"""Metric evaluation CLI of the port (ref: lib/eval_toolkit/bin/eval.py).

    python -m usot_tpu_torch.cli.evaluate --dataset OTB2015 \
        --dataset_dir <root> --tracker_result_dir <root>/OTB2015 \
        --trackers USOT [--num 2] [--vis]

Counterpart of `usot_tpu/cli/evaluate.py`, the same flags and return
value. Dispatch per dataset family:
  OTB / LaSOT / UAV / NFS -> OPE (success, precision, norm precision)
  VOT                     -> Accuracy-Robustness + EAO
  VOT-LT                  -> F1
Host code (numpy): no device. `--vis` needs matplotlib and raises
without it.
"""
from __future__ import annotations

import argparse
import os

from usot_tpu_torch.eval.benchmarks import (AccuracyRobustnessBenchmark,
                                            EAOBenchmark, F1Benchmark,
                                            OPEBenchmark)
from usot_tpu_torch.eval.datasets import create_dataset


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="tracking evaluation")
    parser.add_argument("--dataset_dir", type=str, help="dataset root")
    parser.add_argument("--dataset", type=str, help="dataset name")
    parser.add_argument("--tracker_result_dir", type=str,
                        help="tracker result root")
    parser.add_argument("--trackers", nargs="+")
    parser.add_argument("--vis", dest="vis", action="store_true",
                        help="write plots (per-attribute success/precision "
                        "curves, EAO attribute radar, F1 curves)")
    parser.add_argument("--show_video_level", action="store_true",
                        help="per-video result table (ref eval.py flag)")
    parser.add_argument("--plot_dir", default="var/plots",
                        help="where --vis writes figures")
    parser.add_argument("--num", type=int, default=1,
                        help="parallel workers over trackers "
                        "(ref bin/eval.py --num)")
    return parser.parse_args(argv)


def _eval_parallel(fn, trackers, num: int):
    """Fan an eval method out over trackers (ref: bin/eval.py:39-48
    Pool.imap_unordered). Threads rather than processes: the statistics
    kernels are vectorized NumPy (GIL released) and results merge as
    plain dicts."""
    if num <= 1 or len(trackers) <= 1:
        return fn(trackers)
    from concurrent.futures import ThreadPoolExecutor

    out = {}
    with ThreadPoolExecutor(min(num, len(trackers))) as ex:
        for ret in ex.map(lambda t: fn([t]), trackers):
            out.update(ret)
    return out


def evaluate(dataset_name, dataset_dir, tracker_result_dir, trackers,
             vis=False, show_video_level=False, plot_dir="var/plots",
             num=1):
    dataset = create_dataset(dataset_name, dataset_dir)
    dataset.set_tracker(tracker_result_dir, trackers)
    if vis:
        from usot_tpu_torch.eval.visualization import require_pyplot
        require_pyplot()  # raises before scoring where there is none
        os.makedirs(plot_dir, exist_ok=True)

    if "VOT" in dataset_name and "LT" not in dataset_name:
        ar = AccuracyRobustnessBenchmark(dataset)
        ar_result = _eval_parallel(ar.eval, trackers, num)
        # per-attribute EAO when plotting the radar, 'all' otherwise
        tags = tuple(dataset.tags) if vis else ("all",)
        eao = EAOBenchmark(dataset, tags=tags)
        eao_result = _eval_parallel(eao.eval, trackers, num)
        ar.show_result(ar_result, eao_result,
                       show_video_level=show_video_level)
        if vis:
            from usot_tpu_torch.eval.visualization import draw_eao
            draw_eao(eao_result,
                     os.path.join(plot_dir, f"{dataset_name}_eao.png"))
        return {"ar": ar_result, "eao": eao_result}

    if "LT" in dataset_name:
        f1 = F1Benchmark(dataset)
        f1_result = _eval_parallel(f1.eval, trackers, num)
        f1.show_result(f1_result)
        if vis:
            from usot_tpu_torch.eval.visualization import draw_f1
            draw_f1(f1_result,
                    os.path.join(plot_dir, f"{dataset_name}_f1.png"))
        return {"f1": f1_result}

    ope = OPEBenchmark(dataset)
    success = _eval_parallel(ope.eval_success, trackers, num)
    precision = _eval_parallel(ope.eval_precision, trackers, num)
    norm_precision = _eval_parallel(ope.eval_norm_precision, trackers, num)
    ope.show_result(success, precision, norm_precision,
                    show_video_level=show_video_level)
    if vis:
        from usot_tpu_torch.eval.visualization import draw_success_precision
        for attr, videos in getattr(dataset, "attr",
                                    {"ALL": None}).items():
            safe = attr.replace(" ", "_")
            draw_success_precision(
                success, name=dataset_name, videos=videos, attr=attr,
                precision_ret=precision,
                norm_precision_ret=norm_precision,
                out_path=os.path.join(plot_dir,
                                      f"{dataset_name}_{safe}.png"))
    return {"success": success, "precision": precision,
            "norm_precision": norm_precision}


def main(argv=None):
    args = parse_args(argv)
    evaluate(args.dataset, args.dataset_dir, args.tracker_result_dir,
             args.trackers, vis=args.vis,
             show_video_level=args.show_video_level,
             plot_dir=args.plot_dir, num=args.num)


if __name__ == "__main__":
    main()
