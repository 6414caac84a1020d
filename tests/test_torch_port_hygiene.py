"""The port stands alone: it imports no JAX, no flax, no msgpack and
nothing of `usot_tpu`, and its entry points never fall back to the CPU
quietly."""
import ast
import os
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "usot_tpu_torch")


def _forbidden(name: str) -> bool:
    # `usot_tpu_torch` starts with `usot_tpu`: match the package exactly
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "msgpack", "usot_tpu")


def test_importing_every_module_loads_no_jax():
    script = textwrap.dedent("""
        import importlib, pkgutil, sys
        import usot_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            usot_tpu_torch.__path__, "usot_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        print(len(names))
        print("\\n".join(sorted(sys.modules)))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300,
                          check=True)
    lines = proc.stdout.split()
    assert int(lines[0]) >= 20  # every sub-package and module was imported
    loaded = lines[1:]
    for name in ("tracker.tracker", "config.defaults", "train.losses",
                 "train.optim", "train.step", "train.checkpoint",
                 "train.schedulers", "utils.edict", "utils.meters",
                 "data.shards", "cli.train", "utils.msgpack",
                 "tools.synthetic_shards", "tools.measure_bf16_drift",
                 "tools.ab_card_layers", "data.cvops", "data.augment",
                 "data.dataset", "data.loader", "cli.make_shards",
                 "preprocessing.correlation", "preprocessing.pwclite",
                 "preprocessing.flow2box", "preprocessing.inference",
                 "preprocessing.crop_gen", "cli.parse_flow",
                 *SLICE_9_MODULES, *SLICE_10_MODULES, *SLICE_11_MODULES,
                 *SLICE_12_MODULES):
        assert "usot_tpu_torch." + name in loaded, name
    assert [m for m in loaded if _forbidden(m)] == []


# the TraX entry point, the evaluation toolkit and the one-key pipeline
SLICE_9_MODULES = ("eval.trax_protocol", "cli.vot_wrapper", "eval.region",
                   "eval.statistics", "eval.datasets", "eval.benchmarks",
                   "eval.visualization", "cli.evaluate", "cli.test_epochs",
                   "cli.onekey", "tools.onekey_synthetic", "utils.profiling",
                   "entry")
# data parallelism: the mesh, the process group, the step runs
SLICE_10_MODULES = ("parallel", "parallel.mesh", "parallel.steps")
# the full schedule with kill and resume, the trained checkpoint, accuracy
SLICE_11_MODULES = ("tools.train_full_schedule", "tools.regen_bench_ckpt",
                    "tools.accuracy_parity_run")
# the measuring entry points and their compile watch
SLICE_12_MODULES = ("utils.compile_watch", "tools.bench",
                    "tools.vot_protocol_bench", "tools.bench_train")


def test_evaluation_and_pipeline_import_no_optional_library():
    """The TraX wrapper, the evaluation toolkit, the one-key pipeline,
    the profiling helpers, `entry`, the measuring tools and their compile
    watch import neither OpenCV, Pillow, PyYAML, matplotlib, numba nor
    the pip `trax` package at module level (the GPU machine has none of
    them), nor anything of JAX."""
    script = textwrap.dedent("""
        import importlib, sys
        for name in %r:
            importlib.import_module("usot_tpu_torch." + name)
        print(sorted(n for n in sys.modules if n.split(".")[0] in
                     ("cv2", "PIL", "yaml", "matplotlib", "numba", "trax",
                      "jax", "jaxlib", "flax", "usot_tpu")))
    """ % ((*SLICE_9_MODULES, *SLICE_12_MODULES),))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300,
                          check=True)
    assert proc.stdout.split() == ["[]"]


def test_training_imports_no_optional_library():
    """The trainer and its modules (data parallelism too), the
    flax-checkpoint reader, the synthetic-data tools, the pseudo-label
    factory, the full-schedule and accuracy tools import PyYAML only
    when a config file is read, and neither OpenCV, Pillow, tensorboardX
    nor msgpack at module level (the GPU machine has none of them)."""
    script = textwrap.dedent("""
        import sys
        import usot_tpu_torch.cli.train
        import usot_tpu_torch.config.defaults
        import usot_tpu_torch.data.shards
        import usot_tpu_torch.train.step
        import usot_tpu_torch.train.checkpoint
        import usot_tpu_torch.utils.msgpack
        import usot_tpu_torch.tools.synthetic_shards
        import usot_tpu_torch.tools.measure_bf16_drift
        import usot_tpu_torch.data.dataset
        import usot_tpu_torch.data.loader
        import usot_tpu_torch.cli.make_shards
        import usot_tpu_torch.cli.parse_flow
        import usot_tpu_torch.preprocessing.flow2box
        import usot_tpu_torch.parallel.mesh
        import usot_tpu_torch.parallel.steps
        import usot_tpu_torch.tools.train_full_schedule
        import usot_tpu_torch.tools.regen_bench_ckpt
        import usot_tpu_torch.tools.accuracy_parity_run
        print(sorted(n for n in sys.modules if n.split(".")[0] in
                     ("yaml", "cv2", "PIL", "tensorboardX", "msgpack")))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300,
                          check=True)
    assert proc.stdout.split() == ["[]"]


def test_no_source_file_names_jax():
    """Static check of the port (its benchmark tools included),
    `chip_smoke.py` and the port's profiling tool, including imports
    inside functions."""
    paths = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "tools", "profile_port_slice.py")]
    for dirpath, _, files in os.walk(PORT):
        paths += [os.path.join(dirpath, f) for f in files
                  if f.endswith(".py")]
    assert len(paths) > 20
    for tool in ("bench_xcorr.py", "bench_memhead.py", "profile_engine.py",
                 "timing.py", "synthetic_shards.py", "measure_bf16_drift.py",
                 "ab_card_layers.py", "onekey_synthetic.py",
                 "train_full_schedule.py", "regen_bench_ckpt.py",
                 "accuracy_parity_run.py", "bench.py",
                 "vot_protocol_bench.py", "bench_train.py", "stage_cost.py",
                 "bench_lockstep.py", "bench_memops.py",
                 "microbench_step.py", "cliff_sweep.py", "cliff_bisect.py",
                 "process_battery.py"):
        assert os.path.join(PORT, "tools", tool) in paths
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not any(_forbidden(n) for n in names), (path, names)


def test_entry_points_raise_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    from usot_tpu_torch.cli import test as cli
    from usot_tpu_torch.models.usot import build_usot, init_model
    from usot_tpu_torch.tracker.config import TrackerConfig
    from usot_tpu_torch.tracker.engine import BatchScanEngine
    from usot_tpu_torch.tracker.runner import ModelRunner

    model = build_usot(width=4, channels=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_model(model)
    with pytest.raises(RuntimeError, match="CUDA"):
        ModelRunner(model)
    init_model(model, device="cpu")
    assert ModelRunner(model, device="cpu").device.type == "cpu"
    # the test CLI, before it reads a checkpoint or a dataset
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--dataset", "OTB2015", "--dataset_root",
                  str(tmp_path / "none"), "--result_dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())
    # the trainer, before it reads a config, a checkpoint or a shard set
    from usot_tpu_torch.cli import train as train_cli

    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--cfg", str(tmp_path / "none.yaml"), "--shards",
                        str(tmp_path / "none"), "--resume",
                        str(tmp_path / "none.pth")])
    assert not any(tmp_path.iterdir())
    # the engine the lockstep protocols and the lane surgery run on
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchScanEngine(model, TrackerConfig(), 64, 64, batch=2)
    engine = BatchScanEngine(model, TrackerConfig(), 64, 64, batch=2,
                             device="cpu")
    assert engine._origin0.device.type == "cpu"
    # the pseudo-label factory: its flow helper, and the CLI before it
    # reads a checkpoint or a dataset
    from usot_tpu_torch.cli import parse_flow
    from usot_tpu_torch.preprocessing.inference import FlowHelper

    with pytest.raises(RuntimeError, match="CUDA"):
        FlowHelper(test_shape=(64, 96))
    assert FlowHelper(test_shape=(64, 96), device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        parse_flow.main(["--data_dir", str(tmp_path / "none"),
                         "--output_dir", str(tmp_path / "out"),
                         "--flow_ckpt", str(tmp_path / "none.tar")])
    assert not any(tmp_path.iterdir())
    # the TraX wrapper, before it builds a model or speaks the protocol
    import io

    from usot_tpu_torch.cli import vot_wrapper

    fout = io.StringIO()
    with pytest.raises(RuntimeError, match="CUDA"):
        vot_wrapper.run(str(tmp_path / "none.pth"), "mask",
                        fin=io.StringIO(""), fout=fout)
    assert fout.getvalue() == ""
    # the full-schedule and accuracy tools, before they write anything
    from usot_tpu_torch.tools import accuracy_parity_run, train_full_schedule

    with pytest.raises(RuntimeError, match="CUDA"):
        train_full_schedule.run(train_full_schedule.parse_args(
            ["--root", str(tmp_path / "schedule")]))
    with pytest.raises(RuntimeError, match="CUDA"):
        accuracy_parity_run.run(accuracy_parity_run.parse_args(
            ["--root", str(tmp_path / "bench"),
             "--ckpt", str(tmp_path / "none.pth")]))
    assert not any(tmp_path.iterdir())
    # the measuring tools, before they build, read or write anything
    from usot_tpu_torch.tools import bench, bench_train, vot_protocol_bench

    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(["--json", str(tmp_path / "bench.json")],
                   env={"BENCH_CKPT": str(tmp_path / "none.pth")})
    with pytest.raises(RuntimeError, match="CUDA"):
        vot_protocol_bench.main(["--root", str(tmp_path / "vot"), "--out",
                                 str(tmp_path / "vot.json")])
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_train.main(["--shards", str(tmp_path / "shards"), "--json",
                          str(tmp_path / "train.json")])
    assert not any(tmp_path.iterdir())
    # the step attribution and lockstep tools and the battery's digest,
    # before they load weights, write or read anything
    from usot_tpu_torch.tools import (bench_lockstep, bench_memops,
                                      cliff_bisect, cliff_sweep,
                                      microbench_step, process_battery)

    none = str(tmp_path / "none.pth")
    for tool, argv in ((microbench_step, ["--mfu", "--ckpt", none]),
                       (cliff_sweep, ["--ckpt", none, "--trace",
                                      str(tmp_path / "trace")]),
                       (cliff_bisect, ["--ckpt", none]),
                       (bench_memops, []),
                       (bench_lockstep, ["--vot", "--refill", "--ckpt",
                                         none])):
        with pytest.raises(RuntimeError, match="CUDA"):
            tool.main(argv + ["--json", str(tmp_path / "rec.json")])
    with pytest.raises(RuntimeError, match="CUDA"):
        process_battery.main(["--dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())


def test_only_imageio_touches_an_image_library():
    """Frame decoding is `data/imageio.py`'s alone: no other module of
    the port imports OpenCV or Pillow (the GPU machine has neither), not
    even inside a function, the live data pipeline (its cv2 calls are
    `data/cvops.py`'s) and `cli/make_shards.py` among them; and importing
    the port loads neither."""
    for name in ("cvops", "augment", "dataset", "loader"):
        assert os.path.exists(os.path.join(PORT, "data", name + ".py"))
    for name in ("inference", "crop_gen"):
        assert os.path.exists(os.path.join(PORT, "preprocessing",
                                           name + ".py"))
    assert os.path.exists(os.path.join(PORT, "cli", "make_shards.py"))
    assert os.path.exists(os.path.join(PORT, "cli", "parse_flow.py"))
    for dirpath, _, files in os.walk(PORT):
        for f in files:
            path = os.path.join(dirpath, f)
            if not f.endswith(".py") or path.endswith(
                    os.path.join("data", "imageio.py")):
                continue
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    names = [node.module or ""]
                else:
                    continue
                assert not any(n.split(".")[0] in ("cv2", "PIL")
                               for n in names), (path, names)
    script = textwrap.dedent("""
        import importlib, pkgutil, sys
        import usot_tpu_torch
        for m in pkgutil.walk_packages(usot_tpu_torch.__path__,
                                       "usot_tpu_torch."):
            importlib.import_module(m.name)
        print(sorted(n for n in sys.modules if n.split(".")[0] in
                     ("cv2", "PIL")))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300,
                          check=True)
    assert proc.stdout.split() == ["[]"]


def test_groupdw_kernel_source_is_for_hopper():
    """The kernel is CUDA C++ built for sm_90a from the repo's source:
    an entry point over the tiled kernel of `xcorr_tile.cuh`."""
    from usot_tpu_torch.ops import xcorr_kernel

    assert xcorr_kernel.SOURCE.exists()
    assert "arch=compute_90a,code=sm_90a" in xcorr_kernel.NVCC_FLAGS
    src = xcorr_kernel.SOURCE.read_text()
    tile = (xcorr_kernel.CSRC / "xcorr_tile.cuh").read_text()
    assert '#include "xcorr_tile.cuh"' in src and 'extern "C"' in src
    assert "__global__" in tile and "launch<3>" in src
    assert "xcorr_groupdw_pallas" in src  # names the TPU kernel it replaces


def test_depthwise_kernel_source_is_for_hopper():
    """K2 and K3 are CUDA C++ built for sm_90a from the repo's source,
    each entry point naming the TPU kernel it replaces."""
    from usot_tpu_torch.ops import xcorr_kernel

    src = xcorr_kernel.DEPTHWISE_SOURCE.read_text()
    assert xcorr_kernel.DEPTHWISE_SOURCE in xcorr_kernel.SOURCES
    assert "arch=compute_90a,code=sm_90a" in xcorr_kernel.NVCC_FLAGS
    tile = (xcorr_kernel.CSRC / "xcorr_tile.cuh").read_text()
    assert '#include "xcorr_tile.cuh"' in src and "__global__" in tile
    assert src.count('extern "C"') == 2 and "launch<1>" in src
    assert "usot_xcorr_depthwise_multi  <- xcorr_depthwise_multi_pallas" \
        in src
    assert "usot_xcorr_depthwise        <- xcorr_depthwise_pallas" in src


def test_engines_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    from usot_tpu_torch.models.usot import build_usot
    from usot_tpu_torch.tracker.config import TrackerConfig
    from usot_tpu_torch.tracker.engine import BatchScanEngine, ScanEngine

    model = build_usot(width=4, channels=8)
    p = TrackerConfig()
    with pytest.raises(RuntimeError, match="CUDA"):
        ScanEngine(model, p, 64, 64)
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchScanEngine(model, p, 64, 64, batch=2)
    assert ScanEngine(model, p, 64, 64, device="cpu").device.type == "cpu"
    engine = BatchScanEngine(model, p, 64, 64, batch=2, device="cpu")
    assert engine._consts["window"].device.type == "cpu"
