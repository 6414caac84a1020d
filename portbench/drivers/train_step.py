"""Driver: the cycle-memory training step, `make_train_step(cycle_memory=
True, stage_bn_train=True)` over `build_optimizer(..., unfix=True)`, step
after step on batches made on the card (the port's `bench_train.
make_batch` recipe, drawn with a `torch.Generator`), cycled.

Set-up builds the one model, optimizer and step, and drives it through
its first `check_steps` steps on the first batches (the warm-up): the
momentum after step 1 and the weights after the last are kept for the
check. The same objects then run the window.

Traffic keys: `batch`, `mem_num`, `distinct_batches`, `lr`,
`cls_ratio`, `lambda_1`, `lambda_total`, `momentum`, `weight_decay`,
`layers_lr`, `check_steps`, `trace_seconds`.

End to end: `train_samples_per_s`, the samples of the steps completed
in the window over its seconds (each step reads its loss back).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench.checks import train_numbers
from portbench.drivers import program
from portbench.harness import Outcome
from portbench.reference.numerics import deterministic
from portbench.reference.train import STATS, leaves, train
from portbench.trace import Profile, peak_bytes, release, span, sync
from portbench.weights import make_weights


def make_batches(seed: int, tr: dict, device) -> list:
    """`distinct_batches` batches, NHWC float32 on `device`: images and
    memory frames N(0, 1), labels 1 where U(0, 1) > 0.8, regression
    targets |N(0, 1)| + 1, weights 1 where U(0, 1) > 0.7, the template
    box [3, 3, 11, 11] and the search box [5, 5, 19, 19]."""
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    b, m = tr["batch"], tr["mem_num"]

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)

    def above(p, *shape):
        return (torch.rand(shape, generator=gen, device=device) > p).float()
    out = []
    for _ in range(tr["distinct_batches"]):
        out.append({
            "template": normal(b, 127, 127, 3),
            "search": normal(b, 255, 255, 3),
            "label": above(0.8, b, 25, 25),
            "reg_target": normal(b, 25, 25, 4).abs() + 1.0,
            "reg_weight": above(0.7, b, 25, 25),
            "template_bbox": torch.tensor([[3.0, 3.0, 11.0, 11.0]] * b,
                                          device=device),
            "search_memory": normal(b, m, 255, 255, 3),
            "search_bbox": torch.tensor([[5.0, 5.0, 19.0, 19.0]] * b,
                                        device=device)})
    return out


def first_gradient(opt, param, start, weight_decay: float):
    """The first step's gradient of `param` as the optimizer got it, from
    its state after that step: SGD's first momentum is g + wd * p0 (zero
    where the optimizer holds none: it never stepped)."""
    buf = opt.state.get(param, {}).get("momentum_buffer")
    if buf is None:
        return torch.zeros_like(param, device="cpu")
    return (buf - weight_decay * start).cpu()


def hyper(cfg: dict, tr: dict) -> dict:
    return dict(width=cfg["width"], channels=cfg["channels"],
                **{k: tr[k] for k in ("lr", "cls_ratio", "lambda_1",
                                      "lambda_total", "momentum",
                                      "weight_decay", "layers_lr")})


def run(ctx) -> Outcome:
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    weights = make_weights(ctx.seed, cfg["width"], cfg["channels"], dev)
    batches = make_batches(ctx.seed, tr, dev)

    from usot_tpu_torch.train.optim import build_optimizer
    from usot_tpu_torch.train.step import make_train_step

    model = program.model(cfg, weights, dev)
    opt, _ = build_optimizer(model, tr["momentum"], tr["weight_decay"],
                             tr["layers_lr"], unfix=True)
    step = make_train_step(model, opt, cycle_memory=True,
                           stage_bn_train=True, lambda_1=tr["lambda_1"],
                           lambda_total=tr["lambda_total"])
    params = dict(model.named_parameters())
    names = leaves(cfg["width"], cfg["channels"])
    done = [0]

    def one_step():
        with span("step"):
            out = step(batches[done[0] % len(batches)], tr["lr"],
                       tr["cls_ratio"])
        done[0] += 1
        return out

    kept = {"loss": []}
    with span("warm"):
        for i in range(tr["check_steps"]):
            kept["loss"].append(float(one_step()["loss"]))
            if i == 0:
                kept["grad1"] = {k: first_gradient(opt, params[k], weights[k],
                                                   tr["weight_decay"])
                                 for k in names}
    state = model.state_dict()
    kept["params"] = {k: state[k].detach().to("cpu", copy=True) for k in names}
    kept["stats"] = {k: state[k].detach().to("cpu", copy=True) for k in state
                     if k.endswith(STATS)}
    sync(dev)

    limit = ctx.window_limit()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    start, failed, ends = done[0], 0, []
    with Profile(ctx.trace) as prof:
        t_first = time.time()
        t0 = time.perf_counter()
        while done[0] == start or time.perf_counter() - t0 < limit:
            loss = float(one_step()["loss"])
            failed += not (loss == loss and abs(loss) < 1e4)
            ends.append(time.perf_counter() - t0)
        window = time.perf_counter() - t0
    steps = done[0] - start
    peak = peak_bytes(dev)
    summary = prof.summary()
    del model, opt, step, params, state
    release(dev)

    with deterministic():
        ref = train({k: v for k, v in weights.items()}, batches,
                    hyper(cfg, tr), tr["check_steps"])
    ref_cpu = {"loss": [l[3] for l in ref["loss"]],
               **{k: {n: t.cpu() for n, t in ref[k].items()}
                  for k in ("grad1", "params", "stats")}}
    numbers = train_numbers(kept, ref_cpu,
                            {k: v.cpu() for k, v in weights.items()})
    limits = cfg["limits"]["train_step"]
    return Outcome(
        e2e={"train_samples_per_s": steps * tr["batch"] / window,
             "setup_s": t_first - ctx.started},
        attempted=steps, failed=failed,
        checks={k: (v, float(limits[k])) for k, (v, _) in numbers.items()},
        memory_peak_bytes=peak, trace=summary,
        counts={"steps": steps, "samples": steps * tr["batch"],
                "window_peak_bytes": peak},
        notes=[f"window {window:.3f} s: {steps} steps; step seconds "
               f"{np.round(np.diff([0.0] + ends), 4).tolist()}",
               *(f"worst leaf of {k}: {leaf}"
                 for k, (_, leaf) in numbers.items() if leaf),
               f"losses program {kept['loss']} reference "
               f"{ref_cpu['loss']}"])
