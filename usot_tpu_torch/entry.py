"""Entry point of the port: the flagship per-frame tracking forward.

    python -m usot_tpu_torch.entry [--device cpu]

Counterpart of `entry()` in the repo's `__graft_entry__.py`:
`entry(device=None) -> (fn, example_args)`, fn the per-frame forward of
the flagship USOT model at full width (width 64, channels 256, memory
queue 7): search features, then the offline and online heads, the
sigmoid applied to both score maps as in JAX. Seeded random weights
(`init_model`, seed 0). The args are in the port's public layout (NHWC,
as every public method of `USOTNet` takes them): the model, x (1, 255,
255, 3), zf (1, 7, 7, 256), mem (7, 7, 7, 256). On the card the three
GroupDW correlations go through the hand-written kernel (K1).
"""
from __future__ import annotations

import sys

import torch

from usot_tpu_torch.core.device import resolve_device


def entry(device=None):
    """(fn, (model, x, zf, mem)) on `device` (default the GPU; raises
    without one unless device="cpu"); fn(model, x, zf, mem) -> (sigmoid
    cls, bbox, sigmoid cls_mem, xf)."""
    from usot_tpu_torch.models.usot import build_usot, init_model

    dev = resolve_device(device)
    model = build_usot(mem_size=4, fused_xcorr=True)
    init_model(model, torch.Generator().manual_seed(0), device=dev)
    model.cast_weights()

    @torch.inference_mode()
    def fn(model, x, zf, mem):
        xf = model.search_features(x)
        cls, bbox, cls_mem = model.track_memory(xf, zf, mem)
        return torch.sigmoid(cls), bbox, torch.sigmoid(cls_mem), xf

    x = torch.zeros((1, 255, 255, 3), dtype=torch.float32, device=dev)
    zf = torch.zeros((1, 7, 7, 256), dtype=torch.float32, device=dev)
    mem = torch.zeros((7, 7, 7, 256), dtype=torch.float32, device=dev)
    return fn, (model, x, zf, mem)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="run entry() once")
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    fn, args = entry(a.device)
    out = fn(*args)
    print("entry OK:", [tuple(o.shape) for o in out])


if __name__ == "__main__":
    sys.exit(main())
