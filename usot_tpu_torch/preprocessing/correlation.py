"""Cost-volume correlation of the flow network (counterpart of
`usot_tpu/preprocessing/correlation.py`), NCHW.

JAX's shift-and-reduce loop is 81 (mul, mean) pairs that XLA fuses; in
eager torch that would be ~160 launches per cost volume. Here `x2` is
padded once and its (2d+1)^2 shifted windows are one strided view
(`Tensor.unfold` twice, no copy), multiplied with `x1` and averaged
over the channels: four launches per cost volume.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def correlation(x1: torch.Tensor, x2: torch.Tensor,
                max_displacement: int = 4) -> torch.Tensor:
    """x1, x2: (B, C, H, W) -> (B, (2d+1)^2, H, W) cost volume.

    out[b, k, y, x] = mean_c x1[b, c, y, x] * x2[b, c, y + dy, x + dx]
    with (dy, dx) the k-th displacement in row-major order and zero
    padding outside (the channel mean is the CUDA op's division by C)."""
    b, c, h, w = x1.shape
    d = max_displacement
    n = 2 * d + 1
    x2_pad = F.pad(x2, (d, d, d, d))
    # (B, C, H, W, n, n) -> (B, C, n, n, H, W): windows[b, c, dy, dx, y, x]
    # = x2_pad[b, c, y + dy, x + dx]
    windows = x2_pad.unfold(2, n, 1).unfold(3, n, 1).permute(0, 1, 4, 5, 2, 3)
    out = (x1[:, :, None, None] * windows).mean(dim=1)
    return out.reshape(b, n * n, h, w)
