"""The reference's numerics, set for its own calls alone."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def deterministic():
    """cuDNN's deterministic algorithms and no benchmarking inside the
    block (the same algorithm, so the same sums, on every run of the
    reference), the caller's settings restored after it: the program's
    timed path runs as it would anyway. It leaves the TF32 switches as
    they are."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
