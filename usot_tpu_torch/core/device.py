"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the GPU.

    With no GPU and no explicit request this raises instead of falling
    back to the CPU: a CPU run must be asked for (`device="cpu"`)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port on the CPU")
    return torch.device("cuda")


def f32_numerics() -> None:
    """Keep the card's float32 work in float32. cuDNN runs float32
    convolutions in TF32 unless told not to (`cudnn.allow_tf32` defaults
    to True), and the port's f32 numerics are held against the f32
    reference. Every entry point that runs a model calls this; the two
    switches touch CUDA work alone, so a CPU run is unchanged."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
