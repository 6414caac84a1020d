"""PyTorch/CUDA port of the USOT tracker for NVIDIA Hopper GPUs.

Sub-packages mirror `usot_tpu/` (`core/`, `ops/`, `models/`, `tracker/`)
so each module has a named counterpart. The port imports `torch` and
`numpy` only: nothing of JAX, flax or `usot_tpu`. Public functions keep
the JAX package's NHWC layout. Entry points run on `cuda` unless the
caller passes `device="cpu"`.
"""
