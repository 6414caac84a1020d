"""PyTorch/CUDA port of the USOT tracker for NVIDIA Hopper GPUs.

Sub-packages mirror `usot_tpu/` (`core/`, `ops/`, `models/`, `tracker/`,
`cli/`, `data/`, `eval/`, `preprocessing/`) so each module has a named
counterpart. The port imports `torch`, `numpy` and `scipy` (and, in
`data/imageio.py` only, OpenCV or Pillow to decode frame files): nothing
of JAX, flax or `usot_tpu`. Public functions keep the JAX package's NHWC
layout, but for the flow network's (`preprocessing/{correlation,
pwclite}.py`: NCHW). Entry points run on `cuda` unless the caller passes
`device="cpu"`.
"""
