"""The benchmark of `usot_tpu_torch` on NVIDIA GPUs (see `run.py`)."""
