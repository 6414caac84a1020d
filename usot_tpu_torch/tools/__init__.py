"""Benchmarks of the port on one GPU (`python -m usot_tpu_torch.tools.<name>`)."""
