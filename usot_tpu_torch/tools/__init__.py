"""Tools of the port (`python -m usot_tpu_torch.tools.<name>`): benchmarks
on one GPU, synthetic training data, the bf16 drift measurement, and an
A/B of the layers' card-only paths."""
