"""Plain PyTorch reference of USOT*: the network, the tracker and the
cycle-memory training step. Imports nothing of the measured program."""
