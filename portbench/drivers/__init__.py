"""Drivers of the traffic mixes: `run(ctx) -> harness.Outcome`, one
module per kind of entry point the mixes drive (a mix names its driver
in its JSON file)."""
