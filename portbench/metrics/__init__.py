"""Per-layer metric readers, one file per metric of `BENCHMARK.json`
named after it (`read(ctx, outcome)` -> a number, or None where the run
has nothing to read), and the work counts they share (`work.py`)."""
