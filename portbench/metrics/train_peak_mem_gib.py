"""The training window's peak of allocated device memory, GiB
(`torch.cuda.max_memory_allocated` after `reset_peak_memory_stats` at
the window's start)."""


def read(ctx, out):
    peak = out.counts.get("window_peak_bytes")
    return peak / 2 ** 30 if peak else None
