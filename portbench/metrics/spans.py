"""The program's own spans, as the per-layer readers read them:
`usot_tpu_torch.utils.profiling.spans()`, the record of the newest
profiled session, which in a traced run is the measured window. A
program that records no spans gives an empty record, and its readers
read nothing."""


def record() -> list:
    """The program's span record (empty where it keeps none)."""
    try:
        from usot_tpu_torch.utils.profiling import spans
    except ImportError:
        return []
    return spans()


def durations_ms(rec: list, name: str) -> list:
    """The durations, ms, of the spans named `name`."""
    return [(s.end_ns - s.start_ns) / 1e6 for s in rec if s.name == name]


def mean(values: list):
    return sum(values) / len(values) if values else None
