"""Host ms of an OSTrack frame step: the mean duration of the engine's
`engine.step` spans in the traced window (the time the host takes to
enqueue one step of all lanes; the card runs it behind)."""
from portbench.metrics import spans


def read(ctx, out):
    return spans.mean(spans.durations_ms(spans.record(), "engine.step"))
