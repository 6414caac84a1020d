"""Host ms of a tracking round's init spent in the lanes' host crops:
the summed `engine.init_host` spans over the number of
`engine.init_batch` spans in the traced window (the card has nothing
queued meanwhile: the round before ended in its read-back)."""
from portbench.metrics import spans


def read(ctx, out):
    rec = spans.record()
    inits = len(spans.durations_ms(rec, "engine.init_batch"))
    host = spans.durations_ms(rec, "engine.init_host")
    return sum(host) / inits if inits and host else None
