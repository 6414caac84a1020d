"""Host ms of a training step outside its loss gate, as the traced host
takes it: the mean over the traced window's `train.step` spans of the
span's duration less that of its `train.gate` child (the read-back where
the host waits for the card), so the time the host takes to enqueue
forward, backward and update under the CPU profiler, its cost for each
op included. Not comparable with untraced step times; the untraced
split is `python -m usot_tpu_torch.tools.profile_engine --train`'s."""
from portbench.metrics import spans


def read(ctx, out):
    rec = spans.record()
    own = {i: (s.end_ns - s.start_ns) / 1e6 for i, s in enumerate(rec)
           if s.name == "train.step"}
    for s in rec:
        if s.name == "train.gate" and s.parent in own:
            own[s.parent] -= (s.end_ns - s.start_ns) / 1e6
    return spans.mean(list(own.values()))
