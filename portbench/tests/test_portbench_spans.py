"""The readers of the program's own spans (`metrics/spans.py` and the
three metrics on it) on a hand-made record, a program that keeps no
record, and the CPU rehearsal's traced line of each cell."""
import pytest

from conftest import ROOT, small_context
from portbench import harness
from portbench.metrics import spans

NEW = {"track_b64_staged": {"init_host_ms.track", "host_step_ms.track"},
       "train_cycle_b12": {"host_step_ms.train"}}
MS = 1_000_000


def _span(name, start_ms, end_ms, parent=None, id=1):
    from usot_tpu_torch.utils.profiling import Span

    return Span(name, start_ms * MS, end_ms * MS, parent, id)


def _read(metric, rec, monkeypatch):
    monkeypatch.setattr(spans, "record", lambda: rec)
    return harness.load_metric(ROOT, metric).read(None, None)


def test_tracking_readers_on_a_record(monkeypatch):
    rec = [_span("engine.init_batch", 0, 100),
           _span("engine.init_host", 0, 60, parent=0),
           _span("engine.step", 100, 120), _span("engine.search", 101, 110, 2),
           _span("engine.step", 120, 150),
           _span("engine.collate", 150, 160),
           _span("engine.init_batch", 160, 250, id=2),
           _span("engine.init_host", 160, 200, parent=6, id=2)]
    assert _read("init_host_ms.track", rec, monkeypatch) == \
        pytest.approx((60 + 40) / 2)
    assert _read("host_step_ms.track", rec, monkeypatch) == \
        pytest.approx((20 + 30) / 2)


def test_training_reader_leaves_out_the_gate(monkeypatch):
    rec = [_span("train.step", 0, 400), _span("train.forward", 0, 100, 0),
           _span("train.backward", 100, 200, 0),
           _span("train.gate", 200, 350, 0),
           _span("train.update", 350, 390, 0),
           _span("train.step", 400, 700, id=2),
           _span("train.gate", 500, 600, 5, id=2)]
    assert _read("host_step_ms.train", rec, monkeypatch) == \
        pytest.approx(((400 - 150) + (300 - 100)) / 2)


@pytest.mark.parametrize("metric", sorted(set().union(*NEW.values())))
def test_readers_read_nothing_without_spans(metric, monkeypatch):
    """An empty record (a program that keeps none, or a window without
    these spans) leaves the metric out of the line."""
    assert _read(metric, [], monkeypatch) is None
    other = [_span("pb.step", 0, 1)]
    assert _read(metric, other, monkeypatch) is None


def test_a_program_without_the_record_gives_an_empty_one(monkeypatch):
    import usot_tpu_torch.utils.profiling as profiling

    monkeypatch.delattr(profiling, "spans")
    assert spans.record() == []


@pytest.mark.parametrize("cell", sorted(NEW))
def test_traced_line_carries_the_cell_s_span_metrics(cell):
    bench, ctx = small_context(cell, trace=True)
    line = harness.run_cell(ctx, bench)
    assert NEW[cell] <= set(line["metrics"])
    for name in NEW[cell]:
        assert line["metrics"][name]["value"] > 0
        assert line["metrics"][name]["unit"] == "ms"
