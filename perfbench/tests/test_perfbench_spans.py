"""The ``program_span`` metric readers on synthetic spans: each reads the
spans that ended inside the run's window (``setup_end``, ``setup_end +
window_s``] and no other, and returns None when none ended there or the
program has no span recorder."""

import time

import pytest

from enhance_cb_whisper_tpu_torch.runtime import profiler
from perfbench import harness

SETUP_END, WINDOW_S = 100.0, 10.0
INSIDE, BEFORE, AFTER = 105.0, 99.0, 110.5  # span ends


def _span(name, seq, end, dur_s=0.001, parent=None, id=None, device_ms=None, **attrs):
    return {"name": name, "seq": seq, "parent": parent, "id": id, "thread": "t",
            "start_s": end - dur_s, "end_s": end, "device_ms": device_ms, "attrs": attrs}


def _spans():
    """Inside the window the expected readings come out; the spans that end
    before or after it would move every reading."""
    out = []
    for end in (BEFORE, AFTER):  # outside: large values everywhere
        out += [_span("ecw.serving.queue_wait", 1, end, dur_s=90.0, id=0),
                _span("ecw.scheduler.window", 2, end, id=(), slots=16),
                _span("ecw.decode.step", 3, end, dur_s=0.5),
                _span("ecw.decode.sync", 4, end - 0.1, dur_s=0.1, parent=3),
                _span("ecw.cbw.encoder", 5, end, device_ms=9e3),
                _span("ecw.cbw.spotter", 6, end, device_ms=9e3),
                _span("ecw.catalog.proxy", 7, end, dur_s=9.0, device_ms=9e3)]
    out += [_span("ecw.serving.queue_wait", 10 + i, INSIDE, dur_s=d, id=i) for i, d in enumerate((2.0, 4.0, 9.0))]
    out += [_span("ecw.scheduler.window", 20, INSIDE, id=tuple(range(16)), slots=16),
            _span("ecw.scheduler.window", 21, INSIDE, id=tuple(range(12)), slots=16)]
    for seq, step_ms, sync_ms in ((30, 40.0, 25.0), (32, 30.0, 10.0)):
        out += [_span("ecw.decode.sync", seq + 1, INSIDE - 0.001, dur_s=sync_ms / 1e3, parent=seq),
                _span("ecw.decode.step", seq, INSIDE, dur_s=step_ms / 1e3, rows=80)]
    out += [_span("ecw.cbw.encoder", 40 + i, INSIDE, device_ms=d, rows=16) for i, d in enumerate((500.0, 300.0))]
    out += [_span("ecw.cbw.spotter", 50 + i, INSIDE, device_ms=d, rows=1) for i, d in enumerate((120.0, 100.0, 110.0))]
    out += [_span("ecw.catalog.proxy", 60 + i, INSIDE, dur_s=h, device_ms=d, chunks=784)
            for i, (h, d) in enumerate(((0.1, 180.0), (0.3, 220.0), (0.2, 200.0)))]
    return out


EXPECTED = {
    "queue_wait_p50_s.serve": 4.0,
    "occupancy_pct.serve": 87.5,
    "step_host_ms.serve": 17.5,
    "step_wait_ms.serve": 17.5,
    "encoder_share_pct.serve": 8.0,
    "spotter_ms.spot": 110.0,
    "proxy_host_ms.cascade": 200.0,
    "proxy_device_ms.cascade": 200.0,
}


def _ctx(setup_end=SETUP_END, window_s=WINDOW_S):
    return harness.Ctx(env=None, out={"setup_end": setup_end, "window_s": window_s},
                       setup_s=0.0, summary=None, peaks=None, slice_s=0.0)


def _fake(spans):
    def read(since_s=None, until_s=None):
        return [s for s in spans if (since_s is None or s["end_s"] > since_s)
                and (until_s is None or s["end_s"] <= until_s)]
    return read


def test_every_program_span_metric_has_a_reader_here():
    bench = harness.load_benchmark()
    assert {m["name"] for m in bench["per_layer"] if m["source"] == "program_span"} == set(EXPECTED)


@pytest.mark.parametrize("metric", list(EXPECTED))
def test_reader_takes_the_spans_inside_the_window(metric, monkeypatch):
    monkeypatch.setattr(profiler, "spans", _fake(_spans()))
    got = harness.load_plugin("metrics", metric).read(_ctx())
    assert got == pytest.approx(EXPECTED[metric], rel=1e-9)


@pytest.mark.parametrize("metric", list(EXPECTED))
def test_reader_returns_none_with_nothing_inside(metric, monkeypatch):
    outside = [s for s in _spans() if s["end_s"] in (BEFORE, AFTER) or s["end_s"] == BEFORE - 0.1]
    monkeypatch.setattr(profiler, "spans", _fake(outside))
    assert harness.load_plugin("metrics", metric).read(_ctx()) is None
    monkeypatch.delattr(profiler, "spans")  # a program without the recorder
    assert harness.load_plugin("metrics", metric).read(_ctx()) is None


def test_queue_wait_reads_the_recorder_itself(monkeypatch):
    """End to end through the recorder: intervals stamped before and inside
    a window, on the clock the runs' windows are stamped with."""
    monkeypatch.setattr(profiler, "RECORDER", profiler.Recorder())
    profiler.interval("ecw.serving.queue_wait", time.perf_counter_ns(), id=0)
    setup_end = time.perf_counter()
    for ticket in (1, 2, 3):
        profiler.interval("ecw.serving.queue_wait", time.perf_counter_ns() - ticket * 10**9, id=ticket)
    ctx = _ctx(setup_end, time.perf_counter() - setup_end)
    got = harness.load_plugin("metrics", "queue_wait_p50_s.serve").read(ctx)
    assert got == pytest.approx(2.0, abs=0.05)
