"""The whisper-large-v3 cell, ``cbw-whisper-large-v3.serve16``: a whole run
at tiny widths on the CPU (128 bins and v3's ids kept), its control, a
broken timed path, and its per-layer readers on synthetic spans: each
reads the spans that ended inside the run's window and returns None when
there are none, or when the program records no such span or counter (as
a program before them does)."""

import time

import pytest

from enhance_cb_whisper_tpu_torch.runtime import profiler
from perfbench import harness

import tiny

CELL = "cbw-whisper-large-v3.serve16"
SETUP_END, WINDOW_S = 100.0, 10.0
INSIDE, OUTSIDE = 105.0, (99.0, 110.5)


def _span(name, seq, end, dur_s=0.001, parent=None, device_ms=None, **attrs):
    return {"name": name, "seq": seq, "parent": parent, "id": None, "thread": "t",
            "start_s": end - dur_s, "end_s": end, "device_ms": device_ms, "attrs": attrs}


def _spans(counters=True):
    out = []
    for end in OUTSIDE:  # ends outside the window: large values everywhere
        out += [_span("ecw.audio.features", 1, end, device_ms=90.0, n_mels=128, samples=480000, launches=1),
                _span("ecw.scheduler.window", 2, end, slots=16, self_kv_bytes=10**12, cross_kv_bytes=10**12),
                _span("ecw.decode.step", 3, end, dur_s=0.5),
                _span("ecw.decode.sync", 4, end - 0.1, dur_s=0.1, parent=3),
                _span("ecw.cbw.encoder", 5, end, device_ms=9e3)]
    out += [_span("ecw.audio.features", 10 + i, INSIDE, device_ms=d, n_mels=128, samples=480000, launches=1)
            for i, d in enumerate((0.2, 0.4, 0.3))]
    kv = {"self_kv_bytes": 6_396_313_600, "cross_kv_bytes": 7_864_320_000} if counters else {}
    out += [_span("ecw.scheduler.window", 20 + i, INSIDE, slots=16, **kv) for i in range(2)]
    for seq, step_ms, sync_ms in ((30, 60.0, 5.0), (32, 50.0, 5.0)):
        out += [_span("ecw.decode.sync", seq + 1, INSIDE - 0.001, dur_s=sync_ms / 1e3, parent=seq),
                _span("ecw.decode.step", seq, INSIDE, dur_s=step_ms / 1e3, rows=80)]
    out += [_span("ecw.cbw.encoder", 40 + i, INSIDE, device_ms=d, rows=16) for i, d in enumerate((700.0, 500.0))]
    return out


EXPECTED = {
    "features_ms.serve-v3": 0.3,
    "kv_cache_gb.serve-v3": 14.2606336,
    "step_host_ms.serve-v3": 50.0,
    "encoder_share_pct.serve-v3": 12.0,
}


def _ctx():
    return harness.Ctx(env=None, out={"setup_end": SETUP_END, "window_s": WINDOW_S},
                       setup_s=0.0, summary=None, peaks=None, slice_s=0.0)


def _fake(spans):
    def read(since_s=None, until_s=None):
        return [s for s in spans if (since_s is None or s["end_s"] > since_s)
                and (until_s is None or s["end_s"] <= until_s)]
    return read


def test_the_cell_lists_its_own_per_layer_metrics():
    bench = harness.load_benchmark()
    names = {m["name"] for m in harness.cell_metrics(bench, CELL, per_layer=True)}
    assert names == set(EXPECTED) | {"mfu.serve-v3", "idle_pct.serve-v3"}
    assert all(m["workloads"] == [CELL] for m in bench["per_layer"] if m["name"] in names)


@pytest.mark.parametrize("metric", list(EXPECTED))
def test_reader_takes_the_spans_inside_the_window(metric, monkeypatch):
    monkeypatch.setattr(profiler, "spans", _fake(_spans()))
    assert harness.load_plugin("metrics", metric).read(_ctx()) == pytest.approx(EXPECTED[metric], rel=1e-9)


@pytest.mark.parametrize("metric", list(EXPECTED))
def test_reader_returns_none_without_its_spans(metric, monkeypatch):
    monkeypatch.setattr(profiler, "spans", _fake([s for s in _spans() if s["end_s"] in OUTSIDE
                                                  or s["end_s"] == OUTSIDE[0] - 0.1]))
    assert harness.load_plugin("metrics", metric).read(_ctx()) is None
    monkeypatch.delattr(profiler, "spans")  # a program without the recorder
    assert harness.load_plugin("metrics", metric).read(_ctx()) is None


def test_cache_reader_returns_none_for_windows_without_counters(monkeypatch):
    """A program whose window spans carry no cache counters (before them)."""
    monkeypatch.setattr(profiler, "spans", _fake(_spans(counters=False)))
    assert harness.load_plugin("metrics", "kv_cache_gb.serve-v3").read(_ctx()) is None


def _run(trace=False, **mix):
    env = tiny.env(CELL, trace=trace)
    env.mix.update(mix)
    return harness.run_cell(harness.load_benchmark(), env, 1.5, time.perf_counter())["result"]


def test_sound_run_is_correct():
    result = _run()
    assert result["correct"], result["compared"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", "rtfx"}


def test_traced_run_reads_the_program_metrics():
    """On the CPU the spans carry no device time: the host and counter
    readings come out, the device ones stay out of the line."""
    result = _run(trace=True)
    assert {"kv_cache_gb.serve-v3", "step_host_ms.serve-v3", "idle_pct.serve-v3"} <= set(result["metrics"])
    assert "features_ms.serve-v3" not in result["metrics"]


def test_control_reads_above_the_program():
    env = tiny.env(CELL)
    driver = harness.load_plugin("drivers", env.mix["driver"])
    check = harness.load_plugin("checks", env.mix["check"])
    state = driver.setup(env)
    out = driver.window(state, 1.0)
    items = driver.check_items(state, out)
    driver.close(state)
    program = check.readings(env, items)
    control = check.readings(env, items, control=env.mix["control"])
    assert set(program) == set(control) == set(env.mix["limits"])
    assert any(control[k] > 3 * program[k] for k in program), (program, control)


def test_a_step_that_keeps_its_state_is_not_correct(monkeypatch):
    from enhance_cb_whisper_tpu_torch.decoding.generate import WhisperGenerator

    real = WhisperGenerator._decode_step

    def step(self, tokens, cache, ctx):
        index = cache["index"]
        logits, cache = real(self, tokens, cache, ctx)
        cache["index"] = index
        return logits, cache

    monkeypatch.setattr(WhisperGenerator, "_decode_step", step)
    result = _run(check_requests=4, check_requests_min=4)
    assert not result["correct"], result["compared"]
