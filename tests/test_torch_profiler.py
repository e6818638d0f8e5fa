"""The port's ``runtime/profiler.py`` against the JAX package's: the events
of JAX ``tests/test_flops_profiler.py:_fake_trace`` written once in JAX's
trace format (device tracks named by process, an "XLA Modules" track over
the op track) and once as a Kineto trace (device work by category, a user
annotation over the kernels, host ops beside them).  The port's
``device_op_breakdown`` on the Kineto one gives JAX's ``(total, ops)`` on
its own, leaf ops only, with a nested event too.

Then the span recorder: parents per thread, concurrent appends, the
bounded ring, the switch, and spans lined up with their profiler
events through the clock anchor."""

import contextlib
import gzip
import json
import sys
import threading
import time
import types

import pytest
import torch

from enhance_cb_whisper_tpu.runtime.profiler import device_op_breakdown as jax_breakdown
from enhance_cb_whisper_tpu_torch.runtime import profiler
from enhance_cb_whisper_tpu_torch.runtime.profiler import device_op_breakdown, trace

# (name, ts, dur) on the device's op track, and one host event
OPS = [("fusion.1", 0, 40), ("fusion.1", 50, 40), ("copy.2", 90, 10)]
NESTED = [("outer.4", 200, 30), ("inner.5", 205, 10)]
HOST = ("np.asarray", 0, 999)


def _write(directory, name, events):
    directory.mkdir(parents=True, exist_ok=True)
    with gzip.open(directory / name, "wt") as f:
        json.dump({"traceEvents": events}, f)


def _jax_trace(tmp_path, ops):
    events = [
        {"ph": "M", "pid": 1, "name": "process_name", "args": {"name": "/device:TPU:0"}},
        {"ph": "M", "pid": 9, "name": "process_name", "args": {"name": "/host:CPU"}},
        {"ph": "M", "pid": 1, "tid": 1, "name": "thread_name", "args": {"name": "XLA Modules"}},
        {"ph": "M", "pid": 1, "tid": 2, "name": "thread_name", "args": {"name": "XLA Ops"}},
        {"ph": "X", "pid": 1, "tid": 1, "name": "jit_f", "ts": 0, "dur": 100},
        *({"ph": "X", "pid": 1, "tid": 2, "name": n, "ts": ts, "dur": d} for n, ts, d in ops),
        {"ph": "X", "pid": 9, "tid": 1, "name": HOST[0], "ts": HOST[1], "dur": HOST[2]},
    ]
    _write(tmp_path / "jax" / "plugins" / "profile" / "run1", "host.trace.json.gz", events)
    return str(tmp_path / "jax")


def _kineto_trace(tmp_path, ops):
    """The same events as torch.profiler writes them: the host process
    named after the program, kernels on the GPU's stream track, a
    ``record_function`` mirrored onto the GPU as a user annotation."""
    events = [
        {"ph": "M", "pid": 4242, "name": "process_name", "args": {"name": "python3 chip_smoke.py"}},
        {"ph": "M", "pid": 0, "name": "process_name", "args": {"name": "CUDA GPU 0"}},
        {"ph": "M", "pid": 0, "tid": 7, "name": "thread_name", "args": {"name": "stream 7"}},
        {"ph": "X", "cat": "gpu_user_annotation", "pid": 0, "tid": 8, "name": "jit_f", "ts": 0, "dur": 100},
        *({"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "name": n, "ts": ts, "dur": d} for n, ts, d in ops),
        {"ph": "X", "cat": "cpu_op", "pid": 4242, "tid": 1, "name": HOST[0], "ts": HOST[1], "dur": HOST[2]},
        {"ph": "X", "cat": "cuda_runtime", "pid": 4242, "tid": 1, "name": "cudaLaunchKernel", "ts": 1, "dur": 3},
    ]
    _write(tmp_path / "kineto", "00000000000000000001.1.trace.json.gz", events)
    return str(tmp_path / "kineto")


@pytest.mark.parametrize("ops", [OPS, OPS + NESTED], ids=["flat", "nested"])
def test_device_op_breakdown_matches_jax(tmp_path, ops):
    want = jax_breakdown(_jax_trace(tmp_path, ops))
    got = device_op_breakdown(_kineto_trace(tmp_path, ops))
    assert got[0] == pytest.approx(want[0])
    assert got[1] == want[1]
    names = [o["name"] for o in got[1]]
    assert "jit_f" not in names and HOST[0] not in names and "cudaLaunchKernel" not in names
    if ops is not OPS:
        assert "outer.4" not in names and "inner.5" in names  # the leaf, not its parent


def test_device_op_breakdown_reads_the_newest_trace(tmp_path):
    _write(tmp_path, "00000000000000000001.1.trace.json.gz",
           [{"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "name": "old", "ts": 0, "dur": 5}])
    _write(tmp_path, "00000000000000000002.1.trace.json.gz",
           [{"ph": "X", "cat": "gpu_memcpy", "pid": 0, "tid": 7, "name": "Memcpy HtoD", "ts": 0, "dur": 5}])
    total, ops = device_op_breakdown(str(tmp_path))
    assert total == pytest.approx(5e-6) and [o["name"] for o in ops] == ["Memcpy HtoD"]
    with pytest.raises(FileNotFoundError):
        device_op_breakdown(str(tmp_path / "missing"))


def test_trace_of_a_cpu_forward_has_no_device_time(tmp_path):
    x = torch.randn(8, 16)
    w = torch.randn(16, 4)
    with trace(str(tmp_path), cuda=False) as prof:
        torch.relu(x @ w).sum()
    assert any(e.key for e in prof.key_averages())
    assert list(tmp_path.glob("*.trace.json.gz"))
    assert device_op_breakdown(str(tmp_path)) == (0.0, [])


# ------------------------------------------------------------------- spans

@pytest.fixture
def recorder(monkeypatch):
    """A fresh ring for the test, recording on."""
    rec = profiler.Recorder()
    monkeypatch.setattr(profiler, "RECORDER", rec)
    return rec


def _by_name(spans):
    return {s["name"]: s for s in spans}


def test_nested_spans_take_their_parents_per_thread(recorder):
    """Each thread's spans nest under that thread's own open span, never
    under another thread's."""
    gate = threading.Barrier(2, timeout=10)

    def work(tag):
        with profiler.span(f"ecw.t.{tag}.outer", id=tag, rows=2):
            gate.wait()  # both outer spans are open at once
            with profiler.span(f"ecw.t.{tag}.inner"):
                gate.wait()

    threads = [threading.Thread(target=work, args=(tag,), name=f"worker-{tag}") for tag in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    got = _by_name(profiler.spans())
    assert len(got) == 4
    for tag in "ab":
        outer, inner = got[f"ecw.t.{tag}.outer"], got[f"ecw.t.{tag}.inner"]
        assert outer["parent"] is None and inner["parent"] == outer["seq"]
        assert outer["thread"] == inner["thread"] == f"worker-{tag}"
        assert outer["id"] == tag and outer["attrs"] == {"rows": 2} and inner["attrs"] == {}
        assert outer["start_s"] <= inner["start_s"] <= inner["end_s"] <= outer["end_s"]
        assert outer["device_ms"] is None  # not device-timed, and no card here


def test_two_threads_recording_at_once_lose_no_span(recorder):
    """Appends race from several threads with a short switch interval:
    every span is kept, each under its own thread's parent."""
    n_threads, per_thread = 4, 2000
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per_thread // 2):
                with profiler.span("ecw.t.outer"):
                    with profiler.span("ecw.t.inner"):
                        pass

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(switch)
    got = profiler.spans()
    assert len(got) == n_threads * per_thread and profiler.dropped() == 0
    assert len({s["seq"] for s in got}) == len(got)
    outer = {s["seq"]: s["thread"] for s in got if s["name"] == "ecw.t.outer"}
    assert all(outer[s["parent"]] == s["thread"] for s in got if s["name"] == "ecw.t.inner")


def test_ring_drops_the_oldest_and_counts_them(monkeypatch):
    monkeypatch.setattr(profiler, "RECORDER", profiler.Recorder(capacity=4))
    for i in range(6):
        with profiler.span("ecw.t.n", id=i):
            pass
    assert [s["id"] for s in profiler.spans()] == [2, 3, 4, 5]
    assert profiler.dropped() == 2
    profiler.reset()
    assert profiler.spans() == [] and profiler.dropped() == 0


def test_spans_filter_by_end_and_interval_takes_a_foreign_start(recorder):
    """``spans(since_s, until_s)`` keeps the spans that END in
    (since_s, until_s]; an interval's start may come from another thread
    and its parent is this thread's open span."""
    stamped = []
    t = threading.Thread(target=lambda: stamped.append(time.perf_counter_ns()))
    t.start()
    t.join(10)
    with profiler.span("ecw.t.first"):
        pass
    mid = time.perf_counter()
    with profiler.span("ecw.t.outer"):
        profiler.interval("ecw.t.wait", stamped[0], id=7)
    got = profiler.spans(since_s=mid)
    assert [s["name"] for s in got] == ["ecw.t.wait", "ecw.t.outer"]
    wait, outer = got
    assert wait["parent"] == outer["seq"] and wait["id"] == 7
    assert wait["start_s"] == stamped[0] / 1e9 < mid < wait["end_s"]
    first = profiler.spans(until_s=mid)
    assert [s["name"] for s in first] == ["ecw.t.first"]
    assert profiler.spans(since_s=first[0]["end_s"], until_s=first[0]["end_s"]) == []


def test_recording_off_records_nothing_and_never_enters_record_function(recorder, monkeypatch):
    """Off: nothing is kept, and no ``record_function`` even under a
    profiler.  On: ``record_function`` only while a profiler records."""
    entered = []

    def fake_record_function(name):
        entered.append(name)
        return contextlib.nullcontext()

    monkeypatch.setattr(torch.profiler, "record_function", fake_record_function)
    with profiler.span("ecw.t.plain"):
        pass
    assert entered == [] and len(profiler.spans()) == 1
    previous = profiler.set_recording(False)
    try:
        assert previous is True
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            with profiler.span("ecw.t.off", device=True):
                profiler.interval("ecw.t.off_wait", time.perf_counter_ns())
    finally:
        profiler.set_recording(previous)
    assert entered == [] and len(profiler.spans()) == 1
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiler.span("ecw.t.profiled"):
            pass
    assert entered == ["ecw.t.profiled"] and len(profiler.spans()) == 2


def _offsets_from_their_events(tmp_path) -> list:
    """One profiled block of nested spans; per span, how far (µs) its
    start and end land from its ``user_annotation`` event's through
    ``to_trace_us``."""
    profiler.reset()
    x = torch.randn(64, 64)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiler.span("ecw.t.warm"):  # a first record_function is slow
            pass
        with profiler.span("ecw.t.outer", id=1):
            for _ in range(3):
                with profiler.span("ecw.t.inner"):
                    (x @ x).relu()
            time.sleep(0.01)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace_json = json.loads(path.read_text())
    base = trace_json["baseTimeNanoseconds"]
    events = [e for e in trace_json["traceEvents"]
              if e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith("ecw.t.")]
    got = profiler.spans()
    assert sorted(s["name"] for s in got) == sorted(e["name"] for e in events)
    assert [s["name"] for s in got].count("ecw.t.inner") == 3
    out = []
    for name in ("ecw.t.outer", "ecw.t.inner"):
        mine = sorted((s for s in got if s["name"] == name), key=lambda s: s["start_s"])
        theirs = sorted((e for e in events if e["name"] == name), key=lambda e: e["ts"])
        for s, e in zip(mine, theirs):
            start = profiler.to_trace_us(round(s["start_s"] * 1e9), base) - e["ts"]
            end = profiler.to_trace_us(round(s["end_s"] * 1e9), base) - (e["ts"] + e["dur"])
            out.append((name, start, end))
    return out


def test_spans_line_up_with_their_profiler_events(recorder, tmp_path):
    """Under ``torch.profiler`` each span is a ``user_annotation`` event,
    and ``to_trace_us`` puts its start and end within 1 ms of the event's
    ``ts`` and ``ts + dur``.  A thread preempted between the profiler's
    stamp and the span's own clock read can miss by more on a loaded host,
    so the block is profiled again, up to three times."""
    for _ in range(3):
        offsets = _offsets_from_their_events(tmp_path)
        if all(abs(start) < 1000 and abs(end) < 1000 for _, start, end in offsets):
            return
    pytest.fail(f"spans off their events by more than 1 ms (µs): {offsets}")


_STREAM = types.SimpleNamespace(cuda_stream=7)  # a card's current stream


class _FakeEvent:
    """Stands in for ``torch.cuda.Event``: ``record`` stamps a counter that
    advances 1 "ms" a call; ``synchronize`` counts the waits."""

    clock = 0
    waits = 0
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _FakeEvent.made += 1
        self.t = None

    def record(self, stream=None):
        assert stream is _STREAM
        _FakeEvent.clock += 1
        self.t = _FakeEvent.clock

    def synchronize(self):
        _FakeEvent.waits += 1

    def elapsed_time(self, end):
        return float(end.t - self.t)


def test_device_timing_is_read_lazily_from_reused_event_pairs(recorder, monkeypatch):
    """``device=True`` on a card: a pair of timing events recorded at the
    span's ends on the current stream, nothing synchronised until the spans
    are read; the pairs come from a pool reused in turn, so a span whose
    pair was taken again reads no device time."""
    streams = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda card: streams.append(card) or _STREAM)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda card: 7, raising=False)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(_FakeEvent, "clock", 0)
    monkeypatch.setattr(_FakeEvent, "waits", 0)
    monkeypatch.setattr(_FakeEvent, "made", 0)
    monkeypatch.setattr(recorder, "events", profiler._EventPairs(2))
    with profiler.span("ecw.t.dev", device=True):
        with profiler.span("ecw.t.host"):
            _FakeEvent.clock += 5  # device work inside the span
    assert _FakeEvent.waits == 0 and _FakeEvent.made == 2
    dev, host = sorted(profiler.spans(), key=lambda s: s["name"])
    assert dev["device_ms"] == 6.0 and host["device_ms"] is None and _FakeEvent.waits == 1
    for _ in range(2):  # two more device-timed spans take both pairs again
        with profiler.span("ecw.t.later", device=True):
            pass
    got = profiler.spans()
    assert _FakeEvent.made == 4  # pairs are made once and reused
    assert streams == [0]  # the stream object is kept while it stays current
    assert [s["device_ms"] for s in got if s["name"] != "ecw.t.host"] == [None, 1.0, 1.0]


# ------------------------------------------------- features and cache counters


def test_features_span_records_bins_samples_and_launches(recorder, monkeypatch):
    """``prepare_features`` records one ``ecw.audio.features`` span a call:
    its mel bins, the samples it transformed (30 s, or the clip padded to a
    hop) and the K1 launches inside, counted by the kernel's wrapper; a
    stand-in wrapper counts as the real one does and takes the plain path."""
    import numpy as np

    from enhance_cb_whisper_tpu_torch.audio.io import prepare_features
    from enhance_cb_whisper_tpu_torch.ops import mel_cuda
    from enhance_cb_whisper_tpu_torch.ops.mel import log10_mel_plain

    def counted(audio, n_mels=80):
        mel_cuda.kernel.launches += 1
        return log10_mel_plain(audio, n_mels)

    monkeypatch.setattr(mel_cuda, "log10_mel", counted)
    monkeypatch.setattr(mel_cuda.kernel, "launches", 0)
    prepare_features(np.zeros(16000 * 12, np.float32), n_mels=128, device="cpu")
    prepare_features(np.ones(16000 * 40 + 5, np.float32), n_mels=80, device="cpu")
    got = [s for s in profiler.spans() if s["name"] == "ecw.audio.features"]
    assert [s["attrs"] for s in got] == [{"n_mels": 128, "samples": 480000, "launches": 1},
                                         {"n_mels": 80, "samples": 640160, "launches": 1}]
    assert all(s["device_ms"] is None for s in got)  # device-timed on a card only


def test_window_counts_the_decoder_caches_it_allocated(recorder):
    """Each ``ecw.scheduler.window`` carries the bytes of the caches its
    launch allocated, from their shapes: the self-attention K/V of every
    beam row over the whole target length, and one cross-attention K/V per
    slot over the encoder's positions, in every decoder layer."""
    import numpy as np

    from enhance_cb_whisper_tpu_torch.convert import from_jax_whisper_params
    from enhance_cb_whisper_tpu_torch.decoding.generate import GenerationOptions, WhisperGenerator
    from enhance_cb_whisper_tpu_torch.models.whisper import WhisperConfig, init_whisper_params

    cfg = WhisperConfig(vocab_size=128, num_mel_bins=8, d_model=32, encoder_layers=1, encoder_attention_heads=4,
                        decoder_layers=3, decoder_attention_heads=4, encoder_ffn_dim=64, decoder_ffn_dim=64,
                        max_source_positions=24, max_target_positions=30, decoder_start_token_id=3,
                        eos_token_id=2, pad_token_id=0)
    params = from_jax_whisper_params(init_whisper_params(np.random.default_rng(0), cfg), device="cpu")
    gen = WhisperGenerator(cfg, params, device="cpu")
    opts = GenerationOptions(decoder_start_token_id=3, no_timestamps_token_id=100, prev_sot_token_id=99,
                             eos_token_id=2, pad_token_id=0, num_beams=3, max_target_positions=30)
    stream = [(torch.randn(1, 8, 48, generator=torch.Generator().manual_seed(i)), None) for i in range(3)]
    slots, beams, layers, width, f32 = 2, 3, 3, 32, 4
    assert len(list(gen.generate_packed(iter(stream), opts, slots=slots))) == 3
    windows = [s for s in profiler.spans() if s["name"] == "ecw.scheduler.window"]
    assert len(windows) == 2  # three utterances of one window each over two slots
    for w in windows:
        assert w["attrs"]["self_kv_bytes"] == layers * 2 * slots * beams * 30 * width * f32
        assert w["attrs"]["cross_kv_bytes"] == layers * 2 * slots * 24 * width * f32
