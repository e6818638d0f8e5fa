"""Profiling and throughput counters (port of
enhance_cb_whisper_tpu/runtime/profiler.py).

* :func:`trace` — a ``torch.profiler`` window (CPU, plus CUDA when the
  card is there) that writes a gzipped Chrome trace
  ``<time>.<pid>.trace.json.gz`` under ``log_dir``;
* :func:`device_op_breakdown` — the device time of the newest trace under
  a directory, per operation: leaf ops only, repeats summed, the JAX
  package's contract;
* :class:`RTFxMeter` — seconds of audio per second of wall clock;
* :func:`span`, :func:`interval`, :func:`add_counts`, :func:`spans` — the
  program's own spans at its layer boundaries and their counters, kept in
  a bounded in-memory ring (below).

The JAX package tells device tracks from host ones by a process name
without "CPU".  A Kineto trace names its host process after the program,
so here device work is selected by the event's category: ``kernel``,
``gpu_memcpy`` and ``gpu_memset`` (user annotations mirrored onto the GPU
track, ``gpu_user_annotation``, span kernels and are not counted).

Spans.  :func:`span` is a context manager that records a name, its start
and end on ``time.perf_counter_ns``, its parent (the innermost span open
on the same thread), the thread, a request id or ids and a few scalar
attributes.  With ``device=True`` in a process that uses the card it also
records a timing ``torch.cuda.Event`` on the current stream at each end
(from a pool of :data:`EVENT_PAIRS` pairs reused in turn); they become
``device_ms`` only when :func:`spans` reads them, so nothing synchronises
while the program runs.  :func:`interval` records a span
whose start was stamped elsewhere, possibly on another thread (a queue
wait).  While a ``torch.profiler`` records, every :func:`span` also enters
``record_function(name)``, so it lands on the Kineto timeline; otherwise it
never does (``record_function`` costs ~13 µs a use even with no profiler).
Spans live in a ring of :data:`CAPACITY`; the oldest are overwritten and
counted by :func:`dropped`.  Recording is on by default;
:func:`set_recording` turns it off, and :func:`span` then returns one
shared null context after a single flag check.

The port's spans, each named ``ecw.<layer>.<what>`` so that a trace reader
tells them from ATen operators and from a caller's own annotations:

=========================  ==============================================
``ecw.serving.queue_wait``  ``TranscriptionService``: ``submit`` to the
                            scheduler taking the utterance (id: ticket)
``ecw.scheduler.window``    ``generate_packed``: one launch over the slots
                            (id: the occupied slots' stream orders;
                            ``slots``)
``ecw.cbw.encoder``         ``CBWhisper``: the encoder forward that feeds
                            spotting (``rows``; device-timed)
``ecw.cbw.spotter``         ``CBWhisper``: catalog scoring to keywords
                            (``rows``; device-timed)
``ecw.decode.step``         ``beam_search`` / ``greedy_search``: one step,
                            its stop test included (``rows``; a beam
                            step's ``reorder_bytes``, the cache bytes its
                            reorder copied, 0 through an ancestry map,
                            and ``anc_layers``, the decoder layers whose
                            self-attention read through the map)
``ecw.decode.sync``         the stop test's read of the device, a child of
                            ``ecw.decode.step``
``ecw.catalog.proxy``       the cascade's stage 1: every chunk's proxy and
                            the mask (``chunks``; device-timed)
``ecw.audio.features``      ``prepare_features``: the audio's copy to the
                            card, kernel K1 and the log-mel epilogue, on
                            the features' own stream (``n_mels``,
                            ``samples``, ``launches``: K1's; device-timed)
=========================  ==============================================

Counters that a span gathers while it is open (:func:`add_counts`; or
:func:`set_counts`, for a count that each of several calls inside the span
reports whole, such as the decoder's once per segment):
``ecw.scheduler.window`` takes ``self_kv_bytes`` (the self-attention
caches its prefills allocated, beam rows included) and ``cross_kv_bytes``
(its cross-attention K/V, one per slot), both from the tensors' shapes;
``ecw.decode.step`` takes ``reorder_bytes`` and ``anc_layers`` (above).

:func:`to_trace_us` maps a span's ``perf_counter_ns`` time onto a Chrome
trace's ``ts`` through one anchor pair ``(perf_counter_ns, time_ns)`` read
at import and again as each :func:`trace` starts (a Kineto trace's ``ts``
plus its ``baseTimeNanoseconds`` is on the Unix clock), so a device idle
gap can be put down to the span open on the launching thread.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import itertools
import json
import os
import threading
import time
from time import perf_counter_ns
from typing import Any, Dict, List, Optional, Tuple

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(log_dir: str, cuda: Optional[bool] = None):
    """Profile the block; yields the ``torch.profiler.profile`` object (for
    ``key_averages()``).  ``cuda`` defaults to ``torch.cuda.is_available()``;
    the card is synchronised before the window closes."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available() if cuda is None else cuda
    set_anchor()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        name = f"{time.time_ns():020d}.{os.getpid()}.trace.json.gz"
        prof.export_chrome_trace(os.path.join(log_dir, name))


def device_op_breakdown(log_dir: str) -> Tuple[float, List[Dict]]:
    """``(total_device_seconds, ops)`` of the newest ``*.trace.json.gz``
    under ``log_dir`` (by name: :func:`trace` names them by time).  ``ops``
    holds ``{"name", "seconds", "count"}`` per operation, largest first:
    device events only, an event nested inside another on the same track
    counted once (as the leaf), repeats summed.  A trace without device
    events gives ``(0.0, [])``."""
    files = sorted(glob.glob(f"{log_dir}/**/*.trace.json.gz", recursive=True))
    if not files:
        raise FileNotFoundError(f"no *.trace.json.gz under {log_dir}")
    with gzip.open(files[-1]) as f:
        events = json.load(f).get("traceEvents", [])

    by_track: Dict[Tuple, List[dict]] = {}
    for e in events:
        if e.get("ph") == "X" and str(e.get("cat", "")).lower() in DEVICE_CATEGORIES:
            by_track.setdefault((e.get("pid"), e.get("tid")), []).append(dict(e))
    agg: Dict[str, float] = {}
    cnt: Dict[str, int] = {}
    for track in by_track.values():
        track.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
        stack: List[dict] = []
        for e in track:
            while stack and stack[-1]["ts"] + stack[-1].get("dur", 0) <= e["ts"]:
                stack.pop()
            if stack:
                stack[-1]["_parent"] = True
            stack.append(e)
        for e in track:
            if not e.pop("_parent", False):
                agg[e["name"]] = agg.get(e["name"], 0.0) + e.get("dur", 0) / 1e6
                cnt[e["name"]] = cnt.get(e["name"], 0) + 1
    ops = [
        {"name": name, "seconds": round(sec, 6), "count": cnt[name]}
        for name, sec in sorted(agg.items(), key=lambda kv: -kv[1])
    ]
    return sum(agg.values()), ops


class RTFxMeter:
    """Accumulates audio seconds and wall seconds; ``rtfx`` = audio / wall.
    Callers bracket work that ends in a device synchronisation."""

    def __init__(self):
        self.audio_seconds = 0.0
        self.wall_seconds = 0.0
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, audio_seconds: float):
        if self._t0 is None:
            raise RuntimeError("RTFxMeter.stop() without start()")
        self.wall_seconds += time.perf_counter() - self._t0
        self.audio_seconds += audio_seconds
        self._t0 = None

    @property
    def rtfx(self) -> float:
        return self.audio_seconds / self.wall_seconds if self.wall_seconds else 0.0

    def summary(self) -> dict:
        return {
            "audio_seconds": round(self.audio_seconds, 3),
            "wall_seconds": round(self.wall_seconds, 3),
            "rtfx": round(self.rtfx, 3),
        }


# ------------------------------------------------------------------- spans

CAPACITY = 65_536  # spans kept; older ones are overwritten and counted
EVENT_PAIRS = 4_096  # device-timed spans whose device time stays readable


def _read_anchor() -> Tuple[int, int]:
    """``(perf_counter_ns, time_ns)`` read back to back (the middle of two
    ``perf_counter_ns`` reads around the ``time_ns`` one)."""
    a = perf_counter_ns()
    unix = time.time_ns()
    b = perf_counter_ns()
    return (a + b) // 2, unix


_anchor = _read_anchor()


def set_anchor() -> None:
    """Read the clock anchor anew (each :func:`trace` does)."""
    global _anchor
    _anchor = _read_anchor()


def to_trace_us(t_ns: int, base_ns: int) -> float:
    """A ``perf_counter_ns`` time as a Chrome trace's ``ts`` (µs after the
    trace's ``baseTimeNanoseconds``, ``base_ns``)."""
    pc, unix = _anchor
    return (t_ns - pc + unix - base_ns) / 1e3


class _EventPairs:
    """Timing-event pairs reused in turn, per card: creating a CUDA event
    costs far more than recording one.  A span takes the next pair and its
    ticket; once :data:`EVENT_PAIRS` later spans have taken pairs, its own
    is reused and its device time can no longer be read.  Each thread's
    current stream object is kept while the stream stays the same (making
    one costs as much as recording an event)."""

    def __init__(self, size: int):
        self.size = size
        self.tickets = itertools.count()
        self.pairs: Dict[int, list] = {}  # card index -> [size × [start, end, ticket]]

    def take(self, local) -> tuple:
        """``(pair, ticket, stream)`` for a span on this thread's current
        card and stream."""
        ticket = next(self.tickets)
        card = torch.cuda.current_device()
        stream = local.streams.get(card)
        if stream is None or stream.cuda_stream != torch._C._cuda_getCurrentRawStream(card):
            stream = local.streams[card] = torch.cuda.current_stream(card)
        pairs = self.pairs.get(card)
        if pairs is None:
            pairs = self.pairs.setdefault(card, [None] * self.size)
        pair = pairs[ticket % self.size]
        if pair is None:
            pair = pairs[ticket % self.size] = [torch.cuda.Event(enable_timing=True),
                                                torch.cuda.Event(enable_timing=True), ticket]
        pair[2] = ticket
        return pair, ticket, stream


class Recorder:
    """The ring of spans and the per-thread stacks of open ones.  The ring
    is a ``deque`` with a ``maxlen``, whose appends are atomic, so any
    thread may record without a lock; each record carries its append
    count, from which :attr:`dropped` follows."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = int(capacity)
        self.recording = True
        self.local = threading.local()
        self.seq = itertools.count(1)
        self.events = _EventPairs(EVENT_PAIRS)
        self.reset()

    def reset(self) -> None:
        self.ring: "collections.deque[tuple]" = collections.deque(maxlen=self.capacity)
        self.appends = itertools.count()

    def stack(self) -> list:
        """This thread's open spans, innermost last."""
        try:
            return self.local.stack
        except AttributeError:
            self.local.stack = []
            self.local.thread = threading.current_thread().name
            self.local.streams = {}
            return self.local.stack

    def records(self) -> List[tuple]:
        """The kept records, oldest first."""
        while True:
            try:
                return list(self.ring)
            except RuntimeError:  # another thread appended during the copy
                continue

    @property
    def dropped(self) -> int:
        ring = self.records()
        return max(r[0] for r in ring) + 1 - len(ring) if ring else 0


# a record: (append count, seq, name, start_ns, end_ns, parent seq, id,
# thread, attrs, (event pair, its ticket) or None)
RECORDER = Recorder()
_NULL = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


class _Span:
    """An open host span (no device events, no profiler)."""

    __slots__ = ("name", "id", "attrs", "seq", "parent", "t0")

    def __init__(self, name, id, attrs):
        self.name, self.id, self.attrs = name, id, attrs

    def __enter__(self):
        rec = RECORDER
        stack = rec.stack()
        self.parent = stack[-1].seq if stack else None
        self.seq = next(rec.seq)
        stack.append(self)
        self.t0 = perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._close(perf_counter_ns(), None)
        return False

    def _close(self, t1: int, device) -> None:
        rec = RECORDER
        stack = rec.local.stack
        if stack and stack[-1] is self:
            stack.pop()
        rec.ring.append((next(rec.appends), self.seq, self.name, self.t0, t1, self.parent, self.id,
                         rec.local.thread, self.attrs, device))


class _TimedSpan(_Span):
    """An open span with device events, or inside a profiler's
    ``record_function``, or both."""

    __slots__ = ("timed", "device", "rf")

    def __init__(self, name, id, attrs, device):
        super().__init__(name, id, attrs)
        self.timed = device and torch.cuda.is_initialized()
        self.device = self.rf = None

    def __enter__(self):
        super().__enter__()
        if self.timed:
            self.device = RECORDER.events.take(RECORDER.local)
            pair, _, stream = self.device
            pair[0].record(stream)
        if _profiling():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        device = None
        if self.device is not None:
            pair, ticket, stream = self.device
            pair[1].record(stream)
            device = (pair, ticket)
        self._close(t1, device)
        return False


def span(name: str, id: Any = None, device: bool = False, **attrs):
    """Record the block as a span (module docstring); ``device=True`` also
    times it on the card's current stream."""
    if not RECORDER.recording:
        return _NULL
    if device or _profiling():
        return _TimedSpan(name, id, attrs, device)
    return _Span(name, id, attrs)


def interval(name: str, start_ns: int, id: Any = None, **attrs) -> None:
    """Record a span from ``start_ns`` (``perf_counter_ns``, stamped on any
    thread) to now, its parent the innermost span open on this thread.  It
    is not device-timed and does not reach a profiler's timeline."""
    if not RECORDER.recording:
        return
    end = perf_counter_ns()
    rec = RECORDER
    stack = rec.stack()
    rec.ring.append((next(rec.appends), next(rec.seq), name, int(start_ns), end,
                     stack[-1].seq if stack else None, id, rec.local.thread, attrs, None))


def _innermost(name: str) -> Optional[_Span]:
    """The innermost span named ``name`` open on this thread, if recording."""
    if RECORDER.recording:
        for open_span in reversed(RECORDER.stack()):
            if open_span.name == name:
                return open_span
    return None


def add_counts(name: str, **counts: int) -> None:
    """Add ``counts`` to the attributes of the innermost span named
    ``name`` open on this thread (a counter summed while the span is open);
    nothing when no such span is open or recording is off."""
    open_span = _innermost(name)
    if open_span is not None:
        for key, value in counts.items():
            open_span.attrs[key] = open_span.attrs.get(key, 0) + value


def set_counts(name: str, **counts: int) -> None:
    """Set ``counts`` as attributes of the innermost span named ``name``
    open on this thread (a count that several calls inside the span each
    report whole, not a sum); nothing when no such span is open or
    recording is off."""
    open_span = _innermost(name)
    if open_span is not None:
        open_span.attrs.update(counts)


def spans(since_s: Optional[float] = None, until_s: Optional[float] = None) -> List[Dict[str, Any]]:
    """The kept spans whose end lies in ``(since_s, until_s]``
    (``perf_counter`` seconds; None leaves a side open), oldest first:
    ``name``, ``seq``, ``parent`` (its parent's ``seq`` or None), ``id``,
    ``thread``, ``start_s``, ``end_s``, ``device_ms`` (None unless
    device-timed and among the newest :data:`EVENT_PAIRS` device-timed
    spans; reading it waits for the span's device work) and ``attrs``."""
    out = []
    for _, seq, name, t0, t1, parent, id_, thread, attrs, device in RECORDER.records():
        end_s = t1 / 1e9
        if (since_s is not None and end_s <= since_s) or (until_s is not None and end_s > until_s):
            continue
        device_ms = None
        if device is not None and device[0][2] == device[1]:  # its pair not reused since
            device[0][1].synchronize()
            device_ms = device[0][0].elapsed_time(device[0][1])
        out.append({"name": name, "seq": seq, "parent": parent, "id": id_, "thread": thread,
                    "start_s": t0 / 1e9, "end_s": end_s, "device_ms": device_ms, "attrs": dict(attrs)})
    return out


def reset() -> None:
    """Empty the ring (and the count of dropped spans)."""
    RECORDER.reset()


def dropped() -> int:
    """Spans overwritten since the last :func:`reset`."""
    return RECORDER.dropped


def set_recording(flag: bool) -> bool:
    """Turn recording on or off; returns the previous setting."""
    previous = RECORDER.recording
    RECORDER.recording = bool(flag)
    return previous
