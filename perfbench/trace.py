"""A bounded profiler window and its reduction to device numbers.

:func:`profiled` wraps ``torch.profiler`` over a slice of steady work; the
trace is written under ``TMPDIR``, read back and deleted.  :func:`summarize`
reduces it:

* device operations: kernel, memcpy and memset events; an event nested in
  another on the same track counts once, as the leaf; repeats summed
  (the arithmetic of the port's ``runtime/profiler.py:device_op_breakdown``,
  enhance_cb_whisper_tpu_torch/runtime/profiler.py:71);
* busy seconds: the union of the device operations' intervals;
* per host annotation (``record_function`` names that start with ``pb:``),
  the device seconds of the operations launched inside it, found through
  the launch's correlation id;
* idle gaps: each stretch with no device operation, named by what the
  launching thread was inside at its middle (innermost ``pb:`` annotation
  and innermost host op), summed by name.
"""

from __future__ import annotations

import contextlib
import gzip
import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "pb:"


class Slice:
    """What a profiled slice leaves: the trace's events and the slice's
    wall seconds (host clock, device synchronised at both ends)."""

    def __init__(self):
        self.events: List[dict] = []
        self.wall_s = 0.0


@contextlib.contextmanager
def profiled(device):
    """Profile the block (CPU and, on a card, CUDA activity); yields a
    :class:`Slice` filled when the block ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    out = Slice()
    prof = profile(activities=activities)
    if cuda:
        torch.cuda.synchronize(device)
    prof.start()
    t0 = time.perf_counter()
    try:
        yield out
    finally:
        if cuda:
            torch.cuda.synchronize(device)
        out.wall_s = time.perf_counter() - t0
        prof.stop()
        fd, path = tempfile.mkstemp(suffix=".trace.json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            opener = gzip.open if path.endswith(".gz") else open
            with opener(path, "rt") as f:
                out.events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)


def _leaves(events: List[dict]) -> List[dict]:
    """Device events, nested ones counted once (the leaf), per track."""
    by_track: Dict[Tuple, List[dict]] = {}
    for e in events:
        if e.get("ph") == "X" and str(e.get("cat", "")).lower() in DEVICE_CATEGORIES:
            by_track.setdefault((e.get("pid"), e.get("tid")), []).append(dict(e))
    leaves = []
    for track in by_track.values():
        track.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
        stack: List[dict] = []
        for e in track:
            while stack and stack[-1]["ts"] + stack[-1].get("dur", 0) <= e["ts"]:
                stack.pop()
            if stack:
                stack[-1]["_parent"] = True
            stack.append(e)
        leaves.extend(e for e in track if not e.pop("_parent", False))
    return leaves


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


class _Stack:
    """Walks one thread's well-nested host intervals in time order and
    answers which are open at increasing times."""

    def __init__(self, intervals: List[dict]):
        self.items = sorted(intervals, key=lambda e: (e["ts"], -e.get("dur", 0)))
        self.next = 0
        self.open: List[dict] = []

    def at(self, t: float) -> List[dict]:
        while self.next < len(self.items) and self.items[self.next]["ts"] <= t:
            e = self.items[self.next]
            while self.open and self.open[-1]["ts"] + self.open[-1].get("dur", 0) <= e["ts"]:
                self.open.pop()
            self.open.append(e)
            self.next += 1
        while self.open and self.open[-1]["ts"] + self.open[-1].get("dur", 0) <= t:
            self.open.pop()
        return [e for e in self.open if e["ts"] + e.get("dur", 0) > t]


def _innermost(open_events: List[dict], annotation: bool) -> Optional[str]:
    for e in reversed(open_events):
        is_pb = str(e.get("name", "")).startswith(PREFIX)
        if is_pb == annotation:
            return str(e["name"])
    return None


def summarize(s: Slice, top: int = 10) -> dict:
    """``busy_s``, ``device_s`` (leaf sum), ``ops`` {name: [seconds,
    count]}, ``by_annotation`` {pb-name: device seconds}, ``idle_gaps``
    [[name, seconds]] (largest ``top``), ``device_ops`` [[name, seconds]]
    (largest ``top``)."""
    events = s.events
    leaves = _leaves(events)
    ops: Dict[str, List[float]] = {}
    for e in leaves:
        rec = ops.setdefault(e["name"], [0.0, 0])
        rec[0] += e.get("dur", 0) / 1e6
        rec[1] += 1
    spans = _union([(e["ts"], e["ts"] + e.get("dur", 0)) for e in leaves])
    busy = sum(b - a for a, b in spans) / 1e6

    # the host side: runtime launches (by correlation id) and the intervals
    # of each thread that launched device work
    launches: Dict[int, dict] = {}
    host: Dict[Tuple, List[dict]] = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = str(e.get("cat", "")).lower()
        if cat in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = e
        elif cat in ("cpu_op", "user_annotation", "python_function"):
            host.setdefault((e.get("pid"), e.get("tid")), []).append(e)

    # device seconds under each pb: annotation of the launching thread
    by_annotation: Dict[str, float] = {}
    per_thread: Dict[Tuple, List[Tuple[float, float]]] = {}
    for e in leaves:
        launch = launches.get((e.get("args") or {}).get("correlation"))
        if launch is not None:
            per_thread.setdefault((launch.get("pid"), launch.get("tid")), []).append(
                (launch["ts"], e.get("dur", 0) / 1e6))
    for thread, items in per_thread.items():
        walker = _Stack([h for h in host.get(thread, []) if str(h.get("name", "")).startswith(PREFIX)])
        for ts, dur in sorted(items):
            for name in {str(h["name"]) for h in walker.at(ts)}:
                by_annotation[name] = by_annotation.get(name, 0.0) + dur

    # idle gaps inside the slice, named by the busiest launching thread
    gaps: Dict[str, float] = {}
    if spans and per_thread:
        main = max(per_thread, key=lambda k: len(per_thread[k]))
        walker = _Stack(host.get(main, []))
        for (_, end), (start, _) in zip(spans[:-1], spans[1:]):
            open_events = walker.at((end + start) / 2)
            label = _innermost(open_events, annotation=True) or "outside any pb: span"
            op = _innermost(open_events, annotation=False)
            name = f"{label} > {op}" if op else label
            gaps[name] = gaps.get(name, 0.0) + (start - end) / 1e6
    by_time = sorted(ops.items(), key=lambda kv: -kv[1][0])
    return {
        "busy_s": busy,
        "device_s": sum(v[0] for v in ops.values()),
        "ops": ops,
        "by_annotation": by_annotation,
        "device_ops": [[name[:160], sec] for name, (sec, _) in by_time[:top]],
        "idle_gaps": [[name[:160], sec] for name, sec in sorted(gaps.items(), key=lambda kv: -kv[1])[:top]],
    }


def kernel_stats(summary: dict, fragment: str) -> Tuple[float, int]:
    """(device seconds, launches) of the operations whose name holds
    ``fragment``."""
    sec, count = 0.0, 0
    for name, (s, n) in summary["ops"].items():
        if fragment in name:
            sec += s
            count += n
    return sec, count
