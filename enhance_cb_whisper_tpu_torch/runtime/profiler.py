"""Profiling and throughput counters (port of
enhance_cb_whisper_tpu/runtime/profiler.py).

* :func:`trace` — a ``torch.profiler`` window (CPU, plus CUDA when the
  card is there) that writes a gzipped Chrome trace
  ``<time>.<pid>.trace.json.gz`` under ``log_dir``;
* :func:`device_op_breakdown` — the device time of the newest trace under
  a directory, per operation: leaf ops only, repeats summed, the JAX
  package's contract;
* :class:`RTFxMeter` — seconds of audio per second of wall clock.

The JAX package tells device tracks from host ones by a process name
without "CPU".  A Kineto trace names its host process after the program,
so here device work is selected by the event's category: ``kernel``,
``gpu_memcpy`` and ``gpu_memset`` (user annotations mirrored onto the GPU
track, ``gpu_user_annotation``, span kernels and are not counted).
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(log_dir: str, cuda: Optional[bool] = None):
    """Profile the block; yields the ``torch.profiler.profile`` object (for
    ``key_averages()``).  ``cuda`` defaults to ``torch.cuda.is_available()``;
    the card is synchronised before the window closes."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available() if cuda is None else cuda
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
