"""The program's own spans (``enhance_cb_whisper_tpu_torch/runtime/
profiler.py``) that ended inside a run's window, for the ``program_span``
metric readers.

A run's ``setup_end`` and ``window_s`` are stamped on
``time.perf_counter``, the spans' clock; a span counts when its end lies
in ``(setup_end, setup_end + window_s]``.  A program without the
recorder gives no spans, and the readers then return None.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def window(ctx, *names: str) -> Dict[str, List[dict]]:
    """The window's spans of each of ``names``, oldest first."""
    try:
        from enhance_cb_whisper_tpu_torch.runtime.profiler import spans
    except ImportError:
        return {name: [] for name in names}
    lo = ctx.out["setup_end"]
    got = spans(since_s=lo, until_s=lo + ctx.out["window_s"])
    return {name: [s for s in got if s["name"] == name] for name in names}


def duration_ms(span: dict) -> float:
    return 1e3 * (span["end_s"] - span["start_s"])


def device_ms(spans: List[dict]) -> List[float]:
    """The device times of the spans that have one."""
    return [s["device_ms"] for s in spans if s["device_ms"] is not None]


def median(values: List[float]) -> Optional[float]:
    return float(np.median(values)) if values else None


def mean(values: List[float]) -> Optional[float]:
    return float(np.mean(values)) if values else None


def step_parts_ms(ctx) -> List[Tuple[float, float]]:
    """Per ``ecw.decode.step`` in the window: (host ms, wait ms), the wait
    being its ``ecw.decode.sync`` child and the host the rest."""
    got = window(ctx, "ecw.decode.step", "ecw.decode.sync")
    wait = {s["parent"]: duration_ms(s) for s in got["ecw.decode.sync"]}
    return [(duration_ms(s) - wait[s["seq"]], wait[s["seq"]]) for s in got["ecw.decode.step"] if s["seq"] in wait]
