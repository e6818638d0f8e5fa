"""Arithmetic the metric readers share (``perfbench/metrics/<name>.py``)."""

from __future__ import annotations

from typing import Optional

import numpy as np

PEAK_KEYS = {"float32": "fp32_flops", "bfloat16": "bf16_flops"}


def percentile_ms(ctx, q: float) -> Optional[float]:
    lat = ctx.out.get("latency_s")
    return float(np.percentile(lat, q)) * 1e3 if lat else None


def idle_pct(ctx) -> Optional[float]:
    if ctx.summary is None or ctx.slice_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.summary["busy_s"] / ctx.slice_s)


def mfu_pct(ctx, dtype: str) -> Optional[float]:
    """The window's counted FLOPs over its wall at the card's published
    peak for ``dtype`` (None on a card the table does not list)."""
    if ctx.peaks is None or not ctx.out.get("flops"):
        return None
    return 100.0 * ctx.out["flops"] / (ctx.out["window_s"] * ctx.peaks[PEAK_KEYS[dtype]])
