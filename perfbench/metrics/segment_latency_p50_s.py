"""Median seconds from a segment's submit to its result, over the
segments counted in the window (benchmark clock)."""

import numpy as np


def read(ctx):
    lat = ctx.out.get("latency_s")
    return float(np.median(lat)) if lat else None
