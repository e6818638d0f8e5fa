"""Encoder and spotter FLOPs of the window's requests over its wall, at
the published FP32 peak."""

from perfbench.readers import mfu_pct


def read(ctx):
    return mfu_pct(ctx, "float32")
