"""The launches' model FLOPs (encoder, cross K/V, spotter, prefill,
each decode step) over the window's wall, at the published FP32 peak."""

from perfbench.readers import mfu_pct


def read(ctx):
    return mfu_pct(ctx, "float32")
