"""Median of one segment's path to its biased prompt, every request in
the window."""

from perfbench.readers import percentile_ms


def read(ctx):
    return percentile_ms(ctx, 50)
