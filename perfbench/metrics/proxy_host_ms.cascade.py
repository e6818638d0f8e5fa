"""Median host milliseconds of the cascade's stage 1 (``ecw.catalog.proxy``:
every chunk's proxy and the mask, enqueued)."""

from perfbench import spans


def read(ctx):
    return spans.median([spans.duration_ms(s) for s in spans.window(ctx, "ecw.catalog.proxy")["ecw.catalog.proxy"]])
