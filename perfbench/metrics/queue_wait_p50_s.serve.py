"""Median seconds a segment waited in the service's queue, from ``submit``
to the scheduler taking it (the program's ``ecw.serving.queue_wait``
spans that ended in the window)."""

from perfbench import spans


def read(ctx):
    waits = spans.window(ctx, "ecw.serving.queue_wait")["ecw.serving.queue_wait"]
    return spans.median([s["end_s"] - s["start_s"] for s in waits])
