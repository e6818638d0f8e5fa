"""Share of the scheduler's slots that held a segment, over the launches
(``ecw.scheduler.window`` spans, id the occupied slots' orders) that
ended in the window."""

from perfbench import spans


def read(ctx):
    launches = spans.window(ctx, "ecw.scheduler.window")["ecw.scheduler.window"]
    slots = sum(s["attrs"]["slots"] for s in launches)
    return 100.0 * sum(len(s["id"]) for s in launches) / slots if slots else None
