"""Share of the profiled slice in which no device operation ran:
``idle_pct.serve``'s reading, in the v3 cell."""

from perfbench import harness


def read(ctx):
    return harness.load_plugin("metrics", "idle_pct.serve").read(ctx)
