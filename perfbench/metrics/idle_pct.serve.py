"""Share of the profiled slice in which no device operation ran."""

from perfbench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
