"""Mean host milliseconds of a decode step outside its stop test's wait for
the card: ``step_host_ms.serve``'s reading, in the v3 cell."""

from perfbench import harness


def read(ctx):
    return harness.load_plugin("metrics", "step_host_ms.serve").read(ctx)
