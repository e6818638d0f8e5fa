"""The launches' model FLOPs over the window's wall at the published FP32
peak: ``mfu.serve``'s reading, in the v3 cell."""

from perfbench import harness


def read(ctx):
    return harness.load_plugin("metrics", "mfu.serve").read(ctx)
