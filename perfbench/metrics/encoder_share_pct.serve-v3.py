"""Share of the window's wall that the card spent in the encoder forward
that feeds spotting: ``encoder_share_pct.serve``'s reading, in the v3
cell."""

from perfbench import harness


def read(ctx):
    return harness.load_plugin("metrics", "encoder_share_pct.serve").read(ctx)
