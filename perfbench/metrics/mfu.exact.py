"""The catalog scorer's FLOPs over the window (exact ResNet maps,
similarities, the proxy, the utterance's projection) at the published peak
of the cell's compute type."""

from perfbench.readers import mfu_pct


def read(ctx):
    return mfu_pct(ctx, ctx.env.mix["dtype"])
