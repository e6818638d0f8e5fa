"""95th percentile of one segment's path to its biased prompt (audio,
features, encode and spot, prompt ids), over every request in the window."""

from perfbench.readers import percentile_ms


def read(ctx):
    return percentile_ms(ctx, 95)
