"""Share of the window's wall that the card spent in the encoder forward
that feeds spotting: the device times of the ``ecw.cbw.encoder`` spans that
ended in the window, summed."""

from perfbench import spans


def read(ctx):
    times = spans.device_ms(spans.window(ctx, "ecw.cbw.encoder")["ecw.cbw.encoder"])
    return 100.0 * sum(times) / 1e3 / ctx.out["window_s"] if times else None
