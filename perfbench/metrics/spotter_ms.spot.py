"""Median device milliseconds of a request's catalog scoring to keywords
(``ecw.cbw.spotter``)."""

from perfbench import spans


def read(ctx):
    return spans.median(spans.device_ms(spans.window(ctx, "ecw.cbw.spotter")["ecw.cbw.spotter"]))
