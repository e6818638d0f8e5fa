"""Median device milliseconds of a request's features: the
``ecw.audio.features`` spans (``prepare_features``: the audio's copy to
the card, kernel K1 and the log-mel epilogue) that ended in the window."""

from perfbench import spans


def read(ctx):
    return spans.median(spans.device_ms(spans.window(ctx, "ecw.audio.features")["ecw.audio.features"]))
