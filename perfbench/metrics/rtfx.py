"""Seconds of audio transcribed per wall second, over the whole launches
between the opening and the closing burst of results (host clock)."""


def read(ctx):
    return ctx.out["audio_s"] / ctx.out["window_s"] if "audio_s" in ctx.out else None
