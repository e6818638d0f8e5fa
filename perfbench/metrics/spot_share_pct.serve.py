"""Share of the window's wall inside ``encode_and_spot`` (the wrapper
synchronises before and after it in the traced run)."""


def read(ctx):
    spot = ctx.out.get("spot_s")
    return 100.0 * spot / ctx.out["window_s"] if spot else None
