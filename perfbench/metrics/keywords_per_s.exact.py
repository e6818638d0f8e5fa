"""Catalog keywords ranked per second: the catalog size times the
utterances scored, over the window from the first request to the first
completion at or after its length (host clock)."""


def read(ctx):
    if "keywords" not in ctx.out:
        return None
    return ctx.out["keywords"] * ctx.out["attempted"] / ctx.out["window_s"]
