"""Set-up seconds: from the start of the run to the end of warm-up
(imports, weights, catalog, the first launch or request), host clock."""


def read(ctx):
    return ctx.setup_s
