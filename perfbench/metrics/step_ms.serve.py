"""The decode's wall per beam step: the decode time of the window's
launches (synchronised at its start) over the steps the wrapper of the
generator's step counted."""


def read(ctx):
    steps = sum(ctx.out.get("steps", []))
    return 1e3 * ctx.out["decode_s"] / steps if steps and ctx.out.get("decode_s") else None
