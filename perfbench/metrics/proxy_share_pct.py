"""Share of the profiled requests' device time spent under the
cascade's stage 1 (``pb:proxy`` around ``maxsim_proxy_fast``)."""


def read(ctx):
    if ctx.summary is None or not ctx.summary["device_s"]:
        return None
    proxy = ctx.summary["by_annotation"].get("pb:proxy")
    return 100.0 * proxy / ctx.summary["device_s"] if proxy else None
