"""Median device milliseconds of the cascade's stage 1 (``ecw.catalog.proxy``
timed by events on the card's stream); beside ``proxy_host_ms.cascade`` it
tells a host-paced stage 1 (the two alike) from a device-paced one."""

from perfbench import spans


def read(ctx):
    return spans.median(spans.device_ms(spans.window(ctx, "ecw.catalog.proxy")["ecw.catalog.proxy"]))
