"""Median gigabytes (1e9 B) of decoder caches a launch allocated: the
``self_kv_bytes`` (beam rows' self-attention K/V) plus ``cross_kv_bytes``
(one cross-attention K/V per slot) counters of the ``ecw.scheduler.window``
spans that ended in the window.  A program whose windows lack the counters
gives None."""

from perfbench import spans


def read(ctx):
    launches = spans.window(ctx, "ecw.scheduler.window")["ecw.scheduler.window"]
    sizes = [s["attrs"]["self_kv_bytes"] + s["attrs"]["cross_kv_bytes"] for s in launches
             if "self_kv_bytes" in s["attrs"] and "cross_kv_bytes" in s["attrs"]]
    return spans.median(sizes) / 1e9 if sizes else None
