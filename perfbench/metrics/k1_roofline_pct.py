"""Kernel K1's share of its roofline: its least traffic at [1, 480000]
(audio read once, mels written once) at the published HBM rate, over its
device time per launch in the profiled slice."""

from perfbench import flops, trace

N_SAMPLES = 480000


def read(ctx):
    if ctx.summary is None or ctx.peaks is None:
        return None
    seconds, launches = trace.kernel_stats(ctx.summary, "log_mel_kernel")
    if not launches:
        return None
    bound = flops.k1_bytes(N_SAMPLES, ctx.env.config["num_mel_bins"]) / ctx.peaks["hbm_bytes_per_s"]
    return 100.0 * bound / (seconds / launches)
