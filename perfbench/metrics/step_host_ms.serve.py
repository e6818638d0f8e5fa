"""Mean host milliseconds of a decode step outside its stop test's wait
for the card: each ``ecw.decode.step`` less its ``ecw.decode.sync``."""

from perfbench import spans


def read(ctx):
    return spans.mean([host for host, _ in spans.step_parts_ms(ctx)])
