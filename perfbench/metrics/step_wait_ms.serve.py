"""Mean milliseconds a decode step waits for the card at its stop test
(``ecw.decode.sync``, the child of each ``ecw.decode.step``)."""

from perfbench import spans


def read(ctx):
    return spans.mean([wait for _, wait in spans.step_parts_ms(ctx)])
