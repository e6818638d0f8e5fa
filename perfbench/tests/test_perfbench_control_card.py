"""On the card, at each cell's own size: on three seeds the program passes
its limits and the control (the plain reference one precision below the
configuration's, in the program's place) fails them.  Skips without a
card; run on the card with ``python -m pytest perfbench/tests -m card``."""

import pytest

from perfbench import control, harness

# a window at the cell's own load long enough for the requests the check draws
WINDOW_S = {"cbw-whisper-medium.serve16": 30.0, "cbw-whisper-medium.spot": 12.0,
            "kws-lef.cascade-100k": 8.0, "kws-lef.exact-1k": 12.0}


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(WINDOW_S))
def test_program_passes_and_control_fails(cell, card):
    bench = harness.load_benchmark()
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        line = control.read_seed(bench, cell, seed, WINDOW_S[cell], card, control=True)
        assert line["program_correct"], line
        assert not line["control_correct"], line
