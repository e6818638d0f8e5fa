"""The general traffic generator: what every request of a mix carries.

A mix file (``workloads/<cell>.json``) gives the parameters; this module
turns them and the run's seed into requests.  A mix's audio is a fixed
pool of ``block`` clips, drawn from the mix's ``pool_seed``, their lengths
evenly spaced over ``seconds`` = [lo, hi].  The requests come in blocks of
``block``, each block every clip once, in an order drawn from the run's
seed.  So every seed does the same work in another order: with random
weights, how many windows a segment's decode takes depends on its audio,
and clips drawn per seed made one seed's window hold a quarter fewer
segments than another's.
"""

from __future__ import annotations

from typing import List

import numpy as np

SAMPLE_RATE = 16000


def clips(mix: dict, seed: int, count: int) -> List[int]:
    """The clips of the first ``count`` requests."""
    out: List[int] = []
    block = 0
    while len(out) < count:
        rng = np.random.default_rng([int(seed) & (2**64 - 1), 31, block])
        out.extend(int(c) for c in rng.permutation(mix["block"]))
        block += 1
    return out[:count]


def seconds(mix: dict, clip: int) -> float:
    lo, hi = mix["seconds"]
    return float(np.linspace(lo, hi, mix["block"])[clip])


def audio(mix: dict, clip: int) -> np.ndarray:
    return noise_and_tone(mix["pool_seed"], clip, seconds(mix, clip))


def noise_and_tone(pool_seed: int, clip: int, length_s: float) -> np.ndarray:
    """16 kHz mono float32: noise at a drawn level with a drawn tone over
    it and a silent tail, as ``chip_smoke.py``'s ``_audio`` makes it
    (chip_smoke.py:236)."""
    rng = np.random.default_rng([int(pool_seed) & (2**64 - 1), 32, int(clip)])
    n = int(round(length_s * SAMPLE_RATE))
    voiced = int(n * rng.uniform(0.6, 0.95))
    level = rng.uniform(0.02, 0.12)
    freq = rng.uniform(150.0, 900.0)
    t = np.arange(voiced, dtype=np.float64) / SAMPLE_RATE
    out = np.zeros((n,), np.float32)
    out[:voiced] = (rng.standard_normal(voiced) * level + 0.1 * np.sin(2 * np.pi * freq * t)).astype(np.float32)
    return out
