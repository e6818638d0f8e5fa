"""Real-time-factor meter (a copy of the JAX package's ``RTFxMeter``)."""

from __future__ import annotations

import time
from typing import Optional


class RTFxMeter:
    """Accumulates audio seconds and wall seconds; ``rtfx`` = audio / wall.
    Callers bracket work that ends in a device synchronisation."""

    def __init__(self):
        self.audio_seconds = 0.0
        self.wall_seconds = 0.0
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, audio_seconds: float):
        if self._t0 is None:
            raise RuntimeError("RTFxMeter.stop() without start()")
        self.wall_seconds += time.perf_counter() - self._t0
        self.audio_seconds += audio_seconds
        self._t0 = None

    @property
    def rtfx(self) -> float:
        return self.audio_seconds / self.wall_seconds if self.wall_seconds else 0.0

    def summary(self) -> dict:
        return {
            "audio_seconds": round(self.audio_seconds, 3),
            "wall_seconds": round(self.wall_seconds, 3),
            "rtfx": round(self.rtfx, 3),
        }
