"""Paper 2, "Massive Open-Vocabulary Keyword-Spotting": the L/LE/LEF
models, pre-projected catalog scoring, the eval datasets and the eval
engine (port of enhance_cb_whisper_tpu/efficient_kws/; training is
ROADMAP.md §1 item 6b)."""

from .model import EfficientKWSConfig, EfficientKWSModel

__all__ = ["EfficientKWSConfig", "EfficientKWSModel"]
