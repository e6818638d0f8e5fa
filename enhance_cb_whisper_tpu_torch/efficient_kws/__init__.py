"""Paper 2, "Massive Open-Vocabulary Keyword-Spotting": the L/LE/LEF
models, pre-projected catalog scoring, the training and eval datasets,
and the engine that trains (from hidden-state caches or from audio) and
evaluates them (port of enhance_cb_whisper_tpu/efficient_kws/)."""

from .model import EfficientKWSConfig, EfficientKWSModel

__all__ = ["EfficientKWSConfig", "EfficientKWSModel"]
