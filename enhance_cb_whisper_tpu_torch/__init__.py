"""enhance_cb_whisper_tpu_torch — the PyTorch/CUDA port of enhance_cb_whisper_tpu.

The JAX package beside it is the reference: every module here mirrors the
path and name of its JAX counterpart (``ops/mel.py`` ↔ ``ops/mel.py``, ...)
and is held against it by ``tests/test_torch_*.py``.

Slice 1 covers the shortform CB-Whisper main path on one NVIDIA H100: mel
front end (hand-written CUDA kernel ``csrc/mel.cu``) → Whisper encoder →
catalog keyword spotting → biased beam/greedy decode → entity recall.
Slice 2 adds int8 keyword spotting (``models/quant.py``, whose bottleneck
1×1 convolutions run the hand-written kernel ``csrc/matmul_s8.cu``) for
CB-Whisper and the paper-1 KWS eval (``runtime/kws_engine.py``).  Longform
transcription adds the 30 s seek loop with condition-on-prev
prompts and the temperature-fallback ladder (``decoding/generate.py``),
and the resampling audio front end (``audio/io.py``).  The command line
(``cli/``: ``cb-whisper.py test`` and ``kws.py test|validate`` from config
files) reads the eval datasets (``data/``), HF Whisper checkpoint
directories (``models/whisper_loader.py``) and KWS checkpoints
(``models/torch_compat.py``, ``runtime/checkpoint.py``).  Paper 2's
open-vocabulary spotter (``efficient_kws/``: the L/LE/LEF models, projected
and cascade catalog scoring, its eval) runs from the same command line.
Entry points run on
the card unless the caller passes ``device="cpu"``, and turn TF32 off
there (``runtime/precision.py``).  The
package imports torch and numpy, never jax, flax or the JAX package: the
numpy-only helpers it needs are copied in.
"""

__version__ = "0.1.0"
