"""Hidden-state cache IO (port of enhance_cb_whisper_tpu/catalog/store.py).

A cache holds one Whisper-encoder hidden-state stack [n_layers, T, D] per
utterance or keyword: plain ``.npy`` (the JAX package's native format), or
the reference pipeline's ``.bin`` (one ``torch.save`` pickle per stack),
read with ``torch.load(weights_only=True)``.  A ``.npy`` beside a ``.bin``
path wins, as in the JAX package.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def load_hidden_states(path: str) -> np.ndarray:
    """A [n_layers, T, D] stack from ``.npy`` or a reference ``.bin``, always
    float32 (float16-stored caches are upcast)."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32, copy=False)
    npy = os.path.splitext(path)[0] + ".npy"
    if os.path.exists(npy):
        return np.load(npy).astype(np.float32, copy=False)
    if os.path.exists(path):
        with open(path, "rb") as f:
            t = torch.load(f, map_location="cpu", weights_only=True)
        return t.detach().to(torch.float32).numpy()
    raise FileNotFoundError(path)


def save_hidden_states(path: str, hs: np.ndarray, dtype=np.float32) -> None:
    """Write a stack as ``.npy`` (the suffix is forced) in ``dtype``;
    ``np.float16`` halves the file, and :func:`load_hidden_states` upcasts
    it again (the stacks are L2-normalized, so the rounding is ~1e-3)."""
    if not path.endswith(".npy"):
        path = os.path.splitext(path)[0] + ".npy"
    np.save(path, np.asarray(hs, dtype=dtype))


def hidden_states_exist(path: str) -> bool:
    return os.path.exists(path) or os.path.exists(os.path.splitext(path)[0] + ".npy")
