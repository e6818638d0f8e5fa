"""Bilinear resize weights with torchvision semantics (port of
enhance_cb_whisper_tpu/ops/resize.py).

A separable resize is two small dense matmuls (``W_h @ X @ W_w^T``); the
interpolation matrices are built host-side in numpy (a copy of the JAX
package's ``_resize_matrix_np``) and contracted on the device:

* non-antialiased: ``src = (i + 0.5) * (in/out) - 0.5`` clamped at 0, two
  taps (ATen ``upsample_bilinear2d``, align_corners=False);
* antialiased downsample: PIL's triangle filter (support = scale,
  normalized), which torch replicates bitwise.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


@lru_cache(maxsize=4096)
def _resize_matrix_np(in_size: int, out_size: int, antialias: bool) -> np.ndarray:
    w = np.zeros((out_size, in_size), dtype=np.float64)
    if in_size == out_size:
        np.fill_diagonal(w, 1.0)
        return w.astype(np.float32)
    # torch computes source coordinates in the input's opmath type (float32
    # for float32 tensors); mirror that so boundary lambdas match bitwise.
    scale = np.float32(in_size) / np.float32(out_size)
    if not antialias or scale <= 1.0:
        # aten upsample_bilinear2d, align_corners=False.  (For upsampling,
        # the antialiased path degenerates to this same computation.)
        for i in range(out_size):
            src = max(scale * (np.float32(i) + np.float32(0.5)) - np.float32(0.5),
                      np.float32(0.0))
            i0 = min(int(np.floor(src)), in_size - 1)
            i1 = min(i0 + 1, in_size - 1)
            lam = np.float32(src) - np.float32(i0)
            w[i, i0] += float(np.float32(1.0) - lam)
            w[i, i1] += float(lam)
    else:
        # PIL / aten antialiased downsample with the triangle (bilinear) filter.
        support = scale  # filter support 1.0 * scale
        for i in range(out_size):
            center = scale * (np.float32(i) + np.float32(0.5))
            xmin = max(int(center - support + 0.5), 0)
            xmax = min(int(center + support + 0.5), in_size)
            xs = np.arange(xmin, xmax, dtype=np.float32)
            weights = np.maximum(
                np.float32(0.0),
                np.float32(1.0) - np.abs((xs - center + np.float32(0.5)) / scale),
            )
            total = weights.sum(dtype=np.float32)
            if total > 0:
                w[i, xmin:xmax] = (weights / total).astype(np.float64)
    return w.astype(np.float32)


def resize_matrix(in_size: int, out_size: int, antialias: bool) -> np.ndarray:
    """[out_size, in_size] interpolation weights along one axis."""
    return _resize_matrix_np(int(in_size), int(out_size), bool(antialias))
