"""Bilinear resize weights with torchvision semantics (port of
enhance_cb_whisper_tpu/ops/resize.py).

A separable resize is two small dense matmuls (``W_h @ X @ W_w^T``); the
interpolation matrices are built host-side in numpy (a copy of the JAX
package's ``_resize_matrix_np``) and contracted on the device:

* non-antialiased: ``src = (i + 0.5) * (in/out) - 0.5`` clamped at 0, two
  taps (ATen ``upsample_bilinear2d``, align_corners=False);
* antialiased downsample: PIL's triangle filter (support = scale,
  normalized), which torch replicates bitwise.

:func:`resize_matrix_dynamic` builds the same weights on the device from a
tensor of input lengths, and :func:`features_from_hidden_states` fuses the
training features (similarity einsum + antialiased resize) into the train
step.  Both want full-fp32 products: TF32 off on the card
(:mod:`..runtime.precision`).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


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


def resize_matrix_dynamic(t_in: torch.Tensor, max_in: int, t_out: int, antialias: bool) -> torch.Tensor:
    """[B, t_out, max_in] interpolation weights for the input lengths
    ``t_in`` [B] (integers as a tensor), on ``t_in``'s device.

    Same semantics as :func:`resize_matrix` (ATen f32 coordinate math, PIL
    triangle filter when antialiased downsampling); columns at or beyond a
    row's length are zero, so padded input frames never reach the output."""
    f32 = torch.float32
    t_in = t_in.to(f32)[:, None, None]
    out_idx = torch.arange(t_out, dtype=f32, device=t_in.device)[None, :, None]
    in_idx = torch.arange(max_in, dtype=f32, device=t_in.device)[None, None, :]
    scale = t_in / float(t_out)

    # plain bilinear (upsample, or antialias=False): two taps
    src = torch.clamp(scale * (out_idx + 0.5) - 0.5, min=0.0)
    i0 = torch.minimum(torch.floor(src), t_in - 1.0)
    i1 = torch.minimum(i0 + 1.0, t_in - 1.0)
    lam = src - i0
    plain = (in_idx == i0) * (1.0 - lam) + (in_idx == i1) * lam
    if not antialias:
        return plain

    # PIL/ATen triangle-filter antialiased downsample
    center = scale * (out_idx + 0.5)
    support = scale
    xmin = torch.clamp(torch.floor(center - support + 0.5), min=0.0)
    xmax = torch.minimum(torch.floor(center + support + 0.5), t_in)
    w = torch.clamp(1.0 - torch.abs((in_idx - center + 0.5) / scale), min=0.0)
    w = w * (in_idx >= xmin) * (in_idx < xmax)
    total = w.sum(dim=2, keepdim=True)
    aa = torch.where(total > 0, w / torch.where(total > 0, total, torch.ones_like(total)),
                     torch.zeros_like(w))
    # upsampling degenerates to the plain path
    return torch.where(scale <= 1.0, plain, aa)


def features_from_hidden_states(kwd: torch.Tensor, utt: torch.Tensor, kwd_len: torch.Tensor,
                                utt_len: torch.Tensor, size, antialias: bool = True) -> torch.Tensor:
    """Training features on the device: the cosine-similarity maps (the
    caches are pre-normalized, so an inner product) followed by the
    collator's antialiased resize.

    ``kwd`` [B, L, T_k_max, D] and ``utt`` [B, L, T_u_max, D] are
    zero-padded past ``kwd_len`` / ``utt_len`` [B]; returns
    [B, L, size[0], size[1]] f32."""
    sims = torch.einsum("blkd,blud->blku", kwd.to(torch.float32), utt.to(torch.float32))
    wk = resize_matrix_dynamic(kwd_len, kwd.shape[-2], size[0], antialias)
    wu = resize_matrix_dynamic(utt_len, utt.shape[-2], size[1], antialias)
    rows = torch.matmul(wk[:, None], sims)  # [B, L, size0, T_u]
    return torch.matmul(rows, wu[:, None].transpose(-1, -2))
