"""Cosine-similarity primitives (port of enhance_cb_whisper_tpu/ops/sim.py).

* :func:`l2_normalize` with ``eps=None`` is the reference's raw
  ``x / ||x||_2`` (zero vectors become NaN, as there); with ``eps`` the norm
  is clamped below at ``eps`` (clamp on the squared norm, as in JAX).
* :func:`sim_matrix` is the eps-stabilized cosine-similarity matrix.
"""

from __future__ import annotations

from typing import Optional

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: Optional[float] = None) -> torch.Tensor:
    if eps is None:
        return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    sq = torch.sum(x * x, dim=dim, keepdim=True)
    return x / torch.sqrt(torch.clamp_min(sq, eps * eps))


def sim_matrix(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """[..., T_a, D] x [..., T_b, D] → [..., T_a, T_b], norms clamped at eps."""
    return torch.einsum(
        "...ad,...bd->...ab", l2_normalize(a, eps=eps), l2_normalize(b, eps=eps)
    )
