"""Top-k with ``lax.top_k``'s contract (port of
enhance_cb_whisper_tpu/decoding/topk.py).

``torch.topk`` documents neither its tie order nor distinct indices on
rows of equal values.  Beam search needs both, exactly as ``lax.top_k``
gives them:

* values in descending order;
* ties go to the LOWER index;
* indices are distinct even on ``-inf`` rows (NEG_INF-masked logprobs added
  to NEG_INF dead-beam scores overflow to ``-inf``).

A stable descending sort guarantees all three: it keeps equal values in
their original (ascending index) order.
"""

from __future__ import annotations

from typing import Tuple

import torch


def exact_top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``k`` largest entries along the last axis."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]
