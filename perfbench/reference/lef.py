"""Paper 2's LEF scorer, written out plainly.

* projection: per layer ``Linear(W, D/2) → ReLU → Linear(D/2, U)``, then
  per layer ``Conv1d(U, U, 3, padding 1) → BatchNorm (running statistics)
  → MaxPool1d(3, 2, 1)`` over frames; masks pooled the same way;
* similarity: per layer cosine maps of keyword frames against utterance
  frames (norms clamped at 1e-6), times the frame masks;
* the exact score: ResNet-50 over the maps, a linear head, the softmax's
  class 1;
* the MaxSim proxy: per keyword frame its best similarity over the
  utterance's frames, averaged over the keyword's frames, then over layers.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from . import resnet
from .precision import Prec

ROWS = 1024  # keywords per block: bounds the reference's memory


def project(w: Dict[str, torch.Tensor], cfg: dict, x: torch.Tensor, mask: Optional[torch.Tensor],
            prec: Prec):
    """[B, L, T, W] → ([B, L, ceil(T/2), U], pooled mask [B, L, ceil(T/2)] or None)."""
    outs = []
    for i in range(cfg["n_layers"]):
        h = torch.relu(prec.linear(x[:, i], w[f"projector.proj_{i}_0.weight"], w[f"projector.proj_{i}_0.bias"]))
        h = prec.linear(h, w[f"projector.proj_{i}_1.weight"], w[f"projector.proj_{i}_1.bias"])
        h = prec.conv1d(h.transpose(1, 2), w[f"time_projector.conv_{i}.weight"],
                        w[f"time_projector.conv_{i}.bias"], padding=1)
        bn = f"time_projector.bn_{i}"
        h = F.batch_norm(h, w[f"{bn}.running_mean"], w[f"{bn}.running_var"], w[f"{bn}.weight"],
                         w[f"{bn}.bias"], False, 0.0, 1e-5)
        outs.append(F.max_pool1d(h, 3, stride=2, padding=1).transpose(1, 2))
    if mask is not None:
        b, n_layers, t = mask.shape
        mask = F.max_pool1d(mask.reshape(b * n_layers, 1, t).float(), 3, stride=2, padding=1).reshape(b, n_layers, -1)
    return torch.stack(outs, dim=1), mask


def _unit(x):
    x = x.to(torch.float32)
    return x / torch.sqrt(torch.clamp_min((x * x).sum(-1, keepdim=True), 1e-12))


def sims(kwd, utt, kwd_mask, utt_mask, prec: Prec) -> torch.Tensor:
    """[B, L, T_k, T_u] masked cosine maps (``utt`` [1, L, T_u, U])."""
    s = prec.matmul(_unit(kwd), _unit(utt).transpose(-1, -2))
    return s * utt_mask.float()[:, :, None, :] * kwd_mask.float()[:, :, :, None]


def proxy(kwd, utt, kwd_mask, utt_mask, prec: Prec) -> torch.Tensor:
    """MaxSim proxy [B] of keyword rows against the utterance."""
    s = prec.matmul(_unit(kwd), _unit(utt).transpose(-1, -2))
    s = torch.where(utt_mask.float()[:, :, None, :] > 0, s, torch.full_like(s, -1e30))
    top = s.amax(-1)
    best = torch.where(kwd_mask.float() > 0, top, top.new_zeros(()))
    per_layer = best.sum(-1) / kwd_mask.float().sum(-1).clamp_min(1.0)
    return per_layer.mean(-1)


def probs(w, cfg, kwd, utt, kwd_mask, utt_mask, prec: Prec, batch: int = 64) -> torch.Tensor:
    """Exact class-1 probabilities [B] of projected keyword rows."""
    out = []
    for i in range(0, kwd.shape[0], batch):
        maps = sims(kwd[i:i + batch], utt, kwd_mask[i:i + batch], utt_mask, prec)
        logits = resnet.logits(w, cfg["resnet"], maps, "model.", "classifier", prec)
        out.append(torch.softmax(logits, dim=-1)[:, 1])
    return torch.cat(out)


def proxy_all(kwd, utt, kwd_mask, utt_mask, prec: Prec) -> torch.Tensor:
    """The proxy of every catalog row, ``ROWS`` at a time."""
    return torch.cat([proxy(kwd[i:i + ROWS], utt, kwd_mask[i:i + ROWS], utt_mask, prec)
                      for i in range(0, kwd.shape[0], ROWS)])
