"""Paper-2 KWS model: the L / LE / LEF variants (port of
enhance_cb_whisper_tpu/efficient_kws/model.py).

* **L** (``learn_features=False``): cosine-similarity maps over the raw
  Whisper embeddings, one channel per layer, into a ResNet-18/34/50;
* **LE** (``proj_mlp=True``): a per-layer MLP ``Linear(W, D/2) → ReLU →
  Linear(D/2, proj_mlp_units)`` projects both sides before the similarity
  (W is the stacks' width, D ``embedding_dim``: flax's ``Dense`` takes its
  input width from the data, so W need not be D);
* **LEF** (``frames_conv=True``): then a per-layer ``Conv1d(U, U, k=3, p=1)
  → BatchNorm → MaxPool1d(3, 2, 1)`` halves the frame axis.

Padded frames are zeroed by multiplying the maps with the f32 frame masks.
LEF's masks are max-pooled with the frames' (3, 2, 1) window: a pooled
frame is valid if any frame of its window was (the JAX package's repair of
the reference, which crashes there).

Module names follow the flax tree (``model``, ``classifier``,
``projector.proj_{i}_{j}``, ``time_projector.conv_{i}`` / ``bn_{i}``), so
:func:`..convert.from_flax_efficient_variables` maps names one to one.  The
time projector works in torch's NCW layout: ``[B, T, U]`` is transposed to
``[B, U, T]`` around the convolution, its BatchNorm and the pool.
``dtype=torch.bfloat16`` runs the projection stack and the ResNet in bf16
(parameters, BatchNorm statistics and the similarity in f32), as the flax
module's ``dtype`` does.  In train mode every BatchNorm normalizes by the
batch and moves its running statistics as flax does (:class:`..models.
resnet.BatchNorm`); LEF's time projector runs once for the keywords and
once for the utterances, so its statistics move twice a step, in that
order, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..models.resnet import BatchNorm, ResNet, ResNetConfig


@dataclasses.dataclass(frozen=True)
class EfficientKWSConfig:
    """The reference hyperparameters (a copy of the JAX dataclass)."""

    n_layers: int = 3
    embedding_dim: int = 1024
    learn_features: bool = False
    proj_mlp: bool = False
    proj_mlp_units: int = 64
    frames_conv: bool = False
    resnet_version: str = "resnet-50"
    threshold: float = 0.5

    def resnet_config(self) -> ResNetConfig:
        return ResNetConfig.from_version(self.resnet_version, self.n_layers, 2)


def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer`` in ``x``'s dtype (its f32 weights cast to it)."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


class PerLayerMLP(nn.Module):
    """One ``Linear(in_dim, D/2) → ReLU → Linear(D/2, units)`` per layer:
    ``in_dim`` is the width of the stacks it takes, D ``embedding_dim``."""

    def __init__(self, in_dim: int, embedding_dim: int, units: int, n_layers: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_layers = n_layers
        self.dtype = dtype
        for i in range(n_layers):
            self.add_module(f"proj_{i}_0", nn.Linear(in_dim, embedding_dim // 2))
            self.add_module(f"proj_{i}_1", nn.Linear(embedding_dim // 2, units))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, L, T, D] → [B, L, T, units]
        if self.dtype is not None:
            x = x.to(self.dtype)
        outs = []
        for i in range(self.n_layers):
            h = torch.relu(_linear(getattr(self, f"proj_{i}_0"), x[:, i]))
            outs.append(_linear(getattr(self, f"proj_{i}_1"), h))
        return torch.stack(outs, dim=1)


class PerLayerTimeConv(nn.Module):
    """Per layer: ``Conv1d(U, U, 3, padding 1)`` → BatchNorm (f32, eps 1e-5,
    the running statistics) → ``MaxPool1d(3, 2, 1)``: [B, L, T, U] →
    [B, L, ceil(T/2), U]."""

    def __init__(self, units: int, n_layers: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_layers = n_layers
        self.dtype = dtype
        for i in range(n_layers):
            self.add_module(f"conv_{i}", nn.Conv1d(units, units, 3, padding=1))
            # the ResNet's BatchNorm on [B, U, T]: eval reads the running statistics
            self.add_module(f"bn_{i}", BatchNorm(units, eps=1e-5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = []
        for i in range(self.n_layers):
            conv = getattr(self, f"conv_{i}")
            h = x[:, i].transpose(1, 2)  # NWC → NCW
            if self.dtype is not None:
                h = h.to(self.dtype)
            h = F.conv1d(h, conv.weight.to(h.dtype), conv.bias.to(h.dtype), padding=1)
            h = getattr(self, f"bn_{i}")(h.to(torch.float32))
            if self.dtype is not None:
                h = h.to(self.dtype)
            outs.append(F.max_pool1d(h, 3, stride=2, padding=1).transpose(1, 2))
        return torch.stack(outs, dim=1)


def _safe_normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    """x / max(||x||, eps), the *squared* norm clamped at eps² (finite at
    x == 0, the JAX package's form)."""
    sq = torch.sum(x * x, dim=-1, keepdim=True)
    return x / torch.sqrt(torch.clamp_min(sq, eps * eps))


def sim_matrix(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Cosine similarity ``[..., U, D] x [..., K, D] → [..., U, K]`` in f32,
    norms clamped at eps."""
    a = _safe_normalize(a, eps).to(torch.float32)
    b = _safe_normalize(b, eps).to(torch.float32)
    return torch.matmul(a, b.transpose(-1, -2))


def masked_sims(kwd: torch.Tensor, utt: torch.Tensor, kwd_mask=None, utt_mask=None) -> torch.Tensor:
    """Per-layer cosine-similarity maps ``[B, L, T_k, T_u]`` (keyword frames
    on H), f32, padded frames zeroed by the f32 masks.  A ``[1, ...]``
    utterance broadcasts against B keywords."""
    k = _safe_normalize(kwd, 1e-6).to(torch.float32)
    u = _safe_normalize(utt, 1e-6).to(torch.float32)
    sims = torch.matmul(k, u.transpose(-1, -2))
    if utt_mask is not None:
        sims = sims * utt_mask.to(torch.float32)[:, :, None, :]
    if kwd_mask is not None:
        sims = sims * kwd_mask.to(torch.float32)[:, :, :, None]
    return sims


def _pool_mask(mask: torch.Tensor) -> torch.Tensor:
    """Max-pool [B, L, T] masks with (k=3, s=2, p=1), LEF's frame halving."""
    b, l, t = mask.shape
    return F.max_pool1d(mask.reshape(b * l, 1, t), 3, stride=2, padding=1).reshape(b, l, -1)


class EfficientKWSModel(nn.Module):
    """Projection stack (LE/LEF) + similarity + ResNet + a linear head over
    {absent, present}.  Call :meth:`eval` before scoring: the BatchNorms
    read their running statistics."""

    def __init__(self, config: EfficientKWSConfig, dtype: torch.dtype = torch.float32,
                 input_dim: Optional[int] = None):
        """``input_dim`` is the width of the hidden-state stacks the
        projector takes (``embedding_dim`` when not given; a loaded state
        brings its own, :meth:`load_converted`)."""
        super().__init__()
        self.config = config
        self.dtype = dtype
        rcfg = config.resnet_config()
        self.model = ResNet(rcfg, dtype=dtype)
        self.classifier = nn.Linear(rcfg.hidden_sizes[-1], 2)
        # f32 projection stack by default; bf16 runs its matmuls in bf16
        self._proj_dtype = None if dtype == torch.float32 else dtype
        if config.learn_features and config.proj_mlp:
            self.projector = self._projector(input_dim or config.embedding_dim)
            if config.frames_conv:
                self.time_projector = PerLayerTimeConv(config.proj_mlp_units, config.n_layers,
                                                       dtype=self._proj_dtype)

    def _projector(self, in_dim: int) -> PerLayerMLP:
        cfg = self.config
        return PerLayerMLP(in_dim, cfg.embedding_dim, cfg.proj_mlp_units, cfg.n_layers,
                           dtype=self._proj_dtype)

    def load_converted(self, state) -> "EfficientKWSModel":
        """Load a state from :func:`..convert.from_flax_efficient_variables`
        or :func:`.torch_compat.load_torch_efficient_kws` (every parameter
        and running statistic must be present).  The projector takes the
        input width of the state's ``projector.proj_0_0``."""
        width = state.get("projector.proj_0_0.weight")
        if width is not None and hasattr(self, "projector") \
                and width.shape[1] != self.projector.proj_0_0.in_features:
            device = self.projector.proj_0_0.weight.device
            self.projector = self._projector(int(width.shape[1])).to(device)
        missing, unexpected = self.load_state_dict(state, strict=False)
        missing = [k for k in missing if not k.endswith("num_batches_tracked")]
        if missing or unexpected:
            raise ValueError(f"paper-2 state mismatch: missing {missing}, unexpected {unexpected}")
        return self

    def project(self, features: torch.Tensor, mask: Optional[torch.Tensor] = None):
        """The learned projection stack alone: [B, L, T, D] → ([B, L, T', U],
        the mask pooled as the frames were).  Pre-projects large keyword
        catalogs (:mod:`.catalog`)."""
        cfg = self.config
        if cfg.learn_features and cfg.proj_mlp:
            x = self.projector(features)
            if cfg.frames_conv:
                x = self.time_projector(x)
                if mask is not None:
                    mask = _pool_mask(mask)
            return x, mask
        return features, mask

    def classify_projected(self, kwd, utt, kwd_mask=None, utt_mask=None):
        """Similarity + ResNet + head over already-projected features (with
        the masks :meth:`project` returned) → (logits, sims)."""
        sims = masked_sims(kwd, utt, kwd_mask, utt_mask)
        return self.classifier(self.model(sims)), sims

    def forward(self, kwd_features, utt_features, kwd_mask=None, utt_mask=None):
        """``kwd_features`` [B, L, T_k, D], ``utt_features`` [B or 1, L, T_u,
        D], masks [B, L, T] → (logits [B, 2], sims [B, L, T_k', T_u'])."""
        kwd, kwd_mask = self.project(kwd_features, kwd_mask)
        utt, utt_mask = self.project(utt_features, utt_mask)
        return self.classify_projected(kwd, utt, kwd_mask, utt_mask)
