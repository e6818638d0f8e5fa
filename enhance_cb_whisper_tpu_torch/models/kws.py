"""Paper-1 KWS classifier and the heads of its adversarial training (port of
enhance_cb_whisper_tpu/models/kws.py).

A 12-input-channel ResNet-50 + linear head over stacked cosine-similarity
"images" [batch, 12, T_kwd, T_utt] → logits over {absent, present}, the
pooled features that feed the domain discriminator, and optionally the CE
loss.  Training adds the gradient-reversal layer, the discriminator heads
and the entropy loss.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from .resnet import BatchNorm, ResNetClassifier, ResNetConfig


@dataclasses.dataclass
class KWSOutput:
    logits: torch.Tensor
    features: torch.Tensor
    loss: Optional[torch.Tensor] = None


class DiscOutput(NamedTuple):
    logits: torch.Tensor
    loss: Optional[torch.Tensor] = None


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = -100) -> torch.Tensor:
    """Mean CE over the labels other than ``ignore_index``, divided by
    ``max(valid, 1)``: a batch whose every label is ignored gives 0, where
    ``F.cross_entropy(ignore_index=...)`` gives NaN (the multi-keyword
    collator labels ghost keywords -100)."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -logp.gather(-1, safe[:, None].long())[:, 0]
    denom = valid.sum().clamp(min=1)
    return torch.where(valid, nll, torch.zeros_like(nll)).sum() / denom


def entropy_loss(logits: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of the entropy of the softmax distribution."""
    logp = torch.log_softmax(logits, dim=1)
    p = torch.softmax(logits, dim=1)
    return -1.0 * (p * logp).sum(dim=1).mean()


class _GradReverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, beta):
        ctx.beta = beta
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.beta * g, None


def grad_reverse(x: torch.Tensor, beta: float) -> torch.Tensor:
    """Gradient-reversal layer: identity forward, gradient × ``-beta``
    backward."""
    return _GradReverse.apply(x, float(beta))


class KWSModel(nn.Module):
    def __init__(self, config: ResNetConfig, dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.config = config
        self.model = ResNetClassifier(config, dtype=dtype, remat=remat)

    def forward(self, input_features: torch.Tensor, labels: Optional[torch.Tensor] = None) -> KWSOutput:
        logits, features = self.model(input_features)
        loss = cross_entropy(logits, labels) if labels is not None else None
        return KWSOutput(logits=logits, features=features, loss=loss)

    def load_converted(self, state: Dict[str, torch.Tensor]) -> "KWSModel":
        """Load a state from :func:`..convert.from_flax_resnet_variables`
        (every parameter and running statistic must be present)."""
        missing, unexpected = self.load_state_dict(state, strict=False)
        missing = [m for m in missing if not m.endswith("num_batches_tracked")]
        if missing or unexpected:
            raise ValueError(f"KWS state mismatch: missing {missing}, unexpected {unexpected}")
        return self


class DiscriminatorHead(nn.Module):
    """One linear layer."""

    def __init__(self, in_features: int, num_labels: int):
        super().__init__()
        self.linear = nn.Linear(in_features, num_labels)

    def forward(self, x: torch.Tensor, keep=None) -> torch.Tensor:
        return self.linear(x.reshape(x.shape[0], -1))


class DiscriminatorHeadLarge(nn.Module):
    """Three linear layers with ReLU + Dropout(0.5) between them.  ``keep``
    gives the two dropout masks (bool, [batch, in_features // 2] each) in
    training; without it the head is deterministic."""

    def __init__(self, in_features: int, num_labels: int):
        super().__init__()
        hidden = in_features // 2
        self.dense_0 = nn.Linear(in_features, hidden)
        self.dense_1 = nn.Linear(hidden, hidden)
        self.dense_2 = nn.Linear(hidden, num_labels)

    def forward(self, x: torch.Tensor, keep=None) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        x = torch.relu(self.dense_0(x))
        if keep is not None:  # inverted dropout at rate 0.5: kept values × 2
            x = torch.where(keep[0], x / 0.5, torch.zeros_like(x))
        x = torch.relu(self.dense_1(x))
        if keep is not None:
            x = torch.where(keep[1], x / 0.5, torch.zeros_like(x))
        return self.dense_2(x)


class Discriminator(nn.Module):
    """Domain classifier behind the gradient-reversal layer; ``beta`` is an
    argument of each call."""

    def __init__(self, in_features: int, num_labels: int, large: bool = False):
        super().__init__()
        self.large = large
        head = DiscriminatorHeadLarge if large else DiscriminatorHead
        self.head = head(in_features, num_labels)

    def forward(self, input_features: torch.Tensor, labels: Optional[torch.Tensor] = None,
                beta: float = 0.0, use_grad_reverse: bool = True, keep=None) -> DiscOutput:
        x = grad_reverse(input_features, beta) if use_grad_reverse else input_features
        logits = self.head(x, keep=keep)
        loss = cross_entropy(logits, labels) if labels is not None else None
        return DiscOutput(logits=logits, loss=loss)


def init_kws_model(config: ResNetConfig, generator: torch.Generator) -> KWSModel:
    """A KWS model with random weights drawn from ``generator``, for
    benchmarks and smoke runs where no trained checkpoint exists: He-normal
    convolutions, identity BatchNorm statistics with the last BN of each
    residual branch zeroed (torchvision's ``zero_init_residual``, so deep
    stacks keep their activation scale), a small normal head."""
    last_bn = "layer_2.normalization" if config.layer_type == "bottleneck" else "layer_1.normalization"
    model = KWSModel(config).eval()
    with torch.no_grad():
        for name, module in model.named_modules():
            if isinstance(module, nn.Conv2d):
                fan_in = module.in_channels * module.kernel_size[0] * module.kernel_size[1]
                module.weight.normal_(0.0, float(np.sqrt(2.0 / fan_in)), generator=generator)
            elif isinstance(module, BatchNorm):
                module.weight.fill_(0.0 if name.endswith(last_bn) else 1.0)
                module.bias.zero_()
                module.running_mean.zero_()
                module.running_var.fill_(1.0)
            elif isinstance(module, nn.Linear):
                module.weight.normal_(0.0, 0.01, generator=generator)
                module.bias.zero_()
    return model
