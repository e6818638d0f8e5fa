"""ResNet-18/34/50 feature extractor + linear head (port of
enhance_cb_whisper_tpu/models/resnet.py).

Same architecture as HF ``ResNetModel`` and the flax module, with the
module names of the flax tree (so :func:`..convert.from_flax_resnet_variables`
maps names one to one):

* embedder: 7x7 conv stride 2 (pad 3, no bias) + BatchNorm + ReLU, then a
  3x3 max-pool stride 2 pad 1;
* 4 stages of bottleneck (1x1 → 3x3 (stride) → 1x1, reduction 4) or basic
  (3x3 → 3x3) blocks; a strided 1x1 conv + BN shortcut where the shape
  changes; stage strides (1, 2, 2, 2);
* global average pool.

Convolutions pad symmetrically by ``k // 2`` (flax's explicit padding);
BatchNorm eps 1e-5.  Layout is torch's NCHW: inputs [batch, layers, T_kwd,
T_utt] feed the stem directly (the JAX package's ``channels_last`` NHWC
input has no counterpart here).

Training follows flax:

* BatchNorm normalizes by the batch statistics and updates its running
  statistics as ``ra = 0.9 ra + 0.1 stat`` with the *biased* batch
  variance (:class:`BatchNorm`; ``nn.BatchNorm2d`` would take the unbiased
  one);
* ``dtype=torch.bfloat16`` casts the input and each convolution's kernel
  to bf16 (bf16 activations and convolutions) while parameters, BatchNorm
  statistics and the pooled features stay f32, as the flax module's
  ``dtype`` does;
* ``remat=True`` recomputes each residual block in the backward pass
  (``torch.utils.checkpoint``): the same gradients, a smaller live set of
  activations.  The recomputation leaves the running statistics alone.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    num_channels: int = 12
    embedding_size: int = 64
    hidden_sizes: Sequence[int] = (256, 512, 1024, 2048)
    depths: Sequence[int] = (3, 4, 6, 3)
    layer_type: str = "bottleneck"  # "bottleneck" | "basic"
    num_labels: int = 2
    downsample_in_first_stage: bool = False

    @classmethod
    def from_version(cls, version: str, num_channels: int, num_labels: int = 2) -> "ResNetConfig":
        if version == "resnet-18":
            return cls(num_channels, 64, (64, 128, 256, 512), (2, 2, 2, 2), "basic", num_labels)
        if version == "resnet-34":
            return cls(num_channels, 64, (64, 128, 256, 512), (3, 4, 6, 3), "basic", num_labels)
        if version == "resnet-50":
            return cls(num_channels=num_channels, num_labels=num_labels)
        raise ValueError(f"unknown resnet version: {version}")


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose running variance follows flax.

    Both normalize a training batch by its biased variance, but torch moves
    the running variance toward the unbiased one, ``n / (n - 1)`` larger
    (n = batch × H × W).  The running update here is torch's own (one fused
    pass) with that factor taken back out.  ``frozen`` skips the update:
    a rematerialized block's second forward must not count twice."""

    frozen = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        n = x.numel() // x.shape[1]
        # update copies: autograd keeps the statistics it was handed, and a
        # frozen (recomputing) forward must save the same tensors as the first
        mean, var = self.running_mean.clone(), self.running_var.clone()
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 0.1, self.eps)
        if not self.frozen:
            with torch.no_grad():
                # torch added 0.1 · var · n/(n-1); flax adds 0.1 · var
                old = self.running_var.to(torch.float64)
                added = (var.to(torch.float64) - 0.9 * old) * ((n - 1) / n)
                self.running_mean.copy_(mean)
                self.running_var.copy_(0.9 * old + added)
        return y


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` on ``x`` in ``x``'s dtype (the f32 kernel cast to it)."""
    return F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride, conv.padding)


class ConvNormAct(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, act: bool = True):
        super().__init__()
        self.convolution = nn.Conv2d(
            in_channels, out_channels, kernel_size, stride=stride,
            padding=kernel_size // 2, bias=False,
        )
        self.normalization = BatchNorm(out_channels, eps=1e-5)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.normalization(_conv(self.convolution, x))
        return torch.relu(x) if self.act else x


class ShortCut(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int):
        super().__init__()
        self.convolution = nn.Conv2d(in_channels, out_channels, 1, stride=stride, bias=False)
        self.normalization = BatchNorm(out_channels, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.normalization(_conv(self.convolution, x))


class BottleneckBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int = 1, reduction: int = 4):
        super().__init__()
        reduced = out_channels // reduction
        self.shortcut = (
            ShortCut(in_channels, out_channels, stride)
            if in_channels != out_channels or stride != 1 else None
        )
        self.layer_0 = ConvNormAct(in_channels, reduced, 1, 1)
        self.layer_1 = ConvNormAct(reduced, reduced, 3, stride)
        self.layer_2 = ConvNormAct(reduced, out_channels, 1, 1, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = self.shortcut(x) if self.shortcut is not None else x
        return torch.relu(self.layer_2(self.layer_1(self.layer_0(x))) + residual)


class BasicBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int = 1):
        super().__init__()
        self.shortcut = (
            ShortCut(in_channels, out_channels, stride)
            if in_channels != out_channels or stride != 1 else None
        )
        self.layer_0 = ConvNormAct(in_channels, out_channels, 3, stride)
        self.layer_1 = ConvNormAct(out_channels, out_channels, 3, 1, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = self.shortcut(x) if self.shortcut is not None else x
        return torch.relu(self.layer_1(self.layer_0(x)) + residual)


@contextlib.contextmanager
def _frozen_statistics(block: nn.Module):
    norms = [m for m in block.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.frozen = True
    try:
        yield
    finally:
        for m in norms:
            m.frozen = False


class ResNet(nn.Module):
    """Feature extractor: NCHW input → pooled f32 [batch, hidden_sizes[-1]]."""

    def __init__(self, config: ResNetConfig, dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.remat = remat
        self.embedder = ConvNormAct(config.num_channels, config.embedding_size, 7, 2)
        self.pool = nn.MaxPool2d(3, stride=2, padding=1)
        block = BottleneckBlock if config.layer_type == "bottleneck" else BasicBlock
        self.block_names = []
        in_ch = config.embedding_size
        for stage_idx, (width, depth) in enumerate(zip(config.hidden_sizes, config.depths)):
            first_stride = 2 if (stage_idx > 0 or config.downsample_in_first_stage) else 1
            for block_idx in range(depth):
                name = f"stage_{stage_idx}_block_{block_idx}"
                self.add_module(name, block(in_ch, width, first_stride if block_idx == 0 else 1))
                self.block_names.append(name)
                in_ch = width

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        x = self.pool(self.embedder(pixel_values.to(self.dtype)))
        for name in self.block_names:
            blk = getattr(self, name)
            if self.remat and self.training and torch.is_grad_enabled():
                x = checkpoint(blk, x, use_reentrant=False,
                               context_fn=lambda b=blk: (contextlib.nullcontext(), _frozen_statistics(b)))
            else:
                x = blk(x)
        return x.mean(dim=(2, 3)).to(torch.float32)


class ResNetClassifier(nn.Module):
    """ResNet feature extractor + linear head → (logits, pooled features)."""

    def __init__(self, config: ResNetConfig, dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        self.config = config
        self.feature_extractor = ResNet(config, dtype=dtype, remat=remat)
        self.classifier = nn.Linear(config.hidden_sizes[-1], config.num_labels)

    def forward(self, pixel_values: torch.Tensor):
        features = self.feature_extractor(pixel_values)
        return self.classifier(features), features
