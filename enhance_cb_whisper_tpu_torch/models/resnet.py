"""ResNet-18/34/50 feature extractor + linear head, eval forward (port of
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
BatchNorm eps 1e-5, running statistics in eval.  Layout is torch's NCHW:
inputs [batch, layers, T_kwd, T_utt] feed the stem directly.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn


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


class ConvNormAct(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, act: bool = True):
        super().__init__()
        self.convolution = nn.Conv2d(
            in_channels, out_channels, kernel_size, stride=stride,
            padding=kernel_size // 2, bias=False,
        )
        self.normalization = nn.BatchNorm2d(out_channels, eps=1e-5)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.normalization(self.convolution(x))
        return torch.relu(x) if self.act else x


class ShortCut(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int):
        super().__init__()
        self.convolution = nn.Conv2d(in_channels, out_channels, 1, stride=stride, bias=False)
        self.normalization = nn.BatchNorm2d(out_channels, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.normalization(self.convolution(x))


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


class ResNet(nn.Module):
    """Feature extractor: NCHW input → pooled [batch, hidden_sizes[-1]]."""

    def __init__(self, config: ResNetConfig):
        super().__init__()
        self.config = config
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
        x = self.pool(self.embedder(pixel_values.to(torch.float32)))
        for name in self.block_names:
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))


class ResNetClassifier(nn.Module):
    """ResNet feature extractor + linear head → (logits, pooled features)."""

    def __init__(self, config: ResNetConfig):
        super().__init__()
        self.config = config
        self.feature_extractor = ResNet(config)
        self.classifier = nn.Linear(config.hidden_sizes[-1], config.num_labels)

    def forward(self, pixel_values: torch.Tensor):
        features = self.feature_extractor(pixel_values)
        return self.classifier(features), features
