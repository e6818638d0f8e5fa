"""A bottleneck ResNet in eval mode, written out plainly.

Stem: 7x7 convolution stride 2 padding 3, BatchNorm, ReLU, 3x3 max-pool
stride 2 padding 1.  Stages of bottleneck blocks (1x1 reduce, 3x3 with the
stage's stride, 1x1 expand, each with BatchNorm; ReLU after the first two
and after the residual sum), a 1x1 strided shortcut with BatchNorm where
the shape changes; stage strides 1, 2, 2, 2; global average pool.
BatchNorm reads its running statistics, eps 1e-5.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .precision import Prec


def _conv_bn(w: Dict[str, torch.Tensor], name: str, x, stride: int, prec: Prec, relu: bool = True):
    k = w[f"{name}.convolution.weight"]
    y = prec.conv2d(x, k, stride=stride, padding=k.shape[-1] // 2)
    y = F.batch_norm(y, w[f"{name}.normalization.running_mean"], w[f"{name}.normalization.running_var"],
                     w[f"{name}.normalization.weight"], w[f"{name}.normalization.bias"], False, 0.0, 1e-5)
    return torch.relu(y) if relu else y


def features(w: Dict[str, torch.Tensor], rcfg: dict, x: torch.Tensor, prefix: str, prec: Prec) -> torch.Tensor:
    """x [B, C, H, W] → pooled [B, hidden_sizes[-1]]."""
    x = F.max_pool2d(_conv_bn(w, f"{prefix}embedder", x, 2, prec), 3, stride=2, padding=1)
    in_ch = rcfg["embedding_size"]
    for s, (width, depth) in enumerate(zip(rcfg["hidden_sizes"], rcfg["depths"])):
        for b in range(depth):
            stride = (2 if s > 0 else 1) if b == 0 else 1
            name = f"{prefix}stage_{s}_block_{b}"
            if in_ch != width or stride != 1:
                residual = _conv_bn(w, f"{name}.shortcut", x, stride, prec, relu=False)
            else:
                residual = x
            h = _conv_bn(w, f"{name}.layer_0", x, 1, prec)
            h = _conv_bn(w, f"{name}.layer_1", h, stride, prec)
            x = torch.relu(_conv_bn(w, f"{name}.layer_2", h, 1, prec, relu=False) + residual)
            in_ch = width
    return x.mean(dim=(2, 3))


def logits(w, rcfg, x, prefix: str, head: str, prec: Prec) -> torch.Tensor:
    """The classifier's logits [B, 2]."""
    return prec.linear(features(w, rcfg, x, prefix, prec), w[f"{head}.weight"], w[f"{head}.bias"])
