"""Paper-1 KWS classifier, eval forward (port of enhance_cb_whisper_tpu/models/kws.py).

A 12-input-channel ResNet-50 + linear head over stacked cosine-similarity
"images" [batch, 12, T_kwd, T_utt] → logits over {absent, present}.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
from torch import nn

from .resnet import ResNetClassifier, ResNetConfig


@dataclasses.dataclass
class KWSOutput:
    logits: torch.Tensor
    features: torch.Tensor


class KWSModel(nn.Module):
    def __init__(self, config: ResNetConfig):
        super().__init__()
        self.config = config
        self.model = ResNetClassifier(config)

    def forward(self, input_features: torch.Tensor) -> KWSOutput:
        logits, features = self.model(input_features)
        return KWSOutput(logits=logits, features=features)

    def load_converted(self, state: Dict[str, torch.Tensor]) -> "KWSModel":
        """Load a state from :func:`..convert.from_flax_resnet_variables`
        (every parameter and running statistic must be present)."""
        missing, unexpected = self.load_state_dict(state, strict=False)
        missing = [m for m in missing if not m.endswith("num_batches_tracked")]
        if missing or unexpected:
            raise ValueError(f"KWS state mismatch: missing {missing}, unexpected {unexpected}")
        return self


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
            elif isinstance(module, nn.BatchNorm2d):
                module.weight.fill_(0.0 if name.endswith(last_bn) else 1.0)
                module.bias.zero_()
                module.running_mean.zero_()
                module.running_var.fill_(1.0)
            elif isinstance(module, nn.Linear):
                module.weight.normal_(0.0, 0.01, generator=generator)
                module.bias.zero_()
    return model
