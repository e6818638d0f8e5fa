"""Reference paper-2 Lightning checkpoints → a ``state_dict`` of the port's
:class:`.model.EfficientKWSModel` (port of
enhance_cb_whisper_tpu/efficient_kws/torch_compat.py).

The reference ``KWSModel`` holds
* ``model`` — an HF ``ResNetModel`` under ``model.feature_extractor`` and a
  ``Sequential(Flatten, Linear)`` head at ``model.classifier.1``;
* ``projector.{i}`` — ``Sequential(Linear, ReLU, Linear)`` per layer (LE,
  LEF);
* ``time_projector.{i}`` — ``Sequential(Conv1d, BatchNorm1d, MaxPool1d)``
  per layer (LEF).

Both sides are torch, so only names change: the ResNet's as in
:mod:`..models.torch_compat` (then ``model.feature_extractor.`` →
``model.``, ``model.classifier`` → ``classifier``), ``projector.{i}.{0,2}``
→ ``projector.proj_{i}_{0,1}``, ``time_projector.{i}.0`` → ``conv_{i}`` and
``.1`` → ``bn_{i}``.  Tensors come out float32.
:func:`lightning_efficient_kws` is the inverse, for writing a checkpoint
in the reference's layout.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

from ..models.torch_compat import lightning_resnet_classifier, load_hf_resnet_classifier
from .model import EfficientKWSConfig

_BN = ("weight", "bias", "running_mean", "running_var")


def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().to(torch.float32).clone()


def load_torch_efficient_kws(state_dict: Mapping[str, Any],
                             config: EfficientKWSConfig) -> Dict[str, torch.Tensor]:
    """A reference paper-2 ``state_dict`` (or the ``.ckpt`` dict holding one
    under ``state_dict``) → entries of ``EfficientKWSModel.state_dict()``,
    for :meth:`.model.EfficientKWSModel.load_converted`."""
    if "state_dict" in state_dict and not any(
        k.startswith(("model.", "projector.", "time_projector.")) for k in state_dict
    ):
        state_dict = state_dict["state_dict"]
    out: Dict[str, torch.Tensor] = {}
    for key, t in load_hf_resnet_classifier(state_dict, config.resnet_config(), prefix="model.").items():
        if key.startswith("model.feature_extractor."):
            out["model." + key[len("model.feature_extractor."):]] = t
        else:  # model.classifier.{weight,bias}
            out[key[len("model."):]] = t
    out.update({port: _f32(state_dict[ref]) for ref, port in _projection_pairs(config)})
    return out


def _projection_pairs(config: EfficientKWSConfig):
    """(reference key, port key) of the projection stack's tensors."""
    pairs = []
    if config.learn_features and config.proj_mlp:
        for i in range(config.n_layers):
            for j, src in ((0, 0), (1, 2)):
                pairs += [(f"projector.{i}.{src}.{leaf}", f"projector.proj_{i}_{j}.{leaf}")
                          for leaf in ("weight", "bias")]
            if config.frames_conv:
                pairs += [(f"time_projector.{i}.0.{leaf}", f"time_projector.conv_{i}.{leaf}")
                          for leaf in ("weight", "bias")]
                pairs += [(f"time_projector.{i}.1.{leaf}", f"time_projector.bn_{i}.{leaf}") for leaf in _BN]
    return pairs


def lightning_efficient_kws(state_dict: Mapping[str, torch.Tensor],
                            config: EfficientKWSConfig) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`load_torch_efficient_kws`: an
    ``EfficientKWSModel`` state dict under the reference Lightning
    checkpoint's names, on the host."""
    resnet = {("model.feature_extractor." + k[len("model."):] if k.startswith("model.") else "model." + k): v
              for k, v in state_dict.items()}
    out = lightning_resnet_classifier(resnet, config.resnet_config())
    out.update({ref: state_dict[port].detach().cpu() for ref, port in _projection_pairs(config)})
    return out
