"""Reference Lightning KWS checkpoints → a ``state_dict`` of the port's
:class:`.kws.KWSModel` (port of enhance_cb_whisper_tpu/models/torch_compat.py).

The reference's classifier is an HF ``ResNetModel`` under
``model.feature_extractor`` plus a ``Sequential(Flatten, Linear)`` head at
``model.classifier.1``.  The port's module names follow the flax tree:

* ``feature_extractor.embedder.embedder.*`` → ``feature_extractor.embedder.*``;
* ``encoder.stages.{s}.layers.{b}.layer.{i}`` → ``stage_{s}_block_{b}.layer_{i}``,
  and ``...layers.{b}.shortcut`` → ``stage_{s}_block_{b}.shortcut``;
* ``classifier.1`` → ``classifier``.

Tensors are float32 and keep torch's layouts.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import torch

from .resnet import ResNetConfig

_CLASSIFIER = "classifier.1"  # the reference head: Sequential(Flatten, Linear)
_OUT_PREFIX = "model."  # KWSModel keeps its ResNet classifier under .model
_CONV_NORM = ("convolution.weight", "normalization.weight", "normalization.bias",
              "normalization.running_mean", "normalization.running_var")


def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().to(torch.float32).clone()


def migrate_legacy_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Old reference checkpoints use ``model.resnet.*`` keys; migrate them to
    the current ``model.feature_extractor.*`` layout exactly as the
    reference's ``on_load_checkpoint`` shim does."""
    keys = list(state_dict.keys())
    if not any("resnet." in k for k in keys):
        return dict(state_dict)
    resnet_re = re.compile("resnet.")
    fe_re = re.compile("(model.embedder|model.encoder)")
    out: Dict[str, Any] = {}
    for key in keys:
        new_key = resnet_re.sub("", key)
        if fe_re.search(new_key):
            new_key = new_key[:6] + "feature_extractor." + new_key[6:]
        out[new_key] = state_dict[key]
    return out


def _key_pairs(config: ResNetConfig, prefix: str):
    """(reference key under ``prefix``, ``KWSModel.state_dict()`` key) of
    every tensor the classifier may hold; each block's shortcut is listed
    whether the block has one or not."""
    src, dst = prefix + "feature_extractor.", _OUT_PREFIX + "feature_extractor."
    pairs = []

    def conv_norm(name_in: str, name_out: str) -> None:
        pairs.extend((f"{src}{name_in}.{leaf}", f"{dst}{name_out}.{leaf}") for leaf in _CONV_NORM)

    conv_norm("embedder.embedder", "embedder")
    n_layers = {"bottleneck": 3, "basic": 2}[config.layer_type]
    for s, depth in enumerate(config.depths):
        for b in range(depth):
            base = f"encoder.stages.{s}.layers.{b}"
            block = f"stage_{s}_block_{b}"
            conv_norm(f"{base}.shortcut", f"{block}.shortcut")
            for i in range(n_layers):
                conv_norm(f"{base}.layer.{i}", f"{block}.layer_{i}")
    pairs.extend((f"{prefix}{_CLASSIFIER}.{leaf}", f"{_OUT_PREFIX}classifier.{leaf}")
                 for leaf in ("weight", "bias"))
    return pairs


def load_hf_resnet_classifier(state_dict: Mapping[str, Any], config: ResNetConfig,
                              prefix: str = "") -> Dict[str, torch.Tensor]:
    """The reference's ResNet classifier (keys under ``prefix``) → entries of
    ``KWSModel.state_dict()``, for :meth:`.kws.KWSModel.load_converted`."""
    return {
        port: _f32(state_dict[ref]) for ref, port in _key_pairs(config, prefix)
        if ".shortcut." not in ref or ref in state_dict
    }


def lightning_resnet_classifier(state_dict: Mapping[str, torch.Tensor],
                                config: ResNetConfig) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`load_hf_resnet_classifier`: a ``KWSModel``
    state dict under the reference Lightning checkpoint's names (``model.``
    prefix), on the host."""
    return {
        ref: state_dict[port].detach().cpu() for ref, port in _key_pairs(config, "model.")
        if ".shortcut." not in port or port in state_dict
    }
