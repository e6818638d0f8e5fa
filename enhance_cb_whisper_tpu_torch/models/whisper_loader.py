"""HF Whisper checkpoint → the port's parameter dict (port of
enhance_cb_whisper_tpu/models/whisper_loader.py).

The port's layout is HF's own (``nn.Linear`` ``weight`` [out, in], conv
``weight`` [C_out, C_in, W]), so a state dict goes straight to the nested
dict of :mod:`.whisper` with no transposes: the ``model.`` prefix is
stripped and ``proj_out.weight`` (tied to ``decoder.embed_tokens``) is not
read.  Every tensor becomes float32 (the published whisper-large-v3 ships
float16).  Checkpoints are read from a local directory: ``config.json``
plus ``model.safetensors``, a sharded ``model.safetensors.index.json``, or
``pytorch_model.bin``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Tuple

import torch

from .whisper import WhisperConfig


def _put(t: torch.Tensor, device) -> torch.Tensor:
    return t.detach().to(device=device, dtype=torch.float32).contiguous()


def _linear(sd: Mapping[str, torch.Tensor], name: str, device) -> Dict[str, torch.Tensor]:
    out = {"weight": _put(sd[f"{name}.weight"], device)}
    if f"{name}.bias" in sd:
        out["bias"] = _put(sd[f"{name}.bias"], device)
    return out


def _attn(sd, name: str, device) -> Dict[str, Any]:
    return {proj: _linear(sd, f"{name}.{proj}", device)
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj")}  # k_proj has no bias


def load_hf_whisper(state_dict: Mapping[str, torch.Tensor], config: WhisperConfig,
                    device="cuda") -> Dict[str, Any]:
    """A ``WhisperModel`` or ``WhisperForConditionalGeneration`` state dict
    → the port's params on ``device``."""
    sd = dict(state_dict)
    if any(k.startswith("model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}

    def layer(base: str, cross: bool) -> Dict[str, Any]:
        p = {
            "self_attn": _attn(sd, f"{base}.self_attn", device),
            "self_attn_layer_norm": _linear(sd, f"{base}.self_attn_layer_norm", device),
            "fc1": _linear(sd, f"{base}.fc1", device),
            "fc2": _linear(sd, f"{base}.fc2", device),
            "final_layer_norm": _linear(sd, f"{base}.final_layer_norm", device),
        }
        if cross:
            p["encoder_attn"] = _attn(sd, f"{base}.encoder_attn", device)
            p["encoder_attn_layer_norm"] = _linear(sd, f"{base}.encoder_attn_layer_norm", device)
        return p

    encoder = {
        "conv1": _linear(sd, "encoder.conv1", device),
        "conv2": _linear(sd, "encoder.conv2", device),
        "embed_positions": _linear(sd, "encoder.embed_positions", device),
        "layer_norm": _linear(sd, "encoder.layer_norm", device),
        "layers": [layer(f"encoder.layers.{i}", False) for i in range(config.encoder_layers)],
    }
    decoder = {
        "embed_tokens": _linear(sd, "decoder.embed_tokens", device),
        "embed_positions": _linear(sd, "decoder.embed_positions", device),
        "layer_norm": _linear(sd, "decoder.layer_norm", device),
        "layers": [layer(f"decoder.layers.{i}", True) for i in range(config.decoder_layers)],
    }
    return {"encoder": encoder, "decoder": decoder}


def hf_whisper_state(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`load_hf_whisper`: the port's params under the
    names of HF's ``WhisperForConditionalGeneration`` (no ``proj_out``),
    contiguous, on the device they lie on."""
    state: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix):
        for key, value in tree.items():
            if key == "layers":
                for i, layer in enumerate(value):
                    walk(layer, f"{prefix}layers.{i}.")
            elif isinstance(value, dict):
                walk(value, f"{prefix}{key}.")
            else:
                state[prefix + key] = value.contiguous()

    walk(params, "model.")
    return state


def _read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The HF weights of a checkpoint directory, in any of its file forms,
    or of one ``.safetensors`` file."""
    from safetensors.torch import load_file

    if path.endswith(".safetensors"):
        return load_file(path)
    single = os.path.join(path, "model.safetensors")
    index = os.path.join(path, "model.safetensors.index.json")
    pickled = os.path.join(path, "pytorch_model.bin")
    if os.path.exists(single):
        return load_file(single)
    if os.path.exists(index):
        with open(index) as f:
            shards = sorted(set(json.load(f)["weight_map"].values()))
        sd: Dict[str, torch.Tensor] = {}
        for shard in shards:
            sd.update(load_file(os.path.join(path, shard)))
        return sd
    if os.path.exists(pickled):
        return torch.load(pickled, map_location="cpu", weights_only=True)
    raise FileNotFoundError(
        f"{path} holds none of model.safetensors, model.safetensors.index.json, pytorch_model.bin"
    )


def load_whisper_from_safetensors(path: str, config: WhisperConfig, device="cuda") -> Dict[str, Any]:
    """Params from one ``.safetensors`` file, or from a checkpoint directory
    in any of its forms, with a config the caller holds."""
    return load_hf_whisper(_read_state_dict(path), config, device)


def load_whisper_from_pretrained(name_or_path: str, device="cuda") -> Tuple[WhisperConfig, Dict[str, Any]]:
    """(config, params on ``device``) from a local HF checkpoint directory;
    the card is the default, a CPU run passes ``device="cpu"``."""
    if not os.path.isdir(name_or_path):
        raise FileNotFoundError(f"{name_or_path} is not a local checkpoint directory")
    with open(os.path.join(name_or_path, "config.json")) as f:
        config = WhisperConfig.from_hf(json.load(f))
    return config, load_hf_whisper(_read_state_dict(name_or_path), config, device)
