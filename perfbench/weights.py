"""Seeded weights and catalogs, made on the device in a few large draws.

Each maker lists its tensors as ``(name, shape, init)`` and fills every
random tensor from ONE flat normal draw of a ``torch.Generator`` on the
device, sliced in list order and scaled per tensor.  The same seed gives the
same values on every call, so the program and the plain reference are each
handed their own copy of identical weights: the reference never reads a
tensor the program was given.

The names follow the layouts the program loads: HF's ``WhisperModel`` state
dict for Whisper (read by the port's ``load_hf_whisper``), and the port's
module names for the ResNet classifiers (its ``load_converted``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

# (name, shape, init): init is ("normal", std), ("const", value) or ("table", array)
Spec = List[Tuple[str, Tuple[int, ...], tuple]]


def generator(seed: int, salt: int, device) -> torch.Generator:
    """A generator on ``device`` for stream ``salt`` of run ``seed`` (any
    seed up to 2**63; the streams of one seed do not overlap)."""
    mixed = np.random.SeedSequence([int(seed) & (2**64 - 1), int(salt)]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed) & (2**63 - 1))


def materialize(spec: Spec, seed: int, salt: int, device) -> Dict[str, torch.Tensor]:
    """Float32 tensors of ``spec`` on ``device``: one normal draw for all
    random tensors, sliced in order."""
    total = sum(math.prod(shape) for _, shape, init in spec if init[0] == "normal")
    flat = torch.empty(total, dtype=torch.float32, device=device)
    flat.normal_(0.0, 1.0, generator=generator(seed, salt, device))
    out, at = {}, 0
    for name, shape, init in spec:
        if init[0] == "normal":
            n = math.prod(shape)
            out[name] = flat[at : at + n].view(shape).mul_(init[1])
            at += n
        elif init[0] == "const":
            out[name] = torch.full(shape, float(init[1]), dtype=torch.float32, device=device)
        else:
            out[name] = torch.as_tensor(init[1], dtype=torch.float32, device=device).reshape(shape)
    return out


# --------------------------------------------------------------------- whisper


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed encoder position table [length, channels]."""
    step = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-step * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


def whisper_spec(cfg: dict) -> Spec:
    """HF Whisper names; every matrix N(0, init_std), biases 0, LayerNorms
    identity, the encoder's sinusoid positions (the scales of the port's
    ``init_whisper_params``)."""
    d, std = cfg["d_model"], cfg["init_std"]
    spec: Spec = []

    def linear(name, n_out, n_in, bias=True):
        spec.append((f"{name}.weight", (n_out, n_in), ("normal", std)))
        if bias:
            spec.append((f"{name}.bias", (n_out,), ("const", 0.0)))

    def norm(name):
        spec.append((f"{name}.weight", (d,), ("const", 1.0)))
        spec.append((f"{name}.bias", (d,), ("const", 0.0)))

    def attention(name):
        linear(f"{name}.q_proj", d, d)
        linear(f"{name}.k_proj", d, d, bias=False)
        linear(f"{name}.v_proj", d, d)
        linear(f"{name}.out_proj", d, d)

    def layer(name, ffn, cross):
        attention(f"{name}.self_attn")
        norm(f"{name}.self_attn_layer_norm")
        if cross:
            attention(f"{name}.encoder_attn")
            norm(f"{name}.encoder_attn_layer_norm")
        linear(f"{name}.fc1", ffn, d)
        linear(f"{name}.fc2", d, ffn)
        norm(f"{name}.final_layer_norm")

    spec.append(("encoder.conv1.weight", (d, cfg["num_mel_bins"], 3), ("normal", std)))
    spec.append(("encoder.conv1.bias", (d,), ("const", 0.0)))
    spec.append(("encoder.conv2.weight", (d, d, 3), ("normal", std)))
    spec.append(("encoder.conv2.bias", (d,), ("const", 0.0)))
    spec.append(("encoder.embed_positions.weight", (cfg["max_source_positions"], d),
                 ("table", sinusoids(cfg["max_source_positions"], d))))
    for i in range(cfg["encoder_layers"]):
        layer(f"encoder.layers.{i}", cfg["encoder_ffn_dim"], cross=False)
    norm("encoder.layer_norm")
    spec.append(("decoder.embed_tokens.weight", (cfg["vocab_size"], d), ("normal", std)))
    spec.append(("decoder.embed_positions.weight", (cfg["max_target_positions"], d), ("normal", std)))
    for i in range(cfg["decoder_layers"]):
        layer(f"decoder.layers.{i}", cfg["decoder_ffn_dim"], cross=True)
    norm("decoder.layer_norm")
    return spec


# ---------------------------------------------------------------------- resnet


def resnet_spec(rcfg: dict, num_channels: int, prefix: str, last_bn: float) -> Spec:
    """A bottleneck ResNet under the port's module names: He-normal
    convolutions, identity BatchNorm statistics, the last BatchNorm of every
    residual branch scaled by ``last_bn`` (nonzero, so every convolution
    reaches the output)."""
    spec: Spec = []

    def conv_norm(name, c_out, c_in, k, gamma=1.0):
        spec.append((f"{name}.convolution.weight", (c_out, c_in, k, k),
                     ("normal", math.sqrt(2.0 / (c_in * k * k)))))
        spec.append((f"{name}.normalization.weight", (c_out,), ("const", gamma)))
        spec.append((f"{name}.normalization.bias", (c_out,), ("const", 0.0)))
        spec.append((f"{name}.normalization.running_mean", (c_out,), ("const", 0.0)))
        spec.append((f"{name}.normalization.running_var", (c_out,), ("const", 1.0)))

    if rcfg["layer_type"] != "bottleneck":
        raise ValueError("the benchmark's configurations use bottleneck ResNets")
    conv_norm(f"{prefix}embedder", rcfg["embedding_size"], num_channels, 7)
    in_ch = rcfg["embedding_size"]
    for s, (width, depth) in enumerate(zip(rcfg["hidden_sizes"], rcfg["depths"])):
        for b in range(depth):
            stride = (2 if s > 0 else 1) if b == 0 else 1
            name = f"{prefix}stage_{s}_block_{b}"
            if in_ch != width or stride != 1:
                conv_norm(f"{name}.shortcut", width, in_ch, 1)
            red = width // 4
            conv_norm(f"{name}.layer_0", red, in_ch, 1)
            conv_norm(f"{name}.layer_1", red, red, 3)
            conv_norm(f"{name}.layer_2", width, red, 1, gamma=last_bn)
            in_ch = width
    return spec


def head_spec(name: str, n_in: int, n_out: int, std: float) -> Spec:
    return [(f"{name}.weight", (n_out, n_in), ("normal", std)), (f"{name}.bias", (n_out,), ("const", 0.0))]


def cbw_kws_spec(kws: dict) -> Spec:
    """Paper 1's spotter: the ResNet under ``model.feature_extractor`` and
    a small normal head under ``model.classifier`` (``KWSModel``'s names)."""
    r = kws["resnet"]
    return (resnet_spec(r, kws["num_channels"], "model.feature_extractor.", kws["last_bn"])
            + head_spec("model.classifier", r["hidden_sizes"][-1], 2, kws["head_std"]))


def lef_spec(cfg: dict) -> Spec:
    """Paper 2's LEF (``EfficientKWSModel``'s names): the per-layer MLP and
    time convolution (LeCun-normal linears, He-normal convolutions, zero
    biases, identity BatchNorms), the ResNet, a LeCun-normal head."""
    d, units, n_layers = cfg["embedding_dim"], cfg["proj_mlp_units"], cfg["n_layers"]
    width = cfg.get("input_dim", d)
    spec: Spec = []
    for i in range(n_layers):
        spec += [(f"projector.proj_{i}_0.weight", (d // 2, width), ("normal", math.sqrt(1.0 / width))),
                 (f"projector.proj_{i}_0.bias", (d // 2,), ("const", 0.0)),
                 (f"projector.proj_{i}_1.weight", (units, d // 2), ("normal", math.sqrt(1.0 / (d // 2)))),
                 (f"projector.proj_{i}_1.bias", (units,), ("const", 0.0))]
    for i in range(n_layers):
        spec += [(f"time_projector.conv_{i}.weight", (units, units, 3), ("normal", math.sqrt(2.0 / (3 * units)))),
                 (f"time_projector.conv_{i}.bias", (units,), ("const", 0.0)),
                 (f"time_projector.bn_{i}.weight", (units,), ("const", 1.0)),
                 (f"time_projector.bn_{i}.bias", (units,), ("const", 0.0)),
                 (f"time_projector.bn_{i}.running_mean", (units,), ("const", 0.0)),
                 (f"time_projector.bn_{i}.running_var", (units,), ("const", 1.0))]
    r = cfg["resnet"]
    spec += resnet_spec(r, n_layers, "model.", cfg["last_bn"])
    spec += head_spec("classifier", r["hidden_sizes"][-1], 2, math.sqrt(1.0 / r["hidden_sizes"][-1]))
    return spec


# -------------------------------------------------------------------- catalogs


def keyword_stacks(seed: int, n: int, n_layers: int, frames: Sequence[int], dim: int,
                   device) -> List[torch.Tensor]:
    """``n`` L2-normalized keyword stacks [n_layers, T_i, dim] with T_i
    drawn from ``frames`` = (lo, hi) inclusive, in one draw on ``device``."""
    g = np.random.default_rng([int(seed) & (2**64 - 1), 11])
    lengths = g.integers(frames[0], frames[1] + 1, size=n)
    flat = torch.empty(int(lengths.sum()) * n_layers * dim, device=device)
    flat.normal_(0.0, 1.0, generator=generator(seed, 12, device))
    out, at = [], 0
    for t in lengths:
        s = flat[at : at + n_layers * int(t) * dim].view(n_layers, int(t), dim)
        out.append(s / torch.linalg.vector_norm(s, dim=-1, keepdim=True))
        at += s.numel()
    return out


def projected_catalog(seed: int, n: int, n_layers: int, frames: int, units: int, chunk: int,
                      device, dtype=torch.bfloat16) -> dict:
    """A pre-projected LEF catalog made on the device: ``kwd`` [n, L, T', U]
    in ``dtype``, every frame and row valid (``bench_catalog100k.py``'s
    workload)."""
    kwd = torch.empty((n, n_layers, frames, units), dtype=dtype, device=device)
    kwd.normal_(0.0, 1.0, generator=generator(seed, 21, device))
    return {"kwd": kwd, "kwd_mask": torch.ones((n, n_layers, frames), dtype=dtype, device=device),
            "mask": torch.ones((n,), device=device), "num_keywords": n, "chunk": chunk}


def raw_keyword_groups(seed: int, n: int, n_layers: int, frames: int, dim: int, group: int,
                       device) -> List[dict]:
    """Raw keyword stacks [group, L, frames, dim] (all frames valid), in
    groups of ``group`` rows, for ``project_catalog``."""
    g = generator(seed, 22, device)
    out = []
    for _ in range(n // group):
        kwd = torch.empty((group, n_layers, frames, dim), device=device).normal_(0.0, 1.0, generator=g)
        out.append({"kwd": kwd, "kwd_mask": torch.ones((group, n_layers, frames), device=device),
                    "mask": torch.ones((group,), device=device)})
    return out


def utterance_stack(seed: int, index: int, n_layers: int, frames: int, dim: int, device) -> torch.Tensor:
    """Request ``index``'s raw utterance stack [1, L, frames, dim]."""
    g = generator(seed, 1000 + int(index), device)
    return torch.empty((1, n_layers, frames, dim), device=device).normal_(0.0, 1.0, generator=g)
