"""Whisper encoder-decoder in functional PyTorch (port of
enhance_cb_whisper_tpu/models/whisper.py, fp32 path).

As in the JAX package the model is a set of functions over a nested
parameter dict with HF names.  The dict holds torch layouts (built from the
JAX pytrees by :func:`..convert.from_jax_whisper_params`):

* linear ``weight`` [out, in] (``F.linear``), ``bias`` [out];
* conv ``weight`` [C_out, C_in, W] (``F.conv1d`` on [B, C, T]);
* ``layers`` is a list of per-layer dicts.

The self-attention KV cache is a dict ``{"index": int, "layers": [{"k",
"v"}]}`` whose [B, max_len, H, Dh] slabs are written IN PLACE by
:func:`decoder_forward` (no copy per step).  Beam search reorders it by
index (``decoding/beam.py``); the JAX ancestry cache, staged writes and the
int8 levers are TPU mechanisms that this port does not carry.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.sim import l2_normalize

NEG_INF = float(np.finfo(np.float32).min)


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    vocab_size: int = 51865
    num_mel_bins: int = 80
    d_model: int = 1024
    encoder_layers: int = 24
    encoder_attention_heads: int = 16
    decoder_layers: int = 24
    decoder_attention_heads: int = 16
    encoder_ffn_dim: int = 4096
    decoder_ffn_dim: int = 4096
    max_source_positions: int = 1500
    max_target_positions: int = 448
    decoder_start_token_id: int = 50258
    eos_token_id: int = 50257
    pad_token_id: int = 50257

    @classmethod
    def from_hf(cls, hf_config: Dict[str, Any]) -> "WhisperConfig":
        """From an HF ``config.json`` dict; a key it lacks takes
        ``transformers.WhisperConfig``'s default, as ``from_pretrained``
        would give it."""
        values = {**_HF_WHISPER_DEFAULTS, **hf_config}
        return cls(**{f.name: values[f.name] for f in dataclasses.fields(cls)})


# transformers.WhisperConfig's constructor defaults for the fields above
_HF_WHISPER_DEFAULTS = {
    "vocab_size": 51865, "num_mel_bins": 80, "d_model": 384,
    "encoder_layers": 4, "encoder_attention_heads": 6,
    "decoder_layers": 4, "decoder_attention_heads": 6,
    "encoder_ffn_dim": 1536, "decoder_ffn_dim": 1536,
    "max_source_positions": 1500, "max_target_positions": 448,
    "decoder_start_token_id": 50257, "eos_token_id": 50256, "pad_token_id": 50256,
}


# ---------------------------------------------------------------------------
# primitives


def _layer_norm(p: Dict[str, Any], x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), p["weight"], p["bias"], eps)


def _linear(p: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, p["weight"], p.get("bias"))


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, num_heads, d // num_heads)


def _attention(
    q: torch.Tensor,  # [B, Tq, H, Dh] (already scaled)
    k: torch.Tensor,  # [B, Tk, H, Dh]
    v: torch.Tensor,  # [B, Tk, H, Dh]
    mask: Optional[torch.Tensor] = None,  # broadcastable to [B, H, Tq, Tk], True=keep
) -> torch.Tensor:
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _mha(p: Dict[str, Any], x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Unmasked self-attention (the encoder's)."""
    head_dim = x.shape[-1] // num_heads
    q = _split_heads(_linear(p["q_proj"], x), num_heads) * (head_dim**-0.5)
    k = _split_heads(_linear(p["k_proj"], x), num_heads)
    v = _split_heads(_linear(p["v_proj"], x), num_heads)
    o = _attention(q, k, v)
    return _linear(p["out_proj"], o.reshape(*o.shape[:2], -1))


def _conv1d(p: Dict[str, Any], x: torch.Tensor, stride: int) -> torch.Tensor:
    # x: [B, C_in, T]; weight [C_out, C_in, W]; padding 1 both sides
    return F.conv1d(x, p["weight"], p["bias"], stride=stride, padding=1)


def sinusoid_positions(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed encoder positional table."""
    log_timescale_increment = np.log(10000.0) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)], axis=1).astype(np.float32)


def init_whisper_params(rng: np.random.Generator, config: WhisperConfig) -> Dict[str, Any]:
    """Random-normal params in the JAX package's layout (numpy, [in, out]
    kernels, [W, C_in, C_out] convs) — a copy of its ``init_whisper_params``
    so one numpy seed gives the same weights in both packages.  Convert with
    :func:`..convert.from_jax_whisper_params`."""

    def lin(n_in, n_out, bias=True):
        p = {"weight": rng.normal(0, 0.02, (n_in, n_out)).astype(np.float32)}
        if bias:
            p["bias"] = np.zeros((n_out,), np.float32)
        return p

    def ln():
        return {"weight": np.ones((config.d_model,), np.float32),
                "bias": np.zeros((config.d_model,), np.float32)}

    def attn():
        d = config.d_model
        return {
            "q_proj": lin(d, d),
            "k_proj": lin(d, d, bias=False),
            "v_proj": lin(d, d),
            "out_proj": lin(d, d),
        }

    def enc_layer():
        return {
            "self_attn": attn(),
            "self_attn_layer_norm": ln(),
            "fc1": lin(config.d_model, config.encoder_ffn_dim),
            "fc2": lin(config.encoder_ffn_dim, config.d_model),
            "final_layer_norm": ln(),
        }

    def dec_layer():
        return {
            **enc_layer(),
            "fc1": lin(config.d_model, config.decoder_ffn_dim),
            "fc2": lin(config.decoder_ffn_dim, config.d_model),
            "encoder_attn": attn(),
            "encoder_attn_layer_norm": ln(),
        }

    d = config.d_model
    return {
        "encoder": {
            "conv1": {"weight": rng.normal(0, 0.02, (3, config.num_mel_bins, d)).astype(np.float32),
                      "bias": np.zeros((d,), np.float32)},
            "conv2": {"weight": rng.normal(0, 0.02, (3, d, d)).astype(np.float32),
                      "bias": np.zeros((d,), np.float32)},
            "embed_positions": {"weight": sinusoid_positions(config.max_source_positions, d)},
            "layer_norm": ln(),
            "layers": [enc_layer() for _ in range(config.encoder_layers)],
        },
        "decoder": {
            "embed_tokens": {"weight": rng.normal(0, 0.02, (config.vocab_size, d)).astype(np.float32)},
            "embed_positions": {"weight": rng.normal(0, 0.02, (config.max_target_positions, d)).astype(np.float32)},
            "layer_norm": ln(),
            "layers": [dec_layer() for _ in range(config.decoder_layers)],
        },
    }


# ---------------------------------------------------------------------------
# encoder


def encoder_layer(p: Dict[str, Any], x: torch.Tensor, num_heads: int) -> torch.Tensor:
    h = _layer_norm(p["self_attn_layer_norm"], x)
    x = x + _mha(p["self_attn"], h, num_heads)
    h = _layer_norm(p["final_layer_norm"], x)
    h = F.gelu(_linear(p["fc1"], h))
    return x + _linear(p["fc2"], h)


def encoder_forward(
    params: Dict[str, Any],
    input_features: torch.Tensor,  # [B, n_mels, 2 * max_source_positions]
    config: WhisperConfig,
    output_hidden_states: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns (last_hidden_state [B, T_enc, D], hidden_states
    [n_layers+1, B, T_enc, D] or None).  ``hidden_states[i]`` is the input
    to layer i; the final entry is the post-LayerNorm output (HF's tuple).

    Each row is encoded on its own: cuBLAS and cuDNN pick their kernels by
    the batch, so a batched encoder would give a segment other bits beside
    other segments, and a packed decode's keywords (int8 spotting rounds
    those bits into other codes) and tokens would depend on its schedule."""
    if input_features.shape[0] > 1:
        rows = [encoder_forward(params, input_features[i : i + 1], config, output_hidden_states)
                for i in range(input_features.shape[0])]
        last = torch.cat([r[0] for r in rows])
        return last, torch.cat([r[1] for r in rows], dim=1) if output_hidden_states else None
    p = params["encoder"]
    x = F.gelu(_conv1d(p["conv1"], input_features.to(torch.float32), stride=1))
    x = F.gelu(_conv1d(p["conv2"], x, stride=2))
    x = x.transpose(1, 2) + p["embed_positions"]["weight"]  # [B, T_enc, D]

    states = [x] if output_hidden_states else None
    for layer in p["layers"]:
        x = encoder_layer(layer, x, config.encoder_attention_heads)
        if output_hidden_states:
            states.append(x)
    last = _layer_norm(p["layer_norm"], x)
    if output_hidden_states:
        states[-1] = last
        return last, torch.stack(states, dim=0)
    return last, None


def encoder_kws_stack(
    params: Dict[str, Any],
    input_features: torch.Tensor,
    config: WhisperConfig,
    layer_slice: Tuple[int, int] = (10, 22),
    return_encoding: bool = False,
):
    """hidden_states[lo:hi], L2-normalized over the embedding dim →
    [B, n_slabs, T_enc, D] (and the last hidden state with
    ``return_encoding=True``: one encoder forward feeds both keyword
    spotting and the decoder's cross-attention)."""
    lo, hi = layer_slice
    if not (0 <= lo < hi <= config.encoder_layers + 1):
        raise ValueError(
            f"layer_slice {layer_slice} out of range for a "
            f"{config.encoder_layers}-layer encoder"
        )
    last, states = encoder_forward(params, input_features, config, output_hidden_states=True)
    stack = l2_normalize(states[lo:hi].transpose(0, 1))
    if return_encoding:
        return stack, last
    return stack


# ---------------------------------------------------------------------------
# decoder


def init_cache(config: WhisperConfig, batch: int, max_len: int,
               device: torch.device) -> Dict[str, Any]:
    head_dim = config.d_model // config.decoder_attention_heads
    shape = (batch, max_len, config.decoder_attention_heads, head_dim)
    return {
        "index": 0,
        "layers": [
            {"k": torch.zeros(shape, device=device), "v": torch.zeros(shape, device=device)}
            for _ in range(config.decoder_layers)
        ],
    }


def precompute_cross_kv(params: Dict[str, Any], encoder_out: torch.Tensor,
                        config: WhisperConfig) -> List[Dict[str, torch.Tensor]]:
    """Cross-attention K/V, once per segment: per layer {"k","v"} [B, T_enc, H, Dh].
    Each segment is projected on its own, so its bits do not depend on the
    batch (see :func:`encoder_forward`)."""
    h = config.decoder_attention_heads
    return [
        {
            name: torch.cat([_split_heads(_linear(layer["encoder_attn"][proj], encoder_out[i : i + 1]), h)
                             for i in range(encoder_out.shape[0])])
            for name, proj in (("k", "k_proj"), ("v", "v_proj"))
        }
        for layer in params["decoder"]["layers"]
    ]


def _decoder_layer(
    p: Dict[str, Any],
    x: torch.Tensor,
    cross_kv: Dict[str, torch.Tensor],
    num_heads: int,
    self_mask: torch.Tensor,
    cache_layer: Optional[Dict[str, torch.Tensor]],
    offset: int,
) -> torch.Tensor:
    head_dim = x.shape[-1] // num_heads
    t = x.shape[1]

    h = _layer_norm(p["self_attn_layer_norm"], x)
    q = _split_heads(_linear(p["self_attn"]["q_proj"], h), num_heads) * (head_dim**-0.5)
    k = _split_heads(_linear(p["self_attn"]["k_proj"], h), num_heads)
    v = _split_heads(_linear(p["self_attn"]["v_proj"], h), num_heads)
    if cache_layer is not None:
        # in-place cache write; attend over the written prefix only (slots
        # past it are masked by the causal rule in the reference anyway)
        cache_layer["k"][:, offset : offset + t] = k
        cache_layer["v"][:, offset : offset + t] = v
        k = cache_layer["k"][:, : offset + t]
        v = cache_layer["v"][:, : offset + t]
    attn = _attention(q, k, v, self_mask)
    x = x + _linear(p["self_attn"]["out_proj"], attn.reshape(*attn.shape[:2], -1))

    # cross attention: beams of one batch item share the encoder output, so
    # the K/V stay at batch size and the beam rows fold into the query axis
    # (exact — cross attention has no positional structure over queries)
    h = _layer_norm(p["encoder_attn_layer_norm"], x)
    q = _split_heads(_linear(p["encoder_attn"]["q_proj"], h), num_heads) * (head_dim**-0.5)
    k_c, v_c = cross_kv["k"], cross_kv["v"]
    if q.shape[0] != k_c.shape[0]:
        reps = q.shape[0] // k_c.shape[0]
        q_folded = q.reshape(k_c.shape[0], reps * q.shape[1], *q.shape[2:])
        attn = _attention(q_folded, k_c, v_c).reshape(q.shape)
    else:
        attn = _attention(q, k_c, v_c)
    x = x + _linear(p["encoder_attn"]["out_proj"], attn.reshape(*attn.shape[:2], -1))

    h = _layer_norm(p["final_layer_norm"], x)
    h = F.gelu(_linear(p["fc1"], h))
    return x + _linear(p["fc2"], h)


def decoder_forward(
    params: Dict[str, Any],
    input_ids: torch.Tensor,  # [B, T] int64
    cross_kv: List[Dict[str, torch.Tensor]],
    config: WhisperConfig,
    cache: Optional[Dict[str, Any]] = None,
    attention_mask: Optional[torch.Tensor] = None,  # [B, >= index + T] 1=attend
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Teacher forcing (``cache=None``) or incremental decoding: positions
    start at ``cache["index"]``, the cache is updated in place and its
    index advanced.  ``attention_mask`` masks prompt padding (the
    reference's ``decoder_attention_mask`` from pad ids).

    Returns (logits [B, T, vocab], cache)."""
    p = params["decoder"]
    t = input_ids.shape[1]
    offset = int(cache["index"]) if cache is not None else 0
    device = input_ids.device

    x = p["embed_tokens"]["weight"][input_ids] + p["embed_positions"]["weight"][offset : offset + t]

    key_pos = torch.arange(offset + t, device=device)
    query_pos = offset + torch.arange(t, device=device)
    mask = (key_pos[None, :] <= query_pos[:, None])[None, None]  # [1, 1, T, offset+T]
    if attention_mask is not None:
        mask = mask & attention_mask[:, None, None, : offset + t].bool()

    for i, layer in enumerate(p["layers"]):
        x = _decoder_layer(
            layer, x, cross_kv[i], config.decoder_attention_heads, mask,
            cache["layers"][i] if cache is not None else None, offset,
        )
    x = _layer_norm(p["layer_norm"], x)
    logits = F.linear(x, p["embed_tokens"]["weight"])
    if cache is not None:
        cache["index"] = offset + t
    return logits, cache
