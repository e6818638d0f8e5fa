"""Whisper encoder-decoder in functional PyTorch (port of
enhance_cb_whisper_tpu/models/whisper.py).

As in the JAX package the model is a set of functions over a nested
parameter dict with HF names.  The dict holds torch layouts (built from the
JAX pytrees by :func:`..convert.from_jax_whisper_params`):

* linear ``weight`` [out, in] (``F.linear``), ``bias`` [out];
* conv ``weight`` [C_out, C_in, W] (``F.conv1d`` on [B, C, T]);
* ``layers`` is a list of per-layer dicts.

The self-attention KV cache is a dict ``{"index": int, "layers": [{"k",
"v"}]}`` whose [B, max_len, H, Dh] slabs are written IN PLACE by
:func:`decoder_forward` (no copy per step).  Beam search over a float cache
adds the JAX package's ancestry map ``anc`` [B_items, K, max_len]
(``decoding/beam.py``): the rows stay where each beam appended its tokens,
and a decode step's self-attention reads them through the map
(:func:`..ops.beam_attention.ancestry_attention`, kernel K4 on the card);
an int8 cache is reordered by index instead.  Staged writes (the JAX
package's ``kv_staging``) are carried for the int8 cache alone, the one
cache whose results they change: the last tokens stay in a compute-dtype
window until :func:`flush_staging` quantizes them (:func:`init_cache`).

The serving levers of the JAX package, with its casts one for one:

* a compute dtype (``dtype=torch.bfloat16``): products in that dtype with
  f32 accumulation, LayerNorms and softmaxes in f32, attention scores and
  the vocab logits in f32 (:func:`to_compute_dtype` casts the weights once);
* weight-only int8 (:func:`quantize_vocab_projection`,
  :func:`quantize_decoder_layers`): per-output-channel int8 codes, stored
  as int8 and converted at each call, with an f32 scale epilogue;
* int8 K/V (``init_cache(kv_int8=True)``,
  ``precompute_cross_kv(int8=True)``): per-(row, token) scales that factor
  out of the attention contractions exactly;
* the s8 encoder (:func:`quantize_encoder`): s8 x s8 -> s32 products
  (``torch._int_mm``) with calibrated static activation scales.

Tensor parallelism (``parallel/sharding.py:whisper_param_sharding``) hands
the same functions a rank's share of the params: its heads and MLP units.
Heads are split by ``head_dim`` (the config's ``d_model / heads``), so a
projection holds as many as its width; a row-split linear's dict names its
process group under ``"reduce"`` and :func:`_linear` sums its partial
products over it before adding the bias once.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops.beam_attention import ancestry_attention
from ..ops.sim import l2_normalize
from ..runtime import profiler

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


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the operands' dtype, accumulated in f32 and rounded
    once.  On the CPU bf16 operands are upcast (exact) and the f32 product
    rounded; on the card cuBLAS accumulates in f32 (``reference_precision``
    forbids bf16 partial sums)."""
    if a.dtype != torch.float32 and a.device.type == "cpu":
        return torch.matmul(a.float(), b.float()).to(a.dtype)
    return torch.matmul(a, b)


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with an f32 result from operands in one compute dtype (JAX's
    ``preferred_element_type=jnp.float32``).  torch has no bf16 -> f32
    product on the CPU, so bf16 operands are upcast there (exact); on the
    card cuBLAS reads them as they are and writes f32."""
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.device.type == "cpu":
        return torch.matmul(a.float(), b.float())
    if b.ndim == 2:
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    lead = a.shape[:-2]
    out = torch.bmm(a.reshape(-1, *a.shape[-2:]), b.expand(*lead, *b.shape[-2:]).reshape(-1, *b.shape[-2:]),
                    out_dtype=torch.float32)
    return out.reshape(*lead, a.shape[-2], b.shape[-1])


def _layer_norm(p: Dict[str, Any], x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """In f32, cast back to the activation's dtype."""
    if x.dtype == torch.float32:
        return F.layer_norm(x, (x.shape[-1],), p["weight"], p["bias"], eps)
    return F.layer_norm(x.float(), (x.shape[-1],), p["weight"], p["bias"], eps).to(x.dtype)


def _linear(p: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    if "reduce" in p:
        # a row-parallel shard (tensor parallelism): this rank's partial
        # product without the bias, summed over the group, the bias once
        y = _matmul_f32(x, p["weight"].to(x.dtype).t())
        dist.all_reduce(y, group=p["reduce"])
        y = y.to(x.dtype)
        return y + p["bias"].to(x.dtype) if "bias" in p else y
    if "qweight" in p:
        # weight-only int8: compute-dtype operands, f32 accumulation, then
        # the per-output-channel scale and the bias in f32
        y = _matmul_f32(x, p["qweight"].to(x.dtype).t()) * p["scale"]
        if "bias" in p:
            y = y + p["bias"]
        return y.to(x.dtype)
    if x.dtype == torch.float32:
        bias = p.get("bias")
        return F.linear(x, p["weight"].to(x.dtype), None if bias is None else bias.to(x.dtype))
    # two roundings, as in JAX: the product to the compute dtype, then the
    # bias added in it (F.linear would fuse the bias into the GEMM)
    y = _matmul(x, p["weight"].to(x.dtype).t())
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


# sqrt(1/2) as a bf16 constant, as jax.nn.gelu casts it to the input's dtype
_SQRT_HALF_BF16 = float(torch.tensor(0.5**0.5, dtype=torch.bfloat16))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU.  Below f32 it is ``jax.nn.gelu``'s
    ``0.5 * x * erfc(-x * sqrt(1/2))`` with its roundings as XLA evaluates
    it: the constant and erfc's result in the compute dtype, the rest in
    f32, one rounding at the end (``F.gelu`` rounds erfc's result nowhere,
    and would differ from JAX in about a fifth of its bf16 outputs)."""
    if x.dtype == torch.float32:
        return F.gelu(x)
    xf = x.float()
    erfc = torch.special.erfc(xf * -_SQRT_HALF_BF16).to(x.dtype).float()
    return (0.5 * xf * erfc).to(x.dtype)


def _split_heads(x: torch.Tensor, head_dim: int) -> torch.Tensor:
    """[B, T, H·Dh] -> [B, T, H, Dh]: as many heads as the projection's
    width holds (all of them, or a tensor-parallel rank's share)."""
    b, t, _ = x.shape
    return x.reshape(b, t, -1, head_dim)


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """f32 attention scores [B, H, Tq, Tk] of q [B, Tq, H, Dh] and k [B, Tk, H, Dh]."""
    return _matmul_f32(q.permute(0, 2, 1, 3), k.permute(0, 2, 3, 1))


def _weighted(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs [B, H, Tq, Tk] (compute dtype) · v [B, Tk, H, Dh] -> [B, Tq, H, Dh]."""
    return _matmul(probs, v.permute(0, 2, 1, 3)).permute(0, 2, 1, 3)


def _attention(
    q: torch.Tensor,  # [B, Tq, H, Dh] (already scaled)
    k: torch.Tensor,  # [B, Tk, H, Dh] (int8 when k_scale is given)
    v: torch.Tensor,  # [B, Tk, H, Dh] (int8 when v_scale is given)
    mask: Optional[torch.Tensor] = None,  # broadcastable to [B, H, Tq, Tk], True=keep
    k_scale: Optional[torch.Tensor] = None,  # [B, Tk] per-token int8 dequant
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Scores and softmax in f32, the probabilities cast to the value dtype.
    A per-token scale factors out of the contractions exactly: it scales
    the scores on the key side and the softmax weights on the value side."""
    if q.dtype == torch.float32 and k_scale is None and v_scale is None:
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            scores = scores.masked_fill(~mask, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v)
    scores = _scores(q, k.to(q.dtype))
    if k_scale is not None:
        scores = scores * k_scale[:, None, None, :]
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale[:, None, None, :]
    return _weighted(probs.to(q.dtype), v.to(q.dtype))


def _attention_step(
    q: torch.Tensor,  # [B, 1, H, Dh] (already scaled)
    k_cache: torch.Tensor,  # [B, T, H, Dh] int8: the positions before this token
    v_cache: torch.Tensor,
    k_scale: torch.Tensor,  # [B, T]
    v_scale: torch.Tensor,
    k_new: torch.Tensor,  # [B, 1, H, Dh] this token's K/V, compute dtype
    v_new: torch.Tensor,
    mask: Optional[torch.Tensor],  # broadcastable to [B, H, 1, T], True=keep
    stage_k: Optional[torch.Tensor] = None,  # [B, S, H, Dh] staged tokens, compute dtype
    stage_v: Optional[torch.Tensor] = None,
    stage_mask: Optional[torch.Tensor] = None,  # broadcastable to [B, H, 1, S]
) -> torch.Tensor:
    """A decode step over an int8 cache (JAX ``_attention_split``): the
    dequantized cache strictly before this position, and this token's K/V
    at full precision as one more score column.  The caller stores the
    token's quantized codes afterwards.  Staged tokens (``stage_k``/
    ``stage_v``, at full precision) are a third score block between the
    two, as in the JAX package."""
    scores_c = _scores(q, k_cache.to(q.dtype)) * k_scale[:, None, None, :]
    if mask is not None:
        scores_c = scores_c.masked_fill(~mask, NEG_INF)
    blocks = [scores_c]
    if stage_k is not None:
        scores_s = _scores(q, stage_k.to(q.dtype))
        if stage_mask is not None:
            scores_s = scores_s.masked_fill(~stage_mask, NEG_INF)
        blocks.append(scores_s)
    probs = torch.softmax(torch.cat([*blocks, _scores(q, k_new)], dim=-1), dim=-1)
    t = k_cache.shape[1]
    probs_c = probs[..., :t] * v_scale[:, None, None, :]
    out = _weighted(probs_c.to(q.dtype), v_cache.to(q.dtype)) + _weighted(probs[..., -1:].to(q.dtype), v_new)
    if stage_k is not None:
        out = out + _weighted(probs[..., t:-1].to(q.dtype), stage_v.to(q.dtype))
    return out


def _mha(p: Dict[str, Any], x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Unmasked self-attention (the encoder's)."""
    head_dim = x.shape[-1] // num_heads
    q = _split_heads(_linear(p["q_proj"], x), head_dim) * (head_dim**-0.5)
    k = _split_heads(_linear(p["k_proj"], x), head_dim)
    v = _split_heads(_linear(p["v_proj"], x), head_dim)
    o = _attention(q, k, v)
    return _linear(p["out_proj"], o.reshape(*o.shape[:2], -1))


def _conv1d(p: Dict[str, Any], x: torch.Tensor, stride: int) -> torch.Tensor:
    # x: [B, C_in, T]; weight [C_out, C_in, W]; padding 1 both sides
    if x.dtype == torch.float32:
        return F.conv1d(x, p["weight"].to(x.dtype), p["bias"].to(x.dtype), stride=stride, padding=1)
    w = p["weight"].to(x.dtype)
    if x.device.type == "cpu":
        y = F.conv1d(x.float(), w.float(), stride=stride, padding=1).to(x.dtype)
    else:
        y = F.conv1d(x, w, stride=stride, padding=1)
    return y + p["bias"].to(x.dtype)[:, None]


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
# compute dtype and weight-only int8 (serving levers)


def to_compute_dtype(params: Dict[str, Any], dtype: torch.dtype) -> Dict[str, Any]:
    """The weights the forward casts to ``dtype`` at every use, cast once:
    the linears' and convolutions' weights and biases, the position tables
    and the token embedding.  LayerNorm affines stay f32 (the LayerNorm runs
    in f32), and so do int8 linears (their scale and bias enter an f32
    epilogue) and the encoder's activation scales.  The identity for f32."""
    if dtype == torch.float32:
        return params

    def cast(tree, name):
        if isinstance(tree, list):
            return [cast(layer, "") for layer in tree]
        if not isinstance(tree, dict) or "qweight" in tree:
            return tree
        if isinstance(tree.get("weight"), torch.Tensor):
            if name.endswith("layer_norm"):
                return tree
            return {k: v.to(dtype) if k in ("weight", "bias") else v for k, v in tree.items()}
        return {k: cast(v, k) for k, v in tree.items()}

    return cast(params, "")


def _quantize_rows(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 of a 2-D f32 weight: (codes, scale [rows]) with the JAX
    package's arithmetic (max|w| / 127 floored at 1e-12, round half to
    even), so the codes are bit-equal to its.  The codes are row-major
    whatever ``w``'s strides: cuBLASLt's s8 product takes the [in, out]
    operand of ``torch._int_mm`` only column-major."""
    w = w.to(torch.float32)
    scale = torch.clamp_min(w.abs().amax(dim=1, keepdim=True) / 127.0, 1e-12)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q.contiguous(), scale[:, 0]


def quantize_vocab_projection(params: Dict[str, Any]) -> Dict[str, Any]:
    """Weight-only int8 for the tied vocab projection (JAX
    ``quantize_vocab_projection``): ``decoder.embed_tokens_q`` holds the
    per-row codes [vocab, d_model] and scales [vocab]; the f32 table stays
    for the input-token gather."""
    q, scale = _quantize_rows(params["decoder"]["embed_tokens"]["weight"])
    decoder = dict(params["decoder"], embed_tokens_q={"qweight": q, "scale": scale})
    return dict(params, decoder=decoder)


def _quantize_linear_params(p: Dict[str, Any]) -> Dict[str, Any]:
    """Per-output-channel weight-only int8 for one [out, in] linear."""
    q, scale = _quantize_rows(p["weight"])
    out = {"qweight": q, "scale": scale}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def _quantize_paths(layer: Dict[str, Any], paths) -> Dict[str, Any]:
    layer = dict(layer)
    for path in paths:
        parent = layer
        for key in path[:-1]:
            parent[key] = dict(parent[key])
            parent = parent[key]
        parent[path[-1]] = _quantize_linear_params(parent[path[-1]])
    return layer


# the linears inside the per-token decode loop; encoder_attn k/v run once
# per segment (precompute_cross_kv), and the cross-K/V slab has its own
# lever (precompute_cross_kv(int8=True))
_DECODE_LOOP_LINEARS = (
    ("self_attn", "q_proj"), ("self_attn", "k_proj"),
    ("self_attn", "v_proj"), ("self_attn", "out_proj"),
    ("encoder_attn", "q_proj"), ("encoder_attn", "out_proj"),
    ("fc1",), ("fc2",),
)


def quantize_decoder_layers(params: Dict[str, Any]) -> Dict[str, Any]:
    """Weight-only int8 for every decoder-layer linear of the decode loop
    (JAX ``quantize_decoder_layers``): each becomes ``{"qweight" int8
    [out, in], "scale" f32 [out], "bias"}`` and :func:`_linear` takes its
    int8 branch."""
    layers = [_quantize_paths(layer, _DECODE_LOOP_LINEARS) for layer in params["decoder"]["layers"]]
    return dict(params, decoder=dict(params["decoder"], layers=layers))


# ---------------------------------------------------------------------------
# s8 encoder (the KWS encoder's serving mode)
#
# Activations are quantized at four sites per layer with static scales
# calibrated on real segments; the six linears run s8 x s8 -> s32
# (torch._int_mm: on the card it needs more than 16 rows and K, N multiples
# of 8, which a 1500-frame segment meets) with an f32 dequant epilogue.
# Attention, LayerNorms and GELU stay in the compute dtype / f32.

_ENC_ACT_SITES = ("attn_in", "attn_out", "fc1_in", "fc2_in")
_ENC_LOOP_LINEARS = (
    ("self_attn", "q_proj"), ("self_attn", "k_proj"),
    ("self_attn", "v_proj"), ("self_attn", "out_proj"),
    ("fc1",), ("fc2",),
)


def _quantize_act(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x.to(torch.float32) / s), -127, 127).to(torch.int8)


def _qlinear(p: Dict[str, Any], xq: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    """s8 activations x per-output-channel s8 weights -> s32, then
    ``z * (s_x * scale) + bias`` in f32 (JAX's association).  Returns f32."""
    z = torch._int_mm(xq.reshape(-1, xq.shape[-1]), p["qweight"].t())
    y = z.to(torch.float32).reshape(*xq.shape[:-1], -1) * (s_x * p["scale"])
    if "bias" in p:
        y = y + p["bias"]
    return y


def encoder_layer_int8(p: Dict[str, Any], x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """s8 twin of :func:`encoder_layer` (same topology, quantized linears)."""
    sc = p["act_scales"]
    head_dim = x.shape[-1] // num_heads
    h = _layer_norm(p["self_attn_layer_norm"], x)
    hq = _quantize_act(h, sc["attn_in"])
    q = _split_heads(_qlinear(p["self_attn"]["q_proj"], hq, sc["attn_in"]).to(x.dtype), head_dim) * (
        head_dim**-0.5)
    k = _split_heads(_qlinear(p["self_attn"]["k_proj"], hq, sc["attn_in"]).to(x.dtype), head_dim)
    v = _split_heads(_qlinear(p["self_attn"]["v_proj"], hq, sc["attn_in"]).to(x.dtype), head_dim)
    o = _attention(q, k, v)
    o = o.reshape(*o.shape[:2], -1)
    oq = _quantize_act(o, sc["attn_out"])
    x = x + _qlinear(p["self_attn"]["out_proj"], oq, sc["attn_out"]).to(x.dtype)
    h = _layer_norm(p["final_layer_norm"], x)
    hq = _quantize_act(h, sc["fc1_in"])
    g = _gelu(_qlinear(p["fc1"], hq, sc["fc1_in"]))
    gq = _quantize_act(g, sc["fc2_in"])
    return x + _qlinear(p["fc2"], gq, sc["fc2_in"]).to(x.dtype)


def _encoder_layer_record_maxes(p: Dict[str, Any], x: torch.Tensor,
                                num_heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`encoder_layer` that also returns max|x| at the four
    activation-quantization sites (the calibration pass)."""
    h = _layer_norm(p["self_attn_layer_norm"], x)
    m_attn_in = h.to(torch.float32).abs().amax()
    head_dim = x.shape[-1] // num_heads
    q = _split_heads(_linear(p["self_attn"]["q_proj"], h), head_dim) * (head_dim**-0.5)
    k = _split_heads(_linear(p["self_attn"]["k_proj"], h), head_dim)
    v = _split_heads(_linear(p["self_attn"]["v_proj"], h), head_dim)
    o = _attention(q, k, v).reshape(*x.shape[:2], -1)
    m_attn_out = o.to(torch.float32).abs().amax()
    x = x + _linear(p["self_attn"]["out_proj"], o)
    h = _layer_norm(p["final_layer_norm"], x)
    m_fc1_in = h.to(torch.float32).abs().amax()
    g = _gelu(_linear(p["fc1"], h))
    m_fc2_in = g.to(torch.float32).abs().amax()
    x = x + _linear(p["fc2"], g)
    return x, torch.stack([m_attn_in, m_attn_out, m_fc1_in, m_fc2_in])


def calibrate_encoder_act_scales(params: Dict[str, Any], input_features: torch.Tensor,
                                 config: WhisperConfig, dtype: torch.dtype = torch.float32) -> np.ndarray:
    """Per-layer static activation scales [n_layers, 4] (sites in
    ``_ENC_ACT_SITES`` order): max|x| over the calibration mels
    [B, n_mels, 3000] / 127, each mel encoded on its own (see
    :func:`encoder_forward`)."""
    p = params["encoder"]
    maxes = []
    for i in range(input_features.shape[0]):
        x = _encoder_input(p, input_features[i : i + 1], dtype)
        per_layer = []
        for layer in p["layers"]:
            x, m = _encoder_layer_record_maxes(layer, x, config.encoder_attention_heads)
            per_layer.append(m)
        maxes.append(torch.stack(per_layer))
    maxes = torch.stack(maxes).amax(dim=0).cpu().numpy()
    return np.maximum(maxes / 127.0, 1e-12)


def quantize_encoder_layers(params: Dict[str, Any], act_scales: np.ndarray) -> Dict[str, Any]:
    """int8 codes for every encoder-layer linear (per output channel) and
    the calibrated static activation scales (:func:`calibrate_encoder_act_scales`)
    in each layer's ``act_scales``; :func:`encoder_layer` dispatches on it.
    The convolutions, LayerNorms and attention stay in the compute dtype."""
    layers = params["encoder"]["layers"]
    act_scales = np.asarray(act_scales, dtype=np.float32)
    if act_scales.shape != (len(layers), len(_ENC_ACT_SITES)):
        raise ValueError(
            f"act_scales must be [{len(layers)}, {len(_ENC_ACT_SITES)}], got {act_scales.shape}"
        )
    device = params["encoder"]["conv1"]["weight"].device
    quantized = []
    for i, layer in enumerate(layers):
        layer = _quantize_paths(layer, _ENC_LOOP_LINEARS)
        layer["act_scales"] = {site: torch.tensor(act_scales[i, j], device=device)
                               for j, site in enumerate(_ENC_ACT_SITES)}
        quantized.append(layer)
    return dict(params, encoder=dict(params["encoder"], layers=quantized))


def quantize_encoder(params: Dict[str, Any], calibration_features: torch.Tensor,
                     config: WhisperConfig, dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Calibrate and quantize in one call."""
    scales = calibrate_encoder_act_scales(to_compute_dtype(params, dtype), calibration_features, config, dtype)
    return quantize_encoder_layers(params, scales)


# ---------------------------------------------------------------------------
# encoder


def encoder_layer(p: Dict[str, Any], x: torch.Tensor, num_heads: int) -> torch.Tensor:
    if "act_scales" in p:
        return encoder_layer_int8(p, x, num_heads)
    h = _layer_norm(p["self_attn_layer_norm"], x)
    x = x + _mha(p["self_attn"], h, num_heads)
    h = _layer_norm(p["final_layer_norm"], x)
    h = _gelu(_linear(p["fc1"], h))
    return x + _linear(p["fc2"], h)


def _encoder_input(p: Dict[str, Any], input_features: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The convolutional front end and position embedding: [B, T_enc, D]."""
    x = _gelu(_conv1d(p["conv1"], input_features.to(dtype), stride=1))
    x = _gelu(_conv1d(p["conv2"], x, stride=2))
    return x.transpose(1, 2) + p["embed_positions"]["weight"].to(dtype)


def encoder_forward(
    params: Dict[str, Any],
    input_features: torch.Tensor,  # [B, n_mels, 2 * max_source_positions]
    config: WhisperConfig,
    output_hidden_states: bool = False,
    dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns (last_hidden_state [B, T_enc, D], hidden_states
    [n_layers+1, B, T_enc, D] or None), in ``dtype``.  ``hidden_states[i]``
    is the input to layer i; the final entry is the post-LayerNorm output
    (HF's tuple).

    Each row is encoded on its own: cuBLAS and cuDNN pick their kernels by
    the batch, so a batched encoder would give a segment other bits beside
    other segments, and a packed decode's keywords (int8 spotting rounds
    those bits into other codes) and tokens would depend on its schedule."""
    if input_features.shape[0] > 1:
        rows = [encoder_forward(params, input_features[i : i + 1], config, output_hidden_states, dtype)
                for i in range(input_features.shape[0])]
        last = torch.cat([r[0] for r in rows])
        return last, torch.cat([r[1] for r in rows], dim=1) if output_hidden_states else None
    p = params["encoder"]
    x = _encoder_input(p, input_features, dtype)

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
    dtype: torch.dtype = torch.float32,
    valid_frames: Optional[torch.Tensor] = None,
):
    """hidden_states[lo:hi] in f32, L2-normalized over the embedding dim →
    [B, n_slabs, T_enc, D] (and the last hidden state, in ``dtype``, with
    ``return_encoding=True``: one encoder forward feeds both keyword
    spotting and the decoder's cross-attention).  With ``valid_frames``
    ([B] integers), each row's frames at or beyond its count are zeroed
    after the norm."""
    lo, hi = layer_slice
    if not (0 <= lo < hi <= config.encoder_layers + 1):
        raise ValueError(
            f"layer_slice {layer_slice} out of range for a "
            f"{config.encoder_layers}-layer encoder"
        )
    last, states = encoder_forward(params, input_features, config, output_hidden_states=True, dtype=dtype)
    stack = l2_normalize(states[lo:hi].transpose(0, 1).to(torch.float32))
    if valid_frames is not None:
        t = torch.arange(stack.shape[2], device=stack.device)
        keep = t[None, :] < valid_frames.to(stack.device)[:, None]
        stack = torch.where(keep[:, None, :, None], stack, torch.zeros((), device=stack.device))
    if return_encoding:
        return stack, last
    return stack


# ---------------------------------------------------------------------------
# decoder


def decoder_heads(params: Dict[str, Any], config: WhisperConfig) -> int:
    """The decoder attention heads that ``params`` hold: all of them, or a
    tensor-parallel rank's share (``parallel/sharding.py``)."""
    k = params["decoder"]["layers"][0]["self_attn"]["k_proj"]
    width = (k["weight"] if "weight" in k else k["qweight"]).shape[0]
    return width // (config.d_model // config.decoder_attention_heads)


def init_cache(config: WhisperConfig, batch: int, max_len: int, device: torch.device,
               dtype: torch.dtype = torch.float32, kv_int8: bool = False,
               staging_window: int = 0, num_heads: Optional[int] = None) -> Dict[str, Any]:
    """Per layer ``{"k", "v"}`` [batch, max_len, H, Dh] slabs in ``dtype``
    (H: ``num_heads``, by default the config's; a tensor-parallel rank
    holds its share, :func:`decoder_heads`);
    with ``kv_int8`` int8 slabs and f32 ``k_scale``/``v_scale`` [batch,
    max_len] (per-token scales, :func:`_quantize_kv`).

    ``staging_window`` W > 0 (int8 caches only) adds per layer a W-token
    window ``ks``/``vs`` [batch, W, H, Dh] in ``dtype`` and the cache's
    ``base``, the position of the window's first token.  A decode step
    attends the slab before ``base``, the window's tokens at full precision
    and its own token, then writes its K/V into the window; the decode loop
    calls :func:`flush_staging` every W steps."""
    head_dim = config.d_model // config.decoder_attention_heads
    shape = (batch, max_len, num_heads or config.decoder_attention_heads, head_dim)
    if staging_window and not kv_int8:
        raise ValueError("staging_window applies to an int8 cache: a float cache's results do not change")
    if staging_window and not 0 < staging_window < max_len:
        raise ValueError(f"staging_window must be in (0, max_len={max_len}); got {staging_window}")

    def layer():
        if kv_int8:
            out = {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                   "v": torch.zeros(shape, dtype=torch.int8, device=device),
                   "k_scale": torch.zeros((batch, max_len), device=device),
                   "v_scale": torch.zeros((batch, max_len), device=device)}
            if staging_window:
                wshape = (batch, staging_window, *shape[2:])
                out["ks"] = torch.zeros(wshape, dtype=dtype, device=device)
                out["vs"] = torch.zeros(wshape, dtype=dtype, device=device)
            return out
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    cache = {"index": 0, "layers": [layer() for _ in range(config.decoder_layers)]}
    if staging_window:
        cache["base"] = 0
    return cache


def flush_staging(cache: Dict[str, Any]) -> Dict[str, Any]:
    """Quantize every layer's staging window into its int8 slabs at
    ``base`` with the slab's per-token quantizer, and advance ``base`` by W
    (window tokens past the slab's end are dropped).  A cache without
    staging is returned as it is."""
    if "base" not in cache:
        return cache
    base = cache["base"]
    for layer in cache["layers"]:
        window = layer["ks"].shape[1]
        n = max(0, min(window, layer["k"].shape[1] - base))
        for src, codes, scale in (("ks", "k", "k_scale"), ("vs", "v", "v_scale")):
            q, sc = _quantize_kv(layer[src][:, :n])
            layer[codes][:, base : base + n] = q
            layer[scale][:, base : base + n] = sc
    cache["base"] = base + cache["layers"][0]["ks"].shape[1]
    return cache


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token int8: x [..., t, H, Dh] → (int8 codes, f32 scale [..., t]).
    The scale spans all heads and dims of a (row, token), so it factors out
    of the attention contractions exactly."""
    x32 = x.to(torch.float32)
    scale = torch.clamp_min(x32.abs().amax(dim=(-2, -1)), 1e-8) / 127.0
    q = torch.clamp(torch.round(x32 / scale[..., None, None]), -127, 127).to(torch.int8)
    return q, scale


# The memory order of the cross-attention K and V behind their [B, T_enc,
# H, Dh] shape (to it, and back): K as [B, H, Dh, T_enc] and V as [B, H,
# T_enc, Dh], the layouts that the decoder's batched products read them in.
# Stored as [B, T_enc, H, Dh], each einsum copied the segment's whole K and
# V into those layouts in every layer of every decode step.
_CROSS_ORDER = {"k": ((0, 2, 3, 1), (0, 3, 1, 2)), "v": ((0, 2, 1, 3), (0, 2, 1, 3))}


def cross_kv_order(name: str, parts: List[torch.Tensor]) -> torch.Tensor:
    """``parts`` ([b, T_enc, H, Dh] each) concatenated along the batch, in
    the memory order of the cross-attention tensor ``name`` (K and V; any
    other, such as an int8 scale, as it is).  Values and shape are those of
    ``torch.cat(parts)``."""
    if name not in _CROSS_ORDER:
        return torch.cat(parts)
    to, back = _CROSS_ORDER[name]
    return torch.cat([part.permute(to) for part in parts]).permute(back)


def precompute_cross_kv(params: Dict[str, Any], encoder_out: torch.Tensor,
                        config: WhisperConfig, int8: bool = False) -> List[Dict[str, torch.Tensor]]:
    """Cross-attention K/V, once per segment: per layer {"k","v"} [B, T_enc, H, Dh]
    in the encoding's dtype (in :func:`cross_kv_order`'s memory order); with
    ``int8`` the codes (in that order) and per-(row, token) f32
    ``k_scale``/``v_scale`` [B, T_enc].  Each segment is projected on its
    own, so its bits do not depend on the batch (see
    :func:`encoder_forward`)."""
    head_dim = config.d_model // config.decoder_attention_heads
    out = []
    for layer in params["decoder"]["layers"]:
        kv = {
            name: cross_kv_order(name, [_split_heads(_linear(layer["encoder_attn"][proj], encoder_out[i : i + 1]),
                                                     head_dim) for i in range(encoder_out.shape[0])])
            for name, proj in (("k", "k_proj"), ("v", "v_proj"))
        }
        if int8:
            (kq, ks), (vq, vs) = _quantize_kv(kv["k"]), _quantize_kv(kv["v"])
            kv = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        out.append(kv)
    return out


def _self_attention_int8(q, k, v, cache_layer, offset: int, mask, step: bool,
                         base: Optional[int] = None) -> torch.Tensor:
    """Self-attention over an int8 cache, with the JAX package's two write
    semantics.  A decode ``step`` attends over the dequantized cache before
    ``offset`` and over this token's K/V at full precision, then stores the
    token's codes.  A multi-token write (the prefill) stores the codes
    first and attends over the dequantized tokens, the new ones included.

    With a staging window (:func:`init_cache`) a step attends the slab
    before ``base``, the window's ``offset - base`` tokens and its own
    token, and stores its K/V in the window, unquantized."""
    t = k.shape[1]
    if step and "ks" in cache_layer:
        staged = offset - base
        attn = _attention_step(
            q, cache_layer["k"][:, :base], cache_layer["v"][:, :base],
            cache_layer["k_scale"][:, :base], cache_layer["v_scale"][:, :base],
            k.to(q.dtype), v.to(q.dtype), mask[..., :base],
            stage_k=cache_layer["ks"][:, :staged], stage_v=cache_layer["vs"][:, :staged],
            stage_mask=mask[..., base:offset],
        )
        cache_layer["ks"][:, staged : staged + 1] = k
        cache_layer["vs"][:, staged : staged + 1] = v
        return attn
    (k_q, k_s), (v_q, v_s) = _quantize_kv(k), _quantize_kv(v)
    if step:
        attn = _attention_step(
            q, cache_layer["k"][:, :offset], cache_layer["v"][:, :offset],
            cache_layer["k_scale"][:, :offset], cache_layer["v_scale"][:, :offset],
            k.to(q.dtype), v.to(q.dtype), mask[..., :offset],
        )
    cache_layer["k"][:, offset : offset + t] = k_q
    cache_layer["v"][:, offset : offset + t] = v_q
    cache_layer["k_scale"][:, offset : offset + t] = k_s
    cache_layer["v_scale"][:, offset : offset + t] = v_s
    if step:
        return attn
    k = cache_layer["k"][:, : offset + t].to(q.dtype) * cache_layer["k_scale"][:, : offset + t, None, None].to(q.dtype)
    v = cache_layer["v"][:, : offset + t].to(q.dtype) * cache_layer["v_scale"][:, : offset + t, None, None].to(q.dtype)
    return _attention(q, k, v, mask)


def _decoder_layer(
    p: Dict[str, Any],
    x: torch.Tensor,
    cross_kv: Dict[str, torch.Tensor],
    num_heads: int,
    self_mask: torch.Tensor,
    cache_layer: Optional[Dict[str, torch.Tensor]],
    offset: int,
    step: bool = False,
    base: Optional[int] = None,
    anc: Optional[torch.Tensor] = None,
    attention_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One decoder layer.  With an ancestry map ``anc`` (a beam step over a
    float cache) the self-attention reads the unpermuted cache through it,
    masked by ``attention_mask``; otherwise by ``self_mask``."""
    head_dim = x.shape[-1] // num_heads
    t = x.shape[1]

    h = _layer_norm(p["self_attn_layer_norm"], x)
    q = _split_heads(_linear(p["self_attn"]["q_proj"], h), head_dim) * (head_dim**-0.5)
    k = _split_heads(_linear(p["self_attn"]["k_proj"], h), head_dim)
    v = _split_heads(_linear(p["self_attn"]["v_proj"], h), head_dim)
    if cache_layer is not None and "k_scale" in cache_layer:
        attn = _self_attention_int8(q, k, v, cache_layer, offset, self_mask, step, base)
    else:
        if cache_layer is not None:
            # in-place cache write; attend over the written prefix only
            # (slots past it are masked by the causal rule in the reference
            # anyway)
            cache_layer["k"][:, offset : offset + t] = k
            cache_layer["v"][:, offset : offset + t] = v
            k = cache_layer["k"][:, : offset + t]
            v = cache_layer["v"][:, : offset + t]
        if anc is not None:
            # a beam step: each logical beam's prefix through the map
            attn = ancestry_attention(q, cache_layer["k"], cache_layer["v"], anc, attention_mask, offset + 1)
        else:
            attn = _attention(q, k, v, self_mask)
    x = x + _linear(p["self_attn"]["out_proj"], attn.reshape(*attn.shape[:2], -1))

    # cross attention: beams of one batch item share the encoder output, so
    # the K/V stay at batch size and the beam rows fold into the query axis
    # (exact — cross attention has no positional structure over queries)
    h = _layer_norm(p["encoder_attn_layer_norm"], x)
    q = _split_heads(_linear(p["encoder_attn"]["q_proj"], h), head_dim) * (head_dim**-0.5)
    k_c, v_c = cross_kv["k"], cross_kv["v"]
    scales = {"k_scale": cross_kv.get("k_scale"), "v_scale": cross_kv.get("v_scale")}
    if scales["k_scale"] is None:
        k_c, v_c = k_c.to(q.dtype), v_c.to(q.dtype)
    if q.shape[0] != k_c.shape[0]:
        reps = q.shape[0] // k_c.shape[0]
        q_folded = q.reshape(k_c.shape[0], reps * q.shape[1], *q.shape[2:])
        attn = _attention(q_folded, k_c, v_c, **scales).reshape(q.shape)
    else:
        attn = _attention(q, k_c, v_c, **scales)
    x = x + _linear(p["encoder_attn"]["out_proj"], attn.reshape(*attn.shape[:2], -1))

    h = _layer_norm(p["final_layer_norm"], x)
    h = _gelu(_linear(p["fc1"], h))
    return x + _linear(p["fc2"], h)


def decoder_forward(
    params: Dict[str, Any],
    input_ids: torch.Tensor,  # [B, T] int64
    cross_kv: List[Dict[str, torch.Tensor]],
    config: WhisperConfig,
    cache: Optional[Dict[str, Any]] = None,
    attention_mask: Optional[torch.Tensor] = None,  # [B, >= index + T] 1=attend
    dtype: torch.dtype = torch.float32,
    prefill: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Teacher forcing (``cache=None``) or incremental decoding: positions
    start at ``cache["index"]``, the cache is updated in place and its
    index advanced.  ``attention_mask`` masks prompt padding (the
    reference's ``decoder_attention_mask`` from pad ids).  Activations are
    in ``dtype``; the logits are f32.

    A single-token call is a decode step, which matters for an int8 cache
    (:func:`_self_attention_int8`) and for a cache with an ancestry map,
    whose steps read it through the map (and which takes steps only);
    ``prefill=True`` gives any call the multi-token write (the JAX package
    prefills a prompt padded to a bucket of at least 8 tokens, so its
    prefill always takes that path).

    Returns (logits [B, T, vocab], cache)."""
    p = params["decoder"]
    t = input_ids.shape[1]
    offset = int(cache["index"]) if cache is not None else 0
    device = input_ids.device
    step = cache is not None and t == 1 and not prefill
    anc = cache.get("anc") if cache is not None else None
    if anc is not None and not step:
        raise ValueError("a cache with an ancestry map takes single-token decode steps only")

    x = p["embed_tokens"]["weight"][input_ids].to(dtype) + p["embed_positions"]["weight"][offset : offset + t].to(dtype)

    mask = None
    if anc is None:
        key_pos = torch.arange(offset + t, device=device)
        query_pos = offset + torch.arange(t, device=device)
        mask = (key_pos[None, :] <= query_pos[:, None])[None, None]  # [1, 1, T, offset+T]
        if attention_mask is not None:
            mask = mask & attention_mask[:, None, None, : offset + t].bool()

    for i, layer in enumerate(p["layers"]):
        x = _decoder_layer(
            layer, x, cross_kv[i], config.decoder_attention_heads, mask,
            cache["layers"][i] if cache is not None else None, offset, step,
            cache.get("base") if cache is not None else None, anc, attention_mask,
        )
    if anc is not None:
        profiler.set_counts("ecw.decode.step", anc_layers=len(p["layers"]))
    x = _layer_norm(p["layer_norm"], x)
    if "embed_tokens_q" in p:
        # weight-only int8 vocab projection: f32 logits, f32 row scales
        q = p["embed_tokens_q"]
        logits = _matmul_f32(x, q["qweight"].to(x.dtype).t()) * q["scale"]
    elif x.dtype == torch.float32:
        logits = F.linear(x, p["embed_tokens"]["weight"].to(x.dtype))
    else:
        logits = _matmul_f32(x, p["embed_tokens"]["weight"].to(x.dtype).t())
    if cache is not None:
        cache["index"] = offset + t
    return logits, cache
