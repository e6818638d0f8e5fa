"""Whisper's encoder and a teacher-forced decoder, written out plainly.

The weights are HF's ``WhisperModel`` state dict (without the ``model.``
prefix).  Pre-LayerNorm blocks, exact GELU, attention scaled by
``head_dim ** -0.5``, no KV cache: the decoder runs the whole sequence
at once under a causal mask, with padded prompt positions masked as keys.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .precision import Prec

NEG = torch.finfo(torch.float32).min


def _ln(w, name, x):
    return F.layer_norm(x, (x.shape[-1],), w[f"{name}.weight"], w[f"{name}.bias"], 1e-5)


def _lin(w, name, x, prec: Prec):
    return prec.linear(x, w[f"{name}.weight"], w.get(f"{name}.bias"))


def _attend(q, k, v, heads: int, prec: Prec, mask=None):
    """q [Tq, D], k/v [Tk, D] → [Tq, D]; ``mask`` [Tq, Tk] True = keep."""
    dh = q.shape[-1] // heads
    q = q.view(q.shape[0], heads, dh).transpose(0, 1) * dh**-0.5
    k = k.view(k.shape[0], heads, dh).transpose(0, 1)
    v = v.view(v.shape[0], heads, dh).transpose(0, 1)
    scores = prec.matmul(q, k.transpose(-1, -2))
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG)
    out = prec.matmul(torch.softmax(scores, dim=-1), v)
    return out.transpose(0, 1).reshape(q.shape[1], -1)


def _attention(w, name, x, src, heads, prec, mask=None):
    q = _lin(w, f"{name}.q_proj", x, prec)
    k = _lin(w, f"{name}.k_proj", src, prec)
    v = _lin(w, f"{name}.v_proj", src, prec)
    return _lin(w, f"{name}.out_proj", _attend(q, k, v, heads, prec, mask), prec)


def _mlp(w, name, x, prec):
    return _lin(w, f"{name}.fc2", F.gelu(_lin(w, f"{name}.fc1", x, prec)), prec)


def encode(w: Dict[str, torch.Tensor], cfg: dict, mel: torch.Tensor, prec: Prec
           ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """mel [n_mels, 3000] → (last hidden state [1500, D] after the final
    LayerNorm, the hidden states [input to layer 0, ..., output of layer
    n-1 with the final LayerNorm applied], HF's tuple)."""
    x = F.gelu(prec.conv1d(mel[None], w["encoder.conv1.weight"], w["encoder.conv1.bias"], padding=1))
    x = F.gelu(prec.conv1d(x, w["encoder.conv2.weight"], w["encoder.conv2.bias"], stride=2, padding=1))
    x = x[0].t() + w["encoder.embed_positions.weight"]
    states = [x]
    heads = cfg["encoder_attention_heads"]
    for i in range(cfg["encoder_layers"]):
        name = f"encoder.layers.{i}"
        h = _ln(w, f"{name}.self_attn_layer_norm", x)
        x = x + _attention(w, f"{name}.self_attn", h, h, heads, prec)
        x = x + _mlp(w, name, _ln(w, f"{name}.final_layer_norm", x), prec)
        states.append(x)
    last = _ln(w, "encoder.layer_norm", x)
    states[-1] = last
    return last, states


def decode_logits(w: Dict[str, torch.Tensor], cfg: dict, ids: torch.Tensor, key_mask: torch.Tensor,
                  enc: torch.Tensor, prec: Prec) -> torch.Tensor:
    """Teacher forcing: ids [T] (prompt and generated tokens), key_mask [T]
    (0 at padded prompt positions), enc [1500, D] → logits [T, vocab]."""
    t = ids.shape[0]
    x = w["decoder.embed_tokens.weight"][ids] + w["decoder.embed_positions.weight"][:t]
    pos = torch.arange(t, device=ids.device)
    mask = (pos[None, :] <= pos[:, None]) & key_mask.bool()[None, :]
    heads = cfg["decoder_attention_heads"]
    for i in range(cfg["decoder_layers"]):
        name = f"decoder.layers.{i}"
        h = _ln(w, f"{name}.self_attn_layer_norm", x)
        x = x + _attention(w, f"{name}.self_attn", h, h, heads, prec, mask)
        h = _ln(w, f"{name}.encoder_attn_layer_norm", x)
        x = x + _attention(w, f"{name}.encoder_attn", h, enc, heads, prec)
        x = x + _mlp(w, name, _ln(w, f"{name}.final_layer_norm", x), prec)
    x = _ln(w, "decoder.layer_norm", x)
    return prec.matmul(x, w["decoder.embed_tokens.weight"].t())
