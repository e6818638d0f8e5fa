"""Pre-projected keyword catalogs for massive open-vocabulary KWS (port of
enhance_cb_whisper_tpu/efficient_kws/catalog.py, one device).

A 100k-keyword catalog of raw ``[L, 150, 1024]`` stacks would not fit on
the card; the LE/LEF projections bring each keyword down to 64 dims (LEF
also halves its frames), ~40x smaller.

* :func:`project_catalog` — the model's projection stack over the keyword
  groups once: ``{kwd [N_pad, L, T', U], kwd_mask [N_pad, L, T'], mask
  [N_pad]}`` on the model's device, zero-padded to a multiple of ``chunk``;
* :func:`make_projected_score_fn` — per utterance: project it once, then
  similarity + ResNet over the catalog ``chunk`` rows at a time (a loop
  where the JAX package runs ``lax.map``);
* :func:`make_cascade_score_fn` — a MaxSim proxy (:func:`maxsim_proxy`,
  or the bf16 :func:`maxsim_proxy_fast`) ranks every keyword and the exact
  chunked classifier scores only the top ``shortlist``.  The shortlist is
  taken by a stable descending sort, so equal proxies keep the lower row
  first, as ``lax.top_k`` does (padded rows are -inf and tie).

The float classifier is the model's own; with ``quantized_params``
(:func:`..models.quant.quantize_efficient_classifier`) and calibrated
``act_scales`` the ResNet and head run int8, with the bottleneck 1×1
convolutions of the stages in ``s8_1x1`` on the fused kernel K2.  The
projection and the similarity stay float either way.  Each entry point
holds :func:`..runtime.precision.reference_precision` when the model is on
the card, so its fp32 products run at full FP32 as the JAX package's
``precision="highest"`` ones do.  A catalog whose rows are sharded over
the mesh's ``model`` ranks (:func:`..parallel.sharding.shard_catalog`) is
scored rank by rank: the full scorer gathers its rows' probabilities; the
cascade gathers the proxy, takes the same shortlist on every rank, scores
the shortlisted rows each rank holds and gathers the result.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..models.quant import make_quantized_kws_apply
from ..runtime.precision import reference_precision
from .model import EfficientKWSModel, _safe_normalize, masked_sims


def _device(model: torch.nn.Module) -> torch.device:
    """The model's device; on the card, TF32 and bf16 partial sums off."""
    device = next(model.parameters()).device
    if device.type == "cuda":
        reference_precision()
    return device


def _tensor(x, device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(dtype)


@torch.no_grad()
def project_catalog(model: EfficientKWSModel, groups, chunk: int = 128,
                    dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """``groups``: the eval datasets' group list ({kwd, kwd_mask, mask})."""
    device = _device(model)
    kwds, masks, valid = [], [], []
    for g in groups:
        km = _tensor(g["kwd_mask"], device)
        out, pooled = model.project(_tensor(g["kwd"], device), km)
        kwds.append(out.to(torch.float32))
        masks.append(pooled if pooled is not None else km)
        valid.append(_tensor(g["mask"], device))
    kwd, kwd_mask, mask = torch.cat(kwds), torch.cat(masks), torch.cat(valid)
    n = kwd.shape[0]
    pad = -(-n // chunk) * chunk - n

    def pad0(x):
        return torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])

    return {"kwd": pad0(kwd).to(dtype), "kwd_mask": pad0(kwd_mask).to(dtype),
            "mask": pad0(mask), "num_keywords": n, "chunk": chunk}


def _make_chunk_classifier(model: EfficientKWSModel, quantized_params=None, act_scales=None,
                           s8_1x1=()):
    """The exact per-chunk classifier of the full and cascade scorers:
    ``bind(utt_p, utt_mask_p)(kwd, kwd_mask) -> logits [chunk, 2]`` (float:
    ``classify_projected``; int8: ``masked_sims`` + the quantized ResNet)."""
    if quantized_params is not None:
        q_apply = make_quantized_kws_apply(model.config.resnet_config(), act_scales=act_scales,
                                           s8_1x1=s8_1x1)

    def bind(utt_p, utt_mask_p):
        def chunk_logits(kwd, kwd_mask):
            if quantized_params is not None:
                return q_apply(quantized_params, masked_sims(kwd, utt_p, kwd_mask, utt_mask_p))
            return model.classify_projected(kwd, utt_p, kwd_mask, utt_mask_p)[0]

        return chunk_logits

    return bind


def _chunked_probs(chunk_logits, kwd, kwd_mask, chunk: int) -> torch.Tensor:
    if kwd.shape[0] == 0:
        return kwd.new_zeros((0,), dtype=torch.float32)
    return torch.cat([
        torch.softmax(chunk_logits(kwd[i:i + chunk], kwd_mask[i:i + chunk]), -1)[:, 1]
        for i in range(0, kwd.shape[0], chunk)
    ])


def _gathered(catalog, x: torch.Tensor) -> torch.Tensor:
    """``x`` over this rank's catalog rows → over all rows (a sharded
    catalog), or ``x`` itself."""
    return catalog["shard"].gather(x) if "shard" in catalog else x


def _check_rows(catalog, chunk: int) -> int:
    n_pad = catalog["kwd"].shape[0]
    assert n_pad % chunk == 0, (
        f"catalog rows ({n_pad}) must be a multiple of chunk ({chunk}) — "
        "build the catalog with project_catalog(chunk=...) or pad it"
    )
    return n_pad


def _project_utterance(model, utt, utt_mask):
    device = _device(model)
    return model.project(_tensor(utt, device), None if utt_mask is None else _tensor(utt_mask, device))


def make_projected_score_fn(model: EfficientKWSModel, chunk: int = 128, quantized_params=None,
                            act_scales=None, s8_1x1=()):
    """``score(catalog, utt, utt_mask) -> probs [N_pad]`` (utt: [1, L, T, D]
    raw features); padded and ghost rows score 0."""
    _device(model)
    bind = _make_chunk_classifier(model, quantized_params, act_scales, s8_1x1)

    @torch.no_grad()
    def score(catalog, utt, utt_mask):
        _check_rows(catalog, chunk)
        utt_p, utt_mask_p = _project_utterance(model, utt, utt_mask)
        probs = _chunked_probs(bind(utt_p, utt_mask_p), catalog["kwd"], catalog["kwd_mask"], chunk)
        return _gathered(catalog, probs * catalog["mask"])

    return score


def maxsim_proxy(kwd, utt_p, kwd_mask, utt_mask_p) -> torch.Tensor:
    """Stage-1 cascade score, no ResNet: per keyword frame its best cosine
    over the utterance frames, averaged over the keyword's valid frames,
    then over layers.  Reads the exact classifier's ``masked_sims``.
    Returns [chunk] f32."""
    return _maxsim_reduce(masked_sims(kwd, utt_p, kwd_mask, utt_mask_p), kwd_mask, utt_mask_p)


def _maxsim_reduce(sims, kwd_mask, utt_mask_p) -> torch.Tensor:
    """max over T_u → masked mean over T_k → mean over L."""
    if utt_mask_p is not None:
        # a finite sentinel: -inf * 0 would be nan in the masked mean below
        sims = torch.where(utt_mask_p[:, :, None, :] > 0, sims, sims.new_tensor(-1e30))
    best = torch.amax(sims, dim=-1)  # [c, L, T_k]
    if kwd_mask is not None:
        best = torch.where(kwd_mask > 0, best, best.new_tensor(0.0))
        denom = torch.clamp_min(torch.sum(kwd_mask, dim=-1), 1.0)  # [c, L]
        per_layer = torch.sum(best, dim=-1) / denom
    else:
        per_layer = torch.mean(best, dim=-1)
    return torch.mean(per_layer, dim=-1)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``bmm`` with an f32 result from bf16 operands (JAX's
    ``preferred_element_type=jnp.float32``): cuBLAS writes f32 on the card;
    the CPU has no such product, so the operands are upcast there (exact)."""
    if a.device.type == "cpu" or a.dtype == torch.float32:
        return torch.bmm(a.to(torch.float32), b.to(torch.float32))
    return torch.bmm(a, b, out_dtype=torch.float32)


def maxsim_proxy_fast(kwd, utt_n, kwd_mask, utt_mask_p, dtype=torch.bfloat16) -> torch.Tensor:
    """:func:`maxsim_proxy`'s reduction over a cheaper similarity: operands
    rounded to ``dtype`` and products summed in f32, the utterance side
    normalized once per utterance (``utt_n = _safe_normalize(utt_p)[0]``,
    [L, T_u, U]).  Returns [chunk] f32."""
    c, n_layers, t_k, u = kwd.shape
    kwd_n = _safe_normalize(kwd, 1e-6).to(dtype)
    # per layer, every keyword frame of the chunk against the utterance
    rows = kwd_n.transpose(0, 1).reshape(n_layers, c * t_k, u)
    sims = _bmm_f32(rows, utt_n.to(dtype).transpose(-1, -2))  # [L, c * T_k, T_u]
    sims = sims.reshape(n_layers, c, t_k, -1).transpose(0, 1)
    mask3 = utt_mask_p[:1] if utt_mask_p is not None else None
    return _maxsim_reduce(sims, kwd_mask, mask3)


def shortlist_rows(proxy: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries, largest first, equal values in
    row order (``lax.top_k``'s order; ``torch.topk`` promises none)."""
    return torch.sort(proxy, descending=True, stable=True).indices[:k]


def make_cascade_score_fn(model: EfficientKWSModel, chunk: int = 128, shortlist: int = 2048,
                          quantized_params=None, act_scales=None, proxy_dtype: str = "bfloat16",
                          s8_1x1=()):
    """Two-stage scorer for massive catalogs: ``score(catalog, utt, utt_mask)
    -> probs [N_pad]``, the shortlisted rows carrying the full scorer's
    probability and every other row exactly 0.  ``proxy_dtype``:
    "bfloat16" (:func:`maxsim_proxy_fast`) or "float32" (:func:`maxsim_proxy`
    on the classifier's own similarity maps); stage 2 is exact either way."""
    assert shortlist % chunk == 0, (
        f"shortlist ({shortlist}) must be a multiple of chunk ({chunk}) so "
        "stage 2 reuses the full scorer's chunk shape"
    )
    _device(model)
    bind = _make_chunk_classifier(model, quantized_params, act_scales, s8_1x1)

    @torch.no_grad()
    def score(catalog, utt, utt_mask):
        n_pad = _check_rows(catalog, chunk)
        shard = catalog.get("shard")
        total = shard.total if shard is not None else n_pad
        assert shortlist <= total, f"shortlist ({shortlist}) exceeds catalog rows ({total})"
        utt_p, utt_mask_p = _project_utterance(model, utt, utt_mask)
        kwd, kwd_mask = catalog["kwd"], catalog["kwd_mask"]
        if proxy_dtype == "float32":
            parts = [maxsim_proxy(kwd[i:i + chunk], utt_p, kwd_mask[i:i + chunk], utt_mask_p)
                     for i in range(0, n_pad, chunk)]
        else:
            utt_n = _safe_normalize(utt_p, 1e-6)[0]  # once per utterance
            dtype = getattr(torch, proxy_dtype)
            parts = [maxsim_proxy_fast(kwd[i:i + chunk], utt_n, kwd_mask[i:i + chunk], utt_mask_p, dtype)
                     for i in range(0, n_pad, chunk)]
        proxy = _gathered(catalog, torch.where(catalog["mask"] > 0, torch.cat(parts), float("-inf")))
        idx = shortlist_rows(proxy, shortlist)
        if shard is not None:
            # every rank took the same shortlist; each scores the rows it holds
            idx = idx[(idx >= shard.lo) & (idx < shard.hi)] - shard.lo
        probs_s = _chunked_probs(bind(utt_p, utt_mask_p), kwd[idx], kwd_mask[idx], chunk)
        probs = torch.zeros(n_pad, dtype=probs_s.dtype, device=probs_s.device)
        probs[idx] = probs_s
        return _gathered(catalog, probs * catalog["mask"])

    return score

