"""Sharded execution on the (``data``, ``model``) mesh (port of
enhance_cb_whisper_tpu/parallel/sharding.py).

* :func:`make_sharded_train_step` — the paper-1 train step with the batch
  over ``data``: each rank computes its share of every minibatch with the
  BatchNorm statistics of the global batch, the gradients are summed over
  ``data`` once per step, and parameters and Adam's state stay replicated
  (never re-sent).  It gives the single-device step's result.
* :func:`shard_catalog` — the keyword rows of a device catalog
  (``catalog/database.py:device_put_catalog`` or paper 2's
  ``efficient_kws/catalog.py:project_catalog``) over ``model``: each rank
  keeps a contiguous block of whole scoring chunks, scores it, and the
  scorers gather the ``[N_pad]`` results back into row order.
* :func:`whisper_param_sharding` — megatron tensor parallelism of the
  Whisper params over ``model``: q/k/v/fc1 split by output (heads, hidden
  units), out_proj/fc2 split by input with their partial products summed
  over the group before the bias; everything else replicated.

Where the JAX package hands XLA shardings, these return the rank's own
values: the collectives are explicit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..models.whisper import WhisperConfig
from ..train.kws_train import KWSTrainConfig, KWSTrainState, make_train_step
from .mesh import dim_rank, dim_size, gather_rows


def make_sharded_train_step(config: KWSTrainConfig, state: KWSTrainState, mesh: DeviceMesh,
                            axis: str = "data"):
    """``step(batch, noise, beta, suppression) -> metrics`` data-parallel
    over ``axis`` (:func:`..train.kws_train.make_train_step` with the
    axis's group).  Every rank passes the same global batch and a noise
    source that draws for it; ``state`` must start equal on every rank
    (:func:`.mesh.replicate`)."""
    return make_train_step(config, state, data_group=mesh.get_group(axis))


# --------------------------------------------------------------------------
# catalog rows over `model`


@dataclasses.dataclass
class CatalogShard:
    """Which rows of a sharded catalog this rank holds: ``[lo, hi)`` of
    ``total``, every rank's row count in ``lengths``."""

    group: Any
    lo: int
    hi: int
    total: int
    lengths: List[int]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's block of ``x`` (rows of this shard) in row order."""
        return gather_rows(x, self.group, self.lengths)


def shard_catalog(catalog_dev: Dict[str, Any], mesh: DeviceMesh, axis: str = "model") -> Dict[str, Any]:
    """This rank's block of a device catalog's rows: the ranks of ``axis``
    split its ``chunk``-row scoring chunks into contiguous runs (the first
    ranks take one more where they do not divide), so the block is a
    multiple of ``chunk`` and the ranks launch as many chunks in all as one
    rank would.  Every tensor with the catalog's leading row count is cut;
    ``"shard"`` (:class:`CatalogShard`) tells the scorers to gather."""
    n_pad = int(catalog_dev["mask"].shape[0])
    chunk = int(catalog_dev["chunk"])
    n, r = dim_size(mesh, axis), dim_rank(mesh, axis)
    assert n_pad % chunk == 0, f"catalog rows ({n_pad}) must be a multiple of chunk ({chunk})"
    n_chunks = n_pad // chunk
    assert n_chunks >= n, f"{n_chunks} chunks of {chunk} rows cannot cover {n} ranks of {axis}"
    lengths = [len(c) * chunk for c in np.array_split(np.arange(n_chunks), n)]
    lo = sum(lengths[:r])
    hi = lo + lengths[r]
    out = {k: v[lo:hi] if isinstance(v, torch.Tensor) and v.ndim and v.shape[0] == n_pad else v
           for k, v in catalog_dev.items()}
    out["shard"] = CatalogShard(mesh.get_group(axis), lo, hi, n_pad, lengths)
    return out


# --------------------------------------------------------------------------
# tensor-parallel Whisper


def _refuse_int8(tree, path: str = "") -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k in ("qweight", "act_scales", "embed_tokens_q"):
                raise ValueError(
                    f"tensor parallelism takes float Whisper params; {path}/{k} is int8 "
                    "(decoder_int8, vocab_int8 or encoder_int8): shard the f32 params instead")
            _refuse_int8(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            _refuse_int8(v, f"{path}/{i}")


def whisper_param_sharding(params: Dict[str, Any], mesh: DeviceMesh,
                           config: Optional[WhisperConfig] = None, axis: str = "model") -> Dict[str, Any]:
    """This rank's tensor-parallel share of the Whisper params (the
    JAX package's specs, in torch's [out, in] layout): column-split
    ``q_proj``/``k_proj``/``v_proj``/``fc1`` weights and biases (a
    contiguous run of heads or hidden units), row-split ``out_proj``/
    ``fc2`` weights whose dicts carry the group under ``"reduce"``
    (``models/whisper.py:_linear`` sums their partial products over it and
    adds the whole bias once), everything else as it is.  The forward
    functions take the params as they are; the attention works on the
    rank's heads and the decoder's cache holds them
    (``models/whisper.py:decoder_heads``).

    Float params only: int8 leaves raise ``ValueError``.  With ``config``
    the head counts are checked to divide over the axis."""
    _refuse_int8(params)
    n, r = dim_size(mesh, axis), dim_rank(mesh, axis)
    group = mesh.get_group(axis)
    if config is not None:
        for heads in (config.encoder_attention_heads, config.decoder_attention_heads):
            if heads % n:
                raise ValueError(f"{heads} attention heads do not divide over {axis}={n}")

    def block(x: torch.Tensor, dim: int) -> torch.Tensor:
        size = x.shape[dim]
        if size % n:
            raise ValueError(f"width {size} does not divide over {axis}={n}")
        return x.narrow(dim, r * (size // n), size // n).contiguous()

    def column(p):
        return {k: block(v, 0) if k in ("weight", "bias") else v for k, v in p.items()}

    def row(p):
        return {**p, "weight": block(p["weight"], 1), "reduce": group}

    def attn(p):
        return {**p, "q_proj": column(p["q_proj"]), "k_proj": column(p["k_proj"]),
                "v_proj": column(p["v_proj"]), "out_proj": row(p["out_proj"])}

    def layer(p, decoder: bool):
        out = {**p, "self_attn": attn(p["self_attn"]), "fc1": column(p["fc1"]), "fc2": row(p["fc2"])}
        if decoder:
            out["encoder_attn"] = attn(p["encoder_attn"])
        return out

    return {
        **params,
        "encoder": {**params["encoder"], "layers": [layer(p, False) for p in params["encoder"]["layers"]]},
        "decoder": {**params["decoder"], "layers": [layer(p, True) for p in params["decoder"]["layers"]]},
    }
