"""Keyword catalog: padded device tensors + batched scoring (port of
enhance_cb_whisper_tpu/catalog/database.py).

The whole catalog is three padded arrays —

    hs     [N_pad, L, T_k_max, D]   keyword hidden-state stacks
    frames [N_pad]                  true frame counts
    mask   [N_pad]                  1 = real, non-ghost keyword

— and the variable keyword length → fixed (150, 750) bilinear resize is
folded into the matmuls: per-keyword height-resize matrices [out_h, T_k_max]
(zero-padded columns) reproduce torchvision's ``antialias=False`` resize
exactly while every shape stays static.  Scoring walks the catalog in
chunks: sim einsum with the resize folded in → ResNet → softmax.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.resize import resize_matrix
from .store import hidden_states_exist, load_hidden_states


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclasses.dataclass
class KeywordCatalog:
    keywords: List[str]  # length N (real keywords)
    hs: np.ndarray  # [N_pad, L, T_k_max, D] zero-padded
    frames: np.ndarray  # [N_pad] int, true frame count (>=1)
    mask: np.ndarray  # [N_pad] 1.0 = real non-ghost keyword
    group_size: int = 100  # the reference's keywords per group (per-group loss)

    @property
    def num_keywords(self) -> int:
        return len(self.keywords)

    @property
    def num_padded(self) -> int:
        return self.hs.shape[0]

    @classmethod
    def from_arrays(
        cls,
        keywords: Sequence[str],
        stacks: Sequence[Optional[np.ndarray]],  # each [L, T_k, D] or None (ghost)
        group_size: int = 100,
        pad_multiple: int = 8,
    ) -> "KeywordCatalog":
        """Ghost keywords (missing caches) get zero features and mask 0,
        with the smallest real keyword's frame count."""
        real = [s for s in stacks if s is not None]
        if not real:
            raise ValueError("catalog has no keyword hidden states at all")
        n_layers, _, dim = real[0].shape
        t_max = max(max(s.shape[1] for s in real), 1)
        n = len(keywords)
        n_pad = _round_up(max(n, 1), pad_multiple)

        hs = np.zeros((n_pad, n_layers, t_max, dim), dtype=np.float32)
        frames = np.ones((n_pad,), dtype=np.int32)
        mask = np.zeros((n_pad,), dtype=np.float32)
        smallest = min(real, key=lambda s: s.shape[1])
        for i, s in enumerate(stacks):
            if s is None:
                frames[i] = smallest.shape[1]
                continue
            hs[i, :, : s.shape[1], :] = s
            frames[i] = s.shape[1]
            mask[i] = 1.0
        return cls(list(keywords), hs, frames, mask, group_size)

    @classmethod
    def from_bin_dir(
        cls,
        keywords: Sequence[str],
        directory: str,
        group_size: int = 100,
    ) -> "KeywordCatalog":
        """Load the reference's keywords-hs layout: ``{idx}.bin`` (or the
        ``.npy`` beside it) per keyword, the index zero-padded to the width
        of the last one; a keyword with no file is a ghost."""
        zfill = len(str(len(keywords) - 1))
        stacks: List[Optional[np.ndarray]] = []
        for idx in range(len(keywords)):
            path = os.path.join(directory, str(idx).zfill(zfill) + ".bin")
            stacks.append(load_hidden_states(path) if hidden_states_exist(path) else None)
        return cls.from_arrays(keywords, stacks, group_size)

    def resize_weights(self, out_h: int) -> np.ndarray:
        """[N_pad, out_h, T_k_max]: per-keyword height-resize matrices
        (antialias=False), zero-padded to the static frame budget."""
        w = np.zeros((self.num_padded, out_h, self.hs.shape[2]), dtype=np.float32)
        for i in range(self.num_padded):
            t = int(self.frames[i])
            w[i, :, :t] = resize_matrix(t, out_h, antialias=False)
        return w


def calibration_sim_maps(
    catalog: KeywordCatalog,
    utt_stack: np.ndarray,  # [L, T_u, D] L2-normalized
    out_size: Tuple[int, int] = (150, 750),
    n: int = 8,
) -> np.ndarray:
    """[n, L, out_h, out_w] real similarity maps of the first ``n`` non-ghost
    keywords vs one utterance — the representative inputs for int8
    activation-scale calibration (:mod:`..models.quant`).  Host-side numpy
    replica of the scorer's fold-resize-into-matmul math: the JAX package's
    einsums, written as batched BLAS matmuls (f32 sums in another order)."""
    out_h, out_w = out_size
    utt_stack = np.asarray(utt_stack, np.float32)
    utt_r = resize_matrix(utt_stack.shape[1], out_w, antialias=False) @ utt_stack  # [L, out_w, D]
    utt_t = np.ascontiguousarray(utt_r.transpose(0, 2, 1))  # [L, D, out_w]
    maps = []
    for i in range(catalog.num_padded):
        if catalog.mask[i] == 0:
            continue
        t = int(catalog.frames[i])
        kw_r = resize_matrix(t, out_h, antialias=False) @ catalog.hs[i, :, :t]  # [L, out_h, D]
        maps.append(kw_r @ utt_t)
        if len(maps) == n:
            break
    if not maps:
        raise ValueError("catalog has no non-ghost keywords to calibrate on")
    return np.stack(maps).astype(np.float32)


def calibration_sim_maps_multi(
    catalog: KeywordCatalog,
    utt_stacks,  # sequence of [L, T_u, D] stacks
    out_size: Tuple[int, int] = (150, 750),
    n_per_utt: int = 8,
) -> np.ndarray:
    """Calibration maps over several utterances or segments: the static
    scale is a max over every (keyword, utterance) pair, so more
    calibration batches can only widen it."""
    return np.concatenate(
        [calibration_sim_maps(catalog, np.asarray(u), out_size, n=n_per_utt) for u in utt_stacks]
    )


def device_put_catalog(catalog: KeywordCatalog, out_h: int = 150, chunk: int = 100,
                       device="cuda") -> dict:
    """Pad the catalog to a chunk multiple and move it to ``device``."""
    n_pad = _round_up(catalog.num_padded, chunk)
    extra = n_pad - catalog.num_padded

    def pad0(x):
        return np.pad(x, [(0, extra)] + [(0, 0)] * (x.ndim - 1))

    return {
        "hs": torch.from_numpy(pad0(catalog.hs).astype(np.float32)).to(device),
        "w": torch.from_numpy(pad0(catalog.resize_weights(out_h))).to(device),
        "mask": torch.from_numpy(pad0(catalog.mask).astype(np.float32)).to(device),
        "chunk": chunk,
    }


def make_catalog_score_fn(
    kws_apply: Callable[[torch.Tensor], torch.Tensor],  # images [G, L, H, W] -> logits [G, 2]
    out_size: Tuple[int, int] = (150, 750),
) -> Callable:
    """Build the catalog scorer.

    Returns ``score(catalog_dev, utt_stack, utt_w) -> (probs [N_pad],
    logits [N_pad, 2])``: ``utt_stack`` [L, T_u, D] is L2-normalized,
    ``utt_w`` [out_w, T_u] the width-resize weights.  Per chunk of keywords:
    height-resize the keyword stacks with their per-keyword matrices (or,
    when T_k_max < out_h, contract D first at the native keyword length —
    the resize is linear, so both orders give the same map), cosine-
    similarity einsum → [chunk, L, out_h, out_w], ResNet, softmax.  A
    catalog sharded over the mesh's ``model`` ranks
    (:func:`..parallel.sharding.shard_catalog`) is scored rank by rank
    and its rows gathered, so every rank returns the whole ``[N_pad]``."""
    out_h, _ = out_size

    def score(catalog_dev, utt_stack, utt_w):
        utt_r = torch.einsum("pu,lud->lpd", utt_w, utt_stack)  # [L, out_w, D]
        chunk = catalog_dev["chunk"]
        probs, logits = [], []
        for start in range(0, catalog_dev["hs"].shape[0], chunk):
            kwd_hs = catalog_dev["hs"][start : start + chunk]  # [c, L, T_k, D]
            kwd_w = catalog_dev["w"][start : start + chunk]  # [c, out_h, T_k]
            if kwd_hs.shape[2] < out_h:
                sim_raw = torch.einsum("clkd,lpd->clkp", kwd_hs, utt_r)  # [c, L, T_k, out_w]
                sim = torch.einsum("cok,clkp->clop", kwd_w, sim_raw)
            else:
                kwd_r = torch.einsum("cok,clkd->clod", kwd_w, kwd_hs)  # [c, L, out_h, D]
                sim = torch.einsum("clod,lpd->clop", kwd_r, utt_r)
            chunk_logits = kws_apply(sim)
            probs.append(torch.softmax(chunk_logits, dim=-1)[:, 1])
            logits.append(chunk_logits)
        probs, logits = torch.cat(probs) * catalog_dev["mask"], torch.cat(logits)
        if "shard" in catalog_dev:
            # a model-sharded catalog (parallel/sharding.py:shard_catalog):
            # this rank scored its rows; every rank gets all of them
            shard = catalog_dev["shard"]
            probs, logits = shard.gather(probs), shard.gather(logits)
        return probs, logits

    return score
