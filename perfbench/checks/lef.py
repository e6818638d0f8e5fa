"""Judges a paper-2 catalog cell's sampled requests against the plain
reference (float32, TF32 off).

The reference makes its own weights, catalog and utterances from the seed;
where the cell's catalog is projected in set-up (raw keyword stacks), the
reference projects them again.  Numbers compared (each the largest over
the sampled requests):

* ``prob_gap``: the exact probability of every row the program scored
  exactly (the whole catalog, or the cascade's shortlist), max
  |program - reference|;
* ``proxy_gap`` (cascade): the MaxSim proxy of every catalog row, max
  |program - reference|;
* ``shortlist_gap`` (cascade): how far below the reference's own
  ``shortlist``-th best proxy the worst row of the program's shortlist
  lies, by the reference's proxy (0 when every shortlisted row is among
  the reference's best).

With ``control`` set, the reference in that lower precision stands in for
the program, its shortlist taken by its own proxy.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .. import weights
from ..reference import lef as ref_lef
from ..reference.precision import Prec, full_fp32
from ..systems import lef as system


def catalog(env, prec: Prec) -> dict:
    """The cell's catalog as the reference takes it: the pre-projected rows
    as made, or the raw stacks projected at ``prec``."""
    cfg, mix, seed, device = env.config, env.mix, env.seed, env.device
    w = weights.materialize(weights.lef_spec(cfg), seed, system.SALT_LEF, device)
    if mix["catalog"] == "projected":
        cat = weights.projected_catalog(seed, mix["keywords"], cfg["n_layers"], mix["keyword_frames"] // 2,
                                        cfg["proj_mlp_units"], mix["chunk"], device, dtype=getattr(torch, mix["dtype"]))
        return {"w": w, "kwd": cat["kwd"].float(), "kwd_mask": cat["kwd_mask"].float()}
    kwd, kwd_mask = [], []
    for g in weights.raw_keyword_groups(seed, mix["keywords"], cfg["n_layers"], mix["keyword_frames"],
                                        cfg.get("input_dim", cfg["embedding_dim"]), mix["chunk"], device):
        k, m = ref_lef.project(w, cfg, g["kwd"], g["kwd_mask"], prec)
        kwd.append(k)
        kwd_mask.append(m)
    return {"w": w, "kwd": torch.cat(kwd), "kwd_mask": torch.cat(kwd_mask)}


def _utterance(env, index: int, w, prec: Prec):
    cfg, mix = env.config, env.mix
    utt = weights.utterance_stack(env.seed, index, cfg["n_layers"], mix["utterance_frames"],
                                  cfg.get("input_dim", cfg["embedding_dim"]), env.device)
    mask = torch.ones(utt.shape[:3], device=env.device)
    return ref_lef.project(w, cfg, utt, mask, prec)


@torch.no_grad()
def readings(env, items: List[dict], control: Optional[str] = None) -> Dict[str, float]:
    """``items``: per sampled request ``index``, the program's ``probs``
    [N] and, for a cascade, its ``proxy`` [N] and ``shortlist`` [k]."""
    cfg, mix = env.config, env.mix
    full_fp32()
    ref = Prec("fp32")
    cat = catalog(env, ref)
    low = Prec(control) if control else None
    cat_low = catalog(env, low) if low and mix["catalog"] != "projected" else cat
    w = cat["w"]
    cascade = mix.get("shortlist") is not None
    gaps = {"prob_gap": 0.0}
    for item in items:
        utt, utt_mask = _utterance(env, item["index"], w, ref)
        if low:
            utt_c, utt_mask_c = _utterance(env, item["index"], w, low)
        if cascade:
            proxy_ref = ref_lef.proxy_all(cat["kwd"], utt, cat["kwd_mask"], utt_mask, ref)
            if low:
                proxy_c = ref_lef.proxy_all(cat_low["kwd"], utt_c, cat_low["kwd_mask"], utt_mask_c, low)
                rows = torch.sort(proxy_c, descending=True, stable=True).indices[: mix["shortlist"]]
            else:
                proxy_c = item["proxy"].to(env.device)
                rows = item["shortlist"].to(env.device)
            kth = torch.sort(proxy_ref, descending=True).values[mix["shortlist"] - 1]
            gaps["proxy_gap"] = max(gaps.get("proxy_gap", 0.0), float((proxy_c - proxy_ref).abs().max()))
            gaps["shortlist_gap"] = max(gaps.get("shortlist_gap", 0.0),
                                        max(0.0, float(kth - proxy_ref[rows].min())))
        else:
            rows = torch.arange(mix["keywords"], device=env.device)
        p_ref = ref_lef.probs(w, cfg, cat["kwd"][rows], utt, cat["kwd_mask"][rows], utt_mask, ref)
        if low:
            p_c = ref_lef.probs(w, cfg, cat_low["kwd"][rows], utt_c, cat_low["kwd_mask"][rows], utt_mask_c, low)
        else:
            p_c = item["probs"].to(env.device)[rows]
        gaps["prob_gap"] = max(gaps["prob_gap"], float((p_c - p_ref).abs().max()))
    return gaps
