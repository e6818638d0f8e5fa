"""One client scoring one utterance at a time against a paper-2 keyword
catalog: the raw ``[1, L, T, D]`` stack, as the cache loader hands it over
(made on the card from the seed before the request starts), through the
port's projected scorer (every keyword exact) or its cascade (MaxSim
proxy, shortlist, exact scorer), and the probabilities back on the host.

The catalog is made in set-up: pre-projected rows, or raw keyword stacks
that set-up projects with ``project_catalog``.  Set-up ends after one
warm-up request.  The window runs from the first request's start to the
first completion at or after ``--seconds``.  With ``--trace 1`` the
``trace_requests`` requests after the window run under the profiler, the
cascade's stage-1 calls (``maxsim_proxy_fast``) inside ``pb:proxy``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import flops, trace, weights
from ..systems import lef as system

WARMUP_INDEX = 2**32 + 1


class State:
    pass


def setup(env):
    from enhance_cb_whisper_tpu_torch.efficient_kws import catalog as cat_mod

    s = State()
    cfg, mix, device = env.config, env.mix, env.device
    s.cfg, s.mix, s.seed, s.device, s.trace = cfg, mix, env.seed, device, env.trace
    s.cascade = mix.get("shortlist") is not None
    s.model = system.build(cfg, env.seed, device, getattr(torch, mix["dtype"]))
    if mix["catalog"] == "projected":
        s.catalog = weights.projected_catalog(env.seed, mix["keywords"], cfg["n_layers"], mix["keyword_frames"] // 2,
                                              cfg["proj_mlp_units"], mix["chunk"], device,
                                              dtype=getattr(torch, mix["dtype"]))
    else:
        groups = weights.raw_keyword_groups(env.seed, mix["keywords"], cfg["n_layers"], mix["keyword_frames"],
                                            cfg.get("input_dim", cfg["embedding_dim"]), mix["chunk"], device)
        s.catalog = cat_mod.project_catalog(s.model, groups, chunk=mix["chunk"])
        del groups
    if s.cascade:
        s.score = cat_mod.make_cascade_score_fn(s.model, chunk=mix["chunk"], shortlist=mix["shortlist"],
                                                proxy_dtype=mix["proxy_dtype"])
    else:
        s.score = cat_mod.make_projected_score_fn(s.model, chunk=mix["chunk"])
    rng = np.random.default_rng([int(env.seed) & (2**64 - 1), 43])
    s.sample = set(int(x) for x in rng.choice(mix["check_pool"], size=mix["check_requests"], replace=False))
    s.kept, s.slice, s.annotate, s.recording = {}, None, False, None
    _install(s, cat_mod)
    _request(s, WARMUP_INDEX)
    return s


def _install(s, cat_mod) -> None:
    """Wrap the cascade's stage 1 and shortlist (the scorer calls them by
    module name): keep what they give for the requests the check judges,
    and annotate stage 1 in the profiled slice."""
    proxy_fast, shortlist_rows = cat_mod.maxsim_proxy_fast, cat_mod.shortlist_rows

    def proxy(*args, **kwargs):
        if s.annotate:
            with torch.profiler.record_function("pb:proxy"):
                out = proxy_fast(*args, **kwargs)
        else:
            out = proxy_fast(*args, **kwargs)
        if s.recording is not None:
            s.recording.setdefault("proxy", []).append(out)
        return out

    def shortlist(proxy_all, k):
        idx = shortlist_rows(proxy_all, k)
        if s.recording is not None:
            s.recording["shortlist"] = idx
        return idx

    cat_mod.maxsim_proxy_fast, cat_mod.shortlist_rows = proxy, shortlist
    s.restore = lambda: (setattr(cat_mod, "maxsim_proxy_fast", proxy_fast),
                         setattr(cat_mod, "shortlist_rows", shortlist_rows))


def _request(s, index: int, keep: bool = False):
    cfg, mix = s.cfg, s.mix
    utt = weights.utterance_stack(s.seed, index, cfg["n_layers"], mix["utterance_frames"],
                                  cfg.get("input_dim", cfg["embedding_dim"]), s.device)
    mask = torch.ones(utt.shape[:3], device=s.device)
    s.recording = {"index": index} if keep else None
    t0 = time.perf_counter()
    probs = s.score(s.catalog, utt, mask).cpu()
    t1 = time.perf_counter()
    if keep:
        rec = s.recording
        rec["probs"] = probs
        if "proxy" in rec:
            rec["proxy"] = torch.cat(rec["proxy"])
        s.kept[index] = rec
    s.recording = None
    return t0, t1


def window(s, seconds: float) -> dict:
    mix, cfg = s.mix, s.cfg
    setup_end = time.perf_counter()
    latency, start, i = [], None, 0
    while True:
        t0, t1 = _request(s, i, keep=i in s.sample)
        start = t0 if start is None else start
        latency.append(t1 - t0)
        i += 1
        if t1 - start >= seconds:
            break
    n = len(latency)
    if s.trace:
        s.annotate = True
        with trace.profiled(s.device) as s.slice:
            for j in range(mix["trace_requests"]):
                with torch.profiler.record_function("pb:request"):
                    _request(s, n + j)
        s.annotate = False
    kw_frames = mix["keyword_frames"] // 2
    utt_frames = (mix["utterance_frames"] + 1) // 2
    exact = mix["shortlist"] if s.cascade else mix["keywords"]
    per_request = (exact * flops.resnet_conv_flops(cfg["resnet"], cfg["n_layers"], (kw_frames, utt_frames))
                   + flops.lef_sim_flops(cfg, kw_frames, utt_frames, exact)
                   + flops.lef_projection_flops(cfg, mix["utterance_frames"]))
    if s.cascade:
        per_request += flops.lef_sim_flops(cfg, kw_frames, utt_frames, mix["keywords"])
    return {"setup_end": setup_end, "window_s": t1 - start, "latency_s": latency, "attempted": n, "failed": 0,
            "keywords": mix["keywords"], "flops": n * per_request,
            "trace_requests": mix["trace_requests"] if s.trace else 0}


def check_items(s, out: dict) -> list:
    return [s.kept[i] for i in sorted(s.kept) if i < out["attempted"]]


def close(s) -> None:
    s.restore()
    s.model = s.catalog = s.score = None
