"""One client, one request at a time, through the half of a CB-Whisper
window that the decode does not touch: a segment's audio through
``prepare_features`` (kernel K1), then ``CBWhisper.encode_and_spot`` (one
encoder forward, the catalog scorer), then the biased prompt's token ids
on the host.

Set-up ends after one warm-up request.  The window runs from the first
request's start to the first completion at or after ``--seconds``; every
request in it counts.  With ``--trace 1`` the ``trace_requests`` requests
after the window run under the profiler.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import flops, trace, traffic
from ..systems import cbw as system

WARMUP_INDEX = 2**32 + 1  # a request index no window reaches


class State:
    pass


def setup(env):
    s = State()
    s.cfg, s.mix, s.seed, s.device, s.trace = env.config, env.mix, env.seed, env.device, env.trace
    s.cb = system.build(env.config, env.device)
    rng = np.random.default_rng([int(env.seed) & (2**64 - 1), 42])
    s.sample = set(int(x) for x in rng.choice(env.mix["check_pool"], size=env.mix["check_requests"], replace=False))
    s.kept, s.slice = {}, None
    _request(s, WARMUP_INDEX, env.mix["block"] - 1, keep=False)
    return s


def _request(s, index: int, clip: int, keep: bool):
    """One request; returns (start, end, prompt tokens) on the host clock."""
    from enhance_cb_whisper_tpu_torch.audio.io import prepare_features

    audio = traffic.audio(s.mix, clip)
    logits = []
    if keep:
        score_fn = s.cb._score_fn

        def scorer(catalog_dev, stack, utt_w):
            out = score_fn(catalog_dev, stack, utt_w)
            logits.append(out[1])
            return out

        s.cb._score_fn = scorer
    t0 = time.perf_counter()
    feats, _ = prepare_features(audio, n_mels=s.cfg["num_mel_bins"], device=s.device)
    tokens, enc = s.cb.encode_and_spot(feats, start_of_prev=True)
    t1 = time.perf_counter()  # the prompt ids are on the host: spotting has finished
    if keep:
        s.cb._score_fn = score_fn
        s.kept[index] = {"clip": clip, "features": feats[0],
                         "windows": [{"seek": 0, "frames": None, "enc": enc[0], "logits": logits[0]}]}
    return t0, t1, len(tokens[0])


def window(s, seconds: float) -> dict:
    mix = s.mix
    clips = traffic.clips(mix, s.seed, mix["max_requests"])
    latency, prompt_tokens = [], []
    setup_end = time.perf_counter()
    start = None
    for i, clip in enumerate(clips):
        t0, t1, n_tokens = _request(s, i, clip, keep=i in s.sample)
        start = t0 if start is None else start
        latency.append(t1 - t0)
        prompt_tokens.append(n_tokens)
        if t1 - start >= seconds:
            break
    else:
        raise RuntimeError(f"the window did not close: {len(clips)} requests ran out first")
    end = t1
    n = len(latency)
    if s.trace:
        s.annotate = True
        with trace.profiled(s.device) as s.slice:
            for j in range(mix["trace_requests"]):
                with torch.profiler.record_function("pb:request"):
                    _request(s, n + j, clips[n + j], keep=False)
    kws = s.cfg["kws"]
    maps = -(-kws["keywords"] // kws["chunk"]) * kws["chunk"]
    per_request = (flops.encoder_flops(s.cfg)
                   + maps * flops.resnet_conv_flops(kws["resnet"], kws["num_channels"], kws["features_size"])
                   + flops.cbw_sim_flops(kws, s.cfg["d_model"], s.cfg["max_source_positions"],
                                         kws["keyword_frames"][1], maps))
    return {"setup_end": setup_end, "window_s": end - start, "latency_s": latency, "attempted": n, "failed": 0,
            "flops": n * per_request, "prompt_tokens": prompt_tokens,
            "trace_requests": mix["trace_requests"] if s.trace else 0}


def check_items(s, out: dict) -> list:
    return [s.kept[i] for i in sorted(s.kept) if i < out["attempted"]]


def close(s) -> None:
    s.cb = None
