"""Closed-loop load on the port's live service, ``TranscriptionService``.

One load-generator thread (the caller's) keeps ``outstanding`` segments in
the service: each returned result sends the next segment, whose features
it makes with ``prepare_features`` (kernel K1) just before submitting it.
The service decodes ``slots`` segments per launch of the packed
scheduler, on its own worker thread.  The load thread takes results in
the order they complete: a segment whose decode leaves its window early
takes a second launch, and waiting on the oldest ticket would hold back
the submissions behind it and leave slots empty.

The window opens at the end of the first launch (its results are the
burst; set-up, the first launch included, ends there) and closes at the
first launch end at or after ``--seconds`` later.  The metrics count the
segments whose launches ended inside (open, close].  Wrappers on the
generator (the ``_recorded_windows`` wrappers of chip_smoke.py:1511)
record each launch's rows and end, count decode steps, and keep, for the
segments drawn for the check, what the program produced.  With ``--trace
1`` they also time the spotter and the decode (synchronising), and the
launch after the window runs under the profiler.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from .. import flops, trace, traffic
from ..systems import cbw as system

RESULT_TIMEOUT = 600.0  # seconds a segment may take before the run fails
POLL_S = 0.05  # the longest a completed result waits for the load thread


class State:
    pass


def _annotate(state, name):
    """A ``pb:`` span in the profiled launch, nothing elsewhere."""
    return torch.profiler.record_function(name) if state.annotate else contextlib.nullcontext()


def _install(state) -> None:
    """Wrap the generator's window, decode and step, and the spotter's
    hook and scorer, as instance attributes (the service calls them)."""
    cb, gen = state.cb, state.cb.generator
    run_window, decode_prompted = gen._run_longform_window, gen._decode_prompted
    with_fallback, decode_step = gen._generate_with_fallback, gen._decode_step
    encode_and_spot, score_fn = cb.encode_and_spot, cb._score_fn
    cfg = state.cfg
    sync = state.device.type == "cuda"

    def window(rows, *args, **kwargs):
        rec = {"orders": [None if r is None else r.order for r in rows],
               "seek": [0 if r is None else r.seek for r in rows],
               "frames": [0 if r is None else min(r.max_frames - r.seek, gen.n_segment_frames) for r in rows],
               "steps": 0, "step_flops": 0, "decode_s": 0.0, "spot_s": 0.0, "plen": 0,
               "t_start": time.perf_counter()}
        state.launches.append(rec)
        state.spot_calls = 0
        profile = state.trace and state.t_close is not None and state.slice is None
        if profile:
            state.annotate = True
            with trace.profiled(state.device) as state.slice:
                with _annotate(state, "pb:launch"):
                    out = run_window(rows, *args, **kwargs)
            state.annotate = False
        else:
            out = run_window(rows, *args, **kwargs)
        rec["t_end"] = time.perf_counter()
        rec["done"] = [r.order for r in rows if r is not None and r.done]
        if state.t_open is None:
            state.t_open = rec["t_end"]
        elif state.t_close is None and rec["t_end"] >= state.t_open + state.seconds:
            state.t_close = rec["t_end"]
        return out

    def spot(input_features, start_of_prev=False, real_rows=None):
        rec = state.launches[-1]
        if state.trace and sync:
            torch.cuda.synchronize(state.device)
        kept = {j: {"seek": rec["seek"][j], "frames": rec["frames"][j]}
                for j, order in enumerate(rec["orders"]) if order in state.sample}
        for j, win in kept.items():
            state.kept[rec["orders"][j]].setdefault("windows", []).append(win)
        t0 = time.perf_counter()
        with _annotate(state, "pb:encode_and_spot"):
            tokens, enc = encode_and_spot(input_features, start_of_prev=start_of_prev, real_rows=real_rows)
        if state.trace and sync:
            torch.cuda.synchronize(state.device)
        rec["spot_s"] += time.perf_counter() - t0
        for j, win in kept.items():
            win["enc"] = enc[j].clone()
        return tokens, enc

    def scorer(catalog_dev, stack, utt_w):
        rec = state.launches[-1]
        probs, logits = score_fn(catalog_dev, stack, utt_w)
        order = rec["orders"][state.spot_calls]
        state.spot_calls += 1
        if order in state.sample:
            state.kept[order]["windows"][-1]["logits"] = logits
        return probs, logits

    def decode(cross_kv, ids, attn, opts, *args, **kwargs):
        seqs, scores, no_speech = decode_prompted(cross_kv, ids, attn, opts, *args, **kwargs)
        rec = state.launches[-1]
        rec["plen"] = int(ids.shape[1])
        for j, order in enumerate(rec["orders"]):
            if order in state.sample:
                state.kept[order]["windows"][-1].update(
                    prompt=np.asarray(ids[j]), prompt_mask=np.asarray(attn[j]), sequence=seqs[j], score=scores[j])
        return seqs, scores, no_speech

    def fallback(*args, **kwargs):
        rec = state.launches[-1]
        if state.trace and sync:
            torch.cuda.synchronize(state.device)
        t0 = time.perf_counter()
        with _annotate(state, "pb:decode"):
            out = with_fallback(*args, **kwargs)  # host arrays: the decode has finished
        rec["decode_s"] += time.perf_counter() - t0
        return out

    def step(tokens, cache, ctx):
        rec = state.launches[-1]
        rec["steps"] += 1
        rec["step_flops"] += int(tokens.shape[0]) * flops.decoder_token_flops(cfg, int(cache["index"]) + 1)
        with _annotate(state, "pb:decode_step"):
            return decode_step(tokens, cache, ctx)

    gen._run_longform_window, gen._decode_prompted = window, decode
    gen._generate_with_fallback, gen._decode_step = fallback, step
    cb.encode_and_spot, cb._score_fn = spot, scorer


def setup(env):
    from enhance_cb_whisper_tpu_torch.runtime.serving import TranscriptionService

    s = State()
    s.cfg, s.mix, s.seed, s.device, s.trace = env.config, env.mix, env.seed, env.device, env.trace
    s.cb = system.build(env.config, env.device)
    s.launches, s.t_open, s.t_close, s.slice, s.annotate, s.spot_calls = [], None, None, None, False, 0
    # segments the check judges: drawn from those the window's first
    # launches decode (tickets of launches 2 to 1 + check_launches)
    slots, mix = env.mix["slots"], env.mix
    lo = slots * 1
    pool = np.arange(lo, lo + slots * mix["check_launches"])
    rng = np.random.default_rng([int(env.seed) & (2**64 - 1), 41])
    s.sample = set(int(x) for x in rng.choice(pool, size=mix["check_requests"], replace=False))
    s.kept = {i: {} for i in s.sample}
    _install(s)
    s.service = TranscriptionService(s.cb, slots=slots)
    return s


def _features(s, index: int, clip: int):
    from enhance_cb_whisper_tpu_torch.audio.io import prepare_features

    t0 = time.perf_counter()
    feats, mask = prepare_features(traffic.audio(s.mix, clip), n_mels=s.cfg["num_mel_bins"], device=s.device)
    if index in s.sample:
        s.kept[index].update(clip=clip, features=feats[0])
    s.make_s.append(time.perf_counter() - t0)
    return feats, mask


def window(s, seconds: float) -> dict:
    s.seconds, s.make_s = seconds, []
    mix = s.mix
    clips = traffic.clips(mix, s.seed, mix["max_requests"])
    submitted, arrived, pending = {}, {}, {}
    # the first launch must be full: its segments are all made before the
    # first is submitted
    first = [_features(s, i, clips[i]) for i in range(mix["outstanding"])]
    for i, (feats, mask) in enumerate(first):
        submitted[i] = time.perf_counter()
        pending[s.service.submit(feats, mask)] = time.perf_counter() + RESULT_TIMEOUT
    next_index = len(first)
    failed = 0
    while pending:
        done = [t for t in pending if _ready(s.service, t, 0.0)]
        if not done:
            oldest = next(iter(pending))
            if _ready(s.service, oldest, POLL_S):
                done = [oldest]
            elif time.perf_counter() > pending[oldest]:
                failed += 1
                done = [oldest]
        for ticket in done:
            del pending[ticket]
            arrived[ticket] = time.perf_counter()
            if s.t_close is None and next_index < len(clips):
                feats, mask = _features(s, next_index, clips[next_index])
                submitted[next_index] = time.perf_counter()
                pending[s.service.submit(feats, mask)] = time.perf_counter() + RESULT_TIMEOUT
                next_index += 1
    s.service.close()
    if s.t_close is None:
        raise RuntimeError(f"the window did not close: {len(clips)} segments ran out first")
    inside = [rec for rec in s.launches if s.t_open < rec["t_end"] <= s.t_close]
    done = [o for rec in inside for o in rec["done"]]
    return {
        "setup_end": s.t_open, "window_s": s.t_close - s.t_open,
        "audio_s": sum(traffic.seconds(mix, clips[o]) for o in done),
        "latency_s": [arrived[o] - submitted[o] for o in done],
        "launches": inside, "attempted": len(done), "failed": failed,
        "slots": mix["slots"], "steps": [rec["steps"] for rec in inside],
        "occupied": [sum(o is not None for o in rec["orders"]) for rec in s.launches],
        "flops": sum(_launch_flops(s.cfg, rec) for rec in inside),
        "spot_s": sum(rec["spot_s"] for rec in inside), "decode_s": sum(rec["decode_s"] for rec in inside),
        "features_ms": [round(1e3 * float(q), 3) for q in np.percentile(s.make_s, [50, 95, 100])],
        "launch_s": [round(rec["t_end"] - rec["t_start"], 3) for rec in inside],
    }


def _ready(service, ticket: int, timeout: float) -> bool:
    """Whether ``ticket``'s result came within ``timeout`` (taken if so)."""
    try:
        service.result(ticket, timeout=timeout)
        return True
    except TimeoutError:
        return False


def _launch_flops(cfg: dict, rec: dict) -> int:
    """Model FLOPs of one launch: per row the encoder, its cross K/V, the
    spotter over the padded catalog and the beam prefill; the decode
    steps as counted."""
    kws = cfg["kws"]
    rows = len(rec["orders"])
    maps = -(-kws["keywords"] // kws["chunk"]) * kws["chunk"]
    spot = maps * flops.resnet_conv_flops(kws["resnet"], kws["num_channels"], kws["features_size"]) + \
        flops.cbw_sim_flops(kws, cfg["d_model"], cfg["max_source_positions"], kws["keyword_frames"][1], maps)
    beams = cfg["generation"]["num_beams"]
    per_row = flops.encoder_flops(cfg) + flops.cross_kv_flops(cfg) + spot + \
        flops.prefill_flops(cfg, beams, rec["plen"])
    return rows * per_row + rec["step_flops"]


def check_items(s, out: dict) -> list:
    done = {o for rec in out["launches"] for o in rec["done"]}
    return [s.kept[i] for i in sorted(s.sample) if i in done and s.kept[i].get("windows")]


def close(s) -> None:
    s.service.close()
    s.cb = s.service = None
