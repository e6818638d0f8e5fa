"""Whole runs of every cell at tiny widths on the CPU: the harness's path
past its look for a card.  A sound run agrees with the plain reference;
the control (the reference in the precision below the configuration's)
reads higher than the program; and with the timed path broken underneath,
``correct`` comes out false, once for each fault the cell can have."""

import time

import numpy as np
import pytest

from perfbench import harness

import tiny

CELLS = ["cbw-whisper-medium.serve16", "cbw-whisper-medium.spot", "kws-lef.cascade-100k", "kws-lef.exact-1k"]


def run(cell, **mix):
    env = tiny.env(cell)
    env.mix.update(mix)
    return harness.run_cell(harness.load_benchmark(), env, 1.5, time.perf_counter())["result"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result = run(cell)
    assert result["correct"], result["compared"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "compared"
    names = {m["name"] for m in harness.cell_metrics(harness.load_benchmark(), cell, per_layer=False)}
    assert set(result["metrics"]) == names


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_above_the_program(cell):
    env = tiny.env(cell)
    driver = harness.load_plugin("drivers", env.mix["driver"])
    check = harness.load_plugin("checks", env.mix["check"])
    state = driver.setup(env)
    out = driver.window(state, 1.0)
    items = driver.check_items(state, out)
    driver.close(state)
    program = check.readings(env, items)
    control = check.readings(env, items, control=env.mix["control"])
    assert set(program) == set(control) == set(env.mix["limits"])
    assert any(control[k] > 3 * program[k] for k in program), (program, control)


def test_traced_run_reads_its_per_layer_metrics():
    env = tiny.env("cbw-whisper-medium.serve16", trace=True)
    result = harness.run_cell(harness.load_benchmark(), env, 1.5, time.perf_counter())["result"]
    # on the CPU the trace has no device time: device metrics stay out
    assert {"segment_latency_p50_s", "step_ms.serve", "spot_share_pct.serve"} <= set(result["metrics"])
    assert "breakdown" in result and result["device"]["window_s"] > 0


# -------------------------------------------------------------------- faults


def _altered_token(monkeypatch):
    from enhance_cb_whisper_tpu_torch.decoding.generate import WhisperGenerator

    real = WhisperGenerator._decode_prompted

    def decode(self, cross_kv, ids, *args, **kwargs):
        seqs, scores, no_speech = real(self, cross_kv, ids, *args, **kwargs)
        seqs = seqs.copy()
        seqs[:, ids.shape[1] + 3] = 1000 + (seqs[:, ids.shape[1] + 3] % 1000)
        return seqs, scores, no_speech

    monkeypatch.setattr(WhisperGenerator, "_decode_prompted", decode)


def _half_batch_encoded(monkeypatch):
    from enhance_cb_whisper_tpu_torch.models import cb_whisper

    real = cb_whisper.encoder_kws_stack

    def stack(params, feats, *args, **kwargs):
        half = -(-feats.shape[0] // 2)
        out = real(params, feats[:half], *args, **kwargs)
        rows = np.arange(feats.shape[0]) % half
        return tuple(o[rows] for o in out) if isinstance(out, tuple) else out[rows]

    monkeypatch.setattr(cb_whisper, "encoder_kws_stack", stack)


def _step_keeps_state(monkeypatch):
    from enhance_cb_whisper_tpu_torch.decoding.generate import WhisperGenerator

    real = WhisperGenerator._decode_step

    def step(self, tokens, cache, ctx):
        index = cache["index"]
        logits, cache = real(self, tokens, cache, ctx)
        cache["index"] = index
        return logits, cache

    monkeypatch.setattr(WhisperGenerator, "_decode_step", step)


def _scorer(monkeypatch, alter):
    from enhance_cb_whisper_tpu_torch.models import cb_whisper

    real = cb_whisper.make_catalog_score_fn

    def make(*args, **kwargs):
        score = real(*args, **kwargs)

        def broken(catalog_dev, stack, utt_w):
            probs, logits = score(catalog_dev, stack, utt_w)
            return probs, alter(logits.clone())

        return broken

    monkeypatch.setattr(cb_whisper, "make_catalog_score_fn", make)


def _altered_logit(logits):
    logits[3, 1] += 1.0
    return logits


def _half_keywords_scored(logits):
    half = logits.shape[0] // 2
    logits[half:] = logits[: logits.shape[0] - half]
    return logits


def _probs(monkeypatch, alter):
    from enhance_cb_whisper_tpu_torch.efficient_kws import catalog

    real = catalog._chunked_probs

    def chunked(chunk_logits, kwd, kwd_mask, chunk):
        return alter(real, chunk_logits, kwd, kwd_mask, chunk)

    monkeypatch.setattr(catalog, "_chunked_probs", chunked)


def _altered_prob(real, *args):
    p = real(*args).clone()
    p[5] = 1.0 - p[5]
    return p


def _half_rows_scored(real, chunk_logits, kwd, kwd_mask, chunk):
    half = -(-kwd.shape[0] // 2)
    p = real(chunk_logits, kwd[:half], kwd_mask[:half], chunk)
    return p[np.arange(kwd.shape[0]) % half]


FAULTS = [
    ("cbw-whisper-medium.serve16", "token altered", lambda mp: _altered_token(mp)),
    ("cbw-whisper-medium.serve16", "half the batch left out", lambda mp: _half_batch_encoded(mp)),
    ("cbw-whisper-medium.serve16", "step returns its state unchanged", lambda mp: _step_keeps_state(mp)),
    ("cbw-whisper-medium.spot", "answer altered", lambda mp: _scorer(mp, _altered_logit)),
    ("cbw-whisper-medium.spot", "half the batch left out", lambda mp: _scorer(mp, _half_keywords_scored)),
    ("kws-lef.cascade-100k", "answer altered", lambda mp: _probs(mp, _altered_prob)),
    ("kws-lef.cascade-100k", "half the batch left out", lambda mp: _probs(mp, _half_rows_scored)),
    ("kws-lef.exact-1k", "answer altered", lambda mp: _probs(mp, _altered_prob)),
    ("kws-lef.exact-1k", "half the batch left out", lambda mp: _probs(mp, _half_rows_scored)),
]


@pytest.mark.parametrize("cell,fault,plant", FAULTS, ids=[f"{c}-{f}" for c, f, _ in FAULTS])
def test_broken_timed_path_is_not_correct(cell, fault, plant, monkeypatch):
    plant(monkeypatch)
    # judge every request the window drew from, so the broken rows are among them
    result = run(cell, check_requests=4, check_requests_min=4) if cell.endswith("serve16") else run(cell)
    assert not result["correct"], (fault, result["compared"])
