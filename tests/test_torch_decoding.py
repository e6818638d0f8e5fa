"""Port decoding vs the JAX package: logits processors, the top-k contract,
and greedy / beam-5 search over a tiny random Whisper (one numpy seed,
converted weights) — token-exact sequences and scores within 1e-4, over
several seeds, with a batch whose prompts carry padding inside.  The
decode's step spans, and that recording them changes no output."""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhance_cb_whisper_tpu.decoding import logits_process as jlp
from enhance_cb_whisper_tpu.decoding.generate import GenerationOptions as JaxOptions
from enhance_cb_whisper_tpu.decoding.generate import WhisperGenerator as JaxGenerator
from enhance_cb_whisper_tpu.decoding.prompt import prepare_decoder_input_ids
from enhance_cb_whisper_tpu.models import whisper as jw
from enhance_cb_whisper_tpu_torch.convert import from_jax_whisper_params
from enhance_cb_whisper_tpu_torch.decoding import logits_process as tlp
from enhance_cb_whisper_tpu_torch.decoding.generate import GenerationOptions, WhisperGenerator
from enhance_cb_whisper_tpu_torch.decoding.topk import exact_top_k
from enhance_cb_whisper_tpu_torch.models import whisper as tw
from enhance_cb_whisper_tpu_torch.runtime import profiler

VOCAB, NO_TS = 128, 100  # timestamps are ids 101..127
CFG = dict(
    vocab_size=VOCAB, num_mel_bins=80, d_model=64,
    encoder_layers=2, encoder_attention_heads=4,
    decoder_layers=2, decoder_attention_heads=4,
    encoder_ffn_dim=128, decoder_ffn_dim=128,
    max_source_positions=1500, max_target_positions=40,
    decoder_start_token_id=3, eos_token_id=2, pad_token_id=0,
)
OPTS = dict(
    decoder_start_token_id=3, language_token_id=10, task_token_id=11,
    no_timestamps_token_id=NO_TS, prev_sot_token_id=99, eos_token_id=2, pad_token_id=0,
    max_initial_timestamp_index=10, max_target_positions=40,
    suppress_tokens=(5, 6), begin_suppress_tokens=(2, 7),
)


@pytest.mark.parametrize("timestamps", [True, False])
def test_logits_processors_match_jax(timestamps):
    rng = np.random.default_rng(0)
    cfg = dict(suppress_tokens=(5, 6), begin_suppress_tokens=(2, 7), no_timestamps_token_id=NO_TS,
               max_initial_timestamp_index=10, return_timestamps=timestamps, eos_token_id=2,
               vocab_size=VOCAB)
    jcfg, tcfg = jlp.LogitsProcessorConfig(**cfg), tlp.LogitsProcessorConfig(**cfg)
    begin, length = 4, 16
    for cur_len in range(begin, 12):
        # histories mixing text and timestamp tokens: pairs, singles, none
        tokens = rng.integers(3, 99, (6, length))
        ts = rng.random((6, length)) < 0.4
        tokens = np.where(ts, rng.integers(101, VOCAB, (6, length)), tokens).astype(np.int64)
        # strongly peaked rows make the "timestamp mass wins" rule fire
        logits = rng.standard_normal((6, VOCAB)).astype(np.float32) * np.array(
            [1, 1, 4, 4, 8, 8], np.float32)[:, None]
        want = np.asarray(jlp.apply_logits_processors(jcfg, logits, tokens.astype(np.int32), cur_len, begin))
        got = tlp.apply_logits_processors(tcfg, torch.from_numpy(logits), torch.from_numpy(tokens),
                                          cur_len, begin).numpy()
        np.testing.assert_array_equal(got == tlp.NEG_INF, want == jlp.NEG_INF)
        np.testing.assert_allclose(got, want, rtol=0, atol=0)


def test_top_k_contract_matches_lax():
    x = np.array(
        [
            [0.5, 2.0, 2.0, -1.0, 2.0, 0.5, 0.1, 0.5],
            [-np.inf] * 8,  # all -inf: indices must still be distinct
            [np.float32(jlp.NEG_INF)] * 4 + [1.0, -np.inf, 1.0, 3.0],
        ],
        np.float32,
    )
    for k in (1, 3, 5, 8):
        want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
        got_v, got_i = exact_top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        assert all(len(set(row)) == k for row in got_i.tolist())


@pytest.fixture(scope="module")
def generators():
    jcfg, tcfg = jw.WhisperConfig(**CFG), tw.WhisperConfig(**CFG)
    params = jw.init_whisper_params(np.random.default_rng(0), jcfg)
    return jcfg, tcfg, JaxGenerator(jcfg, params), WhisperGenerator(tcfg, from_jax_whisper_params(params, device="cpu"), device="cpu")


@pytest.mark.parametrize("num_beams", [1, 5], ids=["greedy", "beam5"])
def test_search_token_exact_over_seeds(generators, num_beams):
    jcfg, tcfg, jgen, tgen = generators
    jopts = JaxOptions(**OPTS, num_beams=num_beams, return_timestamps=True)
    topts = GenerationOptions(**OPTS, num_beams=num_beams, return_timestamps=True)
    # two rows with keyword prompts of different lengths -> left padding
    # inside the prompt, masked by the attention mask
    ids, attn = prepare_decoder_input_ids(
        init_tokens=jopts.init_tokens(), keywords_tokens=[[99, 20, 21, 22, 23], [99, 30]],
        prev_tokens_per_batch=None, condition_on_prev=False, max_target_positions=40,
        pad_token_id=0, prev_sot_token_id=99,
    )
    assert (attn == 0).any()
    # seed 3 boosts the eos embedding row so hypotheses finish mid-decode
    # (eos retirement, finished-vs-running competition, early stop)
    for seed, eos_scale in ((1, 1.0), (2, 1.0), (3, 5.0)):
        params = jw.init_whisper_params(np.random.default_rng(seed), jcfg)
        params["decoder"]["embed_tokens"]["weight"][2] *= eos_scale
        jgen.swap_params(params)
        tgen.params = from_jax_whisper_params(params, device="cpu")
        mel = np.random.default_rng(10 + seed).standard_normal((2, 80, 3000)).astype(np.float32)
        j_xkv = jgen._cross_kv_fn(jgen._encode(jnp.asarray(mel)))
        t_xkv = tgen._cross_kv_fn(tgen._encode(torch.from_numpy(mel)))
        j_seqs, j_scores, _ = jgen._decode_prompted(j_xkv, ids, attn, jopts, return_timestamps=True)
        t_seqs, t_scores, _ = tgen._decode_prompted(t_xkv, ids, attn, topts, return_timestamps=True)
        np.testing.assert_array_equal(t_seqs, j_seqs)
        np.testing.assert_allclose(t_scores, j_scores, rtol=0, atol=1e-4)
        # the decode really ran past the prompt
        generated = t_seqs[:, ids.shape[1]:]
        assert (generated != 0).any()
        if eos_scale > 1.0:
            assert (generated == 2).any()


@pytest.mark.parametrize("language", ["given", "detected"])
def test_generate_shortform_matches_jax(generators, language):
    """The shortform entry point: a <30 s mel is padded to the segment,
    a spotting callback supplies the prompt, the prompt is stripped; the
    language token is given, or detected from the segment (HF
    detect_language: [sot] prefill, argmax over the language tokens).  A
    3001-frame mel decodes through the longform path, as in JAX."""
    jcfg, tcfg, jgen, tgen = generators
    params = jw.init_whisper_params(np.random.default_rng(4), jcfg)
    jgen.swap_params(params)
    tgen.params = from_jax_whisper_params(params, device="cpu")
    mel = np.random.default_rng(5).standard_normal((1, 80, 1234)).astype(np.float32)

    def spot(input_features, start_of_prev=False):
        assert input_features.shape[-1] == 3000
        return [[99, 40, 41]]

    lang = {} if language == "given" else dict(language_token_id=None, lang_token_ids=(10, 12, 13, 14))
    jopts = dataclasses.replace(JaxOptions(**OPTS), num_beams=5, return_timestamps=True, **lang)
    topts = dataclasses.replace(GenerationOptions(**OPTS), num_beams=5, return_timestamps=True, **lang)
    assert topts.needs_lang_detection == (language == "detected")
    want = jgen.generate(mel, jopts, keyword_spotting=spot)
    got = tgen.generate(torch.from_numpy(mel), topts, keyword_spotting=spot)
    np.testing.assert_array_equal(got, np.asarray(want))
    # one frame more than a segment takes the longform seek loop: greedy,
    # no prompt hook, and a decoder whose timestamp rows are damped and
    # whose eos row is boosted, so the first window's output ends early
    # and the seek moves past it (a plain random decoder closes a
    # timestamp pair every few tokens and crawls through the audio)
    params = jw.init_whisper_params(np.random.default_rng(0), jcfg)
    params["decoder"]["embed_tokens"]["weight"][NO_TS + 1:] *= 0.5
    params["decoder"]["embed_tokens"]["weight"][2] *= 3.0
    jgen.swap_params(params)
    tgen.params = from_jax_whisper_params(params, device="cpu")
    mel = np.random.default_rng(6).standard_normal((1, 80, 3001)).astype(np.float32)
    jopts, topts = (dataclasses.replace(o, num_beams=1) for o in (jopts, topts))
    want = jgen.generate(mel, jopts)
    got = tgen.generate(torch.from_numpy(mel), topts)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got.shape[0] == 1 and (got != 0).sum() > 0


@pytest.mark.parametrize("num_beams", [1, 5], ids=["greedy", "beam5"])
def test_decode_step_spans_and_recording_change_nothing(generators, num_beams, monkeypatch):
    """One ``ecw.decode.step`` span per step taken, each the parent of one
    ``ecw.decode.sync`` span inside it; tokens and scores are the same bits
    with recording on and off (eos boosted, so hypotheses finish)."""
    jcfg, _, _, tgen = generators
    params = jw.init_whisper_params(np.random.default_rng(3), jcfg)
    params["decoder"]["embed_tokens"]["weight"][2] *= 5.0
    tgen.params = from_jax_whisper_params(params, device="cpu")
    opts = GenerationOptions(**OPTS, num_beams=num_beams, return_timestamps=True)
    ids, attn = prepare_decoder_input_ids(
        init_tokens=opts.init_tokens(), keywords_tokens=[[99, 20, 21, 22, 23], [99, 30]],
        prev_tokens_per_batch=None, condition_on_prev=False, max_target_positions=40,
        pad_token_id=0, prev_sot_token_id=99,
    )
    mel = np.random.default_rng(13).standard_normal((2, 80, 3000)).astype(np.float32)
    xkv = tgen._cross_kv_fn(tgen._encode(torch.from_numpy(mel)))
    calls = []
    step = tgen._decode_step
    monkeypatch.setattr(tgen, "_decode_step", lambda *a: calls.append(1) or step(*a))

    t0 = time.perf_counter()
    seqs_on, scores_on, _ = tgen._decode_prompted(xkv, ids, attn, opts, return_timestamps=True)
    got = profiler.spans(since_s=t0)
    previous = profiler.set_recording(False)
    try:
        t1 = time.perf_counter()
        seqs_off, scores_off, _ = tgen._decode_prompted(xkv, ids, attn, opts, return_timestamps=True)
        assert profiler.spans(since_s=t1) == []
    finally:
        profiler.set_recording(previous)
    np.testing.assert_array_equal(seqs_on, seqs_off)
    np.testing.assert_array_equal(scores_on, scores_off)

    steps = {s["seq"]: s for s in got if s["name"] == "ecw.decode.step"}
    syncs = [s for s in got if s["name"] == "ecw.decode.sync"]
    assert 1 < len(steps) == len(calls) // 2 <= 40 - ids.shape[1]
    assert sorted(s["parent"] for s in syncs) == sorted(steps)
    for s in syncs:
        parent = steps[s["parent"]]
        assert parent["start_s"] <= s["start_s"] <= s["end_s"] <= parent["end_s"]
    # a beam step over the float cache reads it through the ancestry map in
    # every decoder layer and reorders nothing
    beam_attrs = {"reorder_bytes": 0, "anc_layers": CFG["decoder_layers"]} if num_beams > 1 else {}
    assert all(s["attrs"] == {"rows": 2 * num_beams, **beam_attrs} for s in steps.values())
