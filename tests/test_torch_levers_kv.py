"""Transcripts of the port's int8 K/V levers vs the JAX package's, on the
CPU at the dims of ``test_torch_levers.py`` (same weights), on the JAX
package's own protocols (``tests/test_kv_cache_int8.py``,
``tests/test_cross_kv_int8.py``): the longform seek loop over a batch of two
130-frame mels with timestamps and condition-on-prev, greedy and beam-3 (the
beams reorder the cache's scales), and the short prompted decode with both
levers on; then the fallback ladder with every rung tripping (it takes rows
out of the int8 cross K/V) and language detection (a one-token prefill into
an int8 cache).

Held token-exact to JAX, the prompted scores to 1e-5: the codes are equal
and only fp32 rounding differs.  The JAX outputs are made once, in a
module fixture (one prompt bucket, so one program family per case)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhance_cb_whisper_tpu.decoding.generate import GenerationOptions as JaxOptions
from enhance_cb_whisper_tpu.decoding.generate import WhisperGenerator as JaxGenerator
from enhance_cb_whisper_tpu.models.whisper import WhisperConfig as JaxWhisperConfig
from enhance_cb_whisper_tpu_torch.convert import from_jax_whisper_params
from enhance_cb_whisper_tpu_torch.decoding.generate import GenerationOptions, WhisperGenerator
from enhance_cb_whisper_tpu_torch.models.whisper import WhisperConfig
from test_torch_levers import CFG, whisper_params

OPTS = dict(
    decoder_start_token_id=3, language_token_id=None, task_token_id=None,
    no_timestamps_token_id=100, prev_sot_token_id=99, eos_token_id=2, pad_token_id=0,
    max_initial_timestamp_index=10, max_target_positions=40,
    return_timestamps=True, condition_on_prev_tokens=True,
)
LANGS = tuple(range(4, 99, 3))


def _mel(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _levers(**flags):
    """(JAX generator kwargs, port generator kwargs)."""
    return flags, flags


# name -> (levers, call, mel shape, mel seed, option overrides)
#   call "generate": the seek loop's sequences; "prompted": _decode_prompted
#   of [3, 9, 5, 7] to 24 positions (sequences and scores); "detect":
#   detect_language
CASES = {
    "kv_cache_int8_greedy": (_levers(kv_cache_int8=True), "generate", (2, 8, 130), 1, dict(num_beams=1)),
    "kv_cache_int8_beam3": (_levers(kv_cache_int8=True), "generate", (2, 8, 130), 1, dict(num_beams=3)),
    "cross_kv_int8_greedy": (_levers(cross_kv_int8=True), "generate", (2, 8, 130), 1, dict(num_beams=1)),
    "cross_kv_int8_beam3": (_levers(cross_kv_int8=True), "generate", (2, 8, 130), 1, dict(num_beams=3)),
    "both_kv_int8_prompted": (_levers(kv_cache_int8=True, cross_kv_int8=True), "prompted", (1, 8, 48), 4,
                              dict(num_beams=1, max_target_positions=24)),
    # every rung trips: the second rung decodes the rows it takes out of
    # the int8 cross K/V (codes and scales) again
    "ladder_both_kv_int8": (_levers(kv_cache_int8=True, cross_kv_int8=True), "generate", (3, 8, 130), 6,
                            dict(num_beams=1, logprob_threshold=0.0, temperature=(0.0, 0.0))),
    "detect_language_both_kv_int8": (_levers(kv_cache_int8=True, cross_kv_int8=True), "detect", (3, 8, 90), 7,
                                     dict(lang_token_ids=LANGS)),
}


def _run(gen, call, mel, opts, as_input):
    if call == "generate":
        return np.asarray(gen.generate(as_input(mel), opts))
    if call == "detect":
        return np.asarray(gen.detect_language(as_input(mel), opts))
    with torch.no_grad():
        cross_kv = gen._cross_kv_fn(gen._encode(as_input(mel)))
    seqs, scores, _ = gen._decode_prompted(cross_kv, np.asarray([[3, 9, 5, 7]] * mel.shape[0], np.int64), None,
                                           dataclasses.replace(opts, return_timestamps=False),
                                           return_timestamps=False)
    return np.asarray(seqs), np.asarray(scores)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def params():
    return whisper_params()


@pytest.fixture(scope="module")
def jax_run(params):
    out = {}
    for name, ((jax_kwargs, _), call, shape, seed, overrides) in CASES.items():
        gen = JaxGenerator(JaxWhisperConfig(**CFG), params, prompt_buckets=(CFG["max_target_positions"],), **jax_kwargs)
        out[name] = _run(gen, call, _mel(shape, seed), JaxOptions(**{**OPTS, **overrides}), jnp.asarray)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_lever_transcripts_match_jax(jax_run, params, case):
    (_, port_kwargs), call, shape, seed, overrides = CASES[case]
    gen = WhisperGenerator(WhisperConfig(**CFG), from_jax_whisper_params(params, device="cpu"), device="cpu",
                           **port_kwargs)
    got = _run(gen, call, _mel(shape, seed), GenerationOptions(**{**OPTS, **overrides}), torch.from_numpy)
    want = jax_run[case]
    if call == "prompted":
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)
        assert (got[0][:, 4:] != OPTS["pad_token_id"]).any()
    else:
        np.testing.assert_array_equal(got, want)
    if call == "generate":
        assert (got != OPTS["pad_token_id"]).sum(axis=1).min() > 8  # every row decoded something
