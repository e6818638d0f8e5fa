"""Transcripts of the port's weight levers vs the JAX package's, on the
CPU at the dims of ``test_torch_levers.py`` (same weights), on the JAX
package's own protocols (``tests/test_whisper_parity.py``): greedy longform
of a 150-frame mel with timestamps and condition-on-prev under the int8
vocab, and under the int8 vocab and decoder, and a beam-5 prompted decode
under the int8 decoder, each held token-exact to JAX (the codes are equal,
only fp32 rounding differs; beam scores to 1e-5).

bf16, alone and with the int8 vocab and decoder (the serving set):

* a prompted greedy decode with timestamps by JAX, teacher-forced through
  both packages in bf16: every logit within 0.02 x the logits' scale of
  JAX's (its own bf16 bound), and the same argmax at every position whose
  top-two margin exceeds twice that bound.  On random weights a near-tie
  can flip either package's bf16 greedy decode against its own fp32 one a
  few tokens in, so the decisions are held where bf16 can decide them;
* the seek loop without timestamps, by JAX's prefix rule for a lossy lever:
  no token differs before the 24th.

The JAX outputs are made once, in a module fixture (one prompt bucket)."""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhance_cb_whisper_tpu.decoding.generate import GenerationOptions as JaxOptions
from enhance_cb_whisper_tpu.decoding.generate import WhisperGenerator as JaxGenerator
from enhance_cb_whisper_tpu.models import whisper as jw
from enhance_cb_whisper_tpu.models.whisper import WhisperConfig as JaxWhisperConfig
from enhance_cb_whisper_tpu_torch.convert import from_jax_whisper_params
from enhance_cb_whisper_tpu_torch.decoding.generate import GenerationOptions, WhisperGenerator
from enhance_cb_whisper_tpu_torch.models import whisper as tw
from enhance_cb_whisper_tpu_torch.models.whisper import WhisperConfig
from test_torch_levers import BF16_SCALE, CFG, whisper_params

OPTS = dict(
    decoder_start_token_id=3, language_token_id=None, task_token_id=None,
    no_timestamps_token_id=100, prev_sot_token_id=99, eos_token_id=2, pad_token_id=0,
    max_initial_timestamp_index=10, max_target_positions=40,
    return_timestamps=True, condition_on_prev_tokens=True,
)
BF16_PREFIX = 24  # JAX's rule for a lossy lever: no differing token before this one


def _mel(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _levers(bf16=False, **flags):
    """(JAX generator kwargs, port generator kwargs)."""
    return ({**flags, **({"dtype": jnp.bfloat16} if bf16 else {})},
            {**flags, **({"dtype": torch.bfloat16} if bf16 else {})})


# name -> (levers, call, mel shape, mel seed, option overrides)
#   call "generate": the seek loop's sequences; "prompted": _decode_prompted
#   of [3, 9, 5, 7] to 24 positions (sequences and scores)
CASES = {
    "vocab_int8_greedy": (_levers(vocab_int8=True), "generate", (1, 8, 150), 3, dict(num_beams=1)),
    "vocab_decoder_int8_greedy": (_levers(vocab_int8=True, decoder_int8=True), "generate", (1, 8, 150), 3,
                                  dict(num_beams=1)),
    "decoder_int8_beam5": (_levers(decoder_int8=True), "prompted", (2, 8, 48), 0,
                           dict(num_beams=5, max_target_positions=24)),
    "bf16_no_timestamps": (_levers(bf16=True), "generate", (1, 8, 150), 3,
                           dict(num_beams=1, return_timestamps=False)),
    "bf16_serving_no_timestamps": (_levers(bf16=True, vocab_int8=True, decoder_int8=True), "generate",
                                   (2, 8, 130), 1, dict(num_beams=3, return_timestamps=False)),
}
BF16_LEVERS = {"bf16": _levers(bf16=True), "bf16_serving": _levers(bf16=True, vocab_int8=True, decoder_int8=True)}
PROMPT = [3, 9, 5, 7]


def _run(gen, call, mel, opts, as_input, return_timestamps=False):
    if call == "generate":
        return np.asarray(gen.generate(as_input(mel), opts))
    with torch.no_grad():
        cross_kv = gen._cross_kv_fn(gen._encode(as_input(mel)))
    seqs, scores, _ = gen._decode_prompted(cross_kv, np.asarray([PROMPT] * mel.shape[0], np.int64), None,
                                           dataclasses.replace(opts, return_timestamps=return_timestamps),
                                           return_timestamps=return_timestamps)
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


def _jax_generator(params, kwargs):
    return JaxGenerator(JaxWhisperConfig(**CFG), params, prompt_buckets=(CFG["max_target_positions"],), **kwargs)


@pytest.fixture(scope="module")
def jax_run(params):
    out = {}
    for name, ((jax_kwargs, _), call, shape, seed, overrides) in CASES.items():
        out[name] = _run(_jax_generator(params, jax_kwargs), call, _mel(shape, seed),
                         JaxOptions(**{**OPTS, **overrides}), jnp.asarray)
    mel = _mel((1, 8, 48), 4)
    for name, (jax_kwargs, _) in BF16_LEVERS.items():
        # JAX's bf16 prompted greedy decode with timestamps, and its logits
        # teacher-forced along that sequence
        gen = _jax_generator(params, jax_kwargs)
        seqs, _ = _run(gen, "prompted", mel, JaxOptions(**{**OPTS, "num_beams": 1}), jnp.asarray,
                       return_timestamps=True)
        forced = jax.jit(partial(jw.decoder_forward, config=JaxWhisperConfig(**CFG), dtype=jnp.bfloat16))
        logits, _ = forced(gen.params, jnp.asarray(seqs[:, :-1]), gen._cross_kv_fn(gen._encode(jnp.asarray(mel))))
        out[name] = (seqs, np.asarray(logits))
    return out


def _prefix(a, b):
    a, b = list(a), list(b)
    return next((i for i in range(min(len(a), len(b))) if a[i] != b[i]), min(len(a), len(b)))


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
        assert (got[0][:, len(PROMPT):] != OPTS["pad_token_id"]).any()
        return
    if "dtype" in port_kwargs:
        assert got.shape[0] == want.shape[0]
        for g, w in zip(got, want):
            assert _prefix(g, w) >= min(BF16_PREFIX, len(w)), (g, w)
    else:
        np.testing.assert_array_equal(got, want)
    assert (got != OPTS["pad_token_id"]).sum(axis=1).min() > 8  # every row decoded something


@pytest.mark.parametrize("lever", list(BF16_LEVERS))
def test_bf16_logits_along_jax_transcript(jax_run, params, lever):
    seqs, want = jax_run[lever]
    gen = WhisperGenerator(WhisperConfig(**CFG), from_jax_whisper_params(params, device="cpu"), device="cpu",
                           **BF16_LEVERS[lever][1])
    with torch.no_grad():
        cross_kv = gen._cross_kv_fn(gen._encode(torch.from_numpy(_mel((1, 8, 48), 4))))
        got, _ = tw.decoder_forward(gen.params, torch.tensor(seqs[:, :-1]), cross_kv, WhisperConfig(**CFG),
                                    dtype=torch.bfloat16)
    got = got.numpy()
    generated = slice(len(PROMPT) - 1, int((seqs[0] != OPTS["pad_token_id"]).sum()) - 1)
    got, want = got[0, generated], want[0, generated]
    assert len(want) > 8
    bound = BF16_SCALE * np.abs(want).max()
    assert np.abs(got - want).max() < bound, (np.abs(got - want).max(), bound)
    top2 = np.sort(want, axis=-1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > 2 * bound
    assert decided.sum() > len(want) // 2
    np.testing.assert_array_equal(got.argmax(-1)[decided], want.argmax(-1)[decided])
