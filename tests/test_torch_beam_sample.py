"""The port's beam-sample (``num_beams > 1`` at a temperature above 0) vs
the JAX package's, on a tiny random Whisper (one numpy seed, converted
weights), on ``tests/test_beam_sample.py``'s protocol.

JAX's own Gumbel draws (``jax.random.gumbel(fold_in(rng, cur_len), [B, K,
V])``, ``decoding/beam.py``) are injected into the port's noise source, so
a sampled search is held token-exact to JAX, and its normalized scores to
1e-5; at a near-zero temperature beam-sample is beam search on both sides;
the fallback ladder still samples with ``num_beams=1``, and the
``logprob_threshold`` gate applies to beam scores."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhance_cb_whisper_tpu.decoding.generate import GenerationOptions as JaxOptions
from enhance_cb_whisper_tpu.decoding.generate import WhisperGenerator as JaxGenerator
from enhance_cb_whisper_tpu.models import whisper as jw
from enhance_cb_whisper_tpu_torch.convert import from_jax_whisper_params
from enhance_cb_whisper_tpu_torch.decoding.generate import (
    GenerationOptions,
    WhisperGenerator,
    cpu_gumbel_noise,
)
from enhance_cb_whisper_tpu_torch.models import whisper as tw

CFG = dict(
    vocab_size=64, num_mel_bins=8, d_model=32,
    encoder_layers=2, encoder_attention_heads=4,
    decoder_layers=2, decoder_attention_heads=4,
    encoder_ffn_dim=64, decoder_ffn_dim=64,
    max_source_positions=24, max_target_positions=40,
)
OPTS = dict(
    decoder_start_token_id=3, language_token_id=None, task_token_id=None,
    no_timestamps_token_id=50, prev_sot_token_id=None, eos_token_id=2,
    pad_token_id=0, suppress_tokens=(), begin_suppress_tokens=(),
    max_target_positions=40,
)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def generators():
    params = jw.init_whisper_params(np.random.default_rng(0), jw.WhisperConfig(**CFG))
    jgen = JaxGenerator(jw.WhisperConfig(**CFG), params, prompt_buckets=(8, 16, 32))
    tgen = WhisperGenerator(tw.WhisperConfig(**CFG), from_jax_whisper_params(params, device="cpu"),
                            device="cpu")
    mel = np.random.default_rng(1).standard_normal((2, 8, 48)).astype(np.float32)
    j_xkv = jgen._cross_kv_fn(jgen._encode(jnp.asarray(mel)))
    t_xkv = tgen._cross_kv_fn(tgen._encode(torch.from_numpy(mel)))
    return jgen, j_xkv, tgen, t_xkv


def jax_noise(key):
    """The JAX beam search's draws at each step, for the port's source."""
    def noise(cur_len, shape):
        draws = jax.random.gumbel(jax.random.fold_in(key, cur_len), shape, jnp.float32)
        return torch.from_numpy(np.array(draws))
    return noise


def _rows(xkv, rows, port):
    return WhisperGenerator._take_rows(xkv, rows) if port else JaxGenerator._take_rows(xkv, rows)


@pytest.mark.parametrize("seed", [7, 8])
def test_beam_sample_with_jax_draws_is_token_exact(generators, seed):
    """T = 0.7, 4 beams, two rows: JAX's sequences and normalized scores;
    the draws change the tokens (not the deterministic search's)."""
    jgen, j_xkv, tgen, t_xkv = generators
    prompt = np.asarray([[3, 4, 9], [3, 5, 6]], np.int64)
    opts = dict(OPTS, num_beams=4, max_target_positions=24)
    key = jax.random.PRNGKey(seed)
    j_seqs, j_scores, _ = jgen._decode_prompted(j_xkv, prompt, None, JaxOptions(**opts), False,
                                                temperature=0.7, rng=key)
    t_seqs, t_scores, _ = tgen._decode_prompted(t_xkv, prompt, None, GenerationOptions(**opts), False,
                                                temperature=0.7, noise=jax_noise(key))
    np.testing.assert_array_equal(t_seqs, np.asarray(j_seqs))
    np.testing.assert_allclose(t_scores, np.asarray(j_scores), rtol=0, atol=1e-5)
    det, _, _ = tgen._decode_prompted(t_xkv, prompt, None, GenerationOptions(**opts), False)
    assert (t_seqs != det).any(), "beam-sample gave the beam-search tokens"


@pytest.mark.parametrize("prompt", [[[3, 4]], [[9, 5, 6, 7, 3, 4]]])
def test_near_zero_temperature_is_beam_search(generators, prompt):
    """T = 0.01 collapses beam-sample to beam search, in both packages."""
    jgen, j_xkv, tgen, t_xkv = generators
    prompt = np.asarray(prompt, np.int64)
    opts = dict(OPTS, num_beams=5, max_target_positions=prompt.shape[1] + 10)
    key = jax.random.PRNGKey(7)
    j_xkv, t_xkv = _rows(j_xkv, [0], False), _rows(t_xkv, [0], True)
    det, _, _ = tgen._decode_prompted(t_xkv, prompt, None, GenerationOptions(**opts), False)
    sampled, _, _ = tgen._decode_prompted(t_xkv, prompt, None, GenerationOptions(**opts), False,
                                          temperature=0.01, noise=jax_noise(key))
    j_det, _, _ = jgen._decode_prompted(j_xkv, prompt, None, JaxOptions(**opts), False)
    j_sampled, _, _ = jgen._decode_prompted(j_xkv, prompt, None, JaxOptions(**opts), False,
                                            temperature=0.01, rng=key)
    np.testing.assert_array_equal(sampled, det)
    np.testing.assert_array_equal(det, np.asarray(j_det))
    np.testing.assert_array_equal(sampled, np.asarray(j_sampled))


def test_beam_sample_needs_a_noise_source(generators):
    _, _, tgen, t_xkv = generators
    opts = GenerationOptions(**dict(OPTS, num_beams=3, max_target_positions=8))
    with pytest.raises(ValueError, match="noise"):
        tgen._decode_prompted(t_xkv, np.asarray([[3, 4], [3, 5]]), None, opts, False, temperature=0.5)


def test_ladder_samples_with_one_beam_and_gates_beam_scores(generators, monkeypatch):
    """``logprob_threshold`` trips the ladder on a normalized beam score, and
    the sampled rung decodes with ``num_beams=1`` (HF's
    ``generate_with_fallback``), in both packages."""
    jgen, j_xkv, tgen, t_xkv = generators
    opts = dict(OPTS, num_beams=5, temperature=(0.0, 0.4), logprob_threshold=-0.5,
                max_target_positions=20)
    seen = {}
    for name, gen, options in (("jax", jgen, JaxOptions), ("port", tgen, GenerationOptions)):
        calls = seen[name] = []

        def fake_decode(cross_kv, decoder_ids, attn, o, return_timestamps, temperature=0.0,
                        calls=calls, **kw):
            calls.append((temperature, o.num_beams))
            seqs = np.zeros((1, 20), np.int64)
            seqs[0, :3] = [3, 7, 2]
            return seqs, np.asarray([-1.0]), np.asarray([0.0])  # score < threshold

        monkeypatch.setattr(gen, "_decode_prompted", fake_decode)
        flags = [True]
        if name == "jax":
            gen._generate_with_fallback(_rows(j_xkv, [0], False), np.asarray([[3]]), None,
                                        options(**opts), flags, [0])
        else:
            gen._generate_with_fallback(_rows(t_xkv, [0], True), np.asarray([[3]]), None,
                                        options(**opts), flags, [0],
                                        segment_idx=1, noise=cpu_gumbel_noise)
    assert seen["port"] == seen["jax"] == [(0.0, 5), (0.4, 1)]
