"""The port's staged writes into an int8 self-attention cache (``kv_staging``
with ``kv_cache_int8``) vs the JAX package's, on the CPU, on the protocol of
``tests/test_kv_staging.py``.

The JAX package keeps the last <= W decode tokens in a compute-dtype
window, attends them unquantized as a third score block, and quantizes the
window into the int8 slab once every W steps; its results therefore differ
from the unstaged int8 cache's, and the port must give JAX's.

* The raw decoder loop (W = 4, twelve steps, three flushes, all below
  ``max_len - W``: JAX's flush clamps its write past the slab's end): the
  port's per-step logits against JAX's staged logits at f32 rounding (rtol
  and atol 1e-5, inside JAX's own atol 5e-2) and against its own unstaged
  ones (JAX's 5e-2, and not equal), and after every step the flushed int8
  codes equal to JAX's (JAX's own bound: one code) and the scales to rtol
  1e-5 (JAX's: 1e-2); ``base`` advances only at a flush.
* Transcripts of the longform seek loop (a batch of two 130-frame mels,
  timestamps, condition-on-prev) at ``num_beams`` 1 and 3: token-exact to
  JAX's staged int8 generator.
* Packed decode with staging equals its ``slots=1`` decode in f32 (batched
  steps) and in bf16 (one segment at a time); with a float cache
  ``kv_staging`` is ignored.
The CLI's run of a config with both knobs is held to the JAX CLI in
``tests/test_torch_cli.py`` (``kv_staging_int8``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhance_cb_whisper_tpu.decoding.generate import GenerationOptions as JaxOptions
from enhance_cb_whisper_tpu.decoding.generate import WhisperGenerator as JaxGenerator
from enhance_cb_whisper_tpu.models import whisper as jw
from enhance_cb_whisper_tpu_torch.convert import from_jax_whisper_params
from enhance_cb_whisper_tpu_torch.decoding.generate import GenerationOptions, WhisperGenerator
from enhance_cb_whisper_tpu_torch.models import whisper as tw
from test_torch_levers import CFG, whisper_params

W = 4
OPTS = dict(
    decoder_start_token_id=3, language_token_id=None, task_token_id=None,
    no_timestamps_token_id=100, prev_sot_token_id=99, eos_token_id=2, pad_token_id=0,
    max_initial_timestamp_index=10, max_target_positions=40,
    return_timestamps=True, condition_on_prev_tokens=True,
)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_staged_decoder_forward_state_and_logits():
    config = dict(
        vocab_size=64, num_mel_bins=8, d_model=16,
        encoder_layers=1, encoder_attention_heads=2,
        decoder_layers=2, decoder_attention_heads=2,
        encoder_ffn_dim=32, decoder_ffn_dim=32,
        max_source_positions=12, max_target_positions=24,
    )
    jcfg, tcfg = jw.WhisperConfig(**config), tw.WhisperConfig(**config)
    rng = np.random.default_rng(0)
    host = jw.init_whisper_params(rng, jcfg)
    jparams = jw.stack_whisper_params(host)
    tparams = from_jax_whisper_params(host, device="cpu")
    enc = rng.standard_normal((2, 12, 16), dtype=np.float32)
    prompt = rng.integers(4, 60, (2, 3))
    j_ckv = jw.precompute_cross_kv(jparams, jnp.asarray(enc), jcfg)
    t_ckv = tw.precompute_cross_kv(tparams, torch.from_numpy(enc), tcfg)
    max_len = 24

    j_cache = jw.init_cache(jcfg, 2, max_len, stacked=True, kv_int8=True, staging_window=W)
    t_cache = tw.init_cache(tcfg, 2, max_len, "cpu", kv_int8=True, staging_window=W)
    t_plain = tw.init_cache(tcfg, 2, max_len, "cpu", kv_int8=True)
    j_logits, j_cache = jw.decoder_forward(jparams, jnp.asarray(prompt, jnp.int32), j_ckv, jcfg, cache=j_cache)
    ids = torch.from_numpy(prompt)
    t_logits, _ = tw.decoder_forward(tparams, ids, t_ckv, tcfg, cache=t_cache, prefill=True)
    tw.decoder_forward(tparams, ids, t_ckv, tcfg, cache=t_plain, prefill=True)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), rtol=1e-5, atol=1e-5)
    j_cache["index"] = jnp.asarray(2, jnp.int32)  # re-feed the last prompt token
    j_cache["base"] = jnp.asarray(2, jnp.int32)
    t_cache["index"] = t_cache["base"] = t_plain["index"] = 2

    tok = prompt[:, -1:]
    staged_moved = 0.0
    for step in range(12):
        j_logits, j_cache = jw.decoder_forward(jparams, jnp.asarray(tok, jnp.int32), j_ckv, jcfg, cache=j_cache)
        t_logits, _ = tw.decoder_forward(tparams, torch.from_numpy(tok), t_ckv, tcfg, cache=t_cache)
        plain_logits, _ = tw.decoder_forward(tparams, torch.from_numpy(tok), t_ckv, tcfg, cache=t_plain)
        want = np.asarray(j_logits)
        # JAX's staged logits to f32 rounding (tighter than JAX's own 5e-2)
        np.testing.assert_allclose(t_logits.numpy(), want, rtol=1e-5, atol=1e-5, err_msg=f"step {step}")
        np.testing.assert_allclose(t_logits.numpy(), plain_logits.numpy(), atol=5e-2, rtol=0)
        staged_moved = max(staged_moved, float((t_logits - plain_logits).abs().max()))
        tok = np.asarray(np.argmax(want[:, -1:], axis=-1), np.int64)
        if (step + 1) % W == 0:
            j_cache = jw.flush_staging(j_cache)
            assert tw.flush_staging(t_cache) is t_cache
        base = int(j_cache["base"])
        assert t_cache["base"] == base == 2 + ((step + 1) // W) * W
        assert t_cache["index"] == int(j_cache["index"]) == 3 + step
        for i, layer in enumerate(t_cache["layers"]):
            for codes, scale in (("k", "k_scale"), ("v", "v_scale")):
                # the codes equal (JAX's own bound is one code), the scales
                # to f32 rounding (JAX's own bound rtol 1e-2)
                np.testing.assert_array_equal(layer[codes][:, :base].numpy(),
                                              np.asarray(j_cache["layers"][codes][i, :, :base]))
                np.testing.assert_allclose(layer[scale][:, :base].numpy(),
                                           np.asarray(j_cache["layers"][scale][i, :, :base]), rtol=1e-5)
                # past the last flush the slab holds the prompt only
                assert not layer[codes][:, max(base, prompt.shape[1]):].any()
    # the window's unquantized tokens change the logits (by int8 noise)
    assert 1e-6 < staged_moved < 5e-2


@pytest.fixture(scope="module")
def params():
    return whisper_params()


@pytest.fixture(scope="module")
def mel():
    return np.random.default_rng(2).standard_normal((2, 8, 130)).astype(np.float32)


@pytest.mark.parametrize("num_beams", [1, 3])
def test_staged_int8_matches_jax_transcripts(params, mel, num_beams):
    jgen = JaxGenerator(jw.WhisperConfig(**CFG), params, prompt_buckets=(CFG["max_target_positions"],),
                        kv_cache_int8=True, kv_staging=W)
    want = np.asarray(jgen.generate(jnp.asarray(mel), JaxOptions(**OPTS, num_beams=num_beams)))
    tgen = WhisperGenerator(tw.WhisperConfig(**CFG), from_jax_whisper_params(params, device="cpu"),
                            device="cpu", kv_cache_int8=True, kv_staging=W)
    got = np.asarray(tgen.generate(torch.from_numpy(mel), GenerationOptions(**OPTS, num_beams=num_beams)))
    np.testing.assert_array_equal(got, want)
    assert (got != OPTS["pad_token_id"]).sum(axis=1).min() > 8  # every row decoded something


def _packed(gen, mels, slots):
    stream = ((torch.from_numpy(m[None]), None) for m in mels)
    opts = GenerationOptions(**OPTS, num_beams=1)
    return {order: np.asarray(tokens) for order, tokens in gen.generate_packed(stream, opts, slots=slots)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_staged_int8_equals_slots1(params, dtype):
    mels = [np.random.default_rng(10 + i).standard_normal((8, n)).astype(np.float32)
            for i, n in enumerate((130, 60, 95))]
    gen = WhisperGenerator(tw.WhisperConfig(**CFG), from_jax_whisper_params(params, device="cpu"),
                           device="cpu", dtype=getattr(torch, dtype), kv_cache_int8=True, kv_staging=W)
    one = _packed(gen, mels, 1)
    two = _packed(gen, mels, 2)
    assert sorted(one) == sorted(two) == [0, 1, 2]
    for order in one:
        np.testing.assert_array_equal(two[order], one[order])
        assert len(one[order]) > 8


def test_float_cache_ignores_staging(params):
    gen = WhisperGenerator(tw.WhisperConfig(**CFG), from_jax_whisper_params(params, device="cpu"),
                           device="cpu", kv_staging=W)
    assert gen._kv_staging == 0
    with pytest.raises(ValueError, match="int8 cache"):
        tw.init_cache(tw.WhisperConfig(**CFG), 1, 8, "cpu", staging_window=W)
    with pytest.raises(ValueError, match="staging_window must be in"):
        tw.init_cache(tw.WhisperConfig(**CFG), 1, 8, "cpu", kv_int8=True, staging_window=8)
