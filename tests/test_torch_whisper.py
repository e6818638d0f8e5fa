"""Port Whisper vs the JAX package on tiny random weights (one numpy seed,
converted): converter layouts, encoder hidden states and KWS stack,
cross-attention K/V, and decoder logits under teacher forcing, prompt
prefill and single-token steps (with a prompt-padding attention mask).

Tolerance: atol 2e-5 / rtol 1e-4 on fp32 activations of O(1) — both sides
run full fp32 on the CPU; only summation order differs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhance_cb_whisper_tpu.models import whisper as jw
from enhance_cb_whisper_tpu_torch.convert import from_jax_whisper_params
from enhance_cb_whisper_tpu_torch.models import whisper as tw

RTOL, ATOL = 1e-4, 2e-5

CFG = dict(
    vocab_size=128, num_mel_bins=80, d_model=64,
    encoder_layers=3, encoder_attention_heads=4,
    decoder_layers=2, decoder_attention_heads=4,
    encoder_ffn_dim=128, decoder_ffn_dim=128,
    max_source_positions=1500, max_target_positions=40,
    decoder_start_token_id=3, eos_token_id=2, pad_token_id=0,
)


@pytest.fixture(scope="module")
def models():
    jcfg = jw.WhisperConfig(**CFG)
    tcfg = tw.WhisperConfig(**CFG)
    params = jw.init_whisper_params(np.random.default_rng(0), jcfg)
    # non-trivial biases and LayerNorm affines, so the converter's handling
    # of every leaf is exercised
    rng = np.random.default_rng(1)

    def jitter(tree):
        for key, value in tree.items():
            if isinstance(value, dict):
                jitter(value)
            elif isinstance(value, list):
                for layer in value:
                    jitter(layer)
            elif key == "bias" or (key == "weight" and value.ndim == 1):
                tree[key] = (value + rng.normal(0, 0.05, value.shape)).astype(np.float32)

    jitter(params)
    jparams = jw.stack_whisper_params(params)
    return jcfg, tcfg, params, jparams, from_jax_whisper_params(params, device="cpu")


def _mel(batch, seed):
    return np.random.default_rng(seed).standard_normal((batch, 80, 3000)).astype(np.float32)


def test_port_init_matches_jax_init(models):
    jcfg, tcfg, *_ = models
    a = jw.init_whisper_params(np.random.default_rng(7), jcfg)
    b = tw.init_whisper_params(np.random.default_rng(7), tcfg)
    np.testing.assert_array_equal(a["decoder"]["embed_tokens"]["weight"], b["decoder"]["embed_tokens"]["weight"])
    np.testing.assert_array_equal(
        a["encoder"]["layers"][2]["fc2"]["weight"], b["encoder"]["layers"][2]["fc2"]["weight"]
    )
    np.testing.assert_array_equal(
        a["encoder"]["embed_positions"]["weight"], b["encoder"]["embed_positions"]["weight"]
    )


def test_converter_layouts_and_stacked_input(models):
    _, _, params, jparams, tparams = models
    enc0 = params["encoder"]["layers"][0]
    np.testing.assert_array_equal(
        tparams["encoder"]["layers"][0]["self_attn"]["q_proj"]["weight"].numpy(),
        enc0["self_attn"]["q_proj"]["weight"].T,
    )
    np.testing.assert_array_equal(
        tparams["encoder"]["conv2"]["weight"].numpy(),
        params["encoder"]["conv2"]["weight"].transpose(2, 1, 0),
    )
    # the stacked (scan) layout converts to the same tensors
    stacked = from_jax_whisper_params(jax.tree.map(np.asarray, jparams), device="cpu")
    want, got = _leaves(tparams), _leaves(stacked)
    assert want.keys() == got.keys()
    for path, tensor in want.items():
        torch.testing.assert_close(got[path], tensor, rtol=0, atol=0)


def _leaves(tree, prefix=""):
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    out = {}
    for key, value in items:
        path = f"{prefix}.{key}"
        if isinstance(value, (dict, list)):
            out.update(_leaves(value, path))
        else:
            out[path] = value
    return out


def test_encoder_hidden_states_and_kws_stack(models):
    jcfg, tcfg, _, jparams, tparams = models
    mel = _mel(2, 2)
    j_last, j_states = jw.encoder_forward(jparams, jnp.asarray(mel), jcfg, output_hidden_states=True)
    t_last, t_states = tw.encoder_forward(tparams, torch.from_numpy(mel), tcfg, output_hidden_states=True)
    assert t_states.shape == (jcfg.encoder_layers + 1, 2, 1500, 64)
    np.testing.assert_allclose(t_states.numpy(), np.asarray(j_states), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_last.numpy(), np.asarray(j_last), rtol=RTOL, atol=ATOL)

    j_stack, j_enc = jw.encoder_kws_stack(jparams, jnp.asarray(mel), jcfg, layer_slice=(1, 3),
                                          return_encoding=True)
    t_stack, t_enc = tw.encoder_kws_stack(tparams, torch.from_numpy(mel), tcfg, layer_slice=(1, 3),
                                          return_encoding=True)
    assert t_stack.shape == (2, 2, 1500, 64)
    np.testing.assert_allclose(t_stack.numpy(), np.asarray(j_stack), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_enc.numpy(), np.asarray(j_enc), rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="out of range"):
        tw.encoder_kws_stack(tparams, torch.from_numpy(mel), tcfg, layer_slice=(2, 5))


@pytest.fixture(scope="module")
def encoded(models):
    jcfg, tcfg, _, jparams, tparams = models
    enc = np.random.default_rng(3).standard_normal((2, 1500, 64)).astype(np.float32)
    j_xkv = jw.precompute_cross_kv(jparams, jnp.asarray(enc), jcfg)
    t_xkv = tw.precompute_cross_kv(tparams, torch.from_numpy(enc), tcfg)
    return j_xkv, t_xkv


def test_cross_kv(models, encoded):
    j_xkv, t_xkv = encoded
    for i, layer in enumerate(t_xkv):
        for name in ("k", "v"):
            np.testing.assert_allclose(layer[name].numpy(), np.asarray(j_xkv[name][i]), rtol=RTOL, atol=ATOL)


# a left-padded prompt (row 1 carries two pad ids inside its prompt)
PROMPT = np.array([[99, 30, 31, 32, 3, 50], [99, 0, 0, 40, 3, 50]], np.int64)
ATTN = (PROMPT != 0).astype(np.int64)


def test_decoder_teacher_forcing(models, encoded):
    jcfg, tcfg, _, jparams, tparams = models
    j_xkv, t_xkv = encoded
    want, _ = jw.decoder_forward(jparams, jnp.asarray(PROMPT), j_xkv, jcfg, attention_mask=jnp.asarray(ATTN))
    got, _ = tw.decoder_forward(tparams, torch.from_numpy(PROMPT), t_xkv, tcfg,
                                attention_mask=torch.from_numpy(ATTN))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_decoder_prefill_and_steps(models, encoded):
    jcfg, tcfg, _, jparams, tparams = models
    j_xkv, t_xkv = encoded
    max_len = jcfg.max_target_positions
    attn = np.ones((2, max_len), np.int64)
    attn[:, : PROMPT.shape[1]] = ATTN
    j_cache = jw.init_cache(jcfg, 2, max_len, stacked=True)
    t_cache = tw.init_cache(tcfg, 2, max_len, torch.device("cpu"))
    want, j_cache = jw.decoder_forward(jparams, jnp.asarray(PROMPT), j_xkv, jcfg, cache=j_cache,
                                       attention_mask=jnp.asarray(attn))
    got, t_cache = tw.decoder_forward(tparams, torch.from_numpy(PROMPT), t_xkv, tcfg, cache=t_cache,
                                      attention_mask=torch.from_numpy(attn))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    steps = np.random.default_rng(4).integers(4, 90, (5, 2, 1))
    for tok in steps:
        want, j_cache = jw.decoder_forward(jparams, jnp.asarray(tok), j_xkv, jcfg, cache=j_cache,
                                           attention_mask=jnp.asarray(attn))
        got, t_cache = tw.decoder_forward(tparams, torch.from_numpy(tok), t_xkv, tcfg, cache=t_cache,
                                          attention_mask=torch.from_numpy(attn))
        assert t_cache["index"] == int(j_cache["index"])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
