"""The port's serving levers vs the JAX package's, on the CPU at tiny dims
(d_model 32, 2 + 3 layers, vocab 128, 8 mels, 48-frame windows; random
weights from one numpy seed, converted): bf16 compute, weight-only int8
vocab and decoder, int8 self-attention cache and int8 cross-attention K/V.

* The quantizers give JAX's int8 codes and f32 scales bit for bit, and a
  JAX-quantized tree converts to the port's own.
* Per lever, the prefill's logits and three decode steps' logits against
  JAX's in the same mode (the JAX side through the generator's own jitted
  programs): int8 on fp32 at the fp32 tests' tolerance (atol 2e-5 /
  rtol 1e-4, fp32 rounding only: the codes are the same); bf16 within
  0.02 x the logits' scale with equal argmax (JAX's own bf16 bound,
  ``tests/test_whisper_parity.py``).
* The int8 cache's two write semantics, its beam reorder, and
  ``swap_params`` re-quantizing.

Transcripts per lever are in ``test_torch_levers_decode.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhance_cb_whisper_tpu.decoding.generate import WhisperGenerator as JaxGenerator
from enhance_cb_whisper_tpu.models import whisper as jw
from enhance_cb_whisper_tpu_torch.convert import from_jax_whisper_params
from enhance_cb_whisper_tpu_torch.decoding.beam import _gather_beams
from enhance_cb_whisper_tpu_torch.decoding.generate import GenerationOptions, WhisperGenerator
from enhance_cb_whisper_tpu_torch.models import whisper as tw

RTOL, ATOL = 1e-4, 2e-5  # int8 on fp32: fp32 rounding of the same codes
BF16_SCALE = 0.02  # bf16: JAX's own bound, a share of max |logit|

CFG = dict(
    vocab_size=128, num_mel_bins=8, d_model=32,
    encoder_layers=2, encoder_attention_heads=4,
    decoder_layers=3, decoder_attention_heads=4,
    encoder_ffn_dim=64, decoder_ffn_dim=64,
    max_source_positions=24, max_target_positions=40,
    decoder_start_token_id=3, eos_token_id=2, pad_token_id=0,
)
PROMPT = [3, 9, 5, 7, 11]
STEPS = [13, 17, 19]

# name -> (JAX generator kwargs, port generator kwargs)
LEVERS = {
    "vocab_int8": (dict(vocab_int8=True), dict(vocab_int8=True)),
    "decoder_int8": (dict(decoder_int8=True), dict(decoder_int8=True)),
    "kv_cache_int8": (dict(kv_cache_int8=True), dict(kv_cache_int8=True)),
    "cross_kv_int8": (dict(cross_kv_int8=True), dict(cross_kv_int8=True)),
    "bf16": (dict(dtype=jnp.bfloat16), dict(dtype=torch.bfloat16)),
    "bf16_serving": (dict(dtype=jnp.bfloat16, vocab_int8=True, decoder_int8=True),
                     dict(dtype=torch.bfloat16, vocab_int8=True, decoder_int8=True)),
}


def whisper_params(seed: int = 0):
    """Random weights with non-zero biases and LayerNorm affines (so every
    leaf the levers touch matters), the encoder's convolutions x10 and the
    cross-attention output x4 (a plain random encoder's output is nearly
    all position embedding)."""
    params = jw.init_whisper_params(np.random.default_rng(seed), jw.WhisperConfig(**CFG))
    rng = np.random.default_rng(seed + 100)

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
    params["encoder"]["conv1"]["weight"] *= 10.0
    params["encoder"]["conv2"]["weight"] *= 10.0
    for layer in params["decoder"]["layers"]:
        layer["encoder_attn"]["out_proj"]["weight"] *= 4.0
    return params


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
def mel():
    return np.random.default_rng(1).standard_normal((1, 8, 48)).astype(np.float32)


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


def test_quantizers_bit_equal_to_jax(params):
    """Codes and scales of the vocab, decoder and encoder quantizers and of
    ``_quantize_kv`` equal JAX's; a JAX-quantized tree (stacked, as the JAX
    generator holds it) converts to exactly the port's own quantization."""
    port = from_jax_whisper_params(params, device="cpu")

    vocab_j = jw.quantize_vocab_projection(params)["decoder"]["embed_tokens_q"]
    vocab_t = tw.quantize_vocab_projection(port)["decoder"]["embed_tokens_q"]
    np.testing.assert_array_equal(vocab_t["qweight"].numpy(), vocab_j["qweight"])
    np.testing.assert_array_equal(vocab_t["scale"].numpy(), vocab_j["scale"])

    dec_j = jw.quantize_decoder_layers(params)["decoder"]["layers"]
    dec_t = tw.quantize_decoder_layers(port)["decoder"]["layers"]
    for lj, lt in zip(dec_j, dec_t):
        for path in jw._DECODE_LOOP_LINEARS:
            pj, pt = lj, lt
            for key in path:
                pj, pt = pj[key], pt[key]
            assert pt["qweight"].dtype == torch.int8 and pt["qweight"].is_contiguous()
            np.testing.assert_array_equal(pt["qweight"].numpy(), pj["qweight"].T)
            np.testing.assert_array_equal(pt["scale"].numpy(), pj["scale"])
            if "bias" in pj:
                np.testing.assert_array_equal(pt["bias"].numpy(), pj["bias"])
        # the cross K/V projections run once per segment: left in f32
        assert "weight" in lt["encoder_attn"]["k_proj"] and "qweight" not in lt["encoder_attn"]["k_proj"]

    scales = np.random.default_rng(2).uniform(0.01, 0.1, (CFG["encoder_layers"], 4)).astype(np.float32)
    enc_j = jw.quantize_encoder_layers(params, scales)
    enc_t = tw.quantize_encoder_layers(port, scales)
    for i, lt in enumerate(enc_t["encoder"]["layers"]):
        for path in jw._ENC_LOOP_LINEARS:
            pj, pt = enc_j["encoder"]["layers"], lt
            for key in path:
                pj, pt = pj[key], pt[key]
            # row-major [out, in]: cuBLASLt takes torch._int_mm's weight operand column-major only
            assert pt["qweight"].is_contiguous()
            np.testing.assert_array_equal(pt["qweight"].numpy(), np.asarray(pj["qweight"][i]).T)
            np.testing.assert_array_equal(pt["scale"].numpy(), np.asarray(pj["scale"][i]))
        for j, site in enumerate(jw._ENC_ACT_SITES):
            assert float(lt["act_scales"][site]) == float(scales[i, j])
    with pytest.raises(ValueError, match="act_scales"):
        tw.quantize_encoder_layers(port, scales[:-1])

    x = np.random.default_rng(3).standard_normal((3, 5, 4, 8)).astype(np.float32) * 7
    x[1, 2] = 0.0  # an all-zero token keeps zero codes
    qj, sj = jw._quantize_kv(jnp.asarray(x))
    qt, st = tw._quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert not qt[1, 2].any()

    # the JAX generator's tree (quantized, then stacked) through the converter
    jtree = jw.stack_whisper_params(
        jax.tree.map(jnp.asarray, jw.quantize_decoder_layers(jw.quantize_vocab_projection(params))))
    converted = _leaves(from_jax_whisper_params(jax.tree.map(np.asarray, jtree), device="cpu"))
    own = _leaves(tw.quantize_decoder_layers(tw.quantize_vocab_projection(port)))
    assert converted.keys() == own.keys()
    for path, tensor in own.items():
        assert converted[path].dtype == tensor.dtype, path
        torch.testing.assert_close(converted[path], tensor, rtol=0, atol=0)
    converted_enc = _leaves(from_jax_whisper_params(jax.tree.map(np.asarray, enc_j), device="cpu")["encoder"])
    own_enc = _leaves(enc_t["encoder"])
    assert converted_enc.keys() == own_enc.keys()
    for path, tensor in own_enc.items():
        torch.testing.assert_close(converted_enc[path], tensor, rtol=0, atol=0)


def _jax_logits(params, mel, kwargs):
    """The JAX generator's own programs: encode, cross K/V, the prefill of
    ``PROMPT`` (padded to its bucket) and the decode steps of ``STEPS``.
    Returns the logits [1 + len(STEPS), vocab]."""
    gen = JaxGenerator(jw.WhisperConfig(**CFG), params, prompt_buckets=(8,), **kwargs)
    cross_kv = gen._cross_kv_fn(gen._encode(jnp.asarray(mel)))
    padded = np.zeros((1, 8), np.int32)
    padded[0, : len(PROMPT)] = PROMPT
    ctx = gen._make_ctx(cross_kv, np.ones((1, len(PROMPT)), np.int32), CFG["max_target_positions"], 1)
    cache, first = gen._prefill(jnp.asarray(padded), len(PROMPT), ctx, CFG["max_target_positions"])
    step = jax.jit(gen._decode_step)
    logits = [np.asarray(first)]
    # the decode loop's first step re-feeds the last prompt token
    for tok in [PROMPT[-1]] + STEPS[:-1]:
        out, cache = step(jnp.asarray([[tok]], jnp.int32), cache, ctx)
        logits.append(np.asarray(out.astype(jnp.float32)))
    return np.concatenate(logits)


def _port_logits(params, mel, kwargs):
    gen = WhisperGenerator(tw.WhisperConfig(**CFG), from_jax_whisper_params(params, device="cpu"),
                           device="cpu", **kwargs)
    with torch.no_grad():
        cross_kv = gen._cross_kv_fn(gen._encode(torch.from_numpy(mel)))
        ctx = gen._make_ctx(cross_kv, np.ones((1, len(PROMPT)), np.int64), CFG["max_target_positions"], 1)
        cache, first = gen._prefill(torch.tensor([PROMPT]), ctx, CFG["max_target_positions"])
        logits = [first]
        for tok in [PROMPT[-1]] + STEPS[:-1]:
            out, cache = gen._decode_step(torch.tensor([[tok]]), cache, ctx)
            logits.append(out)
    return torch.cat(logits).float().numpy(), gen


@pytest.mark.parametrize("lever", list(LEVERS))
def test_lever_logits_match_jax(params, mel, lever):
    jax_kwargs, port_kwargs = LEVERS[lever]
    want = _jax_logits(params, mel, jax_kwargs)
    got, gen = _port_logits(params, mel, port_kwargs)
    assert got.shape == want.shape == (1 + len(STEPS), CFG["vocab_size"])
    if "dtype" in port_kwargs:
        scale = np.abs(want).max()
        assert np.abs(got - want).max() < BF16_SCALE * scale, (np.abs(got - want).max(), scale)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        # the weights the forward reads are bf16, LayerNorms and int8 scales f32
        layer = gen.params["decoder"]["layers"][0]
        assert layer["self_attn_layer_norm"]["weight"].dtype == torch.float32
        assert gen.params["decoder"]["embed_tokens"]["weight"].dtype == torch.bfloat16
        fc1 = layer["fc1"]
        if "qweight" in fc1:
            assert (fc1["qweight"].dtype, fc1["scale"].dtype) == (torch.int8, torch.float32)
        else:
            assert fc1["weight"].dtype == torch.bfloat16
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _int8_cache_layer(rng, batch=2, length=8, heads=4, head_dim=8):
    k = torch.from_numpy(rng.standard_normal((batch, length, heads, head_dim)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((batch, length, heads, head_dim)).astype(np.float32))
    (kq, ks), (vq, vs) = tw._quantize_kv(k), tw._quantize_kv(v)
    return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}


def test_int8_cache_write_semantics():
    """A decode step attends over the dequantized cache BEFORE its position
    and over its own K/V at full precision, then stores its codes; a
    multi-token write (the prefill) stores first and attends over the
    dequantized tokens, the new ones included."""
    rng = np.random.default_rng(4)
    offset = 5
    layer = _int8_cache_layer(rng)
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 8)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 1, 4, 8)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 1, 4, 8)).astype(np.float32))
    mask = torch.ones((1, 1, 1, offset + 1), dtype=torch.bool)

    def dequant(c, upto):
        return (c["k"][:, :upto].float() * c["k_scale"][:, :upto, None, None],
                c["v"][:, :upto].float() * c["v_scale"][:, :upto, None, None])

    step_layer = {name: t.clone() for name, t in layer.items()}
    got = tw._self_attention_int8(q, k, v, step_layer, offset, mask, step=True)
    kd, vd = dequant(layer, offset)
    want = tw._attention(q, torch.cat([kd, k], 1), torch.cat([vd, v], 1), mask)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    (kq, ks), (vq, vs) = tw._quantize_kv(k), tw._quantize_kv(v)
    assert torch.equal(step_layer["k"][:, offset], kq[:, 0]) and torch.equal(step_layer["v_scale"][:, offset], vs[:, 0])
    assert torch.equal(step_layer["k"][:, :offset], layer["k"][:, :offset])
    # attending the stored (quantized) token instead gives another output
    kd1, vd1 = dequant(step_layer, offset + 1)
    assert not torch.allclose(tw._attention(q, kd1, vd1, mask), got, rtol=0, atol=1e-6)

    prefill_layer = {name: t.clone() for name, t in layer.items()}
    got = tw._self_attention_int8(q, k, v, prefill_layer, offset, mask, step=False)
    kd1, vd1 = dequant(prefill_layer, offset + 1)
    torch.testing.assert_close(got, tw._attention(q, kd1, vd1, mask), rtol=1e-5, atol=1e-6)
    assert torch.equal(prefill_layer["k"], step_layer["k"]) and torch.equal(prefill_layer["v_scale"],
                                                                          step_layer["v_scale"])

    # a one-token prefill takes the multi-token write too (JAX pads it to a bucket)
    cfg = tw.WhisperConfig(**CFG)
    port = from_jax_whisper_params(whisper_params(), device="cpu")
    cross_kv = tw.precompute_cross_kv(port, torch.zeros((1, 24, 32)), cfg)
    out = {}
    for prefill in (False, True):
        cache = tw.init_cache(cfg, 1, 8, torch.device("cpu"), kv_int8=True)
        out[prefill] = tw.decoder_forward(port, torch.tensor([[3]]), cross_kv, cfg, cache=cache,
                                          prefill=prefill)[0]
    assert not torch.equal(out[False], out[True])


def test_beam_reorder_moves_the_scales():
    """``_gather_beams`` reorders every slab of an int8 cache layer, codes
    and scales alike, over the written prefix only."""
    rng = np.random.default_rng(5)
    layer = _int8_cache_layer(rng, batch=3)
    cache = {"index": 6, "layers": [{name: t.clone() for name, t in layer.items()}]}
    rows = torch.tensor([2, 0, 0])
    _gather_beams(cache, rows, 6)
    for name, t in layer.items():
        got = cache["layers"][0][name]
        assert torch.equal(got[:, :6], t[:, :6].index_select(0, rows)), name
        assert torch.equal(got[:, 6:], t[:, 6:]), name


def test_swap_params_requantizes(params):
    """``swap_params`` quantizes and casts a new f32 checkpoint as the
    constructor did: the weights equal a fresh generator's on it, and one of
    another architecture is refused."""
    kwargs = dict(dtype=torch.bfloat16, vocab_int8=True, decoder_int8=True, device="cpu")
    cfg = tw.WhisperConfig(**CFG)
    gen = WhisperGenerator(cfg, from_jax_whisper_params(params, device="cpu"), **kwargs)
    other = whisper_params(seed=1)
    gen.swap_params(from_jax_whisper_params(other, device="cpu"))
    fresh = WhisperGenerator(cfg, from_jax_whisper_params(other, device="cpu"), **kwargs)
    got, want = _leaves(gen.params), _leaves(fresh.params)
    assert got.keys() == want.keys()
    for path, tensor in want.items():
        assert got[path].dtype == tensor.dtype, path
        torch.testing.assert_close(got[path], tensor, rtol=0, atol=0)
    bad = from_jax_whisper_params(other, device="cpu")
    bad["decoder"]["embed_tokens"]["weight"] = bad["decoder"]["embed_tokens"]["weight"][:, :16]
    with pytest.raises(ValueError, match="architecture mismatch"):
        gen.swap_params(bad)


def test_bf16_steps_run_one_segment_at_a_time(params, monkeypatch):
    """Below f32 every decode step, like the prefill, runs one segment's
    beams at a time, so a packed window's rows get the bits of their own
    ``slots=1`` decode, and a vacant slot is not decoded at all; f32 steps
    stay batched and decode the vacant slot too."""
    from enhance_cb_whisper_tpu_torch.decoding import generate as gen_module

    rows, decoded, real = [], [], gen_module.decoder_forward
    monkeypatch.setattr(gen_module, "decoder_forward",
                        lambda p, ids, *a, **kw: rows.append(ids.shape[0]) or real(p, ids, *a, **kw))
    opts = GenerationOptions(decoder_start_token_id=3, language_token_id=None, task_token_id=None,
                             no_timestamps_token_id=100, prev_sot_token_id=99, eos_token_id=2, pad_token_id=0,
                             max_initial_timestamp_index=10, max_target_positions=40, num_beams=2,
                             return_timestamps=True, condition_on_prev_tokens=True)
    # two windows each, then one: the last window has a vacant slot
    ms = [np.random.default_rng(9 + i).standard_normal((1, 8, n)).astype(np.float32)
          for i, n in enumerate((60, 90, 30))]
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        gen = WhisperGenerator(tw.WhisperConfig(**CFG), from_jax_whisper_params(params, device="cpu"),
                               device="cpu", dtype=dtype)
        prompted = gen._decode_prompted
        monkeypatch.setattr(gen, "_decode_prompted",
                            lambda cross_kv, ids, *a, **kw: decoded.append(ids.shape[0]) or prompted(
                                cross_kv, ids, *a, **kw))
        rows.clear()
        decoded.clear()
        packed = dict(gen.generate_packed(((m, None) for m in ms), opts, slots=2))
        out[dtype] = (set(rows), list(decoded))
        monkeypatch.undo()
        monkeypatch.setattr(gen_module, "decoder_forward",
                            lambda p, ids, *a, **kw: rows.append(ids.shape[0]) or real(p, ids, *a, **kw))
        solo = [dict(gen.generate_packed(iter([(m, None)]), opts, slots=1))[0] for m in ms]
        assert [packed[i].tolist() for i in range(len(ms))] == [s.tolist() for s in solo]
    assert out[torch.bfloat16] == ({2}, [2, 2, 1]) and 4 in out[torch.float32][0]
    assert out[torch.float32][1] == [2, 2, 2]
