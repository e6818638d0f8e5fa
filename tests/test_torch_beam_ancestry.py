"""The beam search's ancestry map (``decoding/beam.py``) and the decoder's
attention through it (``ops/beam_attention.py``, kernel K4's plain version)
on the CPU at tiny dims (d_model 64, 4 heads, 2 + 2 layers, vocab 128, 8
mels, 48-frame windows; torch on one thread).

A float cache keeps its rows where each beam appended them and the step
re-parents the map; an int8 cache is still reordered.  The map path is
held to the physical reorder it replaced bit for bit (every step's logits,
then sequences and scores) at 1, 3 and 5 beams in f32 and bf16, beam-sample
included; the map and the attention to the JAX package's ``anc`` rule and
``_ancestry_attention``; a packed service at ``slots=4`` to ``slots=1``; the
step spans' ``reorder_bytes`` and ``anc_layers``; and K4's wrapper raises
on what the kernel does not take."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhance_cb_whisper_tpu.models import whisper as jw
from enhance_cb_whisper_tpu_torch.convert import from_jax_whisper_params
from enhance_cb_whisper_tpu_torch.decoding import beam
from enhance_cb_whisper_tpu_torch.decoding.generate import GenerationOptions, WhisperGenerator
from enhance_cb_whisper_tpu_torch.decoding.prompt import prepare_decoder_input_ids
from enhance_cb_whisper_tpu_torch.models import whisper as tw
from enhance_cb_whisper_tpu_torch.ops import beam_attention as ba
from enhance_cb_whisper_tpu_torch.runtime import profiler

CFG = dict(
    vocab_size=128, num_mel_bins=8, d_model=64,
    encoder_layers=2, encoder_attention_heads=4,
    decoder_layers=2, decoder_attention_heads=4,
    encoder_ffn_dim=64, decoder_ffn_dim=64,
    max_source_positions=24, max_target_positions=40,
    decoder_start_token_id=3, eos_token_id=2, pad_token_id=0,
)
OPTS = dict(
    decoder_start_token_id=3, language_token_id=10, task_token_id=11,
    no_timestamps_token_id=100, prev_sot_token_id=99, eos_token_id=2, pad_token_id=0,
    max_initial_timestamp_index=10, max_target_positions=40, return_timestamps=True,
)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def params():
    """Random weights (one numpy seed) whose transcripts depend on the mel:
    the encoder's convolutions ×10 and the cross-attention output ×4; eos
    ×3, so some hypotheses finish and their items freeze."""
    p = tw.init_whisper_params(np.random.default_rng(0), tw.WhisperConfig(**CFG))
    p["encoder"]["conv1"]["weight"] *= 10.0
    p["encoder"]["conv2"]["weight"] *= 10.0
    for layer in p["decoder"]["layers"]:
        layer["encoder_attn"]["out_proj"]["weight"] *= 4.0
    p["decoder"]["embed_tokens"]["weight"][2] *= 3.0
    return from_jax_whisper_params(p, device="cpu")


def _generator(params, **levers):
    return WhisperGenerator(tw.WhisperConfig(**CFG), params, device="cpu", **levers)


def _prompt():
    """Two items whose prompts carry padding inside (keywords of unequal
    lengths)."""
    opts = GenerationOptions(**OPTS)
    return prepare_decoder_input_ids(
        init_tokens=opts.init_tokens(), keywords_tokens=[[99, 20, 21, 22, 23], [99, 30]],
        prev_tokens_per_batch=None, condition_on_prev=False, max_target_positions=40,
        pad_token_id=0, prev_sot_token_id=99,
    )


def _gumbel(cur_len, shape):
    return torch.from_numpy(np.random.default_rng(cur_len).gumbel(size=shape).astype(np.float32))


def _beam_run(gen, beams: int, sample: bool):
    """``beam_search`` as ``_decode_prompted`` runs it, at any beam count:
    (sequences, scores, every step's logits, the cache at the end)."""
    ids, attn = _prompt()
    mel = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 8, 48)).astype(np.float32))
    cross_kv = gen._cross_kv_fn(gen._encode(mel))
    ctx = gen._make_ctx(cross_kv, attn, 40, beams)
    prompt = torch.from_numpy(ids)
    cache, _ = gen._prefill(prompt.repeat_interleave(beams, dim=0), ctx, 40)
    steps = []

    def decode_fn(tokens, cache, ctx):
        logits, cache = gen._decode_step(tokens, cache, ctx)
        steps.append(logits.clone())
        return logits, cache

    seqs, scores = beam.beam_search(
        decode_fn, prompt, ids.shape[1], cache, ctx, gen._processors(GenerationOptions(**OPTS)),
        num_beams=beams, max_length=40, pad_token_id=0, eos_token_id=2,
        do_sample=sample, temperature=0.7 if sample else 1.0, noise=_gumbel if sample else None,
    )
    return seqs, scores, steps, cache


@pytest.mark.parametrize("sample", [False, True], ids=["beam", "beam_sample"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("beams", [1, 3, 5])
def test_map_path_equals_physical_reorder(params, beams, dtype, sample, monkeypatch):
    """Every step's logits bit for bit, then sequences and scores, against
    the same search with the cache reordered in place (the path before the
    map)."""
    gen = _generator(params, dtype=dtype)
    seqs, scores, steps, cache = _beam_run(gen, beams, sample)
    assert "anc" in cache and cache["anc"].shape == (2, beams, 40)
    monkeypatch.setattr(beam, "_ancestry_map", lambda *a: None)
    seqs_p, scores_p, steps_p, cache_p = _beam_run(gen, beams, sample)
    assert "anc" not in cache_p
    assert len(steps) == len(steps_p) > 1
    for i, (got, want) in enumerate(zip(steps, steps_p)):
        assert torch.equal(got, want), f"step {i}: max |diff| {float((got - want).abs().max())}"
    assert torch.equal(seqs, seqs_p) and torch.equal(scores, scores_p)
    if beams > 1 and not sample:
        # the map is not the identity by the end: beams took other parents
        ident = torch.arange(beams, dtype=torch.int32)[None, :, None]
        assert (cache["anc"] != ident).any()


def _jax_reparent(anc, sel_beam, cur_len):
    """``enhance_cb_whisper_tpu/decoding/beam.py``'s update of ``anc``."""
    parent = jnp.take_along_axis(anc, sel_beam[:, :, None], axis=1)
    ident = jnp.broadcast_to(jnp.arange(anc.shape[1], dtype=anc.dtype)[None, :, None], anc.shape)
    slot = jnp.arange(anc.shape[-1], dtype=jnp.int32)[None, None, :]
    return jnp.where(slot < cur_len, parent, ident)


def test_map_follows_jax_and_reads_the_reordered_cache():
    """Over 12 steps of random parent choices the map equals JAX's, and the
    unpermuted cache read through it equals a cache reordered every step
    (each beam appending its own token's K/V at the step's position)."""
    rng = np.random.default_rng(1)
    batch, beams, max_len, start = 3, 4, 20, 5
    shape = (batch * beams, max_len, 2, 8)
    prefix = torch.from_numpy(rng.standard_normal((batch, 1, start, 2, 8)).astype(np.float32))
    physical = torch.zeros(shape)
    physical[:, :start] = prefix.expand(batch, beams, start, 2, 8).reshape(batch * beams, start, 2, 8)
    unpermuted = physical.clone()
    cache = {"layers": [{"k": unpermuted}]}
    anc = beam._ancestry_map(cache, batch, beams)
    jax_anc = jnp.asarray(anc.numpy().copy())  # the port updates anc in place
    rows = (torch.arange(batch)[:, None] * beams)
    for cur_len in range(start + 1, start + 13):
        token = torch.from_numpy(rng.standard_normal((batch * beams, 2, 8)).astype(np.float32))
        physical[:, cur_len - 1] = token
        unpermuted[:, cur_len - 1] = token
        sel = torch.from_numpy(rng.integers(0, beams, (batch, beams)))
        beam._gather_beams({"layers": [{"k": physical}]}, (rows + sel).reshape(-1), cur_len)
        beam._reparent(anc, sel, cur_len)
        jax_anc = _jax_reparent(jax_anc, jnp.asarray(sel.numpy()), cur_len)
        np.testing.assert_array_equal(anc.numpy(), np.asarray(jax_anc))
        assert torch.equal(ba.gather_rows(unpermuted, anc, cur_len), physical[:, :cur_len])


def _attention_inputs(rng, batch, beams, length, max_len, heads=3, dh=16, masked=True):
    q = rng.standard_normal((batch * beams, 1, heads, dh)).astype(np.float32) * 0.5
    k = rng.standard_normal((batch * beams, max_len, heads, dh)).astype(np.float32)
    v = rng.standard_normal((batch * beams, max_len, heads, dh)).astype(np.float32)
    anc = rng.integers(0, beams, (batch, beams, max_len)).astype(np.int32)
    mask = np.ones((batch * beams, max_len), np.int64)
    if masked:
        mask[:, 1:4] = 0  # prompt padding
    return q, k, v, anc, mask


@pytest.mark.parametrize("masked", [True, False], ids=["pads", "no_mask"])
def test_attention_matches_jax(masked):
    """The port's attention through the map against JAX's one-hot
    ``_ancestry_attention`` on the written prefix (f32; the sums run in
    another order)."""
    rng = np.random.default_rng(2)
    batch, beams, length, max_len = 2, 5, 11, 16
    q, k, v, anc, mask = _attention_inputs(rng, batch, beams, length, max_len, masked=masked)
    got = ba.ancestry_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                torch.from_numpy(anc), torch.from_numpy(mask) if masked else None, length)
    onehot = anc[:, :, None, :length] == np.arange(beams, dtype=np.int32)[None, None, :, None]
    jmask = mask[:, None, None, :length].astype(bool) if masked else np.ones((1, 1, 1, length), bool)
    want = jw._ancestry_attention(jnp.asarray(q), jnp.asarray(k[:, :length]), jnp.asarray(v[:, :length]),
                                  jnp.asarray(onehot), jnp.asarray(jmask))
    assert got.shape == (batch * beams, 1, 3, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_packed_slots_equal_one_slot(params):
    """A packed bf16 decode (each segment's rows through their own slice of
    the map) gives every utterance the same tokens at 4 slots as at 1."""
    gen = _generator(params, dtype=torch.bfloat16)
    opts = GenerationOptions(**{**OPTS, "language_token_id": None, "task_token_id": None}, num_beams=3)
    rng = np.random.default_rng(7)
    feats = [(rng.standard_normal((1, 8, t)).astype(np.float32), None) for t in (48, 70, 30, 96, 52)]
    one = dict(gen.generate_packed(iter(feats), opts, slots=1))
    four = dict(gen.generate_packed(iter(feats), opts, slots=4))
    assert sorted(one) == sorted(four) == list(range(len(feats)))
    for order in one:
        np.testing.assert_array_equal(four[order], one[order])


@pytest.mark.parametrize("levers", [
    dict(), dict(dtype=torch.bfloat16), dict(kv_cache_int8=True), dict(kv_cache_int8=True, kv_staging=4),
], ids=["f32", "bf16", "int8", "int8_staged"])
def test_step_spans_count_the_reorder(params, levers):
    """Float caches: every beam step reorders 0 bytes and reads through the
    map in every decoder layer.  Int8 caches: no map, and every step
    reorders the written prefix of each slab."""
    gen = _generator(params, **levers)
    profiler.reset()
    _, _, steps, cache = _beam_run(gen, 3, sample=False)
    spans = [s for s in profiler.spans() if s["name"] == "ecw.decode.step"]
    assert len(spans) == len(steps) > 1
    if levers.get("kv_cache_int8"):
        assert "anc" not in cache
        # step i reorders the written prefix [:prompt_len + i] of every slab
        # (the codes, their scales, and the staging windows' written part)
        prompt_len = _prompt()[0].shape[1]
        for i, s in enumerate(spans):
            written = sum(slab[:, :prompt_len + i].numel() * slab.element_size()
                          for layer in cache["layers"] for slab in layer.values())
            assert s["attrs"]["anc_layers"] == 0 and s["attrs"]["reorder_bytes"] == written > 0
    else:
        assert all(s["attrs"]["anc_layers"] == CFG["decoder_layers"] and s["attrs"]["reorder_bytes"] == 0
                   for s in spans)


def test_map_cache_takes_steps_only(params):
    """A cache with a map refuses a multi-token call: its rows are not in
    logical order."""
    gen = _generator(params)
    cfg = tw.WhisperConfig(**CFG)
    cache = tw.init_cache(cfg, 2, 40, torch.device("cpu"))
    beam._ancestry_map(cache, 1, 2)
    cross_kv = gen._cross_kv_fn(gen._encode(torch.zeros((1, 8, 48))))
    with pytest.raises(ValueError, match="single-token"):
        tw.decoder_forward(gen.params, torch.zeros((2, 3), dtype=torch.long), cross_kv, cfg, cache=cache)


def _valid(batch=2, beams=5, dh=64):
    rng = np.random.default_rng(3)
    q, k, v, anc, mask = _attention_inputs(rng, batch, beams, 9, 12, heads=2, dh=dh)
    return dict(q=torch.from_numpy(q), k_slab=torch.from_numpy(k), v_slab=torch.from_numpy(v),
                anc=torch.from_numpy(anc), attention_mask=torch.from_numpy(mask), length=9)


def _beams_past_max(a):
    """One item of ``MAX_BEAMS + 1`` beams; the slabs are expanded views,
    which the beam count's check reaches before their contiguity's."""
    rows = ba.MAX_BEAMS + 1
    slab = a["k_slab"][:1].expand(rows, -1, -1, -1)
    return dict(a, q=a["q"][:1].expand(rows, -1, -1, -1).contiguous(), k_slab=slab, v_slab=slab,
                anc=torch.zeros((1, rows, a["anc"].shape[2]), dtype=torch.int32), attention_mask=None)


BAD = {
    "q_float16": (TypeError, lambda a: dict(a, q=a["q"].half())),
    "slab_dtype": (TypeError, lambda a: dict(a, k_slab=a["k_slab"].double())),
    "anc_int64": (TypeError, lambda a: dict(a, anc=a["anc"].long())),
    "mask_float": (TypeError, lambda a: dict(a, attention_mask=a["attention_mask"].float())),
    "head_dim_80": (ValueError, lambda a: _valid(dh=80)),
    "head_dim_odd_45": (ValueError, lambda a: _valid(dh=45)),
    "slab_head_dim": (ValueError, lambda a: dict(a, k_slab=a["k_slab"][..., :32].contiguous(),
                                                 v_slab=a["v_slab"][..., :32].contiguous())),
    "two_tokens": (ValueError, lambda a: dict(a, q=a["q"].expand(-1, 2, -1, -1).contiguous())),
    "beams_past_max": (ValueError, lambda a: _beams_past_max(a)),
    "map_rows_differ": (ValueError, lambda a: dict(a, anc=a["anc"][:1])),
    "length_past_slab": (ValueError, lambda a: dict(a, length=13)),
    "length_zero": (ValueError, lambda a: dict(a, length=0)),
    "slab_not_contiguous": (ValueError, lambda a: dict(a, k_slab=a["k_slab"].transpose(1, 2).contiguous()
                                                      .transpose(1, 2))),
    "anc_not_contiguous": (ValueError, lambda a: dict(a, anc=torch.cat([a["anc"], a["anc"]], 2)[:, :, ::2])),
    "mask_strided": (ValueError, lambda a: dict(a, attention_mask=torch.cat(
        [a["attention_mask"], a["attention_mask"]], 1)[:, ::2])),
    "cpu_tensors": (ValueError, lambda a: a),
}


@pytest.mark.parametrize("dh", [16, 32, 64])
def test_kernel_wrapper_takes_whisper_head_sizes(dh):
    """K4's wrapper checks pass at the head sizes it takes (64, and the
    tests' tiny models' 16 and 32): CPU tensors then raise only for their
    device."""
    with pytest.raises(ValueError, match="CUDA tensors"):
        ba.ancestry_attention_cuda(**_valid(dh=dh))


@pytest.mark.parametrize("case", sorted(BAD))
def test_kernel_wrapper_refuses(case):
    """K4's wrapper raises before any launch on a dtype, shape, contiguity
    or device it does not take (here on CPU tensors, which the kernel never
    takes: valid ones raise for their device)."""
    error, change = BAD[case]
    with pytest.raises(error, match="ancestry_attention"):
        ba.ancestry_attention_cuda(**change(_valid()))


@pytest.mark.parametrize("beams", [1, 8, 9, 17])
def test_kernel_wrapper_takes_any_beam_count(beams):
    """K4's wrapper checks pass at any beam count up to ``MAX_BEAMS``,
    past a block's 8 too: CPU tensors then raise only for their device."""
    with pytest.raises(ValueError, match="CUDA tensors"):
        ba.ancestry_attention_cuda(**_valid(batch=1, beams=beams))


@pytest.mark.parametrize("beams", [8, 9])
def test_dispatcher_sends_every_beam_count_off_the_cpu_to_k4(beams, monkeypatch):
    """Off the CPU the dispatcher calls K4 at any beam count and never the
    plain version (here on the meta device, with a stand-in for the kernel
    that records its calls)."""
    calls = []
    monkeypatch.setattr(ba, "ancestry_attention_cuda", lambda q, *args: calls.append(q.shape) or torch.empty_like(q))
    monkeypatch.setattr(ba, "ancestry_attention_plain", lambda *args: pytest.fail("the plain version ran"))
    batch, heads, head_dim, max_len, length = 2, 4, 16, 12, 7
    q = torch.empty((batch * beams, 1, heads, head_dim), device="meta")
    k = torch.empty((batch * beams, max_len, heads, head_dim), device="meta")
    anc = torch.zeros((batch, beams, max_len), dtype=torch.int32, device="meta")
    mask = torch.ones((batch * beams, max_len), dtype=torch.bool, device="meta")
    out = ba.ancestry_attention(q, k, torch.empty_like(k), anc, mask, length)
    assert out.shape == q.shape and out.device.type == "meta"
    assert calls == [q.shape]
