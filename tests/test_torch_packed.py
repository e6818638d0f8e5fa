"""The port's batched and packed (continuous-batching) decode vs the JAX
package, on the CPU at tiny dims (d_model 32, 2 + 2 layers, vocab 128, 8
mels, 48-frame windows; random weights from one numpy seed, converted).

``WhisperGenerator.generate_packed`` takes the cases of
``tests/test_packed_decode.py``, the two with the weight-only int8 decoder
included: every case holds
the port's ``(order, tokens, segments)`` to the JAX package's, exactly, and
the port's ``slots=N`` to its own ``slots=1``.  The JAX outputs are made
once, in a module fixture.  Then ``CBWhisper.run_test(batch_size=2)``
(``forward_batch``) and ``run_test(packed=True, batch_size=2)``
(``forward_packed``) against JAX (transcripts, keywords, entity recall and
its CIs, the CIs within one process), the int8 calibration rows of a
launch with vacant slots against JAX ``_calib_rows``, and the fixed-width
prompt layout of ``prepare_decoder_input_ids`` against JAX over prompt
shapes."""

import time

import numpy as np
import pytest
import torch

from enhance_cb_whisper_tpu.catalog import KeywordCatalog as JaxCatalog
from enhance_cb_whisper_tpu.decoding import prompt as jax_prompt
from enhance_cb_whisper_tpu.decoding.generate import GenerationOptions as JaxOptions
from enhance_cb_whisper_tpu.decoding.generate import WhisperGenerator as JaxGenerator
from enhance_cb_whisper_tpu.models.cb_whisper import CBWhisper as JaxCBWhisper
from enhance_cb_whisper_tpu.models.cb_whisper import CBWhisperConfig as JaxCBConfig
from enhance_cb_whisper_tpu.models.kws import KWSModel as JaxKWS
from enhance_cb_whisper_tpu.models.resnet import ResNetConfig as JaxResNetConfig
from enhance_cb_whisper_tpu.models.whisper import WhisperConfig as JaxWhisperConfig
from enhance_cb_whisper_tpu.models.whisper import init_whisper_params
from enhance_cb_whisper_tpu_torch.catalog.database import KeywordCatalog
from enhance_cb_whisper_tpu_torch.convert import from_jax_whisper_params
from enhance_cb_whisper_tpu_torch.decoding import prompt as port_prompt
from enhance_cb_whisper_tpu_torch.decoding.generate import GenerationOptions, WhisperGenerator
from enhance_cb_whisper_tpu_torch.models.cb_whisper import CBWhisper, CBWhisperConfig
from enhance_cb_whisper_tpu_torch.models.kws import init_kws_model
from enhance_cb_whisper_tpu_torch.models.resnet import ResNetConfig
from enhance_cb_whisper_tpu_torch.models.whisper import WhisperConfig, encoder_kws_stack, precompute_cross_kv
from enhance_cb_whisper_tpu_torch.runtime import profiler

CFG = dict(
    vocab_size=128, num_mel_bins=8, d_model=32,
    encoder_layers=2, encoder_attention_heads=4,
    decoder_layers=2, decoder_attention_heads=4,
    encoder_ffn_dim=64, decoder_ffn_dim=64,
    max_source_positions=24, max_target_positions=40,
    decoder_start_token_id=3, eos_token_id=2, pad_token_id=0,
)
OPTS = dict(
    decoder_start_token_id=3, language_token_id=None, task_token_id=None,
    no_timestamps_token_id=100, prev_sot_token_id=99, eos_token_id=2, pad_token_id=0,
    max_initial_timestamp_index=10, return_timestamps=True, max_target_positions=40,
)
TS_BEGIN = OPTS["no_timestamps_token_id"] + 1
INT8_DECODE = dict(vocab_int8=True, decoder_int8=True)  # the weight-only int8 serving decode
LANGS = tuple(range(4, 99, 3))  # "language" tokens of the tiny vocab


def whisper_params(seed: int = 0):
    """Random weights whose transcripts depend on the mel and whose seek
    moves by whole windows and by parts of them: the encoder's convolutions
    ×10 and the cross-attention output ×4 (a plain random encoder's output
    is nearly all position embedding, so every utterance would decode the
    same tokens), the timestamp rows of the embedding ×0.5 (a plain random
    decoder closes a timestamp pair every few tokens and crawls)."""
    params = init_whisper_params(np.random.default_rng(seed), JaxWhisperConfig(**CFG))
    params["encoder"]["conv1"]["weight"] *= 10.0
    params["encoder"]["conv2"]["weight"] *= 10.0
    for layer in params["decoder"]["layers"]:
        layer["encoder_attn"]["out_proj"]["weight"] *= 4.0
    params["decoder"]["embed_tokens"]["weight"][TS_BEGIN:] *= 0.5
    return params


def mels(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, 8, t)).astype(np.float32) for t in lengths]


def spotter(input_features, start_of_prev=False):
    """Keyword prompts whose LENGTH varies with the mel: the co-scheduling
    hazard the fixed-width layout neutralizes.  Reads a mel's first 48
    frames to 2 decimals, so both packages see the same lengths."""
    out = []
    for row in np.asarray(input_features):
        h = int(round(float(np.abs(row).sum()), 2) * 997) % 5
        out.append([20 + (h + j) % 30 for j in range(h)])
    return out


# name -> (mel lengths, mel seed, slots, option overrides, generate_packed kwargs)
CASES = {
    "no_context_beams1": ([60, 130, 200, 90, 130], 1, 2, dict(num_beams=1), {}),
    "no_context_beams2": ([60, 130, 200, 90, 130], 1, 2, dict(num_beams=2), {}),
    "conditioning_slots2": ([60, 130, 200, 90, 130], 2, 2, dict(condition_on_prev_tokens=True), {}),
    "conditioning_slots3": ([60, 130, 200, 90, 130], 2, 3, dict(condition_on_prev_tokens=True), {}),
    "conditioning_beams2_slots3": ([60, 130, 200], 2, 3,
                                   dict(num_beams=2, condition_on_prev_tokens=True), {}),
    "spotting": ([130, 60, 200], 3, 2, dict(condition_on_prev_tokens=True),
                 dict(keyword_spotting=spotter)),
    # a ladder of two temperature-0 rungs that always falls back: the
    # vacant rows must not change the real rows' outcome
    "more_slots_than_stream": ([60, 130], 4, 4,
                               dict(condition_on_prev_tokens=True, logprob_threshold=0.0,
                                    temperature=(0.0, 0.0)), {}),
    "return_segments": ([130, 60], 7, 2, {}, dict(return_segments=True)),
    "refill_keeps_width": ([60, 200, 60, 60, 60], 8, 2, {}, {}),
    "single_window": ([30, 40], 15, 2, {}, {}),
    "no_spotter_prev_budget": ([130], 16, 1, dict(condition_on_prev_tokens=True), {}),
    "with_spotter_prev_budget": ([130], 16, 1, dict(condition_on_prev_tokens=True),
                                dict(keyword_spotting=spotter)),
}


def _options(cls, overrides):
    return cls(**{**OPTS, "num_beams": 1, **overrides})


def _plain(result):
    """(tokens, [(start, end, tokens) per segment]) of one packed result."""
    if isinstance(result, dict):
        segs = [(s["start"], s["end"], list(map(int, s["tokens"]))) for s in result["segments"]]
        return list(map(int, result["sequences"])), segs
    return list(map(int, result)), None


def _packed(gen, stream, opts, slots, **kwargs):
    return {order: _plain(result) for order, result in gen.generate_packed(stream, opts, slots=slots, **kwargs)}


def _stream(lengths, seed):
    return ((m, None) for m in mels(lengths, seed))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's generator (one prompt bucket: every prompt reuses
    one compiled program family and padding changes no token) and its
    outputs for every case."""
    params = whisper_params()
    jgen = JaxGenerator(JaxWhisperConfig(**CFG), params, prompt_buckets=(CFG["max_target_positions"],))
    out = {}
    for name, (lengths, seed, slots, overrides, kwargs) in CASES.items():
        out[name] = _packed(jgen, _stream(lengths, seed), _options(JaxOptions, overrides), slots, **kwargs)
    # a zero-length utterance between two real ones
    zero_stream = [(m, None) for m in mels([60, 130], 5)]
    zero_stream.insert(1, (np.zeros((1, 8, 50), np.float32), np.zeros((1, 50), np.int32)))
    out["zero_length"] = _packed(jgen, iter(zero_stream), _options(JaxOptions, {}), 2)
    # an attention-mask prefix bounds the seek loop
    [mel] = mels([130], 6)
    padded = np.zeros((1, 8, 200), np.float32)
    padded[:, :, :130] = mel
    mask = np.zeros((1, 200), np.int32)
    mask[:, :130] = 1
    out["mask_prefix"] = (padded, mask, _packed(jgen, iter([(padded, mask)]), _options(JaxOptions, dict(num_beams=2)), 2))
    # the fixed-batch seek loop: HF layout and row-0 gate, as before
    batch, attn = _right_padded(mels([200, 60], 10))
    out["fixed_batch"] = (batch, attn, jgen.generate(batch, _options(JaxOptions, dict(num_beams=2)),
                                                     attention_mask=attn, return_segments=True))
    batch1, attn1 = _right_padded(mels([30, 40], 15))
    out["fixed_batch_single_window"] = (batch1, attn1, jgen.generate(
        batch1, _options(JaxOptions, {}), attention_mask=attn1, return_segments=True))
    # language detection from each row's first window, rows of unequal length
    out["detect_language"] = jgen.detect_language(_right_padded(mels([30, 130, 60, 90], 21))[0],
                                                  _options(JaxOptions, dict(lang_token_ids=LANGS)))
    # the swapped-in checkpoint's decode, then the first checkpoint's again
    [mel] = mels([130], 13)
    opts = _options(JaxOptions, dict(num_beams=2, condition_on_prev_tokens=True))
    jgen.swap_params(whisper_params(1))
    out["swapped"] = jgen.generate(mel, opts, return_segments=True)
    jgen.swap_params(params)
    out["swapped_back"] = jgen.generate(mel, opts, return_segments=True)
    # the packed cases of the weight-only int8 decode (JAX's
    # test_packed_composes_with_int8_decoder, test_swap_params_int8_requantizes)
    int8 = JaxGenerator(JaxWhisperConfig(**CFG), params, prompt_buckets=(CFG["max_target_positions"],),
                        **INT8_DECODE)
    out["int8_packed"] = _packed(int8, _stream([130, 60], 12), _options(
        JaxOptions, dict(condition_on_prev_tokens=True)), 2)
    int8.swap_params(whisper_params(1))
    [mel] = mels([60], 14)
    out["int8_swapped"] = int8.generate(mel, _options(JaxOptions, {}), return_segments=True)
    return out


@pytest.fixture(scope="module")
def port_gen():
    return WhisperGenerator(WhisperConfig(**CFG), from_jax_whisper_params(whisper_params(), device="cpu"),
                            device="cpu")


def _right_padded(ms):
    t_max = max(m.shape[-1] for m in ms)
    batch = np.zeros((len(ms), 8, t_max), np.float32)
    attn = np.zeros((len(ms), t_max), np.int32)
    for i, m in enumerate(ms):
        batch[i, :, : m.shape[-1]] = m[0]
        attn[i, : m.shape[-1]] = 1
    return batch, attn


def _spy(monkeypatch, gen, name, record):
    real = getattr(gen, name)

    def spied(*args, **kwargs):
        record(*args, **kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(gen, name, spied)


@pytest.mark.parametrize("case", list(CASES))
def test_generate_packed_matches_jax(jax_run, port_gen, case, monkeypatch):
    lengths, seed, slots, overrides, kwargs = CASES[case]
    opts = _options(GenerationOptions, overrides)
    record = {"widths": [], "plens": [], "decodes": []}
    _spy(monkeypatch, port_gen, "_run_longform_window", lambda rows, *a, **k: record["widths"].append(len(rows)))
    _spy(monkeypatch, port_gen, "_generate_with_fallback",
         lambda cross_kv, ids, *a, **k: record["plens"].append(ids.shape[1]))
    _spy(monkeypatch, port_gen, "_decode_prompted",
         lambda cross_kv, ids, *a, **k: record["decodes"].append(ids.shape[0]))
    got = _packed(port_gen, _stream(lengths, seed), opts, slots, **kwargs)
    widths, plens, decodes = record["widths"], record["plens"], record["decodes"]
    record = {"widths": [], "plens": [], "decodes": []}  # the solo runs' below
    assert got == jax_run[case]
    assert sorted(got) == list(range(len(lengths)))
    # every window launches at the full slot width, and with context every
    # prompt has one width (the port's stand-in for JAX's one prompt bucket)
    assert widths and all(w == slots for w in widths), widths
    if opts.condition_on_prev_tokens or kwargs.get("keyword_spotting"):
        assert len(set(plens)) == 1, plens
    # schedule independence: each utterance alone gives the same tokens
    for order, m in enumerate(mels(lengths, seed)):
        solo = _packed(port_gen, iter([(m, None)]), opts, 1, **kwargs)
        assert solo[0] == got[order], (case, order)

    if case == "more_slots_than_stream":
        # every window falls back once, and vacant rows never reach the
        # second rung
        assert decodes[::2] == [slots] * len(widths) and all(0 < n <= 2 for n in decodes[1::2]), decodes
    if case.startswith("no_context") or case in ("refill_keeps_width", "return_segments"):
        # no spotting, no conditioning: equal to the plain batch-1 decode
        for order, m in enumerate(mels(lengths, seed)):
            res = port_gen.generate(torch.from_numpy(m), opts, return_segments=True)
            flat = [int(t) for s in res["segments"][0] for t in s["tokens"]]
            assert flat == got[order][0], (case, order)
    if case.endswith("prev_budget"):
        cut = CFG["max_target_positions"] // 2 - 1
        w_kw = (cut * 3) // 4 - 1
        # sot + FULL prev budget + init without a spotter; sot + keyword
        # budget + the rest of the prev budget + init with one
        assert plens[0] == (1 + cut + 1 if case.startswith("no_") else 1 + w_kw + (cut - w_kw - 1) + 1)


@pytest.mark.parametrize("case", ["refill_keeps_width", "more_slots_than_stream"])
def test_window_span_per_launch(port_gen, case, monkeypatch):
    """One ``ecw.scheduler.window`` span per launch, its id the stream
    orders of the occupied slots (fewer than ``slots`` where some are
    vacant) and ``slots`` the launch's width."""
    lengths, seed, slots, overrides, kwargs = CASES[case]
    launches = []
    _spy(monkeypatch, port_gen, "_run_longform_window",
         lambda rows, *a, **k: launches.append(tuple(r.order for r in rows if r is not None)))
    t0 = time.perf_counter()
    _packed(port_gen, _stream(lengths, seed), _options(GenerationOptions, overrides), slots, **kwargs)
    windows = [s for s in profiler.spans(since_s=t0) if s["name"] == "ecw.scheduler.window"]
    assert [s["id"] for s in windows] == launches and len(launches) > 1
    # the launch's width, and the bytes of the decoder caches it allocated
    # (their values: test_torch_profiler.py)
    assert all(s["attrs"]["slots"] == slots and s["attrs"]["self_kv_bytes"] > 0 and s["attrs"]["cross_kv_bytes"] > 0
               and set(s["attrs"]) == {"slots", "self_kv_bytes", "cross_kv_bytes"} for s in windows)
    if case == "more_slots_than_stream":
        assert all(len(ids) < slots for ids in launches), launches


def test_zero_length_utterance(jax_run, port_gen):
    stream = [(m, None) for m in mels([60, 130], 5)]
    stream.insert(1, (np.zeros((1, 8, 50), np.float32), np.zeros((1, 50), np.int32)))
    got = _packed(port_gen, iter(stream), _options(GenerationOptions, {}), 2)
    assert got == jax_run["zero_length"]
    assert got[1] == ([], None) and len(got[0][0]) > 0 and len(got[2][0]) > 0


def test_attention_mask_prefix(jax_run, port_gen):
    padded, mask, want = jax_run["mask_prefix"]
    opts = _options(GenerationOptions, dict(num_beams=2))
    got = _packed(port_gen, iter([(padded, mask)]), opts, 2)
    assert got == want
    res = port_gen.generate(torch.from_numpy(padded[:, :, :130].copy()), opts, return_segments=True)
    assert got[0][0] == [int(t) for s in res["segments"][0] for t in s["tokens"]]


@pytest.mark.parametrize("case", ["fixed_batch", "fixed_batch_single_window"])
def test_fixed_batch_longform_unchanged(jax_run, port_gen, case):
    """The fixed-batch seek loop keeps the HF layout and row-0 gate; with
    no context each row equals its own decode (a batch of single-window
    utterances takes the seek loop too)."""
    batch, attn, want = jax_run[case]
    opts = _options(GenerationOptions, dict(num_beams=2) if case == "fixed_batch" else {})
    got = port_gen.generate(torch.from_numpy(batch), opts, attention_mask=attn, return_segments=True)
    np.testing.assert_array_equal(got["sequences"], want["sequences"])
    assert [[s["tokens"] for s in row] for row in got["segments"]] == \
        [[s["tokens"] for s in row] for row in want["segments"]]
    for i in range(batch.shape[0]):
        solo = _packed(port_gen, iter([(batch[i:i + 1, :, : attn[i].sum()], None)]), opts, 1)
        assert solo[0][0] == [int(t) for s in got["segments"][i] for t in s["tokens"]]


def test_detect_language_matches_jax(jax_run, port_gen):
    batch = _right_padded(mels([30, 130, 60, 90], 21))[0]
    got = port_gen.detect_language(torch.from_numpy(batch), _options(GenerationOptions, dict(lang_token_ids=LANGS)))
    np.testing.assert_array_equal(got, jax_run["detect_language"])
    assert set(got.tolist()) <= set(LANGS) and len(set(got.tolist())) > 1


def test_swap_params(jax_run):
    """A swap decodes under the new weights (as JAX's swap does), a swap
    back gives the first weights' tokens again, and a checkpoint of another
    architecture is refused and leaves the weights as they were."""
    gen = WhisperGenerator(WhisperConfig(**CFG), from_jax_whisper_params(whisper_params(), device="cpu"),
                           device="cpu")
    [mel] = mels([130], 13)
    opts = _options(GenerationOptions, dict(num_beams=2, condition_on_prev_tokens=True))

    def tokens(result):
        return [[s["tokens"] for s in row] for row in result["segments"]]

    before = gen.generate(torch.from_numpy(mel), opts, return_segments=True)
    gen.swap_params(from_jax_whisper_params(whisper_params(1), device="cpu"))
    swapped = gen.generate(torch.from_numpy(mel), opts, return_segments=True)
    assert tokens(swapped) == tokens(jax_run["swapped"]) != tokens(before)
    gen.swap_params(from_jax_whisper_params(whisper_params(), device="cpu"))
    back = gen.generate(torch.from_numpy(mel), opts, return_segments=True)
    assert tokens(back) == tokens(before) == tokens(jax_run["swapped_back"])

    other = dict(CFG, d_model=16, encoder_ffn_dim=32, decoder_ffn_dim=32)
    bad = from_jax_whisper_params(init_whisper_params(np.random.default_rng(7), JaxWhisperConfig(**other)),
                                  device="cpu")
    params = gen.params
    with pytest.raises(ValueError, match="architecture mismatch"):
        gen.swap_params(bad)
    wrong_dtype = from_jax_whisper_params(whisper_params(), device="cpu")
    wrong_dtype["decoder"]["embed_tokens"]["weight"] = wrong_dtype["decoder"]["embed_tokens"]["weight"].double()
    with pytest.raises(ValueError, match="architecture mismatch"):
        gen.swap_params(wrong_dtype)
    assert gen.params is params


def test_packed_composes_with_int8_decoder(jax_run):
    """Packed scheduling under the weight-only int8 decode: slots=2 equals
    slots=1 per utterance, and both equal the JAX package's."""
    gen = WhisperGenerator(WhisperConfig(**CFG), from_jax_whisper_params(whisper_params(), device="cpu"),
                           device="cpu", **INT8_DECODE)
    opts = _options(GenerationOptions, dict(condition_on_prev_tokens=True))
    ms = mels([130, 60], 12)
    packed = _packed(gen, ((m, None) for m in ms), opts, 2)
    solo = {i: _packed(gen, iter([(m, None)]), opts, 1)[0] for i, m in enumerate(ms)}
    assert packed == solo == jax_run["int8_packed"]
    assert all(len(tokens) > 4 for tokens, _ in packed.values())


def test_swap_params_int8_requantizes(jax_run):
    """``swap_params`` replays the constructor's int8 quantization: an int8
    generator swapped to a new checkpoint decodes as a fresh int8 generator
    on it, and as the JAX package's swapped one."""
    ported = {seed: from_jax_whisper_params(whisper_params(seed), device="cpu") for seed in (0, 1)}
    gen = WhisperGenerator(WhisperConfig(**CFG), ported[0], device="cpu", **INT8_DECODE)
    fresh = WhisperGenerator(WhisperConfig(**CFG), ported[1], device="cpu", **INT8_DECODE)
    [mel] = mels([60], 14)
    opts = _options(GenerationOptions, {})

    def tokens(g):
        result = g.generate(torch.from_numpy(mel), opts, return_segments=True)
        return [[list(map(int, s["tokens"])) for s in row] for row in result["segments"]]

    before = tokens(gen)
    gen.swap_params(ported[1])
    assert "qweight" in gen.params["decoder"]["layers"][0]["fc1"] and "embed_tokens_q" in gen.params["decoder"]
    want = [[list(map(int, s["tokens"])) for s in row] for row in jax_run["int8_swapped"]["segments"]]
    assert tokens(gen) == tokens(fresh) == want != before


def test_rows_get_their_own_bits():
    """A batch's encoder output, KWS stack, cross K/V, prefill logits and
    prefilled cache give each segment the bits it gets alone.  Packed
    decode's schedule independence on the card rests on it: cuBLAS picks
    its kernels by the batch (at these dims the CPU's batched GEMMs give
    other bits too)."""
    cfg = WhisperConfig(**CFG)
    params = from_jax_whisper_params(whisper_params(), device="cpu")
    gen = WhisperGenerator(cfg, params, device="cpu")
    x = torch.from_numpy(np.concatenate(mels([48, 48, 48], 30)))
    stack, enc = encoder_kws_stack(params, x, cfg, layer_slice=(1, 3), return_encoding=True)
    cross_kv = precompute_cross_kv(params, enc, cfg)
    prompt = torch.tensor([[3, 20, 21], [3, 30, 31], [3, 40, 41]]).repeat_interleave(2, dim=0)
    cache, logits = gen._prefill(prompt, gen._make_ctx(cross_kv, np.ones((3, 3), np.int64), 40, 2), 40)
    for i in range(3):
        stack1, enc1 = encoder_kws_stack(params, x[i : i + 1], cfg, layer_slice=(1, 3), return_encoding=True)
        assert torch.equal(stack[i], stack1[0]) and torch.equal(enc[i], enc1[0])
        cross_kv1 = precompute_cross_kv(params, enc1, cfg)
        assert all(torch.equal(a[n][i], b[n][0]) for a, b in zip(cross_kv, cross_kv1) for n in ("k", "v"))
        rows = slice(2 * i, 2 * i + 2)
        cache1, logits1 = gen._prefill(prompt[rows], gen._make_ctx(cross_kv1, np.ones((1, 3), np.int64), 40, 2), 40)
        assert torch.equal(logits[rows], logits1)
        assert all(torch.equal(a[n][rows], b[n]) for a, b in zip(cache["layers"], cache1["layers"]) for n in ("k", "v"))


# ------------------------------------------------------------ prompt layout


@pytest.mark.parametrize("condition_on_prev, fixed_keywords", [(True, True), (False, True), (True, False)])
@pytest.mark.parametrize("seed", range(3))
def test_fixed_width_prompt_matches_jax(condition_on_prev, fixed_keywords, seed):
    """``prepare_decoder_input_ids(fixed_width=True)`` over random keyword
    and previous-text lengths (empty, short, past their budget), per-row
    init tokens, and rows without history."""
    rng = np.random.default_rng(seed)
    for _ in range(40):
        batch = int(rng.integers(1, 5))
        keywords = [[int(t) for t in rng.integers(4, 99, int(rng.choice([0, 2, 9, 30])))]
                    for _ in range(batch)]
        prev = [None if rng.random() < 0.3 else [int(t) for t in rng.integers(4, 99, int(rng.choice([0, 3, 25, 80])))]
                for _ in range(batch)]
        init = [3, 10, 11] if rng.random() < 0.5 else [[3, int(rng.integers(10, 14)), 11] for _ in range(batch)]
        kwargs = dict(
            init_tokens=init, keywords_tokens=keywords,
            prev_tokens_per_batch=prev if rng.random() < 0.8 else None,
            condition_on_prev=condition_on_prev, max_target_positions=int(rng.choice([40, 448])),
            pad_token_id=0, prev_sot_token_id=99, fixed_width=True, fixed_keywords=fixed_keywords,
        )
        want_ids, want_mask = jax_prompt.prepare_decoder_input_ids(**kwargs)
        got_ids, got_mask = port_prompt.prepare_decoder_input_ids(**kwargs)
        np.testing.assert_array_equal(got_ids, want_ids)
        if want_mask is None:
            assert got_mask is None
        else:
            np.testing.assert_array_equal(got_mask, want_mask)


# --------------------------------------------------------------- CBWhisper

KEYWORDS = ["alpha", "beta", "gamma", "delta"]
OUT = (32, 48)
RESNET = dict(num_channels=2, embedding_size=8, hidden_sizes=(8, 16, 24, 32), depths=(1, 1, 1, 1),
              num_labels=2)


def prompt_ids_fn(text):
    return [99] + [10 + (ord(c) % 50) for c in text][:6]


def decode_fn(tokens):
    return " ".join(f"w{t}" for t in tokens if 4 < t < 99)


def flax_variables(model):
    """A torch KWSModel's weights as the flax tree of the JAX KWSModel
    (flax's own init of this ResNet costs ~30 s of eager ops here)."""
    params, stats = {}, {}
    for key, t in model.state_dict().items():
        *path, leaf = key.split(".")
        a = t.numpy()
        if leaf == "num_batches_tracked":
            continue
        if leaf.startswith("running_"):
            tree, path = stats, path + [{"running_mean": "mean", "running_var": "var"}[leaf]]
        else:
            tree = params
            if leaf == "bias":
                path = path + ["bias"]
            elif a.ndim == 4:
                path, a = path + ["kernel"], a.transpose(2, 3, 1, 0)
            elif a.ndim == 2:
                path, a = path + ["kernel"], a.T
            else:
                path = path + ["scale"]
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.ascontiguousarray(a)
    return {"params": params, "batch_stats": stats}


def cb_pipelines(params=None):
    """A JAX CBWhisper and its port on the CPU: the tiny Whisper above
    (beam 2, timestamps, condition-on-prev), four keywords of 2-layer
    stacks, and a tiny random ResNet whose class-1 bias sits in the widest
    gap of the keywords' margins on the test mels, so that the spotter
    passes some keywords and not others."""
    params = whisper_params() if params is None else params
    opts = dict(OPTS, num_beams=2, condition_on_prev_tokens=True)
    rng = np.random.default_rng(3)
    stacks = []
    for _ in KEYWORDS:
        s = rng.standard_normal((2, int(rng.integers(2, 6)), CFG["d_model"])).astype(np.float32)
        stacks.append(s / np.linalg.norm(s, axis=-1, keepdims=True))
    kws = init_kws_model(ResNetConfig(**RESNET), torch.Generator().manual_seed(0))
    port_cb = CBWhisper(
        config=CBWhisperConfig(kws_features_size=OUT, keywords_per_group=2), whisper_config=WhisperConfig(**CFG),
        whisper_params=from_jax_whisper_params(params, device="cpu"), kws_model=kws,
        catalog=KeywordCatalog.from_arrays(KEYWORDS, stacks, group_size=2),
        generation_options=GenerationOptions(**opts),
        prompt_ids_fn=prompt_ids_fn, decode_fn=decode_fn, kws_layer_slice=(1, 3), device="cpu",
    )
    port_cb._ensure_catalog()
    margins = []
    with torch.no_grad():
        for item in cb_dataset():
            segment = port_cb.generator._pad_segment(torch.from_numpy(item["mel"][:, :, :48]))
            stack = encoder_kws_stack(port_cb.encoder_params, segment, port_cb.encoder_config, layer_slice=(1, 3))
            logits = port_cb._score_fn(port_cb._catalog_dev, stack[0], port_cb._utt_w)[1][: len(KEYWORDS)]
            margins.extend((logits[:, 1] - logits[:, 0]).tolist())
        m = np.sort(margins)
        gap = max(range(len(m) // 4, len(m) - len(m) // 4 - 1), key=lambda i: m[i + 1] - m[i])
        kws.model.classifier.bias[1] -= float(m[gap] + m[gap + 1]) / 2
    jkws = JaxKWS(JaxResNetConfig(**RESNET))
    jax_cb = JaxCBWhisper(
        config=JaxCBConfig(kws_features_size=OUT, keywords_per_group=2), whisper_config=JaxWhisperConfig(**CFG),
        whisper_params=params, kws_model=jkws, kws_variables=flax_variables(kws),
        catalog=JaxCatalog.from_arrays(KEYWORDS, stacks, group_size=2), generation_options=JaxOptions(**opts),
        prompt_ids_fn=prompt_ids_fn, decode_fn=decode_fn, kws_layer_slice=(1, 3),
    )
    return jax_cb, port_cb


def cb_dataset():
    """Five utterances of 0.6-4 windows (mels made directly: ``mel_fn``
    returns them), two speakers."""
    items = []
    for i, m in enumerate(mels([130, 60, 200, 90, 30], 21)):
        items.append({
            "mel": m,
            "transcript": "w12 w30 w44 w61",
            "hotword_labels": np.array([1, 0, 0, 1]),
            "speaker": f"s{i % 2}",
            "keywords": [{"mention": "w30", "total_offset": 4, "end_offset": 7},
                         {"mention": "w61", "total_offset": 12, "end_offset": 15}],
        })
    return items


def _record_keywords(monkeypatch, cb, sink):
    real = cb._score_to_keywords

    def recorded(*args, **kwargs):
        out = real(*args, **kwargs)
        sink.extend(out)
        return out

    monkeypatch.setattr(cb, "_score_to_keywords", recorded)


@pytest.fixture(scope="module")
def cb_pair():
    return cb_pipelines()


@pytest.mark.parametrize("packed", [False, True])
def test_run_test_batched_matches_jax(cb_pair, packed, monkeypatch):
    """``run_test(batch_size=2)`` (``forward_batch``) and
    ``run_test(packed=True, batch_size=2)`` (``forward_packed``) give the
    JAX package's transcripts, keywords per scored segment, entity recall
    and CIs; packed, each utterance's transcript is its own slots=1 one."""
    jax_cb, port_cb = cb_pair
    dataset = cb_dataset()
    jax_kw, port_kw, jax_preds, port_preds = [], [], [], []
    _record_keywords(monkeypatch, jax_cb, jax_kw)
    _record_keywords(monkeypatch, port_cb, port_kw)
    want = jax_cb.run_test(dataset, lambda item: (item["mel"], None), num_bootstraps=20,
                           batch_size=2, packed=packed, predictions_out=jax_preds)
    got = port_cb.run_test(dataset, lambda item: (torch.from_numpy(item["mel"]), None), num_bootstraps=20,
                           batch_size=2, packed=packed, predictions_out=port_preds)
    assert port_preds == jax_preds and len(port_preds) == len(dataset) and all(port_preds)
    assert len(set(port_preds)) > 1
    for key in ("Entity Recall", "Entity Recall LB", "Entity Recall UB"):
        assert got[key] == want[key], key
    assert got["RTFx"] > 0
    assert port_kw == jax_kw
    spotted = {len(k) for k in port_kw}
    assert max(spotted) > 0 and min(spotted) < len(KEYWORDS), port_kw
    if packed:
        monkeypatch.undo()
        solo = [dict(port_cb.forward_packed(iter([(item["mel"], None)]), slots=1))[0] for item in dataset]
        assert port_preds == solo


def test_int8_calibration_skips_vacant_slots(cb_pair, monkeypatch):
    """One 3-window utterance through 4 slots: every window has 3 vacant
    zero-mel rows, and the calibration set takes only the real rows, the
    rows JAX ``_calib_rows`` picks (4 slots of zero rows would have
    completed a 4-segment calibration in the first window)."""
    jax_cb, port_cb = cb_pair
    picked = []
    real = CBWhisper._calib_rows

    def recorded(n_seg, needed, real_rows=None):
        rows = real(n_seg, needed, real_rows)
        assert rows == JaxCBWhisper._calib_rows(n_seg, needed, real_rows)
        picked.append((n_seg, tuple(real_rows) if real_rows is not None else None, rows))
        return rows

    monkeypatch.setattr(CBWhisper, "_calib_rows", staticmethod(recorded))
    [mel] = mels([130], 950)
    try:
        port_cb.enable_int8_spotting(calibration_batches=4)
        jax_cb.enable_int8_spotting(calibration_batches=4)
        got = dict(port_cb.forward_packed(iter([(mel, None)]), slots=4))
        want = dict(jax_cb.forward_packed(iter([(mel, None)]), slots=4))
        assert got == want and got[0]
        assert picked == [(4, (True, False, False, False), [0])] * 3
        assert port_cb._int8_pending, "calibration completed early: zero rows leaked in"
        assert len(port_cb._int8_calib_stacks) == 3
        np.testing.assert_allclose(np.stack(port_cb._int8_calib_stacks), np.stack(jax_cb._int8_calib_stacks),
                                   rtol=1e-4, atol=1e-5)
    finally:  # back to the fp32 scorer for the other cases
        port_cb._int8_pending = jax_cb._int8_pending = False
