"""The port's longform generation vs the JAX package: the seek loop,
condition-on-prev prompts, language detection per row, the spotting hook
per window, no-speech skips and the temperature-fallback ladder with its
sampled rungs (JAX's own Gumbel draws injected into the port), over a tiny
random Whisper (one numpy seed, converted weights).

Held exact: sequences, segment tokens and seeks; segment times to 1e-9;
the host-side helpers field for field over seeded fuzz cases; the greedy
logprob sum of a sampled decode within 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhance_cb_whisper_tpu.decoding import generate as jgen_mod
from enhance_cb_whisper_tpu.decoding.generate import GenerationOptions as JaxOptions
from enhance_cb_whisper_tpu.decoding.generate import WhisperGenerator as JaxGenerator
from enhance_cb_whisper_tpu.decoding.prompt import prepare_decoder_input_ids
from enhance_cb_whisper_tpu.models import whisper as jw
from enhance_cb_whisper_tpu_torch.convert import from_jax_whisper_params
from enhance_cb_whisper_tpu_torch.decoding import generate as tgen_mod
from enhance_cb_whisper_tpu_torch.decoding.generate import GenerationOptions, WhisperGenerator
from enhance_cb_whisper_tpu_torch.models import whisper as tw

VOCAB, NO_TS = 128, 100  # timestamps are ids 101..127
TS_BEGIN = NO_TS + 1
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
    return_timestamps=True, condition_on_prev_tokens=True,
)
FRAMES = 7400  # 2.47 windows of 3000 frames


def _params():
    """Random weights whose decoder emits eos and timestamps often enough
    that a window ends early and seeks move by whole and by partial
    windows (a plain random decoder emits a timestamp pair every few
    tokens and crawls through the audio 0.5 s a window)."""
    params = jw.init_whisper_params(np.random.default_rng(0), jw.WhisperConfig(**CFG))
    params["decoder"]["embed_tokens"]["weight"][TS_BEGIN:] *= 0.5
    params["decoder"]["embed_tokens"]["weight"][CFG["eos_token_id"]] *= 3.0
    return params


@pytest.fixture(scope="module")
def generators():
    params = _params()
    # one prompt bucket (the whole 40-token budget): every window's prompt
    # reuses the same compiled JAX programs; bucketing pads the prompt and
    # changes no token
    jgen = JaxGenerator(jw.WhisperConfig(**CFG), params, prompt_buckets=(CFG["max_target_positions"],))
    tgen = WhisperGenerator(tw.WhisperConfig(**CFG), from_jax_whisper_params(params, device="cpu"),
                            device="cpu")
    return jgen, tgen


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's decode steps are tiny: one intra-op thread each keeps them
    fast when the test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_gumbel(rung, segment_idx, cur_len, shape):
    """The JAX package's draws for one sampled step: the key of rung
    ``rung`` at window ``segment_idx`` (generate.py:1068), folded with the
    step (beam.py:411-414)."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(rung), segment_idx), cur_len)
    return torch.from_numpy(np.array(jax.random.gumbel(key, shape, jnp.float32)))


# ------------------------------------------------------------ host helpers


def _random_seek_sequence(rng):
    """Token runs of text (4..98) and timestamps (101..127) in the shapes
    the decoder gives: pairs, singles, a single-timestamp ending, a
    closing pair at position 0, no timestamp at all, empty."""
    kind = rng.integers(0, 6)
    n = int(rng.integers(0, 14))
    seq = []
    for _ in range(n):
        if rng.random() < 0.35:
            seq.append(int(rng.integers(TS_BEGIN, VOCAB)))
        else:
            seq.append(int(rng.integers(4, 99)))
    if kind == 1:  # single timestamp ending
        seq += [int(rng.integers(4, 99)), int(rng.integers(TS_BEGIN, VOCAB))]
    elif kind == 2:  # closing pair
        seq += [int(rng.integers(TS_BEGIN, VOCAB)), int(rng.integers(TS_BEGIN, VOCAB))]
    elif kind == 3:  # closing pair at position 0: the seek would not move
        seq = [TS_BEGIN, TS_BEGIN] + seq[:3] + [TS_BEGIN, TS_BEGIN]
    elif kind == 4:  # text only
        seq = [t for t in seq if t < TS_BEGIN]
    return seq


def test_retrieve_segment_matches_jax():
    rng = np.random.default_rng(0)
    branches = set()
    for _ in range(250):
        seq = _random_seek_sequence(rng)
        offset = float(rng.choice([0.0, 30.0, rng.uniform(0, 100)]))
        # 1686 and 1756 are frame counts where float32 truncation differs
        # from an exact halving
        frames = int(rng.choice([3000, 1686, 1756, int(rng.integers(1, 3001))]))
        want = jgen_mod.WhisperGenerator._retrieve_segment(seq, offset, TS_BEGIN, frames)
        got = tgen_mod.WhisperGenerator._retrieve_segment(seq, offset, TS_BEGIN, frames)
        assert got == want, (seq, offset, frames)
        ts = np.asarray(seq) >= TS_BEGIN
        branches.add("pairs" if len(seq) > 1 and (ts[:-1] & ts[1:]).any() else "single segment")
        if len(seq) >= 2 and ts[-1] and not ts[-2]:
            branches.add("single timestamp ending")
    assert branches == {"pairs", "single segment", "single timestamp ending"}


@pytest.mark.parametrize("pad_is_eos", [False, True])
def test_trim_generated_matches_jax(pad_is_eos):
    rng = np.random.default_rng(1)
    kw = dict(eos_token_id=2, pad_token_id=2 if pad_is_eos else 0)
    jopts, topts = JaxOptions(**kw), GenerationOptions(**kw)
    for _ in range(200):
        body = rng.integers(0, 6, int(rng.integers(0, 10)))  # 0 pad, 2 eos mid-sequence too
        tail = [2] * int(rng.integers(0, 2)) + [kw["pad_token_id"]] * int(rng.integers(0, 4))
        tokens = np.asarray(list(body) + tail, np.int64)
        for keep_eos in (False, True):
            want = jgen_mod.WhisperGenerator._trim_generated(tokens, jopts, keep_eos=keep_eos)
            got = tgen_mod.WhisperGenerator._trim_generated(tokens, topts, keep_eos=keep_eos)
            assert got == want, (tokens, keep_eos)


def test_compression_ratio_matches_jax():
    rng = np.random.default_rng(2)
    for i in range(200):
        vocab = int(rng.choice([128, 300, 51865, 70000]))
        n = int(rng.integers(0, 60))
        if i % 3 == 0:  # repetitive: compresses well
            tokens = list(rng.integers(0, vocab, 3)) * (n // 3 + 1)
        else:
            tokens = list(rng.integers(0, vocab, n))
        assert tgen_mod._compression_ratio(tokens, vocab) == jgen_mod._compression_ratio(tokens, vocab)


def test_need_fallback_matches_jax(generators):
    jgen, tgen = generators
    rng = np.random.default_rng(3)
    outcomes = set()
    for _ in range(250):
        n = int(rng.integers(0, 30))
        gen = list(rng.integers(0, VOCAB, 3)) * (n // 3) if rng.random() < 0.3 else list(rng.integers(0, VOCAB, n))
        kw = dict(
            compression_ratio_threshold=rng.choice([None, 0.8, 1.2, 2.4]),
            logprob_threshold=rng.choice([None, -1.0, -0.3, 0.0]),
            no_speech_threshold=rng.choice([None, 0.3, 0.6]),
        )
        score = float(rng.uniform(-3.0, 0.0) * max(len(gen), 1))
        no_speech = float(rng.random())
        beams = int(rng.choice([1, 3]))
        want = jgen._need_fallback(gen, score, no_speech, JaxOptions(**kw), beams)
        got = tgen._need_fallback(gen, score, no_speech, GenerationOptions(**kw), beams)
        assert got == want
        outcomes.add(got)
    assert outcomes == {(False, False), (True, False), (False, True)}


def test_longform_row_and_padding_match_jax():
    jfields = [(f.name, f.default) for f in dataclasses.fields(jgen_mod._LongformRow)]
    tfields = [(f.name, f.default) for f in dataclasses.fields(tgen_mod._LongformRow)]
    assert [n for n, _ in tfields] == [n for n, _ in jfields]
    assert [d for _, d in tfields] == [d for _, d in jfields]
    for seek, max_frames in ((0, 10), (10, 10), (12, 10)):
        row_j = jgen_mod._LongformRow(features=None, max_frames=max_frames, seek=seek)
        row_t = tgen_mod._LongformRow(features=None, max_frames=max_frames, seek=seek)
        assert row_t.done == row_j.done
        assert row_t.segments == row_j.segments == [] and row_t.segments is not row_j.segments
    seqs = [[5, 6, 7], [], [8]]
    np.testing.assert_array_equal(tgen_mod.WhisperGenerator._pad_sequences_right(seqs, 0),
                                  jgen_mod.WhisperGenerator._pad_sequences_right(seqs, 0))


def test_take_rows_matches_jax(generators):
    """The ladder's retry batch: rows of the cross K/V, in the port's
    per-layer [B, T, H, Dh] layout and JAX's stacked [L, B, T, H, Dh]."""
    jgen, tgen = generators
    mel = np.random.default_rng(4).standard_normal((3, 80, 3000)).astype(np.float32)
    j_xkv = JaxGenerator._take_rows(jgen._cross_kv_fn(jgen._encode(jnp.asarray(mel))), [2, 0])
    t_xkv = tgen._take_rows(tgen._cross_kv_fn(tgen._encode(torch.from_numpy(mel))), [2, 0])
    for layer, t_layer in enumerate(t_xkv):
        for name in ("k", "v"):
            np.testing.assert_allclose(t_layer[name].numpy(), np.asarray(j_xkv[name][layer]),
                                       rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------- sampling


def test_greedy_sampling_with_jax_noise_is_token_exact(generators):
    """A sampled decode (temperature 0.7, the ladder's ``num_beams=1``
    rung) given JAX's Gumbel draws samples JAX's tokens; the logprob sum
    is of the processed scores, not divided by the temperature."""
    jgen, tgen = generators
    opts = dict(OPTS)
    jopts, topts = JaxOptions(**opts), GenerationOptions(**opts)
    ids, attn = prepare_decoder_input_ids(
        init_tokens=jopts.init_tokens(), keywords_tokens=[[99, 20, 21, 22], [99, 30]],
        prev_tokens_per_batch=None, condition_on_prev=False, max_target_positions=40,
        pad_token_id=0, prev_sot_token_id=99,
    )
    mel = np.random.default_rng(5).standard_normal((2, 80, 3000)).astype(np.float32)
    j_xkv = jgen._cross_kv_fn(jgen._encode(jnp.asarray(mel)))
    t_xkv = tgen._cross_kv_fn(tgen._encode(torch.from_numpy(mel)))
    for rung, segment_idx in ((1, 1), (2, 3)):
        rng = jax.random.fold_in(jax.random.PRNGKey(rung), segment_idx)
        j_seqs, j_scores, _ = jgen._decode_prompted(j_xkv, ids, attn, jopts, True,
                                                    temperature=0.7, rng=rng)
        t_seqs, t_scores, _ = tgen._decode_prompted(
            t_xkv, ids, attn, topts, True, temperature=0.7,
            noise=lambda cur_len, shape: jax_gumbel(rung, segment_idx, cur_len, shape))
        np.testing.assert_array_equal(t_seqs, np.asarray(j_seqs))
        np.testing.assert_allclose(t_scores, np.asarray(j_scores), rtol=0, atol=1e-5)
        greedy, _, _ = tgen._decode_prompted(t_xkv, ids, attn, topts, True)
        assert (t_seqs != greedy).any(), "sampling gave the greedy tokens"


def test_cpu_noise_source_is_reproducible_gumbel():
    a = tgen_mod.cpu_gumbel_noise(1, 2, 7, (4, 5000))
    assert torch.equal(a, tgen_mod.cpu_gumbel_noise(1, 2, 7, (4, 5000)))
    assert not torch.equal(a, tgen_mod.cpu_gumbel_noise(1, 2, 8, (4, 5000)))
    assert not torch.equal(a, tgen_mod.cpu_gumbel_noise(2, 1, 7, (4, 5000)))
    assert torch.isfinite(a).all() and a.dtype == torch.float32
    # standard Gumbel: mean = Euler-Mascheroni constant, variance pi^2 / 6
    assert abs(a.mean().item() - 0.5772) < 0.02
    assert abs(a.var().item() - np.pi**2 / 6) < 0.05


# ---------------------------------------------------------------- longform


def _spot(input_features, start_of_prev=False):
    """Fixed keyword prompts per segment, of a different length per row
    (left padding inside the prompt)."""
    assert input_features.shape[1:] == (80, 3000) and not start_of_prev
    return [[40 + j, 41, 42][: 3 - j] for j in range(input_features.shape[0])]


CASES = {
    "batch1_greedy": dict(batch=1),
    "batch2_mask_beam3_detected_language": dict(
        batch=2, opts=dict(num_beams=3, language_token_id=None, lang_token_ids=(10, 12, 13, 14))),
    "batch2_mask_spotting_hook": dict(batch=2, hook=True),
    # ratio 0.5: long outputs fail at every rung, short ones pass, so one
    # window retries one row of two and others run the whole ladder
    "batch2_ladder_every_rung_trips": dict(
        batch=2, hook=True, opts=dict(temperature=(0.0, 0.2, 0.4), compression_ratio_threshold=0.5)),
    # 0.0086 lies between the no-speech probabilities of row 0's windows
    # (0.0066-0.0087): its last window is skipped, the others are not
    "batch2_no_speech_skip": dict(
        batch=2, opts=dict(no_speech_threshold=0.0086, no_speech_token_id=50, logprob_threshold=-1.0)),
}


def _record_decodes(tgen, monkeypatch):
    """(rows, temperature) of every decode, and the number of windows cut
    into segments, while the port's generator runs."""
    decodes, segmented = [], []
    decode, retrieve = tgen._decode_prompted, tgen._retrieve_segment

    def recorded_decode(cross_kv, ids, *args, **kwargs):
        decodes.append((ids.shape[0], kwargs.get("temperature", 0.0)))
        return decode(cross_kv, ids, *args, **kwargs)

    def recorded_retrieve(*args):
        segmented.append(1)
        return retrieve(*args)

    monkeypatch.setattr(tgen, "_decode_prompted", recorded_decode)
    monkeypatch.setattr(tgen, "_retrieve_segment", recorded_retrieve)
    return decodes, segmented


@pytest.mark.parametrize("case", list(CASES))
def test_generate_longform_matches_jax(generators, case, monkeypatch):
    jgen, tgen = generators
    spec = CASES[case]
    mel = np.random.default_rng(6).standard_normal((spec["batch"], 80, FRAMES)).astype(np.float32)
    mask = None
    if spec["batch"] == 2:  # unequal lengths: 2.47 and 1.37 windows
        mask = np.zeros((2, FRAMES), np.int64)
        mask[0, :] = 1
        mask[1, :4100] = 1
    jopts = dataclasses.replace(JaxOptions(**OPTS), **spec.get("opts", {}))
    topts = dataclasses.replace(GenerationOptions(**OPTS), **spec.get("opts", {}))
    hook = _spot if spec.get("hook") else None
    want = jgen.generate(mel, jopts, attention_mask=mask, keyword_spotting=hook, return_segments=True)
    decodes, segmented = _record_decodes(tgen, monkeypatch)
    got = tgen.generate(torch.from_numpy(mel), topts, attention_mask=mask, keyword_spotting=hook,
                        return_segments=True, noise=jax_gumbel)
    np.testing.assert_array_equal(got["sequences"], want["sequences"])
    assert len(got["segments"]) == len(want["segments"]) == spec["batch"]
    for got_row, want_row in zip(got["segments"], want["segments"]):
        assert [s["tokens"] for s in got_row] == [s["tokens"] for s in want_row]
        for g, w in zip(got_row, want_row):
            assert abs(g["start"] - w["start"]) <= 1e-9 and abs(g["end"] - w["end"]) <= 1e-9

    # the case drove what it is named for
    assert got["segments"][0][-1]["end"] > 30.0, "the seek never left the first window"
    windows = sum(rows for rows, temperature in decodes if temperature == 0.0)
    if case.endswith("no_speech_skip"):
        assert len(segmented) < windows
    else:
        assert len(segmented) == windows
    if "ladder" in case:
        firsts = [rows for rows, temperature in decodes if temperature == 0.0]
        retries = [rows for rows, temperature in decodes if temperature > 0.0]
        assert any(temperature == 0.4 for _, temperature in decodes), "no row reached the last rung"
        assert min(retries) < max(firsts), "no window retried only some of its rows"
