"""CB-Whisper shaped like whisper-large-v3 through the port's live service.

The tiny model keeps what v3 changes against v2 and medium: 128 mel bins,
the 51,866-id vocabulary and v3's special ids (every id from
``<|translate|>`` up one higher than v2's), all read from the benchmark's
``perfbench/configs/cbw-whisper-large-v3.json``; its widths are cut to d 64,
2 + 2 layers and a tiny ResNet spotter.  It runs on seeded random weights
through ``TranscriptionService`` → ``generate_packed`` → ``encode_and_spot``
(beam 5, timestamps, condition-on-prev), built as the benchmark builds it
(``perfbench/systems/cbw.py``), and every launch's outputs are held to the
plain reference of ``perfbench/reference/``: the features, the encoder's
output, the spotter's logits and the teacher-forced beam score of each
served sequence.  Then the ids: no v2 default reaches a prompt or a
processor, the timestamp rules and the previous-text rule agree with the
references at v3's ``timestamp_begin`` 50365, and K1's sparse filterbank
rebuilds the dense one at 128 bins.
"""

import copy

import numpy as np
import pytest
import torch

from enhance_cb_whisper_tpu.decoding.prompt import segment_prev_tokens as jax_segment_prev_tokens
from enhance_cb_whisper_tpu_torch.audio.io import prepare_features
from enhance_cb_whisper_tpu_torch.decoding import generate as port_generate
from enhance_cb_whisper_tpu_torch.decoding.logits_process import LogitsProcessorConfig, apply_logits_processors
from enhance_cb_whisper_tpu_torch.decoding.prompt import segment_prev_tokens
from enhance_cb_whisper_tpu_torch.ops.mel import mel_filter_bank
from enhance_cb_whisper_tpu_torch.ops.mel_cuda import sparse_filterbank
from enhance_cb_whisper_tpu_torch.runtime.serving import TranscriptionService
from perfbench import harness, traffic, weights
from perfbench.reference import cbw as ref_cbw
from perfbench.reference import logits as ref_logits
from perfbench.reference import mel as ref_mel
from perfbench.reference import whisper as ref_whisper
from perfbench.reference.precision import Prec
from perfbench.systems import cbw as system

V3 = harness.load_json(harness.BENCH_DIR / "configs" / "cbw-whisper-large-v3.json")
TS_BEGIN = 50365  # v3's first timestamp: <|notimestamps|> 50364 + 1
V2_IDS = {50359, 50361, 50363}  # v2's <|transcribe|>, <|startofprev|>, <|notimestamps|>
CPU = torch.device("cpu")
FP32 = Prec("fp32")
CLIPS_S = (12.0, 26.0, 41.0)  # the last takes two windows, so a prompt carries previous text
POOL_SEED = 7


def tiny_v3() -> dict:
    cfg = copy.deepcopy(V3)
    cfg.update(d_model=64, encoder_layers=2, decoder_layers=2, encoder_attention_heads=2,
               decoder_attention_heads=2, encoder_ffn_dim=128, decoder_ffn_dim=128, max_target_positions=40)
    cfg["kws"].update(resnet={"embedding_size": 8, "hidden_sizes": [8, 16, 24, 32], "depths": [1, 1, 1, 1],
                              "layer_type": "bottleneck"},
                      num_channels=2, layer_slice=[1, 3], features_size=[30, 150], keywords=8, keyword_frames=[2, 5])
    return cfg


def _audio(index: int) -> np.ndarray:
    return traffic.noise_and_tone(POOL_SEED, index, CLIPS_S[index])


def _padded(audio: np.ndarray) -> torch.Tensor:
    n = max(480000, -(-audio.size // 160) * 160)
    out = np.zeros((n,), np.float32)
    out[: audio.size] = audio
    return torch.from_numpy(out)


@pytest.fixture(scope="module")
def served():
    """Three clips through a two-slot service; per launch the segments the
    encoder saw, its output, the spotter's logits per row and the decode's
    prompts, sequences and scores; the processors and the previous-text
    boundary the scheduler used."""
    cfg = tiny_v3()
    torch.manual_seed(0)
    cb = system.build(cfg, CPU)
    gen = cb.generator
    launches, processors, prev_calls = [], [], []
    real_spot, real_score, real_decode = cb.encode_and_spot, cb._score_fn, gen._decode_prompted
    real_processors = gen._processors

    def spot(input_features, start_of_prev=False, real_rows=None):
        launches.append({"seg": input_features.clone(), "logits": [], "real_rows": real_rows})
        tokens, enc = real_spot(input_features, start_of_prev=start_of_prev, real_rows=real_rows)
        launches[-1]["enc"] = enc.clone()
        return tokens, enc

    def score(catalog_dev, stack, utt_w):
        probs, logits = real_score(catalog_dev, stack, utt_w)
        launches[-1]["logits"].append(logits.clone())
        return probs, logits

    def decode(cross_kv, ids, attn, opts, *args, **kwargs):
        seqs, scores, no_speech = real_decode(cross_kv, ids, attn, opts, *args, **kwargs)
        launches[-1].update(ids=np.asarray(ids), attn=np.asarray(attn), seqs=seqs, scores=scores, opts=opts)
        return seqs, scores, no_speech

    def prev_tokens(segment, timestamp_begin):
        prev_calls.append(timestamp_begin)
        return segment_prev_tokens(segment, timestamp_begin)

    def make_processors(opts):
        processors.append(real_processors(opts))
        return processors[-1]

    cb.encode_and_spot, cb._score_fn = spot, score
    gen._decode_prompted, gen._processors = decode, make_processors
    features = [prepare_features(_audio(i), n_mels=cfg["num_mel_bins"], device=CPU) for i in range(len(CLIPS_S))]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_generate, "segment_prev_tokens", prev_tokens)
        service = TranscriptionService(cb, slots=2)
        try:
            tickets = [service.submit(f, m) for f, m in features]
            texts = [service.result(t, timeout=300) for t in tickets]
        finally:
            service.close()
    return {"cfg": cfg, "launches": launches, "features": features, "texts": texts,
            "processors": processors, "prev_calls": prev_calls}


@pytest.fixture(scope="module")
def reference(served):
    """The reference's own weights and spotter head, centred as the
    benchmark centres the program's."""
    cfg = served["cfg"]
    w = weights.materialize(weights.whisper_spec(cfg), cfg["weights_seed"], system.SALT_WHISPER, CPU)
    w_kws = weights.materialize(weights.cbw_kws_spec(cfg["kws"]), cfg["weights_seed"], system.SALT_KWS, CPU)
    keywords = system.catalog_stacks(cfg, CPU)
    n_kw = cfg["kws"]["keywords"]

    def spot(states):
        return ref_cbw.spot_logits(w_kws, cfg["kws"], keywords, ref_cbw.kws_stack(states, cfg["kws"]["layer_slice"]),
                                   FP32)[:n_kw]

    mel = ref_mel.log_mel(_padded(system.centre_audio(cfg)), cfg["num_mel_bins"], FP32)
    ref_cbw.centre(w_kws, spot(ref_whisper.encode(w, cfg, mel[:, :3000], FP32)[1]))
    return {"w": w, "spot": spot}


def _rows(launch):
    rows = launch["real_rows"] or [True] * launch["seg"].shape[0]
    return [j for j, real in enumerate(rows) if real]


def test_service_served_every_clip_over_several_launches(served):
    assert len(served["texts"]) == len(CLIPS_S) and all(isinstance(t, str) for t in served["texts"])
    assert len(served["launches"]) >= 3  # the 41 s clip takes a second window
    assert all(launch["seg"].shape[1:] == (128, 3000) for launch in served["launches"])


def test_features_match_the_reference(served):
    """The port's features at 128 bins (its plain path here, K1 on a card)
    against the reference's DFT-by-products.  On the CPU both take the same
    float32 products and agree to the bit; the tolerance, 1e-4 in log-mel
    units, is ten times under the cell's ``mel_gap`` limit."""
    for i, (features, _) in enumerate(served["features"]):
        want = ref_mel.log_mel(_padded(_audio(i)), 128, FP32)
        assert features.shape == (1, 128, want.shape[1])
        assert float((features[0] - want).abs().max()) < 1e-4


def test_encoder_output_matches_the_reference(served, reference):
    """Every row's encoder output against the reference's on the same
    segment, relative to its largest value.  On the CPU the two float32
    forwards agree to the bit; 1e-5 leaves room for another order of sums
    and is far under what a row mix-up or a lost layer gives."""
    cfg = served["cfg"]
    for launch in served["launches"]:
        for j in range(launch["seg"].shape[0]):
            want, _ = ref_whisper.encode(reference["w"], cfg, launch["seg"][j], FP32)
            gap = float((launch["enc"][j] - want).abs().max()) / float(want.abs().max())
            assert gap < 1e-5


def test_spotter_logits_match_the_reference(served, reference):
    """Each real row's catalog logits against the reference's maps and
    ResNet from the reference's own encoder states: ~3e-9 apart at these
    logits of order 0.01 (float32 through the resize and the ResNet); the
    tolerance is the cell's ``kws_gap`` limit, 1e-6."""
    cfg = served["cfg"]
    for launch in served["launches"]:
        for k, j in enumerate(_rows(launch)):
            _, states = ref_whisper.encode(reference["w"], cfg, launch["seg"][j], FP32)
            want = reference["spot"](states)
            got = launch["logits"][k][: cfg["kws"]["keywords"]]
            assert float((got - want).abs().max()) < 1e-6


def test_beam_scores_match_the_teacher_forced_reference(served, reference):
    """Each served row's beam score (prefill and steps through the K/V
    cache, the processors, length-normalized) against the reference's full
    teacher-forced forward of the same tokens: scores near -10, the sum of
    <= 18 float32 log-probabilities, ~1.3e-6 apart; 1e-5 is the tolerance."""
    cfg = served["cfg"]
    checked = 0
    for launch in served["launches"]:
        plen = launch["ids"].shape[1]
        for j in _rows(launch):
            enc, _ = ref_whisper.encode(reference["w"], cfg, launch["seg"][j], FP32)
            want = float(ref_cbw.beam_score(reference["w"], cfg, enc, plen, torch.as_tensor(launch["seqs"][j]),
                                            torch.as_tensor(launch["attn"][j]), FP32))
            assert abs(float(launch["scores"][j]) - want) < 1e-5
            checked += 1
    assert checked >= len(CLIPS_S) + 1


def test_prompts_and_tokens_take_v3_ids(served):
    """Every prompt opens its task with <|startoftranscript|> <|en|>
    <|transcribe|> (v3's 50360) and has no <|notimestamps|> (timestamps on);
    a prompt with context (keywords or previous text) starts with v3's
    <|startofprev|> 50362.
    No v2 id of those tokens appears.  Each row's first generated token is
    a timestamp no later than ``max_initial_timestamp_index`` past 50365."""
    conditioned = 0
    for launch in served["launches"]:
        plen = launch["ids"].shape[1]
        for j in _rows(launch):
            ids, attn = launch["ids"][j], launch["attn"][j]
            real = ids[attn > 0].tolist()
            assert real[-3:] == [50258, 50259, 50360]
            assert not V2_IDS & set(real) and 50364 not in real
            if 50362 in real:
                conditioned += 1
                assert real.index(50362) == 0
            first = int(launch["seqs"][j][plen])
            assert TS_BEGIN <= first <= TS_BEGIN + V3["generation"]["max_initial_timestamp_index"]
            assert 50364 not in launch["seqs"][j][plen:].tolist()
    assert conditioned >= 1


def test_processors_and_previous_text_take_v3_ids(served):
    """The scheduler's processors and previous-text rule are built from the
    options: v3's <|notimestamps|>, its vocabulary and end-of-text, and
    ``timestamp_begin`` 50365 wherever a finished segment feeds a prompt."""
    assert served["processors"]
    for p in served["processors"]:
        assert (p.no_timestamps_token_id, p.timestamp_begin, p.vocab_size, p.eos_token_id) == (
            50364, TS_BEGIN, 51866, 50257)
        assert p.return_timestamps and tuple(p.begin_suppress_tokens) == (220, 50257)
    assert served["prev_calls"] and set(served["prev_calls"]) == {TS_BEGIN}
    opts = served["launches"][0]["opts"]
    assert (opts.prev_sot_token_id, opts.no_speech_token_id, opts.pad_token_id) == (50362, 50363, 50256)


def _histories():
    """Token rows (prompt of 4, then generated) whose last two generated
    tokens straddle v3's timestamp boundary: 50364 is <|notimestamps|>, a
    text-side id; 50365 the first timestamp."""
    prompt = [50258, 50259, 50360, 1000]
    return {
        "first-position": (prompt, []),
        "after-a-timestamp": (prompt, [50365 + 4, 300]),
        "after-a-pair": (prompt, [50365, 500, 50365 + 7, 50365 + 7]),
        "after-50364": (prompt, [50365 + 2, 700, 50364]),
        "after-text-then-50365": (prompt, [50365 + 3, 800, 50365]),
    }


@pytest.mark.parametrize("name", list(_histories()))
def test_timestamp_rules_match_the_reference_at_v3(name):
    """The port's processors against the reference's frozen copy, both
    configured from the v3 file, on random logits over all 51,866 ids and a
    history at the boundary: equal bit for bit (the same float32 ops)."""
    gen = V3["generation"]
    kwargs = dict(begin_suppress_tokens=tuple(V3["begin_suppress_tokens"]),
                  no_timestamps_token_id=gen["no_timestamps_token_id"],
                  max_initial_timestamp_index=gen["max_initial_timestamp_index"], return_timestamps=True,
                  eos_token_id=V3["eos_token_id"], vocab_size=V3["vocab_size"])
    prompt, generated = _histories()[name]
    length = len(prompt) + len(generated)
    tokens = torch.full((3, length + 4), V3["pad_token_id"], dtype=torch.long)
    tokens[:, :length] = torch.as_tensor(prompt + generated)
    logits = torch.randn(3, V3["vocab_size"], generator=torch.Generator().manual_seed(length)) * 4
    logits[1, TS_BEGIN:] += 6.0  # a row where the timestamps' mass wins
    got = apply_logits_processors(LogitsProcessorConfig(**kwargs), logits, tokens, length, len(prompt))
    want = ref_logits.apply_logits_processors(ref_logits.LogitsProcessorConfig(**kwargs), logits, tokens, length,
                                              len(prompt))
    assert torch.equal(got, want)
    assert torch.all(got[:, 50364] == ref_logits.NEG_INF)  # <|notimestamps|> is never emitted


@pytest.mark.parametrize("tokens,drops_last", [
    ([400, 50365 + 9, 50365 + 9], True),  # a closed double timestamp: the last one goes
    ([400, 50364, 50365 + 9], False),  # 50364 is not a timestamp in v3
    ([50365 + 1, 400, 500, 50365 + 8], False),
])
def test_previous_text_rule_at_v3(tokens, drops_last):
    """The port's previous-text rule at 50365 against the JAX package's and
    HF's (``len(tokens) > 2 and tokens[-2] >= timestamp_begin``)."""
    segment = {"tokens": tokens}
    got = list(segment_prev_tokens(segment, TS_BEGIN))
    assert got == list(jax_segment_prev_tokens(segment, TS_BEGIN))
    assert got == (tokens[:-1] if drops_last else tokens)


@pytest.mark.parametrize("n_mels,taps,single", [(80, 391, 3), (128, 394, 45)])
def test_sparse_filterbank_rebuilds_the_dense_one(n_mels, taps, single):
    """K1's packed runs, laid back at their first bins, give
    ``mel_filter_bank`` exactly; at 128 bins 45 of the mels have one tap
    (their triangles narrower than a 40 Hz DFT bin)."""
    dense = mel_filter_bank(n_mels)
    packed, meta = sparse_filterbank(n_mels)
    first, offsets = meta[:n_mels], meta[n_mels:]
    assert packed.size == taps == offsets[-1] and offsets[0] == 0
    rebuilt = np.zeros_like(dense)
    for m in range(n_mels):
        run = packed[offsets[m]:offsets[m + 1]]
        rebuilt[first[m]:first[m] + run.size, m] = run
    assert np.array_equal(rebuilt, dense.astype(np.float32))
    assert int(np.sum(np.diff(offsets) == 1)) == single
