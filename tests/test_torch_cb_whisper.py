"""The whole shortform slice, port vs JAX: ``CBWhisper.run_test`` over
three synthetic utterances of at most 30 s (audio → mel → one encoder
forward → catalog keyword spotting → biased beam-5 decode with timestamps
→ entity recall with bootstrap CIs), tiny random Whisper and ResNet
weights from one seed, converted.

Held exact: detected keywords, transcripts and entity recall (the CI
bounds too — same predictions, same bootstrap).  Continuous values inside
agree to fp32 summation-order level, which these decisions never see."""

import jax
import numpy as np
import pytest
import torch

from enhance_cb_whisper_tpu.audio.io import prepare_features as jax_prepare_features
from enhance_cb_whisper_tpu.catalog import KeywordCatalog as JaxCatalog
from enhance_cb_whisper_tpu.decoding import GenerationOptions as JaxOptions
from enhance_cb_whisper_tpu.models.cb_whisper import CBWhisper as JaxCBWhisper
from enhance_cb_whisper_tpu.models.cb_whisper import CBWhisperConfig as JaxCBConfig
from enhance_cb_whisper_tpu.models.kws import KWSModel as JaxKWS
from enhance_cb_whisper_tpu.models.resnet import ResNetConfig as JaxResNetConfig
from enhance_cb_whisper_tpu.models.whisper import WhisperConfig as JaxWhisperConfig
from enhance_cb_whisper_tpu.models.whisper import init_whisper_params
from enhance_cb_whisper_tpu_torch.audio.io import prepare_features
from enhance_cb_whisper_tpu_torch.catalog.database import KeywordCatalog
from enhance_cb_whisper_tpu_torch.convert import from_flax_resnet_variables, from_jax_whisper_params
from enhance_cb_whisper_tpu_torch.decoding.generate import GenerationOptions
from enhance_cb_whisper_tpu_torch.models.cb_whisper import CBWhisper, CBWhisperConfig
from enhance_cb_whisper_tpu_torch.models.kws import KWSModel
from enhance_cb_whisper_tpu_torch.models.resnet import ResNetConfig
from enhance_cb_whisper_tpu_torch.models.whisper import WhisperConfig

CFG = dict(
    vocab_size=128, num_mel_bins=80, d_model=64,
    encoder_layers=3, encoder_attention_heads=4,
    decoder_layers=2, decoder_attention_heads=4,
    encoder_ffn_dim=128, decoder_ffn_dim=128,
    max_source_positions=1500, max_target_positions=40,
    decoder_start_token_id=3, eos_token_id=2, pad_token_id=0,
)
RESNET = dict(num_channels=2, embedding_size=8, hidden_sizes=(8, 16, 24, 32),
              depths=(1, 1, 1, 1), num_labels=2)
OUT = (32, 48)
OPTS = dict(
    decoder_start_token_id=3, language_token_id=10, task_token_id=11,
    no_timestamps_token_id=100, prev_sot_token_id=99, eos_token_id=2, pad_token_id=0,
    max_initial_timestamp_index=10, num_beams=5, return_timestamps=True,
    condition_on_prev_tokens=True, max_target_positions=40,
)
KEYWORDS = ["alpha", "beta", "gamma", "delta", "eps", "zeta"]


def prompt_ids_fn(text):
    return [99] + [10 + (ord(c) % 50) for c in text][:6]


def decode_fn(tokens):
    return " ".join(f"w{t}" for t in tokens if 4 < t < 99)


@pytest.fixture(scope="module")
def pipelines():
    rng = np.random.default_rng(0)
    params = init_whisper_params(rng, JaxWhisperConfig(**CFG))
    stacks = []
    for _ in KEYWORDS:
        s = rng.standard_normal((2, int(rng.integers(3, 12)), 64)).astype(np.float32)
        stacks.append(s / np.linalg.norm(s, axis=-1, keepdims=True))
    jkws = JaxKWS(JaxResNetConfig(**RESNET))
    variables = jkws.init(jax.random.PRNGKey(0), np.zeros((1, 2, *OUT), np.float32))

    jax_cb = JaxCBWhisper(
        config=JaxCBConfig(kws_features_size=OUT), whisper_config=JaxWhisperConfig(**CFG),
        whisper_params=params, kws_model=jkws, kws_variables=variables,
        catalog=JaxCatalog.from_arrays(KEYWORDS, stacks), generation_options=JaxOptions(**OPTS),
        prompt_ids_fn=prompt_ids_fn, decode_fn=decode_fn, kws_layer_slice=(1, 3),
    )
    port_cb = CBWhisper(
        config=CBWhisperConfig(kws_features_size=OUT), whisper_config=WhisperConfig(**CFG),
        whisper_params=from_jax_whisper_params(params, device="cpu"),
        kws_model=KWSModel(ResNetConfig(**RESNET)).load_converted(from_flax_resnet_variables(variables)),
        catalog=KeywordCatalog.from_arrays(KEYWORDS, stacks), generation_options=GenerationOptions(**OPTS),
        prompt_ids_fn=prompt_ids_fn, decode_fn=decode_fn, kws_layer_slice=(1, 3), device="cpu",
    )
    return jax_cb, port_cb


def _dataset():
    rng = np.random.default_rng(1)
    items = []
    for i, seconds in enumerate((5.0, 12.5, 30.0)):
        audio = (rng.standard_normal(int(16000 * seconds)) * 0.1).astype(np.float32)
        items.append({
            "audio": audio,
            "transcript": "w12 w30 w44 w61",
            "hotword_labels": np.array([1, 0, 0, 1, 0, 0]),
            "speaker": f"s{i % 2}",
            "keywords": [{"mention": "w30", "total_offset": 4, "end_offset": 7},
                         {"mention": "w61", "total_offset": 12, "end_offset": 15}],
        })
    return items


def test_run_test_matches_jax(pipelines):
    jax_cb, port_cb = pipelines
    dataset = _dataset()

    # keyword spotting decisions, per utterance
    port_spotted, jax_spotted = [], []
    for item in dataset:
        port_spotted.append(port_cb.spot_keywords(prepare_features(item["audio"], device="cpu")[0]))
        jax_spotted.append(jax_cb.spot_keywords(jax_prepare_features(item["audio"])[0]))
    assert port_spotted == jax_spotted
    assert any(kw for spotted in port_spotted for kw in spotted), "no keyword spotted: vacuous prompt"

    jax_preds, port_preds = [], []
    want = jax_cb.run_test(dataset, lambda item: jax_prepare_features(item["audio"]),
                           num_bootstraps=20, predictions_out=jax_preds)
    got = port_cb.run_test(dataset, lambda item: prepare_features(item["audio"], device="cpu"),
                           num_bootstraps=20, predictions_out=port_preds)
    assert port_preds == jax_preds
    assert all(pred for pred in port_preds)
    for key in ("Entity Recall", "Entity Recall LB", "Entity Recall UB"):
        assert got[key] == want[key]
    assert got["RTFx"] > 0


@pytest.mark.parametrize("oracle", ["gold", "random"])
def test_oracle_prompts_match_jax(pipelines, oracle):
    """The reference's oracle modes: the gold (or random negative) keyword
    set of the utterance becomes the prompt instead of the spotter's."""
    jax_cb, port_cb = pipelines
    dataset = _dataset()[:2]
    preds = {}
    for name, cb, mel_fn in (
        ("jax", jax_cb, lambda item: jax_prepare_features(item["audio"])),
        ("port", port_cb, lambda item: prepare_features(item["audio"], device="cpu")),
    ):
        cb.config.oracle = oracle
        try:
            out = []
            cb.run_test(dataset, mel_fn, num_bootstraps=5, rng=np.random.default_rng(7), predictions_out=out)
        finally:
            cb.config.oracle = "kws"
        preds[name] = out
    assert preds["port"] == preds["jax"]


def test_metrics_copies_match_jax():
    """The port's copies of entity recall and the bootstrap CIs give the
    JAX package's numbers exactly."""
    from enhance_cb_whisper_tpu import metrics as jm
    from enhance_cb_whisper_tpu_torch import metrics as tm

    refs = ["the alpha beta model. then gamma", "delta eps zeta", "we use alpha here"]
    preds = ["the alpha betta model then gamma", "delta ep zeta", "we used alfa here"]
    mentions = [
        [{"mention": "alpha", "total_offset": 4, "end_offset": 9, "ner_tag": "UNK"},
         {"mention": "gamma", "total_offset": 27, "end_offset": 32, "ner_tag": "UNK"}],
        [{"mention": "eps", "total_offset": 6, "end_offset": 9, "ner_tag": "UNK"}],
        [{"mention": "alpha", "total_offset": 7, "end_offset": 12, "ner_tag": "UNK"}],
    ]
    for char_split in (False, True):
        assert tm.entity_recall(preds, refs, mentions, ner_tags="ALL", char_split=char_split) == \
            jm.entity_recall(preds, refs, mentions, ner_tags="ALL", char_split=char_split)

    def metric(recall_fn):
        return lambda labels, samples, samples2=None: recall_fn(
            list(samples), [l[0] for l in labels], [l[1] for l in labels], ner_tags="ALL")["ALL"]

    args = (list(preds), list(zip(refs, mentions)), [0, 1, 0])
    assert tm.evaluate_with_conf_int(args[0], metric(tm.entity_recall), *args[1:], num_bootstraps=50, alpha=5) == \
        jm.evaluate_with_conf_int(args[0], metric(jm.entity_recall), *args[1:], num_bootstraps=50, alpha=5)


def test_spotting_failure_raises(pipelines):
    """No broad except around spotting: a failing encoder surfaces."""
    _, port_cb = pipelines
    with pytest.raises(RuntimeError):
        port_cb.encode_and_spot(torch.zeros((1, 80, 17)))


def test_run_test_longform_matches_jax(pipelines):
    """``run_test`` at batch 1 over one 50 s utterance (two windows):
    keywords spotted per window, the seek loop's transcript and entity
    recall agree with JAX.  The decoder's timestamp embedding rows are
    zeroed, so a window's output holds no timestamp pair after its first
    token and the seek moves a whole window (a plain random decoder closes
    a pair every few tokens and crawls through the audio)."""
    jax_cb, port_cb = pipelines
    rng = np.random.default_rng(2)
    audio = (rng.standard_normal(16000 * 50) * 0.1).astype(np.float32)
    dataset = [{**_dataset()[0], "audio": audio}]
    params = init_whisper_params(np.random.default_rng(0), JaxWhisperConfig(**CFG))
    no_ts = jax.tree.map(np.copy, params)
    no_ts["decoder"]["embed_tokens"]["weight"][101:] = 0.0
    spotted = {"jax": [], "port": []}
    preds = {"jax": [], "port": []}
    results = {}
    # one intra-op thread: the port's tiny decode steps stay fast when the
    # test workers share the machine's cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        jax_cb.generator.swap_params(no_ts)
        port_cb.generator.params = from_jax_whisper_params(no_ts, device="cpu")
        for name, cb, mel_fn in (
            ("jax", jax_cb, lambda item: jax_prepare_features(item["audio"])),
            ("port", port_cb, lambda item: prepare_features(item["audio"], device="cpu")),
        ):
            score_to_keywords = cb._score_to_keywords

            def recorded(*args, _name=name, _fn=score_to_keywords, **kwargs):
                out = _fn(*args, **kwargs)
                spotted[_name].extend(out)
                return out

            cb._score_to_keywords = recorded
            try:
                results[name] = cb.run_test(dataset, mel_fn, num_bootstraps=5, predictions_out=preds[name])
            finally:
                del cb._score_to_keywords
    finally:
        torch.set_num_threads(threads)
        jax_cb.generator.swap_params(params)
        port_cb.generator.params = from_jax_whisper_params(params, device="cpu")
    features, mask = prepare_features(audio, device="cpu")
    assert features.shape[-1] == 5000 and mask.sum() == 5000
    assert len(spotted["port"]) >= 2, "the utterance was not cut into windows"
    assert spotted["port"] == spotted["jax"]
    assert preds["port"] == preds["jax"] and preds["port"][0]
    assert results["port"]["Entity Recall"] == results["jax"]["Entity Recall"]
