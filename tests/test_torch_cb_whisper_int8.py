"""int8 keyword spotting inside the shortform slice, port vs JAX:
``CBWhisper.run_test`` over three synthetic utterances after
``enable_int8_spotting(calibration_batches=2)`` on both sides, with a
K2-eligible ResNet (stage_1 widths are 128-multiples) whose stage_1
bottleneck 1×1 convs run the fused s8 kernel — Pallas in interpret mode on
the JAX side (``ECW_S8_PALLAS=stage_1``), the kernel's plain version on the
port's (``s8_1x1=("stage_1",)``).

The first segment is scored in fp32 while its stack is kept for
calibration; the second fills the calibration set, which swaps the scorer,
so it and the third are scored in int8.  Held exact: keywords per segment,
transcripts and entity recall with its CI bounds."""

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
from enhance_cb_whisper_tpu_torch.ops import matmul_s8_cuda

from test_torch_cb_whisper import CFG, KEYWORDS, OPTS, OUT, _dataset, decode_fn, prompt_ids_fn

RESNET = dict(num_channels=2, embedding_size=32, hidden_sizes=(128, 512), depths=(1, 3),
              layer_type="bottleneck", num_labels=2)


def _pipelines():
    rng = np.random.default_rng(0)
    params = init_whisper_params(rng, JaxWhisperConfig(**CFG))
    stacks = []
    for _ in KEYWORDS:
        s = rng.standard_normal((2, int(rng.integers(3, 12)), 64)).astype(np.float32)
        stacks.append(s / np.linalg.norm(s, axis=-1, keepdims=True))
    jkws = JaxKWS(JaxResNetConfig(**RESNET))
    variables = jkws.init(jax.random.PRNGKey(0), np.zeros((1, 2, *OUT), np.float32))
    # a random head decides every keyword alike: put the class-1 bias
    # between the keywords' margins so the spotter passes some of them
    variables = jax.tree.map(np.asarray, variables)
    variables["params"]["model"]["classifier"]["bias"] = np.array([0.0, -0.105], np.float32)

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


def _record_keywords(cb, spotted):
    inner = cb._score_to_keywords

    def recorded(*args, **kwargs):
        out = inner(*args, **kwargs)
        spotted.append(out)
        return out

    cb._score_to_keywords = recorded


def test_int8_run_test_matches_jax(monkeypatch):
    monkeypatch.setenv("ECW_S8_PALLAS", "stage_1")
    jax_cb, port_cb = _pipelines()
    jax_cb.enable_int8_spotting(calibration_batches=2)
    port_cb.enable_int8_spotting(calibration_batches=2, s8_1x1=("stage_1",))
    jax_spotted, port_spotted = [], []
    _record_keywords(jax_cb, jax_spotted)
    _record_keywords(port_cb, port_spotted)

    dataset = _dataset()
    jax_preds, port_preds = [], []
    want = jax_cb.run_test(dataset, lambda item: jax_prepare_features(item["audio"]),
                           num_bootstraps=20, predictions_out=jax_preds)
    launches = matmul_s8_cuda.kernel.launches
    got = port_cb.run_test(dataset, lambda item: prepare_features(item["audio"], device="cpu"),
                           num_bootstraps=20, predictions_out=port_preds)
    assert matmul_s8_cuda.kernel.launches == launches  # CPU tensors: the plain version

    assert not port_cb._int8_pending and not jax_cb._int8_pending
    assert len(port_spotted) == len(jax_spotted) == 3
    assert port_spotted == jax_spotted
    spotted = [kw for seg in port_spotted for kws in seg for kw in kws]
    assert 0 < len(spotted) < 3 * len(KEYWORDS), port_spotted  # decisions are not all alike
    assert port_preds == jax_preds
    for key in ("Entity Recall", "Entity Recall LB", "Entity Recall UB"):
        assert got[key] == want[key]


def test_int8_scorer_tracks_fp32_on_the_calibration_segment():
    """The segment that fills the calibration set is the first the int8
    scorer scores; it keeps the fp32 scorer's decisions there, and its
    stage_1 1×1 convs go through the kernel's wrapper."""
    _, port_cb = _pipelines()
    features, _ = prepare_features(_dataset()[2]["audio"], device="cpu")
    fp32 = port_cb.spot_keywords(features)
    port_cb.enable_int8_spotting(calibration_batches=1, s8_1x1=("stage_1",))
    calls = []
    real = matmul_s8_cuda.matmul_s8_requant
    try:
        matmul_s8_cuda.matmul_s8_requant = lambda *a, **k: calls.append(1) or real(*a, **k)
        int8 = port_cb.spot_keywords(features)  # calibrates, then scores in int8
    finally:
        matmul_s8_cuda.matmul_s8_requant = real
    assert not port_cb._int8_pending and "kws_qparams" in vars(port_cb)
    assert len(calls) == 4  # one catalog chunk: 3 layer_0 reduces + 1 fused tail
    assert int8 == fp32 and 0 < len(fp32[0]) < len(KEYWORDS)
    assert port_cb.spot_keywords(features) == int8
