"""The port's s8 Whisper encoder vs the JAX package's, on the CPU.

On ``tests/test_quant_encoder.py``'s protocol (d_model 64, 6 layers, two
80-mel 30 s segments of random weights): the calibrated activation scales
(the maxes differ from JAX's by fp32 rounding only: rtol 1e-5), the int8
KWS stack with JAX's scales against JAX's int8 stack (per-frame cosine
above 0.9999: an activation whose quotient sits on a rounding edge may take
the neighbouring code) and against the f32 stack (JAX's own bounds: cosine
above 0.999, 0.995 with bf16 activations), and the nearest-keyword decision
that the stacks feed.

On ``tests/test_cb_whisper.py``'s protocol (a tiny CB-Whisper with a
separate 4-layer KWS encoder): ``enable_int8_kws_encoder`` refuses a shared
encoder, calibrates lazily on real segment mels only, and then spots the
keywords JAX spots and its own fp32 encoder spots."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhance_cb_whisper_tpu.catalog import KeywordCatalog as JaxCatalog
from enhance_cb_whisper_tpu.decoding.generate import GenerationOptions as JaxOptions
from enhance_cb_whisper_tpu.models import whisper as jw
from enhance_cb_whisper_tpu.models.cb_whisper import CBWhisper as JaxCBWhisper
from enhance_cb_whisper_tpu.models.cb_whisper import CBWhisperConfig as JaxCBConfig
from enhance_cb_whisper_tpu.models.kws import KWSModel as JaxKWS
from enhance_cb_whisper_tpu.models.resnet import ResNetConfig as JaxResNetConfig
from enhance_cb_whisper_tpu_torch.catalog.database import KeywordCatalog
from enhance_cb_whisper_tpu_torch.convert import from_jax_whisper_params
from enhance_cb_whisper_tpu_torch.decoding.generate import GenerationOptions
from enhance_cb_whisper_tpu_torch.models import whisper as tw
from enhance_cb_whisper_tpu_torch.models.cb_whisper import CBWhisper, CBWhisperConfig
from enhance_cb_whisper_tpu_torch.models.kws import init_kws_model
from enhance_cb_whisper_tpu_torch.models.resnet import ResNetConfig
from test_torch_packed import (
    CFG, KEYWORDS, OPTS, OUT, RESNET, decode_fn, flax_variables, prompt_ids_fn, whisper_params,
)

ENC_CFG = dict(
    vocab_size=100, num_mel_bins=80, d_model=64,
    encoder_layers=6, encoder_attention_heads=4,
    decoder_layers=2, decoder_attention_heads=4,
    encoder_ffn_dim=256, decoder_ffn_dim=256,
    max_source_positions=1500, max_target_positions=64,
)
SLICE = (2, 5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    """JAX's f32 and int8 stacks, its scales, and the port's params."""
    rng = np.random.default_rng(0)
    jcfg = jw.WhisperConfig(**ENC_CFG)
    params = jw.init_whisper_params(rng, jcfg)
    feats = (rng.standard_normal((2, 80, 3000)) * 0.5).astype(np.float32)
    stacked = jw.stack_whisper_params(jax.tree.map(jnp.asarray, params))
    ref = np.asarray(jw.encoder_kws_stack(stacked, feats, jcfg, layer_slice=SLICE))
    scales = jw.calibrate_encoder_act_scales(params, feats, jcfg)
    qp = jax.device_put(jw.quantize_encoder_layers(params, scales))
    ref8 = np.asarray(jw.encoder_kws_stack(qp, feats, jcfg, layer_slice=SLICE))
    return params, feats, ref, scales, ref8, from_jax_whisper_params(params, device="cpu")


def test_calibration_scales_match_jax(setup):
    _, feats, _, scales, _, port = setup
    got = tw.calibrate_encoder_act_scales(port, torch.from_numpy(feats), tw.WhisperConfig(**ENC_CFG))
    assert got.shape == (ENC_CFG["encoder_layers"], len(tw._ENC_ACT_SITES)) and got.dtype == np.float32
    assert (got > 0).all()
    np.testing.assert_allclose(got, scales, rtol=1e-5, atol=0)


def _port_stack(port, scales, feats, dtype=torch.float32):
    q = tw.quantize_encoder_layers(port, scales)
    assert "act_scales" in q["encoder"]["layers"][0] and "act_scales" not in port["encoder"]["layers"][0]
    return tw.encoder_kws_stack(q, torch.from_numpy(feats), tw.WhisperConfig(**ENC_CFG), layer_slice=SLICE,
                                dtype=dtype).numpy()


def test_int8_kws_stack_matches_jax(setup):
    _, feats, ref, scales, ref8, port = setup
    got = _port_stack(port, scales, feats)
    assert got.shape == ref8.shape
    # both stacks are L2-normalized per frame: the rowwise dot is the cosine
    assert (got * ref8).sum(-1).min() > 0.9999, (got * ref8).sum(-1).min()
    assert (got * ref).sum(-1).min() > 0.999
    got16 = _port_stack(port, scales, feats, torch.bfloat16)
    assert (got16 * ref).sum(-1).min() > 0.995


def test_nearest_keyword_decision_parity(setup):
    """The decision the stacks feed (the nearest of 8 catalog keywords cut
    from the f32 stacks) is the same for JAX's f32 and int8 stacks and the
    port's int8 stack."""
    _, feats, ref, scales, ref8, port = setup
    got = _port_stack(port, scales, feats)
    rng = np.random.default_rng(1)
    kws = []
    for _ in range(8):
        b = rng.integers(0, ref.shape[0])
        t0 = int(rng.integers(0, ref.shape[2] - 6))
        kws.append(ref[b, :, t0 : t0 + 5, :])

    def nearest(stacks):
        scores = np.stack([np.einsum("bltd,lkd->blk", stacks, kw).max(axis=(1, 2)) for kw in kws], axis=1)
        return scores.argmax(axis=1)

    np.testing.assert_array_equal(nearest(got), nearest(ref))
    np.testing.assert_array_equal(nearest(got), nearest(ref8))


# ------------------------------------------------- CBWhisper.enable_int8_kws_encoder

ENCODER = dict(CFG, encoder_layers=4)  # the separate KWS encoder


def _cb_pair():
    """A JAX CBWhisper and its port with a separate 4-layer KWS encoder of
    another seed, a tiny ResNet whose class-1 bias sits in the widest gap of
    the keywords' fp32 margins on the test mels, greedy decode."""
    params = whisper_params()
    enc = jw.init_whisper_params(np.random.default_rng(7), jw.WhisperConfig(**ENCODER))
    enc["encoder"]["conv1"]["weight"] *= 10.0
    enc["encoder"]["conv2"]["weight"] *= 10.0
    rng = np.random.default_rng(3)
    stacks = []
    for _ in KEYWORDS:
        s = rng.standard_normal((2, int(rng.integers(2, 6)), CFG["d_model"])).astype(np.float32)
        stacks.append(s / np.linalg.norm(s, axis=-1, keepdims=True))
    kws = init_kws_model(ResNetConfig(**RESNET), torch.Generator().manual_seed(0))

    def port_cb():
        return CBWhisper(
            config=CBWhisperConfig(kws_features_size=OUT, keywords_per_group=2),
            whisper_config=tw.WhisperConfig(**CFG), whisper_params=from_jax_whisper_params(params, device="cpu"),
            kws_model=kws, catalog=KeywordCatalog.from_arrays(KEYWORDS, stacks, group_size=2),
            generation_options=GenerationOptions(**OPTS), prompt_ids_fn=prompt_ids_fn, decode_fn=decode_fn,
            encoder_params=from_jax_whisper_params(enc, device="cpu"), encoder_config=tw.WhisperConfig(**ENCODER),
            kws_layer_slice=(1, 3), device="cpu",
        )

    f32 = port_cb()
    f32._ensure_catalog()
    margins = []
    with torch.no_grad():
        for mel in MELS:
            for seg in tw.encoder_kws_stack(f32.encoder_params, torch.from_numpy(mel), f32.encoder_config,
                                            layer_slice=(1, 3)):
                logits = f32._score_fn(f32._catalog_dev, seg, f32._utt_w)[1][: len(KEYWORDS)]
                margins.extend((logits[:, 1] - logits[:, 0]).tolist())
        m = np.sort(margins)
        gap = max(range(len(m) // 4, len(m) - len(m) // 4 - 1), key=lambda i: m[i + 1] - m[i])
        kws.model.classifier.bias[1] -= float(m[gap] + m[gap + 1]) / 2
    jax_cb = JaxCBWhisper(
        config=JaxCBConfig(kws_features_size=OUT, keywords_per_group=2), whisper_config=jw.WhisperConfig(**CFG),
        whisper_params=params, kws_model=JaxKWS(JaxResNetConfig(**RESNET)), kws_variables=flax_variables(kws),
        catalog=JaxCatalog.from_arrays(KEYWORDS, stacks, group_size=2), generation_options=JaxOptions(**OPTS),
        prompt_ids_fn=prompt_ids_fn, decode_fn=decode_fn, encoder_params=enc,
        encoder_config=jw.WhisperConfig(**ENCODER), kws_layer_slice=(1, 3),
    )
    return jax_cb, f32, port_cb()


MELS = [np.random.default_rng(21 + i).standard_normal((2, 8, 48)).astype(np.float32) for i in range(3)]


def test_int8_kws_encoder_refuses_a_shared_encoder():
    from test_torch_packed import cb_pipelines

    _, port_cb = cb_pipelines()
    with pytest.raises(ValueError, match="separate KWS encoder"):
        port_cb.enable_int8_kws_encoder()


def test_int8_kws_encoder_matches_jax_and_fp32():
    jax_cb, f32, q = _cb_pair()
    jax_cb.enable_int8_kws_encoder(host_params=jax_cb.encoder_params, calibration_batches=3)
    q.enable_int8_kws_encoder(calibration_batches=3)
    asr = q.generator.params
    # a vacant packed slot (real_rows False) never enters the calibration set
    q.spot_keywords(MELS[0], real_rows=[False, True])
    assert q._enc_int8_pending and len(q._enc_int8_mels) == 1
    torch.testing.assert_close(q._enc_int8_mels[0], torch.from_numpy(MELS[0][1]), rtol=0, atol=0)
    q._enc_int8_mels = []

    spotted = {"jax": [], "f32": [], "int8": []}
    for mel in MELS:
        spotted["jax"].append(jax_cb.spot_keywords(mel))
        spotted["f32"].append(f32.spot_keywords(mel))
        spotted["int8"].append(q.spot_keywords(mel))
        if len(spotted["int8"]) == 1:  # 2 of 3 segments seen: still f32
            assert q._enc_int8_pending
    assert not q._enc_int8_pending and not jax_cb._enc_int8_pending
    assert "act_scales" in q.encoder_params["encoder"]["layers"][0]
    np.testing.assert_allclose(
        np.stack([[float(layer["act_scales"][s]) for s in tw._ENC_ACT_SITES]
                  for layer in q.encoder_params["encoder"]["layers"]]),
        np.stack([np.asarray(jax_cb.encoder_params["encoder"]["layers"]["act_scales"][s])
                  for s in jw._ENC_ACT_SITES], axis=1), rtol=1e-5)
    assert spotted["int8"] == spotted["jax"] == spotted["f32"]
    flat = [k for segs in spotted["int8"] for k in segs]
    assert {len(k) for k in flat} - {0} and min(len(k) for k in flat) < len(KEYWORDS)
    assert q.generator.params is asr and "act_scales" not in asr["encoder"]["layers"][0]
