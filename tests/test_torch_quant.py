"""The port's int8 ResNet (models/quant.py) against the JAX package's, from
the same flax variables (BatchNorm statistics perturbed so the fold is
exercised).

* Fold and quantize: identical int8 codes, equal scales and biases — both
  run the same numpy arithmetic on the same weights.
* Calibration: the scales agree to f32 summation order (rtol 1e-4: each is
  a max of |activation| of an f32 conv whose sums run in another order).
* ``quantized_apply`` with JAX's scales fed to both, in the static,
  dynamic, mixed (``float_stages``) and fused-kernel (``s8_1x1`` against
  JAX's ``pallas_1x1``, Pallas in interpret mode) modes, for bottleneck and
  basic blocks: identical decisions, logits within atol 1e-5.  Every
  integer convolution accumulates exactly and the epilogues round the same
  values in the same steps, so the int8 codes coincide; what is left is the
  order of f32 sums (mean pool, the float stages' convolutions): up to
  5.4e-7 on logits of order 0.1-1.5 here.
"""

import jax
import numpy as np
import pytest
import torch

from enhance_cb_whisper_tpu.models.kws import KWSModel as JaxKWS
from enhance_cb_whisper_tpu.models.quant import calibrate_act_scales as jax_calibrate
from enhance_cb_whisper_tpu.models.quant import quantize_resnet_classifier as jax_quantize
from enhance_cb_whisper_tpu.models.quant import quantized_apply as jax_apply
from enhance_cb_whisper_tpu.models.resnet import ResNetConfig as JaxResNetConfig
from enhance_cb_whisper_tpu_torch.convert import from_flax_resnet_variables, from_jax_quantized_params
from enhance_cb_whisper_tpu_torch.models import quant
from enhance_cb_whisper_tpu_torch.models.kws import KWSModel
from enhance_cb_whisper_tpu_torch.models.resnet import ResNetConfig

N_LAYERS = 3
HW = (32, 32)
CONFIGS = {
    # stage_1 widths are 128-multiples (the fused kernel's rule); depths
    # (1, 3) give a shortcut block, fused int8 tails and a last float tail
    "bottleneck": dict(num_channels=N_LAYERS, embedding_size=32, hidden_sizes=(128, 512),
                       depths=(1, 3), layer_type="bottleneck", num_labels=2),
    "basic": dict(num_channels=N_LAYERS, embedding_size=8, hidden_sizes=(8, 16, 24),
                  depths=(1, 2, 1), layer_type="basic", num_labels=2),
}


def _perturb_bn(tree, rng, in_stats=False):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb_bn(v, rng, in_stats or k == "normalization")
        elif in_stats and k == "mean":
            out[k] = rng.normal(0, 0.2, v.shape).astype(np.float32)
        elif in_stats and k == "var":
            out[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        elif in_stats and k == "scale":
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif in_stats and k == "bias":
            out[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def models(request):
    layer_type = request.param
    jcfg, tcfg = JaxResNetConfig(**CONFIGS[layer_type]), ResNetConfig(**CONFIGS[layer_type])
    rng = np.random.default_rng(11)
    variables = JaxKWS(jcfg).init(jax.random.PRNGKey(0), np.zeros((1, N_LAYERS, *HW), np.float32))
    variables = {"params": _perturb_bn(variables["params"], rng),
                 "batch_stats": _perturb_bn(variables["batch_stats"], rng, True)}
    model = KWSModel(tcfg).load_converted(from_flax_resnet_variables(variables)).eval()
    calib = rng.standard_normal((8, N_LAYERS, *HW)).astype(np.float32)
    x = rng.standard_normal((8, N_LAYERS, *HW)).astype(np.float32)
    jq = jax_calibrate(jcfg, jax_quantize(variables, jcfg), calib)
    return layer_type, jcfg, tcfg, variables, model, calib, x, jq


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_fold_and_quantize_match_jax(models):
    _, jcfg, tcfg, variables, model, *_ = models
    want = jax_quantize(variables, jcfg)
    got = quant.quantize_resnet_classifier(model, tcfg)
    want_leaves, got_leaves = dict(_leaves(want)), dict(_leaves(got))
    assert sorted(want_leaves) == sorted(got_leaves)
    for name, w in want_leaves.items():
        g = got_leaves[name].numpy()
        if name.endswith(".wq"):
            assert g.dtype == np.int8
            g = g.transpose(2, 3, 1, 0)  # [out, in, kh, kw] → JAX's [kh, kw, in, out]
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)


def test_calibration_matches_jax(models):
    _, _, tcfg, _, model, calib, _, jq = models
    got = quant.calibrate_act_scales(tcfg, quant.quantize_resnet_classifier(model, tcfg), calib)
    want = jq["act_scales"]
    assert sorted(got["act_scales"]) == sorted(want)
    for site, s in want.items():
        np.testing.assert_allclose(got["act_scales"][site], s, rtol=1e-4, err_msg=site)


MODES = {
    "static": dict(scales=True),
    "dynamic": dict(scales=False),
    "float_stages": dict(scales=True, float_stages=("stem", "stage_0")),
    "s8_1x1": dict(scales=True, s8=("stage_1",)),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_quantized_apply_matches_jax(models, mode):
    layer_type, jcfg, tcfg, _, _, _, x, jq = models
    spec = MODES[mode]
    jparams = jq if spec["scales"] else {k: v for k, v in jq.items() if k != "act_scales"}
    fs, s8 = spec.get("float_stages", ()), spec.get("s8", ())
    want = np.asarray(jax_apply(jcfg, jparams, x, float_stages=fs, pallas_1x1=s8))
    got = quant.quantized_apply(
        tcfg, from_jax_quantized_params(jparams, device="cpu"), torch.from_numpy(x),
        float_stages=fs, s8_1x1=s8,
    ).numpy()
    assert got.shape == want.shape == (8, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.array_equal(np.argmax(got, -1), np.argmax(want, -1))
    # a random head decides every map alike; the decisions against the
    # median margin split the batch, and must agree too
    margin = want[:, 1] - want[:, 0]
    cut = np.median(margin)
    assert 0 < (margin > cut).sum() < len(margin)
    assert np.array_equal(got[:, 1] - got[:, 0] > cut, margin > cut)


def test_s8_path_goes_through_the_kernel_wrapper(models, monkeypatch):
    """With ``s8_1x1`` the bottleneck 1×1 convs of the stage call the fused
    kernel's entry: for stage_1 of depth 3, three layer_0 reduces and one
    fused tail (block 1 hands codes to block 2; block 0 has a shortcut and
    block 2 is the last).  Basic blocks never call it."""
    layer_type, _, tcfg, _, _, _, x, jq = models
    from enhance_cb_whisper_tpu_torch.ops import matmul_s8_cuda

    calls = []
    real = matmul_s8_cuda.matmul_s8_requant
    monkeypatch.setattr(matmul_s8_cuda, "matmul_s8_requant",
                        lambda *a, **k: calls.append(tuple(a[0].shape)) or real(*a, **k))
    quant.quantized_apply(tcfg, from_jax_quantized_params(jq, device="cpu"),
                          torch.from_numpy(x), s8_1x1=("stage_1",))
    if layer_type == "basic":
        assert calls == []
    else:  # M = 8 maps x 8 x 8 positions into block 0, x 4 x 4 after its stride 2
        assert calls == [(512, 128), (128, 512), (128, 128), (128, 512)]
