"""The port's paper-2 model (``efficient_kws/model.py``), its weight
conversions and its reference-checkpoint loader against the JAX package's,
on the CPU at tiny dims (2 layers, D 16, U 8, ResNet-18).

The same seeded inputs (random frame masks) and the same weights (the JAX
package's initialization, with random BatchNorm statistics so the eval-mode
normalizations are not identities, converted by
``from_flax_efficient_variables``) go through both packages:

* the L/LE/LEF forwards (logits and similarity maps), ``masked_sims`` with
  a broadcast utterance, ``_pool_mask`` and ``project``: rtol 1e-4 / atol
  1e-5, the JAX tests' own tolerance (``tests/test_efficient_kws_model.py``);
* bf16 (projection stack and ResNet): the port's bf16 outputs against
  JAX's f32 ones within twice JAX's own bf16-to-f32 distance (bf16 on the
  CPU rounds where XLA keeps fused chains in f32, so no element need match);
* ``to_flax_variables`` inverts the conversion bit for bit, and
  ``load_torch_efficient_kws`` on a reference-layout state dict the test
  writes (``lightning_efficient_kws``) gives JAX's loader's forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhance_cb_whisper_tpu.efficient_kws import model as jm
from enhance_cb_whisper_tpu.efficient_kws.torch_compat import load_torch_efficient_kws as jax_load
from enhance_cb_whisper_tpu_torch.convert import from_flax_efficient_variables, to_flax_variables
from enhance_cb_whisper_tpu_torch.efficient_kws import model as pm
from enhance_cb_whisper_tpu_torch.efficient_kws.torch_compat import (
    lightning_efficient_kws,
    load_torch_efficient_kws,
)

L, D, U = 2, 16, 8
RTOL, ATOL = 1e-4, 1e-5
VARIANTS = {
    "L": dict(),
    "LE": dict(learn_features=True, proj_mlp=True),
    "LEF": dict(learn_features=True, proj_mlp=True, frames_conv=True),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(module, variant, **extra):
    return module.EfficientKWSConfig(n_layers=L, embedding_dim=D, proj_mlp_units=U,
                                     resnet_version="resnet-18", **VARIANTS[variant], **extra)


def _inputs(b=3, tk=10, tu=21, seed=0):
    rng = np.random.default_rng(seed)
    kwd = rng.standard_normal((b, L, tk, D)).astype(np.float32)
    utt = rng.standard_normal((1, L, tu, D)).astype(np.float32)
    kwd[0, :, -3:] = 0.0  # padded frames are zero vectors
    kwd_mask = (rng.random((b, L, tk)) > 0.2).astype(np.float32)
    utt_mask = (rng.random((1, L, tu)) > 0.1).astype(np.float32)
    return kwd, utt, kwd_mask, utt_mask


def _random_stats(variables, seed):
    """Random running means and variances for every BatchNorm."""
    rng = np.random.default_rng(seed)

    def fill(path, x):
        name = jax.tree_util.keystr(path)
        x = np.asarray(x)
        if name.endswith("['mean']"):
            return rng.normal(0, 0.1, x.shape).astype(np.float32)
        return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)

    return {**variables, "batch_stats": jax.tree_util.tree_map_with_path(fill, variables["batch_stats"])}


_MODELS = {}


def _models(variant):
    """(JAX module, JAX variables, port model), built once per variant."""
    if variant not in _MODELS:
        kwd, utt, km, um = _inputs()
        jmodel = jm.EfficientKWSModel(_config(jm, variant))
        variables = jax.jit(jmodel.init)(jax.random.PRNGKey(1), kwd, utt, km, um)
        variables = _random_stats(jax.tree.map(np.asarray, variables), seed=2)
        port = pm.EfficientKWSModel(_config(pm, variant)).load_converted(
            from_flax_efficient_variables(variables)).eval()
        _MODELS[variant] = (jmodel, variables, port)
    return _MODELS[variant]


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_matches_jax(variant):
    jmodel, variables, port = _models(variant)
    kwd, utt, km, um = _inputs(seed=3)
    want_logits, want_sims = jax.jit(jmodel.apply)(variables, kwd, utt, km, um)
    with torch.no_grad():
        logits, sims = port(_t(kwd), _t(utt), _t(km), _t(um))
    frames = (5, 11) if variant == "LEF" else (10, 21)
    assert sims.shape == (3, L, *frames)
    np.testing.assert_allclose(sims.numpy(), np.asarray(want_sims), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("variant", ["LE", "LEF"])
def test_project_matches_jax(variant):
    jmodel, variables, port = _models(variant)
    kwd, _, km, _ = _inputs(seed=4)
    want, want_mask = jax.jit(lambda v, x, m: jmodel.apply(v, x, m, method=jm.EfficientKWSModel.project))(
        variables, kwd, km)
    with torch.no_grad():
        got, got_mask = port.project(_t(kwd), _t(km))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))


def test_masked_sims_and_pool_mask_match_jax():
    kwd, utt, km, um = _inputs(b=4, seed=5)
    want = np.asarray(jm.masked_sims(jnp.asarray(kwd), jnp.asarray(utt), jnp.asarray(km), jnp.asarray(um)))
    got = pm.masked_sims(_t(kwd), _t(utt), _t(km), _t(um))
    assert got.shape == (4, L, 10, 21)  # [1, ...] utterance broadcast over 4 keywords
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert (got.numpy()[0, :, -3:] == 0).all()  # zero vectors: finite, zero similarity
    for t in (1, 2, 7, 8, 21):
        mask = (np.random.default_rng(t).random((2, L, t)) > 0.6).astype(np.float32)
        np.testing.assert_array_equal(pm._pool_mask(_t(mask)).numpy(),
                                      np.asarray(jm._pool_mask(jnp.asarray(mask))))
    a, b = kwd[0], utt[0]
    np.testing.assert_allclose(pm.sim_matrix(_t(a), _t(b)).numpy(),
                               np.asarray(jm.sim_matrix(jnp.asarray(a), jnp.asarray(b))), rtol=RTOL, atol=ATOL)


def test_bfloat16_within_jax_bf16_distance():
    jmodel, variables, port = _models("LEF")
    kwd, utt, km, um = _inputs(seed=6)
    want_logits, want_sims = (np.asarray(x) for x in jax.jit(jmodel.apply)(variables, kwd, utt, km, um))
    jbf = jm.EfficientKWSModel(_config(jm, "LEF"), dtype=jnp.bfloat16)
    ref_logits, ref_sims = (np.asarray(x, np.float32) for x in jax.jit(jbf.apply)(variables, kwd, utt, km, um))
    bf = pm.EfficientKWSModel(_config(pm, "LEF"), dtype=torch.bfloat16).load_converted(
        from_flax_efficient_variables(variables)).eval()
    with torch.no_grad():
        logits, sims = bf(_t(kwd), _t(utt), _t(km), _t(um))
        proj, _ = bf.project(_t(kwd), _t(km))
    assert proj.dtype == torch.bfloat16 and logits.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in bf.parameters())
    for got, ref, want in ((sims.numpy(), ref_sims, want_sims), (logits.numpy(), ref_logits, want_logits)):
        jax_gap = np.abs(ref - want).max()
        assert 0 < jax_gap < 0.1
        assert np.abs(got - want).max() <= 2 * jax_gap


@pytest.mark.parametrize("variant", ["L", "LEF"])
def test_conversions_and_reference_checkpoint(variant):
    jmodel, variables, port = _models(variant)
    back = to_flax_variables(port.state_dict())
    flat = lambda tree: {jax.tree_util.keystr(k): np.asarray(v)  # noqa: E731
                         for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    want = flat({"params": variables["params"], "batch_stats": variables["batch_stats"]})
    got = flat(back)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    reference = lightning_efficient_kws(port.state_dict(), port.config)
    assert "model.feature_extractor.embedder.embedder.convolution.weight" in reference
    assert "model.classifier.1.weight" in reference
    if variant == "LEF":
        assert reference["time_projector.1.0.weight"].shape == (U, U, 3)
        assert "time_projector.0.1.running_var" in reference and "projector.1.2.bias" in reference
    jax_vars = jax_load({"state_dict": reference}, _config(jm, variant))
    loaded = pm.EfficientKWSModel(_config(pm, variant)).load_converted(
        load_torch_efficient_kws({"state_dict": reference}, port.config)).eval()
    kwd, utt, km, um = _inputs(seed=7)
    want_logits, _ = jax.jit(jmodel.apply)(jax_vars, kwd, utt, km, um)
    with torch.no_grad():
        logits, _ = loaded(_t(kwd), _t(utt), _t(km), _t(um))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=RTOL, atol=ATOL)
