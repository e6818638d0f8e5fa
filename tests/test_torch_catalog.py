"""Port keyword-spotting scorer vs the JAX package: resize weights, cosine
similarity, the ResNet KWS classifier (basic and bottleneck blocks,
converted from flax variables with non-trivial BatchNorm statistics) and
both einsum orders of the catalog scorer, down to identical class-1
decisions.

Tolerance: atol 1e-5 / rtol 1e-4 on logits and probabilities (fp32 on the
CPU both sides; conv and einsum summation orders differ)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhance_cb_whisper_tpu.catalog.database import KeywordCatalog as JaxCatalog
from enhance_cb_whisper_tpu.catalog.database import device_put_catalog as jax_put
from enhance_cb_whisper_tpu.catalog.database import make_catalog_score_fn as jax_score_fn
from enhance_cb_whisper_tpu.models.kws import KWSModel as JaxKWS
from enhance_cb_whisper_tpu.models.resnet import ResNetConfig as JaxResNetConfig
from enhance_cb_whisper_tpu.ops import resize as jresize
from enhance_cb_whisper_tpu.ops import sim as jsim
from enhance_cb_whisper_tpu_torch.catalog.database import KeywordCatalog, device_put_catalog, make_catalog_score_fn
from enhance_cb_whisper_tpu_torch.convert import from_flax_resnet_variables
from enhance_cb_whisper_tpu_torch.models.kws import KWSModel
from enhance_cb_whisper_tpu_torch.models.resnet import ResNetConfig
from enhance_cb_whisper_tpu_torch.ops import resize as tresize
from enhance_cb_whisper_tpu_torch.ops import sim as tsim

RTOL, ATOL = 1e-4, 1e-5
LAYERS = 2

RESNETS = {
    "bottleneck": dict(num_channels=LAYERS, embedding_size=8, hidden_sizes=(8, 16, 24, 32),
                       depths=(1, 2, 1, 1), layer_type="bottleneck", num_labels=2),
    "basic": dict(num_channels=LAYERS, embedding_size=8, hidden_sizes=(8, 16, 24, 32),
                  depths=(2, 1, 1, 1), layer_type="basic", num_labels=2),
}


def _kws_pair(kind: str, image_hw, seed: int = 0):
    """Flax KWS variables (random BN statistics) and the converted port model."""
    jmodel = JaxKWS(JaxResNetConfig(**RESNETS[kind]))
    variables = jmodel.init(jax.random.PRNGKey(seed), np.zeros((1, LAYERS, *image_hw), np.float32))
    rng = np.random.default_rng(seed)
    stats = jax.tree.map(
        lambda x: (rng.uniform(0.5, 1.5, x.shape) if x.ndim == 1 else x).astype(np.float32),
        variables["batch_stats"],
    )
    stats = jax.tree_util.tree_map_with_path(
        lambda path, x: x - 1.0 + rng.normal(0, 0.1, x.shape).astype(np.float32)
        if path[-1].key == "mean" else x,
        stats,
    )
    variables = {"params": variables["params"], "batch_stats": stats}
    tmodel = KWSModel(ResNetConfig(**RESNETS[kind])).load_converted(
        from_flax_resnet_variables(variables)
    ).eval()
    return jmodel, variables, tmodel


@pytest.mark.parametrize("antialias", [False, True])
def test_resize_matrix_is_the_jax_matrix(antialias):
    for n_in, n_out in [(7, 150), (1500, 750), (20, 8), (750, 750)]:
        np.testing.assert_array_equal(
            tresize.resize_matrix(n_in, n_out, antialias), jresize.resize_matrix(n_in, n_out, antialias)
        )


def test_similarity_primitives():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 5, 16)).astype(np.float32)
    b = rng.standard_normal((3, 9, 16)).astype(np.float32)
    np.testing.assert_allclose(
        tsim.l2_normalize(torch.from_numpy(a)).numpy(), np.asarray(jsim.l2_normalize(a)), rtol=RTOL, atol=ATOL
    )
    np.testing.assert_allclose(
        tsim.sim_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jsim.sim_matrix(a, b)), rtol=RTOL, atol=ATOL,
    )


@pytest.mark.parametrize("kind", ["bottleneck", "basic"])
def test_resnet_matches_flax(kind):
    jmodel, variables, tmodel = _kws_pair(kind, (32, 48))
    images = np.random.default_rng(1).standard_normal((3, LAYERS, 32, 48)).astype(np.float32)
    want = jmodel.apply(variables, images)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(images))
    np.testing.assert_allclose(got.features.numpy(), np.asarray(want.features), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits), rtol=RTOL, atol=ATOL)


# out_size (32, 48): keyword clips (<= 9 frames) are shorter than out_h, so
# the scorer contracts D first; (6, 48): T_k_max >= out_h, resize first
@pytest.mark.parametrize("out_size", [(32, 48), (6, 48)], ids=["tk<out_h", "tk>=out_h"])
@pytest.mark.parametrize("kind", ["bottleneck", "basic"])
def test_catalog_scorer_matches_jax(kind, out_size):
    rng = np.random.default_rng(2)
    dim, t_u = 16, 60
    keywords = [f"kw{i}" for i in range(11)]
    stacks = []
    for i in range(len(keywords)):
        if i == 4:
            stacks.append(None)  # a ghost keyword: zero features, mask 0
            continue
        s = rng.standard_normal((LAYERS, int(rng.integers(3, 10)), dim)).astype(np.float32)
        stacks.append(s / np.linalg.norm(s, axis=-1, keepdims=True))
    utt = rng.standard_normal((LAYERS, t_u, dim)).astype(np.float32)
    utt /= np.linalg.norm(utt, axis=-1, keepdims=True)
    utt_w = jresize.resize_matrix(t_u, out_size[1], antialias=False)

    jmodel, variables, tmodel = _kws_pair(kind, out_size, seed=3)
    jcat = JaxCatalog.from_arrays(keywords, stacks)
    tcat = KeywordCatalog.from_arrays(keywords, stacks)
    np.testing.assert_array_equal(tcat.resize_weights(out_size[0]), jcat.resize_weights(out_size[0]))

    j_score = jax_score_fn(lambda v, x: jmodel.apply(v, x).logits, out_size=out_size, chunk=8)
    j_probs, j_logits = j_score(variables, jax_put(jcat, out_h=out_size[0], chunk=8),
                                jnp.asarray(utt), jnp.asarray(utt_w))
    t_score = make_catalog_score_fn(lambda x: tmodel(x).logits, out_size=out_size)
    with torch.no_grad():
        t_probs, t_logits = t_score(device_put_catalog(tcat, out_h=out_size[0], chunk=8, device="cpu"),
                                    torch.from_numpy(utt), torch.from_numpy(utt_w))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_probs.numpy(), np.asarray(j_probs), rtol=RTOL, atol=ATOL)
    n = len(keywords)
    np.testing.assert_array_equal(
        torch.argmax(t_logits[:n], dim=-1).numpy(), np.asarray(jnp.argmax(j_logits[:n], axis=-1))
    )
