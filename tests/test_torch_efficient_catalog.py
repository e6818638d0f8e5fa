"""The port's pre-projected catalog scoring (``efficient_kws/catalog.py``)
against the JAX package's, on the CPU at tiny dims (2 layers, D 16, U 8,
ResNet-18; chunks of 4 keywords).

* ``project_catalog`` (padding included) and ``make_projected_score_fn``
  for LE and LEF: rtol 1e-4 / atol 1e-5 against JAX, the JAX tests' own;
  the projected scores equal the direct forward per group within the same;
* the cascade: at a full shortlist bit-equal to the port's full scorer
  (stage 2 is the same chunk classifier on gathered rows) and within 1e-5
  of JAX's cascade; a keyword planted in the utterance survives a
  shortlist of 8, whose rows equal the full scorer's and every other row
  is 0; the f32 proxy the same; int8 stage 2 equal to the full int8
  scorer; the shortlist order equal to ``lax.top_k``'s on tied proxies;
* ``maxsim_proxy_fast`` (bf16 operands, f32 sums) against the exact proxy
  within atol 2e-2 (the JAX test's tolerance) and against JAX's fast proxy
  within 1e-5; ``maxsim_proxy`` against JAX's within 1e-5;
* unpadded catalogs and shortlists off the chunk raise;
* the cascade records one ``ecw.catalog.proxy`` span a call (``launches``
  0 on the CPU), and its probabilities do not depend on recording;
* ``maxsim_proxy_fast`` over a whole catalog on the CPU equals today's
  per-chunk calls of its plain version (ragged N, partial masks, LEF- and
  L-like shapes scaled down); the cascade calls it once per utterance by
  its module name, over every row; CPU tensors never reach kernel K3's
  wrapper; K3's launch plan at the paper-2 configs' shapes, and what it
  refuses.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enhance_cb_whisper_tpu.efficient_kws import catalog as jc
from enhance_cb_whisper_tpu.efficient_kws import model as jm
from enhance_cb_whisper_tpu.models.quant import calibrate_act_scales as jax_calibrate
from enhance_cb_whisper_tpu.models.quant import quantize_efficient_classifier as jax_quantize
from enhance_cb_whisper_tpu_torch.convert import from_flax_efficient_variables
from enhance_cb_whisper_tpu_torch.efficient_kws import catalog as pc
from enhance_cb_whisper_tpu_torch.efficient_kws import model as pm
from enhance_cb_whisper_tpu_torch.models.quant import calibrate_act_scales, quantize_efficient_classifier
from enhance_cb_whisper_tpu_torch.ops import maxsim_cuda
from enhance_cb_whisper_tpu_torch.runtime import profiler

L, D, U, CHUNK = 2, 16, 8, 4
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(module, variant):
    return module.EfficientKWSConfig(n_layers=L, embedding_dim=D, learn_features=True, proj_mlp=True,
                                     proj_mlp_units=U, frames_conv=variant == "LEF",
                                     resnet_version="resnet-18")


def _groups(rng, n_groups=4, g=4, tk=16, last=3):
    """Groups of ``g`` keywords, the last one of ``last`` with a ghost."""
    out = []
    for i in range(n_groups):
        n = last if i == n_groups - 1 else g
        mask = np.ones((n,), np.float32)
        kwd = rng.standard_normal((n, L, tk, D)).astype(np.float32)
        if i == n_groups - 1:
            mask[-1], kwd[-1] = 0.0, 0.0
        out.append({"kwd": kwd, "kwd_mask": (rng.random((n, L, tk)) > 0.1).astype(np.float32),
                    "mask": mask})
    return out


_FIXTURES = {}


def _fixture(variant):
    """(JAX module, variables, port model, groups, utt, utt_mask), once per
    variant; keyword 5 is planted verbatim in the utterance at frames 20:36."""
    if variant not in _FIXTURES:
        rng = np.random.default_rng(3)
        groups = _groups(rng)
        groups[1]["kwd_mask"][1] = 1.0
        utt = rng.standard_normal((1, L, 64, D)).astype(np.float32)
        utt[0, :, 20:36] = groups[1]["kwd"][1]
        utt_mask = np.ones((1, L, 64), np.float32)
        utt_mask[0, :, -6:] = 0.0
        jmodel = jm.EfficientKWSModel(_config(jm, variant))
        variables = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
            jax.random.PRNGKey(0), groups[0]["kwd"], utt, groups[0]["kwd_mask"], utt_mask))
        port = pm.EfficientKWSModel(_config(pm, variant)).load_converted(
            from_flax_efficient_variables(variables)).eval()
        _FIXTURES[variant] = (jmodel, variables, port, groups, utt, utt_mask)
    return _FIXTURES[variant]


def _jax_catalog(variant):
    jmodel, variables, _, groups, _, _ = _fixture(variant)
    return jc.project_catalog(jmodel, variables, groups, chunk=CHUNK)


@pytest.mark.parametrize("variant", ["LE", "LEF"])
def test_projected_scoring_matches_jax_and_the_direct_forward(variant):
    jmodel, variables, port, groups, utt, utt_mask = _fixture(variant)
    want_cat = _jax_catalog(variant)
    catalog = pc.project_catalog(port, groups, chunk=CHUNK)
    assert catalog["num_keywords"] == want_cat["num_keywords"] == 15 and catalog["kwd"].shape[0] == 16
    for key in ("kwd", "kwd_mask", "mask"):
        np.testing.assert_allclose(catalog[key].numpy(), np.asarray(want_cat[key]), rtol=RTOL, atol=ATOL)
    want = np.asarray(jc.make_projected_score_fn(jmodel, chunk=CHUNK)(variables, want_cat, utt, utt_mask))
    got = pc.make_projected_score_fn(port, chunk=CHUNK)(catalog, utt, utt_mask).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert got[15] == 0 and got[14] == 0  # the padded row and the ghost
    with torch.no_grad():
        direct = np.concatenate([
            torch.softmax(port(torch.from_numpy(g["kwd"]), torch.from_numpy(utt),
                               torch.from_numpy(g["kwd_mask"]), torch.from_numpy(utt_mask))[0], -1)[:, 1].numpy()
            * g["mask"] for g in groups])
    np.testing.assert_allclose(got[:15], direct, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("variant", ["LE", "LEF"])
def test_cascade_full_shortlist_is_the_full_scorer(variant):
    jmodel, variables, port, groups, utt, utt_mask = _fixture(variant)
    catalog = pc.project_catalog(port, groups, chunk=CHUNK)
    full = pc.make_projected_score_fn(port, chunk=CHUNK)(catalog, utt, utt_mask)
    casc = pc.make_cascade_score_fn(port, chunk=CHUNK, shortlist=16)(catalog, utt, utt_mask)
    assert torch.equal(casc, full)
    want = np.asarray(jc.make_cascade_score_fn(jmodel, chunk=CHUNK, shortlist=16)(
        variables, _jax_catalog(variant), utt, utt_mask))
    np.testing.assert_allclose(casc.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("proxy_dtype", ["bfloat16", "float32"])
def test_cascade_planted_match_survives_the_shortlist(proxy_dtype):
    jmodel, variables, port, groups, utt, utt_mask = _fixture("LE")
    catalog = pc.project_catalog(port, groups, chunk=CHUNK)
    full = pc.make_projected_score_fn(port, chunk=CHUNK)(catalog, utt, utt_mask)
    got = pc.make_cascade_score_fn(port, chunk=CHUNK, shortlist=8, proxy_dtype=proxy_dtype)(
        catalog, utt, utt_mask)
    nonzero = torch.nonzero(got).ravel()
    assert 5 in nonzero.tolist() and len(nonzero) <= 8
    assert torch.equal(got[nonzero], full[nonzero])
    want = np.asarray(jc.make_cascade_score_fn(jmodel, chunk=CHUNK, shortlist=8, proxy_dtype=proxy_dtype)(
        variables, _jax_catalog("LE"), utt, utt_mask))
    assert set(np.flatnonzero(want)) == set(nonzero.tolist())
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_cascade_int8_stage2_matches_full_int8():
    jmodel, variables, port, groups, utt, utt_mask = _fixture("LEF")
    rcfg = port.config.resnet_config()
    catalog = pc.project_catalog(port, groups, chunk=CHUNK)
    qparams = quantize_efficient_classifier(port, rcfg)
    with torch.no_grad():
        utt_p, utt_mask_p = port.project(torch.from_numpy(utt), torch.from_numpy(utt_mask))
        sims = pm.masked_sims(catalog["kwd"][:CHUNK], utt_p, catalog["kwd_mask"][:CHUNK], utt_mask_p)
    scales = calibrate_act_scales(rcfg, qparams, sims)["act_scales"]
    kw = dict(quantized_params=qparams, act_scales=scales)
    full = pc.make_projected_score_fn(port, chunk=CHUNK, **kw)(catalog, utt, utt_mask)
    got = pc.make_cascade_score_fn(port, chunk=CHUNK, shortlist=8, **kw)(catalog, utt, utt_mask)
    nonzero = torch.nonzero(got).ravel()
    assert 0 < len(nonzero) <= 8
    assert torch.equal(got[nonzero], full[nonzero])
    # the same codes as JAX's quantizer, and the int8 scores within its
    # engine tests' 1e-3 (XLA's fused requant may round a code at a .5)
    jq = jax_quantize(variables, _config(jm, "LEF").resnet_config())
    np.testing.assert_array_equal(qparams["stage_1_block_0"]["layer_0"]["wq"].numpy(),
                                  np.asarray(jq["stage_1_block_0"]["layer_0"]["wq"]).transpose(3, 2, 0, 1))
    jcat = _jax_catalog("LEF")
    jutt_p, jutt_mask_p = jmodel.apply(variables, utt, utt_mask, method=jm.EfficientKWSModel.project)
    jscales = jax_calibrate(_config(jm, "LEF").resnet_config(), jq,
                            jm.masked_sims(jcat["kwd"][:CHUNK], jutt_p, jcat["kwd_mask"][:CHUNK], jutt_mask_p))
    want = np.asarray(jc.make_projected_score_fn(
        jmodel, chunk=CHUNK, quantized_params=jq, act_scales=jscales["act_scales"])(variables, jcat, utt, utt_mask))
    np.testing.assert_allclose(full.numpy(), want, rtol=0, atol=1e-3)


def test_proxies_match_jax():
    rng = np.random.default_rng(11)
    c, tk, tu = 16, 12, 40
    kwd = rng.standard_normal((c, L, tk, U)).astype(np.float32)
    utt = rng.standard_normal((1, L, tu, U)).astype(np.float32)
    kwd_mask = (rng.random((c, L, tk)) > 0.2).astype(np.float32)
    kwd_mask[3] = 0.0  # a keyword with no valid frame
    utt_mask = (rng.random((1, L, tu)) > 0.1).astype(np.float32)
    t = torch.from_numpy
    exact = pc.maxsim_proxy(t(kwd), t(utt), t(kwd_mask), t(utt_mask))
    fast = pc.maxsim_proxy_fast(t(kwd), pm._safe_normalize(t(utt), 1e-6)[0], t(kwd_mask), t(utt_mask))
    assert exact.dtype == fast.dtype == torch.float32 and torch.isfinite(exact).all()
    np.testing.assert_allclose(fast.numpy(), exact.numpy(), rtol=0, atol=2e-2)
    want_exact = np.asarray(jc.maxsim_proxy(kwd, utt, kwd_mask, utt_mask))
    want_fast = np.asarray(jc.maxsim_proxy_fast(kwd, jm._safe_normalize(jnp.asarray(utt), 1e-6)[0],
                                                kwd_mask, utt_mask))
    np.testing.assert_allclose(exact.numpy(), want_exact, rtol=0, atol=1e-5)
    np.testing.assert_allclose(fast.numpy(), want_fast, rtol=0, atol=1e-5)


def test_shortlist_order_breaks_ties_as_lax_top_k():
    proxy = np.array([0.5, 0.9, 0.5, -np.inf, 0.9, 0.1, -np.inf, 0.5, -np.inf], np.float32)
    for k in (2, 4, 6, 9):
        want = np.asarray(jax.lax.top_k(jnp.asarray(proxy), k)[1])
        np.testing.assert_array_equal(pc.shortlist_rows(torch.from_numpy(proxy), k).numpy(), want)


def test_bad_catalog_and_shortlist_raise():
    _, _, port, groups, utt, utt_mask = _fixture("LE")
    catalog = pc.project_catalog(port, groups, chunk=CHUNK)
    short = {**catalog, "kwd": catalog["kwd"][:10], "kwd_mask": catalog["kwd_mask"][:10]}
    with pytest.raises(AssertionError, match="multiple of chunk"):
        pc.make_projected_score_fn(port, chunk=CHUNK)(short, utt, utt_mask)
    with pytest.raises(AssertionError, match="multiple of chunk"):
        pc.make_cascade_score_fn(port, chunk=CHUNK, shortlist=6)
    with pytest.raises(AssertionError, match="exceeds"):
        pc.make_cascade_score_fn(port, chunk=CHUNK, shortlist=32)(catalog, utt, utt_mask)


@pytest.mark.parametrize("proxy_dtype", ["bfloat16", "float32"])
def test_cascade_proxy_span_and_recording_change_nothing(proxy_dtype):
    """One ``ecw.catalog.proxy`` span per cascade call, over every chunk;
    the probabilities are the same bits with recording on and off."""
    _, _, port, groups, utt, utt_mask = _fixture("LE")
    catalog = pc.project_catalog(port, groups, chunk=CHUNK)
    score = pc.make_cascade_score_fn(port, chunk=CHUNK, shortlist=8, proxy_dtype=proxy_dtype)
    t0 = time.perf_counter()
    on = [score(catalog, utt, utt_mask) for _ in range(2)]
    got = [s for s in profiler.spans(since_s=t0) if s["name"] == "ecw.catalog.proxy"]
    assert len(got) == 2
    assert all(s["attrs"] == {"chunks": catalog["kwd"].shape[0] // CHUNK, "launches": 0}
               and s["device_ms"] is None for s in got)
    previous = profiler.set_recording(False)
    try:
        t1 = time.perf_counter()
        off = score(catalog, utt, utt_mask)
        assert profiler.spans(since_s=t1) == []
    finally:
        profiler.set_recording(previous)
    assert torch.equal(on[0], off) and torch.equal(on[1], off)


def _proxy_inputs(rng, n, layers, tk, tu, units, dtype):
    """A catalog of ``n`` keywords with partial keyword masks (some keywords
    all masked, their masked frames zero) and an utterance whose mask has
    holes and a masked tail."""
    kwd_mask = (rng.random((n, layers, tk)) > 0.3).astype(np.float32)
    kwd_mask[::9] = 0.0
    kwd = rng.standard_normal((n, layers, tk, units)).astype(np.float32) * kwd_mask[..., None]
    utt = rng.standard_normal((1, layers, tu, units)).astype(np.float32)
    utt_mask = (rng.random((1, layers, tu)) > 0.2).astype(np.float32)
    utt_mask[:, :, -(tu // 5):] = 0.0
    t = torch.from_numpy
    return (t(kwd).to(dtype), pm._safe_normalize(t(utt), 1e-6)[0], t(kwd_mask).to(dtype), t(utt_mask))


@pytest.mark.parametrize("shape", [(3, 15, 150, 64), (2, 30, 300, 256)], ids=["LEF", "L"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_whole_catalog_proxy_equals_the_chunked_calls(shape, dtype):
    """One ``maxsim_proxy_fast`` call over a ragged catalog of 300 rows on
    the CPU (blocks of ``PLAIN_ROWS``) = the per-chunk calls the cascade
    made before, at the cell's chunk of 128 and at a chunk of 7."""
    layers, tk, tu, units = shape
    kwd, utt_n, kwd_mask, utt_mask = _proxy_inputs(np.random.default_rng(5), 300, layers, tk, tu, units, dtype)
    whole = pc.maxsim_proxy_fast(kwd, utt_n, kwd_mask, utt_mask)
    assert whole.shape == (300,) and whole.dtype == torch.float32 and torch.isfinite(whole).all()
    for chunk in (128, 7):
        parts = torch.cat([pc.maxsim_proxy_fast_plain(kwd[i:i + chunk], utt_n, kwd_mask[i:i + chunk], utt_mask)
                           for i in range(0, 300, chunk)])
        np.testing.assert_allclose(whole.numpy(), parts.numpy(), rtol=0, atol=1e-6)
    assert torch.equal(whole[::9], torch.zeros(34))  # keywords with no valid frame


def test_cascade_calls_the_proxy_by_module_name_once_over_every_row(monkeypatch):
    """A wrapper installed as perfbench's catalog driver installs its own
    sees one call per utterance, whose result covers the catalog's rows."""
    _, _, port, groups, utt, utt_mask = _fixture("LEF")
    catalog = pc.project_catalog(port, groups, chunk=CHUNK)
    want = pc.make_cascade_score_fn(port, chunk=CHUNK, shortlist=8)(catalog, utt, utt_mask)
    proxy_fast, calls = pc.maxsim_proxy_fast, []

    def proxy(*args, **kwargs):
        out = proxy_fast(*args, **kwargs)
        calls.append(out)
        return out

    monkeypatch.setattr(pc, "maxsim_proxy_fast", proxy)
    score = pc.make_cascade_score_fn(port, chunk=CHUNK, shortlist=8)
    for k in range(2):
        assert torch.equal(score(catalog, utt, utt_mask), want)
        assert len(calls) == k + 1 and calls[-1].shape == (catalog["kwd"].shape[0],)


def test_cpu_tensors_never_reach_the_kernel(monkeypatch):
    """On the CPU the cascade's proxy is the plain version: K3's wrapper is
    not called and its launch count does not move."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the K3 wrapper")

    wrapper = maxsim_cuda.maxsim_proxy
    monkeypatch.setattr(maxsim_cuda, "maxsim_proxy", refuse)
    _, _, port, groups, utt, utt_mask = _fixture("LE")
    catalog = pc.project_catalog(port, groups, chunk=CHUNK)
    before = maxsim_cuda.kernel.launches
    pc.make_cascade_score_fn(port, chunk=CHUNK, shortlist=8)(catalog, utt, utt_mask)
    kwd, utt_n, kwd_mask, umask = _proxy_inputs(np.random.default_rng(2), 10, L, 6, 20, U, torch.float32)
    assert pc.maxsim_proxy_fast(kwd, utt_n, kwd_mask, umask).shape == (10,)
    assert pc.maxsim_proxy_fast(kwd[:0], utt_n, kwd_mask[:0], umask).shape == (0,)
    assert maxsim_cuda.kernel.launches == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        wrapper(kwd, utt_n, kwd_mask, umask[0])


@pytest.mark.parametrize("variant, shape, bm, stages", [
    ("LEF", (100352, 3, 75, 750, 64), 256, 4),
    ("LE", (100352, 3, 150, 1500, 64), 256, 4),
    ("L", (4096, 3, 150, 1500, 1024), 64, 4),
    ("ragged", (1001, 2, 7, 130, 128), 64, 4),
    ("one tile", (5, 1, 3, 40, 64), 256, 1),
    ("dry run's U 8", (16, 2, 16, 32, 8), 256, 1),
    ("U 96", (300, 2, 20, 300, 96), 64, 4),
])
def test_k3_launch_plan_at_the_configs_shapes(variant, shape, bm, stages):
    """The paper-2 configs' shapes (eval-{LEF,LE,L}-*.yaml) and ragged ones:
    one block per BM frames of a layer, the tile chosen from U, a ring no
    deeper than the tiles to stream, within the shared memory a block has."""
    n, layers, tk, tu, units = shape
    plan = maxsim_cuda.launch_plan(n, layers, tk, tu, units)
    assert (plan.bm, plan.stages) == (bm, stages)
    assert plan.n_tiles * maxsim_cuda.BN >= tu > (plan.n_tiles - 1) * maxsim_cuda.BN
    assert plan.blocks * plan.bm >= n * tk * layers and plan.smem <= maxsim_cuda.SMEM_LIMIT
    if units <= 64:
        assert 2 * plan.smem <= 228 * 1024  # two blocks to an SM


@pytest.mark.parametrize("shape", [(10, 3, 75, 750, 12), (10, 3, 75, 750, 4), (0, 3, 75, 750, 64),
                                   (10, 3, 75, 40000, 1024)])
def test_k3_launch_plan_refuses_what_the_kernel_does_not_take(shape):
    with pytest.raises(ValueError):
        maxsim_cuda.launch_plan(*shape)
