"""The port's model-sharded scoring and tensor-parallel encoder against the
JAX package's single-device functions, on the CPU (gloo, model=2).

One launch of 2 ranks runs every case (``tests/torch_parallel_ranks.py:
catalog_cases``):

* catalog scoring (``catalog/database.py:make_catalog_score_fn``) with the
  rows of 24 keywords (three chunks of 8: two on rank 0, one on rank 1)
  over ``model``, against JAX's ``make_catalog_score_fn`` (rtol 1e-4,
  atol 1e-6);
* paper 2's cascade over a model-sharded projected catalog with a planted
  match at row 5, against JAX's cascade (JAX ``parallel/dryrun.py`` stage
  2b, rtol 1e-4, atol 1e-6);
* the tensor-parallel Whisper encoder (4 heads, 2 a rank; random biases so
  the row-parallel bias shows) against JAX ``encoder_forward`` (rtol 2e-4,
  atol 2e-5);
* int8 spotting calibrated with a sharded catalog: the static activation
  scales and the keywords equal one rank's.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from enhance_cb_whisper_tpu.catalog import KeywordCatalog as JaxCatalog
from enhance_cb_whisper_tpu.catalog import device_put_catalog, make_catalog_score_fn
from enhance_cb_whisper_tpu.efficient_kws import EfficientKWSConfig as JaxEfficientConfig
from enhance_cb_whisper_tpu.efficient_kws import EfficientKWSModel as JaxEfficientModel
from enhance_cb_whisper_tpu.efficient_kws.catalog import make_cascade_score_fn, project_catalog
from enhance_cb_whisper_tpu.models import ResNetConfig as JaxResNetConfig
from enhance_cb_whisper_tpu.models.kws import KWSModel as JaxKWS
from enhance_cb_whisper_tpu.models.whisper import WhisperConfig as JaxWhisperConfig
from enhance_cb_whisper_tpu.models.whisper import encoder_forward
from enhance_cb_whisper_tpu.ops.resize import resize_matrix
from enhance_cb_whisper_tpu_torch.convert import from_flax_efficient_variables, to_flax_variables
from enhance_cb_whisper_tpu_torch.efficient_kws.model import EfficientKWSConfig, EfficientKWSModel
from enhance_cb_whisper_tpu_torch.models.kws import init_kws_model
from enhance_cb_whisper_tpu_torch.models.resnet import ResNetConfig
from enhance_cb_whisper_tpu_torch.models.whisper import WhisperConfig, init_whisper_params
from enhance_cb_whisper_tpu_torch.parallel.dryrun import FLAGSHIP_WHISPER, TRAIN_RESNET, flagship_inputs
from enhance_cb_whisper_tpu_torch.parallel.mesh import launch

ENCODER = dict(FLAGSHIP_WHISPER, max_target_positions=16)
E_CONFIG = dict(n_layers=2, embedding_dim=16, learn_features=True, proj_mlp=True, proj_mlp_units=8,
                resnet_version="resnet-18")


def _inputs():
    rng = np.random.default_rng(0)
    stacks = [rng.standard_normal((3, int(rng.integers(2, 7)), 16), dtype=np.float32) for _ in range(24)]
    utt = rng.standard_normal((3, 20, 16), dtype=np.float32)
    utt /= np.linalg.norm(utt, axis=-1, keepdims=True)
    kws = init_kws_model(ResNetConfig(**TRAIN_RESNET), torch.Generator().manual_seed(1))
    kws_state = {k: v.numpy() for k, v in kws.state_dict().items()}

    groups = [{"kwd": rng.standard_normal((4, 2, 16, 16), dtype=np.float32),
               "kwd_mask": np.ones((4, 2, 16), np.float32), "mask": np.ones((4,), np.float32)}
              for _ in range(4)]
    eutt = rng.standard_normal((1, 2, 32, 16), dtype=np.float32)
    eutt[0, :, 8:24, :] = groups[1]["kwd"][1]  # planted match (row 5)
    eutt_mask = np.ones((1, 2, 32), np.float32)

    wparams = init_whisper_params(rng, WhisperConfig(**ENCODER))
    for layer in wparams["encoder"]["layers"]:
        for p in (layer["self_attn"]["q_proj"], layer["self_attn"]["v_proj"], layer["self_attn"]["out_proj"],
                  layer["fc1"], layer["fc2"]):
            p["bias"] = rng.normal(0, 0.1, p["bias"].shape).astype(np.float32)
    mel = rng.standard_normal((2, 8, 32), dtype=np.float32)
    return {"stacks": stacks, "utt": utt, "kws": kws_state, "groups": groups, "eutt": eutt,
            "eutt_mask": eutt_mask, "whisper": wparams, "mel": mel}


def _jax(inp, evars):
    kws = JaxKWS(JaxResNetConfig(**TRAIN_RESNET))
    variables = to_flax_variables({k: torch.from_numpy(v) for k, v in inp["kws"].items()})
    score = make_catalog_score_fn(lambda v, x: kws.apply(v, x).logits, out_size=(32, 48), chunk=8)
    catalog = JaxCatalog.from_arrays([f"k{i}" for i in range(24)], inp["stacks"], group_size=8)
    w = jnp.asarray(resize_matrix(20, 48, antialias=False))
    probs, logits = score(variables, device_put_catalog(catalog, out_h=32, chunk=8), jnp.asarray(inp["utt"]), w)

    emodel = JaxEfficientModel(JaxEfficientConfig(**E_CONFIG))
    ecat = project_catalog(emodel, evars, inp["groups"], chunk=4)
    casc = make_cascade_score_fn(emodel, chunk=4, shortlist=8)(
        evars, ecat, jnp.asarray(inp["eutt"]), jnp.asarray(inp["eutt_mask"]))

    enc, _ = encoder_forward(inp["whisper"], inp["mel"], JaxWhisperConfig(**ENCODER))
    return {"probs": np.asarray(probs), "logits": np.asarray(logits), "cascade": np.asarray(casc),
            "encoder": np.asarray(enc)}


@pytest.fixture(scope="module")
def results():
    """Each rank's results and JAX's: the ranks run while JAX computes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    inp = _inputs()
    emodel = JaxEfficientModel(JaxEfficientConfig(**E_CONFIG))
    evars = jax.tree.map(np.asarray, jax.jit(emodel.init)(
        jax.random.PRNGKey(2), inp["groups"][0]["kwd"], inp["eutt"], inp["groups"][0]["kwd_mask"],
        inp["eutt_mask"]))
    pconfig = EfficientKWSConfig(**E_CONFIG)
    estate = {k: v.numpy() for k, v in EfficientKWSModel(pconfig).load_converted(
        from_flax_efficient_variables(evars)).state_dict().items()}
    cascade = dict(model_state=estate, config=pconfig, groups=inp["groups"], utt=inp["eutt"],
                   utt_mask=inp["eutt_mask"])
    args = (inp["kws"], inp["stacks"], inp["utt"], cascade, (inp["whisper"], ENCODER, inp["mel"]),
            flagship_inputs(0, 1, 2))
    with ThreadPoolExecutor(1) as pool:
        ranks_run = pool.submit(launch, ranks.catalog_cases, 2, backend="gloo", device="cpu", timeout=120,
                                args=args)
        want = _jax(inp, evars)
        per_rank = ranks_run.result()
    torch.set_num_threads(threads)
    return per_rank, want


def test_sharded_catalog_scoring_matches_jax(results):
    per_rank, want = results
    for r in per_rank:
        probs, logits = r["catalog"]["got"]
        np.testing.assert_allclose(probs, want["probs"], rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(logits, want["logits"], rtol=1e-4, atol=1e-6)
        # the same rows as one rank's scorer, in row order
        np.testing.assert_allclose(probs, r["catalog"]["ref"][0], rtol=1e-5, atol=1e-7)


def test_sharded_cascade_matches_jax_with_the_planted_match(results):
    per_rank, want = results
    for r in per_rank:
        got = r["cascade"]["got"]
        assert 5 in np.flatnonzero(got), "sharded cascade missed the planted match"
        assert set(np.flatnonzero(got)) == set(np.flatnonzero(want["cascade"]))
        np.testing.assert_allclose(got, want["cascade"], rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got, r["cascade"]["ref"], rtol=1e-5, atol=1e-7)


def test_tp_encoder_matches_jax(results):
    per_rank, want = results
    for r in per_rank:
        np.testing.assert_allclose(r["encoder"]["got"], want["encoder"], rtol=2e-4, atol=2e-5)
    np.testing.assert_array_equal(per_rank[0]["encoder"]["got"], per_rank[1]["encoder"]["got"])


def test_int8_calibration_scales_equal_across_shardings(results):
    per_rank, _ = results
    for r in per_rank:
        ref, got = r["int8"]["ref"], r["int8"]["got"]
        assert len(got["act_scales"]) == len(ref["act_scales"]) > 0
        assert got["act_scales"] == ref["act_scales"]  # per site, bit for bit
        assert got["keywords"] == ref["keywords"]
