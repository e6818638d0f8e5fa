"""The port's paper-2 eval path against the JAX package's, on the CPU at
tiny dims: the eval data layer, ``EfficientKWSEngine.validate`` and
``test``, int8 scoring, and the CLI's ``test``/``validate``.

Synthetic layouts from ``tests/fixtures.py`` (MLS dev sets in two
languages, an ACL-6060 eval set, an AISHELL hotword dev set; 3-layer 8-dim
hidden states) and a 2-layer model at 32 × 64 features (U 4, ResNet-18,
the class-1 bias moved so that about a third of the pairs pass 0.5); the
port scores the keyword DB 4 rows at a time where JAX scores it in one
launch.

* Datasets (groups, ghost masks, items), the collator, ``chunk_stride``:
  equal arrays; a ragged truncation raises in both; the datamodule builds
  the same validation sets, and ``setup("fit")`` refuses a batch size
  utterance-examples sampling cannot split (the training half:
  ``tests/test_torch_efficient_train_data.py``).
* ``validate`` (best-F search, recall@k, per-language aggregates, the
  JSON dumps) and ``test`` (P/R/F1 at the threshold, bootstrap CIs) for
  L and LEF (LE through the CLI, ``tests/test_torch_efficient_cli.py``):
  every metric equal to JAX's, losses to rtol 1e-5 (f32 sums in another
  order).
* int8 (LE, on a bottleneck ResNet whose stage_1 1×1s K2 takes, the
  kernel's plain version here; JAX with ``ECW_S8_PALLAS`` naming every
  stage, Pallas in interpret mode): the int8 codes, weight scales and
  biases bit-equal to JAX's, the activation scales within 1e-6 relative
  (f32 maxima of convolutions summed in another order), probabilities
  within 1e-3 (the paper-1 engine tests' bound: XLA's fused requant can
  round a code the other way at a .5) and the same decisions at 0.5.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from enhance_cb_whisper_tpu.efficient_kws import data as jd
from enhance_cb_whisper_tpu.efficient_kws import engine as je
from enhance_cb_whisper_tpu.efficient_kws import model as jm
from enhance_cb_whisper_tpu.models.quant import quantize_efficient_classifier as jax_quantize
from enhance_cb_whisper_tpu.models.resnet import ResNetConfig as JaxResNetConfig
from enhance_cb_whisper_tpu_torch.convert import from_flax_efficient_variables
from enhance_cb_whisper_tpu_torch.efficient_kws import data as pd
from enhance_cb_whisper_tpu_torch.efficient_kws import engine as pe
from enhance_cb_whisper_tpu_torch.efficient_kws import model as pm
from enhance_cb_whisper_tpu_torch.models.quant import s8_stages
from enhance_cb_whisper_tpu_torch.models.resnet import ResNetConfig
from enhance_cb_whisper_tpu_torch.ops import matmul_s8_cuda

from fixtures import DIM, make_acl, make_aishell_hotword, make_mls

LANGS = ("English", "German")
FS = (32, 64)
L, U, CHUNK = 2, 4, 4
VARIANTS = {
    "L": dict(),
    "LE": dict(learn_features=True, proj_mlp=True),
    "LEF": dict(learn_features=True, proj_mlp=True, frames_conv=True),
}
# stage_1's 1x1 convs have K and N multiples of 128: K2's shapes
BOTTLENECK = dict(embedding_size=32, hidden_sizes=(128, 512), depths=(1, 3), layer_type="bottleneck",
                  num_labels=2)
ALL_STAGES = "stage_0,stage_1"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _small_chunks(monkeypatch):
    """The port's keyword DB scored CHUNK rows at a time, so the DB's
    chunks cross its groups."""
    monkeypatch.setattr(pe, "CHUNK", CHUNK)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("paper2")
    roots = {k: str(base / k) for k in ("mls", "acl", "aishell")}
    make_mls(roots["mls"], languages=LANGS)
    make_acl(roots["acl"], n_keywords=7, n_utts=4, ghost=(2,), whisper_dim=DIM, kw_layers=3)
    make_aishell_hotword(roots["aishell"])
    return roots


def _dm_args(roots, **extra):
    return dict(batch_size=4, sampling="random", features_size=FS, n_layers=L, keywords_per_group=2,
                languages=list(LANGS),
                val_info=[{"language": lang, "root": roots["mls"], "kw_type": "natural"} for lang in LANGS],
                test_info={"name": "acl", "root": roots["acl"], "kw_type": "tts"}, **extra)


def _config(module, variant):
    return module.EfficientKWSConfig(n_layers=L, embedding_dim=DIM, proj_mlp_units=U,
                                     resnet_version="resnet-18", **VARIANTS[variant])


def _same_item(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k == "groups":
            for g, w in zip(got[k], v):
                assert g["keywords"] == w["keywords"]
                for key in ("kwd", "kwd_mask", "mask"):
                    np.testing.assert_array_equal(g[key], w[key])
        elif isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


def test_eval_datasets_match_jax(roots):
    common = dict(size=FS, n_layers=L)
    pairs = [
        (pd.MLSEvaluationDataset(roots["mls"], "English", keywords_per_group=2, **common),
         jd.MLSEvaluationDataset(roots["mls"], "English", keywords_per_group=2, **common)),
        (pd.EfficientACL6060KeywordDataset(roots["acl"], split="test", kw_type="tts", keywords_per_group=3,
                                           **common),
         jd.EfficientACL6060KeywordDataset(roots["acl"], split="test", kw_type="tts", keywords_per_group=3,
                                           **common)),
        (pd.EfficientAishellHotwordDataset(os.path.join(roots["aishell"], "hotword"), hotwords_per_group=-1,
                                           **common),
         jd.EfficientAishellHotwordDataset(os.path.join(roots["aishell"], "hotword"), hotwords_per_group=-1,
                                           **common)),
    ]
    for got, want in pairs:
        assert len(got) == len(want) > 0 and got.keywords_per_group == want.keywords_per_group
        assert got.is_expanded() == want.is_expanded() is False
        for i in range(len(want)):
            _same_item(got[i], want[i])
    assert pairs[1][0][0]["hotword_mask"][2] == 0  # the ghost keyword
    assert pairs[1][0][0]["groups"][0]["kwd"].shape == (3, L, FS[0], DIM)
    for module in (pd, jd):  # per-keyword truncated lengths are ragged
        with pytest.raises(ValueError, match="ragged"):
            module.MLSEvaluationDataset(roots["mls"], "English", size=(5, 64), n_layers=L,
                                        pad_long_before_resize=False)
    assert pd.LONG_MAX_LENGTH == jd.LONG_MAX_LENGTH

    rng = np.random.default_rng(0)
    feats, mask = rng.standard_normal((2, 30, 16)).astype(np.float32), np.ones((2, 30), np.float32)
    for args in ((40, 10, "time"), (20, 4, "embeddings"), (25, 5, "time")):
        got, want = pd.chunk_stride(feats, mask, *args), jd.chunk_stride(feats, mask, *args)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    items = [{"kwd_features": rng.random((L, 8, 4)), "kwd_mask": rng.random((L, 8)),
              "utt_features": rng.random((L, 16, 4)), "utt_mask": rng.random((L, 16)),
              "label": i % 2, "mask": 1, "domain": i} for i in range(3)]
    got, want = pd.EfficientKWSDataCollator()(items), jd.EfficientKWSDataCollator()(items)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_datamodule_builds_the_eval_sets_and_refuses_fit(roots):
    port, jax_dm = pd.EfficientKWSDataMod(**_dm_args(roots)), jd.EfficientKWSDataMod(**_dm_args(roots))
    for stage in ("validate", "test"):
        port.setup(stage)
        jax_dm.setup(stage)
    assert list(port.val_dataset) == list(jax_dm.val_dataset) == ["English/natural", "German/natural"]
    assert len(port.val_dataloader()) == 2
    assert len(port.test_dataset) == len(jax_dm.test_dataset) == 4
    _same_item(next(iter(port.test_dataloader())), jax_dm.test_dataset[0])
    train = _dm_args(roots, train_info=[{"name": "mls", "root": roots["mls"], "kw_type": "natural"}])
    refused = pd.EfficientKWSDataMod(**dict(train, batch_size=2, sampling="utterance-examples"))
    with pytest.raises(AssertionError, match="multiple of 4"):
        refused.setup("fit")
    port = pd.EfficientKWSDataMod(**train)
    port.setup("fit")
    _same_item(port.fit_dataset[0], jd.EfficientMLSKWSDataset(
        roots["mls"], languages=LANGS, kw_type="natural", features_size=FS, n_layers=L)[0])


def _variables(variant, jcfg, seed=0):
    """JAX-initialized variables with the class-1 bias set so that about a
    third of the pairs of the first validation set pass 0.5."""
    sample = np.zeros((1, L, FS[0], DIM), np.float32)
    utt = np.zeros((1, L, FS[1], DIM), np.float32)
    jmodel = jm.EfficientKWSModel(jcfg)
    variables = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(seed), sample, utt, np.ones(sample.shape[:3], np.float32),
        np.ones(utt.shape[:3], np.float32)))
    return jmodel, variables


def _centre(variables, port_model, engine, dataset, q=67):
    """Shift the class-1 bias so that ``100 - q`` % of ``dataset``'s real
    pairs pass 0.5."""
    margins = []
    db = pe.keyword_db(port_model, dataset)
    for i in range(len(dataset)):
        item = dataset[i]
        _, logits = engine.score_item(port_model, db, item)
        margins.append((logits[:, 1] - logits[:, 0])[item["hotword_mask"] > 0])
    shift = np.percentile(np.concatenate(margins), q)
    variables["params"]["classifier"]["bias"] = (
        variables["params"]["classifier"]["bias"] + np.array([0.0, -shift], np.float32))
    return variables


def _port_model(variant, variables, cfg=None):
    return pm.EfficientKWSModel(cfg or _config(pm, variant)).load_converted(
        from_flax_efficient_variables(variables)).eval()


def _equal_metrics(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if "loss" in k:
            np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("variant", ["L", "LEF"])
def test_validate_and_test_match_jax(roots, tmp_path, variant):
    jmodel, variables = _variables(variant, _config(jm, variant))
    port_dm, jax_dm = pd.EfficientKWSDataMod(**_dm_args(roots)), jd.EfficientKWSDataMod(**_dm_args(roots))
    port_dm.setup("validate")
    jax_dm.setup("validate")
    engine = pe.EfficientKWSEngine(_config(pm, variant), device="cpu")
    variables = _centre(variables, _port_model(variant, variables), engine,
                        list(port_dm.val_dataset.values())[0])
    model = _port_model(variant, variables)
    jengine = je.EfficientKWSEngine(_config(jm, variant))

    got = engine.validate(model, port_dm, dump_dir=str(tmp_path / "port"))
    want = jengine.validate(variables, jax_dm, dump_dir=str(tmp_path / "jax"))
    _equal_metrics(got, want)
    assert 0 < got["metrics/f1"] < 1 and "val/recall_at_20_1" in got and "metrics/f1_l0" in got
    for name in ("thresdict.json", "prcurve_0.json", "prcurve_1.json"):
        with open(tmp_path / "port" / name) as a, open(tmp_path / "jax" / name) as b:
            np.testing.assert_allclose(np.asarray(json.load(a) if name[0] == "t" else json.load(a)["recall"]),
                                       np.asarray(json.load(b) if name[0] == "t" else json.load(b)["recall"]),
                                       rtol=1e-6)
    # centred again, on the test set's pairs
    port_dm.setup("test")
    jax_dm.setup("test")
    variables = _centre(variables, model, engine, port_dm.test_dataset, q=20)
    model = _port_model(variant, variables)
    got = engine.test(model, port_dm, dump_dir=str(tmp_path / "port"), num_bootstraps=50)
    want = jengine.test(variables, jax_dm, dump_dir=str(tmp_path / "jax"), num_bootstraps=50)
    assert got == want and got["Precision_UB"] > 0
    assert os.path.exists(tmp_path / "port" / "pr_data_aishell.json")


@dataclasses.dataclass(frozen=True)
class _JaxBottleneck(jm.EfficientKWSConfig):
    def resnet_config(self):
        return JaxResNetConfig(num_channels=self.n_layers, **BOTTLENECK)


@dataclasses.dataclass(frozen=True)
class _PortBottleneck(pm.EfficientKWSConfig):
    def resnet_config(self):
        return ResNetConfig(num_channels=self.n_layers, **BOTTLENECK)


def test_int8_scoring_matches_jax(roots, monkeypatch):
    fields = dict(n_layers=L, embedding_dim=DIM, proj_mlp_units=U, **VARIANTS["LE"])
    jcfg, pcfg = _JaxBottleneck(**fields), _PortBottleneck(**fields)
    jmodel, variables = _variables("LE", jcfg, seed=1)
    port_dm, jax_dm = pd.EfficientKWSDataMod(**_dm_args(roots)), jd.EfficientKWSDataMod(**_dm_args(roots))
    port_dm.setup("test")
    jax_dm.setup("test")
    dataset = port_dm.test_dataset
    engine = pe.EfficientKWSEngine(pcfg, device="cpu")
    variables = _centre(variables, _port_model("LE", variables, pcfg), engine, dataset)
    model = _port_model("LE", variables, pcfg)
    jengine = je.EfficientKWSEngine(jcfg)
    db = pe.keyword_db(model, dataset)
    fp32 = [engine.score_item(model, db, dataset[i])[0] for i in range(len(dataset))]

    items = [dataset[i] for i in range(2)]
    monkeypatch.setenv("ECW_S8_PALLAS", ALL_STAGES)
    jengine.enable_int8_scoring(variables, items=[jax_dm.test_dataset[i] for i in range(2)])
    launches = []
    real = matmul_s8_cuda.matmul_s8_requant
    monkeypatch.setattr(matmul_s8_cuda, "matmul_s8_requant",
                        lambda *a, **kw: launches.append(a[0].shape) or real(*a, **kw))
    engine.enable_int8_scoring(model, items=items, s8_1x1=s8_stages(pcfg.resnet_config()))

    # the codes and scales JAX's quantizer and calibration give
    qparams, scales, _ = engine._int8
    jq = jax_quantize(variables, jcfg.resnet_config())
    for name in ("embedder", "stage_1_block_2"):
        conv = "embedder" if name == "embedder" else "layer_0"
        got = qparams[name] if name == "embedder" else qparams[name][conv]
        want = jq[name] if name == "embedder" else jq[name][conv]
        np.testing.assert_array_equal(got["wq"].numpy(), np.asarray(want["wq"]).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(got["s_w"].numpy(), np.asarray(want["s_w"]))
        np.testing.assert_array_equal(got["b"].numpy(), np.asarray(want["b"]))
    from enhance_cb_whisper_tpu.models.quant import calibrate_act_scales as jax_calibrate

    def jax_sims(it):
        project = lambda x, m: jmodel.apply(variables, x, m, method=jm.EfficientKWSModel.project)  # noqa: E731
        kwd, kwd_mask = project(it["groups"][0]["kwd"], it["groups"][0]["kwd_mask"])
        utt, utt_mask = project(it["utt"][None], it["utt_mask"][None])
        return np.asarray(jm.masked_sims(kwd, utt, kwd_mask, utt_mask))

    jsims = np.concatenate([jax_sims(jax_dm.test_dataset[i]) for i in range(2)])
    want_scales = jax_calibrate(jcfg.resnet_config(), jq, jsims)["act_scales"]
    assert scales.keys() == want_scales.keys()
    for site, v in want_scales.items():
        assert scales[site] == pytest.approx(float(v), rel=1e-6), site

    for i in range(len(dataset)):
        item = dataset[i]
        got, _ = engine.score_item(model, db, item)
        kwd = np.concatenate([g["kwd"] for g in item["groups"]])
        km = np.concatenate([g["kwd_mask"] for g in item["groups"]])
        want, _ = jengine._score_group(variables, kwd, item["utt"][None], km, item["utt_mask"][None])
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-3)
        real_rows = item["hotword_mask"] > 0
        assert np.array_equal(got[real_rows] > 0.5, np.asarray(want)[real_rows] > 0.5)
        assert np.abs(got - fp32[i]).max() > 0  # the int8 path ran
    assert launches and all(shape[1] % 128 == 0 for shape in launches)  # K2's route, plain version
