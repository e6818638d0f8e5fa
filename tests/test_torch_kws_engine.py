"""The paper-1 KWS eval, port vs JAX: both engines read the same synthetic
AISHELL datamodule (the JAX package's, which holds numpy arrays) and score
it with the same weights — the fp32 ResNet, then the int8 one after
``enable_int8_scoring`` on both sides, with stage_1's bottleneck 1×1 convs
on the fused s8 kernel (Pallas in interpret mode on the JAX side, the plain
version on the port's).

* ``score_utterance`` probabilities and logits agree within atol 1e-6 in
  fp32 (f32 sums in another order; 9e-8 seen) and 1e-3 in int8: the JAX
  engine runs its int8 forward under ``jit``, where XLA fuses the requant
  epilogue and can round an activation code the other way at a .5
  boundary; one such code moved a logit by 1.8e-4 here;
* ``validate()`` and ``test()`` metrics are equal — P/R/F1 at threshold 0.5
  and their bootstrap CIs — and the validation loss agrees to rtol 1e-5."""

import jax
import numpy as np
import pytest
import torch

from enhance_cb_whisper_tpu.data import KWSDataMod
from enhance_cb_whisper_tpu.models.kws import KWSModel as JaxKWS
from enhance_cb_whisper_tpu.models.resnet import ResNetConfig as JaxResNetConfig
from enhance_cb_whisper_tpu.runtime.kws_engine import KWSEngine as JaxEngine
from enhance_cb_whisper_tpu.train.kws_train import KWSTrainConfig
from enhance_cb_whisper_tpu_torch.convert import from_flax_resnet_variables
from enhance_cb_whisper_tpu_torch.models.kws import KWSModel
from enhance_cb_whisper_tpu_torch.models.resnet import ResNetConfig
from enhance_cb_whisper_tpu_torch.runtime.kws_engine import KWSEngine

from fixtures import N_LAYERS, make_aishell_hotword, make_aishell_kws

OUT = (32, 48)
RESNET = dict(num_channels=N_LAYERS, embedding_size=32, hidden_sizes=(128, 512), depths=(1, 3),
              layer_type="bottleneck", num_labels=2)
TOL = {"fp32": 1e-6, "int8": 1e-3}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("aishell_port"))
    make_aishell_kws(root)
    make_aishell_hotword(root)
    info = {"name": "aishell", "root": root, "kw_type": "natural"}
    dm = KWSDataMod(batch_size=4, sampling="random", train_info=[info], val_info=[info, info],
                    test_info=info, hotwords_per_group=2, features_size=OUT, test_split="dev")
    dm.setup("validate")
    dataset = list(dm.val_dataset.values())[0]

    jcfg = JaxResNetConfig(**RESNET)
    variables = JaxKWS(jcfg).init(jax.random.PRNGKey(0), np.zeros((1, N_LAYERS, *OUT), np.float32))
    variables = jax.tree.map(np.asarray, variables)
    jengine = JaxEngine(KWSTrainConfig(), resnet_config=jcfg, features_size=OUT)
    # a random head scores every pair alike: shift the class-1 bias so the
    # 0.5 threshold passes about 70 % of the pairs, true keywords among them
    margins = []
    for i in range(len(dataset)):
        _, logits = jengine.score_utterance(variables, dataset, dataset[i]["utt_hs"])
        real = dataset[i]["hotword_mask"] > 0
        margins.append(logits[real, 1] - logits[real, 0])
    margin = np.percentile(np.concatenate(margins), 30)
    variables["params"]["model"]["classifier"]["bias"] = np.array([0.0, -margin], np.float32)

    model = KWSModel(ResNetConfig(**RESNET)).load_converted(from_flax_resnet_variables(variables))
    engine = KWSEngine(ResNetConfig(**RESNET), features_size=OUT, device="cpu")
    return dm, dataset, jengine, variables, engine, model


@pytest.fixture(scope="module")
def int8(setup):
    dm, dataset, jengine, variables, engine, model = setup
    mp = pytest.MonkeyPatch()
    mp.setenv("ECW_S8_PALLAS", "stage_1")
    try:
        jq = jengine.enable_int8_scoring(variables, dataset, calibration_batches=4)
    finally:
        mp.undo()
    tq = engine.enable_int8_scoring(model, dataset, calibration_batches=4, s8_1x1=("stage_1",))
    return jq, tq


def _pairs(setup, which, int8):
    dm, dataset, jengine, variables, engine, model = setup
    if which == "fp32":
        return jengine, variables, engine, model
    jq, tq = int8
    return jengine, jq, engine, tq


@pytest.mark.parametrize("which", ["fp32", "int8"])
def test_score_utterance_matches_jax(setup, int8, which):
    jengine, jvars, engine, tvars = _pairs(setup, which, int8)
    dataset = setup[1]
    probs_all = []
    for i in range(len(dataset)):
        utt = dataset[i]["utt_hs"]
        want_p, want_l = jengine.score_utterance(jvars, dataset, utt)
        got_p, got_l = engine.score_utterance(tvars, dataset, utt)
        np.testing.assert_allclose(got_p, want_p, rtol=0, atol=TOL[which])
        np.testing.assert_allclose(got_l, want_l, rtol=0, atol=TOL[which])
        probs_all.append(got_p[dataset[i]["hotword_mask"] > 0])
    probs_all = np.concatenate(probs_all)
    assert (probs_all > 0.5).any() and (probs_all < 0.5).any()


@pytest.mark.parametrize("which", ["fp32", "int8"])
def test_validate_and_test_match_jax(setup, int8, which):
    jengine, jvars, engine, tvars = _pairs(setup, which, int8)
    dm = setup[0]
    mp = pytest.MonkeyPatch()
    mp.setenv("ECW_S8_PALLAS", "stage_1")
    try:
        want_val = jengine.validate(jvars, dm)
        want_test = jengine.test(jvars, dm)
    finally:
        mp.undo()
    got_val = engine.validate(tvars, dm)
    got_test = engine.test(tvars, dm)
    assert sorted(got_val) == sorted(want_val)
    for key, value in want_val.items():
        if "loss" in key:
            np.testing.assert_allclose(got_val[key], value, rtol=1e-5, err_msg=key)
        else:
            assert got_val[key] == value, key
    assert got_test == want_test
    assert 0 < got_val["metrics/f1"] < 1 and 0 < got_test["F1"] < 1
