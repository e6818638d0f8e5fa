"""The port's ``KWSEngine.fit`` and the CLI's ``fit`` against the JAX
package's, on the CPU.

A synthetic AISHELL layout (``tests/fixtures.py``: ``make_aishell_kws``
for training, ``make_aishell_hotword`` for the dev set) and the tiny
ResNet (widths 8-32, one block a stage) at 32 × 48 features.

* Two epochs of adversarial training with entropy (three optimizer
  groups, two accumulated minibatches, the gradient-reversal layer and the
  per-epoch beta) from JAX's initial variables, through JAX's ``fit`` and
  the port's.  Adam moves a weight by about its rate whatever the
  gradient's size, so a gradient at rounding level (a BatchNorm bias
  followed by another BatchNorm has a near-zero one) can step the other
  way in the other framework: every weight is held within 2 × 6 steps ×
  rate 1e-3, at least 80 % of them within 1e-4, the classifier and the
  discriminator (gradients far from zero) all within 1e-4; the BatchNorm
  statistics, which follow the upstream weights, within 0.15 in relative
  L2 per leaf (the deepest drift most); each epoch's validation loss within 2 %
  and precision/recall/F1 equal.  The JAX side compiles with
  XLA's quicker CPU settings: a test-time cost, not a change of what it
  computes.
* Checkpoints: ``best`` per monitor and ``final``, early stopping,
  resume (optimizer state, global step, best values: a resumed run ends
  where an unbroken one does, bit for bit), an epoch that trains zero
  batches, train mode after an in-fit ``validate``.
* A port checkpoint read by JAX's ``load_checkpoint`` (and run through the
  JAX engine's ``test``), and a JAX checkpoint read by the port's.
* Resuming across packages, optimizer state included: the port's
  checkpoint restored by JAX's ``fit`` template and the JAX checkpoint by
  the port's ``restore_train_state`` hold the writer's Adam moments, step
  counts and rates bit for bit; one more training step from each then
  matches the writer's own next step: at least 98 % of the elements, the
  classifier and the discriminator within 1e-6, every weight within the
  step's rate 1e-4 (the near-zero gradients again); a restarted Adam
  lands about 1e-3 away (asserted, so the check can fail).
* ``run_cli(["fit", ...], device="cpu")`` with the reference CLI's
  argument links, then ``test`` from the checkpoint it wrote, through the
  port's CLI and the JAX package's (equal metrics).
"""

import dataclasses
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import enhance_cb_whisper_tpu.cli.main as jax_cli
from enhance_cb_whisper_tpu.data.datamodule import KWSDataMod as JaxDataMod
from enhance_cb_whisper_tpu.models import ResNetConfig as JaxResNetConfig
from enhance_cb_whisper_tpu.runtime import kws_engine as jax_engine_mod
from enhance_cb_whisper_tpu.runtime.checkpoint import load_checkpoint as jax_load_checkpoint
from enhance_cb_whisper_tpu.runtime.checkpoint import save_checkpoint as jax_save_checkpoint
from enhance_cb_whisper_tpu.runtime.logging import MetricsLogger as JaxLogger
from enhance_cb_whisper_tpu.train import kws_train as jt
from enhance_cb_whisper_tpu_torch.cli import main as port_cli
from enhance_cb_whisper_tpu_torch.convert import from_flax_resnet_variables, to_flax_variables
from enhance_cb_whisper_tpu_torch.data.datamodule import KWSDataMod
from enhance_cb_whisper_tpu_torch.models.resnet import ResNetConfig
from enhance_cb_whisper_tpu_torch.runtime.checkpoint import (
    CheckpointManager,
    EarlyStopping,
    load_checkpoint,
    save_checkpoint,
)
from enhance_cb_whisper_tpu_torch.runtime.kws_engine import KWSEngine
from enhance_cb_whisper_tpu_torch.runtime.logging import MetricsLogger
from enhance_cb_whisper_tpu_torch.train import kws_train as pt

from fixtures import make_aishell_hotword, make_aishell_kws, tiny_paper1_patch

TINY = dict(num_channels=3, embedding_size=8, hidden_sizes=(8, 16, 24, 32), depths=(1, 1, 1, 1),
            num_labels=2)
SIZE = (32, 48)
TRAIN = dict(adversarial_training=True, entropy=True, num_domains=2, accumulate_grad_batches=2,
             features_lr=1e-3, classifier_lr=1e-3, discriminator_lr=1e-3, supression_decay=0.5,
             lr_step=1)
FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


class _FastJit:
    """``jax.jit(fn)`` compiled with XLA's quicker CPU settings, once per
    argument signature."""

    def __init__(self, jitted):
        self.jitted, self.compiled = jitted, {}

    def __call__(self, *args):
        leaves, tree = jax.tree.flatten(args)
        key = (tree, tuple((np.shape(x), np.result_type(x)) for x in leaves))
        if key not in self.compiled:
            self.compiled[key] = self.jitted.lower(*args).compile(compiler_options=FAST)
        return self.compiled[key](*args)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("aishell")
    make_aishell_kws(str(root), n_keywords=12, n_utts=6, ghost=(4,))
    make_aishell_hotword(str(root), n_hotwords=5, n_utts=4, ghost=(3,))
    return str(root)


def _data_args(root, **extra):
    return dict(batch_size=8, sampling="random", features_size=SIZE, hotwords_per_group=3,
                train_info=[{"name": "aishell", "root": root, "kw_type": "tts"}],
                val_info=[{"name": "aishell", "root": root, "kw_type": "natural"}], **extra)


def _port_engine(ckpt_dir, train=TRAIN, **kwargs):
    return KWSEngine(ResNetConfig(**TINY), features_size=SIZE, device="cpu",
                     config=pt.KWSTrainConfig(**train), ckpt_dir=str(ckpt_dir),
                     logger=MetricsLogger(verbose=False), **kwargs)


def _port_state_from(engine, jax_state):
    state = engine.init_state()
    state.kws.load_converted(from_flax_resnet_variables(
        {"params": jax_state.params["kws"], "batch_stats": jax_state.batch_stats["kws"]}))
    state.disc.load_state_dict(from_flax_resnet_variables({"params": jax_state.params["disc"]}))
    return state


@pytest.fixture(scope="module")
def runs(root, tmp_path_factory):
    """JAX's fit and the port's, two epochs each from JAX's initial
    variables, with each epoch's validation metrics."""
    config = jt.KWSTrainConfig(**TRAIN)
    engine = jax_engine_mod.KWSEngine(config, resnet_config=JaxResNetConfig(**TINY),
                                      features_size=SIZE, seed=5,
                                      ckpt_dir=str(tmp_path_factory.mktemp("jax_ckpt")),
                                      logger=JaxLogger(verbose=False))
    engine._batched_score_fn = _FastJit(engine._batched_score_fn)
    # flax's init, compiled once instead of run op by op
    kws, disc, tx = jt.build_models(config, JaxResNetConfig(**TINY)) + (None,)
    shape = (1, TINY["num_channels"], *SIZE)
    v = jax.jit(kws.init).lower(jax.random.PRNGKey(5), jnp.zeros(shape)).compile(
        compiler_options=FAST)(jax.random.PRNGKey(5), jnp.zeros(shape))
    dv = jax.jit(lambda r: disc.init(r, jnp.zeros((1, TINY["hidden_sizes"][-1])),
                                     jnp.zeros((1,), jnp.int32)))(jax.random.PRNGKey(5))
    params = {"kws": v["params"], "disc": dv["params"]}
    tx = jt.make_multi_optimizer(jt._label_tree(params), {
        name: jt.make_adam(lr, config.beta_1, config.beta_2, config.weight_decay)
        for name, lr in (("features", config.features_lr), ("classifier", config.classifier_lr),
                         ("discriminator", config.discriminator_lr))})
    initial = jt.KWSTrainState(params, {"kws": v["batch_stats"]}, tx.init(params), 0)

    def init_state(sample_shape=None):
        engine._models = (kws, disc, tx)
        return dataclasses.replace(initial)

    engine.init_state = init_state
    jax_val = []
    validate = engine.validate
    engine.validate = lambda *a: jax_val.append(validate(*a)) or jax_val[-1]
    real_step = jax_engine_mod.make_train_step
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_engine_mod, "make_train_step", lambda *a: _FastJit(real_step(*a)))
    try:
        np.random.seed(0)
        jax_final = engine.fit(JaxDataMod(**_data_args(root)), max_epochs=2)
    finally:
        mp.undo()

    port = _port_engine(tmp_path_factory.mktemp("port_ckpt"), seed=5)
    port_initial = _port_state_from(port, initial)
    port.init_state = lambda: port_initial
    port_val = []
    port_validate = port.validate
    port.validate = lambda *a: port_val.append(port_validate(*a)) or port_val[-1]
    np.random.seed(0)
    port_final = port.fit(KWSDataMod(**_data_args(root)), max_epochs=2)
    return types.SimpleNamespace(jax_engine=engine, jax_initial=initial, jax_final=jax_final,
                                 jax_val=jax_val, port=port, port_final=port_final,
                                 port_val=port_val)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_two_epochs_match_jax(runs):
    want = _flat(runs.jax_final.params)
    start = _flat(runs.jax_initial.params)
    got = _flat({"kws": to_flax_variables(runs.port_final.kws.state_dict())["params"],
                 "disc": to_flax_variables(runs.port_final.disc.state_dict())["params"]})
    assert got.keys() == want.keys()
    steps, lr = 6, 1e-3
    close = []
    for k in want:
        assert np.abs(want[k] - start[k]).max() > 0, k  # every leaf trained
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2 * steps * lr, err_msg=k)
        close.append(np.abs(got[k] - want[k]).ravel() <= 1e-4)
        if "classifier" in k or "disc" in k:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4, err_msg=k)
    assert np.concatenate(close).mean() >= 0.8
    got_stats = _flat(to_flax_variables(runs.port_final.kws.state_dict())["batch_stats"])
    want_stats = _flat(runs.jax_final.batch_stats["kws"])
    for k in want_stats:
        gap = np.linalg.norm(got_stats[k] - want_stats[k]) / np.linalg.norm(want_stats[k])
        assert gap <= 0.15, (k, gap)
    assert len(runs.port_val) == len(runs.jax_val) == 2
    for got_m, want_m in zip(runs.port_val, runs.jax_val):
        assert got_m.keys() == want_m.keys()
        for k, v in want_m.items():
            if "loss" in k:
                assert got_m[k] == pytest.approx(v, rel=0.02), k
            else:
                assert got_m[k] == v, k


def test_checkpoints_are_written_and_read_by_both_packages(runs, root):
    ckpt = runs.port.ckpt_dir
    assert sorted(os.listdir(ckpt)) == ["f1_checkpoint", "final"]
    with open(os.path.join(ckpt, "final", "meta.json")) as f:
        meta = json.load(f)
    assert meta["epoch"] == 1 and meta["hparams"]["adversarial_training"] is True
    # JAX's reader: the params and statistics in its layout, then its engine's test
    raw, _ = jax_load_checkpoint(os.path.join(ckpt, "final"))
    assert raw["epoch"] == 1 and raw["global_step"] == 6
    want = _flat(to_flax_variables(runs.port_final.kws.state_dict())["params"])
    got = _flat(raw["params"]["kws"])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    dm = JaxDataMod(**_data_args(root))
    dm.setup("validate")
    variables = {"params": raw["params"]["kws"], "batch_stats": raw["batch_stats"]["kws"]}
    jax_metrics = runs.jax_engine.validate(variables, dm)
    port_metrics = runs.port.validate(runs.port_final.kws, dm)
    for k, v in jax_metrics.items():
        assert port_metrics[k] == pytest.approx(v, rel=1e-4), k
    runs.port_final.kws.train()
    # the port's reader on JAX's checkpoint, with a template of its layout
    jax_ckpt = os.path.join(runs.jax_engine.ckpt_dir, "final")
    template = {"params": runs.jax_final.params, "batch_stats": runs.jax_final.batch_stats,
                "epoch": 0, "opt_state": jax_load_checkpoint(jax_ckpt)[0]["opt_state"],
                "global_step": 0}
    state, _ = load_checkpoint(jax_ckpt, template=jax.tree.map(np.asarray, template))
    assert state["epoch"] == 1 and state["global_step"] == 6
    for k, v in _flat(runs.jax_final.params).items():
        np.testing.assert_array_equal(_flat(state["params"])[k], v, err_msg=k)
    with pytest.raises(ValueError, match="keys"):
        load_checkpoint(jax_ckpt, template={"params": template["params"]})


def _next_step_batch(root):
    dm = JaxDataMod(**_data_args(root))
    dm.setup("fit")
    np.random.seed(3)
    return next(iter(dm.train_dataloader()))


def _jax_step(runs):
    config = jt.KWSTrainConfig(**TRAIN)
    kws, disc, tx = runs.jax_engine._models
    step = _FastJit(jt.make_train_step(config, kws, disc, tx))
    return lambda p, s, o, batch: step(p, s, o, {k: jnp.asarray(v) for k, v in batch.items()},
                                       jax.random.PRNGKey(0), config.beta(2), config.suppression(2))


def _port_step(state, batch):
    config = pt.KWSTrainConfig(**TRAIN)
    pt.make_train_step(config, state)({k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()},
                                      pt.StepNoise(0, "cpu"), config.beta(2), config.suppression(2))
    return _flat({"kws": to_flax_variables(state.kws.state_dict())["params"],
                  "disc": to_flax_variables(state.disc.state_dict())["params"]})


def _assert_next_step_close(got, want, lr=1e-4):
    """One step at rate ``lr`` from the same weights and Adam state: every
    weight within the step's rate (a BatchNorm bias followed by another
    BatchNorm has a near-zero gradient whose sign is rounding noise), at
    least 98 % of the elements and the whole classifier and discriminator
    within 1e-6."""
    assert got.keys() == want.keys()
    close = []
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=lr, err_msg=k)
        close.append(np.abs(got[k] - want[k]).ravel() <= 1e-6)
        if "classifier" in k or "disc" in k:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
    assert np.concatenate(close).mean() >= 0.98, np.concatenate(close).mean()


def test_optimizer_state_resumes_across_packages(runs, root, tmp_path):
    from flax import serialization

    batch = _next_step_batch(root)
    jax_step = _jax_step(runs)
    initial = runs.jax_initial
    template = {"params": initial.params, "batch_stats": initial.batch_stats, "epoch": 0,
                "opt_state": initial.opt_state, "global_step": 0}
    restart_gap = 5e-4

    # the port's checkpoint resumed in JAX, against the port's own next step
    port_ckpt = os.path.join(runs.port.ckpt_dir, "final")
    restored, _ = jax_load_checkpoint(port_ckpt, template=template)
    raw, _ = load_checkpoint(port_ckpt)
    want_opt = _flat(raw["opt_state"])
    got_opt = _flat(serialization.to_state_dict(restored["opt_state"]))
    # two moments per weight and, per group, two counts and a rate
    assert got_opt.keys() == want_opt.keys() and len(got_opt) == 2 * len(_flat(initial.params)) + 3 * 3
    for k in want_opt:
        np.testing.assert_array_equal(got_opt[k], want_opt[k], err_msg=k)
    assert {int(v) for k, v in got_opt.items() if k.endswith("['count']")} == {6}
    state = _port_engine(tmp_path / "a").init_state()
    pt.restore_train_state(state, raw)
    want = _port_step(state, batch)
    got = _flat(jax_step(restored["params"], restored["batch_stats"], restored["opt_state"], batch)[0])
    fresh = _flat(jax_step(restored["params"], restored["batch_stats"],
                           runs.jax_engine._models[2].init(restored["params"]), batch)[0])
    _assert_next_step_close(got, want)
    # a restarted Adam (fresh moments and the base rate) lands far away
    assert np.median([np.abs(fresh[k] - want[k]).max() for k in want]) > restart_gap

    # JAX's checkpoint resumed in the port, against JAX's own next step
    jax_ckpt = os.path.join(runs.jax_engine.ckpt_dir, "final")
    restored, _ = jax_load_checkpoint(jax_ckpt, template=template)
    state = _port_engine(tmp_path / "b").init_state()
    pt.restore_train_state(state, load_checkpoint(jax_ckpt)[0])
    again = _flat(pt.optimizer_tree(state))
    for k, v in _flat(serialization.to_state_dict(restored["opt_state"])).items():
        np.testing.assert_array_equal(again[k], v, err_msg=k)
    want = _flat(jax_step(restored["params"], restored["batch_stats"], restored["opt_state"], batch)[0])
    _assert_next_step_close(_port_step(state, batch), want)


def test_validate_inside_fit_leaves_train_mode(runs):
    assert runs.port_final.kws.training
    assert all(m.training for m in runs.port_final.kws.modules())


def _fit(root, ckpt, max_epochs, **kwargs):
    """The large heads (dropout noise each step) over the same pairs each
    epoch: the sampler's epoch counter starts again in a resumed process,
    in the JAX package too, so only unresampled epochs repeat exactly."""
    engine = _port_engine(ckpt, train=dict(TRAIN, large_heads=True), seed=9)
    dm = KWSDataMod(**_data_args(root, resample_every_epoch=False))
    return engine, engine.fit(dm, max_epochs=max_epochs, **kwargs)


def test_resume_continues_where_an_unbroken_run_ends(root, tmp_path):
    _, whole = _fit(root, tmp_path / "whole", 3)
    _, first = _fit(root, tmp_path / "broken", 2)
    _, resumed = _fit(root, tmp_path / "broken", 3,
                      resume_from=str(tmp_path / "broken" / "final"))
    got, want = resumed.kws.state_dict(), whole.kws.state_dict()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for k, v in whole.disc.state_dict().items():
        assert torch.equal(resumed.disc.state_dict()[k], v), k
    opt_got, opt_want = resumed.optimizer.state_dict(), whole.optimizer.state_dict()
    for i, s in opt_want["state"].items():
        for k, v in s.items():
            assert torch.equal(opt_got["state"][i][k], v), (i, k)
    raw, _ = load_checkpoint(str(tmp_path / "broken" / "final"))
    assert raw["epoch"] == 2 and raw["global_step"] == 9
    manager = CheckpointManager(str(tmp_path / "broken"), {"f1_checkpoint": "metrics/f1:max"})
    assert manager.restore_best().keys() == {"f1_checkpoint"}


def test_zero_batch_epoch_and_early_stopping(root, tmp_path):
    engine, state = _fit(root, tmp_path / "zero", 2, limit_train_batches=0)
    before = engine.init_state().kws.state_dict()
    for k, v in state.kws.state_dict().items():
        assert torch.equal(v, before[k]), k  # nothing trained
    assert os.path.isdir(tmp_path / "zero" / "final")
    stopper = EarlyStopping("metrics/f1", patience=1, mode="max", min_delta=2.0)
    engine, state = _fit(root, tmp_path / "stop", 5, early_stopping=stopper)
    with open(tmp_path / "stop" / "final" / "meta.json") as f:
        assert json.load(f)["epoch"] == 1  # the second epoch did not improve by 2


def test_checkpoint_manager_keeps_the_best(tmp_path):
    manager = CheckpointManager(str(tmp_path), {"f1_checkpoint": "metrics/f1:max",
                                                "loss": "val/loss:min"})
    for epoch, (f1, loss) in enumerate([(0.5, 2.0), (0.4, 1.0), (0.6, 3.0)]):
        manager.step(epoch, {"metrics/f1": f1, "val/loss": loss}, {"epoch": epoch})
    assert load_checkpoint(str(tmp_path / "f1_checkpoint"))[0]["epoch"] == 2
    assert load_checkpoint(str(tmp_path / "loss"))[0]["epoch"] == 1
    assert load_checkpoint(str(tmp_path / "final"))[0]["epoch"] == 2
    # a flax-written file and a port-written one hold the same bytes
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "b": {"c": np.int32(4)}, "n": 3}
    save_checkpoint(str(tmp_path / "port"), tree)
    jax_save_checkpoint(str(tmp_path / "flax"), tree)
    with open(tmp_path / "port" / "state.msgpack", "rb") as a, \
            open(tmp_path / "flax" / "state.msgpack", "rb") as b:
        assert a.read() == b.read()


def test_cli_fit_then_test(root, tmp_path, monkeypatch):
    monkeypatch.setattr(port_cli, "_paper1_kws_resnet", lambda model_args: ResNetConfig(**TINY))
    run_dir = tmp_path / "run"
    config = {
        "seed_everything": 123,
        "trainer": {"max_epochs": 2, "check_val_every_n_epoch": 1, "limit_train_batches": 3,
                    "default_root_dir": str(run_dir),
                    "logger": {"init_args": {"run_name": "t", "log_model": True}}},
        "f1_checkpoint": {"monitor": "metrics/f1", "mode": "max"},
        "early_stopping": {"monitor": "metrics/f1", "patience": 10, "mode": "max"},
        "ckpt_path": None,
        "model": {"class_path": "model.model.KWSModel", "init_args": {
            **TRAIN, "sampling": "random", "kw_type": "tts", "batch_size": 4}},
        "data": {"init_args": dict(_data_args(root), test_info={
            "name": "aishell", "root": root, "kw_type": "natural"}, test_split="dev",
            device_features=True)},
    }
    path = tmp_path / "train.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    seen = {}
    real_fit = KWSEngine.fit

    def fit(self, datamodule, **kwargs):
        seen.update(batch_size=datamodule.batch_size, config=self.config, kwargs=kwargs)
        return real_fit(self, datamodule, **kwargs)

    monkeypatch.setattr(KWSEngine, "fit", fit)
    state = port_cli.run_cli(["fit", "--config", str(path)], device="cpu")
    assert seen["batch_size"] == 8  # batch_size × accumulate_grad_batches
    assert seen["config"].device_features == SIZE
    assert seen["kwargs"]["limit_train_batches"] == 3 and seen["kwargs"]["max_epochs"] == 2
    assert state.epoch == 1
    ckpt = run_dir / "checkpoints" / "final"
    assert (ckpt / "state.msgpack").exists() and (run_dir / "metrics.jsonl").exists()
    with open(run_dir / "artifacts.jsonl") as f:
        assert len(f.readlines()) >= 2  # log_model: each saved checkpoint
    results = port_cli.run_cli(["test", "--config", str(path), "--ckpt_path", str(ckpt)],
                               device="cpu")
    assert {"F1", "Precision", "Recall"} <= set(results)
    # the JAX CLI's test on the port's checkpoint (its runner shrunk to the
    # same tiny ResNet): the same metrics, bounds included (one process)
    with tiny_paper1_patch():
        jax_results = jax_cli.run_cli(["test", "--config", str(path), "--ckpt_path", str(ckpt)])
    assert results == pytest.approx(jax_results, rel=1e-6)
    # resuming the finished run trains nothing more and keeps its weights
    resumed = port_cli.run_cli(["fit", "--config", str(path), "--ckpt_path", str(ckpt)],
                               device="cpu")
    for k, v in state.kws.state_dict().items():
        assert torch.equal(resumed.kws.state_dict()[k], v), k
