"""The port's paper-2 ``fit``, its checkpoints and the CLI's ``fit``, against
the JAX package's, on the CPU.

A synthetic MLS layout (``make_mls``: English and German, 12-wide stacks,
1-2 s WAVs), LE at ``embedding_dim`` 8 (stacks wider than it), features
(32, 64), ``kw_type='all'`` at batch 4 pairs, the two-stage tiny ResNet of
``tests/test_torch_efficient_train_step.py`` on both sides:

* one epoch of two batches through JAX's ``fit`` and the port's from the
  same initial variables (the port's flax-style init, converted), the port
  stepping on JAX's coin draws: every weight within two rates a step of
  JAX's, at least 98 % of them and all of the classifier within rtol 1e-4
  and 1e-5 × the leaf's scale (Adam moves a weight by about its rate
  whatever a gradient's size, so a gradient at rounding level can step the
  other way); the statistics within rtol 1e-4 and 1e-5 × the leaf's scale;
  the validation loss within 2 %, precision, recall and F1 equal; the
  checkpoints ``f1_checkpoint`` and ``final``, read by JAX's reader;
* a resume from the port's ``final``: epoch 1, global step 4;
* each package resuming the other's checkpoint, AdamW's state included:
  the moments, counts and rates bit for bit, and one more step from each
  within the step's rate of the writer's own next step, at least 98 % of
  the elements and all of the classifier within 1e-6;
* ``run_cli(["fit", ...])`` from the caches (LEF; JAX's engine validates
  the written checkpoint to the port's metrics) and from raw audio with a
  tiny Whisper checkpoint the test writes itself (``config.json`` and
  ``model.safetensors``; the layout's utterance caches deleted first).
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import serialization
from safetensors.torch import save_file

from enhance_cb_whisper_tpu.efficient_kws import data as jd
from enhance_cb_whisper_tpu.efficient_kws import engine as je
from enhance_cb_whisper_tpu.efficient_kws import model as jm
from enhance_cb_whisper_tpu.models.resnet import ResNetConfig as JaxResNetConfig
from enhance_cb_whisper_tpu.runtime.checkpoint import load_checkpoint as jax_load_checkpoint
from enhance_cb_whisper_tpu.runtime.logging import MetricsLogger as JaxLogger
from enhance_cb_whisper_tpu_torch.cli import main as port_cli
from enhance_cb_whisper_tpu_torch.convert import to_flax_variables
from enhance_cb_whisper_tpu_torch.efficient_kws import data as pd
from enhance_cb_whisper_tpu_torch.efficient_kws import engine as pe
from enhance_cb_whisper_tpu_torch.efficient_kws import model as pm
from enhance_cb_whisper_tpu_torch.models.resnet import ResNetConfig
from enhance_cb_whisper_tpu_torch.models.whisper import WhisperConfig, init_whisper_params
from enhance_cb_whisper_tpu_torch.models.whisper_loader import hf_whisper_state
from enhance_cb_whisper_tpu_torch.runtime.checkpoint import load_checkpoint
from enhance_cb_whisper_tpu_torch.runtime.logging import MetricsLogger
from enhance_cb_whisper_tpu_torch.train.kws_train import adam_tree

from fixtures import make_mls

LANGS = ("English", "German")
FS = (32, 64)
WIDTH = 12
TINY = dict(embedding_size=8, hidden_sizes=(8, 16), depths=(1, 1), num_labels=2)
FIELDS = dict(n_layers=2, embedding_dim=8, proj_mlp_units=4, learn_features=True, proj_mlp=True)
TRAIN = dict(kw_type="all", learning_rate=1e-3, learning_rate_sru=2e-3, max_epochs=3)
SEED = 7
LR = 2e-3  # the larger group rate
FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


@dataclasses.dataclass(frozen=True)
class _JaxTiny(jm.EfficientKWSConfig):
    def resnet_config(self):
        return JaxResNetConfig(num_channels=self.n_layers, **TINY)


@dataclasses.dataclass(frozen=True)
class _PortTiny(pm.EfficientKWSConfig):
    def resnet_config(self):
        return ResNetConfig(num_channels=self.n_layers, **TINY)


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


class JaxNoise:
    def __init__(self, coin):
        self._coin = coin

    def coin(self, n, p):
        assert self._coin.shape == (n,)
        return torch.from_numpy(self._coin.copy())


def _jax_coin(global_step, n, seed=SEED, kw_p=0.5):
    rng = jax.random.fold_in(jax.random.PRNGKey(seed + 1), global_step)
    return np.asarray(jax.random.bernoulli(rng, 1.0 - kw_p, (n,)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("mls")
    make_mls(str(root), languages=LANGS, with_audio=True, dim=WIDTH)
    return str(root)


def _dm_args(root, **extra):
    return dict(batch_size=4, sampling="utterance-examples", features_size=FS, n_layers=2,
                languages=list(LANGS), keywords_per_group=2,
                train_info=[{"name": "mls", "root": root, "kw_type": "all"}],
                val_info=[{"language": lang, "root": root, "kw_type": "natural"} for lang in LANGS],
                **extra)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def runs(root, tmp_path_factory):
    """JAX's fit and the port's, one epoch of two batches each from the same
    initial variables, with each one's validation metrics."""
    port = pe.EfficientKWSEngine(_PortTiny(**FIELDS), pe.EfficientTrainConfig(**TRAIN), seed=SEED,
                                 ckpt_dir=str(tmp_path_factory.mktemp("port_ckpt")),
                                 logger=MetricsLogger(verbose=False), device="cpu")
    dm = pd.EfficientKWSDataMod(**_dm_args(root))
    dm.setup("fit")
    sample = next(iter(dm.train_dataloader()))
    initial = to_flax_variables(port.init_state(sample).model.state_dict())

    engine = je.EfficientKWSEngine(_JaxTiny(**FIELDS), je.EfficientTrainConfig(**TRAIN), seed=SEED,
                                   ckpt_dir=str(tmp_path_factory.mktemp("jax_ckpt")),
                                   logger=JaxLogger(verbose=False))
    engine._score_group = _FastJit(engine._score_group)
    steps, jax_val = [], []
    real_make, real_validate, real_jit = engine.make_train_step, engine.validate, jax.jit
    engine.make_train_step = lambda: steps.append(real_make()) or steps[-1]
    engine.validate = lambda *a, **k: jax_val.append(real_validate(*a, **k)) or jax_val[-1]
    mp = pytest.MonkeyPatch()
    mp.setattr(jm.EfficientKWSModel, "init", lambda self, rng, *a, **kw: initial)
    mp.setattr(jax, "jit", lambda fn, **kw: _FastJit(real_jit(fn, **kw)))
    try:
        jax_params, jax_stats = engine.fit(jd.EfficientKWSDataMod(**_dm_args(root)), max_epochs=1,
                                           limit_train_batches=2)
    finally:
        mp.undo()

    real_init = port.init_state

    def init_state(sample):
        state = real_init(sample)
        port.restore_state(state, initial)
        return state

    port.init_state = init_state
    port_val = []
    port_validate = port.validate
    port.validate = lambda *a, **k: port_val.append(port_validate(*a, **k)) or port_val[-1]
    mp = pytest.MonkeyPatch()
    # the step's coin: JAX's draw for the global step
    mp.setattr(pe, "step_seed", lambda seed, global_step: global_step)
    mp.setattr(pe, "StepNoise", lambda step, device: _CoinAt(step))
    try:
        state = port.fit(pd.EfficientKWSDataMod(**_dm_args(root)), max_epochs=1, limit_train_batches=2)
    finally:
        mp.undo()
    return dict(initial=initial, jax_params=jax.tree.map(np.asarray, jax_params),
                jax_stats=jax.tree.map(np.asarray, jax_stats), jax_val=jax_val, jax_engine=engine,
                jax_step=steps[0], port=port, state=state, port_val=port_val)


class _CoinAt(JaxNoise):
    def __init__(self, global_step):
        self.global_step = global_step

    def coin(self, n, p):
        self._coin = _jax_coin(self.global_step, n, kw_p=1.0 - p)
        return super().coin(n, p)


def test_one_epoch_matches_jax(runs):
    got = _flat(to_flax_variables(runs["state"].model.state_dict())["params"])
    want, start = _flat(runs["jax_params"]), _flat(runs["initial"]["params"])
    assert got.keys() == want.keys()
    close = []
    for k, w in want.items():
        assert np.abs(w - start[k]).max() > 0, k  # every leaf trained
        scale = float(np.abs(w).max()) or 1.0
        diff = np.abs(got[k] - w)
        assert diff.max() <= 2 * 2 * LR, (k, diff.max())
        near = diff <= 1e-4 * np.abs(w) + 1e-5 * scale
        if "classifier" in k:
            assert near.all(), k
        close.append(near.ravel())
    assert np.concatenate(close).mean() >= 0.98
    got_s = _flat(to_flax_variables(runs["state"].model.state_dict())["batch_stats"])
    for k, w in _flat(runs["jax_stats"]).items():
        np.testing.assert_allclose(got_s[k], w, rtol=1e-4, atol=1e-5 * (float(np.abs(w).max()) or 1.0),
                                   err_msg=k)
    assert len(runs["port_val"]) == len(runs["jax_val"]) == 1
    got_m, want_m = runs["port_val"][0], runs["jax_val"][0]
    assert got_m.keys() == want_m.keys()
    for k, v in want_m.items():
        if "loss" in k:
            assert got_m[k] == pytest.approx(v, rel=0.02), k
        elif k.split("/")[-1].split("_")[0] in ("precision", "recall", "f1"):
            assert got_m[k] == v, k
    assert runs["state"].model.training  # back in train mode after validate


def test_checkpoints_and_resume(runs, root, tmp_path):
    ckpt = runs["port"].ckpt_dir
    assert {"f1_checkpoint", "final"} <= set(os.listdir(ckpt))
    raw, meta = jax_load_checkpoint(os.path.join(ckpt, "final"))
    assert meta["epoch"] == 0 and int(raw["global_step"]) == 2 and "opt_state" in raw
    want = _flat(to_flax_variables(runs["state"].model.state_dict())["params"])
    for k, v in _flat(raw["params"]).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    engine = pe.EfficientKWSEngine(_PortTiny(**FIELDS), pe.EfficientTrainConfig(**TRAIN), seed=SEED,
                                   ckpt_dir=str(tmp_path / "resumed"), logger=MetricsLogger(verbose=False),
                                   device="cpu")
    state = engine.fit(pd.EfficientKWSDataMod(**_dm_args(root)), max_epochs=2, limit_train_batches=2,
                       resume_from=os.path.join(ckpt, "final"))
    resumed, meta = load_checkpoint(str(tmp_path / "resumed" / "final"))
    assert meta["epoch"] == 1 and state.epoch == 1  # resumed at epoch 1
    assert int(resumed["global_step"]) == 4  # the step counter continued


def _next_batch(root):
    dm = jd.EfficientKWSDataMod(**_dm_args(root))
    dm.setup("fit")
    it = iter(dm.train_dataloader())
    next(it)
    return next(it)


def _port_step(state, engine, batch, coin):
    engine.make_train_step(state)({k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()},
                                  JaxNoise(coin))
    return _flat(to_flax_variables(state.model.state_dict())["params"])


def _assert_next_step_close(got, want):
    assert got.keys() == want.keys()
    close = []
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=2 * LR, err_msg=k)
        close.append(np.abs(got[k] - w).ravel() <= 1e-6)
        if "classifier" in k:
            np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-6, err_msg=k)
    assert np.concatenate(close).mean() >= 0.98, np.concatenate(close).mean()


def test_optimizer_state_resumes_across_packages(runs, root):
    batch = _next_batch(root)
    coin = _jax_coin(99, batch["labels"].shape[0] // 2)
    rng = jax.random.fold_in(jax.random.PRNGKey(SEED + 1), 99)
    engine, jax_step = runs["jax_engine"], runs["jax_step"]
    template = {"params": runs["jax_params"], "batch_stats": runs["jax_stats"], "epoch": 0,
                "opt_state": engine._tx.init(runs["jax_params"]), "global_step": 0}

    def jax_next(restored):
        out = jax_step(restored["params"], restored["batch_stats"], restored["opt_state"],
                       {k: jnp.asarray(v) for k, v in batch.items()}, rng)
        return _flat(out[0])

    # the port's checkpoint resumed in JAX, against the port's own next step
    port_ckpt = os.path.join(runs["port"].ckpt_dir, "final")
    restored, _ = jax_load_checkpoint(port_ckpt, template=template)
    raw, _ = load_checkpoint(port_ckpt)
    got_opt, want_opt = _flat(serialization.to_state_dict(restored["opt_state"])), _flat(raw["opt_state"])
    assert got_opt.keys() == want_opt.keys()
    for k in want_opt:
        np.testing.assert_array_equal(got_opt[k], want_opt[k], err_msg=k)
    assert {int(v) for k, v in got_opt.items() if k.endswith("['count']")} == {2}
    port = runs["port"]
    state = port.init_state(batch)
    port.restore_state(state, raw)
    _assert_next_step_close(jax_next(restored), _port_step(state, port, batch, coin))

    # JAX's checkpoint resumed in the port, against JAX's own next step
    jax_ckpt = os.path.join(engine.ckpt_dir, "final")
    restored, _ = jax_load_checkpoint(jax_ckpt, template=template)
    state = port.init_state(batch)
    port.restore_state(state, load_checkpoint(jax_ckpt)[0])
    again = _flat(adam_tree(state.optimizer, {"": state.model}))
    for k, v in _flat(serialization.to_state_dict(restored["opt_state"])).items():
        np.testing.assert_array_equal(again[k], v, err_msg=k)
    _assert_next_step_close(_port_step(state, port, batch, coin), jax_next(restored))


def _write_whisper(directory):
    """A tiny random Whisper checkpoint: ``config.json`` and the weights
    under HF's names in ``model.safetensors``."""
    os.makedirs(directory)
    hf = dict(vocab_size=64, num_mel_bins=80, d_model=WIDTH, encoder_layers=4,
              encoder_attention_heads=2, decoder_layers=1, decoder_attention_heads=2,
              encoder_ffn_dim=24, decoder_ffn_dim=24, max_source_positions=1500,
              max_target_positions=16, pad_token_id=0, bos_token_id=1, eos_token_id=2,
              decoder_start_token_id=3, model_type="whisper")
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(hf, f)
    from enhance_cb_whisper_tpu_torch.convert import from_jax_whisper_params

    params = from_jax_whisper_params(init_whisper_params(np.random.default_rng(0), WhisperConfig.from_hf(hf)),
                                     device="cpu")
    save_file(hf_whisper_state(params), os.path.join(directory, "model.safetensors"))


def _fit_config(path, root, run_dir, **model):
    config = {
        "seed_everything": 123,
        "trainer": {"max_epochs": 1, "limit_train_batches": 2, "default_root_dir": str(run_dir)},
        "f1_checkpoint": {"monitor": "metrics/f1", "mode": "max"},
        "early_stopping": {"monitor": "metrics/f1", "patience": 5, "mode": "max"},
        "model": {"class_path": "efficient_kws.model.KWSModel", "init_args": {
            "n_layers": 2, "embedding_dim": 8, "learn_features": True, "proj_mlp": True,
            "proj_mlp_units": 4, "batch_size": 4, "sampling": "utterance-examples", "kw_type": "all",
            "features_size": list(FS), "learning_rate": 1e-3, "learning_rate_sru": 1e-3, **model}},
        "data": {"init_args": {
            "train_info": [{"name": "mls", "root": root, "kw_type": "all"}],
            "val_info": [{"language": "English", "root": root, "kw_type": "natural"}],
            "languages": list(LANGS), "keywords_per_group": 2}},
    }
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return str(path)


def _losses(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        values = [json.loads(line)["metrics"].get("train/loss") for line in f]
    return [v for v in values if v is not None]


def test_cli_fit_from_caches_and_from_audio(root, tmp_path, monkeypatch):
    monkeypatch.setattr(pm.EfficientKWSConfig, "resnet_config", _PortTiny.resnet_config)
    run_dir = tmp_path / "caches"
    cfg = _fit_config(tmp_path / "caches.yaml", root, run_dir, frames_conv=True)
    state = port_cli.run_cli(["fit", "--config", cfg], device="cpu")
    assert state.epoch == 0 and state.model.projector.proj_0_0.in_features == WIDTH
    ckpt = run_dir / "checkpoints" / "final"
    assert (ckpt / "state.msgpack").exists()
    assert _losses(run_dir) and all(np.isfinite(_losses(run_dir)))
    # JAX's engine validates the written checkpoint to the port's metrics
    raw, _ = jax_load_checkpoint(str(ckpt))
    jcfg = _JaxTiny(**dict(FIELDS, frames_conv=True))
    jax_engine = je.EfficientKWSEngine(jcfg)
    jax_engine._score_group = _FastJit(jax_engine._score_group)
    val_info = [{"language": "English", "root": root, "kw_type": "natural"}]
    jax_dm = jd.EfficientKWSDataMod(batch_size=4, features_size=FS, n_layers=2, keywords_per_group=2,
                                    val_info=val_info)
    jax_dm.setup("validate")
    want = jax_engine.validate(jax_engine.variables(raw["params"], raw["batch_stats"]), jax_dm)
    port_dm = pd.EfficientKWSDataMod(batch_size=4, features_size=FS, n_layers=2, keywords_per_group=2,
                                     val_info=val_info)
    port_dm.setup("validate")
    engine = pe.EfficientKWSEngine(_PortTiny(**dict(FIELDS, frames_conv=True)), device="cpu")
    got = engine.validate(engine.build_model({"params": raw["params"], "batch_stats": raw["batch_stats"]}),
                          port_dm)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-4, abs=1e-6), k

    # the audio mode: no utterance cache is read
    audio_root = tmp_path / "mls_audio"
    shutil.copytree(root, audio_root, symlinks=True)
    for lang in LANGS:
        shutil.rmtree(audio_root / f"mls_{lang.lower()}_opus" / "train" / "hs")
    _write_whisper(tmp_path / "whisper")
    run_dir = tmp_path / "audio"
    cfg = _fit_config(tmp_path / "audio.yaml", str(audio_root), run_dir, load_embeddings=False,
                      kws_whisper_ckpt=str(tmp_path / "whisper"), kws_layer_slice=[1, 5])
    state = port_cli.run_cli(["fit", "--config", cfg], device="cpu")
    assert (run_dir / "checkpoints" / "final" / "state.msgpack").exists()
    assert _losses(run_dir) and all(np.isfinite(_losses(run_dir)))
    assert all(bool(torch.isfinite(p).all()) for p in state.model.parameters())
