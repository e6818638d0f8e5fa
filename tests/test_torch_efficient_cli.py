"""The port's CLI on the paper-2 eval configs against the JAX CLI, in one
process on the CPU at the tiny dims of ``tests/test_torch_efficient_eval.py``
(whose layouts, weights and bias centring it reuses).

``run_cli(["test" | "validate", "--config",
"configs/efficient_kws/eval-*-comp-acl.yaml", ...])`` with the placeholders
filled by ``--set`` and the widths shrunk by dotted overrides:

* ``test`` from a reference Lightning ``.ckpt`` and ``validate`` from a
  JAX checkpoint directory (the same weights), for LE and LEF on the
  ACL-6060 configs and L on the AISHELL config (the fixture's hotword dev
  split): every metric equal to the JAX CLI's, losses to rtol 1e-5.  The JAX CLI needs
  two values the configs do not give it (a float threshold where they
  quote the placeholder, and a batch size its datamodule accepts); the port
  runs the configs as written, with the same metrics;
* ``test`` with ``kws_int8`` on the K2-eligible bottleneck ResNet: the
  port hands ``s8_stages`` to the engine with no environment variable set
  (JAX with ``ECW_S8_PALLAS`` naming every stage), and the metrics equal
  JAX's;
* ``fit`` on an eval config, which names no training dataset, raises
  ``ValueError`` naming ``train_info`` (the CLI's ``fit`` itself:
  ``tests/test_torch_efficient_fit.py``).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import enhance_cb_whisper_tpu.cli.main as jax_cli
from enhance_cb_whisper_tpu.efficient_kws import model as jm
from enhance_cb_whisper_tpu.runtime.checkpoint import save_checkpoint as jax_save_checkpoint
from enhance_cb_whisper_tpu_torch.cli import main as port_cli
from enhance_cb_whisper_tpu_torch.convert import to_flax_variables
from enhance_cb_whisper_tpu_torch.efficient_kws import data as pd
from enhance_cb_whisper_tpu_torch.efficient_kws import engine as pe
from enhance_cb_whisper_tpu_torch.efficient_kws import model as pm
from enhance_cb_whisper_tpu_torch.efficient_kws.torch_compat import lightning_efficient_kws
from enhance_cb_whisper_tpu_torch.models.quant import s8_stages

from fixtures import DIM
from test_torch_efficient_eval import (  # noqa: F401  (roots, _small_chunks: fixtures)
    ALL_STAGES,
    FS,
    LANGS,
    VARIANTS,
    L,
    U,
    _centre,
    _config,
    _dm_args,
    _equal_metrics,
    _JaxBottleneck,
    _port_model,
    _PortBottleneck,
    _small_chunks,
    roots,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _drawn_variables(jcfg, seed):
    """Seeded variables in flax's layout, drawn with numpy over the port
    model's parameter shapes (no JAX compile, which would take most of a
    case's time): kernels He-normal, biases and BatchNorm shifts 0,
    BatchNorm scales 1, statistics (0, 1).  Both CLIs then read the same
    weights; ``_centre`` sets the class-1 bias."""
    port_cls = _PortBottleneck if isinstance(jcfg, _JaxBottleneck) else pm.EfficientKWSConfig
    pcfg = port_cls(**dataclasses.asdict(jcfg))
    rng = np.random.default_rng(seed)

    def draw(name, a):
        if name == "kernel":
            return rng.normal(0.0, np.sqrt(2.0 / np.prod(a.shape[:-1])), a.shape).astype(np.float32)
        return np.full(a.shape, 1.0 if name in ("scale", "var") else 0.0, np.float32)

    def tree(node):
        return {k: tree(v) if isinstance(v, dict) else draw(k, v) for k, v in node.items()}

    return tree(to_flax_variables(pm.EfficientKWSModel(pcfg).state_dict()))


def _write_checkpoints(tmp_path, variant, variables, cfg=None):
    """The same weights as a reference Lightning .ckpt and as a JAX
    checkpoint directory."""
    port = _port_model(variant, variables, cfg)
    ckpt = tmp_path / f"{variant}.ckpt"
    torch.save({"state_dict": lightning_efficient_kws(port.state_dict(), port.config)}, ckpt)
    directory = tmp_path / f"{variant}_dir"
    jax_save_checkpoint(str(directory), {"params": variables["params"], "batch_stats": variables["batch_stats"]})
    return str(ckpt), str(directory)


def _argv(subcommand, variant, roots, ckpt, *extra, dataset="acl"):
    root = f"{dataset.upper()}_ROOT={roots[dataset]}"
    return [subcommand, "--config", os.path.join(REPO, "configs", "efficient_kws", f"eval-{variant}-comp-{dataset}.yaml"),
            "--set", f"CKPT={ckpt}", "--set", "THRESHOLD=0.5", "--set", root,
            "--model.init_args.n_layers", str(L), "--model.init_args.embedding_dim", str(DIM),
            "--model.init_args.proj_mlp_units", str(U), "--model.init_args.resnet_version", "resnet-18",
            "--model.init_args.features_size", json.dumps(list(FS)),
            "--data.init_args.keywords_per_group", "3",
            "--data.init_args.val_info",
            json.dumps([{"language": lang, "root": roots["mls"], "kw_type": "natural"} for lang in LANGS]),
            "--trainer.default_root_dir", os.path.join(os.path.dirname(ckpt), "runs"), *extra,
            # the JAX CLI takes the configs' quoted threshold as a string and
            # its datamodule refuses their default batch size of 1 under
            # utterance-examples sampling; the port needs neither value
            "--model.init_args.threshold", "0.5", "--model.init_args.batch_size", "4"]


@pytest.mark.parametrize("variant,dataset", [("LE", "acl"), ("LEF", "acl"), ("L", "aishell")])
def test_cli_test_and_validate_match_jax(roots, tmp_path, variant, dataset):
    variables = _drawn_variables(_config(jm, variant), seed=2)
    extra, dm_args = (), _dm_args(roots)
    if dataset == "aishell":  # the fixture's hotword dev split
        info = {"name": "aishell", "root": roots["aishell"], "kw_type": "natural"}
        extra = ("--data.init_args.test_split", "dev", "--data.init_args.test_info", json.dumps(info))
        dm_args.update(test_split="dev", test_info=info)
    engine = pe.EfficientKWSEngine(_config(pm, variant), device="cpu")
    dm = pd.EfficientKWSDataMod(**dm_args)
    dm.setup("test")
    variables = _centre(variables, _port_model(variant, variables), engine, dm.test_dataset)
    ckpt, directory = _write_checkpoints(tmp_path, variant, variables)
    for subcommand, path in (("test", ckpt), ("validate", directory)):
        argv = _argv(subcommand, variant, roots, path, *extra, dataset=dataset)
        want = jax_cli.run_cli(list(argv))
        got = port_cli.run_cli(list(argv), device="cpu")
        _equal_metrics(got, want)
    assert port_cli.run_cli(argv[:-4], device="cpu") == got  # the config as written
    with pytest.raises(ValueError, match="train_info"):
        port_cli.run_cli(["fit"] + argv[1:], device="cpu")


def test_cli_kws_int8_matches_jax(roots, tmp_path, monkeypatch):
    fields = dict(n_layers=L, embedding_dim=DIM, proj_mlp_units=U, **VARIANTS["LE"])
    variables = _drawn_variables(_JaxBottleneck(**fields), seed=3)
    engine = pe.EfficientKWSEngine(_PortBottleneck(**fields), device="cpu")
    dm = pd.EfficientKWSDataMod(**_dm_args(roots))
    dm.setup("test")
    variables = _centre(variables, _port_model("LE", variables, _PortBottleneck(**fields)), engine,
                        dm.test_dataset)
    ckpt, _ = _write_checkpoints(tmp_path, "LE", variables, _PortBottleneck(**fields))
    argv = _argv("test", "LE", roots, ckpt, "--model.init_args.kws_int8", "true",
                 "--model.init_args.kws_int8_calibration_batches", "2")
    monkeypatch.setattr(jm.EfficientKWSConfig, "resnet_config", _JaxBottleneck.resnet_config)
    monkeypatch.setattr(pm.EfficientKWSConfig, "resnet_config", _PortBottleneck.resnet_config)
    monkeypatch.setenv("ECW_S8_PALLAS", ALL_STAGES)
    want = jax_cli.run_cli(list(argv))
    monkeypatch.delenv("ECW_S8_PALLAS")  # the port reads no environment
    seen = []
    real = pe.EfficientKWSEngine.enable_int8_scoring
    monkeypatch.setattr(pe.EfficientKWSEngine, "enable_int8_scoring",
                        lambda self, *a, **kw: seen.append(kw["s8_1x1"]) or real(self, *a, **kw))
    got = port_cli.run_cli(list(argv), device="cpu")
    assert seen == [s8_stages(_PortBottleneck(**fields).resnet_config())]
    _equal_metrics(got, want)
