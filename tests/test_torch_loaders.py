"""The port's checkpoint loaders against the JAX package's, on the CPU.

* Whisper: a tiny random ``WhisperForConditionalGeneration`` written by
  ``save_pretrained`` as ``model.safetensors``, as ``pytorch_model.bin``,
  as a sharded safetensors index and as a float16 copy.  The port's
  ``load_whisper_from_pretrained`` must give the same config and, tensor for
  tensor, exactly (atol 0) what ``from_jax_whisper_params`` makes of the JAX
  loader's params.  ``hf_whisper_state``, the inverse writer, gives back
  the file's tensors under their own names.
* KWS: a reference Lightning ``.ckpt`` (current keys and the legacy
  ``model.resnet.*`` keys) and a JAX ``save_checkpoint`` directory of the
  same weights (float32 and bfloat16 leaves).  The port's
  ``_load_kws_variables`` must equal ``from_flax_resnet_variables`` of the
  JAX CLI's ``_load_kws_variables`` exactly, and load into the port's
  ``KWSModel``.  ``lightning_resnet_classifier``, the inverse writer,
  gives back the checkpoint's tensors under their own names.
* A missing ``msgpack`` raises ``ImportError`` instead of falling back.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import enhance_cb_whisper_tpu.cli.main as jax_cli
from enhance_cb_whisper_tpu.models.resnet import ResNetConfig as JaxResNetConfig
from enhance_cb_whisper_tpu.models.whisper_loader import (
    load_whisper_from_pretrained as jax_load_whisper,
)
from enhance_cb_whisper_tpu.runtime.checkpoint import save_checkpoint
from enhance_cb_whisper_tpu_torch.cli import main as port_cli
from enhance_cb_whisper_tpu_torch.convert import from_flax_resnet_variables, from_jax_whisper_params
from enhance_cb_whisper_tpu_torch.models.kws import KWSModel
from enhance_cb_whisper_tpu_torch.models.resnet import ResNetConfig
from enhance_cb_whisper_tpu_torch.models.torch_compat import lightning_resnet_classifier
from enhance_cb_whisper_tpu_torch.models.whisper_loader import (
    hf_whisper_state,
    load_hf_whisper,
    load_whisper_from_pretrained,
    load_whisper_from_safetensors,
)
from enhance_cb_whisper_tpu_torch.runtime.checkpoint import load_checkpoint

transformers = pytest.importorskip("transformers")

RESNET = dict(num_channels=3, embedding_size=8, hidden_sizes=(8, 16, 24, 32), depths=(1, 1, 1, 1),
              num_labels=2)


@pytest.fixture(scope="module")
def whisper_dirs(tmp_path_factory):
    cfg = transformers.WhisperConfig(
        vocab_size=128, num_mel_bins=8, d_model=32,
        encoder_layers=3, encoder_attention_heads=4,
        decoder_layers=2, decoder_attention_heads=4,
        encoder_ffn_dim=64, decoder_ffn_dim=64,
        max_source_positions=1500, max_target_positions=40,
        pad_token_id=0, bos_token_id=1, eos_token_id=2, decoder_start_token_id=3,
        suppress_tokens=None, begin_suppress_tokens=None,
    )
    torch.manual_seed(0)
    model = transformers.WhisperForConditionalGeneration(cfg)
    with torch.no_grad():  # nonzero biases and LayerNorms, so every leaf is checked
        for p in model.parameters():
            p.add_(torch.randn_like(p) * 0.01)
    dirs = {}
    for kind, kwargs in (("safetensors", {}), ("bin", {"safe_serialization": False}),
                         ("sharded", {"max_shard_size": "100KB"})):
        dirs[kind] = str(tmp_path_factory.mktemp(f"whisper_{kind}"))
        model.save_pretrained(dirs[kind], **kwargs)
    dirs["float16"] = str(tmp_path_factory.mktemp("whisper_float16"))
    model.half().save_pretrained(dirs["float16"])
    return dirs


def _assert_trees_equal(got, want, path=""):
    assert type(got) is type(want), path
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for key in want:
            _assert_trees_equal(got[key], want[key], f"{path}.{key}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_equal(g, w, f"{path}[{i}]")
    else:
        assert got.dtype == want.dtype == torch.float32, path
        assert got.shape == want.shape, path
        assert torch.equal(got, want), path


@pytest.mark.parametrize("kind", ["safetensors", "bin", "sharded", "float16"])
def test_whisper_loader_matches_jax(whisper_dirs, kind):
    path = whisper_dirs[kind]
    if kind == "sharded":
        assert os.path.exists(os.path.join(path, "model.safetensors.index.json"))
    jcfg, jparams = jax_load_whisper(path)
    cfg, params = load_whisper_from_pretrained(path, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    _assert_trees_equal(params, from_jax_whisper_params(jparams, device="cpu"))
    if kind == "safetensors":  # the single-file reader, given the file itself
        direct = load_whisper_from_safetensors(os.path.join(path, "model.safetensors"), cfg, device="cpu")
        _assert_trees_equal(direct, params)
    if kind == "float16":  # the upcast keeps the float16 values
        _, full = load_whisper_from_pretrained(whisper_dirs["safetensors"], device="cpu")
        want = full["decoder"]["embed_tokens"]["weight"].half().float()
        assert torch.equal(params["decoder"]["embed_tokens"]["weight"], want)


def test_hf_whisper_state_inverts_the_loader(whisper_dirs):
    from safetensors.torch import load_file

    path = whisper_dirs["safetensors"]
    cfg, params = load_whisper_from_pretrained(path, device="cpu")
    stored = {k: v for k, v in load_file(os.path.join(path, "model.safetensors")).items()
              if k != "proj_out.weight"}
    written = hf_whisper_state(params)
    assert sorted(written) == sorted(stored)
    for key, value in stored.items():
        assert torch.equal(written[key], value.float()), key
    _assert_trees_equal(load_hf_whisper(written, cfg, device="cpu"), params)


def _randomize(sd, seed):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in sd.items():
        if not v.is_floating_point():
            out[k] = v
        elif k.endswith("running_var"):
            out[k] = torch.rand(v.shape, generator=g) + 0.5
        else:
            out[k] = torch.randn(v.shape, generator=g) * 0.1
    return out


@pytest.fixture(scope="module")
def lightning_ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("kws_lightning")
    hf_cfg = transformers.ResNetConfig(num_channels=3, embedding_size=8, hidden_sizes=[8, 16, 24, 32],
                                       depths=[1, 1, 1, 1])
    torch.manual_seed(0)
    hf = _randomize(transformers.ResNetModel(hf_cfg).state_dict(), 1)
    sd = {f"model.feature_extractor.{k}": v for k, v in hf.items()}
    head = _randomize(torch.nn.Linear(32, 2).state_dict(), 2)
    sd["model.classifier.1.weight"], sd["model.classifier.1.bias"] = head["weight"], head["bias"]
    torch.save({"state_dict": sd, "epoch": 3}, d / "current.ckpt")
    legacy = {("model.resnet." + k[len("model.feature_extractor."):]
               if k.startswith("model.feature_extractor.") else k): v for k, v in sd.items()}
    torch.save({"state_dict": legacy}, d / "legacy.ckpt")
    return {"current": str(d / "current.ckpt"), "legacy": str(d / "legacy.ckpt")}


def _jax_state(path, jcfg):
    return from_flax_resnet_variables(jax.tree.map(np.asarray, jax_cli._load_kws_variables(path, jcfg)))


def _assert_states_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == torch.float32, key
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("layout", ["current", "legacy"])
def test_kws_lightning_ckpt_matches_jax(lightning_ckpts, layout):
    path = lightning_ckpts[layout]
    got = port_cli._load_kws_variables(path, ResNetConfig(**RESNET))
    _assert_states_equal(got, _jax_state(path, JaxResNetConfig(**RESNET)))
    KWSModel(ResNetConfig(**RESNET)).load_converted(got)


def test_lightning_writer_inverts_the_loader(lightning_ckpts):
    path = lightning_ckpts["current"]
    stored = torch.load(path, weights_only=True)["state_dict"]
    got = port_cli._load_kws_variables(path, ResNetConfig(**RESNET))
    written = lightning_resnet_classifier(got, ResNetConfig(**RESNET))
    assert sorted(written) == sorted(k for k in stored if not k.endswith("num_batches_tracked"))
    for key, value in written.items():
        assert torch.equal(value, stored[key]), key
    _assert_states_equal(port_cli._load_kws_variables(path, ResNetConfig(**RESNET)), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kws_checkpoint_dir_matches_jax(tmp_path, lightning_ckpts, dtype):
    # flax variables of a random classifier (through the JAX converter, no
    # compile), saved as the JAX trainer saves them
    jcfg = JaxResNetConfig(**RESNET)
    variables = jax_cli._load_kws_variables(lightning_ckpts["current"], jcfg)
    variables = jax.tree.map(lambda x: np.asarray(x).astype(getattr(jnp, dtype)), variables)
    save_checkpoint(str(tmp_path / "f1"), {"params": {"kws": variables["params"]},
                                          "batch_stats": {"kws": variables["batch_stats"]}},
                    {"epoch": 2})
    got = port_cli._load_kws_variables(str(tmp_path / "f1"), ResNetConfig(**RESNET))
    _assert_states_equal(got, _jax_state(str(tmp_path / "f1"), jcfg))
    KWSModel(ResNetConfig(**RESNET)).load_converted(got)
    assert load_checkpoint(str(tmp_path / "f1"))[1] == {"epoch": 2}


def test_missing_msgpack_raises(tmp_path, monkeypatch):
    save_checkpoint(str(tmp_path / "ck"), {"params": {"w": np.ones(3, np.float32)}})
    monkeypatch.setitem(sys.modules, "msgpack", None)
    with pytest.raises(ImportError, match="msgpack"):
        load_checkpoint(str(tmp_path / "ck"))
