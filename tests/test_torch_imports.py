"""The port stands without JAX: every module of enhance_cb_whisper_tpu_torch
imports in a fresh interpreter with neither jax, flax nor the JAX package
(enhance_cb_whisper_tpu) loaded; each kernel's wrapper takes its plain
version for CPU tensors without counting a launch; and the entry points
place their work on the card unless the caller asks for the CPU."""

import inspect
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import enhance_cb_whisper_tpu_torch
from enhance_cb_whisper_tpu_torch.ops import matmul_s8_cuda, mel_cuda
from enhance_cb_whisper_tpu_torch.ops.matmul_s8 import matmul_s8_requant_plain
from enhance_cb_whisper_tpu_torch.ops.mel import log10_mel_plain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules():
    pkg = enhance_cb_whisper_tpu_torch
    return [pkg.__name__] + sorted(
        m.name for m in pkgutil.walk_packages(pkg.__path__, prefix=pkg.__name__ + ".")
    )


def test_port_imports_no_jax():
    modules = _modules()
    assert "enhance_cb_whisper_tpu_torch.models.cb_whisper" in modules
    assert "enhance_cb_whisper_tpu_torch.runtime.serving" in modules
    for name in ("train.kws_train", "train.optim", "data.samplers", "data.collators",
                 "runtime.logging", "efficient_kws", "efficient_kws.model", "efficient_kws.catalog",
                 "efficient_kws.data", "efficient_kws.engine", "efficient_kws.torch_compat",
                 "pipeline", "parallel", "parallel.mesh", "parallel.sharding", "parallel.dryrun",
                 "runtime.sharded_checkpoint", "runtime.profiler"):
        assert f"enhance_cb_whisper_tpu_torch.{name}" in modules, name
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'enhance_cb_whisper_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("ok")


def test_mel_wrapper_on_cpu_is_the_plain_version():
    audio = torch.from_numpy(
        (np.random.default_rng(0).standard_normal((2, 16000 * 2)) * 0.1).astype(np.float32)
    )
    before = mel_cuda.launches
    got = mel_cuda.log10_mel(audio, 80)
    assert mel_cuda.launches == before == 0
    torch.testing.assert_close(got, log10_mel_plain(audio, 80), rtol=0, atol=0)
    assert got.shape == (2, 80, 200)


def test_matmul_s8_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.integers(-127, 128, (40, 256)).astype(np.int8))
    w_nk = torch.from_numpy(rng.integers(-127, 128, (128, 256)).astype(np.int8))
    scale = torch.from_numpy((rng.uniform(0.5, 2.0, 128) * 1e-4).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.5, 128).astype(np.float32))
    res = dict(residual=torch.from_numpy(rng.integers(-127, 128, (40, 128)).astype(np.int8)),
               res_scale=torch.tensor(1.5e-3))
    before = matmul_s8_cuda.launches
    # w as the [K, N] view of a [N, K] tensor, as the int8 ResNet passes it
    got = matmul_s8_cuda.matmul_s8_requant(x, w_nk.t(), scale, bias, relu=False, **res)
    assert matmul_s8_cuda.launches == before == 0
    want = matmul_s8_requant_plain(x, w_nk.t().contiguous(), scale, bias, relu=False, **res)
    assert got.dtype == torch.int8 and got.shape == (40, 128)
    assert torch.equal(got, want)
    assert len(torch.unique(got)) > 10


def test_entry_points_default_to_the_card():
    """Without ``device`` the entry points target CUDA: on a machine with
    no card they raise instead of quietly running on the CPU."""
    from enhance_cb_whisper_tpu_torch.audio.io import prepare_features
    from enhance_cb_whisper_tpu_torch.catalog.database import KeywordCatalog, device_put_catalog
    from enhance_cb_whisper_tpu_torch.cli import run_cli
    from enhance_cb_whisper_tpu_torch.convert import from_jax_quantized_params, from_jax_whisper_params
    from enhance_cb_whisper_tpu_torch.decoding.generate import GenerationOptions, WhisperGenerator
    from enhance_cb_whisper_tpu_torch.efficient_kws.engine import EfficientKWSEngine
    from enhance_cb_whisper_tpu_torch.efficient_kws.model import EfficientKWSConfig
    from enhance_cb_whisper_tpu_torch.models.cb_whisper import CBWhisper, CBWhisperConfig
    from enhance_cb_whisper_tpu_torch.models.kws import KWSModel
    from enhance_cb_whisper_tpu_torch.models.resnet import ResNetConfig
    from enhance_cb_whisper_tpu_torch.models.whisper import WhisperConfig
    from enhance_cb_whisper_tpu_torch.models.whisper_loader import (
        load_hf_whisper,
        load_whisper_from_pretrained,
        load_whisper_from_safetensors,
    )
    from enhance_cb_whisper_tpu_torch.pipeline import extract_hidden_states
    from enhance_cb_whisper_tpu_torch.runtime.kws_engine import KWSEngine
    from enhance_cb_whisper_tpu_torch.train.kws_train import StepNoise, init_train_state

    cfg = WhisperConfig(vocab_size=16, d_model=8, encoder_layers=1, decoder_layers=1,
                        encoder_attention_heads=2, decoder_attention_heads=2,
                        encoder_ffn_dim=8, decoder_ffn_dim=8)
    params = {"encoder": {"w": np.zeros(2, np.float32)}, "decoder": {"w": np.zeros(2, np.float32)}}
    stack = np.ones((2, 3, 8), np.float32)
    catalog = KeywordCatalog.from_arrays(["kw"], [stack])
    calls = {
        "prepare_features": lambda: prepare_features(np.zeros(1600, np.float32)),
        "from_jax_whisper_params": lambda: from_jax_whisper_params(params),
        "from_jax_quantized_params": lambda: from_jax_quantized_params(
            {"classifier": {"bias": np.zeros(2, np.float32)}}),
        "device_put_catalog": lambda: device_put_catalog(catalog, out_h=4, chunk=8),
        "CBWhisper": lambda: CBWhisper(
            CBWhisperConfig(), cfg, from_jax_whisper_params(params, device="cpu"),
            KWSModel(ResNetConfig(num_channels=2, embedding_size=8, hidden_sizes=(8,), depths=(1,))),
            catalog, GenerationOptions(), lambda text: [], lambda toks: ""),
    }
    assert WhisperGenerator(cfg, {}).device.type == "cuda"
    assert KWSEngine().device.type == "cuda"
    assert EfficientKWSEngine(EfficientKWSConfig()).device.type == "cuda"
    # the CLI and the checkpoint loaders hand their device down to these
    for fn in (run_cli, load_whisper_from_pretrained, load_whisper_from_safetensors, load_hf_whisper,
               init_train_state, StepNoise, extract_hidden_states):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    for name, call in calls.items():
        if torch.cuda.is_available():
            call()
        else:
            with pytest.raises(AssertionError, match="CUDA"):
                call()
    # the CPU when the caller asks for it
    assert prepare_features(np.zeros(1600, np.float32), device="cpu")[0].device.type == "cpu"


def test_scale_out_entry_points_default_to_the_card():
    """The ranks of ``launch`` and the dry run sit on the card unless the
    caller passes ``device="cpu"``; without a card the dry run refuses."""
    from enhance_cb_whisper_tpu_torch.parallel import dryrun
    from enhance_cb_whisper_tpu_torch.parallel.mesh import launch

    assert inspect.signature(launch).parameters["device"].default == "cuda"
    assert inspect.signature(dryrun.main).parameters["device"].default == "cuda"
    assert dryrun._parse(["2"]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun.main(1)
