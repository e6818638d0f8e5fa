"""The port stands without JAX: every module of enhance_cb_whisper_tpu_torch
imports in a fresh interpreter with neither jax, flax nor the JAX package
(enhance_cb_whisper_tpu) loaded, and the mel kernel's wrapper takes its
plain version for CPU tensors without counting a launch."""

import os
import pkgutil
import subprocess
import sys

import numpy as np
import torch

import enhance_cb_whisper_tpu_torch
from enhance_cb_whisper_tpu_torch.ops import mel_cuda
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
