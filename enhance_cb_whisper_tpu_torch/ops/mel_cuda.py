"""Wrapper of the fused mel kernel ``csrc/mel.cu`` (kernel K1 of the port).

Replaces ``enhance_cb_whisper_tpu/ops/mel_pallas.py:_mel_kernel`` (launched
by ``log_mel_spectrogram_pallas``).  On the H100 it is bound by FP32 FMA
throughput: ~1 GFLOP of windowed DFT per 30 s of audio, in plain FP32 to
match the JAX kernel's ``Precision.HIGHEST``.  The DFT is fused with the mel
filterbank and log10, so the power spectrogram never leaves the SM.  Unlike
the Pallas kernel (exactly 30 s windows) it takes any ``[B, N]`` with
``N % 160 == 0``, so every mel computed on the card goes through it.

The library is compiled from the repository's sources with ``nvcc`` at
first use (:mod:`..build`) and bound with :mod:`ctypes`.  A tensor on the
CPU takes the plain torch version (:func:`.mel.log10_mel_plain`); a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from .mel import HOP_LENGTH, N_FFT, N_FREQS, dft_matrices, log10_mel_plain, mel_filter_bank

# kernel launches since import (or since a caller reset it to 0); the
# launch path below is the only place that increments it
launches = 0

_lib = None
_tables: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}


def _library():
    global _lib
    if _lib is None:
        from ..build import build_library

        lib = ctypes.CDLL(str(build_library("mel.cu")))
        lib.ecw_log10_mel.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.ecw_log10_mel.restype = ctypes.c_int
        lib.ecw_log10_mel_table_cols.argtypes = []
        lib.ecw_log10_mel_table_cols.restype = ctypes.c_int
        _lib = lib
    return _lib


def build() -> None:
    """Compile and load the kernel library now (otherwise: at first launch)."""
    _library()


def _device_tables(device: torch.device, n_mels: int):
    """Windowed DFT tables padded to the kernel's row stride, and the
    filterbank, resident on ``device`` (built once per device and n_mels)."""
    key = (device.index, n_mels)
    if key not in _tables:
        cols = _library().ecw_log10_mel_table_cols()
        cos_m, sin_m = dft_matrices()
        cos_p = np.zeros((N_FFT, cols), np.float32)
        sin_p = np.zeros((N_FFT, cols), np.float32)
        cos_p[:, :N_FREQS] = cos_m
        sin_p[:, :N_FREQS] = sin_m
        _tables[key] = (
            torch.from_numpy(cos_p).to(device),
            torch.from_numpy(sin_p).to(device),
            torch.from_numpy(np.ascontiguousarray(mel_filter_bank(n_mels))).to(device),
        )
    return _tables[key]


def log10_mel(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """audio [B, N] f32 → log10 mel [B, n_mels, N // 160] (no epilogue)."""
    global launches
    if audio.device.type == "cpu":
        return log10_mel_plain(audio, n_mels)
    if audio.device.type != "cuda":
        raise ValueError(f"log10_mel: unsupported device {audio.device}")
    if audio.dtype != torch.float32:
        raise TypeError(f"log10_mel: expected float32 audio, got {audio.dtype}")
    if audio.ndim != 2:
        raise ValueError(f"log10_mel: expected [B, N] audio, got shape {tuple(audio.shape)}")
    batch, n_samples = audio.shape
    if n_samples % HOP_LENGTH != 0 or n_samples <= N_FFT // 2:
        raise ValueError(
            f"log10_mel: N={n_samples} must be a multiple of {HOP_LENGTH} "
            f"and exceed {N_FFT // 2} (reflect padding)"
        )
    if not audio.is_contiguous():
        raise ValueError("log10_mel: audio must be contiguous")
    cos_t, sin_t, fb = _device_tables(audio.device, n_mels)
    out = torch.empty((batch, n_mels, n_samples // HOP_LENGTH),
                      dtype=torch.float32, device=audio.device)
    with torch.cuda.device(audio.device):
        stream = torch.cuda.current_stream(audio.device).cuda_stream
        err = _library().ecw_log10_mel(
            audio.data_ptr(), out.data_ptr(), cos_t.data_ptr(), sin_t.data_ptr(),
            fb.data_ptr(), batch, n_samples, n_mels, stream,
        )
    if err != 0:
        raise RuntimeError(f"mel kernel launch failed: CUDA error {err}")
    launches += 1
    return out
