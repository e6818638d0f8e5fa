"""Wrapper of the fused mel kernel ``csrc/mel.cu`` (kernel K1 of the port).

Replaces ``enhance_cb_whisper_tpu/ops/mel_pallas.py:_mel_kernel`` (launched
by ``log_mel_spectrogram_pallas``).  The kernel frames, windows and
transforms the audio with a 20 × 20 factored real DFT in plain FP32 (the
JAX kernel's ``Precision.HIGHEST``), then applies the mel filterbank and
log10, so the power spectrogram never leaves the SM.  Its twiddle, window
and sparse filterbank tables are built here (:func:`dft_tables`,
:func:`sparse_filterbank`), kept on the card per device and ``n_mels``, and
staged in shared memory by every block.  Unlike the Pallas kernel (exactly
30 s windows) it takes any ``[B, N]`` with ``N % 160 == 0``, so every mel
computed on the card goes through it.

A tensor on the CPU takes the plain torch version
(:func:`.mel.log10_mel_plain`); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import threading
from ctypes import c_int, c_void_p
from typing import Dict, Tuple

import numpy as np
import torch

from ..build import NativeLibrary
from .mel import HOP_LENGTH, N_FFT, log10_mel_plain, mel_filter_bank

kernel = NativeLibrary("mel.cu", "ecw_log10_mel", [c_void_p] * 5 + [c_int] * 4 + [c_void_p])

_tables: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}
# K1 runs from more than one thread (``run_test``'s prefetch thread computes
# the mel while the caller's thread decodes)
_tables_lock = threading.Lock()


def dft_tables() -> np.ndarray:
    """[3, 400] float64: cos(2πj/400), sin(2πj/400) and the periodic Hann
    window w[j].  Every twiddle of the kernel's 20 × 20 factored DFT is
    ``cos - i·sin`` at ``(a·b) mod 400``; the kernel gets them rounded once
    to float32."""
    angle = 2.0 * np.pi * np.arange(N_FFT) / N_FFT
    return np.stack([np.cos(angle), np.sin(angle), 0.5 * (1.0 - np.cos(angle))])


def sparse_filterbank(n_mels: int) -> Tuple[np.ndarray, np.ndarray]:
    """``mel_filter_bank(n_mels)`` as the kernel reads it: the weights of
    each mel's contiguous run of bins, packed in mel order and ascending bin
    order (f32), and int32 ``[first bin of each mel | offset of each mel's
    run in the packed weights, then the total]`` (``2 * n_mels + 1``)."""
    fb = mel_filter_bank(n_mels)
    first, offsets, runs = [], [0], []
    for m in range(n_mels):
        bins = np.flatnonzero(fb[:, m])
        lo, hi = (int(bins[0]), int(bins[-1]) + 1) if bins.size else (0, 0)
        first.append(lo)
        offsets.append(offsets[-1] + hi - lo)
        runs.append(fb[lo:hi, m])
    return np.concatenate(runs).astype(np.float32), np.asarray(first + offsets, np.int32)


def _device_tables(device: torch.device, n_mels: int):
    """The twiddle and window tables and the sparse filterbank, resident on
    ``device`` (built once per device and n_mels)."""
    fb_w, fb_meta = sparse_filterbank(n_mels)
    tables = tuple(torch.from_numpy(t).to(device)
                   for t in (dft_tables().astype(np.float32), fb_w, fb_meta))
    with _tables_lock:
        return _tables.setdefault((device.index, n_mels), tables)


def _diagnose(audio: torch.Tensor) -> None:
    """Raises the error that names what the kernel cannot take."""
    if audio.device.type != "cuda":
        raise ValueError(f"log10_mel: unsupported device {audio.device}")
    if audio.dtype != torch.float32:
        raise TypeError(f"log10_mel: expected float32 audio, got {audio.dtype}")
    if audio.ndim != 2:
        raise ValueError(f"log10_mel: expected [B, N] audio, got shape {tuple(audio.shape)}")
    n_samples = audio.shape[1]
    if n_samples % HOP_LENGTH != 0 or n_samples <= N_FFT // 2:
        raise ValueError(
            f"log10_mel: N={n_samples} must be a multiple of {HOP_LENGTH} "
            f"and exceed {N_FFT // 2} (reflect padding)"
        )
    if not audio.is_contiguous():
        raise ValueError("log10_mel: audio must be contiguous")
    raise AssertionError("log10_mel: audio rejected without a reason")


def log10_mel(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """audio [B, N] f32 → log10 mel [B, n_mels, N // 160] (no epilogue)."""
    dev = audio.device
    if dev.type == "cpu":
        return log10_mel_plain(audio, n_mels)
    # one pass over the conditions; _diagnose names the one that fails
    if not (dev.type == "cuda" and audio.dtype is torch.float32 and audio.ndim == 2
            and audio.shape[1] % HOP_LENGTH == 0 and audio.shape[1] > N_FFT // 2
            and audio.is_contiguous()):
        _diagnose(audio)
    batch, n_samples = audio.shape
    tw, fb_w, fb_meta = _tables.get((dev.index, n_mels)) or _device_tables(dev, n_mels)
    out = torch.empty((batch, n_mels, n_samples // HOP_LENGTH), dtype=torch.float32, device=dev)
    # on the caller's current stream: a thread that sets no stream of its own
    # launches on the legacy default stream, the one the decode runs on, so
    # a mel made there is ordered before the work that reads it; keep it
    # that way (``prepare_features`` runs K1 on its own stream and orders the
    # caller's stream after it)
    kernel.launch(dev, audio.data_ptr(), out.data_ptr(), tw.data_ptr(), fb_w.data_ptr(), fb_meta.data_ptr(),
                  batch, n_samples, n_mels, fb_w.numel())
    return out
