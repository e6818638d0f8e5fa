"""Whisper's log-mel features, written out plainly.

n_fft 400, hop 160, periodic Hann window, reflect padding of 200 samples,
power spectrum by a real DFT (two products with cosine and sine tables),
Slaney mel filters (80), ``log10(max(., 1e-10))``, the last frame dropped,
then the clamp at the utterance's maximum minus 8 and ``(x + 4) / 4``:
what ``WhisperFeatureExtractor`` computes.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from .precision import Prec

N_FFT, HOP, RATE = 400, 160, 16000


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = 3.0 * f / 200.0
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) * 27.0 / np.log(6.4), lin)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)), 200.0 * m / 3.0)


@lru_cache(maxsize=4)
def mel_filters(n_mels: int) -> np.ndarray:
    """[201, n_mels] Slaney-normalized triangles."""
    freqs = np.linspace(0, RATE // 2, N_FFT // 2 + 1)
    edges = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(RATE / 2.0), n_mels + 2))
    lower = (freqs[:, None] - edges[None, :-2]) / (edges[1:-1] - edges[:-2])[None, :]
    upper = (edges[None, 2:] - freqs[:, None]) / (edges[2:] - edges[1:-1])[None, :]
    fb = np.maximum(0.0, np.minimum(lower, upper))
    return fb * (2.0 / (edges[2:] - edges[:-2]))[None, :]


@lru_cache(maxsize=2)
def dft_tables():
    n = np.arange(N_FFT)
    k = np.arange(N_FFT // 2 + 1)
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / N_FFT)
    angle = 2.0 * np.pi * np.outer(n, k) / N_FFT
    return np.cos(angle) * window[:, None], -np.sin(angle) * window[:, None]


def log_mel(audio: torch.Tensor, n_mels: int, prec: Prec) -> torch.Tensor:
    """audio [N] (16 kHz, N a multiple of 160) → [n_mels, N // 160]."""
    x = F.pad(audio.to(torch.float32)[None, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[0, 0]
    frames = x.unfold(0, N_FFT, HOP)[:-1]  # [T, 400], the last frame dropped
    cos_t, sin_t = (torch.as_tensor(t, dtype=torch.float32, device=audio.device) for t in dft_tables())
    re, im = prec.matmul(frames, cos_t), prec.matmul(frames, sin_t)
    fb = torch.as_tensor(mel_filters(n_mels), dtype=torch.float32, device=audio.device)
    mel = prec.matmul(re * re + im * im, fb)  # [T, n_mels]
    log_spec = torch.log10(torch.clamp_min(mel, 1e-10)).t()
    log_spec = torch.maximum(log_spec, log_spec.max() - 8.0)
    return (log_spec + 4.0) / 4.0
