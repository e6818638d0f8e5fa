"""Whisper log-mel spectrogram front end (port of enhance_cb_whisper_tpu/ops/mel.py).

Exact Whisper semantics: n_fft=400, hop=160, periodic Hann window,
center=True with reflect padding, slaney-scale slaney-normalized mel
filters, ``log10(clip(, 1e-10))``, clamp to ``max - 8``, then
``(x + 4) / 4``.  Two details that decide parity (JAX ops/mel.py:100-151):

* T + 1 frames are framed and the LAST one is dropped;
* the per-audio global max is taken AFTER that drop.

:func:`log10_mel_plain` is the plain torch version of the fused kernel
(``ops/mel_cuda.py`` / ``csrc/mel.cu``): framing → windowed DFT (two
matmuls) → power → mel filterbank → log10.  :func:`log_mel_spectrogram`
routes through the kernel's wrapper, which takes the plain version only for
tensors on the CPU, and adds the dynamic-range epilogue in torch ops (as
the Pallas kernel left it to XLA, JAX ops/mel_pallas.py:132-135).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
N_SAMPLES = 30 * SAMPLE_RATE  # 480000: whisper's fixed 30 s window
N_FREQS = N_FFT // 2 + 1  # 201 real-DFT bins


def _hertz_to_mel(freq):
    """Slaney mel scale (linear below 1 kHz, log above)."""
    freq = np.asarray(freq, dtype=np.float64)
    min_log_hertz = 1000.0
    min_log_mel = 15.0
    logstep = 27.0 / np.log(6.4)
    mels = 3.0 * freq / 200.0
    return np.where(
        freq >= min_log_hertz,
        min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hertz) * logstep,
        mels,
    )


def _mel_to_hertz(mels):
    mels = np.asarray(mels, dtype=np.float64)
    min_log_hertz = 1000.0
    min_log_mel = 15.0
    logstep = np.log(6.4) / 27.0
    freq = 200.0 * mels / 3.0
    return np.where(
        mels >= min_log_mel,
        min_log_hertz * np.exp(logstep * (mels - min_log_mel)),
        freq,
    )


@lru_cache(maxsize=8)
def mel_filter_bank(n_mels: int = 80, n_freqs: int = N_FREQS,
                    sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """[n_freqs, n_mels] slaney-normalized triangular filters (a copy of the
    JAX package's numpy construction, identical to WhisperFeatureExtractor's)."""
    fft_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    mel_min = _hertz_to_mel(0.0)
    mel_max = _hertz_to_mel(sample_rate / 2.0)
    mel_freqs = _mel_to_hertz(np.linspace(mel_min, mel_max, n_mels + 2))

    fdiff = np.diff(mel_freqs)
    slopes = mel_freqs[None, :] - fft_freqs[:, None]
    down = -slopes[:, :-2] / fdiff[None, :-1]
    up = slopes[:, 2:] / fdiff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))

    enorm = 2.0 / (mel_freqs[2 : n_mels + 2] - mel_freqs[:n_mels])
    fb *= enorm[None, :]
    return fb.astype(np.float32)


@lru_cache(maxsize=2)
def dft_matrices(n_fft: int = N_FFT):
    """Windowed real-DFT matrices [n_fft, n_fft//2+1] (window folded in),
    built in float64 and rounded once to float32."""
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft))
    k = np.arange(n_fft // 2 + 1)
    n = np.arange(n_fft)
    angle = -2.0 * np.pi * np.outer(n, k) / n_fft
    cos_m = (np.cos(angle) * window[:, None]).astype(np.float32)
    sin_m = (np.sin(angle) * window[:, None]).astype(np.float32)
    return cos_m, sin_m


def log10_mel_plain(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """audio [B, n_samples] f32 → log10 mel [B, n_mels, n_samples // 160].

    The plain torch version of the fused kernel: the per-audio dynamic-range
    epilogue is NOT applied here (see :func:`apply_dynamic_range`)."""
    audio = audio.to(torch.float32)
    pad = N_FFT // 2
    padded = F.pad(audio[:, None, :], (pad, pad), mode="reflect")[:, 0]
    frames = padded.unfold(-1, N_FFT, HOP_LENGTH)  # [B, T + 1, n_fft]
    cos_m, sin_m = dft_matrices()
    cos_t = torch.as_tensor(cos_m, device=audio.device)
    sin_t = torch.as_tensor(sin_m, device=audio.device)
    re = frames @ cos_t
    im = frames @ sin_t
    power = (re * re + im * im)[:, :-1, :]  # whisper drops the final frame
    fb = torch.as_tensor(mel_filter_bank(n_mels), device=audio.device)
    mel = power @ fb  # [B, T, n_mels]
    return torch.log10(torch.clamp_min(mel, 1e-10)).transpose(-1, -2)


def apply_dynamic_range(log_spec: torch.Tensor) -> torch.Tensor:
    """Clamp at the per-audio max − 8, then ``(x + 4) / 4``."""
    max_val = torch.amax(log_spec, dim=(-2, -1), keepdim=True)
    log_spec = torch.maximum(log_spec, max_val - 8.0)
    return (log_spec + 4.0) / 4.0


def log_mel_spectrogram(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """audio [..., n_samples] (16 kHz float) → log-mel [..., n_mels, T].

    A CUDA tensor goes through the fused kernel (``n_samples`` must be a
    multiple of 160, which :func:`..audio.io.prepare_features` guarantees);
    a CPU tensor through :func:`log10_mel_plain`."""
    from .mel_cuda import log10_mel

    lead = audio.shape[:-1]
    flat = audio.reshape(-1, audio.shape[-1])
    log_spec = apply_dynamic_range(log10_mel(flat, n_mels))
    return log_spec.reshape(*lead, *log_spec.shape[-2:])
