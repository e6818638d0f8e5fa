"""Host-side audio IO and Whisper feature prep (port of
enhance_cb_whisper_tpu/audio/io.py).

* :func:`read_wav` decodes PCM WAV with the stdlib (mono mix-down);
* :func:`resample` runs the C++ polyphase resampler (``csrc/resample.cpp``,
  built with g++ at first use); :func:`load_audio_16k` is WAV decode plus
  resampling to 16 kHz;
* :func:`prepare_features` mirrors WhisperFeatureExtractor's padding and
  attention-mask semantics (pad/truncate to 30 s for shortform, pad to a
  hop multiple for longform) on top of the mel front end, which runs on
  ``device`` — the fused CUDA kernel on the card.

Unlike the JAX package, nothing falls back: a failed resampler build
raises (scipy's filter would give other samples), and a file that is not
PCM WAV raises (there is no ffmpeg decoder, as in the JAX package on a
machine without ffmpeg).
"""

from __future__ import annotations

import ctypes
import threading
import wave
from math import gcd
from typing import Dict, Tuple

import numpy as np
import torch

from ..build import NativeLibrary
from ..ops import mel_cuda
from ..ops.mel import HOP_LENGTH, N_SAMPLES, SAMPLE_RATE, log_mel_spectrogram
from ..runtime import profiler

_FLOAT_P = ctypes.POINTER(ctypes.c_float)
resampler = NativeLibrary("resample.cpp", "resample_poly",
                          [_FLOAT_P, ctypes.c_int64, _FLOAT_P, ctypes.c_int64, ctypes.c_int, ctypes.c_int],
                          host=True)
_streams: Dict[int, "torch.cuda.Stream"] = {}  # card index -> the features' stream
_streams_lock = threading.Lock()


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Returns (waveform [n_samples] float32 in [-1, 1] mono, sample_rate)."""
    with wave.open(path, "rb") as w:
        n_channels = w.getnchannels()
        width = w.getsampwidth()
        rate = w.getframerate()
        raw = w.readframes(w.getnframes())
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        ints = b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8) | (b[:, 2].astype(np.int32) << 16)
        ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
        data = ints.astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(f"unsupported WAV sample width: {width}")
    if n_channels > 1:
        data = data.reshape(-1, n_channels).mean(axis=1)
    return data, rate


def resample(waveform: np.ndarray, orig_sr: int, target_sr: int = SAMPLE_RATE) -> np.ndarray:
    """Polyphase windowed-sinc resampling from ``orig_sr`` to ``target_sr``:
    ``ceil(n * up / down)`` float32 samples."""
    if orig_sr == target_sr:
        return waveform.astype(np.float32)
    g = gcd(orig_sr, target_sr)
    up, down = target_sr // g, orig_sr // g
    x = np.ascontiguousarray(waveform, dtype=np.float32)
    out = np.empty((-(-x.size * up // down),), np.float32)
    ret = resampler.entry()(
        x.ctypes.data_as(_FLOAT_P), x.size, out.ctypes.data_as(_FLOAT_P), out.size, up, down)
    if ret != 0:
        raise RuntimeError(f"resample_poly failed on {x.size} samples ({orig_sr} -> {target_sr} Hz)")
    return out


def load_audio_16k(path: str) -> np.ndarray:
    """A PCM WAV file as 16 kHz mono float32."""
    if not path.lower().endswith(".wav"):
        raise RuntimeError(f"cannot decode {path}: the port reads PCM WAV only (no ffmpeg decoder)")
    try:
        wav, sr = read_wav(path)
    except (wave.Error, EOFError, ValueError) as err:
        raise RuntimeError(f"cannot decode {path}: not a PCM WAV file ({err})") from err
    return resample(wav, sr, SAMPLE_RATE)


def prepare_features(
    waveform: np.ndarray, n_mels: int = 80, device="cuda"
) -> Tuple[torch.Tensor, np.ndarray]:
    """(input_features [1, n_mels, T] on ``device``, frame attention mask
    [1, T]): <=30 s audio is padded/truncated to exactly 30 s; longer audio
    is padded to a hop multiple with the true-sample mask."""
    n = waveform.shape[-1]
    if n <= N_SAMPLES:
        padded = np.zeros((N_SAMPLES,), np.float32)
        padded[:n] = waveform[:N_SAMPLES]
        mask = np.zeros((N_SAMPLES,), np.int32)
        mask[: min(n, N_SAMPLES)] = 1
    else:
        target = ((n + HOP_LENGTH - 1) // HOP_LENGTH) * HOP_LENGTH
        padded = np.zeros((target,), np.float32)
        padded[:n] = waveform
        mask = np.zeros((target,), np.int32)
        mask[:n] = 1
    device = torch.device(device)
    caller = torch.cuda.current_stream(device) if device.type == "cuda" else None
    side = _features_stream(caller) if caller is not None else None
    # on a card the features run on their own stream (see _features_stream);
    # torch.cuda.stream(None) changes nothing
    with torch.cuda.stream(side), profiler.span(
            "ecw.audio.features", device=side is not None, n_mels=n_mels, samples=int(padded.size)) as span:
        launched = mel_cuda.kernel.launches
        features = log_mel_spectrogram(torch.from_numpy(padded[None]).to(device), n_mels=n_mels)
        if span is not None:  # None while recording is off
            span.attrs["launches"] = mel_cuda.kernel.launches - launched
    if side is not None:
        caller.wait_stream(side)
        features.record_stream(caller)
    frame_mask = mask[::HOP_LENGTH][: features.shape[-1]]
    return features, frame_mask[None]


def _features_stream(caller: "torch.cuda.Stream") -> "torch.cuda.Stream":
    """The features' own stream on the card of ``caller`` (one per card).

    On the caller's stream, which a serving worker thread shares, the
    features span's events would also time the decode work other threads
    queue in between, and the audio's copy would wait for it.  The caller's
    stream is ordered after the features (``wait_stream``), and their
    output is recorded on it, so the allocator keeps its memory until the
    work queued there when it is freed has run."""
    side = _streams.get(caller.device_index)
    if side is None:
        with _streams_lock:
            side = _streams.setdefault(caller.device_index, torch.cuda.Stream(caller.device))
    return side
