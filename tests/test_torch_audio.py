"""The port's audio front end vs the JAX package: the C++ polyphase
resampler (the port's own copy of the source, built with the same g++
flags) gives the JAX package's native samples exactly, and WAV files load
the same; what the port cannot decode, or a resampler that does not build,
raises instead of falling back."""

import wave

import numpy as np
import pytest

from enhance_cb_whisper_tpu.audio import io as jax_io
from enhance_cb_whisper_tpu.audio.native import resample_poly_native
from enhance_cb_whisper_tpu_torch import build
from enhance_cb_whisper_tpu_torch.audio import io


def _tone(rate, seconds, freq=440.0):
    t = np.arange(int(rate * seconds)) / rate
    return (0.5 * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def _write_wav(path, data, rate):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((np.clip(data, -1, 1) * 32767).astype("<i2").tobytes())


@pytest.mark.parametrize("rate", [44100, 22050, 48000, 8000])
def test_resample_matches_jax_native(rate):
    x = _tone(rate, 1.3) + np.random.default_rng(rate).standard_normal(int(rate * 1.3)).astype(np.float32) * 0.01
    got = io.resample(x, rate)
    native = resample_poly_native(x, rate, 16000)
    np.testing.assert_array_equal(got, native)  # atol 0: the same source and flags
    np.testing.assert_allclose(got, jax_io.resample(x, rate), rtol=0, atol=0)
    assert got.dtype == np.float32 and got.shape == (-(-x.size * 16000 // rate),)


def test_load_audio_16k_matches_jax(tmp_path):
    path = tmp_path / "tone.wav"
    _write_wav(path, _tone(44100, 2.0), 44100)
    got = io.load_audio_16k(str(path))
    np.testing.assert_array_equal(got, jax_io.load_audio_16k(str(path)))
    assert got.shape == (32000,)
    same_rate = tmp_path / "16k.wav"
    _write_wav(same_rate, _tone(16000, 0.5), 16000)
    np.testing.assert_array_equal(io.load_audio_16k(str(same_rate)), jax_io.load_audio_16k(str(same_rate)))


def test_undecodable_input_raises(tmp_path):
    mp3 = tmp_path / "a.mp3"
    mp3.write_bytes(b"\xff\xfb" + bytes(100))
    with pytest.raises(RuntimeError, match="PCM WAV only"):
        io.load_audio_16k(str(mp3))
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFF" + bytes(40))
    with pytest.raises(RuntimeError, match="not a PCM WAV"):
        io.load_audio_16k(str(bad))


def test_failed_resampler_build_raises(monkeypatch):
    """No silent fallback to scipy, whose filter gives other samples."""
    monkeypatch.setattr(build, "HOST_FLAGS", (*build.HOST_FLAGS, "-fno-such-option-exists"))
    monkeypatch.setattr(io.resampler, "_entry", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on resample.cpp"):
        io.resample(_tone(44100, 0.1), 44100)
