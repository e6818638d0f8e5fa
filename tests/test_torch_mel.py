"""Port mel front end vs the JAX package: the plain torch mel against
``log_mel_spectrogram`` and the Pallas kernel (interpret mode), and
``prepare_features`` end to end.  Tolerance rtol 1e-4 / atol 1e-5, the one
the JAX package holds its Pallas kernel to (tests/test_mel_pallas.py);
sums run in another order than XLA's, so bitwise equality is not expected.

The CUDA kernel itself runs only on the card: ``chip_smoke.py`` compares
it with the plain version there."""

import wave

import numpy as np
import pytest
import torch

from enhance_cb_whisper_tpu.audio.io import prepare_features as jax_prepare_features
from enhance_cb_whisper_tpu.audio.io import read_wav as jax_read_wav
from enhance_cb_whisper_tpu.ops.mel import log_mel_spectrogram as jax_log_mel
from enhance_cb_whisper_tpu.ops.mel_pallas import log_mel_spectrogram_pallas
from enhance_cb_whisper_tpu_torch.audio.io import prepare_features, read_wav
from enhance_cb_whisper_tpu_torch.ops.mel import N_SAMPLES, log_mel_spectrogram

RTOL, ATOL = 1e-4, 1e-5


def _audio(n_samples: int, seed: int = 0) -> np.ndarray:
    """Two utterances of noise at different levels, zero-padded tails (the
    padded-silence layout prepare_features produces)."""
    rng = np.random.default_rng(seed)
    audio = np.zeros((2, n_samples), np.float32)
    audio[0, : 16000 * 3] = rng.standard_normal(16000 * 3) * 0.1
    audio[1, : 16000 * 7] = rng.standard_normal(16000 * 7) * 0.05
    return audio


@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("n_samples", [N_SAMPLES, 592000], ids=["30s", "37s"])
def test_plain_mel_matches_jax(n_mels, n_samples):
    audio = _audio(n_samples)
    want = np.asarray(jax_log_mel(audio, n_mels=n_mels))
    got = log_mel_spectrogram(torch.from_numpy(audio), n_mels=n_mels).numpy()
    assert got.shape == want.shape == (2, n_mels, n_samples // 160)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_plain_mel_matches_pallas_kernel(n_mels):
    audio = _audio(N_SAMPLES, seed=1)
    want = np.asarray(log_mel_spectrogram_pallas(audio, n_mels=n_mels, interpret=True))
    got = log_mel_spectrogram(torch.from_numpy(audio), n_mels=n_mels).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seconds", [5.5, 37.0])
def test_prepare_features_matches_jax(seconds):
    rng = np.random.default_rng(2)
    wav = (rng.standard_normal(int(16000 * seconds)) * 0.1).astype(np.float32)
    want, want_mask = jax_prepare_features(wav, n_mels=80)
    got, got_mask = prepare_features(wav, n_mels=80, device="cpu")
    assert isinstance(got, torch.Tensor) and got.shape == want.shape
    np.testing.assert_array_equal(got_mask, want_mask)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("width,channels", [(2, 1), (2, 2), (3, 1), (4, 2)])
def test_read_wav_matches_jax(tmp_path, width, channels):
    rng = np.random.default_rng(4)
    path = str(tmp_path / "a.wav")
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(16000)
        w.writeframes(rng.integers(0, 256, 1600 * width * channels, dtype=np.uint8).tobytes())
    got, got_sr = read_wav(path)
    want, want_sr = jax_read_wav(path)
    assert got_sr == want_sr == 16000 and got.shape == (1600,)
    np.testing.assert_array_equal(got, want)
