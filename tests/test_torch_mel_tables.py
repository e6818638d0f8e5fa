"""The tables that K1's wrapper builds (``ops/mel_cuda.py``) and the
algorithm of the kernel (``csrc/mel.cu``), checked on the CPU in numpy: the
sparse filterbank reconstructs ``mel_filter_bank`` exactly, and the
20 × 20 factored real DFT over the wrapper's own twiddle and window tables
gives the windowed real DFT of ``dft_matrices()``.  The kernel itself runs
only on the card, where ``chip_smoke.py`` holds it against the plain
version."""

import numpy as np
import pytest
import torch

from enhance_cb_whisper_tpu_torch.ops.mel import (
    HOP_LENGTH,
    N_FFT,
    N_FREQS,
    dft_matrices,
    log10_mel_plain,
    mel_filter_bank,
)
from enhance_cb_whisper_tpu_torch.ops.mel_cuda import dft_tables, sparse_filterbank

RADIX = 20  # 400 = 20 x 20


def factored_rdft(frames: np.ndarray, tables: np.ndarray) -> np.ndarray:
    """The kernel's transform in numpy, in the tables' dtype: frames
    [F, 400] → X [F, 201].  Stage 1, a real 20-point DFT over n1 of
    x·w[20 n1 + n2], keeps bins k1 = 0..10 and takes 11..19 as their
    conjugates; stage 2 applies W400^(n2 k1) and a 20-point DFT over n2.
    Every twiddle is ``cos - i sin`` of the tables at (a b) mod 400."""
    cdtype = np.complex64 if tables.dtype == np.float32 else np.complex128
    cos_t, sin_t, window = tables
    n = np.arange(RADIX)
    j20 = RADIX * (np.outer(n, n) % RADIX)
    w20 = (cos_t[j20] - 1j * sin_t[j20]).astype(cdtype)  # W20^(a b)
    j400 = np.outer(n, n)  # n2 k1 <= 361
    w400 = (cos_t[j400] - 1j * sin_t[j400]).astype(cdtype)  # W400^(n2 k1)
    xw = (frames.astype(tables.dtype) * window).reshape(len(frames), RADIX, RADIX)  # [F, n1, n2]
    y = np.einsum("fan,ak->fnk", xw.astype(cdtype), w20[:, : RADIX // 2 + 1])
    y = np.concatenate([y, np.conj(y[:, :, RADIX // 2 - 1 : 0 : -1])], axis=2)  # [F, n2, k1]
    x = np.einsum("fnk,nq->fqk", y * w400, w20)  # [F, k2, k1]
    return x.reshape(len(frames), N_FFT)[:, :N_FREQS]  # k = 20 k2 + k1


def _direct_dft64(frames: np.ndarray) -> np.ndarray:
    """The windowed real DFT as ``dft_matrices`` builds it, kept in float64."""
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(N_FFT) / N_FFT))
    angle = -2.0 * np.pi * np.outer(np.arange(N_FFT), np.arange(N_FREQS)) / N_FFT
    cos_m, sin_m = np.cos(angle) * window[:, None], np.sin(angle) * window[:, None]
    want_cos, want_sin = dft_matrices()
    assert np.array_equal(cos_m.astype(np.float32), want_cos)
    assert np.array_equal(sin_m.astype(np.float32), want_sin)
    return frames.astype(np.float64) @ cos_m + 1j * (frames.astype(np.float64) @ sin_m)


def _frames() -> np.ndarray:
    """Random frames at several levels, a tone, and a loud frame next to a
    near-silent one."""
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((6, N_FFT)) * np.array([1.0, 0.1, 1e-3, 1e-6, 1.0, 1e-7])[:, None]
    frames[4] += np.sin(2 * np.pi * 37.5 * np.arange(N_FFT) / N_FFT)
    return frames


@pytest.mark.parametrize("n_mels,n_taps,widest", [(80, 391, 14), (128, 394, 9)])
def test_sparse_filterbank_rebuilds_the_dense_one(n_mels, n_taps, widest):
    weights, meta = sparse_filterbank(n_mels)
    first, offsets = meta[:n_mels], meta[n_mels:]
    assert weights.dtype == np.float32 and meta.dtype == np.int32
    assert weights.shape == (n_taps,) and offsets[0] == 0 and offsets[-1] == n_taps
    runs = np.diff(offsets)
    assert runs.min() >= 1 and runs.max() == widest
    # each mel's taps are one contiguous run of nonzero weights
    assert np.all(weights != 0)
    dense = np.zeros((N_FREQS, n_mels), np.float32)
    for m in range(n_mels):
        dense[first[m] : first[m] + runs[m], m] = weights[offsets[m] : offsets[m + 1]]
    np.testing.assert_array_equal(dense, mel_filter_bank(n_mels))


def test_dft_tables_hold_every_twiddle_and_the_window():
    tables = dft_tables()
    assert tables.shape == (3, N_FFT) and tables.dtype == np.float64
    j = np.arange(N_FFT)
    np.testing.assert_allclose(tables[0] - 1j * tables[1], np.exp(-2j * np.pi * j / N_FFT),
                               rtol=0, atol=1e-15)
    np.testing.assert_allclose(tables[2], np.hanning(N_FFT + 1)[:-1], rtol=0, atol=1e-15)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 1e-5)])
def test_factored_dft_is_the_windowed_real_dft(dtype, tol):
    frames = _frames()
    got = factored_rdft(frames, dft_tables().astype(dtype))
    want = _direct_dft64(frames)
    assert got.shape == want.shape == (len(frames), N_FREQS)
    # each frame against its own L1 norm: a quiet frame keeps its own accuracy
    scale = np.abs(frames * dft_tables()[2]).sum(axis=1, keepdims=True)
    err = np.abs(got - want) / scale
    assert err.max() <= tol, err.max(axis=1)


@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("n_samples", [480, 4960])
def test_factored_dft_and_sparse_filterbank_give_the_plain_log_mel(n_mels, n_samples):
    """The kernel's whole algorithm in float32 numpy — reflect padding,
    factored DFT, power, sparse filterbank in ascending bin order, log10 —
    against the plain torch version at the chip's tolerance."""
    rng = np.random.default_rng(n_samples + n_mels)
    audio = (rng.standard_normal((2, n_samples)) * np.array([[0.1], [1e-4]])).astype(np.float32)
    padded = np.pad(audio, ((0, 0), (N_FFT // 2, N_FFT // 2)), mode="reflect")
    n_frames = n_samples // HOP_LENGTH
    starts = HOP_LENGTH * np.arange(n_frames)
    frames = padded[:, starts[:, None] + np.arange(N_FFT)].reshape(-1, N_FFT)
    spec = factored_rdft(frames, dft_tables().astype(np.float32))
    power = (spec.real * spec.real + spec.imag * spec.imag).astype(np.float32)
    weights, meta = sparse_filterbank(n_mels)
    mel = np.zeros((len(frames), n_mels), np.float32)
    for m in range(n_mels):
        lo, off, hi = meta[m], meta[n_mels + m], meta[n_mels + m + 1]
        for j in range(off, hi):
            mel[:, m] += power[:, lo + j - off] * weights[j]
    got = np.log10(np.maximum(mel, 1e-10)).reshape(2, n_frames, n_mels).transpose(0, 2, 1)
    want = log10_mel_plain(torch.from_numpy(audio), n_mels).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
