"""The port's magnitude spectrogram against the JAX package's and against
the NumPy rfft reference (SNR >= 100 dB: PARITY.md's bar for the
spectrum; full float32 GEMMs give ~130 dB, TF32 would give ~55 dB)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nodey_tpu_torch  # noqa: F401  (sets the TF32 flags)
from nodey_tpu.core.stream import Stream as JStream
from nodey_tpu.ops import stft as jstft
from nodey_tpu_torch.core.stream import Stream
from nodey_tpu_torch.ops import stft as tstft

from conftest import snr_db


def test_tf32_is_off_after_import():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("n_fft,hop", [(1024, 512), (512, 128), (256, 96)])
def test_spectrogram_matches_jax_and_reference(n_fft, hop):
    rng = np.random.default_rng(2)
    n, capacity = 9000, 10_240
    data = np.zeros((2, capacity), np.float32)
    t = np.arange(n) / 48_000.0
    data[0, :n] = 0.5 * np.sin(2 * np.pi * 1000.0 * t)
    data[1, :n] = 0.3 * rng.standard_normal(n)
    got = tstft.magnitude_spectrogram(
        Stream(data=torch.from_numpy(data), length=n, rate=48_000,
               channels=2),
        n_fft=n_fft, hop=hop,
    ).numpy()
    want = np.asarray(jstft.magnitude_spectrogram(
        JStream(data=jnp.asarray(data), length=n, rate=48_000, channels=2),
        n_fft=n_fft, hop=hop,
    ))
    ref = jstft.magnitude_spectrogram_reference(data, n_fft=n_fft, hop=hop)
    # The frame count follows the padded capacity, as in the JAX package.
    frames = (capacity - n_fft) // hop + 1
    assert got.shape == want.shape == ref.shape == (2, frames, n_fft // 2 + 1)
    assert got.dtype == np.float32
    assert snr_db(want, got) >= 100.0
    assert snr_db(ref, got) >= 100.0


def test_spectrogram_shorter_than_one_frame_is_empty():
    x = torch.zeros((2, 100))
    out = tstft.magnitude_spectrogram(
        Stream(data=x, length=100, rate=48_000, channels=2)
    )
    assert tuple(out.shape) == (2, 0, 513)


def _no_basis(n_fft, device):
    raise AssertionError("the rfft branch built the DFT basis")


@pytest.mark.parametrize("hop", [2048, 3000])
def test_large_n_fft_takes_rfft_and_matches_jax(monkeypatch, hop):
    """Above n_fft 4096 the port windows the frames and takes rfft, as the
    JAX package does (nodey_tpu/ops/stft.py:142-146), and builds no basis:
    >= 100 dB against the JAX op and against float64, on ~1 s of stereo at
    n_fft 8,192 (hop dividing n_fft or not)."""
    monkeypatch.setattr(tstft, "_device_basis", _no_basis)
    rng = np.random.default_rng(5)
    n, n_fft = 48_000, 8192
    t = np.arange(n) / 48_000.0
    data = np.stack([0.5 * np.sin(2 * np.pi * 1000.0 * t),
                     0.3 * rng.standard_normal(n)]).astype(np.float32)
    got = tstft.magnitude_spectrogram(
        Stream(data=torch.from_numpy(data), length=n, rate=48_000,
               channels=2), n_fft=n_fft, hop=hop).numpy()
    want = np.asarray(jstft.magnitude_spectrogram(
        JStream(data=jnp.asarray(data), length=n, rate=48_000, channels=2),
        n_fft=n_fft, hop=hop))
    frames = (n - n_fft) // hop + 1
    windowed = (np.lib.stride_tricks.sliding_window_view(
        data.astype(np.float64), n_fft, axis=-1)[:, ::hop][:, :frames]
        * np.hanning(n_fft))
    ref = np.abs(np.fft.rfft(windowed, axis=-1))
    assert got.shape == want.shape == ref.shape == (2, frames, n_fft // 2 + 1)
    assert got.dtype == np.float32
    assert snr_db(want, got) >= 100.0
    assert snr_db(ref, got) >= 100.0
