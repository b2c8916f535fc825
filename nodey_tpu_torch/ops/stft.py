"""STFT magnitude spectrogram (port of nodey_tpu.ops.stft).

Up to ``n_fft`` 4096 the real DFT of every frame is a GEMM against a
Hann-windowed stacked basis [n_fft, 2*bins] = [w*cos | w*-sin], built in
float64 and cast once to float32. When ``hop`` divides ``n_fft`` the frame
matrix is never built: the signal is viewed as hop-aligned segments and the
k = n_fft/hop row blocks of the basis are applied as k GEMMs summed. This
was an XLA einsum in the JAX package, not a Pallas kernel, so it is
``torch.matmul`` here, in full float32 (the package turns TF32 off on
import). Above 4096 the basis would grow as n_fft^2 (17.2 GB at 65,536), so
the frames are windowed and go through ``torch.fft.rfft`` in float32, the
JAX package's other branch (``jnp.fft.rfft``, also XLA's).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from nodey_tpu_torch.core.stream import Stream

# The largest n_fft taken by the GEMM; above it, rfft.
GEMM_MAX_N_FFT = 4096

@functools.lru_cache(maxsize=8)
def _dft_matrices(n_fft: int):
    """Real-DFT bases [n_fft, n_fft//2+1] (cos, -sin), unwindowed, built in
    float64 and cast to float32 (the phase vocoder's analysis bases)."""
    k = np.arange(n_fft)[:, None] * np.arange(n_fft // 2 + 1)[None, :]
    ang = 2.0 * np.pi * k / n_fft
    return (
        np.cos(ang).astype(np.float32),
        (-np.sin(ang)).astype(np.float32),
    )


@functools.lru_cache(maxsize=8)
def _windowed_stacked_basis(n_fft: int) -> np.ndarray:
    w = np.hanning(n_fft)
    k = np.arange(n_fft)[:, None] * np.arange(n_fft // 2 + 1)[None, :]
    ang = 2.0 * np.pi * k / n_fft
    return np.concatenate(
        [np.cos(ang) * w[:, None], -np.sin(ang) * w[:, None]], axis=1
    ).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _device_basis(n_fft: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_windowed_stacked_basis(n_fft)).to(device)


@functools.lru_cache(maxsize=8)
def _device_window(n_fft: int, device: torch.device) -> torch.Tensor:
    """The rfft branch's float32 Hann window (``np.hanning``, as the JAX
    package's)."""
    return torch.from_numpy(np.hanning(n_fft).astype(np.float32)).to(device)


def device_constants(n_fft: int, device: torch.device) -> None:
    """Put the branch's constant for ``n_fft`` (the DFT basis, or the rfft
    window) on ``device`` ahead of the first frame."""
    if n_fft > GEMM_MAX_N_FFT:
        _device_window(n_fft, device)
    else:
        _device_basis(n_fft, device)


def magnitude_spectrogram(stream: Stream, n_fft: int = 1024,
                          hop: int = 512) -> torch.Tensor:
    """``[channels, frames, n_fft//2 + 1]`` float32 magnitudes.

    The frame count comes from the padded capacity, not the valid length,
    as in the JAX package, so both produce the same shape; frames past the
    valid length hold window-of-padding values."""
    data = stream.data
    C, N = data.shape
    num_frames = max(0, (N - n_fft) // hop + 1)
    bins = n_fft // 2 + 1
    if num_frames == 0:
        return data.new_zeros((C, 0, bins))
    if n_fft > GEMM_MAX_N_FFT:
        frames = data.unfold(-1, n_fft, hop)  # [C, num_frames, n_fft] view
        window = _device_window(n_fft, data.device)
        return torch.fft.rfft(frames * window, dim=-1).abs()
    basis = _device_basis(n_fft, data.device)
    if n_fft % hop == 0:
        # frame f = concat(segs[f + i] for i < k), so the windowed DFT of
        # every frame is sum_i segs[:, i : i+F] @ basis[i*hop:(i+1)*hop].
        k = n_fft // hop
        segs_needed = num_frames - 1 + k
        pad = segs_needed * hop - N
        x = F.pad(data, (0, pad)) if pad > 0 else data
        segs = x[:, : segs_needed * hop].reshape(C, segs_needed, hop)
        y = None
        for i in range(k):
            t = torch.matmul(segs[:, i : i + num_frames],
                             basis[i * hop : (i + 1) * hop])
            y = t if y is None else y + t
    else:
        idx = (torch.arange(num_frames, device=data.device)[:, None] * hop
               + torch.arange(n_fft, device=data.device)[None, :])
        y = torch.matmul(data[:, idx], basis)
    re, im = y[..., :bins], y[..., bins:]
    return torch.sqrt(re * re + im * im)
