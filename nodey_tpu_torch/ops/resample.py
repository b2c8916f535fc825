"""Rational polyphase resampling (port of nodey_tpu.ops.resample).

For a reduced rate change L/M, output group g (L outputs) reads one input
window of width W = M + taps - 1 against an embedded [L, W] filter bank:

    y[c, g*L + p] = sum_w  x[c, g*M + w] * bank[p, w]

The bank is the same Kaiser-windowed sinc as the JAX package's, designed
on the host in float64 and cast once to float32, so both packages hold the
same numbers; it is cached on the device per (L, M, taps).

Dispatch (``apply_filter_bank``): a CUDA tensor goes to the hand-written
kernel in :mod:`nodey_tpu_torch.ops.cuda_resample` for every rate pair,
R > 1 and R == 1 alike; a CPU tensor takes the plain PyTorch versions
below, ported from the JAX package's XLA branches. There is no fallback
from one to the other.

Not ported yet: the relay-era formulation switch (``resolve_form``,
``form_override``, the ``transposed`` form), ``compat="swr"`` banks and
``to_rate_and_stereo_many``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from nodey_tpu_torch.core.errors import ProcessorRuntimeError
from nodey_tpu_torch.core.stream import FMT_FLT, Stream

# libswresample default rematrix gain (-3 dB mono upmix).
SQRT1_2 = 0.7071067811865476

# Filter quality point (libswresample's defaults; see the JAX module). The
# JAX package exposes taps/beta/cutoff as arguments; nothing calls it with
# other values, so here they are constants.
DEFAULT_TAPS = 32
DEFAULT_BETA = 9.0
DEFAULT_CUTOFF = 0.97
MAX_PHASES = 8192


@functools.lru_cache(maxsize=64)
def _design_filter_bank(
    L: int, M: int, taps: int, beta: float, cutoff: float
) -> np.ndarray:
    """The [L, W] embedded polyphase bank (float64 design -> float32).

    Phase p reads window positions [o_p, o_p + taps), o_p = floor(p*M/L);
    each phase is normalized to unit DC gain. Callers pass taps through
    ``_effective_taps`` already. Same arithmetic as the JAX package, so the
    two banks are bitwise equal."""
    W = M + taps - 1
    bank = np.zeros((L, W), dtype=np.float64)
    fc = 0.5 * min(1.0, L / M) * cutoff
    half = taps / 2.0
    for p in range(L):
        t = p * M / L
        o = math.floor(t)
        d = t - o
        i = np.arange(taps, dtype=np.float64)
        arg = d + half - 1.0 - i
        h = 2.0 * fc * np.sinc(2.0 * fc * arg)
        x = np.clip(arg / half, -1.0, 1.0)
        w = np.i0(beta * np.sqrt(1.0 - x * x)) / np.i0(beta)
        h = h * w
        h /= h.sum()
        bank[p, o : o + taps] = h
    return bank.astype(np.float32)


def _rational(in_rate: int, out_rate: int):
    g = math.gcd(in_rate, out_rate)
    return out_rate // g, in_rate // g  # L, M


def _effective_taps(L: int, M: int, taps: int) -> int:
    """Stretch tap support by M/L when downsampling, kept even."""
    if M > L:
        taps = -(-taps * M // L)
        taps += taps & 1
    return taps


def out_capacity(capacity: int, in_rate: int, out_rate: int) -> int:
    L, M = _rational(in_rate, out_rate)
    return -(-capacity * L // M)


def _out_length(length: int, L: int, M: int) -> int:
    """ceil(length*L/M) in the JAX package's int32-safe integer form."""
    return (length // M) * L + ((length % M) * L + M - 1) // M


def group_factor(L: int, M: int) -> int:
    """Cycle-group factor R of the grouped GEMM (see the JAX module). The
    plain CPU version groups R cycles per patch row exactly as the JAX
    package does; the CUDA kernel computes the ungrouped sum."""
    if M <= 8:
        return 1
    R = 128 // math.gcd(L, 128)
    if R == 1 or R > 8:
        return 1
    W = M + _effective_taps(L, M, DEFAULT_TAPS) - 1
    Wg = (R - 1) * M + W
    if Wg > 5 * W:
        return 1
    if R * L > 2048 or R * L * Wg > 2_000_000:
        return 1
    return R


def bank_spec(in_rate: int, out_rate: int):
    """(bank ndarray [L, W], left, W) of the analytic design: the window
    of output group g reads input [g*M - left, g*M - left + W)."""
    L, M = _rational(in_rate, out_rate)
    taps = _effective_taps(L, M, DEFAULT_TAPS)
    W = M + taps - 1
    bank = _design_filter_bank(L, M, taps, DEFAULT_BETA, DEFAULT_CUTOFF)
    return bank, taps // 2 - 1, W


@functools.lru_cache(maxsize=32)
def _device_bank(in_rate: int, out_rate: int,
                 device: torch.device) -> torch.Tensor:
    return torch.from_numpy(bank_spec(in_rate, out_rate)[0]).to(device)


def bank_operands(data: torch.Tensor, in_rate: int, out_rate: int):
    """``(x, G, M, W, bank)`` that ``resample_data`` hands
    ``apply_filter_bank`` for ``data`` [C, N]: the padded input, the number
    of output groups, the input stride, the window width and the bank on
    ``data``'s device."""
    L, M = _rational(in_rate, out_rate)
    if L > MAX_PHASES:
        raise ProcessorRuntimeError(
            "Unsupported resampling ratio",
            f"Rate pair {in_rate}->{out_rate} needs {L} phases "
            f"(max {MAX_PHASES}).",
            "resample_data",
        )
    N = data.shape[1]
    G = -(-(-(-N * L // M)) // L)  # groups of L outputs
    _, left, W = bank_spec(in_rate, out_rate)
    bank = _device_bank(in_rate, out_rate, data.device)
    # Input index 0 of the window is original sample -left; the right pad
    # covers the last group's window.
    right = max(0, (G + -(-W // M)) * M - left - N)
    return F.pad(data, (left, right)), G, M, W, bank


def resample_data(data: torch.Tensor, in_rate: int,
                  out_rate: int) -> torch.Tensor:
    """Resample [C, N] float32 to ceil(N*L/M) output samples.

    Also the counterpart of ``nodey_tpu/ops/pallas_resample.py::
    resample_data_pallas``, the TPU's ungrouped kernel (one [128, W] x
    [W, L] GEMM per channel per grid step): on a CUDA tensor this launches
    the polyphase kernel, which computes that same ungrouped sum, so the
    entry needs no code path of its own."""
    if in_rate == out_rate:
        return data
    x, G, M, W, bank = bank_operands(data, in_rate, out_rate)
    n_out = -(-data.shape[1] * bank.shape[0] // M)
    return apply_filter_bank(x, G, M, W, bank)[:, :n_out]


def apply_filter_bank(x: torch.Tensor, G: int, M: int, W: int,
                      bank: torch.Tensor) -> torch.Tensor:
    """``y[c, g*L + p] = sum_w x[c, g*M + w] * bank[p, w]`` -> [C, G*L].

    A CUDA tensor launches the polyphase kernel (or raises); a CPU tensor
    takes the plain version."""
    if x.is_cuda:
        from nodey_tpu_torch.ops import cuda_resample

        return cuda_resample.apply_filter_bank_cuda(x, G, M, W, bank)
    if x.device.type != "cpu":
        raise ProcessorRuntimeError(
            "Unsupported device for resampling",
            "The resampler runs on a CUDA card (kernel) or on the CPU.",
            f"device={x.device}",
        )
    return apply_filter_bank_plain(x, G, M, W, bank)


def apply_filter_bank_plain(x: torch.Tensor, G: int, M: int, W: int,
                            bank: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch versions of the JAX package's ``apply_filter_bank``
    branches: the grouped superblock GEMM for R > 1, and for R == 1 the
    patch GEMM (many small shifts) or the decomposed per-shift GEMM."""
    C = x.shape[0]
    L = bank.shape[0]
    R = group_factor(L, M)
    k_shifts = -(-W // M)
    if R > 1:
        return _apply_grouped_superblock(x, G, M, W, bank)
    need = (G + k_shifts) * M
    if x.shape[1] < need:
        x = F.pad(x, (0, need - x.shape[1]))
    segs = x[:, :need].reshape(C, G + k_shifts, M)
    if k_shifts > 4:
        # Tiny M (integer upsampling): build the [C, G, W] patch matrix.
        patches = torch.cat(
            [segs[:, i : i + G, :] for i in range(k_shifts)], dim=-1
        )[:, :, :W]
        return torch.matmul(patches, bank.T).reshape(C, G * L)
    # One GEMM per M-aligned shift; the patch matrix is never built.
    y = None
    for i in range(k_shifts):
        w0 = i * M
        w1 = min(W, w0 + M)
        part = torch.matmul(segs[:, i : i + G, : w1 - w0], bank[:, w0:w1].T)
        y = part if y is None else y + part
    return y.reshape(C, G * L)


def _grouped_bank(bank: torch.Tensor, M: int, W: int, R: int,
                  Wp: int) -> torch.Tensor:
    """[R*L, Wp] zero-embedded grouped bank: row block j holds the bank
    shifted right by j*M."""
    L = bank.shape[0]
    bank_g = bank.new_zeros((R * L, Wp))
    for j in range(R):
        bank_g[j * L : (j + 1) * L, j * M : j * M + W] = bank
    return bank_g


def _apply_grouped_superblock(x: torch.Tensor, G: int, M: int, W: int,
                              bank: torch.Tensor) -> torch.Tensor:
    """The R > 1 grouped GEMM (ops/resample.py:510-577 in the JAX package).

    R output groups share one Wp-wide window at stride Mg = R*M against the
    zero-embedded grouped bank; the input is viewed in superblocks of B
    group rows so every window is a uniform-shift slice, and one batched
    GEMM contracts the stacked [C, nblk, B, Wp] patches."""
    C = x.shape[0]
    L = bank.shape[0]
    R = group_factor(L, M)
    Mg = M * R
    Wg = (R - 1) * M + W
    Wp = -(-Wg // 128) * 128
    B = 128 // math.gcd(Mg, 128)
    SUP = Mg * B
    Gg = -(-G // R)
    nblk = max(1, -(-Gg // B))
    halo = -(-max(0, Wp - Mg) // 128) * 128
    need = (nblk + 1) * SUP  # +1 zero block feeds the halo
    if x.shape[1] < need:
        x = F.pad(x, (0, need - x.shape[1]))
    segs = x[:, :need].reshape(C, nblk + 1, SUP)
    big = segs[:, :nblk, :]
    if halo:
        big = torch.cat([big, segs[:, 1 : nblk + 1, :halo]], dim=2)
    patches = torch.stack(
        [big[:, :, j * Mg : j * Mg + Wp] for j in range(B)], dim=2
    )  # [C, nblk, B, Wp]
    y = torch.matmul(patches, _grouped_bank(bank, M, W, R, Wp).T)
    return y.reshape(C, nblk * B * R * L)[:, : G * L]


def resample_stream(stream: Stream, out_rate: int) -> Stream:
    """Resample a Stream, tracking valid length; the tail beyond the valid
    output length is zeroed."""
    if stream.rate == out_rate:
        return stream
    L, M = _rational(stream.rate, out_rate)
    data = resample_data(stream.data, stream.rate, out_rate)
    n_out_len = _out_length(stream.length, L, M)
    data[:, n_out_len:] = 0.0  # ``data`` is a fresh tensor: zero in place
    return Stream(
        data=data,
        length=n_out_len,
        rate=out_rate,
        channels=stream.channels,
        fmt=FMT_FLT,
        t0_us=stream.t0_us,
    )


def to_stereo(stream: Stream) -> Stream:
    """Channel-normalize to stereo with swr's default -3 dB mono upmix."""
    if stream.channels == 2:
        return stream
    data = torch.cat([stream.data, stream.data], dim=0) * SQRT1_2
    return stream.with_data(data, fmt=FMT_FLT)


def to_rate_and_stereo(stream: Stream, out_rate: int) -> Stream:
    """The preview/mixer input normalization: ``out_rate`` stereo float
    (reference: audio-io.cpp:532-615, audio-amix.cpp:206-243)."""
    return resample_stream(to_stereo(stream), out_rate)
