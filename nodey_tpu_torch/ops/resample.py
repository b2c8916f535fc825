"""Rational polyphase resampling (port of nodey_tpu.ops.resample).

For a reduced rate change L/M, output group g (L outputs) reads one input
window of width W = M + taps - 1 against an embedded [L, W] filter bank:

    y[c, g*L + p] = sum_w  x[c, g*M + w] * bank[p, w]

The bank is the same Kaiser-windowed sinc as the JAX package's, designed
on the host in float64 and cast once to float32, so both packages hold the
same numbers; it is cached on the device per rate pair, beside its tap
support (``bank_support``): each block of ``SUPPORT_BLOCK`` consecutive
phases reads only ``T`` of the W window columns, from its own offset, and
the kernel sums only those.

Dispatch (``apply_filter_bank``): a CUDA tensor goes to the hand-written
kernel in :mod:`nodey_tpu_torch.ops.cuda_resample` for every rate pair,
R > 1 and R == 1 alike; a CPU tensor takes the plain PyTorch versions
below, ported from the JAX package's XLA branches (the dense bank; they
ignore the support). There is no fallback from one to the other.

A batch of clips, ``[B, C, N]``, takes the same path: the kernel folds the
clips into its rows (one launch whatever B is), and the plain version
computes each clip on its own, on the GEMM shapes of a single clip (a
CPU GEMM's result for a row depends on how many rows it is given, and a
batched clip must equal its single render bitwise).

``compat="swr"`` (or ``NODEY_RESAMPLE_COMPAT=swr``, ``run --swr-compat``)
takes the measured libswresample banks (``host.resample_ref.
measure_swr_bank``) in place of the analytic design, through the same
kernel and plain versions. Measuring needs the codec runtime: where it
does not load, ``bank_spec`` raises, and no analytic bank is rendered in
its place.

Not ported: the relay-era formulation switch (``resolve_form``,
``form_override``, the ``transposed`` form) and
``to_rate_and_stereo_many``.
"""

from __future__ import annotations

import functools
import math
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from nodey_tpu_torch.core.errors import ProcessorRuntimeError
from nodey_tpu_torch.core.stream import FMT_FLT, Stream, map_lengths, zero_tail

# libswresample default rematrix gain (-3 dB mono upmix).
SQRT1_2 = 0.7071067811865476

# Filter quality point (libswresample's defaults; see the JAX module). The
# JAX package exposes taps/beta/cutoff as arguments; nothing calls it with
# other values, so here they are constants.
DEFAULT_TAPS = 32
DEFAULT_BETA = 9.0
DEFAULT_CUTOFF = 0.97
MAX_PHASES = 8192
# Consecutive phases that share one tap window in the CUDA kernel's
# register tile (kBlock in csrc/polyphase_resample.cu): one input value it
# loads feeds this many phases.
SUPPORT_BLOCK = 4
# Phases one CTA of that kernel takes (its kTilePhases): a group's staged
# input row spans the widest offset spread of such a tile.
TILE_PHASES = 32


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


def resolve_compat(compat=None):
    """The resampler's compatibility mode: an explicit argument wins;
    otherwise NODEY_RESAMPLE_COMPAT ('swr' = measured libswresample banks,
    ``host.resample_ref.measure_swr_bank``); default None = the analytic
    design."""
    if compat is not None:
        return compat or None
    return os.environ.get("NODEY_RESAMPLE_COMPAT") or None


def bank_spec(in_rate: int, out_rate: int, compat=None):
    """(bank ndarray [L, W], left, W) for the rate pair under ``compat``
    (``resolve_compat``): the window of output group g reads input
    [g*M - left, g*M - left + W)."""
    L, M = _rational(in_rate, out_rate)
    compat = resolve_compat(compat)
    if compat == "swr":
        from nodey_tpu_torch.host.resample_ref import measure_swr_bank

        bank, left, W = measure_swr_bank(in_rate, out_rate)
        if left < 0:
            # Keep the window non-anticipating: leading zero columns in
            # place of a negative left pad.
            bank = np.pad(bank, ((0, 0), (-left, 0)))
            W += -left
            left = 0
        if W < M + 1:
            bank = np.pad(bank, ((0, 0), (0, M + 1 - W)))
            W = M + 1
        return bank, left, W
    if compat is not None:
        raise ProcessorRuntimeError(
            "Unknown resampler compatibility mode",
            "Supported: 'swr' (measured libswresample-equivalent banks).",
            f"compat={compat!r}",
        )
    taps = _effective_taps(L, M, DEFAULT_TAPS)
    W = M + taps - 1
    bank = _design_filter_bank(L, M, taps, DEFAULT_BETA, DEFAULT_CUTOFF)
    return bank, taps // 2 - 1, W


def bank_support(bank: np.ndarray):
    """``(compact [nb, T, block], offsets int32 [nb], T)``: the tap support
    of the dense float32 bank [L, W], read from its own zeros, for blocks
    of ``block = SUPPORT_BLOCK`` consecutive phases (nb = ceil(L / block)).

    Block b's non-zero columns lie in [first_b, last_b] (over its phases);
    T is the widest last_b - first_b + 1, offsets[b] = min(first_b, W - T)
    and ``compact[b, t, r] = bank[b*block + r, offsets[b] + t]`` (zero for
    phases past L). Re-embedding the compact bank at its offsets gives the
    bank back bitwise: only exact zeros are left out."""
    L, W = bank.shape
    block = SUPPORT_BLOCK
    nb = -(-L // block)
    rows = np.zeros((nb * block, W), dtype=bank.dtype)
    rows[:L] = bank
    live = (rows != 0).reshape(nb, block, W).any(axis=1)        # [nb, W]
    has = live.any(axis=1)
    first = np.where(has, live.argmax(axis=1), 0)
    last = np.where(has, W - 1 - live[:, ::-1].argmax(axis=1), 0)
    T = max(1, int((last - first + 1).max()))
    offsets = np.minimum(first, W - T).astype(np.int32)
    cols = offsets[:, None] + np.arange(T)                       # [nb, T]
    compact = np.take_along_axis(rows.reshape(nb, block, W),
                                 cols[:, None, :], axis=2)        # [nb, blk, T]
    return np.ascontiguousarray(compact.transpose(0, 2, 1)), offsets, T


class BankSupport(NamedTuple):
    """A bank's tap support on a device (see ``bank_support``): what the
    kernel reads in place of the dense bank."""

    compact: torch.Tensor      # [nb, T, SUPPORT_BLOCK] float32
    offsets: torch.Tensor      # [nb] int32
    taps: int                  # T
    phases: int                # L
    width: int                 # W
    row_used: int              # input columns a group's staged row needs


def support_on(bank: np.ndarray, device) -> BankSupport:
    """``bank_support`` of ``bank`` with its tensors on ``device``, and the
    width of the input row the kernel stages per output group: the widest
    offset spread over its ``TILE_PHASES``-phase tiles, plus T."""
    compact, offsets, T = bank_support(bank)
    tile = TILE_PHASES // SUPPORT_BLOCK
    tiles = np.pad(offsets, (0, -len(offsets) % tile), mode="edge")
    tiles = tiles.reshape(-1, tile)
    row_used = int((tiles.max(axis=1) - tiles.min(axis=1)).max()) + T
    return BankSupport(torch.from_numpy(compact).to(device),
                       torch.from_numpy(offsets).to(device), T, *bank.shape,
                       row_used)


def _device_bank(in_rate: int, out_rate: int, device, compat=None):
    """``(bank [L, W], BankSupport)`` of the rate pair under ``compat``
    (``resolve_compat``) on ``device``, derived once per bank and cached,
    so no step copies from the host."""
    return _bank_on(in_rate, out_rate, torch.device(device),
                    resolve_compat(compat))


@functools.lru_cache(maxsize=32)
def _bank_on(in_rate: int, out_rate: int, device: torch.device, compat):
    bank = bank_spec(in_rate, out_rate, compat)[0]
    return (torch.from_numpy(bank).to(device),
            support_on(bank, device))


def bank_operands(data: torch.Tensor, in_rate: int, out_rate: int,
                  compat=None):
    """``(x, G, M, W, bank, support)`` that ``resample_data`` hands
    ``apply_filter_bank`` for ``data`` [C, N] (or a batch [B, C, N]): the
    padded input, the number
    of output groups, the input stride, the window width, and the bank and
    its tap support on ``data``'s device."""
    L, M = _rational(in_rate, out_rate)
    if L > MAX_PHASES:
        raise ProcessorRuntimeError(
            "Unsupported resampling ratio",
            f"Rate pair {in_rate}->{out_rate} needs {L} phases "
            f"(max {MAX_PHASES}).",
            "resample_data",
        )
    N = data.shape[-1]
    G = -(-(-(-N * L // M)) // L)  # groups of L outputs
    compat = resolve_compat(compat)
    _, left, W = bank_spec(in_rate, out_rate, compat)
    bank, support = _device_bank(in_rate, out_rate, data.device, compat)
    # Input index 0 of the window is original sample -left; the right pad
    # covers the last group's window.
    right = max(0, (G + -(-W // M)) * M - left - N)
    return F.pad(data, (left, right)), G, M, W, bank, support


def resample_data(data: torch.Tensor, in_rate: int, out_rate: int,
                  compat=None) -> torch.Tensor:
    """Resample [C, N] (or [B, C, N]) float32 to ceil(N*L/M) output
    samples.

    Also the counterpart of ``nodey_tpu/ops/pallas_resample.py::
    resample_data_pallas``, the TPU's ungrouped kernel (one [128, W] x
    [W, L] GEMM per channel per grid step): on a CUDA tensor this launches
    the polyphase kernel, which computes that same ungrouped sum, so the
    entry needs no code path of its own."""
    if in_rate == out_rate:
        return data
    x, G, M, W, bank, support = bank_operands(data, in_rate, out_rate,
                                              compat)
    n_out = -(-data.shape[-1] * bank.shape[0] // M)
    return apply_filter_bank(x, G, M, W, bank, support)[..., :n_out]


def apply_filter_bank(x: torch.Tensor, G: int, M: int, W: int,
                      bank: torch.Tensor,
                      support: BankSupport) -> torch.Tensor:
    """``y[c, g*L + p] = sum_w x[c, g*M + w] * bank[p, w]`` -> [C, G*L]
    (``x`` [B, C, N] -> [B, C, G*L]).

    A CUDA tensor launches the polyphase kernel on ``support``, the bank's
    tap support (or raises); a CPU tensor takes the plain version on the
    dense ``bank``."""
    if x.is_cuda:
        from nodey_tpu_torch.ops import cuda_resample

        return cuda_resample.apply_filter_bank_cuda(x, G, M, W, support)
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
    patch GEMM (many small shifts) or the decomposed per-shift GEMM. A
    batch ``x`` [B, C, N] goes clip by clip, each on a single clip's
    GEMM shapes."""
    if x.dim() == 3:
        return torch.stack([apply_filter_bank_plain(clip, G, M, W, bank)
                            for clip in x])
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
    """Resample a Stream, tracking valid length (each clip's, for a batch);
    the tail beyond the valid output length is zeroed."""
    if stream.rate == out_rate:
        return stream
    L, M = _rational(stream.rate, out_rate)
    data = resample_data(stream.data, stream.rate, out_rate)
    n_out_len = map_lengths(stream.length, lambda n: _out_length(n, L, M))
    zero_tail(data, n_out_len)  # ``data`` is a fresh tensor: zero in place
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
    data = torch.cat([stream.data, stream.data], dim=-2) * SQRT1_2
    return stream.with_data(data, fmt=FMT_FLT)


def to_rate_and_stereo(stream: Stream, out_rate: int) -> Stream:
    """The preview/mixer input normalization: ``out_rate`` stereo float
    (reference: audio-io.cpp:532-615, audio-amix.cpp:206-243)."""
    return resample_stream(to_stereo(stream), out_rate)
