"""Signal-generator ops, test oscillators and noise, exact by construction
(port of nodey_tpu.ops.oscillator).

* **Tonal waveforms run on exact integer phase residues**, the modulation
  LFOs' two-level modular tables (ops/modfx.py): the phase at absolute
  sample ``t`` is the integer ``(t*NUM) mod M`` with ``M = DEN * rate <
  2^24`` (float32-exact), so the offline render, every streamed chunk and
  the float64 mirror evaluate the same residue at the same sample. The
  frequency quantizes to NUM/DEN cycles a second with the largest DEN that
  keeps M float32-exact (less than 1/DEN_MAX Hz off).
* **Every waveform is integer math plus one float32 multiply** by a
  constant folded on the host (``2*pi/M`` for the sine, ``gain/M`` for saw
  and triangle, ``gain*2^-22`` for noise); the sine adds ``sin``. Square is
  exactly +-gain (an integer compare picks the sign). So the offline and the
  streamed buffers are bitwise equal wherever ``sin`` is evaluated alike,
  and square, saw, triangle and noise are the JAX package's, bitwise.
* **Noise is a counter hash of the absolute sample index**, the Murmur3
  finalizer on ``index ^ f(seed, channel)``: stateless, so a stream
  carries no generator state. The uint32 products mod 2^32 run in int64
  with the multiplier split into 16-bit halves, so no product passes 2^48
  (torch has no general uint32 arithmetic).

Positions and residues are host ints; the step syncs on nothing (the
phase tables go to the device at plan time, ``generator_prepare``).
"""

from __future__ import annotations

import fractions
import math
from typing import Tuple

import numpy as np
import torch

from nodey_tpu_torch.core.stream import FMT_FLT, Stream
from nodey_tpu_torch.ops import modfx
from nodey_tpu_torch.ops.scans import f32 as _f32

_M_MAX = 1 << 24  # f32-exact integer ceiling for the phase modulus

WAVEFORMS = ("sine", "square", "triangle", "saw", "noise")


def osc_quantize(freq_hz: float, sample_rate: int) -> Tuple[int, int]:
    """(NUM, M): quantized oscillator frequency as NUM/DEN cycles/s with
    the largest DEN keeping M = DEN*rate < 2^24; returned as the
    per-sample residue increment NUM and the modulus M."""
    den_max = (_M_MAX - 1) // int(sample_rate)
    f = min(max(float(freq_hz), 1.0 / den_max), sample_rate / 2.0)
    frac = fractions.Fraction(f).limit_denominator(den_max)
    num, den = frac.numerator, frac.denominator
    m = den * int(sample_rate)
    assert 0 < m < _M_MAX, (m, "oscillator modulus must stay f32-exact")
    return num % m, m


def osc_residues(r0: int, width: int, num: int, m: int,
                 device) -> torch.Tensor:
    """int32 residues [width] on ``device``: (r0 + i*NUM) mod M for i in
    [0, width), r0 < M, by the modfx two-level tables (the LFOs')."""
    return modfx.lfo_residues(r0, width, num, m, device)


def tone_block(kind: str, r0: int, width: int, num: int, m: int,
               gain: float, device) -> torch.Tensor:
    """f32 [width] waveform values in [-gain, gain] at residue positions
    r0 + i*NUM (mod M), from the modfx two-level tables (cached on
    ``device`` per (NUM, M, width)): integer arithmetic, then one multiply
    by a folded float32 constant (the sine's ``sin`` between them)."""
    r = osc_residues(r0, width, num, m, device)
    g = float(gain)
    if kind == "sine":
        phase = r.float() * _f32(2.0 * math.pi / m)
        return torch.sin(phase) * _f32(g)
    if kind == "square":
        # Exact integer half-period test: +gain on [0, M/2), -gain after.
        return torch.where(2 * r < m, _f32(g), _f32(-g))
    s = 2 * r - m  # int32 in (-M, M): f32-exact
    if kind == "saw":
        return s.float() * _f32(g / m)
    if kind == "triangle":
        # g*(2|s|/M - 1) = (2|s| - M) * (g/M), 2|s| - M an exact int32.
        return (2 * torch.abs(s) - m).float() * _f32(g / m)
    raise ValueError(f"unknown waveform kind: {kind}")


# -- counter-hash noise ------------------------------------------------------

_FMIX_C1 = np.uint32(0x85EBCA6B)
_FMIX_C2 = np.uint32(0xC2B2AE35)
_U32 = 0xFFFFFFFF


def _mul_u32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for int64 ``h`` in [0, 2^32) and a constant ``c``
    < 2^32: c's 16-bit halves keep every product below 2^48."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """Murmur3 finalizer on int64 words in [0, 2^32): a full-avalanche
    uint32 -> uint32 bijection, exact."""
    h = h ^ (h >> 16)
    h = _mul_u32(h, int(_FMIX_C1))
    h = h ^ (h >> 13)
    h = _mul_u32(h, int(_FMIX_C2))
    return h ^ (h >> 16)


def noise_block(seed: int, channel: int, pos0: int, width: int,
                gain: float, device) -> torch.Tensor:
    """f32 [width] white noise in [-gain, gain): a hash of the absolute
    sample index, so equal indices give equal values in every plan."""
    i = torch.arange(pos0, pos0 + width, dtype=torch.int64, device=device)
    key = (seed * 0x9E3779B9 + channel * 0x7FEB352D) & _U32
    h = _fmix32((i & _U32) ^ key)
    # Top 23 bits, centered in integer space: an exact int in [-2^22, 2^22)
    # -> exact f32, then one multiply maps it to [-gain, gain).
    centered = (h >> 9) - (1 << 22)
    return centered.float() * _f32(float(gain) * 2.0 ** -22)


# -- block synthesis ---------------------------------------------------------


def generator_block(kind: str, num: int, m: int, gain: float, seed: int,
                    channels: int, pos0: int, r0: int, width: int,
                    device) -> torch.Tensor:
    """f32 [channels, width] samples from absolute sample ``pos0`` (residue
    ``r0 = (pos0*NUM) mod M``). Tonal waveforms are equal across channels;
    noise decorrelates per channel."""
    if kind == "noise":
        return torch.stack([noise_block(seed, c, pos0, width, gain, device)
                            for c in range(channels)])
    row = tone_block(kind, r0, width, num, m, gain, device)
    return row.unsqueeze(0).expand(channels, width).contiguous()


def generator_stream(kind: str, freq_hz: float, gain: float, seed: int,
                     rate: int, channels: int, total: int, capacity: int,
                     device, batch=None) -> Stream:
    """Offline synthesis on ``device``: a whole Stream with ``total`` valid
    samples (zero past the end, the Stream padding contract). With
    ``batch``, B copies [B, C, capacity] of the one clip, as the JAX
    package's vmap broadcasts it: copies in memory of their own, since
    ops downstream write in place."""
    num, m = osc_quantize(freq_hz, rate)
    data = generator_block(kind, num, m, gain, seed, channels, 0, 0,
                           capacity, device)
    data[:, total:] = 0.0
    length = total
    if batch is not None:
        data = data.expand(batch, *data.shape).contiguous()
        length = (total,) * batch
    return Stream(data=data, length=length, rate=rate, channels=channels,
                  fmt=FMT_FLT)


# -- chunk streaming: position and phase-residue carries (host ints) ---------


def generator_prepare(kind: str, num: int, m: int, width: int,
                      device) -> None:
    """Put the phase tables for ``width`` on ``device`` at plan time, so a
    step copies nothing from the host."""
    if kind != "noise":
        modfx.lfo_prepare(num, m, width, device)


def generator_stream_init():
    return {"pos": 0, "r": 0}


def generator_stream_step(kind: str, num: int, m: int, gain: float,
                          seed: int, channels: int, total: int, state,
                          width: int, device):
    """One streamed chunk at the carried absolute position: bitwise the
    offline buffer's samples where ``sin`` evaluates alike (the same
    residue or index hash at the same sample). Returns (state, data, n,
    done)."""
    pos, r = state["pos"], state["r"]
    data = generator_block(kind, num, m, gain, seed, channels, pos, r,
                           width, device)
    n = min(max(total - pos, 0), width)
    data[:, n:] = 0.0
    done = pos + width >= total
    # The position stops at ``total``, so flush steps after the end emit
    # nothing.
    new_state = {
        "pos": min(pos + width, total),
        "r": r if done else modfx.advance_residue(r, width, num, m),
    }
    return new_state, data, n, done


# -- float64 mirror ----------------------------------------------------------


def generator_reference(kind: str, freq_hz: float, gain: float, seed: int,
                        rate: int, channels: int, total: int) -> np.ndarray:
    """Float64 mirror on the same integer residues / index hashes."""
    num, m = osc_quantize(freq_hz, rate)
    t = np.arange(total, dtype=np.int64)
    r = (t * num) % m
    if kind == "sine":
        row = np.sin(2.0 * math.pi * r / m)
    elif kind == "square":
        row = np.where(2 * r < m, 1.0, -1.0)
    elif kind == "saw":
        row = (2 * r - m) / m
    elif kind == "triangle":
        row = 2.0 * np.abs(2 * r - m) / m - 1.0
    elif kind == "noise":
        rows = []
        for c in range(channels):
            key = np.uint32(
                (seed * 0x9E3779B9 + c * 0x7FEB352D) & 0xFFFFFFFF
            )
            with np.errstate(over="ignore"):
                h = _fmix32_np(t.astype(np.uint32) ^ key)
            rows.append((h >> 9).astype(np.float64) * 2.0 ** -22 - 1.0)
        return (np.stack(rows) * float(gain)).astype(np.float64)
    else:
        raise ValueError(f"unknown waveform kind: {kind}")
    out = np.broadcast_to(row[None, :], (channels, total))
    return out * float(gain)


def _fmix32_np(h: np.ndarray) -> np.ndarray:
    h = h.astype(np.uint32)
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    return h ^ (h >> np.uint32(16))
