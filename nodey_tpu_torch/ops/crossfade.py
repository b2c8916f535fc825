"""Crossfade, a two-input A->B blend over a timed window (port of
nodey_tpu.ops.crossfade).

The two inputs share one timeline (placed at t0 0, zero past their
lengths). Before the window the output is bitwise input A, after it
bitwise input B: ``torch.where`` on the integer sample index selects
them, never ``1.0 * A + 0.0 * B`` (which flips the sign of -0.0). Inside
the window:

    u     = (i - n0) / n_dur                 i = global sample index
    linear:       gA = 1 - u,        gB = u
    equal_power:  gA = cos(pi u / 2), gB = sin(pi u / 2)
    out   = gA * A + gB * B

The gain at sample i is a pure function of the global index: ``i - n0``
is an integer, converted to float32 only where it is < n_dur <= 2^24
(windows clamp to 60 s), so two plans compute the same u at the same
position. The blend is three eager ops (two products and a sum, no fma
contraction), so on one device the streamed output is bitwise the offline
one where ``cos`` and ``sin`` evaluate alike. The stream carries one
position (a host int) beside the aligned-merge FIFOs (core/chunkflow.py).

The output runs to the longer input. Window anchors clamp to the fade's
2^30-sample ceiling: a start past it raises a structured error rather than
relocating the splice.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from nodey_tpu_torch.core.errors import ProcessorRuntimeError
from nodey_tpu_torch.core.stream import FMT_FLT, Stream, max_length
from nodey_tpu_torch.ops.scans import f32 as _f32, mask_tail

_ANCHOR_MAX = 1 << 30          # same ceiling as ops/fadepan.fade_spec
_DUR_MAX_MS = 60_000.0         # keeps n_dur < 2^24 at 192 kHz

LAWS = ("equal_power", "linear")


def crossfade_spec(sample_rate: int, at_s: float,
                   dur_ms: float) -> Tuple[int, int]:
    """(n0, n_dur) in samples; structured error past the int32-exact
    anchor ceiling (~6.2 h at 48 kHz) instead of a silent relocation."""
    dur = min(max(float(dur_ms), 1.0), _DUR_MAX_MS)
    n_dur = max(int(round(dur * 1e-3 * sample_rate)), 1)
    n0 = int(round(max(float(at_s), 0.0) * sample_rate))
    if n0 + n_dur >= _ANCHOR_MAX:
        raise ProcessorRuntimeError(
            "Crossfade window exceeds the exact-anchor ceiling",
            "Crossfade windows must end within 2^30 samples of the "
            f"timeline start (about {_ANCHOR_MAX / sample_rate / 3600.0:.1f} "
            "hours at this sample rate) so gains stay int32-exact.",
            f"at_s={at_s} dur_ms={dur_ms} rate={sample_rate}",
        )
    return n0, n_dur


def crossfade_gains(pos0: int, width: int, n0: int, n_dur: int, law: str,
                    device):
    """(gA, gB, before, after) at global positions pos0 + [0, width): the
    f32 gains of the window's interior and the selection masks."""
    i = torch.arange(pos0, pos0 + width, dtype=torch.int32, device=device)
    before = i < n0
    after = i >= n0 + n_dur
    # In-window offsets are < n_dur <= 2^24: the int -> f32 conversion is
    # exact. The clamp keeps the (masked-out) exterior finite.
    off = torch.clamp(i - n0, 0, n_dur)
    u = off.float() * _f32(1.0 / n_dur)
    if law == "linear":
        ga = _f32(1.0) - u
        gb = u
    else:
        ga = torch.cos(_f32(0.5 * math.pi) * u)
        gb = torch.sin(_f32(0.5 * math.pi) * u)
    return ga, gb, before, after


def crossfade_blend(a: torch.Tensor, b: torch.Tensor, pos0: int, n0: int,
                    n_dur: int, law: str) -> torch.Tensor:
    """A->B blend of equal-shape [..., C, W] windows at global positions
    pos0 + [0, W): bitwise A before the window, bitwise B after it."""
    ga, gb, before, after = crossfade_gains(pos0, a.shape[-1], n0, n_dur,
                                            law, a.device)
    mix = ga[None, :] * a + gb[None, :] * b
    return torch.where(before[None, :], a,
                       torch.where(after[None, :], b, mix))


def crossfade_streams(sa: Stream, sb: Stream, at_s: float, dur_ms: float,
                      law: str) -> Stream:
    """Offline crossfade of two whole Streams (equal rate and channel
    count, both at t0 0: the node validates), or of two batches: each
    clip runs to the longer of its two inputs."""
    n0, n_dur = crossfade_spec(sa.rate, at_s, dur_ms)
    cap = max(sa.capacity, sb.capacity)

    def pad_to(s: Stream) -> torch.Tensor:
        return torch.nn.functional.pad(mask_tail(s.data, s.length),
                                       (0, cap - s.capacity))

    out = crossfade_blend(pad_to(sa), pad_to(sb), 0, n0, n_dur, law)
    length = max_length([sa.length, sb.length])
    return Stream(data=mask_tail(out, length), length=length, rate=sa.rate,
                  channels=sa.channels, fmt=FMT_FLT)


# -- float64 mirror ----------------------------------------------------------


def crossfade_reference(a: np.ndarray, b: np.ndarray, sample_rate: int,
                        at_s: float, dur_ms: float,
                        law: str) -> np.ndarray:
    """Float64 mirror over equal-length [C, N] arrays (pad first)."""
    n0, n_dur = crossfade_spec(sample_rate, at_s, dur_ms)
    n = a.shape[-1]
    i = np.arange(n, dtype=np.int64)
    u = np.clip((i - n0) / n_dur, 0.0, 1.0)
    if law == "linear":
        ga, gb = 1.0 - u, u
    else:
        ga = np.cos(0.5 * math.pi * u)
        gb = np.sin(0.5 * math.pi * u)
    xa = a.astype(np.float64)
    xb = b.astype(np.float64)
    mix = ga * xa + gb * xb
    out = np.where(i < n0, xa, np.where(i >= n0 + n_dur, xb, mix))
    return out.astype(np.float32)
