"""Stereo pan/balance, mid/side width and fade envelopes (port of
nodey_tpu.ops.fadepan).

**Pan** (``audio_pan``) is a memoryless per-channel constant gain. Stereo
in: the balance law ``gl = min(1, 1-p), gr = min(1, 1+p)`` (center is
gains of exactly 1.0, a bitwise passthrough). Mono in: constant-power
placement into stereo, ``gl = cos((p+1)*pi/4), gr = sin((p+1)*pi/4)``,
gains computed in float64 on the host.

**Width** (``audio_width``) is the pan's mid/side sibling: a constant 2x2
channel matrix ``out = (m + w s, m - w s)`` scaling the side signal. Width
1.0 and mono inputs are bitwise passthroughs (special-cased: the
re-associated matrix at w = 1 is not bitwise L/R).

**Fade** (``audio_fade``) is time-variant but analytic: the gain at sample
t is a pure function of the global sample index, so the only state a
stream carries is the position (a host int). Anchors are absolute (fade-in
from sample 0, fade-out from ``out_start_s``), so the law is the same
offline and streamed; a fade-out anchored at the clip's end is offline
only. Positions are int32 on the device and ramp differences are < 2^24,
so the int->float conversion is exact and the gains are the JAX
package's, bitwise. Outside the ramps the gain is the constant 1.0.

The gains are applied as host scalars, never as small tensors copied to
the device inside a chunk step. Every op takes one clip [C, N] or a batch
[B, C, N] (channels on axis -2): pan and width act per channel, a fade's
gain is one [N] row for every clip, and the end-anchored fade's is [B, 1,
N], each clip's ramp ending at its own length. The sharded functions
(``pan_sharded_local``, ``fade_sharded_local``) run over the list of a
mesh axis's shards: the fade's gain from each shard's global offset, no
communication.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from nodey_tpu_torch.core.stream import FMT_FLT, Stream, device_lengths
from nodey_tpu_torch.ops.scans import f32 as _f32

# -- pan ---------------------------------------------------------------------


def pan_gains(pan: float, channels: int) -> Tuple[float, float]:
    """(gl, gr) for the given input width; float64 host math."""
    p = min(max(float(pan), -1.0), 1.0)
    if channels == 2:
        return min(1.0, 1.0 - p), min(1.0, 1.0 + p)
    theta = (p + 1.0) * math.pi / 4.0
    return math.cos(theta), math.sin(theta)


def pan_array(data: torch.Tensor, pan: float) -> torch.Tensor:
    """[..., C, N] -> [..., 2, N] panned stereo (C in {1, 2}); each channel
    times its gain rounded to float32."""
    channels = data.shape[-2]
    gl, gr = pan_gains(pan, channels)
    left = data[..., 0, :]
    right = data[..., 1, :] if channels == 2 else left
    return torch.stack([left * _f32(gl), right * _f32(gr)], dim=-2)


def pan_stream(stream: Stream, pan: float) -> Stream:
    if stream.channels == 2 and float(pan) == 0.0:
        return stream                      # bitwise passthrough
    return stream.with_data(pan_array(stream.data, pan), fmt=FMT_FLT)


# -- fade --------------------------------------------------------------------

_RAMP_MAX_MS = 60_000.0       # keeps ramp sample counts < 2^24 at 192 kHz


@dataclasses.dataclass(frozen=True)
class FadeSpec:
    """Host-resolved integer anchors.

    ``anchor_end`` switches the fade-out from the absolute ``out_start``
    anchor to "ends at the stream's length", known offline only; the
    streaming planner rejects it (a causal stream cannot anchor at its
    own end)."""

    n_in: int                 # fade-in ramp length in samples (0 = none)
    out_start: int            # fade-out ramp start sample (0 = none)
    n_out: int                # fade-out ramp length in samples
    anchor_end: bool = False

    @property
    def out_end(self) -> int:
        return self.out_start + self.n_out

    @property
    def is_noop(self) -> bool:
        if self.anchor_end:
            return self.n_in == 0 and self.n_out == 0
        return self.n_in == 0 and self.out_start == 0


def fade_spec(rate: int, in_ms: float, out_start_s: float,
              out_ms: float, anchor_end: bool = False) -> FadeSpec:
    in_ms = min(max(float(in_ms), 0.0), _RAMP_MAX_MS)
    out_ms = min(max(float(out_ms), 0.0), _RAMP_MAX_MS)
    out_start_s = max(float(out_start_s), 0.0)
    n_in = int(round(in_ms * 1e-3 * rate))
    # int32 position arithmetic: keep out_end + any chunk width < 2^31.
    out_start = min(int(round(out_start_s * rate)), 1 << 30)
    n_out = int(round(out_ms * 1e-3 * rate))
    if anchor_end:
        return FadeSpec(n_in=n_in, out_start=0, n_out=n_out,
                        anchor_end=True)
    if out_start == 0:
        n_out = 0                     # out_start_s == 0 disables fade-out
    return FadeSpec(n_in=n_in, out_start=out_start, n_out=n_out)


def _positions(pos0: int, width: int, device) -> torch.Tensor:
    return torch.arange(pos0, pos0 + width, dtype=torch.int32, device=device)


def _fade_in(spec: FadeSpec, p: torch.Tensor) -> torch.Tensor:
    ramp = torch.clamp_max(p, spec.n_in).float() * _f32(1.0 / spec.n_in)
    return torch.where(p >= spec.n_in, 1.0, ramp)


def fade_gain(spec: FadeSpec, pos0: int, width: int,
              device) -> torch.Tensor:
    """[width] f32 gain at global positions pos0 + i. Exactly 1.0
    outside the ramps; 0.0 after the fade-out completes."""
    p = _positions(pos0, width, device)
    g = _fade_in(spec, p) if spec.n_in > 0 else None
    if spec.out_start > 0:
        # diff in [0, n_out] inside the ramp — int32-exact, f32-exact.
        diff = torch.clamp(spec.out_end - p, 0, max(spec.n_out, 1))
        if spec.n_out > 0:
            ramp = diff.float() * _f32(1.0 / spec.n_out)
        else:
            ramp = torch.zeros(width, dtype=torch.float32, device=device)
        g_out = torch.where(p < spec.out_start, 1.0,
                            torch.where(p >= spec.out_end, 0.0, ramp))
        g = g_out if g is None else g * g_out
    if g is None:
        g = torch.ones(width, dtype=torch.float32, device=device)
    return g


def fade_gain_end(spec: FadeSpec, pos0: int, width: int, length,
                  device) -> torch.Tensor:
    """[width] f32 gain with the fade-out anchored to END at the stream's
    ``length`` (spec.n_out is the ramp length; spec.out_start is
    ignored). ``length`` may be a batch's int32 [B, 1, 1] lengths on
    ``device`` (``device_lengths``): the gain is then [B, 1, width]."""
    p = _positions(pos0, width, device)
    if spec.n_in > 0:
        g = _fade_in(spec, p)
    else:
        g = torch.ones(width, dtype=torch.float32, device=device)
    if spec.n_out > 0:
        diff = torch.clamp(length - p, 0, spec.n_out)
        ramp = diff.float() * _f32(1.0 / spec.n_out)
        g_out = torch.where(p < length - spec.n_out, 1.0,
                            torch.where(p >= length, 0.0, ramp))
        g = g * g_out if spec.n_in > 0 else g_out
    return g


def fade_stream(stream: Stream, spec: FadeSpec) -> Stream:
    if spec.is_noop:
        return stream                      # bitwise passthrough
    device = stream.data.device
    if spec.anchor_end:
        g = fade_gain_end(spec, 0, stream.capacity,
                          device_lengths(stream.length, device), device)
    else:
        g = fade_gain(spec, 0, stream.capacity, device)
    return stream.with_data(stream.data * g, fmt=FMT_FLT)


# -- streaming ---------------------------------------------------------------


def fade_stream_init():
    """Carry: the global sample position of the next chunk (a host int)."""
    return (0,)


def fade_stream_step(spec: FadeSpec, state, data: torch.Tensor, n: int):
    (pos0,) = state
    g = fade_gain(spec, pos0, data.shape[1], data.device)
    return (pos0 + n,), data * g[None, :]


# -- stereo width (mid/side) --------------------------------------------------


def width_array(data: torch.Tensor, width: float) -> torch.Tensor:
    """[..., 2, N] -> [..., 2, N] mid/side width scaling: out = (m + w s,
    m - w s) with m = 0.5 (L + R), s = 0.5 (L - R). Callers special-case
    w == 1.0 before this (m + s is not bitwise L)."""
    left, right = data[..., 0, :], data[..., 1, :]
    m = _f32(0.5) * (left + right)
    ws = _f32(width) * (_f32(0.5) * (left - right))
    return torch.stack([m + ws, m - ws], dim=-2)


def width_stream(stream: Stream, width: float) -> Stream:
    if float(width) == 1.0 or stream.channels != 2:
        return stream                      # bitwise passthrough
    return stream.with_data(width_array(stream.data, width), fmt=FMT_FLT)


# -- sharded (sp chain) local steps --------------------------------------------
#
# Each takes the list of the shards' equal [C, chunk] time slices along one
# mesh axis and returns theirs (parallel/tv_sharded.py).


def pan_sharded_local(xs, pan: float):
    """Memoryless: per-channel gains, no communication."""
    return [pan_array(x, pan) for x in xs]


def fade_sharded_local(xs, spec: FadeSpec, length=None):
    """Each shard's gain from its global offset, no communication (the
    tremolo's move). ``length`` is the GLOBAL valid length (a host int),
    needed by an end-anchored spec."""
    chunk = xs[0].shape[-1]
    out = []
    for i, x in enumerate(xs):
        if spec.anchor_end:
            g = fade_gain_end(spec, i * chunk, chunk, length, x.device)
        else:
            g = fade_gain(spec, i * chunk, chunk, x.device)
        out.append(x * g[None, :])
    return out
