"""Modulation effects, tremolo and chorus/flanger (port of
nodey_tpu.ops.modfx).

Both are time-variant (an LFO modulates gain or delay), but the variance
is analytic: the modulation at sample t is a pure function of the global
sample index, so the offline and the chunk-streamed renders evaluate the
same modulation at the same position, and the only state carried across
chunks is where in the clip the stream is.

**LFO phase as modular-integer residues.** The LFO rate is quantized to
NUM/DEN cycles a second with DEN <= 128, and the phase is the integer
residue

    r(pos) = (pos * NUM) mod M,       M = DEN * sample_rate  (< 2^24)

built, as in the JAX package, from two-level int32 tables (i*NUM mod M for
i < 4096, and j*4096*NUM mod M) so that no intermediate overflows: the
residues at equal positions are the JAX package's, bitwise. The tables are
cached on the device per (NUM, M, width, device); the residue carried from
chunk to chunk is a host int.
theta = 2*pi*r/M then feeds one float32 cos; M < 2^24 keeps the int->float
conversion exact.

**Tremolo**: out[t] = x[t] * (1 - depth * (0.5 - 0.5*cos theta)); at
depth 0 the gain is exactly 1.0.

**Chorus**: out = dry*x + wet * mean_v x[t - d_v(t)],
d_v(t) = base + depth * (0.5 - 0.5*cos(theta + v/V turns)), a gathered
linear interpolation (two gathers per voice) over a finite history of
ceil(base + depth) + 2 samples (FIR, no feedback).

The offline ops take one clip [C, N] or a batch [B, C, N]: the LFO is
one [N] row shared by every clip, each starting at phase 0 as in the JAX
package's vmap.

The sharded functions (``shard_residue``, ``tremolo_sharded_local``,
``chorus_sharded_local``) run over the list of a mesh axis's shards: each
shard's LFO phase is the residue at its global offset, a host int.
"""

from __future__ import annotations

import fractions
import functools
import math
from typing import Tuple

import numpy as np
import torch

from nodey_tpu_torch.core.stream import FMT_FLT, Stream
from nodey_tpu_torch.ops.scans import f32 as _f32, mask_tail

_DEN_MAX = 128          # LFO rate quantum: 1/128 Hz
_LO_BITS = 12           # two-level phase table split (4096)
_LO = 1 << _LO_BITS


def lfo_quantize(rate_hz: float, sample_rate: int) -> Tuple[int, int]:
    """(NUM, M): quantized LFO rate as NUM/DEN cycles/s with DEN <= 128,
    returned as the per-sample residue increment NUM and the modulus
    M = DEN * sample_rate."""
    frac = fractions.Fraction(
        max(float(rate_hz), 1.0 / _DEN_MAX)
    ).limit_denominator(_DEN_MAX)
    num, den = frac.numerator, frac.denominator
    m = den * int(sample_rate)
    assert m < (1 << 24), (m, "LFO modulus must stay f32-exact")
    return num, m


def _phase_tables(num: int, m: int, width: int):
    """Host-exact int32 tables: lo[i] = (i*NUM) mod M for i < 4096 and
    hi[j] = (j*4096*NUM) mod M for j <= width//4096 (Python ints — no
    overflow anywhere)."""
    lo = np.array([(i * num) % m for i in range(_LO)], dtype=np.int32)
    n_hi = width // _LO + 1
    hi = np.array([(j * _LO * num) % m for j in range(n_hi)],
                  dtype=np.int32)
    return lo, hi


@functools.lru_cache(maxsize=32)
def _device_tables(num: int, m: int, width: int, device: torch.device):
    """``_phase_tables(num, m, width)`` as int32 tensors on ``device``, and
    M as a float32 [1] tensor there: a CUDA division by a host scalar
    multiplies by its reciprocal, which is not the correctly rounded r/M
    that the JAX package computes."""
    lo, hi = _phase_tables(num, m, width)
    return (torch.from_numpy(lo).to(device), torch.from_numpy(hi).to(device),
            torch.full((1,), float(m), dtype=torch.float32, device=device))


def lfo_prepare(num: int, m: int, width: int, device) -> None:
    """Put the phase tables for ``width`` on ``device`` now, so a chunk
    step at that width copies nothing from the host."""
    _device_tables(int(num), int(m), int(width), torch.device(device))


def lfo_residues(r0: int, width: int, num: int, m: int,
                 device) -> torch.Tensor:
    """int32 residues (r0 + i*NUM) mod M [width] on ``device``, i in
    [0, width), by the JAX package's table arithmetic (r0 < M)."""
    lo, hi, _m = _device_tables(int(num), int(m), int(width),
                                torch.device(device))
    i = torch.arange(width, dtype=torch.int32, device=device)
    part = hi[i >> _LO_BITS] + lo[i & (_LO - 1)]       # < 2*M
    return torch.remainder(part + r0, m)                # < 3*M << 2^31


def lfo_turns(r0: int, width: int, num: int, m: int, device,
              offset_turns: float = 0.0) -> torch.Tensor:
    """f32 LFO phase in turns [width] at residue positions r0 + i*NUM
    (mod M), i in [0, width). The int->f32 conversion is exact
    (M < 2^24); ``offset_turns`` adds a static per-voice offset."""
    m_t = _device_tables(int(num), int(m), int(width),
                         torch.device(device))[2]
    turns = lfo_residues(r0, width, num, m, device).float() / m_t
    if offset_turns:
        turns = turns + _f32(offset_turns)
    return turns


def advance_residue(r0: int, n: int, num: int, m: int) -> int:
    """(r0 + n*NUM) mod M: the count is a host int, and Python's integers
    do not overflow, so no table is needed for the exact residue."""
    return (r0 + n * num) % m


def _cos_sweep(turns: torch.Tensor) -> torch.Tensor:
    """0.5 - 0.5*cos(2*pi*turns) in float32."""
    return _f32(0.5) - _f32(0.5) * torch.cos(_f32(2.0 * math.pi) * turns)


# -- tremolo ---------------------------------------------------------------------


def tremolo_gain(r0: int, width: int, num: int, m: int, depth: float,
                 device) -> torch.Tensor:
    """[width] f32 gain 1 - depth*(0.5 - 0.5*cos theta); exactly 1.0
    everywhere at depth == 0."""
    s = _cos_sweep(lfo_turns(r0, width, num, m, device))
    return _f32(1.0) - _f32(depth) * s


def tremolo_stream(stream: Stream, rate_hz: float, depth: float) -> Stream:
    """Offline tremolo over a whole Stream (phase 0 at stream sample 0)."""
    num, m = lfo_quantize(rate_hz, stream.rate)
    g = tremolo_gain(0, stream.capacity, num, m, depth, stream.data.device)
    return stream.with_data(stream.data * g[None, :], fmt=FMT_FLT)


# -- chorus ----------------------------------------------------------------------


def chorus_spec(sample_rate: int, base_ms: float, depth_ms: float,
                voices: int) -> Tuple[float, float, int]:
    """(base, depth, hist) in samples: modulation bounds and the history
    length (receptive field) the streaming ring must cover."""
    base = max(float(base_ms), 0.0) * 1e-3 * sample_rate
    depth = max(float(depth_ms), 0.0) * 1e-3 * sample_rate
    hist = int(math.ceil(base + depth)) + 2
    return base, depth, hist


def chorus_wet(x_ext: torch.Tensor, r0: int, width: int, num: int, m: int,
               base: float, depth: float, voices: int) -> torch.Tensor:
    """Wet sum over voices from ``x_ext`` [..., C, hist + width] (hist
    samples of left context; a batch's clips share the LFO): for output i,
    gathers x_ext[..., hist + i - d_v(i)] with linear interpolation. Voice
    v's LFO is offset v/V turns. Returns [..., C, width]."""
    device = x_ext.device
    hist = x_ext.shape[-1] - width
    i = torch.arange(width, dtype=torch.int32, device=device)
    acc = None
    for v in range(voices):
        s = _cos_sweep(lfo_turns(r0, width, num, m, device,
                                 offset_turns=v / voices))
        d = _f32(base) + _f32(depth) * s                # [width]
        di = torch.floor(d).to(torch.int32)
        frac = d - di.float()
        pos = (hist + i - di).long()                    # >= 1
        a = x_ext.index_select(-1, pos)
        b = x_ext.index_select(-1, pos - 1)
        wetv = (_f32(1.0) - frac)[None, :] * a + frac[None, :] * b
        acc = wetv if acc is None else acc + wetv
    return acc * _f32(1.0 / voices)


def chorus_stream(stream: Stream, rate_hz: float, base_ms: float,
                  depth_ms: float, voices: int, wet: float,
                  dry: float) -> Stream:
    """Offline chorus over a whole Stream (length-preserving; the wet
    path reads zeros before the clip start, like a real delay line that
    starts empty)."""
    num, m = lfo_quantize(rate_hz, stream.rate)
    base, depth, hist = chorus_spec(stream.rate, base_ms, depth_ms, voices)
    x = mask_tail(stream.data, stream.length)
    x_ext = torch.nn.functional.pad(x, (hist, 0))
    w = chorus_wet(x_ext, 0, stream.capacity, num, m, base, depth, voices)
    y = _f32(dry) * x + _f32(wet) * w
    return stream.with_data(mask_tail(y, stream.length), fmt=FMT_FLT)


# -- streaming -------------------------------------------------------------------


def tremolo_stream_init():
    """Carry: the LFO phase residue at the next sample (a host int < M)."""
    return (0,)


def tremolo_stream_step(params, state, data: torch.Tensor, n: int):
    num, m, depth = params
    (r0,) = state
    w = data.shape[1]
    g = tremolo_gain(r0, w, num, m, depth, data.device)
    return (advance_residue(r0, n, num, m),), data * g[None, :]


def chorus_stream_init(channels: int, hist: int, device):
    """Carry: (input-history ring [C, hist], phase residue, a host int)."""
    return (torch.zeros((channels, hist), dtype=torch.float32,
                        device=device), 0)


def chorus_stream_step(params, state, data: torch.Tensor, n: int):
    """One chunk [C, W], n valid: wet from [ring ++ chunk] at the exact
    global phase residues; ring and residue advance by n. Length-
    preserving (out_n == n), so no flush protocol is needed."""
    num, m, base, depth, voices, wet, dry = params
    ring, r0 = state
    w = data.shape[1]
    x = mask_tail(data, n)
    ext = torch.cat([ring, x], dim=1)
    wetsum = chorus_wet(ext, r0, w, num, m, base, depth, voices)
    out = mask_tail(_f32(dry) * x + _f32(wet) * wetsum, n)
    ring = ext[:, n:n + ring.shape[1]]
    return (ring, advance_residue(r0, n, num, m)), out


# -- sharded (sp chain) local steps ------------------------------------------------
#
# Each function takes the list of the shards' equal [C, chunk] time slices
# along one mesh axis and returns theirs (parallel/tv_sharded.py).


def shard_residue(num: int, m: int, chunk: int, index: int) -> int:
    """Shard ``index``'s starting phase residue, (index * chunk * NUM) mod
    M, with the per-shard advance (chunk*NUM mod M) reduced first (the
    JAX package's int32 product stays < sp * M); a host int."""
    adv = (chunk * num) % m
    return (index * adv) % m


def tremolo_sharded_local(xs, rate_hz: float, depth: float,
                          sample_rate: int):
    """The tremolo over the shards ``xs``: each shard's phase from its
    global offset, no communication at all."""
    num, m = lfo_quantize(rate_hz, sample_rate)
    chunk = xs[0].shape[-1]
    return [x * tremolo_gain(shard_residue(num, m, chunk, i), chunk, num, m,
                             depth, x.device)[None, :]
            for i, x in enumerate(xs)]


def chorus_sharded_local(xs, length: int, rate_hz: float, base_ms: float,
                         depth_ms: float, voices: int, wet: float,
                         dry: float, sample_rate: int):
    """The chorus over the shards ``xs``: the left halo (the receptive
    field ``hist``) by ``halo_exchange_nd``, each shard's phase from its
    global offset; masked to the global valid ``length`` so the zero
    padding survives."""
    from nodey_tpu_torch.parallel.ops import halo_exchange_nd

    num, m = lfo_quantize(rate_hz, sample_rate)
    base, depth, hist = chorus_spec(sample_rate, base_ms, depth_ms, voices)
    chunk = xs[0].shape[-1]
    out = []
    for i, (x, ext) in enumerate(zip(xs, halo_exchange_nd(xs, hist, 0))):
        wetsum = chorus_wet(ext, shard_residue(num, m, chunk, i), chunk, num,
                            m, base, depth, voices)
        out.append(mask_tail(_f32(dry) * x + _f32(wet) * wetsum,
                             length - i * chunk))
    return out
