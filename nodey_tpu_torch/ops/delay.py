"""Feedback delay (echo) (port of nodey_tpu.ops.delay): an exact K-echo
geometric comb evaluated at log depth.

The feedback delay line w[t] = x[t - D] + fb * w[t - D] is defined, as in
the JAX package, truncated at the first repeat below -60 dB:

    K = ceil(60 / (-20*log10(fb)))   echoes   (K = 1 when fb == 0,
                                              capped at 66 = fb 0.9),

so the node is a finite sparse FIR comb with taps fb^(k-1) at lags k*D,
k = 1..K: a receptive field of K*D samples, time-invariant.

The comb is built by square-and-multiply: with
T_m[t] = sum_{j<m} fb^j x[t - j*D], T_{a+b}[t] = T_a[t] + fb^a T_b[t - a*D],
so T_K takes ~2*log2(K) shifted multiply-adds over K's binary
decomposition, every weight fb^j a host float64 constant rounded once to
float32. The composition tree per output sample depends on K alone, not
on position, array length or chunking, so a streamed render agrees with
the offline one to the last ulp of a partial sum.

The output grows by exactly K*D (the echo tail); streaming keeps an
input-history ring of K*D samples and flushes the tail after input EOF.
Counts are host ints. The JAX module has no sharded function: the sp
planner shards the delay as an LTI node by its declared receptive field
(parallel/sharded.py).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nodey_tpu_torch.core.stream import FMT_FLT, Stream, map_lengths
from nodey_tpu_torch.ops.scans import f32 as _f32, mask_tail

_MAX_ECHOES = 66          # fb clamp 0.9 -> 66 repeats reach -60 dB
_TRUNCATE_DB = 60.0


def delay_params(rate: int, delay_ms: float, feedback: float
                 ) -> Tuple[int, int]:
    """(D, K): the delay lag in samples (>= 1) and the exact echo count
    of the truncated comb."""
    d = max(1, int(round(float(delay_ms) * 1e-3 * rate)))
    fb = float(feedback)
    if fb <= 0.0:
        return d, 1
    k = int(math.ceil(_TRUNCATE_DB / (-20.0 * math.log10(fb))))
    return d, min(max(k, 1), _MAX_ECHOES)


def _shift(x: torch.Tensor, lag: int) -> torch.Tensor:
    """x[t - lag] along the last axis, zeros shifted in from the left."""
    if lag >= x.shape[-1]:
        return torch.zeros_like(x)
    return F.pad(x[..., :-lag], (lag, 0))


def comb_apply(x: torch.Tensor, d: int, k: int, fb: float) -> torch.Tensor:
    """T_K[t] = sum_{j=0..K-1} fb^j x[t - j*D] by square-and-multiply
    over K's binary decomposition (a fixed composition tree per sample)."""
    fb64 = np.float64(fb)
    part = x            # T_p with p = 1
    p = 1
    acc = None          # T_r
    r = 0
    rem = int(k)
    while rem:
        if rem & 1:
            if acc is None:
                acc, r = part, p
            else:
                acc = acc + _f32(fb64 ** r) * _shift(part, r * d)
                r += p
        rem >>= 1
        if rem:
            part = part + _f32(fb64 ** p) * _shift(part, p * d)
            p *= 2
    return acc


def delay_wet(x: torch.Tensor, d: int, k: int, fb: float) -> torch.Tensor:
    """w[t] = sum_{k=1..K} fb^(k-1) x[t - k*D] = T_K shifted by D."""
    return _shift(comb_apply(x, d, k, fb), d)


# -- offline ---------------------------------------------------------------------


def delay_stream(stream: Stream, delay_ms: float, feedback: float,
                 wet: float, dry: float) -> Stream:
    """Offline echo over a whole Stream, one clip or a batch. Output length
    grows by the K*D echo tail when wet > 0 (each clip's by the same
    static tail, as the capacity); padding past the grown length is zero
    by construction, and re-masked."""
    if float(wet) == 0.0:
        out = stream.data if float(dry) == 1.0 else _f32(dry) * stream.data
        return stream.with_data(out, fmt=FMT_FLT)
    d, k = delay_params(stream.rate, delay_ms, feedback)
    tail = k * d
    x = mask_tail(stream.data, stream.length)
    xpad = F.pad(x, (0, tail))
    y = _f32(dry) * xpad + _f32(wet) * delay_wet(xpad, d, k, float(feedback))
    out_len = map_lengths(stream.length, lambda n: n + tail)
    return Stream(
        data=mask_tail(y, out_len), length=out_len, rate=stream.rate,
        channels=stream.channels, fmt=FMT_FLT, t0_us=stream.t0_us,
    )


# -- streaming -------------------------------------------------------------------


def delay_stream_init(channels: int, d: int, k: int, device):
    """(input-history ring [C, K*D], tail remaining): the ring holds the
    last K*D consumed input samples, the node's whole receptive field, so
    each chunk's outputs see exactly the offline context."""
    ring = torch.zeros((channels, k * d), dtype=torch.float32, device=device)
    return (ring, k * d)


def delay_stream_step(params, state, data: torch.Tensor, n: int,
                      in_done: bool):
    """One chunk [C, W] with ``n`` valid. Outputs the chunk's echoes from
    [ring ++ chunk] (the offline render's values and composition tree),
    advances the ring by the emitted count, and after input EOF keeps
    flushing pure tail until K*D extra samples have shipped. Returns
    (state, out, out_n, done)."""
    d, k, fb, wet, dry = params
    ring, rem = state
    w = data.shape[1]
    hist = ring.shape[1]
    x = mask_tail(data, n)
    ext = torch.cat([ring, x], dim=1)                   # [C, K*D + W]
    wet_full = delay_wet(ext, d, k, fb)
    out = _f32(dry) * x + _f32(wet) * wet_full[:, hist:]
    flushing = in_done and n <= 0
    out_n = min(w, rem) if flushing else n
    if flushing:
        rem -= out_n
    out = mask_tail(out, out_n)
    # Advance the ring by the emitted count (== consumed input samples;
    # flush chunks shift in the zeros the tail algebra expects).
    ring = ext[:, out_n:out_n + hist]
    return (ring, rem), out, out_n, in_done and rem <= 0

