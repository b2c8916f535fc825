"""Phaser (port of nodey_tpu.ops.phaser): K cascaded first-order allpass
stages swept by an exact integer-residue LFO (ops/modfx.py).

    s[n]  = 0.5 - 0.5 cos(2 pi turns[n])        exact LFO residues
    f[n]  = f_min * (f_max / f_min)^s[n]        exponential sweep (Hz)
    t[n]  = tan(pi f[n] / rate)
    a[n]  = (t[n] - 1) / (t[n] + 1)             in (-1, 0)
    stage (x K):  y[n] = a[n] x[n] + x[n-1] - a[n] y[n-1]
    out   = dry * x + wet * y_K                 K/2 sweeping notches

The coefficient at sample t is a pure function of the global sample index,
so the offline and the streamed renders compute the same coefficient at
the same position; offline, a batch [B, C, N] shares that one track, and
the scans run over every clip at once (elementwise, no GEMM). Each stage is a first-order recurrence with the
time-varying pole p[n] = -a[n] in (0, 1) and the drive
u[n] = a[n] x[n] + x[n-1]: one ``scans.tv_ar1_scan`` per stage.

Streaming carries per-stage (x_prev, y_prev) columns on the device and the
LFO residue as a host int; a carried y_prev enters through the first
drive sample (u'[0] = u[0] + p[0] y_prev). ``phaser_sharded_local`` runs
over the list of a mesh axis's shards, each stage's state crossing them by
an affine doubling (parallel/tv_sharded.py).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from nodey_tpu_torch.core.stream import FMT_FLT, Stream
from nodey_tpu_torch.ops import modfx
from nodey_tpu_torch.ops.scans import f32 as _f32, mask_tail, tv_ar1_scan


def phaser_spec(sample_rate: int, rate_hz: float, f_min: float,
                f_max: float) -> Tuple[int, int, float, float]:
    """(NUM, M, k0, k1): quantized LFO constants plus the log-sweep
    affine map ln f = k0 + s * k1, with the sweep band clamped inside
    the Nyquist interval for this rate (f in [20 Hz, 0.45 * rate], so
    t = tan(pi f / rate) stays in (0, tan(0.45 pi)) and a in (-1, 1))."""
    num, m = modfx.lfo_quantize(rate_hz, sample_rate)
    fmin = min(max(float(f_min), 20.0), 0.40 * sample_rate)
    fmax = min(max(float(f_max), fmin), 0.45 * sample_rate)
    k0 = math.log(fmin)
    k1 = math.log(fmax / fmin)
    return num, m, k0, k1


def phaser_coeffs(r0: int, width: int, num: int, m: int, k0: float,
                  k1: float, rate: int, device) -> torch.Tensor:
    """f32 allpass coefficient track a[i] (< 0) for global positions
    r0 + i, i in [0, width), from exact integer phase residues."""
    s = modfx._cos_sweep(modfx.lfo_turns(r0, width, num, m, device))
    f = torch.exp(_f32(k0) + s * _f32(k1))
    t = torch.tan(_f32(math.pi / rate) * f)
    return (t - _f32(1.0)) / (t + _f32(1.0))


def _shift1(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """x delayed one sample along the last axis; ``head`` [..., C, 1]
    fills position 0 (zeros offline, the carried x_prev when
    streaming)."""
    return torch.cat([head, x[..., :-1]], dim=-1)


def phaser_apply(x: torch.Tensor, a: torch.Tensor, stages: int, wet: float,
                 dry: float, x_prev=None, y_prev=None):
    """The K-stage cascade over one window ``x`` [C, W], or a batch's [B,
    C, W] offline, with coefficient track ``a`` [W]. ``x_prev``/``y_prev``
    [K, C] are the per-stage carries of a stream (zeros when None).
    Returns (out, the stages' inputs, the stages' outputs): gather the
    column a carry needs from those."""
    p = -a
    xs, ys = [], []
    cur = x
    for k in range(stages):
        head = (x.new_zeros(x.shape[:-1] + (1,)) if x_prev is None
                else x_prev[k][:, None])
        u = a[None, :] * cur + _shift1(cur, head)
        if y_prev is not None:
            # Fold the carried state into the first drive sample: the
            # recurrence y[0] = p[0] y_prev + u[0] is exactly a scan
            # with u'[0] = u[0] + p[0] * y_prev.
            u[:, 0] += p[0] * y_prev[k]
        xs.append(cur)
        _, cur = tv_ar1_scan(u, p)
        ys.append(cur)
    out = _f32(dry) * x + _f32(wet) * cur
    return out, xs, ys


def phaser_stream(stream: Stream, rate_hz: float, f_min: float,
                  f_max: float, stages: int, wet: float,
                  dry: float) -> Stream:
    """Offline phaser over a whole Stream (phase 0 and empty allpass
    state at stream sample 0; length-preserving)."""
    num, m, k0, k1 = phaser_spec(stream.rate, rate_hz, f_min, f_max)
    x = mask_tail(stream.data, stream.length)
    a = phaser_coeffs(0, stream.capacity, num, m, k0, k1, stream.rate,
                      x.device)
    out, _, _ = phaser_apply(x, a, stages, wet, dry)
    return stream.with_data(mask_tail(out, stream.length), fmt=FMT_FLT)


# -- streaming -------------------------------------------------------------------


def phaser_stream_init(channels: int, stages: int, device):
    """Carry: per-stage previous input/output columns [K, C] each, plus
    the LFO phase residue at the next sample (a host int)."""
    return (
        torch.zeros((stages, channels), dtype=torch.float32, device=device),
        torch.zeros((stages, channels), dtype=torch.float32, device=device),
        0,
    )


def phaser_stream_step(params, state, data: torch.Tensor, n: int):
    """One chunk [C, W], n valid. Length-preserving (out_n == n). The
    new per-stage carries gather at column n-1 (the last VALID sample);
    an all-padding chunk (n == 0) leaves the state untouched."""
    num, m, k0, k1, rate, stages, wet, dry = params
    x_prev, y_prev, r0 = state
    w = data.shape[1]
    x = mask_tail(data, n)
    a = phaser_coeffs(r0, w, num, m, k0, k1, rate, x.device)
    out, xs, ys = phaser_apply(x, a, stages, wet, dry, x_prev=x_prev,
                               y_prev=y_prev)
    out = mask_tail(out, n)
    if n <= 0:
        return (x_prev, y_prev, r0), out
    new_x = torch.stack([cur[:, n - 1] for cur in xs])
    new_y = torch.stack([y[:, n - 1] for y in ys])
    return (new_x, new_y, modfx.advance_residue(r0, n, num, m)), out


# -- sharded (sp chain) local step --------------------------------------------------


def _affine_prefix_exclusive(p_ends, v_ends):
    """The state entering each shard: the exclusive cross-shard prefix of
    the shards' affine summaries (P_i, V_i) of a recurrence that starts at
    zero. Inclusive Hillis-Steele doubling over ``ppermute`` (the received
    summary the EARLIER operand of (Pa, Va) . (Pb, Vb) = (Pa Pb, Vb + Pb
    Va)), the products moving beside the values; ``ppermute``'s zeros are
    not the affine identity, so a shard combines at step d only if its
    index is >= d."""
    from nodey_tpu_torch.parallel.ops import ppermute

    sp = len(p_ends)
    pv, vv = list(p_ends), list(v_ends)
    d = 1
    while d < sp:
        perm = [(i, i + d) for i in range(sp - d)]
        pr, vr = ppermute(pv, perm), ppermute(vv, perm)
        for i in range(d, sp):
            pv[i], vv[i] = pr[i] * pv[i], vv[i] + pv[i] * vr[i]
        d *= 2
    prev = ppermute(vv, [(i, i + 1) for i in range(sp - 1)])
    prev[0] = torch.zeros_like(prev[0])
    return prev


def phaser_sharded_local(xs, length: int, rate_hz: float, f_min: float,
                         f_max: float, stages: int, wet: float, dry: float,
                         sample_rate: int):
    """The phaser over the shards ``xs`` ([C, chunk] each) of one mesh
    axis: each shard's coefficient track from its global offset, a
    one-sample left halo per stage for x[n-1], local scans from zero and
    the exclusive affine prefix folding each stage's entering state in
    through the local pole products; masked to the global ``length``."""
    from nodey_tpu_torch.parallel.ops import halo_exchange_nd

    num, m, k0, k1 = phaser_spec(sample_rate, rate_hz, f_min, f_max)
    chunk = xs[0].shape[-1]
    a = [phaser_coeffs(modfx.shard_residue(num, m, chunk, i), chunk, num, m,
                       k0, k1, sample_rate, x.device)
         for i, x in enumerate(xs)]
    cur = list(xs)
    for _ in range(stages):
        scanned = []
        for c, e, ai in zip(cur, halo_exchange_nd(cur, 1, 0), a):
            u = ai[None, :] * c + e[:, :chunk]
            scanned.append(tv_ar1_scan(u, -ai))
        s_in = _affine_prefix_exclusive([pc[:, -1] for pc, _ in scanned],
                                        [y0[:, -1] for _, y0 in scanned])
        cur = [y0 + pc * s[:, None] for (pc, y0), s in zip(scanned, s_in)]
    return [mask_tail(_f32(dry) * x + _f32(wet) * y, length - i * chunk)
            for i, (x, y) in enumerate(zip(xs, cur))]
