"""Biquad IIR filtering (port of nodey_tpu.ops.biquad): second-order
sections as first-order scans (ops/scans.py).

A biquad y[n] = b0 x[n] + b1 x[n-1] + b2 x[n-2] - a1 y[n-1] - a2 y[n-2]
runs by its pole structure, so no growing matrix product is formed:

* **complex pole pair** (a1^2 < 4 a2, every Q > 0.5 design): the state
  recurrence diagonalizes to ONE complex first-order scan
  m[n] = p m[n-1] + g x[n], and y[n] = b0 x[n] + 2 Re(m[n-1]). The scan
  runs on split re/im float32 tensors; the complex algebra (p, g) is done
  on the host in complex128.
* **real poles** (a1^2 >= 4 a2, Q <= 0.5 designs): FIR(3) then two
  cascaded real AR(1) scans, well conditioned even for repeated poles.

Coefficients follow the RBJ Audio EQ Cookbook in float64 on the host,
rounded once to float32 (``BiquadCoef.f32``), exactly as the JAX package
designs them; the branch is chosen on the rounded values.

Streaming carries one (re, im) pair per channel for a modal section, the
FIR tail and two real scalars for a real one. ``cascade_stream_prepare``
puts the sections' pole tables for a chunk width on the device at plan
time; a chunk step (``cascade_stream_step``) then copies nothing from the
host and waits on nothing: its valid count is a host int. The sharded
cascade (``cascade_sharded_local``) runs over the list of a mesh axis's
shards: local scans, exact cross-shard carries (parallel/tv_sharded.py).

The offline cascade also takes a batch of clips, ``[B, C, N]`` with one
host length a clip: the scans' passes run on all clips, their GEMMs clip
by clip (``scans._gemm``), and each clip is re-masked past its own length.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nodey_tpu_torch.core.stream import FMT_FLT, Stream
from nodey_tpu_torch.ops import scans
from nodey_tpu_torch.ops.scans import f32 as _f32, mask_tail


@dataclasses.dataclass(frozen=True)
class BiquadCoef:
    """Normalized (a0 = 1) biquad coefficients, float64 by design."""

    b0: float
    b1: float
    b2: float
    a1: float
    a2: float

    def f32(self) -> "BiquadCoef":
        """The coefficients the device program actually uses."""
        return BiquadCoef(*(float(np.float32(v)) for v in (
            self.b0, self.b1, self.b2, self.a1, self.a2
        )))


# -- RBJ cookbook designs (float64, host) ------------------------------------


def _wq(freq: float, rate: int, q: float) -> Tuple[float, float, float]:
    f0 = min(max(float(freq), 1.0), 0.49 * rate)
    w0 = 2.0 * math.pi * f0 / rate
    alpha = math.sin(w0) / (2.0 * max(float(q), 1e-3))
    return w0, math.cos(w0), alpha


def _norm(b0, b1, b2, a0, a1, a2) -> BiquadCoef:
    return BiquadCoef(b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0)


def peaking(freq: float, gain_db: float, q: float, rate: int) -> BiquadCoef:
    A = 10.0 ** (gain_db / 40.0)
    _w0, cosw, alpha = _wq(freq, rate, q)
    return _norm(
        1 + alpha * A, -2 * cosw, 1 - alpha * A,
        1 + alpha / A, -2 * cosw, 1 - alpha / A,
    )


def low_shelf(freq: float, gain_db: float, rate: int) -> BiquadCoef:
    A = 10.0 ** (gain_db / 40.0)
    w0, cosw, _ = _wq(freq, rate, 1.0)
    # RBJ shelf slope S = 1: alpha = sin(w0)/2 * sqrt((A+1/A)(1/S-1)+2).
    alpha = math.sin(w0) / 2.0 * math.sqrt(2.0)
    sq = 2.0 * math.sqrt(A) * alpha
    return _norm(
        A * ((A + 1) - (A - 1) * cosw + sq),
        2 * A * ((A - 1) - (A + 1) * cosw),
        A * ((A + 1) - (A - 1) * cosw - sq),
        (A + 1) + (A - 1) * cosw + sq,
        -2 * ((A - 1) + (A + 1) * cosw),
        (A + 1) + (A - 1) * cosw - sq,
    )


def high_shelf(freq: float, gain_db: float, rate: int) -> BiquadCoef:
    A = 10.0 ** (gain_db / 40.0)
    w0, cosw, _ = _wq(freq, rate, 1.0)
    alpha = math.sin(w0) / 2.0 * math.sqrt(2.0)  # S = 1
    sq = 2.0 * math.sqrt(A) * alpha
    return _norm(
        A * ((A + 1) + (A - 1) * cosw + sq),
        -2 * A * ((A - 1) + (A + 1) * cosw),
        A * ((A + 1) + (A - 1) * cosw - sq),
        (A + 1) - (A - 1) * cosw + sq,
        2 * ((A - 1) - (A + 1) * cosw),
        (A + 1) - (A - 1) * cosw - sq,
    )


def lowpass(freq: float, q: float, rate: int) -> BiquadCoef:
    _w0, cosw, alpha = _wq(freq, rate, q)
    return _norm(
        (1 - cosw) / 2, 1 - cosw, (1 - cosw) / 2,
        1 + alpha, -2 * cosw, 1 - alpha,
    )


def highpass(freq: float, q: float, rate: int) -> BiquadCoef:
    _w0, cosw, alpha = _wq(freq, rate, q)
    return _norm(
        (1 + cosw) / 2, -(1 + cosw), (1 + cosw) / 2,
        1 + alpha, -2 * cosw, 1 - alpha,
    )


def bandpass(freq: float, q: float, rate: int) -> BiquadCoef:
    """Constant 0 dB peak gain bandpass."""
    _w0, cosw, alpha = _wq(freq, rate, q)
    return _norm(alpha, 0.0, -alpha, 1 + alpha, -2 * cosw, 1 - alpha)


def notch(freq: float, q: float, rate: int) -> BiquadCoef:
    _w0, cosw, alpha = _wq(freq, rate, q)
    return _norm(1.0, -2 * cosw, 1.0, 1 + alpha, -2 * cosw, 1 - alpha)


# -- section analysis (host) --------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Section:
    """One biquad prepared for execution: f32-rounded coefficients plus
    the pole structure that picks the scan formulation."""

    coef: BiquadCoef          # f32-rounded
    conj: bool                # complex conjugate pole pair?
    # conj: mode pole p and modal input gain g (complex128 host values).
    p: complex
    g: complex
    # real: the two real poles (p, p2), FIR taps are coef.b*.
    p2: complex


def prepare(coef: BiquadCoef) -> Section:
    c = coef.f32()
    disc = c.a1 * c.a1 - 4.0 * c.a2
    if disc < 0.0:
        sq = complex(0.0, math.sqrt(-disc))
        p1 = (-c.a1 + sq) / 2.0
        p2 = (-c.a1 - sq) / 2.0
        # s[n] = A s[n-1] + u x[n] with A = [[-a1, 1], [-a2, 0]],
        # u = (b1 - a1 b0, b2 - a2 b0); eigenvectors (1, p + a1), so
        # V = [[1, 1], [-p2, -p1]], det = p2 - p1, and the mode-1 input
        # gain is g = (-p1 u1 - u2) / (p2 - p1). y = b0 x + 2 Re(m1').
        u1 = c.b1 - c.a1 * c.b0
        u2 = c.b2 - c.a2 * c.b0
        g = (-p1 * u1 - u2) / (p2 - p1)
        return Section(coef=c, conj=True, p=p1, g=g, p2=p2)
    sq = math.sqrt(disc)
    p1 = (-c.a1 + sq) / 2.0
    p2 = (-c.a1 - sq) / 2.0
    return Section(coef=c, conj=False, p=complex(p1), g=0j,
                   p2=complex(p2))


def prepare_all(coeffs: List[BiquadCoef]) -> List[Section]:
    return [prepare(c) for c in coeffs]


def _real_poles(sec: Section) -> Tuple[float, float]:
    """A real section's two poles as the float32 values its scans take."""
    return _f32(sec.p.real), _f32(sec.p2.real)


def _fir3(x: torch.Tensor, b0: float, b1: float, b2: float,
          h: torch.Tensor | None = None) -> torch.Tensor:
    """w[n] = b0 x[n] + b1 x[n-1] + b2 x[n-2]; ``h`` = the two samples
    before x[..., 0] as [..., 2] (zeros if None)."""
    ext = F.pad(x, (2, 0)) if h is None else torch.cat([h, x], dim=-1)
    return (_f32(b0) * ext[..., 2:] + _f32(b1) * ext[..., 1:-1]
            + _f32(b2) * ext[..., :-2])


def _inject(mr, mi, mp_r, mp_i, pole, n: int):
    """m + p^(k+1) * m_prev for k = 0..n-1, on split re/im planes."""
    pw_r, pw_i = scans.device_powers(pole, n, mr.device)
    mp_r, mp_i = mp_r[..., None], mp_i[..., None]
    return (mr + pw_r * mp_r - pw_i * mp_i,
            mi + pw_i * mp_r + pw_r * mp_i)


# -- apply (offline) ------------------------------------------------------------


def _sec_init_state(sec: Section, channels: int, device: torch.device):
    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    if sec.conj:
        return zeros(channels, 2)                # modal carry (re, im)
    return (zeros(channels, 2),                  # FIR history
            zeros(channels),                     # t carry
            zeros(channels))                     # y carry


def _sec_apply(x: torch.Tensor, sec: Section, state, clips: bool = False):
    """Filter [C, N] (or, with ``clips``, a batch [B, C, N]) through one
    section from ``state`` (None = silence history; the init-carry scans
    are skipped entirely); returns (y, new_state)."""
    c = sec.coef
    n = x.shape[-1]
    if sec.conj:
        mr, mi = scans.rot_scan(_f32(sec.g.real) * x, _f32(sec.g.imag) * x,
                                sec.p, clips)
        if state is None:
            mp_r = x.new_zeros(x.shape[:-1])
        else:
            mp_r = state[..., 0]
            mr, mi = _inject(mr, mi, mp_r, state[..., 1], sec.p, n)
        m_excl_r = torch.cat([mp_r[..., None], mr[..., :-1]], dim=-1)
        y = _f32(c.b0) * x + 2.0 * m_excl_r
        return y, torch.stack([mr[..., -1], mi[..., -1]], dim=-1)
    h, t_prev, y_prev = state if state is not None else (None,) * 3
    p1, p2 = _real_poles(sec)
    w = _fir3(x, c.b0, c.b1, c.b2, h)
    t = scans.ar1_scan(w, p1, clips)
    if t_prev is not None:
        t = t + scans.device_powers(sec.p, n, x.device)[0] * t_prev[..., None]
    y = scans.ar1_scan(t, p2, clips)
    if y_prev is not None:
        y = y + scans.device_powers(sec.p2, n, x.device)[0] * y_prev[..., None]
    new_h = (torch.cat([h, x], dim=-1) if h is not None else x)[..., -2:]
    return y, (new_h, t[..., -1], y[..., -1])


def cascade_apply(x: torch.Tensor, sections: List[Section], states=None,
                  clips: bool = False):
    """Apply a section cascade to [C, N] (or, with ``clips``, a batch [B,
    C, N]: the scans' GEMMs clip by clip); returns (y, [new_state per
    section])."""
    new_states = []
    for i, sec in enumerate(sections):
        st = None if states is None else states[i]
        x, s = _sec_apply(x, sec, st, clips)
        new_states.append(s)
    return x, new_states


def cascade_stream(stream: Stream, sections: List[Section]) -> Stream:
    """Offline cascade over a whole Stream. The filter tail past the
    valid length rings into the padding, so the output is re-masked: the
    Stream invariant (zeros at index >= length) holds downstream."""
    if not sections:
        return stream
    out, _ = cascade_apply(stream.data, sections,
                           clips=stream.batch is not None)
    return stream.with_data(mask_tail(out, stream.length), fmt=FMT_FLT)


# -- streaming -----------------------------------------------------------------


def cascade_stream_init(channels: int, sections: List[Section],
                        device: torch.device):
    return tuple(_sec_init_state(s, channels, device) for s in sections)


def cascade_stream_prepare(sections: List[Section], width: int,
                           device: torch.device) -> None:
    """Put on ``device`` every pole table a chunk step of ``width``
    samples reads, so the step copies nothing from the host."""
    for sec in sections:
        if sec.conj:
            scans.prepare(sec.p, width, device, powers=True)
            continue
        # The scans take the float32-rounded real poles; the carries
        # inject with the powers of the unrounded ones.
        for p in _real_poles(sec):
            scans.prepare(p, width, device)
        scans.device_powers(sec.p, width, device)
        scans.device_powers(sec.p2, width, device)


def cascade_stream_step(sections: List[Section], state, data: torch.Tensor,
                        n: int):
    """One chunk [C, W] with ``n`` valid samples (a host int). Invalid
    tail samples do not advance any carry (each is taken at sample n-1),
    so streamed output equals the offline render up to scan
    re-association."""
    width = data.shape[1]
    x = mask_tail(data, n)
    last = min(max(n - 1, 0), width - 1)
    new_states = []
    for i, sec in enumerate(sections):
        c = sec.coef
        if sec.conj:
            mp = state[i]                                     # [C, 2]
            mp_r = mp[:, 0]
            mr, mi = scans.rot_scan(_f32(sec.g.real) * x,
                                    _f32(sec.g.imag) * x, sec.p)
            mr, mi = _inject(mr, mi, mp_r, mp[:, 1], sec.p, width)
            m_excl_r = torch.cat([mp_r[:, None], mr[:, :-1]], dim=-1)
            x = _f32(c.b0) * x + 2.0 * m_excl_r
            new_states.append(torch.stack([mr[:, last], mi[:, last]], dim=-1)
                              if n > 0 else mp)
        else:
            h, t_prev, y_prev = state[i]
            p1, p2 = _real_poles(sec)
            w = _fir3(x, c.b0, c.b1, c.b2, h)
            t = scans.ar1_scan(w, p1) + scans.device_powers(
                sec.p, width, x.device)[0] * t_prev[:, None]
            y = scans.ar1_scan(t, p2) + scans.device_powers(
                sec.p2, width, x.device)[0] * y_prev[:, None]
            if n > 0:
                # FIR history at the valid boundary: samples n-2, n-1.
                ext = torch.cat([h, x], dim=-1)
                new_states.append((ext[:, last + 1:last + 3].clone(),
                                   t[:, last].clone(), y[:, last].clone()))
            else:
                new_states.append((h, t_prev, y_prev))
            x = y
    # Re-mask the invalid tail (the filter rings past sample n-1; chunk
    # padding must stay zero for downstream consumers).
    return tuple(new_states), mask_tail(x, n)


# -- sharding ------------------------------------------------------------------
#
# The sp chain's cascade (parallel/tv_sharded.py): every function below
# takes the list of the shards' equal [C, chunk] time slices along one mesh
# axis (index = position on the axis) and returns theirs. Each section's
# first-order scans run locally from silence, and their carries cross the
# shards by exclusive AR(1) prefixes with host pole-power weights.


def _cross_shard_ar1(v_ends, pole_chunk_pows, zero: float = 0.0):
    """Exclusive cross-shard prefix of an AR(1) carry: shard i receives the
    state at the END of shard i-1 (``zero`` on shard 0: the clip starts in
    silence). ``pole_chunk_pows[k]`` is p^(2^k * chunk) (host, float32).
    Hillis-Steele doubling over ``ppermute``; a shard combines at step d
    only if its index is >= d. Only the [C] state moves."""
    from nodey_tpu_torch.parallel.ops import ppermute

    sp = len(v_ends)
    v = list(v_ends)
    d, k = 1, 0
    while d < sp:
        r = ppermute(v, [(i, i + d) for i in range(sp - d)])
        v = v[:d] + [r[i] * pole_chunk_pows[k] + v[i] for i in range(d, sp)]
        d *= 2
        k += 1
    prev = ppermute(v, [(i, i + 1) for i in range(sp - 1)])
    prev[0] = torch.full_like(prev[0], zero)
    return prev


def _chunk_pows(p: complex, chunk: int, sp: int):
    """[p^(chunk), p^(2*chunk), p^(4*chunk), ...] in host complex128 (the
    doubling's static weights)."""
    out = []
    d = 1
    while d < sp:
        out.append(np.complex128(complex(p)) ** (d * chunk))
        d *= 2
    return out or [np.complex128(0)]


def _cross_shard_ar1_rot(v_ends, pole_chunk_pows):
    """``_cross_shard_ar1`` for the modal (complex) carry held as [C, 2]
    (re, im) float32: the host complex128 weights apply as real
    rotation-scales."""
    from nodey_tpu_torch.parallel.ops import ppermute

    sp = len(v_ends)
    v = list(v_ends)
    d, k = 1, 0
    while d < sp:
        r = ppermute(v, [(i, i + d) for i in range(sp - d)])
        wr = _f32(pole_chunk_pows[k].real)
        wi = _f32(pole_chunk_pows[k].imag)
        for i in range(d, sp):
            rot = torch.stack([r[i][:, 0] * wr - r[i][:, 1] * wi,
                               r[i][:, 0] * wi + r[i][:, 1] * wr], dim=-1)
            v[i] = rot + v[i]
        d *= 2
        k += 1
    prev = ppermute(v, [(i, i + 1) for i in range(sp - 1)])
    prev[0] = torch.zeros_like(prev[0])
    return prev


def cascade_sharded_local(xs, sections: List[Section]):
    """The cascade over the shards ``xs`` ([C, chunk] each) of one mesh
    axis. Per section: the modal branch scans locally and moves one (re,
    im) pair per channel across shards; the real branch takes its FIR
    history as a 2-sample halo from the left neighbor and crosses two real
    scalars in two dependent rounds (t feeds y)."""
    from nodey_tpu_torch.parallel.ops import halo_exchange_nd

    sp = len(xs)
    chunk = xs[0].shape[-1]
    xs = list(xs)
    for sec in sections:
        c = sec.coef
        if sec.conj:
            local = [scans.rot_scan(_f32(sec.g.real) * x,
                                    _f32(sec.g.imag) * x, sec.p) for x in xs]
            mps = _cross_shard_ar1_rot(
                [torch.stack([mr[:, -1], mi[:, -1]], dim=-1)
                 for mr, mi in local], _chunk_pows(sec.p, chunk, sp))
            for i, ((mr_l, _mi_l), mp) in enumerate(zip(local, mps)):
                pw_r, pw_i = scans.device_powers(sec.p, chunk, mp.device)
                mp_r, mp_i = mp[:, 0], mp[:, 1]
                mr = mr_l + pw_r * mp_r[:, None] - pw_i * mp_i[:, None]
                m_excl_r = torch.cat([mp_r[:, None], mr[:, :-1]], dim=-1)
                xs[i] = _f32(c.b0) * xs[i] + 2.0 * m_excl_r
            continue
        p1, p2 = _real_poles(sec)
        exts = halo_exchange_nd(xs, 2, 0)
        t_local = [scans.ar1_scan(_fir3(x, c.b0, c.b1, c.b2, h=e[..., :2]),
                                  p1) for x, e in zip(xs, exts)]
        t_prev = _cross_shard_ar1(
            [t[:, -1] for t in t_local],
            [_f32(pw.real) for pw in _chunk_pows(sec.p, chunk, sp)])
        ts = [t + scans.device_powers(sec.p, chunk, t.device)[0] * tp[:, None]
              for t, tp in zip(t_local, t_prev)]
        y_local = [scans.ar1_scan(t, p2) for t in ts]
        y_prev = _cross_shard_ar1(
            [y[:, -1] for y in y_local],
            [_f32(pw.real) for pw in _chunk_pows(sec.p2, chunk, sp)])
        xs = [y + scans.device_powers(sec.p2, chunk, y.device)[0]
              * yp[:, None] for y, yp in zip(y_local, y_prev)]
    return xs
