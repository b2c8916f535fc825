"""Constant-coefficient first-order scans (port of nodey_tpu.ops.scans).

Every recurrence of the master-bus nodes (the biquad sections of
ops/biquad.py, the compressor's one-pole attack smoother and the
limiter's release envelope in ops/dynamics.py) is a first-order
recurrence with CONSTANT coefficients, so every scan weight is computed
on the host in float64/complex128 (the same numpy code as the JAX
package, rounded to float32 at the same point) and only the scan's
passes run on the device. Two formulations of each primitive:

* ``doubling`` — Hillis-Steele with host-exact step weights: log2(N)
  rounds, each a full pass over the array. Below ``_BLOCK_THRESHOLD``.

* ``blocked`` — reshape [..., N] -> [..., B, W]: the in-block inclusive
  scan is a dense [.., W] x [W, W] upper-triangular pole-power GEMM in
  full float32 (TF32 off, ``float32_matmul_precision`` "highest",
  checked where the GEMMs run), the block carries cross in a doubling
  over the [.., B] block ends, and the exclusive carry injects in one
  pass with host pole-power vectors. The max-plus primitive has no GEMM
  semiring: its blocked form is two-level doubling.

The forms differ only in float32 re-association. The JAX package's
``NODEY_SCAN_FORM`` switch is not ported (the forms are called directly
where a test needs one).

``tv_ar1_scan`` (the phaser's) has a TIME-VARYING pole, so no scan weight
is host-computable: it composes affine maps (P, V) by doubling on the
device, with the pole products carried beside the values.

No complex dtype reaches the device: the complex modal scan runs on split
re/im float32 planes with the complex algebra done on the host.

A batch of clips (``clips``: the first axis holds them) runs every pass
on all clips at once but the blocked GEMMs, which go clip by clip on one
clip's shapes: a GEMM's per-row bits depend on its row count (MKL's and
cuBLAS's kernel choice), and each clip must stay bitwise its single
render.

Host tables are cached on the device per (pole, width, device)
(``_device_powers``, ``_device_table``): an eager port would otherwise
recompute them on every call, and a chunk step would copy them to the
card inside the step. ``prepare`` fills the cache for a width at plan
time, so a streamed step finds every table in place and never waits on a
host copy.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from nodey_tpu_torch.core.stream import map_lengths, zero_tail

_W = 256                  # block width: [.., W] x [W, W] GEMM tiles
_BLOCK_THRESHOLD = 2048   # auto: doubling below, blocked at/above
_NEG = np.float32(-3.0e38)  # effective max identity (floored log domain)


def f32(v: float) -> float:
    """``v`` rounded to float32, as a Python float: a scalar torch's float32
    kernels take unchanged, as the JAX code's ``np.float32`` scalars."""
    return float(np.float32(v))


def mask_tail(x: torch.Tensor, n) -> torch.Tensor:
    """``x`` with every sample at index >= ``n`` along the last axis set to
    zero (a new tensor, unless nothing is masked); for a batch ``x`` [B, C,
    N], ``n`` is the clips' lengths (a tuple) and each clip is masked past
    its own."""
    n = map_lengths(n, lambda m: max(m, 0))
    if np.min(n) >= x.shape[-1]:
        return x
    return zero_tail(x.clone(), n)


def _form(n: int) -> str:
    if n < 2 * _W:        # blocked needs enough blocks to pay for itself
        return "doubling"
    return "blocked" if n >= _BLOCK_THRESHOLD else "doubling"


# -- host-side pole powers ------------------------------------------------------


def pole_powers(p: complex, n: int):
    """[p^1, ..., p^n] in host complex128 (exact-ish decay curves),
    split into (re, im) f32 arrays."""
    with np.errstate(under="ignore"):
        vals = np.power(np.complex128(complex(p)),
                        np.arange(1, n + 1, dtype=np.float64))
    return vals.real.astype(np.float32), vals.imag.astype(np.float32)


def _pow_table(p: complex, w: int) -> np.ndarray:
    """Upper-triangular [W, W] complex128 table U[j, i] = p^(i-j) for
    i >= j, 0 below — the in-block scan as a dense matrix."""
    e = np.arange(w)[None, :] - np.arange(w)[:, None]
    with np.errstate(under="ignore"):
        vals = np.power(np.complex128(complex(p)), np.maximum(e, 0))
    return np.where(e >= 0, vals, 0.0)


@functools.lru_cache(maxsize=64)
def _device_powers(p: complex, n: int, device: torch.device):
    """``pole_powers(p, n)`` as two float32 tensors on ``device``."""
    re, im = pole_powers(p, n)
    return (torch.from_numpy(re).to(device), torch.from_numpy(im).to(device))


@functools.lru_cache(maxsize=64)
def _device_table(p: complex, w: int, device: torch.device):
    """``_pow_table(p, w)``'s (re, im) float32 planes on ``device``."""
    table = _pow_table(p, w)
    return (torch.from_numpy(table.real.astype(np.float32)).to(device),
            torch.from_numpy(table.imag.astype(np.float32)).to(device))


def device_powers(p: complex, n: int, device: torch.device):
    """The (re, im) float32 pole powers p^1..p^n on ``device``, cached."""
    return _device_powers(complex(p), int(n), torch.device(device))


def prepare(p: complex, n: int, device: torch.device,
            powers: bool = False) -> None:
    """Put every host table a scan of width ``n`` with pole ``p`` reads on
    ``device`` now (``powers``: also the width-``n`` pole powers a carry
    injects with), so later calls at that width copy nothing."""
    device = torch.device(device)
    if _form(n) == "blocked":
        _device_table(complex(p), _W, device)
        _device_powers(complex(p), _W, device)
    if powers:
        _device_powers(complex(p), int(n), device)


def _blocks(x: torch.Tensor, w: int):
    """Pad the last axis to a multiple of ``w`` and reshape to
    [..., B, w]; returns (blocks, B, original n)."""
    n = x.shape[-1]
    b = -(-n // w)
    padn = b * w - n
    if padn:
        x = F.pad(x, (0, padn))
    return x.reshape(x.shape[:-1] + (b, w)), b, n


def _shift(t: torch.Tensor, d: int, value: float = 0.0) -> torch.Tensor:
    """``t`` moved ``d`` places right along the last axis, ``value`` in."""
    return F.pad(t[..., :-d], (d, 0), value=value)


def _gemm(v: torch.Tensor, m: torch.Tensor,
          clips: bool = False) -> torch.Tensor:
    """[..., B, W] x [W, W] in full float32 (the JAX package's
    precision=HIGHEST): TF32 must be off. With ``clips``, ``v``'s first
    axis holds a batch's clips and each clip's GEMM runs on a single
    clip's shapes, into its slice of the output."""
    precision = torch.get_float32_matmul_precision()
    if precision != "highest":
        raise RuntimeError(
            "the scan GEMMs need full float32 matmuls; "
            f"float32_matmul_precision is {precision!r}")
    if not clips:
        return torch.matmul(v, m)
    out = v.new_empty(v.shape[:-1] + m.shape[-1:])
    for clip, dst in zip(v, out):
        torch.matmul(clip, m, out=dst)
    return out


# -- AR(1): t[n] = p t[n-1] + x[n], zero init -----------------------------------


def _ar1_doubling(x: torch.Tensor, pole) -> torch.Tensor:
    n = x.shape[-1]
    p = np.complex128(complex(pole))
    t = x
    d = 1
    while d < n:
        w = f32((p ** d).real)
        t = t + w * _shift(t, d)
        d *= 2
    return t


def _ar1_blocked(x: torch.Tensor, pole, clips: bool = False) -> torch.Tensor:
    xb, b, n = _blocks(x, _W)
    u = _device_table(complex(pole), _W, x.device)[0]
    t = _gemm(xb, u, clips)
    # Exclusive block-carry prefix (tiny: [.., B]) with step weight p^W.
    p_w = np.complex128(complex(pole)) ** _W
    s = t[..., -1]
    d = 1
    while d < b:
        s = s + f32((p_w ** d).real) * _shift(s, d)
        d *= 2
    excl = _shift(s, 1)
    powv = _device_powers(complex(pole), _W, x.device)[0]
    t = t + powv * excl[..., None]
    return t.reshape(t.shape[:-2] + (b * _W,))[..., :n]


def ar1_scan(x: torch.Tensor, pole, clips: bool = False) -> torch.Tensor:
    """Inclusive t[n] = pole * t[n-1] + x[n] with zero init along the
    last axis (real pole, f32 x); ``clips``: x's first axis is a batch's
    clips (``_gemm``)."""
    if _form(x.shape[-1]) == "blocked":
        return _ar1_blocked(x, pole, clips)
    return _ar1_doubling(x, pole)


# -- complex AR(1) on split re/im pairs ------------------------------------------


def _rot_doubling(xr: torch.Tensor, xi: torch.Tensor, pole):
    n = xr.shape[-1]
    p = np.complex128(complex(pole))
    tr, ti = xr, xi
    d = 1
    while d < n:
        w = p ** d
        wr = f32(w.real)
        wi = f32(w.imag)
        sr = _shift(tr, d)
        si = _shift(ti, d)
        tr, ti = tr + wr * sr - wi * si, ti + wi * sr + wr * si
        d *= 2
    return tr, ti


def _rot_blocked(xr: torch.Tensor, xi: torch.Tensor, pole,
                 clips: bool = False):
    xrb, b, n = _blocks(xr, _W)
    xib, _, _ = _blocks(xi, _W)
    ur, ui = _device_table(complex(pole), _W, xr.device)
    tr = _gemm(xrb, ur, clips) - _gemm(xib, ui, clips)
    ti = _gemm(xrb, ui, clips) + _gemm(xib, ur, clips)
    # Exclusive block-carry prefix: rotation doubling over [.., B].
    p_w = np.complex128(complex(pole)) ** _W
    sr, si = tr[..., -1], ti[..., -1]
    d = 1
    while d < b:
        w = p_w ** d
        wr = f32(w.real)
        wi = f32(w.imag)
        hr = _shift(sr, d)
        hi = _shift(si, d)
        sr, si = sr + wr * hr - wi * hi, si + wi * hr + wr * hi
        d *= 2
    er = _shift(sr, 1)[..., None]
    ei = _shift(si, 1)[..., None]
    pw_r, pw_i = _device_powers(complex(pole), _W, xr.device)
    tr = tr + pw_r * er - pw_i * ei
    ti = ti + pw_i * er + pw_r * ei
    shape = tr.shape[:-2] + (b * _W,)
    return tr.reshape(shape)[..., :n], ti.reshape(shape)[..., :n]


def rot_scan(xr: torch.Tensor, xi: torch.Tensor, pole, clips: bool = False):
    """The complex modal scan m[n] = p m[n-1] + x[n] on split re/im f32
    tensors; ``clips`` as for ``ar1_scan``."""
    if _form(xr.shape[-1]) == "blocked":
        return _rot_blocked(xr, xi, pole, clips)
    return _rot_doubling(xr, xi, pole)


# -- max-plus: env[n] = max(a[n], env[n-1] - c) ----------------------------------


def _maxplus_doubling(a: torch.Tensor, c: float) -> torch.Tensor:
    n = a.shape[-1]
    t = a
    d = 1
    while d < n:
        t = torch.maximum(
            t, _shift(t, d, float(_NEG)) - f32(float(c) * d))
        d *= 2
    return t


def _maxplus_blocked(a: torch.Tensor, c: float) -> torch.Tensor:
    # _blocks zero-pads, and 0.0 is not the max-plus identity — but the pad
    # only occupies indices >= n, which are sliced off, and a causal scan
    # never reads rightward, so the pad cannot reach a kept output.
    t, b, n = _blocks(a, _W)
    d = 1
    while d < _W:
        t = torch.maximum(
            t, _shift(t, d, float(_NEG)) - f32(float(c) * d))
        d *= 2
    # Exclusive block-carry prefix over [.., B] (decrement c*W per block).
    s = t[..., -1]
    d = 1
    while d < b:
        s = torch.maximum(
            s, _shift(s, d, float(_NEG))
            - f32(float(c) * _W * d))
        d *= 2
    excl = _shift(s, 1, float(_NEG))
    # np.float32(c) * arange(1, W + 1) in float32: integers times one f32
    # scalar, one rounding each, as the host computes them.
    decay = f32(float(c)) * torch.arange(
        1, _W + 1, dtype=torch.float32, device=a.device)
    t = torch.maximum(t, excl[..., None] - decay)
    return t.reshape(t.shape[:-2] + (b * _W,))[..., :n]


def maxplus_scan(a: torch.Tensor, c: float) -> torch.Tensor:
    """Prefix maximum under constant per-step decrement ``c``:
    env[n] = max_{k<=n} (a[k] - c*(n-k)) along the last axis."""
    if _form(a.shape[-1]) == "blocked":
        return _maxplus_blocked(a, c)
    return _maxplus_doubling(a, c)


# -- AR(1) with a time-varying pole ---------------------------------------------


def tv_ar1_scan(u: torch.Tensor, p: torch.Tensor):
    """y[n] = p[n] * y[n-1] + u[n] with y[-1] = 0: a first-order linear
    recurrence with a TIME-VARYING pole, along the last axis.

    The pair (P, V) represents y_out = P * y_in + V; a segment a followed
    by a segment b composes to (Pa * Pb, Vb + Pb * Va). The JAX package
    runs that operator through ``lax.associative_scan``; here it runs as a
    Hillis-Steele doubling (log2(N) rounds, each pass composing every
    position with the one ``d`` before it; positions before the start take
    the identity (1, 0)), with the products on ``p``'s own shape (a [N]
    pole track shared by [C, N] channels).

    Returns ``(P_cum, y)``, ``P_cum[n] = prod_{j<=n} p[j]`` broadcast to
    ``u``'s shape: the weight a nonzero initial state enters with
    (y_s[n] = y[n] + P_cum[n] * s). Callers keep |p| < 1, so every
    composed product decays and the values stay bounded by the drive's
    scale; a long run's P_cum underflows to 0.0 (the initial state's true
    contribution is below float32 resolution there), never to a NaN: the
    doubling only multiplies and adds finite numbers.
    """
    n = u.shape[-1]
    pc, v = p, u
    d = 1
    while d < n:
        v = torch.addcmul(v, pc, _shift(v, d))
        pc = pc * _shift(pc, d, 1.0)
        d *= 2
    return pc.expand(u.shape), v
