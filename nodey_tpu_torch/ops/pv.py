"""Phase-vocoder time stretch (port of nodey_tpu.ops.pv, offline path).

The tempo stage's second algorithm family (``algorithm: "pv"`` on the
velocity and pitch nodes), for polyphonic material: classical
analysis-synthesis with simplified Laroche-Dolson identity phase locking.

1. Analysis frames at the 16.16 fixed-point positions ``pos_k = (k*num +
   32768) >> 16`` (``num = round(hop*tempo*65536)``), periodic-Hann
   windowed, then two float32 GEMMs against the real-DFT bases.
2. The phase path on the [C, K, B] planes: magnitude and phase, the
   instantaneous-frequency wrap over each frame's actual integer hop, the
   phasor prefix product along frames (a Hillis-Steele doubling, log K
   deep), the identity lock, and the ``mag*cos``, ``mag*sin`` products.
3. Two inverse-DFT GEMMs, the synthesis window, overlap-add at hop =
   n_fft/4 and the exact window-squared coverage divide.

The DFT GEMMs are ``torch.matmul`` in full float32 (the JAX package left
them to XLA). The phase path runs ``phase_path``: on a CUDA tensor the
hand-written fused kernel (:mod:`nodey_tpu_torch.ops.cuda_pv`), on a CPU
tensor ``phase_path_plain``. The option paths (onset reset
``transient``, formant pre-warp ``formant_ratio``) run the plain phase
math in torch on either device and lock through ``lock_phases``: the
lock kernel on the card, ``_lock_to_peaks`` on the CPU. This routes by
option, as the JAX package does; nothing falls back.

Bases are float64 host designs cast to float32 (the JAX package's host
branch). Lengths are host ints.

A batch of clips ``[B, C, N]`` (``pv_stretch_at_rate`` with a tuple of
lengths) shares the geometry, which depends on the capacity alone. Each
clip's GEMMs and plain phase math run on a single clip's shapes, so a
clip's bits are its single render's; the planes of all clips fold into
the kernels' channel rows, [B*C, K, bins], so the phase path (or the lock)
is one launch whatever B is. Every pass of both kernels works row by row,
and the transient detector sums over bins, never over channels.

The streaming step (``pv_stream_plan``, ``pv_stream_init``,
``pv_stream_step``) runs the same passes on each chunk's ready frames with
the plain phase math in torch, locks through ``lock_phases`` (the lock
kernel on the card, in every step with frames; no phase-path launch: the
JAX step does its recursion in XLA too) and carries the phasor, the last
frame's phase and magnitudes and the overlap-add tail on the device. The
sp-sharded stretch is ``parallel/pv_sharded.py``: the same passes a shard,
the lock through ``lock_phases``.
"""

from __future__ import annotations

import functools
import math
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from nodey_tpu_torch.core.errors import ProcessorRuntimeError
from nodey_tpu_torch.core.stream import map_lengths, zero_tail
from nodey_tpu_torch.ops.stft import _dft_matrices

# Spectral-flux threshold for transient phase reset (the velocity node's
# ``pv_transient``): the relu'd magnitude increase of a frame over its
# predecessor, normalized by the predecessor's total magnitude. 1.0 fires
# only on real onsets; a pure tone never resets.
PV_TRANSIENT_FLUX = 1.0

# Cepstral lifter length for the formant envelope: n_fft // 32 quefrency
# bins (64 at 48 kHz).
PV_FORMANT_LIFTER_DIV = 32

_TWO_PI = 2.0 * math.pi
# 2*pi as float32: what the JAX package's weakly typed constant becomes
# next to a float32 plane.
_TWO_PI_F32 = float(np.float32(_TWO_PI))

# Frames gathered per analysis GEMM: bounds the frame chunk (and its int64
# index) to [C, 4096, n_fft] instead of the whole clip's.
_FRAME_CHUNK = 4096


def pv_params(rate: int):
    """(n_fft, hop): the smallest power of two covering ~40 ms, 75%
    overlap."""
    n_fft = 512
    while n_fft < rate * 0.04:
        n_fft *= 2
    return n_fft, n_fft // 4


@functools.lru_cache(maxsize=8)
def _pv_window(n_fft: int) -> np.ndarray:
    """Periodic Hann: sum_k w^2(n - k*hop) == 1.5 at hop n_fft/4."""
    n = np.arange(n_fft)
    return (0.5 - 0.5 * np.cos(_TWO_PI * n / n_fft)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _idft_matrices(n_fft: int):
    """Inverse real-DFT bases [bins, n_fft]: x = Re X @ icos + Im X @ isin
    (the conjugate-symmetric expansion folded into the {1,2,...,2,1}/N
    row weights)."""
    bins = n_fft // 2 + 1
    k = np.arange(bins)[:, None] * np.arange(n_fft)[None, :]
    ang = _TWO_PI * k / n_fft
    c = np.full((bins, 1), 2.0 / n_fft)
    c[0, 0] = 1.0 / n_fft
    c[-1, 0] = 1.0 / n_fft
    return (
        (c * np.cos(ang)).astype(np.float32),
        (-c * np.sin(ang)).astype(np.float32),
    )


def pv_hop_num(hop: int, tempo: float) -> int:
    """16.16 fixed-point analysis-hop numerator."""
    return int(round(hop * tempo * 65536))


def _pv_geometry(N: int, tempo: float, rate: int):
    """(n_fft, hop, pos [K] int64 analysis positions, dpos [K] actual
    integer hops (dpos[0] = hop, unused), pad_to) for a clip of capacity
    ``N``: host integers, as in the JAX package."""
    n_fft, hop = pv_params(rate)
    out_cap = int(math.ceil(N / tempo)) + hop
    K = max(2, -(-out_cap // hop) + 1)
    num = pv_hop_num(hop, tempo)
    pos = (np.arange(K, dtype=np.int64) * num + 32768) >> 16
    dpos = np.diff(pos, prepend=pos[:1])
    dpos[0] = hop
    dpos = np.maximum(dpos, 1)
    pad_to = int(pos[-1]) + n_fft + 2
    return n_fft, hop, pos, dpos, pad_to


@functools.lru_cache(maxsize=8)
def _bases(n_fft: int, device: torch.device):
    """(window, cos, -sin, icos, isin) float32 tensors on ``device``."""
    arrays = (_pv_window(n_fft), *_dft_matrices(n_fft), *_idft_matrices(n_fft))
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def _analysis(data: torch.Tensor, pos: np.ndarray, pad_to: int, n_fft: int,
              out=None):
    """(re, im) [C, K, bins]: the windowed real DFT of every frame
    ``data[:, pos_k : pos_k + n_fft]``, gathered in chunks of frames (into
    ``out``, two [C, K, bins] planes, where given)."""
    C, N = data.shape
    K = len(pos)
    bins = n_fft // 2 + 1
    w, cos_m, sin_m = _bases(n_fft, data.device)[:3]
    x = F.pad(data, (0, max(0, pad_to - N)))
    if out is None:
        out = data.new_empty((C, K, bins)), data.new_empty((C, K, bins))
    re, im = out
    offsets = torch.arange(n_fft, device=data.device)
    starts = torch.from_numpy(pos.astype(np.int64)).to(data.device)
    for k0 in range(0, K, _FRAME_CHUNK):
        idx = starts[k0 : k0 + _FRAME_CHUNK, None] + offsets[None, :]
        frames = x[:, idx] * w                       # [C, chunk, n_fft]
        re[:, k0 : k0 + idx.shape[0]] = torch.matmul(frames, cos_m)
        im[:, k0 : k0 + idx.shape[0]] = torch.matmul(frames, sin_m)
    return re, im


# -- the phase path, plain -----------------------------------------------------


def _magnitude_phase(re: torch.Tensor, im: torch.Tensor):
    """(mag, ph): each product, the sum and the root rounded on its own
    (the kernel uses the same roundings, so peak decisions match)."""
    return torch.sqrt(re * re + im * im), torch.atan2(im, re)


def _omega_hop(hop: int, n_fft: int) -> np.ndarray:
    """[bins] float32: the deterministic advance ``(b*hop) mod n_fft`` in
    radians, exact on the host and rounded once."""
    return (np.mod(np.arange(n_fft // 2 + 1) * hop, n_fft).astype(np.float64)
            * (_TWO_PI / n_fft)).astype(np.float32)


def _advance(ph: torch.Tensor, dpos: np.ndarray, hop: int, n_fft: int):
    """[C, K-1, bins] phase advance of frames 1..K-1 (``_advance_on`` with
    the geometry's tables uploaded)."""
    device = ph.device
    dpos_i = torch.from_numpy(dpos[1:].astype(np.int32)).to(device)
    hop_over_dpos = torch.from_numpy(
        (float(hop) / dpos[1:, None]).astype(np.float32)).to(device)
    omega_hop = torch.from_numpy(_omega_hop(hop, n_fft)).to(device)
    return _advance_on(ph[:, 1:] - ph[:, :-1], dpos_i, hop_over_dpos,
                       omega_hop, n_fft)


def _advance_on(dph: torch.Tensor, dpos_i: torch.Tensor,
                hop_over_dpos: torch.Tensor, omega_hop: torch.Tensor,
                n_fft: int):
    """Phase advance of frames whose analysis phase moved by ``dph`` [C, K,
    bins] over their actual integer hops ``dpos_i`` [K] (int32), kept O(1)
    for float32: the deterministic term ``omega_hop`` [bins] is exact on
    the host, and the measured deviation (the wrapped phase delta over
    ``dpos``, scaled by ``hop_over_dpos`` [K, 1] = float32(hop/dpos)) stays
    within ~pi. Makes no copy between host and device.

    A steady tone repeats the same advance every frame, so a rounding
    bias here grows linearly along the prefix; the multiply-adds are
    therefore fused (``_fma``), as the compiled JAX path fuses them."""
    device = dph.device
    b_i = torch.arange(dph.shape[-1], dtype=torch.int32, device=device)
    omega_dpos = ((b_i[None, :] * dpos_i[:, None]) % n_fft).float()
    dphi = _fma(omega_dpos, -float(np.float32(_TWO_PI / n_fft)), dph)
    # A device tensor, so the quotient is an IEEE division on every device
    # (a CUDA tensor divided by a Python scalar is multiplied by its
    # reciprocal).
    two_pi = torch.full((), _TWO_PI_F32, device=device)
    wrapped = _fma(torch.round(dphi / two_pi), -_TWO_PI_F32, dphi)
    return _fma(wrapped, hop_over_dpos, omega_hop)


def _fma(a, b, c):
    """a*b + c rounded once to float32, as a fused multiply-add (and the
    JAX package's compiled XLA) computes it: the float32 product is exact
    in float64. The kernel computes the same float64 expression."""
    b = b.double() if torch.is_tensor(b) else b
    return (a.double() * b + c.double()).float()


def _prefix_product(ca: torch.Tensor, sa: torch.Tensor, reset=None):
    """Inclusive prefix product of unit phasors (ca, sa) along frames
    (dim 1) by Hillis-Steele doubling: log K deep, so the rounding error
    grows with log K, not with K as a serial product's does.

    With ``reset`` ([C, K, 1] bool) the combine is segmented
    (``_cmul_seg``): a reset frame's phasor is absolute and discards
    everything before it. Returns (cos, sin) or (cos, sin, reset seen)."""
    n = ca.shape[1]
    s = 1
    while s < n:
        c0, s0, c1, s1 = ca[:, :-s], sa[:, :-s], ca[:, s:], sa[:, s:]
        mc = c0 * c1 - s0 * s1
        ms = c0 * s1 + s0 * c1
        if reset is not None:
            r1 = reset[:, s:]
            mc = torch.where(r1, c1, mc)
            ms = torch.where(r1, s1, ms)
            reset = torch.cat([reset[:, :s], reset[:, :-s] | r1], dim=1)
        ca = torch.cat([ca[:, :s], mc], dim=1)
        sa = torch.cat([sa[:, :s], ms], dim=1)
        s *= 2
    return (ca, sa) if reset is None else (ca, sa, reset)


def transient_resets(mag_prev: torch.Tensor, mag: torch.Tensor,
                     threshold: float = PV_TRANSIENT_FLUX) -> torch.Tensor:
    """Boolean [...] onset mask by normalized positive spectral flux of
    consecutive [..., bins] magnitude frames."""
    rise = torch.clamp(mag - mag_prev, min=0.0).sum(dim=-1)
    base = mag_prev.sum(dim=-1)
    return rise > threshold * (base + float(np.float32(1e-6)))


def _synthesis_phasors(ph: torch.Tensor, dpos: np.ndarray, hop: int,
                       n_fft: int, reset=None):
    """(cos_phi, sin_phi) [C, K, bins]: frame 0 at its analysis phase,
    every later frame rotated by the prefix of the advances. A frame with
    ``reset`` [C, K-1, 1] (frames 1..K-1) snaps to its analysis phase."""
    adv = _advance(ph, dpos, hop, n_fft)
    ca, sa = torch.cos(adv), torch.sin(adv)
    c0, s0 = torch.cos(ph[:, :1]), torch.sin(ph[:, :1])
    if reset is None:
        pc, ps = _prefix_product(ca, sa)
        cos1, sin1 = c0 * pc - s0 * ps, c0 * ps + s0 * pc
    else:
        ca = torch.where(reset, torch.cos(ph[:, 1:]), ca)
        sa = torch.where(reset, torch.sin(ph[:, 1:]), sa)
        pc, ps, pr = _prefix_product(ca, sa, reset)
        # Frames after a reset are already absolute; earlier ones rotate
        # off frame 0's analysis phase.
        cos1 = torch.where(pr, pc, c0 * pc - s0 * ps)
        sin1 = torch.where(pr, ps, c0 * ps + s0 * pc)
    return torch.cat([c0, cos1], dim=1), torch.cat([s0, sin1], dim=1)


def _hs_last_valid(seed):
    """Inclusive "last valid" scan along the bin axis by Hillis-Steele
    doubling shifts. ``seed`` is (idx, *values); idx < 0 marks an invalid
    slot. Result[i] = the seed values at the largest j <= i with idx[j] >=
    0. The combine only selects seed values, so every scan order gives
    the same bits."""
    arrs = list(seed)
    n = arrs[0].shape[-1]
    s = 1
    while s < n:
        valid = arrs[0] >= 0
        arrs = [
            torch.where(valid, a, torch.cat(
                [torch.full_like(a[..., :s], -1 if i == 0 else 0),
                 a[..., : n - s]], dim=-1))
            for i, a in enumerate(arrs)
        ]
        s *= 2
    return tuple(arrs)


def _peak_flags(mag):
    """The lock's peaks: bins whose magnitude is > the bins 1 and 2 below
    and >= the bins 1 and 2 above (-1 beyond the row's ends)."""
    neg = torch.full_like(mag[..., :1], -1.0)

    def shift(x, s):
        if s > 0:
            return torch.cat([neg.expand(*x.shape[:-1], s), x[..., :-s]], -1)
        return torch.cat([x[..., -s:], neg.expand(*x.shape[:-1], -s)], -1)

    return (
        (mag > shift(mag, 1))
        & (mag >= shift(mag, -1))
        & (mag > shift(mag, 2))
        & (mag >= shift(mag, -2))
    )


def _lock_to_peaks(cos_phi, sin_phi, ph_in, mag):
    """Identity phase locking, plain: peaks are local maxima over +-2
    bins (``_peak_flags``); every other bin adopts the nearer of its
    previous and next peak (the previous on a tie) and is re-phased
    rigidly with it: phasor[b] <- phasor[peak] * e^{i(ph_in[b] -
    ph_in[peak])}. A frame without peaks keeps its own phasors."""
    B = mag.shape[-1]
    is_peak = _peak_flags(mag)
    bi = torch.arange(B, dtype=torch.int32, device=mag.device)
    seed = (
        torch.where(is_peak, bi.expand_as(is_peak), -1),
        torch.where(is_peak, cos_phi, 0.0),
        torch.where(is_peak, sin_phi, 0.0),
        torch.where(is_peak, ph_in, 0.0),
    )
    prev = _hs_last_valid(seed)
    nxt = tuple(x.flip(-1) for x in _hs_last_valid(
        tuple(x.flip(-1) for x in seed)))
    prev_i, nxt_i = prev[0], nxt[0]
    use_prev = (prev_i >= 0) & ((nxt_i < 0) | (bi - prev_i <= nxt_i - bi))
    has_peak = (prev_i >= 0) | (nxt_i >= 0)
    cp = torch.where(use_prev, prev[1], nxt[1])
    sp = torch.where(use_prev, prev[2], nxt[2])
    pph = torch.where(use_prev, prev[3], nxt[3])
    cp = torch.where(has_peak, cp, cos_phi)
    sp = torch.where(has_peak, sp, sin_phi)
    pph = torch.where(has_peak, pph, ph_in)
    d = ph_in - pph
    cd, sd = torch.cos(d), torch.sin(d)
    return (
        torch.where(is_peak, cos_phi, cp * cd - sp * sd),
        torch.where(is_peak, sin_phi, cp * sd + sp * cd),
    )


def phase_path_plain(re: torch.Tensor, im: torch.Tensor, dpos: np.ndarray,
                     hop: int, n_fft: int, lock: bool = True):
    """(mag*cos_phi, mag*sin_phi) [C, K, bins] from the forward-DFT planes:
    the plain version of both kernels (``csrc/pv_phase_path.cu``, and with
    ``lock`` the lock of ``csrc/pv_lock.cu`` inside it). ``dpos`` [K] are
    the integer analysis hops of ``_pv_geometry``; dpos[0] is unused."""
    mag, ph = _magnitude_phase(re, im)
    cos_phi, sin_phi = _synthesis_phasors(ph, dpos, hop, n_fft)
    if lock:
        cos_phi, sin_phi = _lock_to_peaks(cos_phi, sin_phi, ph, mag)
    return mag * cos_phi, mag * sin_phi


def _unsupported_device(t: torch.Tensor, what: str):
    return ProcessorRuntimeError(
        "Unsupported device for the phase vocoder",
        f"The {what} runs on a CUDA card (kernel) or on the CPU.",
        f"device={t.device}",
    )


def phase_path(re, im, dpos, hop: int, n_fft: int, lock: bool = True):
    """The phase path: a CUDA tensor launches the fused kernel (or
    raises); a CPU tensor takes ``phase_path_plain``."""
    if re.is_cuda:
        from nodey_tpu_torch.ops import cuda_pv

        return cuda_pv.phase_path_cuda(re, im, dpos, hop, n_fft, lock)
    if re.device.type != "cpu":
        raise _unsupported_device(re, "phase path")
    return phase_path_plain(re, im, dpos, hop, n_fft, lock)


def lock_phases(cos_phi, sin_phi, ph_in, mag):
    """Identity locking: a CUDA tensor launches the lock kernel (or
    raises); a CPU tensor takes ``_lock_to_peaks``."""
    if mag.is_cuda:
        from nodey_tpu_torch.ops import cuda_pv

        return cuda_pv.lock_to_peaks_cuda(cos_phi, sin_phi, ph_in, mag)
    if mag.device.type != "cpu":
        raise _unsupported_device(mag, "phase lock")
    return _lock_to_peaks(cos_phi, sin_phi, ph_in, mag)


# -- option paths ----------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _cepstral_matrices(n_fft: int):
    """[Q, B] analysis and [B, Q] synthesis cosine matrices of the
    liftered (low-quefrency) reconstruction of a log-magnitude spectrum
    (interior bins count twice for their mirror images); float64 design,
    float32 storage."""
    B = n_fft // 2 + 1
    Q = max(8, n_fft // PV_FORMANT_LIFTER_DIV)
    b = np.arange(B, dtype=np.float64)
    q = np.arange(Q, dtype=np.float64)
    cos_qb = np.cos(2.0 * np.pi * np.outer(q, b) / n_fft)   # [Q, B]
    w = np.full(B, 2.0 / n_fft)
    w[0] = 1.0 / n_fft
    w[-1] = 1.0 / n_fft
    analysis = cos_qb * w[None, :]
    dup = np.full(Q, 2.0)
    dup[0] = 1.0
    synthesis = cos_qb.T * dup[None, :]                     # [B, Q]
    return analysis.astype(np.float32), synthesis.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _formant_tables(n_fft: int, ratio: float, device: torch.device):
    """(analysis [Q, B], synthesis [B, Q], lo [B], hi [B], frac [B]) on
    ``device``: the lifter's matrices and the envelope warp's linear
    interpolation at ``w*ratio`` (frequencies past Nyquist/ratio clamp to
    the top bin). Cached, so a streaming plan puts them on the device once
    and no chunk step copies from the host."""
    B = n_fft // 2 + 1
    pos = np.minimum(np.arange(B, dtype=np.float64) * ratio, B - 1)
    lo = pos.astype(np.int64)
    hi = np.minimum(lo + 1, B - 1)
    frac = (pos - lo).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (
        *_cepstral_matrices(n_fft), lo, hi, frac))


def _formant_correction(mag: torch.Tensor, n_fft: int, ratio: float):
    """Pre-warp magnitudes so a downstream resample by ``ratio`` keeps the
    spectral envelope: mag * exp(E(w*ratio) - E(w)), E the liftered log
    envelope."""
    ana, syn, lo, hi, frac = _formant_tables(n_fft, float(ratio), mag.device)
    log_mag = torch.log(mag + float(np.float32(1e-8)))
    env = torch.matmul(torch.matmul(log_mag, ana.T), syn.T)
    env_w = env[..., lo] * (1.0 - frac) + env[..., hi] * frac
    return mag * torch.exp(env_w - env)


# -- synthesis -------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _ola_denominator(K: int, n_fft: int) -> np.ndarray:
    """Exact window-squared coverage sum_k w^2(n - k*hop) of the
    [(K+3)*hop] overlap-add output, floored at 1e-2 where it vanishes."""
    hop = n_fft // 4
    w2 = _pv_window(n_fft).astype(np.float64) ** 2
    den = np.zeros(((K + 3) * hop,), dtype=np.float64)
    w2v = w2.reshape(4, hop)
    for j in range(4):
        den.reshape(-1, hop)[j : j + K] += w2v[j]
    return np.maximum(den, 1e-2).astype(np.float32)


def _pv_synth(re_y: torch.Tensor, im_y: torch.Tensor, n_fft: int, hop: int):
    """Inverse real-DFT GEMMs, synthesis window, overlap-add at hop =
    n_fft/4 (subframe j of frame k lands on output row k + j) and the
    exact coverage divide. Returns [C, (K+3)*hop]."""
    C, K, _ = re_y.shape
    w, _, _, icos, isin = _bases(n_fft, re_y.device)
    y = torch.matmul(re_y, icos) + torch.matmul(im_y, isin)
    y4 = (y * w).reshape(C, K, 4, hop)
    ola = None
    for j in range(4):
        part = F.pad(y4[:, :, j, :], (0, 0, j, 3 - j))
        ola = part if ola is None else ola + part    # [C, K+3, hop]
    if K >= 8:
        # Coverage rows 0..2 and K..K+2 are the window's edge ramps; every
        # row between is the same full sum, added in the same order, so the
        # K = 8 denominator holds all three bitwise.
        rows = torch.from_numpy(
            _ola_denominator(8, n_fft).reshape(11, hop)).to(ola.device)
        ola[:, :3] /= rows[:3]
        ola[:, 3:K] /= rows[3]
        ola[:, K:] /= rows[8:]
    else:
        ola /= torch.from_numpy(
            _ola_denominator(K, n_fft).reshape(K + 3, hop)).to(ola.device)
    return ola.reshape(C, (K + 3) * hop)


def _pv_impl(data: torch.Tensor, tempo: float, rate: int, lock: bool = True,
             transient: bool = False, formant_ratio: float = 1.0):
    """Stretch [C, N] by ``tempo``; returns the unmasked overlap-added
    output [C, (K+3)*hop]. ``transient`` snaps onset frames (normalized
    positive spectral flux above PV_TRANSIENT_FLUX) back to their analysis
    phase, a segment boundary of the prefix; ``formant_ratio`` pre-warps
    the magnitudes for a downstream resample by that ratio. A batch
    [B, C, N] gives [B, C, (K+3)*hop] (``_pv_batch``)."""
    if data.dim() == 3:
        return _pv_batch(data, tempo, rate, lock, transient, formant_ratio)
    C, N = data.shape
    n_fft, hop, pos, dpos, pad_to = _pv_geometry(N, tempo, rate)
    if not transient and formant_ratio == 1.0:
        re, im = _analysis(data, pos, pad_to, n_fft)
        re_y, im_y = phase_path(re, im, dpos, hop, n_fft, lock)
        del re, im
        return _pv_synth(re_y, im_y, n_fft, hop)
    cos_phi, sin_phi, ph, mag = _option_planes(
        data, pos, pad_to, dpos, hop, n_fft, transient, formant_ratio)
    if lock:
        cos_phi, sin_phi = lock_phases(cos_phi, sin_phi, ph, mag)
    return _pv_synth(mag * cos_phi, mag * sin_phi, n_fft, hop)


def _option_planes(data, pos, pad_to, dpos, hop: int, n_fft: int,
                   transient: bool, formant_ratio: float):
    """(cos_phi, sin_phi, ph, mag) [C, K, bins] of one clip on the option
    paths, before the lock: the plain phase math in torch."""
    re, im = _analysis(data, pos, pad_to, n_fft)
    mag, ph = _magnitude_phase(re, im)
    del re, im
    reset = None
    if transient:
        # Detection reads the input's magnitudes, before any pre-warp.
        reset = transient_resets(mag[:, :-1], mag[:, 1:])[..., None]
    if formant_ratio != 1.0:
        mag = _formant_correction(mag, n_fft, formant_ratio)
    cos_phi, sin_phi = _synthesis_phasors(ph, dpos, hop, n_fft, reset)
    return cos_phi, sin_phi, ph, mag


def _folds_clips(t: torch.Tensor) -> bool:
    """Whether a batch's planes go to the phase path and the lock folded
    into rows, [B*C, K, bins]: one kernel launch on a CUDA tensor. On the
    CPU the plain twins go clip by clip, as a single render calls them:
    their elementwise transcendentals round an element by where it falls
    in the vectorized loop, so folded planes would move a clip's last
    bits."""
    return t.is_cuda


def _pv_batch(data: torch.Tensor, tempo: float, rate: int, lock: bool,
              transient: bool, formant_ratio: float):
    """``_pv_impl`` of a batch [B, C, N]: each clip's analysis, option math
    and synthesis on a single clip's shapes, its planes written into the
    batch's [B, C, K, bins] planes, and the phase path or the lock launched
    once on them folded to [B*C, K, bins] (on the CPU, their plain twins
    clip by clip)."""
    B, C, N = data.shape
    n_fft, hop, pos, dpos, pad_to = _pv_geometry(N, tempo, rate)
    K, bins = len(pos), n_fft // 2 + 1

    def folded(fn, *planes):
        if _folds_clips(planes[0]):
            return [p.view(B, C, K, bins) for p in fn(
                *(p.view(B * C, K, bins) for p in planes))]
        return [torch.stack(out) for out in zip(
            *(fn(*(p[b] for p in planes)) for b in range(B)))]

    if not transient and formant_ratio == 1.0:
        re = data.new_empty((B, C, K, bins))
        im = data.new_empty((B, C, K, bins))
        for b in range(B):
            _analysis(data[b], pos, pad_to, n_fft, out=(re[b], im[b]))
        ry, iy = folded(lambda r, i: phase_path(r, i, dpos, hop, n_fft, lock),
                        re, im)
        del re, im
        return torch.stack([_pv_synth(ry[b], iy[b], n_fft, hop)
                            for b in range(B)])
    planes = data.new_empty((4, B, C, K, bins))  # cos_phi, sin_phi, ph, mag
    for b in range(B):
        for dst, src in zip(planes[:, b], _option_planes(
                data[b], pos, pad_to, dpos, hop, n_fft, transient,
                formant_ratio)):
            dst.copy_(src)
    cos_phi, sin_phi, ph, mag = planes
    if lock:
        cos_phi, sin_phi = folded(lock_phases, *planes)
    del ph
    return torch.stack([_pv_synth(mag[b] * cos_phi[b], mag[b] * sin_phi[b],
                                  n_fft, hop) for b in range(B)])


def pv_stretch_at_rate(data: torch.Tensor, length, tempo: float,
                       rate: int, lock: bool = True, transient: bool = False,
                       formant_ratio: float = 1.0):
    """Stretch [C, N] float32 by ``tempo`` (>1 = faster/shorter).

    Same contract as ``stretch.wsola_stretch_at_rate``: returns ``(out [C,
    (K+3)*hop], out_length)`` with out_length = min(floor(length/tempo),
    width) by the shared exact integer scaling, zeros past it. Identity
    when tempo == 1 (so a formant pre-warp needs a running tempo stage). A
    batch [B, C, N] with a tuple of lengths gives each clip's."""
    if tempo == 1.0:
        return data, length
    from nodey_tpu_torch.ops.stretch import _scale_length_exact

    out = _pv_impl(data, float(tempo), int(rate), lock=lock,
                   transient=transient, formant_ratio=float(formant_ratio))
    width = out.shape[-1]
    out_length = map_lengths(
        length, lambda n: min(_scale_length_exact(n, float(tempo)), width))
    zero_tail(out, out_length)  # a fresh tensor: zero in place
    return out, out_length


# -- streaming (chunked) phase vocoder -------------------------------------------
#
# A chunk is a batch of frames: the passes above run on the frames that the
# input so far makes ready, and the only cross-chunk state is the input FIFO,
# the previous frame's analysis phase and raw magnitudes, the accumulated
# synthesis phasor (the prefix product factorizes across chunk boundaries)
# and the 3*hop overlap-add tail. The geometry is the offline 16.16 law, so
# the streamed output equals the offline render up to float32 association
# of the phasor products (offline one prefix over the clip, here one per
# chunk and the carry), on which the PV's last bits turn (the JAX package's
# streamed == offline bars).


class PvStreamPlan(NamedTuple):
    """Static geometry of one streaming PV stage (the JAX package's plan,
    field for field)."""

    n_fft: int
    hop: int           # synthesis hop (n_fft // 4)
    num: int           # analysis-hop numerator, den 65536 (pv_hop_num)
    num_t: int         # round(tempo * 65536), the output-length law
    push_cap: int
    k_cap: int         # frames processed per step
    window: int        # input window needed by k_cap frames
    cap: int           # FIFO capacity
    out_cap: int       # k_cap * hop
    lock: bool
    transient: bool = False
    formant_ratio: float = 1.0


def pv_stream_plan(tempo: float, rate: int, push_cap: int, lock: bool = True,
                   transient: bool = False,
                   formant_ratio: float = 1.0) -> PvStreamPlan:
    n_fft, hop = pv_params(rate)
    num = pv_hop_num(hop, tempo)
    k_cap = max(1, -(-push_cap * 65536 // num) + 2)
    window = (k_cap - 1) * num // 65536 + n_fft + 2
    return PvStreamPlan(
        n_fft=n_fft, hop=hop, num=num, num_t=int(round(tempo * 65536)),
        push_cap=push_cap, k_cap=k_cap, window=window,
        cap=window + push_cap + num // 65536 + 2, out_cap=k_cap * hop,
        lock=lock, transient=transient, formant_ratio=float(formant_ratio),
    )


@functools.lru_cache(maxsize=8)
def _stream_tables(n_fft: int, device: torch.device):
    """(omega_hop [bins], P1 [4, hop]) float32 on ``device``. P1[r] is the
    window-squared coverage of overlap-add row r < 3 and of every later
    row (the offline denominator's first rows: the trimmed output never
    reaches the end ramp)."""
    hop = n_fft // 4
    P1 = _ola_denominator(4, n_fft).reshape(7, hop)[:4].copy()
    return (torch.from_numpy(_omega_hop(hop, n_fft)).to(device),
            torch.from_numpy(P1).to(device))


class PvStreamState(NamedTuple):
    """The carry of one streaming PV stage: on the device the FIFO, the
    synthesis phasor (cc, cs) [C, bins] and the analysis phase and raw
    magnitudes [C, bins] of the last frame synthesized, and the overlap-add
    tail [C, 3*hop]; on the host the counts (next frame ``k``, input
    samples ``consumed`` from the FIFO's front and ``in_len`` pushed)."""

    fifo: Any
    cc: torch.Tensor
    cs: torch.Tensor
    ph_prev: torch.Tensor
    mag_prev: torch.Tensor
    tail: torch.Tensor
    k: int
    consumed: int
    in_len: int


def pv_stream_init(plan: PvStreamPlan, channels: int, device) -> PvStreamState:
    """An empty stage on ``device``, the phasor at identity. Puts the DFT
    bases and the step's constant tables on the device, so no step copies
    from the host."""
    from nodey_tpu_torch.ops.chunkops import fifo_init

    fifo = fifo_init(channels, plan.cap, device)
    # The tensors' own device ("cuda" becomes "cuda:0"): the step looks the
    # tables up by it.
    device = fifo.buf.device
    _bases(plan.n_fft, device)
    _stream_tables(plan.n_fft, device)
    if plan.formant_ratio != 1.0:
        _formant_tables(plan.n_fft, plan.formant_ratio, device)
    bins = plan.n_fft // 2 + 1

    def zeros(width):
        return torch.zeros((channels, width), dtype=torch.float32,
                           device=device)

    return PvStreamState(
        fifo=fifo,
        cc=torch.ones((channels, bins), dtype=torch.float32, device=device),
        cs=zeros(bins), ph_prev=zeros(bins), mag_prev=zeros(bins),
        tail=zeros(3 * plan.hop), k=0, consumed=0, in_len=0,
    )


def _frame_tables(rel: np.ndarray, dpos: np.ndarray, hop: int,
                  device: torch.device):
    """(rel [K] int64, dpos [K] int32, hop/dpos [K, 1] float32) of a step's
    frames on ``device``, in one copy: from pinned memory without waiting
    on a card, from the array itself on the CPU."""
    K = len(rel)
    host = torch.empty((3, K), dtype=torch.int32,
                       pin_memory=device.type == "cuda")
    table = host.numpy()
    table[0] = rel
    table[1] = dpos
    table[2] = (float(hop) / dpos).astype(np.float32).view(np.int32)
    dev = host.to(device, non_blocking=True)
    return dev[0].long(), dev[1], dev[2].view(torch.float32)[:, None]


def pv_stream_step(plan: PvStreamPlan, state: PvStreamState,
                   data: torch.Tensor, n: int, done: bool):
    """Push ``data[:, :n]``, analyze and synthesize every frame that is
    ready, emit the final overlap-add rows.

    Frame k reads [pos(k), pos(k) + n_fft); output row k (hop samples at
    k*hop) is final once frame k is synthesized. A frame runs once its
    window is buffered and its row lies inside the output-length bound of
    the input so far (so a live emission is never taken back); once
    ``done`` the FIFO's zero tail stands in for the offline right pad and
    the last chunk is clamped to the exact stretched length. The ready
    frames are a prefix of the step's k_cap, counted on the host; every
    pass runs on all k_cap frames (the frames past the prefix read the
    FIFO's zeros, rotate by identity and are masked, as in the JAX step),
    and a step with no ready frame runs none of them. The carries come from
    the last ready frame, unlocked; only synthesis is locked
    (``lock_phases``: the lock kernel on the card). Every emitted row has
    coverage P1[min(3, k)]. No step copies from the device to the host.

    Returns ``(state, out [C, out_cap], out_n, out_done)``."""
    from nodey_tpu_torch.ops.chunkops import (fifo_advance, fifo_push,
                                              fifo_window)
    from nodey_tpu_torch.ops.stretch import scale_length_by_num
    from nodey_tpu_torch.ops.wsola import frame_pos

    n_fft, hop, K = plan.n_fft, plan.hop, plan.k_cap
    fifo, cc, cs, ph_prev, mag_prev, tail, k0, consumed, in_len = state
    fifo = fifo_push(fifo, data, n)
    in_len += n
    out_total = scale_length_by_num(in_len, plan.num_t)
    k_fin = max(-(-out_total // hop), 0)
    k_bound = k_fin if done else out_total // hop
    buffered = consumed + fifo.level
    k_done = 0
    while (k_done < K and k0 + k_done < k_bound
           and (done or frame_pos(k0 + k_done, plan.num) + n_fft <= buffered)):
        k_done += 1

    C, device = fifo.buf.shape[0], fifo.buf.device
    if k_done:
        ks = np.arange(k0, k0 + K, dtype=np.int64)
        pos = (ks * plan.num + 32768) >> 16
        pos_prev = np.where(ks >= 1, ((ks - 1) * plan.num + 32768) >> 16, 0)
        x = fifo_window(fifo, plan.window + plan.push_cap)
        rel, dpos, hop_over_dpos = _frame_tables(
            np.clip(pos - consumed, 0, x.shape[1] - n_fft),
            np.maximum(pos - pos_prev, 1), hop, device)
        w, cos_m, sin_m, icos, isin = _bases(n_fft, device)
        omega_hop, P1 = _stream_tables(n_fft, device)

        frames = x.unfold(1, n_fft, 1)[:, rel] * w          # [C, K, n_fft]
        re, im = torch.matmul(frames, cos_m), torch.matmul(frames, sin_m)
        del frames
        mag, ph = _magnitude_phase(re, im)
        del re, im
        raw_mag = mag
        if plan.formant_ratio != 1.0:
            # Detection and the mag_prev carry read the input's magnitudes;
            # locking and synthesis the pre-warped ones.
            mag = _formant_correction(mag, n_fft, plan.formant_ratio)
        dph = ph - torch.cat([ph_prev[:, None], ph[:, :-1]], dim=1)
        adv = _advance_on(dph, dpos, hop_over_dpos, omega_hop, n_fft)
        if k0 == 0:
            adv[:, 0] = ph[:, 0]  # frame 0 seeds the phasor at its phase
        reset = None
        if plan.transient:
            # Onsets against each frame's predecessor (the carry for the
            # first); frame 0 and the frames past the prefix never reset.
            reset = transient_resets(
                torch.cat([mag_prev[:, None], raw_mag[:, :-1]], dim=1),
                raw_mag)
            if k0 == 0:
                reset[:, 0] = False
            reset[:, k_done:] = False
            reset = reset[..., None]
            adv = torch.where(reset, ph, adv)
        ca, sa = torch.cos(adv), torch.sin(adv)
        ca[:, k_done:] = 1.0
        sa[:, k_done:] = 0.0
        ccb, csb = cc[:, None], cs[:, None]
        if reset is None:
            pc, ps = _prefix_product(ca, sa)
            cos_phi, sin_phi = ccb * pc - csb * ps, ccb * ps + csb * pc
        else:
            pc, ps, pr = _prefix_product(ca, sa, reset)
            cos_phi = torch.where(pr, pc, ccb * pc - csb * ps)
            sin_phi = torch.where(pr, ps, ccb * ps + csb * pc)
        j = k_done - 1
        cc, cs = cos_phi[:, j].clone(), sin_phi[:, j].clone()
        ph_prev, mag_prev = ph[:, j].clone(), raw_mag[:, j].clone()
        if plan.lock:
            cos_phi, sin_phi = lock_phases(cos_phi, sin_phi, ph, mag)

        y = torch.matmul(mag * cos_phi, icos) + torch.matmul(mag * sin_phi,
                                                             isin)
        y = y * w
        y[:, k_done:] = 0.0
        # Overlap-add over rows k0 .. k0+K+2: four shifted adds, then the
        # carried tail on the first three rows.
        y4 = y.reshape(C, K, 4, hop)
        acc = None
        for i in range(4):
            part = F.pad(y4[:, :, i, :], (0, 0, i, 3 - i))
            acc = part if acc is None else acc + part       # [C, K+3, hop]
        acc[:, :3] += tail.view(C, 3, hop)
        tail = acc[:, k_done : k_done + 3].reshape(C, 3 * hop).clone()
        rows = acc[:, :K] / P1[3]
        if k0 < 3:
            rows[:, : 3 - k0] = acc[:, : 3 - k0] / P1[k0:3]
        out = rows.reshape(C, K * hop)
        out_n = min(max(min(k_done * hop, out_total - k0 * hop), 0),
                    plan.out_cap)
        out[:, out_n:] = 0.0
    else:
        out = torch.zeros((C, plan.out_cap), dtype=torch.float32,
                          device=device)
        out_n = 0

    k_next = k0 + k_done
    advance = max(frame_pos(k_next, plan.num) - consumed, 0)
    fifo = fifo_advance(fifo, advance)
    state = PvStreamState(fifo, cc, cs, ph_prev, mag_prev, tail, k_next,
                          consumed + advance, in_len)
    return state, out, out_n, done and k_next >= k_fin
