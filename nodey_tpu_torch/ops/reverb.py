"""Convolution reverb (port of nodey_tpu.ops.reverb): uniform-partition
overlap-save convolution as real-DFT GEMMs.

The impulse response is synthesized on the host in float64 (spectral-decay
synthesis: white-noise STFT frames shaped by a per-bin RT60 curve,
Hann-OLA'd, from a fixed seed), with the JAX package's numpy code, so the
partition spectra are bitwise its own. The convolution runs on the device:

* the IR is cut into K blocks of P samples, each zero-padded to F = 2P and
  transformed once on the host (float64 rfft, rounded to float32);
* overlap-save framing: each hop's segment is the previous P-block beside
  the current one, forward-transformed by two [C*T, F] x [F, BINS] GEMMs
  (cos and -sin bases), so the spectra are split (re, im) float32 planes;
* the frequency-domain delay line Y[t] = sum_k X[t-k] H[k], as K shifted
  multiply-adds accumulated in place into slices of one [C, T, 2*BINS]
  plane (k ascending, the JAX loop's order per element);
* one inverse GEMM [C*T, 2*BINS] x [2*BINS, F]; the last P samples of each
  hop are the valid outputs.

The GEMMs are plain float32 matmuls with TF32 off and
``float32_matmul_precision`` "highest", checked where they run
(``scans._gemm``). The DFT bases and the partition spectra are cached on
the device per device (``_device_mats``, ``_device_partitions``);
``reverb_stream_prepare`` fills both at plan time, so a chunk step copies
nothing from the host. Counts (valid lengths, the tail still to flush) are
host ints.

The offline reverb also takes a batch of clips, ``[B, C, N]`` with one host
length a clip: the delay line's in-place passes run on every clip at once
(elementwise, so each clip's bits are its single render's), the three DFT
GEMMs clip by clip on one clip's shapes (``scans._gemm``), and each clip
grows by the IR's tail from its own length.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nodey_tpu_torch.core.stream import FMT_FLT, Stream, map_lengths
from nodey_tpu_torch.ops import scans
from nodey_tpu_torch.ops.scans import f32 as _f32, mask_tail

PARTITION = 2048            # P: overlap-save hop / IR partition size
_F = 2 * PARTITION          # DFT size
_BINS = _F // 2 + 1


@functools.lru_cache(maxsize=4)
def _fwd_mats() -> Tuple[np.ndarray, np.ndarray]:
    """Real-DFT analysis bases [F, BINS]: (cos, -sin), float64-designed."""
    k = np.arange(_F, dtype=np.float64)[:, None] * np.arange(_BINS)[None, :]
    ang = 2.0 * np.pi * k / _F
    return (np.cos(ang).astype(np.float32),
            (-np.sin(ang)).astype(np.float32))


@functools.lru_cache(maxsize=4)
def _inv_mat() -> np.ndarray:
    """Stacked inverse basis [2*BINS, F]: y = [Yr | Yi] @ inv, matching
    np.fft.irfft (half-spectrum weights 2 except DC/Nyquist, 1/F)."""
    n = np.arange(_F, dtype=np.float64)[None, :]
    b = np.arange(_BINS, dtype=np.float64)[:, None]
    ang = 2.0 * np.pi * b * n / _F
    w = np.full((_BINS, 1), 2.0)
    w[0] = w[-1] = 1.0
    icos = w * np.cos(ang) / _F
    isin = -w * np.sin(ang) / _F
    return np.concatenate([icos, isin], axis=0).astype(np.float32)


# -- host IR synthesis ----------------------------------------------------------


def design_ir(rate: int, channels: int, decay_s: float,
              pre_delay_ms: float, damping: float) -> np.ndarray:
    """[C, L] float32 impulse response, unit energy per channel.

    Spectral-decay synthesis (float64): per-bin RT60 shortens toward
    Nyquist with ``damping``; each STFT frame is white noise scaled by
    10^(-3 t / RT60(f)); Hann-OLA reconstruction (COLA at hop = n_fft/2).
    Deterministic: fixed seed, one RNG stream, so the same parameters
    always produce the same room (serde-stable)."""
    # Frame size scales with rate (~21 ms) so the per-frame decay grid
    # stays fine relative to even the shortest RT60 at any rate.
    n_fft = min(max(1 << int(round(math.log2(max(rate * 0.021, 64)))),
                    256), 2048)
    hop = n_fft // 2
    decay_s = float(decay_s)
    ln = max(int(round(decay_s * rate)), n_fft)
    frames = ln // hop + 2
    rng = np.random.default_rng(0xC0FFEE)
    bins = n_fft // 2 + 1
    freqs = np.arange(bins, dtype=np.float64) * rate / n_fft
    rt60 = decay_s * (1.0 - float(damping) * 0.85 * freqs / (rate / 2.0))
    rt60 = np.maximum(rt60, 0.05)
    t = np.arange(frames, dtype=np.float64)[:, None] * hop / rate
    env = 10.0 ** (-3.0 * t / rt60[None, :])
    win = np.hanning(n_fft + 1)[:n_fft]
    out = np.zeros((channels, frames * hop + n_fft), dtype=np.float64)
    for c in range(channels):
        xr = rng.standard_normal((frames, bins)) * env
        xi = rng.standard_normal((frames, bins)) * env
        xi[:, 0] = 0.0
        xi[:, -1] = 0.0
        seg = np.fft.irfft(xr + 1j * xi, n=n_fft, axis=-1) * win
        for f in range(frames):
            out[c, f * hop:f * hop + n_fft] += seg[f]
    ir = out[:, :ln]
    # Short attack fade-in (2 ms) so the onset is dense, not clicky.
    fade = min(int(0.002 * rate), ln)
    ir[:, :fade] *= np.linspace(0.0, 1.0, fade, endpoint=False)[None, :]
    ir /= np.sqrt(np.sum(ir * ir, axis=1, keepdims=True)) + 1e-30
    pre = int(round(float(pre_delay_ms) * 1e-3 * rate))
    if pre:
        ir = np.concatenate(
            [np.zeros((channels, pre)), ir], axis=1
        )
    return ir.astype(np.float32)


@functools.lru_cache(maxsize=8)
def ir_partitions(rate: int, channels: int, decay_s: float,
                  pre_delay_ms: float, damping: float):
    """Host-precomputed partition spectra: (Hr, Hi) [C, K, BINS] f32
    numpy constants (float64 rfft of P-sample partitions zero-padded to
    F), plus the raw IR length."""
    ir = design_ir(rate, channels, decay_s, pre_delay_ms, damping)
    ln = ir.shape[1]
    k = -(-ln // PARTITION)
    padded = np.zeros((channels, k, _F))
    flat = np.zeros((channels, k * PARTITION))
    flat[:, :ln] = ir
    padded[:, :, :PARTITION] = flat.reshape(channels, k, PARTITION)
    spec = np.fft.rfft(padded, axis=-1)
    return (spec.real.astype(np.float32), spec.imag.astype(np.float32), ln)


def ir_length(rate: int, decay_s: float, pre_delay_ms: float) -> int:
    """Static IR length in samples (the node's receptive field)."""
    ln = max(int(round(float(decay_s) * rate)), 1024)
    return ln + int(round(float(pre_delay_ms) * 1e-3 * rate))


# -- device tables ----------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _device_mats(device: torch.device):
    """The forward bases (cos, -sin) [F, BINS] and the stacked inverse
    basis [2*BINS, F] as float32 tensors on ``device``."""
    cos_m, msin_m = _fwd_mats()
    return tuple(torch.from_numpy(m).to(device)
                 for m in (cos_m, msin_m, _inv_mat()))


@functools.lru_cache(maxsize=8)
def _device_partitions(rate: int, channels: int, decay_s: float,
                       pre_delay_ms: float, damping: float,
                       device: torch.device):
    """``ir_partitions``'s (Hr, Hi) [C, K, BINS] on ``device``."""
    hr, hi, _ln = ir_partitions(rate, channels, decay_s, pre_delay_ms,
                                damping)
    return torch.from_numpy(hr).to(device), torch.from_numpy(hi).to(device)


def partitions(rate: int, channels: int, decay_s: float, pre_delay_ms: float,
               damping: float, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The partition spectra (Hr, Hi) [C, K, BINS] on ``device``, cached."""
    return _device_partitions(int(rate), int(channels), float(decay_s),
                              float(pre_delay_ms), float(damping),
                              torch.device(device))


# -- partitioned convolution (device) ---------------------------------------------


def _segments(x: torch.Tensor) -> torch.Tensor:
    """[..., C, T*P] -> overlap-save segments [..., C, T, F]: each hop is
    the previous P-block concatenated with the current one (zeros before
    the array start)."""
    t = x.shape[-1] // PARTITION
    blocks = x.reshape(*x.shape[:-1], t, PARTITION)
    prev = F.pad(blocks[..., :-1, :], (0, 0, 1, 0))
    return torch.cat([prev, blocks], dim=-1)


def _spectrum(seg: torch.Tensor, cos_m: torch.Tensor, msin_m: torch.Tensor,
              hr: torch.Tensor, hi: torch.Tensor,
              clips: bool = False) -> torch.Tensor:
    """The forward DFT of the overlap-save segments ``seg`` [.., C, T, F]
    on the bases' bin columns (``cos_m``, ``msin_m`` [F, bins]) and the
    frequency-domain delay line with the partition spectra ``hr``, ``hi``
    [C, K, bins] of the same columns: Y [.., C, T, 2, bins], whose last two
    axes are [Yr | Yi] (flattened, the layout the inverse basis takes).

    The delay line, Y[t] = sum_k X[t-k] (*) H[k], accumulates in place into
    the shifted slices of Y (complex product in split-real form; per
    element the JAX loop's order, ((y + xr hr) - xi hi) and ((y + xr hi) +
    xi hr), k ascending): 4 min(K, T) launches."""
    xr = scans._gemm(seg, cos_m, clips)
    xi = scans._gemm(seg, msin_m, clips)
    del seg
    k = hr.shape[1]
    t, bins = xr.shape[-2], xr.shape[-1]
    y = torch.zeros((*xr.shape[:-1], 2, bins), dtype=torch.float32,
                    device=xr.device)
    yr, yi = y[..., 0, :], y[..., 1, :]
    for kk in range(min(k, t)):
        sxr, sxi = xr[..., :t - kk, :], xi[..., :t - kk, :]
        hrk = hr[:, kk][:, None, :]                      # [C, 1, bins]
        hik = hi[:, kk][:, None, :]
        yr[..., kk:, :].addcmul_(sxr, hrk).addcmul_(sxi, hik, value=-1.0)
        yi[..., kk:, :].addcmul_(sxr, hik).addcmul_(sxi, hrk)
    return y


def partitioned_conv(x: torch.Tensor, hr: torch.Tensor, hi: torch.Tensor,
                     out_len: int, clips: bool = False) -> torch.Tensor:
    """Linear convolution of ``x`` [C, N] (or, with ``clips``, a batch [B,
    C, N]: the DFT GEMMs clip by clip) with the partitioned IR spectra
    (``hr``, ``hi`` [C, K, BINS] on x's device); returns [C, out_len] (or
    [B, C, out_len]) where ``out_len`` <= N_padded + K*P (callers pass N +
    L - 1)."""
    lead, n = x.shape[:-1], x.shape[-1]
    t = -(-out_len // PARTITION)
    need = t * PARTITION
    x = F.pad(x, (0, need - n)) if need > n else x[..., :need]
    cos_m, msin_m, inv = _device_mats(x.device)
    y = _spectrum(_segments(x), cos_m, msin_m, hr, hi, clips)
    out = scans._gemm(y.flatten(-2), inv, clips)
    del y
    # Overlap-save: the last P samples of each hop are valid.
    return out[..., PARTITION:].reshape(*lead, t * PARTITION)[..., :out_len]


# -- offline ---------------------------------------------------------------------


def reverb_stream(stream: Stream, decay_s: float, pre_delay_ms: float,
                  damping: float, wet: float, dry: float) -> Stream:
    """Offline reverb over a whole Stream. Output length grows by the IR
    tail (L - 1) when wet > 0; the capacity grows with it. Padding past
    the valid length is re-masked to exact zeros (the DFT path leaves
    ~-140 dB cancellation noise there). A batch's clips each grow from
    their own lengths; the capacity grows as one clip's."""
    if float(wet) == 0.0:
        out = stream.data if float(dry) == 1.0 else _f32(dry) * stream.data
        return stream.with_data(out, fmt=FMT_FLT)
    hr, hi = partitions(stream.rate, stream.channels, decay_s, pre_delay_ms,
                        damping, stream.data.device)
    ln_total = ir_length(stream.rate, decay_s, pre_delay_ms)
    cap_out = stream.capacity + -(-ln_total // PARTITION) * PARTITION
    x = mask_tail(stream.data, stream.length)
    wetpath = partitioned_conv(x, hr, hi, cap_out,
                               clips=stream.batch is not None)
    drypath = F.pad(x, (0, cap_out - stream.capacity))
    y = _f32(dry) * drypath + _f32(wet) * wetpath
    out_len = map_lengths(stream.length, lambda n: n + ln_total - 1)
    return Stream(
        data=mask_tail(y, out_len), length=out_len, rate=stream.rate,
        channels=stream.channels, fmt=FMT_FLT, t0_us=stream.t0_us,
    )


# -- streaming -------------------------------------------------------------------


def stream_ring_len(width: int, ir_len: int) -> int:
    """Static ring capacity for chunk width ``width``: one chunk's full
    convolution (width + IR, hop-padded)."""
    return -(-(width + ir_len) // PARTITION) * PARTITION


def reverb_stream_prepare(rate: int, channels: int, decay_s: float,
                          pre_delay_ms: float, damping: float, device):
    """Put the DFT bases and the partition spectra on ``device`` now, so a
    chunk step copies nothing from the host; returns (Hr, Hi)."""
    _device_mats(torch.device(device))
    return partitions(rate, channels, decay_s, pre_delay_ms, damping, device)


def reverb_stream_init(channels: int, width: int, ir_len: int, wet: float,
                       device):
    """(output ring [C, stream_ring_len], tail samples still to flush)."""
    ring = torch.zeros((channels, stream_ring_len(width, ir_len)),
                       dtype=torch.float32, device=device)
    return (ring, ir_len - 1 if float(wet) > 0.0 else 0)


def reverb_stream_step(params, state, data: torch.Tensor, n: int,
                       in_done: bool):
    """One chunk [C, W] with ``n`` valid. The chunk's full convolution
    accumulates into an output ring anchored at the chunk start; the
    first ``n`` ring samples ship with the dry path, then the ring
    shifts by ``n``. After input EOF, flush steps drain the IR tail
    (``rem`` counts down); done = input done and tail drained.
    Returns (state, out, out_n, done)."""
    hr, hi, _ir_len, wet, dry = params
    ring, rem = state
    w = data.shape[1]
    x = mask_tail(data, n)
    ring = ring + partitioned_conv(x, hr, hi, ring.shape[1]).mul_(_f32(wet))
    flushing = in_done and n <= 0
    out_n = min(w, rem) if flushing else n
    if flushing:
        rem -= out_n
    out = mask_tail(_f32(dry) * x + ring[:, :w], out_n)
    # Shift the ring left by out_n (a host count), zeros in.
    ring = F.pad(ring[:, out_n:], (0, out_n))
    return (ring, rem), out, out_n, in_done and rem <= 0
