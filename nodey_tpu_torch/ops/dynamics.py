"""Dynamics (port of nodey_tpu.ops.dynamics): the peak limiter, the
compressor, the noise gate and the de-esser.

Each detector is a serial recurrence evaluated as a scan (ops/scans.py):

* release:  e[n] = max(a[n], e[n-1] - c), a = log|x| floored: a prefix
  maximum under a constant per-sample decrement (``maxplus_scan``), the
  instant-attack / exponential-release envelope in the log domain;
* attack:   s[n] = alpha*s[n-1] + (1-alpha)*e[n]: an AR(1) with pole
  alpha (``ar1_scan``) plus the init's decay curve alpha^(n+1), computed
  on the host (``one_pole_log_scan``).

The limiter uses the release envelope alone (gain = min(1, T / env));
the compressor and the gate the two-stage detector with their static
curves; the de-esser the compressor's detector keyed by a bandpass of its
input, applied as band subtraction. Every detector is stereo-linked.

Below threshold the limiter, compressor (at 0 dB makeup), gate (at or
above its threshold) and de-esser pass their input bitwise: the gain is
selected as exactly 1.0, not computed.

Streaming carries the detectors' scalars at the previous chunk's last
valid sample (device tensors, so a step reads nothing back); the chunk's
valid count is a host int. ``*_stream_prepare`` puts the host decay
curves for a chunk width on the device at plan time. The sharded
functions (``*_sharded_local``) run over the list of a mesh axis's
shards, the carries crossing them as exclusive prefixes
(parallel/tv_sharded.py).

The offline forms also take a batch of clips, ``[B, C, N]``: each clip's
detector links its own channels (axis -2), never the other clips, and its
attack scan's GEMMs run on one clip's shapes (``scans._gemm``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from nodey_tpu_torch.core.stream import FMT_FLT, Stream
from nodey_tpu_torch.ops import biquad as bq
from nodey_tpu_torch.ops import scans
from nodey_tpu_torch.ops.scans import f32 as _f32, mask_tail

# Envelope floor (log domain) — also the streaming carry's initial value.
# exp(-60) ~ 9e-27: silence for any audio purpose, still far from f32
# denormals after a whole clip of decay.
_LOG_FLOOR = np.float32(-60.0)
_PEAK_FLOOR = float(np.float32(1e-26))    # keeps log(0) out


def _log_peak(x: torch.Tensor) -> torch.Tensor:
    """The stereo-linked peak of [C, N] in the floored log domain ([N]; a
    batch [B, C, N] gives each clip's, [B, N])."""
    peak = x.abs().amax(dim=-2)
    return torch.clamp_min(torch.log(torch.clamp_min(peak, _PEAK_FLOOR)),
                           float(_LOG_FLOOR))


def _carry_floor(device: torch.device) -> torch.Tensor:
    return torch.full((), float(_LOG_FLOOR), dtype=torch.float32,
                      device=device)


def envelope_log_scan(a: torch.Tensor, c: float) -> torch.Tensor:
    """Prefix maximum of ``a`` [..., N] under per-step decrement ``c``:
    env_log[..., n] = max_{k<=n} (a[..., k] - c*(n-k))."""
    return scans.maxplus_scan(a, c)


def _merge_env_carry(env_log: torch.Tensor, carry: torch.Tensor,
                     c: float) -> torch.Tensor:
    """The envelope with the carry just before its first sample decayed in:
    max(env_log[n], carry - c*(n+1))."""
    n_idx = torch.arange(1, env_log.shape[-1] + 1, dtype=torch.float32,
                         device=env_log.device)
    return torch.maximum(env_log, carry - _f32(c) * n_idx)


# -- limiter -------------------------------------------------------------------


def limiter_params(threshold_db: float, release_ms: float, rate: int):
    """(threshold_linear, per-sample log decrement c)."""
    threshold = float(10.0 ** (threshold_db / 20.0))
    release_samples = max(1.0, float(release_ms) * 1e-3 * rate)
    return threshold, 1.0 / release_samples


def limit_block(data: torch.Tensor, threshold: float, c: float,
                carry_log=None):
    """Limit [C, N] (or a batch [B, C, N]) float32 samples; returns (out,
    env_log [N] (or [B, N]), env_log at the last column). ``carry_log`` is
    the envelope (log) just before this block's first sample, or None for
    clip start."""
    env_log = envelope_log_scan(_log_peak(data), c)
    if carry_log is not None:
        env_log = _merge_env_carry(env_log, carry_log, c)
    env = torch.exp(env_log)
    g = torch.clamp_max(torch.div(_f32(threshold), env), 1.0)
    return data * g.unsqueeze(-2), env_log, env_log[..., -1]


def limit_stream(stream: Stream, threshold_db: float,
                 release_ms: float) -> Stream:
    """Offline limiter over a whole Stream (padding past ``length`` is
    zero, so it never raises the envelope; output stays masked)."""
    threshold, c = limiter_params(threshold_db, release_ms, stream.rate)
    out, _env, _carry = limit_block(stream.data, threshold, c)
    return stream.with_data(out, fmt=FMT_FLT)


def limiter_stream_init(channels: int, device: torch.device):
    """Streaming carry: the log envelope at the previous chunk's last
    valid sample (one scalar: the envelope is stereo-linked)."""
    return (_carry_floor(device),)


def limiter_stream_step(threshold: float, c: float, state,
                        data: torch.Tensor, n: int):
    """One chunk: data [C, W], n valid (a host int). Returns
    (state', out [C, W]). Invalid trailing samples do not advance time:
    the carry is the envelope at sample n-1."""
    (carry,) = state
    out, env_log, _tail = limit_block(mask_tail(data, n), threshold, c,
                                      carry_log=carry)
    if n <= 0:
        return (carry,), out
    return (env_log[min(n, data.shape[1]) - 1].clone(),), out


# -- compressor ----------------------------------------------------------------

_NAT_TO_DB = 20.0 / math.log(10.0)
_DB_TO_NAT = math.log(10.0) / 20.0


@dataclasses.dataclass(frozen=True)
class CompressorParams:
    threshold_db: float
    ratio: float
    knee_db: float
    alpha: float        # attack one-pole coefficient
    c: float            # release per-sample log decrement
    makeup: float       # linear makeup gain (exactly 1.0 for 0 dB)


def compressor_params(threshold_db: float, ratio: float, knee_db: float,
                      attack_ms: float, release_ms: float,
                      makeup_db: float, rate: int) -> CompressorParams:
    release_samples = max(1.0, float(release_ms) * 1e-3 * rate)
    attack_samples = max(1e-3, float(attack_ms) * 1e-3 * rate)
    return CompressorParams(
        threshold_db=float(threshold_db),
        ratio=max(1.0, float(ratio)),
        knee_db=max(0.0, float(knee_db)),
        alpha=math.exp(-1.0 / attack_samples),
        c=1.0 / release_samples,
        makeup=float(10.0 ** (float(makeup_db) / 20.0)),
    )


def one_pole_log_scan(e: torch.Tensor, alpha: float, init,
                      clips: bool = False) -> torch.Tensor:
    """s[n] = alpha*s[n-1] + (1-alpha)*e[n] with s[-1] = ``init``: an AR(1)
    with pole alpha on (1-alpha)*e plus the init's decay curve
    alpha^(n+1), computed on the host in float64 and cached on the device
    (it underflows to 0 once the init is forgotten). ``e`` is [N], or with
    ``clips`` a batch's [B, N] (the scan's GEMMs clip by clip)."""
    a32 = np.float32(alpha)
    v = scans.ar1_scan(float(np.float32(1.0) - a32) * e, alpha, clips)
    w = scans.device_powers(alpha, e.shape[-1], e.device)[0]
    return v + w * init


def compressor_gain_db(level_db: torch.Tensor,
                       p: CompressorParams) -> torch.Tensor:
    """Static gain computer (dB in, dB of gain out; <= 0). Below the
    knee the result is EXACTLY 0.0 (selected, not computed)."""
    slope = _f32(1.0 / p.ratio - 1.0)
    over = level_db - _f32(p.threshold_db)
    zero = torch.zeros((), dtype=torch.float32, device=level_db.device)
    if p.knee_db > 0.0:
        w = np.float32(p.knee_db)
        half, two_w = float(w / 2), float(2 * w)
        knee = slope * torch.square(over + half) / two_w
        g = torch.where(over >= half, slope * over, knee)
        return torch.where(over <= -half, zero, g)
    return torch.where(over > 0, slope * over, zero)


def _detect(key: torch.Tensor, alpha: float, c: float, carry_env=None,
            carry_s=None, clips: bool = False):
    """The two-stage detector on ``key`` [C, N] (or, with ``clips``, [B, C,
    N]): (env_log, s_log), each [N] (or [B, N])."""
    env_log = envelope_log_scan(_log_peak(key), c)
    if carry_env is not None:
        env_log = _merge_env_carry(env_log, carry_env, c)
    init = float(_LOG_FLOOR) if carry_s is None else carry_s
    return env_log, one_pole_log_scan(env_log, alpha, init, clips)


def _db_gain(g_db: torch.Tensor) -> torch.Tensor:
    return torch.exp(g_db * _f32(_DB_TO_NAT))


def compress_block(data: torch.Tensor, p: CompressorParams, carry_env=None,
                   carry_s=None, clips: bool = False):
    """Compress [C, N] float32 (or, with ``clips``, [B, C, N]); returns
    (out, env_log, s_log). ``carry_env``/``carry_s`` are the detector
    states just before this block's first sample (None = clip start: both
    at the floor)."""
    env_log, s_log = _detect(data, p.alpha, p.c, carry_env, carry_s, clips)
    g_db = compressor_gain_db(s_log * _f32(_NAT_TO_DB), p)
    gain = _f32(p.makeup) * _db_gain(g_db)
    return data * gain.unsqueeze(-2), env_log, s_log


def compress_stream(stream: Stream, threshold_db: float, ratio: float,
                    knee_db: float, attack_ms: float, release_ms: float,
                    makeup_db: float) -> Stream:
    """Offline compressor over a whole Stream (zero padding past
    ``length`` never raises the detector; output stays masked because
    0 * gain == 0)."""
    p = compressor_params(threshold_db, ratio, knee_db, attack_ms,
                          release_ms, makeup_db, stream.rate)
    out, _env, _s = compress_block(stream.data, p,
                                   clips=stream.batch is not None)
    return stream.with_data(out, fmt=FMT_FLT)


def _detector_init(device: torch.device):
    return (_carry_floor(device), _carry_floor(device))


def compressor_stream_init(channels: int, device: torch.device):
    """Streaming carry: (release envelope, attack smoother) at the
    previous chunk's last valid sample — two scalars (stereo-linked)."""
    return _detector_init(device)


def compressor_stream_prepare(p: CompressorParams, width: int,
                              device: torch.device) -> None:
    scans.prepare(p.alpha, width, device, powers=True)


def _detector_carry(state, env_log, s_log, n: int, width: int):
    """The detector states at sample n-1 (unchanged for an empty chunk)."""
    if n <= 0:
        return state
    last = min(n, width) - 1
    return (env_log[last].clone(), s_log[last].clone())


def compressor_stream_step(p: CompressorParams, state, data: torch.Tensor,
                           n: int):
    """One chunk: data [C, W], n valid. Invalid trailing samples do not
    advance either detector (carries are taken at sample n-1), so streamed
    output equals the offline render to scan re-association."""
    carry_env, carry_s = state
    out, env_log, s_log = compress_block(
        mask_tail(data, n), p, carry_env=carry_env, carry_s=carry_s)
    return _detector_carry(state, env_log, s_log, n, data.shape[1]), out


# -- noise gate ----------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GateParams:
    threshold_db: float
    ratio: float        # expansion ratio (>= 1); gain slope = ratio - 1
    range_db: float     # maximum attenuation
    alpha: float        # attack one-pole coefficient
    c: float            # release per-sample log decrement


def gate_params(threshold_db: float, ratio: float, range_db: float,
                attack_ms: float, release_ms: float,
                rate: int) -> GateParams:
    release_samples = max(1.0, float(release_ms) * 1e-3 * rate)
    attack_samples = max(1e-3, float(attack_ms) * 1e-3 * rate)
    return GateParams(
        threshold_db=float(threshold_db),
        ratio=max(1.0, float(ratio)),
        range_db=max(0.0, float(range_db)),
        alpha=math.exp(-1.0 / attack_samples),
        c=1.0 / release_samples,
    )


def gate_gain_db(level_db: torch.Tensor, p: GateParams) -> torch.Tensor:
    """Static gate curve (dB in, dB of gain out; <= 0). At or above the
    threshold the result is EXACTLY 0.0."""
    under = level_db - _f32(p.threshold_db)
    g = torch.clamp_min(_f32(p.ratio - 1.0) * under, -_f32(p.range_db))
    zero = torch.zeros((), dtype=torch.float32, device=level_db.device)
    return torch.where(under >= 0, zero, g)


def gate_block(data: torch.Tensor, p: GateParams, carry_env=None,
               carry_s=None, clips: bool = False):
    """Gate [C, N] float32 (or, with ``clips``, [B, C, N]); returns (out,
    env_log, s_log) — the compressor's detector with the gate's curve."""
    env_log, s_log = _detect(data, p.alpha, p.c, carry_env, carry_s, clips)
    gain = _db_gain(gate_gain_db(s_log * _f32(_NAT_TO_DB), p))
    return data * gain.unsqueeze(-2), env_log, s_log


def gate_stream(stream: Stream, threshold_db: float, ratio: float,
                range_db: float, attack_ms: float,
                release_ms: float) -> Stream:
    """Offline gate over a whole Stream."""
    p = gate_params(threshold_db, ratio, range_db, attack_ms,
                    release_ms, stream.rate)
    out, _env, _s = gate_block(stream.data, p,
                               clips=stream.batch is not None)
    return stream.with_data(out, fmt=FMT_FLT)


def gate_stream_init(channels: int, device: torch.device):
    return _detector_init(device)


def gate_stream_prepare(p: GateParams, width: int,
                        device: torch.device) -> None:
    scans.prepare(p.alpha, width, device, powers=True)


def gate_stream_step(p: GateParams, state, data: torch.Tensor, n: int):
    """One chunk: data [C, W], n valid — compressor_stream_step with the
    gate's curve."""
    carry_env, carry_s = state
    out, env_log, s_log = gate_block(
        mask_tail(data, n), p, carry_env=carry_env, carry_s=carry_s)
    return _detector_carry(state, env_log, s_log, n, data.shape[1]), out


# -- de-esser ------------------------------------------------------------------


def deesser_params(threshold_db: float, ratio: float, attack_ms: float,
                   release_ms: float, rate: int) -> CompressorParams:
    """The de-esser reuses CompressorParams with no knee and no makeup
    (pure attenuation)."""
    return compressor_params(threshold_db, ratio, 0.0, attack_ms,
                             release_ms, 0.0, rate)


def deess_block(x: torch.Tensor, band: torch.Tensor, p: CompressorParams,
                carry_env=None, carry_s=None, clips: bool = False):
    """De-ess [C, N] float32 (or, with ``clips``, [B, C, N]) given its
    sidechain band; returns (out, env_log, s_log): the compressor's
    detector on ``band``, applied as band subtraction out = x - (1 - g) *
    band."""
    env_log, s_log = _detect(band, p.alpha, p.c, carry_env, carry_s, clips)
    g = _db_gain(compressor_gain_db(s_log * _f32(_NAT_TO_DB), p))
    return x - (1.0 - g).unsqueeze(-2) * band, env_log, s_log


def deesser_sections(freq: float, q: float, rate: int):
    return bq.prepare_all([bq.bandpass(freq, q, rate)])


def deess_stream(stream: Stream, threshold_db: float, ratio: float,
                 freq: float, q: float, attack_ms: float,
                 release_ms: float) -> Stream:
    """Offline de-esser over a whole Stream."""
    sections = deesser_sections(freq, q, stream.rate)
    p = deesser_params(threshold_db, ratio, attack_ms, release_ms,
                       stream.rate)
    clips = stream.batch is not None
    x = mask_tail(stream.data, stream.length)
    band, _ = bq.cascade_apply(x, sections, clips=clips)
    out, _, _ = deess_block(x, band, p, clips=clips)
    return stream.with_data(mask_tail(out, stream.length), fmt=FMT_FLT)


def deesser_stream_init(channels: int, sections, device: torch.device):
    return (bq.cascade_stream_init(channels, sections, device),
            *_detector_init(device))


def deesser_stream_prepare(sections, p: CompressorParams, width: int,
                           device: torch.device) -> None:
    bq.cascade_stream_prepare(sections, width, device)
    scans.prepare(p.alpha, width, device, powers=True)


def deesser_stream_step(sections, p: CompressorParams, state,
                        data: torch.Tensor, n: int):
    """One chunk [C, W], n valid: the band through the carried bandpass
    state, the detector through the carried scalars — all taken at sample
    n-1."""
    bq_state, carry_env, carry_s = state
    x = mask_tail(data, n)
    new_bq, band = bq.cascade_stream_step(sections, bq_state, x, n)
    out, env_log, s_log = deess_block(x, band, p, carry_env=carry_env,
                                      carry_s=carry_s)
    det = _detector_carry((carry_env, carry_s), env_log, s_log, n,
                          data.shape[1])
    return (new_bq, *det), out


# -- sharding ------------------------------------------------------------------
#
# The sp chain's detectors (parallel/tv_sharded.py). Each function takes the
# list of the shards' equal [C, chunk] time slices along one mesh axis (zero
# past the valid length, as every sharded stage keeps them) and returns
# theirs. The cross-shard coupling is the streaming carry evaluated across
# the mesh: each shard reduces its chunk to one scalar summary, and a
# log2(sp)-step Hillis-Steele doubling over ``ppermute`` forms the exclusive
# prefix, combined in the JAX package's order. Zero samples cannot raise an
# envelope, so a shard's padded chunk scans as the offline render's
# full-capacity scan does.


def _cross_shard_maxplus(m_ends, chunk: int, c: float):
    """Exclusive cross-shard max-plus prefix of the shards' envelope
    summaries: shard i receives the envelope at the END of shard i-1 (the
    floor on shard 0, ``limit_block``'s clip start). The received summary
    is the LEFT operand of (m_l, L_l) . (m_r, L_r) = (max(m_l - c*L_r,
    m_r), L_l + L_r); a shard's span at step d is d*chunk samples, so only
    the scalar m moves. ``ppermute``'s zeros are not the max-plus identity:
    a shard combines at step d only if its index is >= d."""
    from nodey_tpu_torch.parallel.ops import ppermute

    c32 = np.float32(c)
    sp = len(m_ends)
    v = list(m_ends)
    d = 1
    while d < sp:
        r = ppermute(v, [(i, i + d) for i in range(sp - d)])
        dec = float(c32 * np.float32(d * chunk))
        v = v[:d] + [torch.maximum(r[i] - dec, v[i]) for i in range(d, sp)]
        d *= 2
    prefix = ppermute(v, [(i, i + 1) for i in range(sp - 1)])
    prefix[0] = torch.full_like(prefix[0], float(_LOG_FLOOR))
    return prefix


def _sharded_env_log(xs, c: float):
    """Each shard's exact global log envelope: the local scan, merged with
    the cross-shard max-plus prefix the way ``limit_block`` merges a
    streaming carry."""
    chunk = xs[0].shape[-1]
    env_local = [envelope_log_scan(_log_peak(x), c) for x in xs]
    prefix = _cross_shard_maxplus([e[-1] for e in env_local], chunk, c)
    return [_merge_env_carry(e, p, c) for e, p in zip(env_local, prefix)]


def limiter_sharded_local(xs, threshold: float, c: float):
    """The limiter over the shards ``xs`` of one mesh axis: the exact
    global envelope (``_sharded_env_log``), then ``limit_block``'s gain.
    The only re-associated term against the offline scan is c*L."""
    out = []
    for x, env_log in zip(xs, _sharded_env_log(xs, c)):
        g = torch.clamp_max(torch.div(_f32(threshold), torch.exp(env_log)),
                            1.0)
        out.append(x * g[None, :])
    return out


def _sharded_s_log(xs, alpha: float, c: float):
    """Each shard's exact global SMOOTHED log level: the sharded release
    envelope through the one-pole attack smoother, its state crossing the
    shards by an affine doubling whose step weight alpha^(d*chunk) is
    static (only the scalar value moves). The detector the compressor, the
    gate and the de-esser share."""
    from nodey_tpu_torch.parallel.ops import ppermute

    chunk = xs[0].shape[-1]
    sp = len(xs)
    a32 = np.float32(alpha)
    env_logs = _sharded_env_log(xs, c)
    # Local inclusive affine scans from zero; the init's contribution is
    # added after the cross-shard prefix below.
    v_incl = [scans.ar1_scan(float(np.float32(1.0) - a32) * e, alpha)
              for e in env_logs]
    v = [x[-1] for x in v_incl]
    d = 1
    while d < sp:
        r = ppermute(v, [(i, i + d) for i in range(sp - d)])
        weight = _f32(alpha ** (d * chunk))
        v = v[:d] + [r[i] * weight + v[i] for i in range(d, sp)]
        d *= 2
    prev = ppermute(v, [(i, i + 1) for i in range(sp - 1)])
    prev[0] = torch.zeros_like(prev[0])
    out = []
    for i, (vi, p) in enumerate(zip(v_incl, prev)):
        # s at the end of shard i-1: its accumulated sum plus the global
        # floor init decayed over i*chunk samples (float32, as the JAX
        # package computes it on the device).
        init_w = torch.exp(
            torch.tensor(float(i), dtype=torch.float32, device=vi.device)
            * _f32(chunk * math.log(alpha)))
        s_prev = p + init_w * float(_LOG_FLOOR)
        w_incl = scans.device_powers(alpha, chunk, vi.device)[0]
        out.append(vi + w_incl * s_prev)
    return out


def compressor_sharded_local(xs, p: CompressorParams):
    """The compressor over the shards ``xs`` of one mesh axis: two
    cross-shard prefixes (max-plus release, affine attack smoother), the
    smoother running on the corrected envelope, so it sees the offline
    input sequence."""
    out = []
    for x, s_log in zip(xs, _sharded_s_log(xs, p.alpha, p.c)):
        g_db = compressor_gain_db(s_log * _f32(_NAT_TO_DB), p)
        out.append(x * (_f32(p.makeup) * _db_gain(g_db))[None, :])
    return out


def gate_sharded_local(xs, p: GateParams):
    """The gate over the shards ``xs``: the compressor's sharded detector
    with the gate's static curve."""
    out = []
    for x, s_log in zip(xs, _sharded_s_log(xs, p.alpha, p.c)):
        g_db = gate_gain_db(s_log * _f32(_NAT_TO_DB), p)
        out.append(x * _db_gain(g_db)[None, :])
    return out


def deesser_sharded_local(xs, sections, p: CompressorParams):
    """The de-esser over the shards ``xs``: the exact sharded band
    (``biquad.cascade_sharded_local``) into the sharded detector, then the
    static curve and the band subtraction."""
    bands = bq.cascade_sharded_local(xs, list(sections))
    out = []
    for x, band, s_log in zip(xs, bands, _sharded_s_log(bands, p.alpha,
                                                        p.c)):
        g = _db_gain(compressor_gain_db(s_log * _f32(_NAT_TO_DB), p))
        out.append(x - (1.0 - g)[None, :] * band)
    return out
