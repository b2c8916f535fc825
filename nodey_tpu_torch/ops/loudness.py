"""Loudness measurement (ITU-R BS.1770-4) and normalization gain (port
of nodey_tpu.ops.loudness), behind ``audio_normalize``.

**Peak mode**: gain = 10^(target/20) / max|x| — one global reduction.

**LUFS mode** (integrated loudness, BS.1770-4):

1. K-weighting: two fixed biquads — a +4 dB high shelf then a ~38 Hz
   high-pass. At 48 kHz the spec's coefficient table ships verbatim; other
   rates re-derive via the RBJ cookbook from the de-facto analog
   parameters. Filtering runs on the EQ's scans (ops/biquad.py).
2. Mean-square per 400 ms block at 75 % overlap (100 ms hop), as hop-chunk
   partial sums then 4-chunk windows (no cumsum over the clip).
3. Gating: absolute at -70 LKFS, then relative at 10 LU below the
   absolute-gated mean, as masked means over the block set.
4. L_int = -0.691 + 10 log10(mean over gated blocks of the channel-weight
   sum), channel weights 1.0 for mono and stereo.

The measurement stays on the device (no value is read back to the host);
the gain is a float32 tensor of shape [1, 1], which broadcasts against the
clip's [C, N]. Whole-clip by construction, so the node refuses chunk
streaming and the export falls back to the offline render.

A batch of clips (``[B, C, N]``, a tuple of host lengths, ``clips``) gives
a [B, 1, 1] gain, each clip's from its own samples and its own valid
blocks: the K-weighting's GEMMs run clip by clip (ops/scans.py), the block
sums and the gates over the whole batch.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

from nodey_tpu_torch.core.stream import map_lengths, zero_tail
from nodey_tpu_torch.ops import biquad as bq
from nodey_tpu_torch.ops.scans import mask_tail

# BS.1770-4 Table 1/2 coefficients, exact at 48 kHz.
_SHELF_48K = ([1.53512485958697, -2.69169618940638, 1.19839281085285],
              [-1.69065929318241, 0.73248077421585])
_HP_48K = ([1.0, -2.0, 1.0],
           [-1.99004745483398, 0.99007225036621])

# De-facto analog parameters behind the 48 kHz table (Mansbridge /
# pyloudnorm re-derivation) for other sample rates.
_SHELF_F, _SHELF_G, _SHELF_Q = 1681.9744509555319, 3.99984385397, \
    0.7071752369554193
_HP_F, _HP_Q = 38.13547087613982, 0.5003270373253953

ABS_GATE_LKFS = -70.0
REL_GATE_LU = 10.0
BLOCK_S = 0.400
HOP_S = 0.100
_OFFSET = -0.691
_SILENCE_FLOOR = -120.0        # returned when no block passes the gate


def _coef(b: List[float], a: List[float]) -> bq.BiquadCoef:
    return bq.BiquadCoef(b0=b[0], b1=b[1], b2=b[2], a1=a[0], a2=a[1])


def k_weight_coeffs(rate: int) -> List[bq.BiquadCoef]:
    """The two K-weighting biquads for ``rate`` (float64 host design)."""
    if rate == 48_000:
        return [_coef(*_SHELF_48K), _coef(*_HP_48K)]
    # RBJ high shelf at (f, G, Q).
    A = 10.0 ** (_SHELF_G / 40.0)
    w0 = 2.0 * math.pi * _SHELF_F / rate
    alpha = math.sin(w0) / (2.0 * _SHELF_Q)
    cw = math.cos(w0)
    sqA = math.sqrt(A)
    b0 = A * ((A + 1) + (A - 1) * cw + 2 * sqA * alpha)
    b1 = -2 * A * ((A - 1) + (A + 1) * cw)
    b2 = A * ((A + 1) + (A - 1) * cw - 2 * sqA * alpha)
    a0 = (A + 1) - (A - 1) * cw + 2 * sqA * alpha
    a1 = 2 * ((A - 1) - (A + 1) * cw)
    a2 = (A + 1) - (A - 1) * cw - 2 * sqA * alpha
    shelf = _coef([b0 / a0, b1 / a0, b2 / a0], [a1 / a0, a2 / a0])
    # RBJ high-pass at (f, Q).
    w0 = 2.0 * math.pi * _HP_F / rate
    alpha = math.sin(w0) / (2.0 * _HP_Q)
    cw = math.cos(w0)
    a0 = 1 + alpha
    hp = _coef(
        [(1 + cw) / 2 / a0, -(1 + cw) / a0, (1 + cw) / 2 / a0],
        [-2 * cw / a0, (1 - alpha) / a0],
    )
    return [shelf, hp]


def block_geometry(rate: int, capacity: int) -> Tuple[int, int, int]:
    """(hop, per_block, n_hops): 100 ms hop chunks; one gating block is
    ``per_block`` consecutive hops (4 at standard rates)."""
    hop = max(int(round(HOP_S * rate)), 1)
    per_block = max(int(round(BLOCK_S / HOP_S)), 1)
    n_hops = capacity // hop
    return hop, per_block, n_hops


def _scalar(value: float, device: torch.device) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=device)


def integrated_lufs(data: torch.Tensor, length, rate: int,
                    clips: bool = False) -> torch.Tensor:
    """Integrated loudness (LKFS) of ``data`` [C, N] with valid prefix
    ``length``, a float32 0-dim tensor on ``data``'s device; silent or
    short clips (no gated block) give ``_SILENCE_FLOOR``. With ``clips``,
    a batch [B, C, N] with a tuple of B lengths gives [B], each clip's
    own."""
    sections = bq.prepare_all(k_weight_coeffs(rate))
    cap = data.shape[-1]
    z, _ = bq.cascade_apply(mask_tail(data, length), sections, clips=clips)

    hop, per_block, n_hops = block_geometry(rate, cap)
    if n_hops < per_block:
        return _scalar(_SILENCE_FLOOR, data.device).expand(data.shape[:-2])
    # Per-channel hop-chunk power sums, then 4-hop block means.
    zz = z[..., : n_hops * hop] ** 2
    hop_sums = zz.reshape(*z.shape[:-1], n_hops, hop).sum(dim=-1)
    n_blocks = n_hops - per_block + 1
    w = torch.stack([
        hop_sums[..., i: i + n_blocks] for i in range(per_block)
    ]).sum(dim=0)                               # [.., C, n_blocks]
    ms = w / float(per_block * hop)
    power = ms.sum(dim=-2)                      # channel weights 1.0
    # A block is measurable only if it lies inside its clip's valid prefix.
    n_valid = map_lengths(
        length, lambda n: min(max(n // hop - per_block + 1, 0), n_blocks))
    valid = zero_tail(torch.ones_like(ms[..., :1, :], dtype=torch.bool),
                      n_valid)[..., 0, :]

    floor = 10.0 ** ((ABS_GATE_LKFS - _OFFSET) / 10.0)
    l_abs = valid & (power > floor)

    def gated_mean(mask):
        cnt = mask.sum(dim=-1)
        s = torch.where(mask, power, 0.0).sum(dim=-1)
        return s / torch.clamp_min(cnt, 1).to(torch.float32), cnt

    m_abs, c_abs = gated_mean(l_abs)
    # Relative gate: 10 LU below the absolute-gated mean loudness.
    rel_floor = m_abs * float(10.0 ** (-REL_GATE_LU / 10.0))
    l_rel = l_abs & (power > rel_floor[..., None])
    m_rel, c_rel = gated_mean(l_rel)
    lufs = _OFFSET + (10.0 / math.log(10.0)) * torch.log(
        torch.clamp_min(m_rel, 1e-30))
    return torch.where((c_abs > 0) & (c_rel > 0), lufs,
                       _scalar(_SILENCE_FLOOR, data.device))


def normalize_gain_lufs(data: torch.Tensor, length, rate: int,
                        target_db: float,
                        clips: bool = False) -> torch.Tensor:
    """Linear gain bringing integrated loudness to ``target_db`` LUFS;
    1.0 for silence (nothing to scale to). [1, 1], or [B, 1, 1] for a
    batch (``clips``)."""
    measured = integrated_lufs(data, length, rate, clips)
    gain = torch.exp((math.log(10.0) / 20.0) * (float(target_db) - measured))
    return torch.where(measured <= _SILENCE_FLOOR + 1.0,
                       _scalar(1.0, data.device), gain)[..., None, None]


def normalize_gain_peak(data: torch.Tensor, length,
                        target_db: float) -> torch.Tensor:
    """Linear gain bringing the sample peak to ``target_db`` dBFS; 1.0
    for silence. [1, 1], or for a batch [B, C, N] with B lengths [B, 1, 1],
    each from its own clip's peak (a maximum: exact in any order)."""
    peak = zero_tail(data.abs(), map_lengths(length, lambda n: max(n, 0))
                     ).amax(dim=(-2, -1), keepdim=True)
    target = float(10.0 ** (float(target_db) / 20.0))
    return torch.where(peak > 0.0,
                       torch.div(target, torch.clamp_min(peak, 1e-30)),
                       _scalar(1.0, data.device))
