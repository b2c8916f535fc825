"""The phase-path kernel's host-side tables (``cuda_pv.phase_tables``), on
the CPU.

The kernel (``csrc/pv_phase_path.cu``) reads the per-frame
``hop_over_dpos`` and the per-bin ``omega_hop`` from these tables and takes
``(b*dpos) mod n_fft`` as ``& (n_fft - 1)``. Held here, bitwise:

- the tables are the values that the plain ``pv._advance`` uploads, at
  config 4's two PV geometries (300 s at 48 kHz, tempo 2^(-1/3) and 1.25)
  and at the goldens' rates and tempi;
- ``hop_over_dpos`` is the JAX package's ``np.float32(hop) /
  dpos.astype(np.float32)`` (``nodey_tpu/ops/pallas_phase.py:133``) on
  every frame;
- the mask is ``% n_fft`` on every bin and every hop of those geometries;
- the kernel's wrap counts turns by thresholds (``turns_of``), which give
  ``rint(dphi / 2pi_f)`` with IEEE division on every float below 7 pi;
- the kernel's advance, emulated in numpy from the tables (three float32
  FMAs, each rounded once, and the thresholds), is ``pv._advance`` (which
  rounds each exact multiply-add to float64 first) bitwise wherever that
  float64 rounding does not land on a float32 tie, and the wrap's
  multiply-add is exact in float64 on every element;
- a non-power-of-two ``n_fft`` is refused.
"""

import math
import pathlib
import re

import numpy as np
import pytest
import torch

from make_pv_goldens import CASES
from nodey_tpu_torch.ops import cuda_pv, pv

# (rate, tempo, seconds): config 4's two PV stages, then the goldens' cases.
GEOMETRIES = [(48_000, 2.0 ** (-1.0 / 3.0), 300.0), (48_000, 1.25, 300.0)] + [
    (rate, tempo, 1.2) for rate, tempo in CASES]
FRAMES = 130  # frames of each geometry that go through pv._advance
TWO_PI_F = np.float32(2.0 * math.pi)
SOURCE = (pathlib.Path(__file__).resolve().parents[1] / "nodey_tpu_torch" /
          "csrc" / "pv_phase_path.cu")


def _turn_thresholds():
    """The kernel's kTurn1..3 (hex float literals), as float32."""
    found = dict(re.findall(r"constexpr float kTurn(\d) = (0x[0-9a-fp.+-]+)f;",
                            SOURCE.read_text()))
    assert sorted(found) == ["1", "2", "3"]
    return [np.float32(float.fromhex(found[m])) for m in "123"]


def _turns(dphi):
    """The kernel's turns_of: copysign(#thresholds <= |dphi|, dphi)."""
    a = np.abs(dphi)
    n = sum((a >= t).astype(np.float32) for t in _turn_thresholds())
    return np.copysign(n, dphi).astype(np.float32)


def _geometry(rate, tempo, seconds):
    n_fft, hop, _, dpos, _ = pv._pv_geometry(int(rate * seconds), tempo, rate)
    return n_fft, hop, dpos


def _uploads(monkeypatch, ph, dpos, hop, n_fft):
    """pv._advance(ph, ...) and the float32 tables it uploads."""
    seen = []
    from_numpy = torch.from_numpy

    def recording(a):
        seen.append(a)
        return from_numpy(a)

    monkeypatch.setattr(torch, "from_numpy", recording)
    adv = pv._advance(ph, dpos, hop, n_fft)
    monkeypatch.undo()
    tables = [a for a in seen if a.dtype == np.float32]
    assert len(tables) == 2
    return adv, tables[0].reshape(-1), tables[1]


def _fmaf(a, b, c):
    """(a*b + c rounded once to float32, whether the float64 rounding of
    the exact value is a float32 tie that the exact value is not): the
    product of two float32s is exact in float64, TwoSum gives the error of
    the float64 sum, and that error decides only a tie."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c = c.astype(np.float64)
    s = p + c
    back = s - p
    error = (p - (s - back)) + (c - back)
    r = s.astype(np.float32)
    other = np.nextafter(r, np.where(s > r, np.inf, -np.inf).astype(np.float32))
    tie = (s != r) & (s == (r.astype(np.float64) + other) / 2) & (error != 0)
    away = tie & ((error > 0) == (other > r))
    return np.where(away, other, r), tie


def _kernel_advance(ph, dpos, hop_over_dpos, omega_hop, n_fft):
    """(The kernel's advance of frames 1.. from the tables, in numpy; where
    a float64 rounding of its multiply-adds lands on a tie)."""
    d = ph[:, 1:] - ph[:, :-1]
    b = np.arange(ph.shape[-1])
    omega_dpos = ((b[None, :] * dpos[1:, None]) & (n_fft - 1)).astype(
        np.float32)
    neg_scale = -np.float32(2.0 * math.pi / n_fft)
    dphi, tie1 = _fmaf(omega_dpos, neg_scale, d)
    turns = _turns(dphi)
    wrapped, tie2 = _fmaf(turns, -TWO_PI_F, dphi)
    # The wrap's multiply-add is exact in float64 (the kernel's comment).
    product = turns.astype(np.float64) * -np.float64(TWO_PI_F)
    total = product + dphi
    back = total - product
    assert not ((product - (total - back)) + (dphi - back)).any()
    adv, tie3 = _fmaf(wrapped, hop_over_dpos[1:, None], omega_hop[None, :])
    return adv, tie1 | tie2 | tie3


def _assert_plain_advance(got, want, tie):
    """pv._advance is the kernel's advance but where a tie may differ."""
    differ = got.view(np.int32) != want.view(np.int32)
    assert not (differ & ~tie).any()


def test_turn_thresholds_are_the_rounded_quotients():
    """Each kTurnM rounds to M turns and the float below it to M - 1: the
    quotient never falls as |dphi| grows, so that decides every float
    below 7 pi, where 4 turns begin. The turns of random floats there, of
    +-0 and of tiny values are rint(dphi / 2pi_f), signed zeros included."""
    for m, t in enumerate(_turn_thresholds(), start=1):
        below = np.nextafter(t, np.float32(0))
        assert np.rint(t / TWO_PI_F) == m
        assert np.rint(below / TWO_PI_F) == m - 1
    rng = np.random.default_rng(7)
    dphi = (rng.uniform(-7 * np.pi, 7 * np.pi, 1 << 20)).astype(np.float32)
    dphi = np.concatenate([dphi, np.float32([0.0, -0.0, 1e-30, -1e-30])] + [
        np.float32([t, -t, np.nextafter(t, np.float32(0)),
                    -np.nextafter(t, np.float32(0))])
        for t in _turn_thresholds()])
    want = np.rint(dphi / TWO_PI_F).astype(np.float32)
    assert np.array_equal(_turns(dphi).view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("rate,tempo,seconds", GEOMETRIES)
def test_tables_are_the_plain_advance_constants(monkeypatch, rate, tempo,
                                                seconds):
    n_fft, hop, dpos = _geometry(rate, tempo, seconds)
    hop_over_dpos, omega_hop = cuda_pv.phase_tables(dpos, hop, n_fft)
    K, B = len(dpos), n_fft // 2 + 1
    assert hop_over_dpos.shape == (K,) and omega_hop.shape == (B,)
    assert hop_over_dpos.dtype == omega_hop.dtype == np.float32
    # Phases uniform on [-pi, pi) over the geometry's first frames (the
    # tables cover all K; the advance needs only the first FRAMES).
    frames = min(FRAMES, K)
    rng = np.random.default_rng(K)
    ph = torch.from_numpy(rng.uniform(-np.pi, np.pi, (2, frames, B)).astype(
        np.float32))
    short = dpos[:frames]
    adv, up_hod, up_omega = _uploads(monkeypatch, ph, short, hop, n_fft)
    assert np.array_equal(up_hod.view(np.int32),
                          hop_over_dpos[1:frames].view(np.int32))
    assert np.array_equal(up_omega.view(np.int32), omega_hop.view(np.int32))
    want, tie = _kernel_advance(ph.numpy(), short, hop_over_dpos[:frames],
                                omega_hop, n_fft)
    _assert_plain_advance(adv.numpy(), want, tie)


@pytest.mark.parametrize("rate,tempo", CASES)
def test_kernel_advance_is_the_plain_advance_on_real_phases(rate, tempo):
    """The goldens' signal: phases of real frames, leakage bins and all."""
    from make_pv_goldens import case_signal

    data = case_signal(rate)
    n_fft, hop, pos, dpos, pad_to = pv._pv_geometry(data.shape[1], tempo, rate)
    re, im = pv._analysis(torch.from_numpy(data), pos, pad_to, n_fft)
    ph = pv._magnitude_phase(re, im)[1]
    hop_over_dpos, omega_hop = cuda_pv.phase_tables(dpos, hop, n_fft)
    want, tie = _kernel_advance(ph.numpy(), dpos, hop_over_dpos, omega_hop,
                                n_fft)
    _assert_plain_advance(pv._advance(ph, dpos, hop, n_fft).numpy(), want, tie)


@pytest.mark.parametrize("rate,tempo,seconds", GEOMETRIES)
def test_hop_over_dpos_is_the_jax_packages(rate, tempo, seconds):
    n_fft, hop, dpos = _geometry(rate, tempo, seconds)
    hop_over_dpos = cuda_pv.phase_tables(dpos, hop, n_fft)[0]
    jax_hod = np.float32(hop) / dpos.astype(np.float32)
    assert np.array_equal(hop_over_dpos[1:].view(np.int32),
                          jax_hod[1:].view(np.int32))


def test_mask_is_the_remainder():
    for rate, tempo, seconds in GEOMETRIES:
        n_fft, _, dpos = _geometry(rate, tempo, seconds)
        b = np.arange(n_fft // 2 + 1, dtype=np.int32)
        hops = np.unique(dpos[1:]).astype(np.int32)
        products = b[None, :] * hops[:, None]
        assert np.array_equal(products & (n_fft - 1), products % n_fft)


@pytest.mark.parametrize("n_fft", [0, 3, 1536, 2047])
def test_tables_refuse_a_non_power_of_two(n_fft):
    with pytest.raises(ValueError, match="power of two"):
        cuda_pv.phase_tables(np.array([4, 4, 5]), 4, n_fft)
