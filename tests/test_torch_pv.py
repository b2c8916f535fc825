"""The port's phase vocoder against the JAX package, on the CPU.

The same inputs, made with numpy from a seed, go through both packages.
The JAX side runs as its own tests run it: the Pallas kernels in
interpret mode, the XLA formulation jitted.

- The phase path (``pv.phase_path_plain``, the plain version of the
  phase-path kernel) against ``pallas_phase.phase_path_pallas`` and the
  XLA formulation, with and without lock: >= 100 dB on both synthesis
  planes. The prefix products are associated in other orders and the
  transcendentals differ by ulps, so the planes are not bitwise.
- The lock (``pv._lock_to_peaks``) against ``pallas_lock`` and the jitted
  ``pv._lock_to_peaks`` on equal inputs: within 2e-6 (equal peak
  decisions; the rotation's cos/sin and its multiply-add differ by ulps).
- ``pv_stretch_at_rate`` on the goldens' 1.2 s signal: equal lengths and
  >= 95 dB against the JAX package over the valid length, and >= 90 dB
  against the frozen windows of ``tests/goldens/pv.npz``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import snr_db
from make_pv_goldens import CASES, OPTION_CASES, case_signal, windows
from nodey_tpu.ops import pv as jpv
from nodey_tpu.ops.pallas_lock import lock_to_peaks_pallas
from nodey_tpu.ops.pallas_phase import phase_path_pallas
from nodey_tpu_torch.core.errors import ProcessorRuntimeError
from nodey_tpu_torch.ops import pv
from test_pallas_phase import _xla_planes

PLANE_DB = 100.0
STRETCH_DB = 95.0
GOLDEN_DB = 90.0
LOCK_TOL = 2e-6


def _planes(rate, tempo):
    """The port's analysis planes of the golden signal, with geometry."""
    data = case_signal(rate)
    n_fft, hop, pos, dpos, pad_to = pv._pv_geometry(data.shape[1], tempo, rate)
    re, im = pv._analysis(torch.from_numpy(data), pos, pad_to, n_fft)
    return re, im, n_fft, hop, dpos


@pytest.mark.parametrize("lock", [True, False])
@pytest.mark.parametrize("rate,tempo", [(48_000, 0.8), (44_100, 1.25)])
def test_plain_phase_path_matches_jax(rate, tempo, lock):
    re, im, n_fft, hop, dpos = _planes(rate, tempo)
    assert re.shape[1] > 80  # a few hundred frames, several kernel tiles
    got = pv.phase_path_plain(re, im, dpos, hop, n_fft, lock)
    jre, jim = jnp.asarray(re.numpy()), jnp.asarray(im.numpy())
    kernel = phase_path_pallas(jre, jim, dpos, hop, n_fft, lock=lock,
                               interpret=True)
    xla = _xla_planes(jre, jim, dpos, hop, n_fft, lock)
    for want in (kernel, xla):
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert g.shape == w.shape
            assert snr_db(w.ravel()[None], g.numpy().ravel()[None]) >= PLANE_DB


def _lock_planes(C, K, B, seed, silent_rows=()):
    """Unit phasors, phases and smooth magnitudes (sparse peaks, as in
    real spectra), as tests/test_pallas_lock.py makes them."""
    rng = np.random.default_rng(seed)
    phi = rng.uniform(-np.pi, np.pi, (C, K, B)).astype(np.float32)
    ph_in = rng.uniform(-np.pi, np.pi, (C, K, B)).astype(np.float32)
    mag = np.abs(np.cumsum(rng.standard_normal((C, K, B)), axis=-1)).astype(
        np.float32)
    mag[:, list(silent_rows), :] = 0.0
    return np.cos(phi), np.sin(phi), ph_in, mag


@pytest.mark.parametrize("C,K,B,silent", [
    (2, 37, 1025, ()),          # the 44.1/48 kHz bin count
    (1, 64, 257, ()),           # 8 kHz
    (2, 16, 1025, (0, 7, 15)),  # silent frames: no strict maxima
])
def test_plain_lock_matches_jax(C, K, B, silent):
    planes = _lock_planes(C, K, B, seed=K, silent_rows=silent)
    got = pv._lock_to_peaks(*(torch.from_numpy(a) for a in planes))
    jplanes = [jnp.asarray(a) for a in planes]
    for want in (lock_to_peaks_pallas(*jplanes, interpret=True),
                 jax.jit(jpv._lock_to_peaks)(*jplanes)):
        for g, w in zip(got, want):
            assert np.abs(g.numpy() - np.asarray(w)).max() <= LOCK_TOL
    if silent:
        # A silent frame's bin 0 is a "peak" (0 > the -1 edge fill) and
        # keeps its phasor.
        np.testing.assert_array_equal(got[0][:, 0, 0].numpy(), planes[0][:, 0, 0])


_STRETCH_CASES = (
    [(f"{rate}_{tempo}_{'L' if lock else 'U'}", rate, tempo, {"lock": lock})
     for rate, tempo in CASES for lock in (True, False)]
    + [(f"{rate}_{tempo}_{suffix}", rate, tempo, kwargs)
       for suffix, rate, tempo, kwargs in OPTION_CASES]
)


@pytest.mark.parametrize("key,rate,tempo,kwargs", _STRETCH_CASES,
                         ids=[c[0] for c in _STRETCH_CASES])
def test_pv_stretch_matches_jax_and_goldens(key, rate, tempo, kwargs):
    data = case_signal(rate)
    n = data.shape[1]
    out, length = pv.pv_stretch_at_rate(torch.from_numpy(data), n, tempo,
                                        rate, **kwargs)
    jstretch = jax.jit(functools.partial(jpv.pv_stretch_at_rate, tempo=tempo,
                                         rate=rate, **kwargs))
    jout, jlen = jstretch(jnp.asarray(data), jnp.int32(n))
    jout = np.asarray(jout)
    assert length == int(jlen) and out.shape == jout.shape
    assert not out[:, length:].any()
    out = out.numpy()
    assert snr_db(jout[:, :length], out[:, :length]) >= STRETCH_DB
    blobs = np.load("tests/goldens/pv.npz")
    assert length == int(blobs[f"{key}_len"])
    got = windows(out, length)
    for name in ("head", "mid", "tail"):
        assert snr_db(blobs[f"{key}_{name}"], got[name]) >= GOLDEN_DB, name


@pytest.mark.parametrize("K", [2, 5, 8, 37])
def test_overlap_add_divides_by_the_exact_coverage(K):
    """The synthesis divides rows by the K = 8 coverage's edge and
    interior rows; that equals dividing by the full [(K+3)*hop]
    denominator bitwise."""
    n_fft, hop = 512, 128
    rng = np.random.default_rng(K)
    planes = [torch.from_numpy(rng.standard_normal((2, K, n_fft // 2 + 1)).astype(
        np.float32)) for _ in range(2)]
    got = pv._pv_synth(*planes, n_fft, hop)
    w, _, _, icos, isin = pv._bases(n_fft, torch.device("cpu"))
    y = ((planes[0] @ icos + planes[1] @ isin) * w).reshape(2, K, 4, hop)
    ola = sum(torch.nn.functional.pad(y[:, :, j], (0, 0, j, 3 - j))
              for j in range(4)).reshape(2, -1)
    want = ola / torch.from_numpy(pv._ola_denominator(K, n_fft))
    assert got.shape == (2, (K + 3) * hop)
    assert torch.equal(got, want)


def test_dispatch_takes_the_plain_versions_on_the_cpu():
    re, im, n_fft, hop, dpos = _planes(44_100, 2.0)
    for lock in (True, False):
        got = pv.phase_path(re, im, dpos, hop, n_fft, lock)
        want = pv.phase_path_plain(re, im, dpos, hop, n_fft, lock)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    planes = [torch.from_numpy(a) for a in _lock_planes(1, 4, 129, seed=2)]
    assert all(torch.equal(g, w) for g, w in zip(pv.lock_phases(*planes),
                                                  pv._lock_to_peaks(*planes)))
    meta = torch.empty((1, 4, 129), device="meta")
    with pytest.raises(ProcessorRuntimeError, match="phase vocoder"):
        pv.phase_path(meta, meta, dpos[:4], hop, n_fft)
    with pytest.raises(ProcessorRuntimeError, match="phase vocoder"):
        pv.lock_phases(meta, meta, meta, meta)


def test_transient_resets_match_jax():
    rng = np.random.default_rng(6)
    mag = np.abs(rng.standard_normal((2, 40, 257))).astype(np.float32)
    mag[:, 10] *= 50.0  # an onset
    got = pv.transient_resets(torch.from_numpy(mag[:, :-1]),
                              torch.from_numpy(mag[:, 1:]))
    want = jpv.transient_resets(jnp.asarray(mag[:, :-1]), jnp.asarray(mag[:, 1:]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[:, 9].all() and got.sum() == 2
