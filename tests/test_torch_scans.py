"""The port's scan engine (nodey_tpu_torch/ops/scans.py) against the JAX
package's (nodey_tpu/ops/scans.py), on the CPU.

Each primitive (AR(1), the split re/im rotation scan, max-plus) in both
forms and under the auto rule, at a doubling length (1,000) and a blocked
length with a ragged tail (4,096 + 37): against the JAX form of the same
name called directly, and against tests/test_scans.py's float64 mirrors,
at that file's bars (> 110 dB for AR(1), > 100 dB for the rotation scan,
atol 2e-5 for max-plus). Poles: real (0.5, -0.3, 0.999), a real pole
repeated (two AR(1) scans in cascade, as a Q = 0.5 section runs), a
conjugate pole near the unit circle, and the pole of a 60 Hz Q = 10 bell.

The doubling forms run the same float32 operations in the same order as
JAX's, so they are bitwise its eager results; the blocked forms differ
from it by the GEMMs' summation order only. The host weights are the JAX
package's arrays, bitwise; the GEMMs run in full float32 (TF32 off,
"highest" asserted where they run); a prepared width copies no table
again. The time-varying-pole scan (the phaser's) against the JAX scan and
a float64 sequential recurrence, its pole products underflowing to 0.0
without a NaN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import snr_db
from nodey_tpu.ops import biquad as jbq
from nodey_tpu.ops import scans as jscans
from nodey_tpu_torch.ops import scans
from test_scans import ar1_ref, maxplus_ref, rot_ref

LENGTHS = [1_000, 4_096 + 37]
FORMS = ["doubling", "blocked", "auto"]
AR1_DB = 110.0
ROT_DB = 100.0
MAXPLUS_ATOL = 2e-5

AR1_POLES = {"real 0.5": 0.5, "real -0.3": -0.3, "real 0.999": 0.999}
ROT_POLES = {
    "conjugate r 0.9995": complex(0.9995 * np.cos(0.01),
                                  0.9995 * np.sin(0.01)),
    "60 Hz Q 10 bell": jbq.prepare(jbq.peaking(60.0, 12.0, 10.0, 48_000)).p,
}


def _noise(n, seed, channels=2):
    rng = np.random.default_rng(seed)
    return (0.5 * rng.standard_normal((channels, n))).astype(np.float32)


def _port(name, form):
    if form == "auto":
        return getattr(scans, name)
    prefix = name.split("_")[0]
    return getattr(scans, f"_{prefix}_{form}")


def _jax(name, form):
    """The JAX form under ``jax.jit`` (one compile costs less than the
    eager ops' many); its last argument, the pole or decrement, static."""
    prefix = name.split("_")[0]
    fn = getattr(jscans, name if form == "auto" else f"_{prefix}_{form}")
    return jax.jit(fn, static_argnums=2 if prefix == "rot" else 1)


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("pole", sorted(AR1_POLES))
def test_ar1_matches_jax_and_the_float64_mirror(pole, form, n):
    p = AR1_POLES[pole]
    x = _noise(n, seed=n)
    got = _port("ar1_scan", form)(torch.from_numpy(x), p).numpy()
    want = np.asarray(_jax("ar1_scan", form)(jnp.asarray(x), p))
    ref = ar1_ref(x, p).astype(np.float32)
    assert got.shape == want.shape == x.shape
    assert snr_db(ref, got) > AR1_DB
    assert snr_db(want, got) > AR1_DB


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("form", FORMS)
def test_ar1_repeated_pole_matches_jax_and_the_float64_mirror(form, n):
    """Two AR(1) scans with one pole in cascade: a real section whose poles
    coincide (the lowpass at Q = 0.5)."""
    sec = jbq.prepare(jbq.lowpass(500.0, 0.5, 48_000))
    p = float(np.float32(sec.p.real))
    x = _noise(n, seed=7)
    scan, jscan = _port("ar1_scan", form), _jax("ar1_scan", form)
    got = scan(scan(torch.from_numpy(x), p), p).numpy()
    want = np.asarray(jscan(jscan(jnp.asarray(x), p), p))
    ref = ar1_ref(ar1_ref(x, p), p).astype(np.float32)
    assert snr_db(ref, got) > AR1_DB
    assert snr_db(want, got) > AR1_DB


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("pole", sorted(ROT_POLES))
def test_rot_matches_jax_and_the_complex128_mirror(pole, form, n):
    p = ROT_POLES[pole]
    x = _noise(n, seed=3)
    g = 0.37 - 0.21j
    xr = np.float32(g.real) * x
    xi = np.float32(g.imag) * x
    mr, mi = _port("rot_scan", form)(torch.from_numpy(xr),
                                     torch.from_numpy(xi), p)
    jr, ji = _jax("rot_scan", form)(jnp.asarray(xr), jnp.asarray(xi), p)
    ref = rot_ref(xr, xi, p)
    for got, want, mirror in ((mr.numpy(), np.asarray(jr), ref.real),
                              (mi.numpy(), np.asarray(ji), ref.imag)):
        assert snr_db(mirror.astype(np.float32), got) > ROT_DB
        assert snr_db(want, got) > ROT_DB


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("c", [1e-4, 1e-2])
def test_maxplus_matches_jax_and_the_float64_mirror(c, form, n):
    rng = np.random.default_rng(7)
    # Log-domain-shaped input: mostly decaying with occasional spikes.
    a = (rng.standard_normal((2, n)) * 2.0 - 8.0).astype(np.float32)
    got = _port("maxplus_scan", form)(torch.from_numpy(a), c).numpy()
    want = np.asarray(_jax("maxplus_scan", form)(jnp.asarray(a), c))
    np.testing.assert_allclose(got, maxplus_ref(a, c), rtol=0,
                               atol=MAXPLUS_ATOL)
    # Max-plus adds no sums: the same decrements in the same order.
    np.testing.assert_array_equal(got, want)


def test_doubling_forms_are_bitwise_the_eager_jax_forms():
    """Op by op (no fusion), the doubling forms run JAX's float32
    operations in JAX's order: the results are bitwise equal. (Under
    ``jax.jit`` XLA contracts a*b + c into FMAs, hence the SNR bars above.)"""
    x = _noise(1_000, seed=11)
    p = ROT_POLES["conjugate r 0.9995"]
    np.testing.assert_array_equal(
        scans._ar1_doubling(torch.from_numpy(x), 0.999).numpy(),
        np.asarray(jscans._ar1_doubling(jnp.asarray(x), 0.999)))
    got = scans._rot_doubling(torch.from_numpy(x), torch.from_numpy(-x), p)
    want = jscans._rot_doubling(jnp.asarray(x), jnp.asarray(-x), p)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_auto_rule_equals_the_jax_package(monkeypatch):
    monkeypatch.delenv("NODEY_SCAN_FORM", raising=False)
    assert (scans._W, scans._BLOCK_THRESHOLD) == \
        (jscans._W, jscans._BLOCK_THRESHOLD)
    assert scans._NEG == jscans._NEG and scans._NEG.dtype == np.float32
    for n in (1, 100, 511, 512, 1_000, 2_047, 2_048, 4_133, 768_000):
        assert scans._form(n) == jscans._form(n), n


@pytest.mark.parametrize("pole", [0.999, -0.3, *ROT_POLES.values()])
def test_host_weights_are_the_jax_arrays(pole):
    for got, want in zip(scans.pole_powers(pole, 5_000),
                         jscans.pole_powers(pole, 5_000)):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(scans._pow_table(pole, scans._W),
                                  jscans._pow_table(pole, jscans._W))
    re, im = scans.device_powers(pole, 300, torch.device("cpu"))
    np.testing.assert_array_equal(re.numpy(), jscans.pole_powers(pole, 300)[0])
    np.testing.assert_array_equal(im.numpy(), jscans.pole_powers(pole, 300)[1])


def test_blocked_gemm_runs_in_full_float32(monkeypatch):
    """The counterpart of tests/test_scans.py::test_blocked_gemm_pins_
    highest_precision: importing the port turns TF32 off, and a scan GEMM
    refuses to run under any lower matmul precision."""
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    x = torch.zeros(2, 4_096)
    scans._ar1_blocked(x, 0.9)
    previous = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="full float32"):
            scans._ar1_blocked(x, 0.9)
        with pytest.raises(RuntimeError, match="full float32"):
            scans._rot_blocked(x, x, 0.5 + 0.5j)
    finally:
        torch.set_float32_matmul_precision(previous)
    assert torch.get_float32_matmul_precision() == "highest"


def test_a_prepared_width_copies_no_table_again():
    """``prepare`` puts every table a width reads on the device; the scans
    and a carry injection at that width then find them all in the cache."""
    device = torch.device("cpu")
    pole = complex(0.99 * np.cos(0.3), 0.99 * np.sin(0.3))
    n = 5_000
    scans.prepare(pole, n, device, powers=True)
    misses = (scans._device_powers.cache_info().misses,
              scans._device_table.cache_info().misses)
    x = torch.from_numpy(_noise(n, seed=5))
    scans.rot_scan(x, x, pole)
    scans.device_powers(pole, n, device)
    assert (scans._device_powers.cache_info().misses,
            scans._device_table.cache_info().misses) == misses


# -- tv_ar1_scan: the time-varying pole -------------------------------------------


def _tv_ref(u, p):
    """The float64 sequential recurrence y[n] = p[n] y[n-1] + u[n]."""
    y = np.zeros(u.shape)
    prev = np.zeros(u.shape[:-1])
    for j in range(u.shape[-1]):
        prev = p.astype(np.float64)[j] * prev + u.astype(np.float64)[..., j]
        y[..., j] = prev
    return y


@pytest.mark.parametrize("n", [1, 1_000, 4_097])
def test_tv_ar1_matches_jax_and_the_float64_recurrence(n):
    """tests/test_phaser.py::test_tv_ar1_scan_matches_sequential_float64 in
    the port (poles in the phaser's working range, an odd length): y
    > 110 dB against the float64 recurrence and against the JAX scan; the
    cumulative products within rtol 5e-4 where they exceed 1e-30, and
    broadcast to the drive's shape."""
    rng = np.random.default_rng(1)
    p = (0.90 + 0.099 * rng.random(n)).astype(np.float32)
    u = (0.5 * rng.standard_normal((2, n))).astype(np.float32)
    p_cum, y = scans.tv_ar1_scan(torch.from_numpy(u), torch.from_numpy(p))
    jp_cum, jy = jax.jit(jscans.tv_ar1_scan)(jnp.asarray(u), jnp.asarray(p))
    assert y.shape == p_cum.shape == u.shape == jy.shape
    yref = _tv_ref(u, p).astype(np.float32)
    assert snr_db(yref, y.numpy()) > 110.0
    assert snr_db(np.asarray(jy), y.numpy()) > 110.0
    want = np.cumprod(p.astype(np.float64))
    keep = want > 1e-30
    for row in (p_cum.numpy()[0], p_cum.numpy()[1], np.asarray(jp_cum)[0]):
        np.testing.assert_allclose(row[keep], want[keep].astype(np.float32),
                                   rtol=5e-4)


def test_tv_ar1_products_underflow_to_zero_never_nan():
    """Over a long run of poles well inside (0, 1) the cumulative product
    falls below float32's least subnormal: it reaches 0.0 and stays finite,
    and y stays bounded by the drive's scale (the JAX docstring's
    conditioning argument)."""
    rng = np.random.default_rng(2)
    n = 20_000
    p = (0.5 + 0.49 * rng.random(n)).astype(np.float32)
    u = rng.standard_normal((2, n)).astype(np.float32)
    p_cum, y = scans.tv_ar1_scan(torch.from_numpy(u), torch.from_numpy(p))
    assert torch.isfinite(p_cum).all() and torch.isfinite(y).all()
    assert float(p_cum[0, -1]) == 0.0
    assert float(y.abs().max()) < 100.0 * float(np.abs(u).max())
    assert snr_db(_tv_ref(u, p).astype(np.float32), y.numpy()) > 110.0
