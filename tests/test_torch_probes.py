"""The step probes' plain versions, the measurement functions of
``nodey_tpu_torch.tools.probes`` with a fake timer, and ``resample_data``
as the counterpart of the JAX package's ``resample_data_pallas``, on the
CPU.

The probes' plain outputs are what the TPU probes store (bench.py's and
tools/ab_wsola_fps.py's kernels): x + 1 per step, or a window's first 128
columns. ``resample_data`` must match ``resample_data_pallas`` (interpret
mode) at tests/test_pallas.py's cases within 1e-6, that file's bar: both
sum the same bank in float32, in another order.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nodey_tpu.ops import pallas_wsola
from nodey_tpu.ops import stretch as jstretch
from nodey_tpu.ops.pallas_resample import resample_data_pallas
from nodey_tpu_torch.ops import cuda_probes, stretch
from nodey_tpu_torch.ops import resample as tr
from nodey_tpu_torch.tools import probes


def test_bare_probe_plain_stores_x_plus_one():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 128)).astype(np.float32))
    per_step = cuda_probes.step_probe_bare(x, 5, per_step=True)
    assert per_step.shape == (5, 8, 128)
    assert all(torch.equal(per_step[k], x + 1) for k in range(5))
    assert torch.equal(cuda_probes.step_probe_bare(x, 5, per_step=False), x + 1)
    with pytest.raises(ValueError, match="float32"):
        cuda_probes.step_probe_bare(x[:4], 5)


@pytest.mark.parametrize("K", [1, 3, 600])
def test_dma_probe_plain_stores_each_windows_head(K):
    x = np.random.default_rng(K).standard_normal((2, 40_000)).astype(
        np.float32)
    span = probes.span_dma()
    limit = ((x.shape[1] - span) // 128) * 128
    assert cuda_probes.dma_limit(x.shape[1], span) == limit
    starts = [(k * 128) % limit for k in range(K)]   # wraps at K = 600
    ring = cuda_probes.step_probe_dma(torch.from_numpy(x), K, span, ring=True)
    want = np.stack([x[:, s : s + 128] + np.float32(1) for s in starts])
    np.testing.assert_array_equal(ring.numpy(), want)
    pair = cuda_probes.step_probe_dma(torch.from_numpy(x), K, span, ring=False)
    last = starts[-1]
    np.testing.assert_array_equal(pair.numpy(), x[:, last : last + 128])
    with pytest.raises(ValueError, match="window"):
        cuda_probes.step_probe_dma(torch.from_numpy(x[:, :span + 64]), K, span)
    with pytest.raises(ValueError, match="CUDA card"):
        cuda_probes.step_probe_dma(torch.empty((2, 40_000), device="meta"),
                                   K, span)


def test_span_dma_is_the_tpu_chain_window():
    for rate in (48_000, 44_100, 8_000):
        _seq, seek, overlap = jstretch._params(rate)
        assert stretch._params(rate) == jstretch._params(rate)
        span_pad = pallas_wsola._geometry(seek, overlap)[3]
        assert probes.span_dma(rate) == span_pad + 128
    assert probes.span_dma() == 1280


def test_step_overhead_is_the_k_slope():
    """With a timer that reads the probe's step count off its output, the
    slope is the timer's per-step term: the launch's term cancels."""
    calls = []

    def fake_timer(fn, iters):
        out = fn()
        calls.append((out.shape, iters))
        per_step = 2e-7 if out.shape[1:] == (8, 128) else 9e-7
        return 3e-5 + out.shape[0] * per_step

    bare, dma = probes.wsola_step_overhead(4, device="cpu", timer=fake_timer)
    assert bare == pytest.approx(2e-7) and dma == pytest.approx(9e-7)
    assert calls == [((2048, 8, 128), 4), ((4096, 8, 128), 4),
                     ((2048, 2, 128), 4), ((4096, 2, 128), 4)]
    # A slope below the floor (a faster long run) reads as bench.py's 1e-9.
    assert probes.k_slope(lambda K: 1.0 - K * 1e-6) == 1e-9


def test_resample_ab_times_in_turns_and_compares():
    seen = []

    def fake_timer(fn, iters):
        seen.append(tuple(fn().shape))
        return 0.002 * len(seen)

    ab = probes.resample_ab(44_100, 48_000, 0.1, iters=3, device="cpu",
                            timer=fake_timer)
    # plain, conv1d, kernel, kernel, conv1d, plain: the mean of each pair.
    assert ab["plain_ms"] == pytest.approx((2 + 12) / 2)
    assert ab["conv1d_ms"] == pytest.approx((4 + 10) / 2)
    assert ab["kernel_ms"] == pytest.approx((6 + 8) / 2)
    assert ab["max_diff"] == 0.0          # on the CPU both are the plain path
    n_out = -(-4410 * 160 // 147)
    assert seen[0] == seen[2] == (2, n_out)
    assert seen[1][:2] == (2, 160)        # conv1d: [C, L, groups]


@functools.lru_cache(maxsize=None)
def _pallas_stereo(in_rate, out_rate):
    """tests/test_pallas.py's stereo input and resample_data_pallas's output
    on it. Its mono input is the first row of the stereo one (the same
    seeded draws), and the kernel treats channels alike, so the stereo run's
    first row is the reference of the mono case too (one interpret run of
    ~5 s per rate pair instead of two)."""
    x = (0.3 * np.random.default_rng(0).standard_normal(
        (2, in_rate // 2))).astype(np.float32)
    return x, np.asarray(resample_data_pallas(jnp.asarray(x), in_rate,
                                              out_rate, interpret=True))


@pytest.mark.parametrize("in_rate,out_rate",
                         [(44_100, 48_000), (48_000, 44_100)])
@pytest.mark.parametrize("channels", [1, 2])
def test_resample_data_matches_resample_data_pallas(in_rate, out_rate,
                                                    channels):
    x = (0.3 * np.random.default_rng(0).standard_normal(
        (channels, in_rate // 2))).astype(np.float32)
    stereo, pallas = _pallas_stereo(in_rate, out_rate)
    np.testing.assert_array_equal(x, stereo[:channels])
    want = pallas[:channels]
    got = tr.resample_data(torch.from_numpy(x), in_rate, out_rate).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
