"""The port's tensor-parallel reverb convolution (nodey_tpu_torch/parallel/
tp.py) against the JAX package's, on the CPU.

The port's mesh is CPU devices passed explicitly (``["cpu"] * 8``): one
process loops over the tp shards. The decomposition adds no approximation,
but the per-shard GEMMs have other shapes than the unsharded ones and a
BLAS may associate a dot product otherwise at another shape, so the bar is
the JAX package's (tests/test_tp.py), >= 130 dB and max-abs <= 1e-6 of the
peak against the unsharded convolution, at tp 2, 4 and 8:

- against the port's unsharded ``partitioned_conv``, the relation the JAX
  test holds within its package;
- against the JAX package's unsharded ``partitioned_conv``: max-abs <= 1e-6
  of the peak, and an SNR no more than 0.5 dB below the two packages'
  unsharded convolutions' own agreement. That agreement is 122.8 dB on
  this input (the two BLAS libraries' float32 sums; each is ~125 dB from
  the float64 convolution), so 130 dB against the JAX conv cannot hold for
  any port; the test asserts the floor is >= 120 dB and that sharding
  adds nothing measurable to it.

A tp that does not divide F refuses. ``reverb_tp`` meets the JAX reverb
node's math (``ops.reverb.reverb_stream``) at >= 130 dB and 1e-6 of the
peak, at the length n + L - 1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import snr_db
from nodey_tpu.core.stream import Stream as JStream
from nodey_tpu.ops import reverb as jrv
from nodey_tpu.parallel import tp as jtp
from nodey_tpu_torch.ops import reverb as rv
from nodey_tpu_torch.parallel import tp
from nodey_tpu_torch.parallel.mesh import make_mesh
from test_torch_effects import one_torch_thread  # noqa: F401 (autouse)

RATE = 48_000
SNR_DB = 130.0
PEAK_REL = 1e-6
FLOOR_DB = 120.0         # the two packages' unsharded convs, at the least
FLOOR_SLACK_DB = 0.5     # what sharding may cost below that floor


def _mesh(n):
    return make_mesh({"tp": n}, ["cpu"] * n)


def test_partitioned_conv_tp_meets_the_unsharded_jax_conv():
    rng = np.random.default_rng(0)
    x = (0.3 * rng.standard_normal((2, RATE))).astype(np.float32)
    hr, hi, ln = jrv.ir_partitions(RATE, 2, 0.3, 5.0, 0.4)
    out_len = x.shape[1] + ln - 1
    jax_ref = np.asarray(jrv.partitioned_conv(jnp.asarray(x), hr, hi,
                                              out_len)).astype(np.float64)
    ref = rv.partitioned_conv(torch.from_numpy(x), torch.from_numpy(hr),
                              torch.from_numpy(hi), out_len
                              ).numpy().astype(np.float64)
    floor = snr_db(jax_ref, ref)
    assert floor >= FLOOR_DB, floor
    for n in (2, 4, 8):
        for mine, theirs in zip(tp._tp_mats(n), jtp._tp_mats(n)):
            assert mine.dtype == theirs.dtype and np.array_equal(mine, theirs)
        got = tp.partitioned_conv_tp(torch.from_numpy(x), hr, hi, out_len,
                                     _mesh(n))
        assert got.shape == (2, out_len)
        got = got.numpy().astype(np.float64)
        assert snr_db(ref, got) >= SNR_DB, n
        assert np.abs(ref - got).max() <= PEAK_REL * np.abs(ref).max(), n
        assert snr_db(jax_ref, got) >= floor - FLOOR_SLACK_DB, n
        assert np.abs(jax_ref - got).max() \
            <= PEAK_REL * np.abs(jax_ref).max(), n

    x1 = (0.1 * rng.standard_normal((1, RATE))).astype(np.float32)
    hr1, hi1, ln1 = jrv.ir_partitions(RATE, 1, 0.3, 5.0, 0.4)
    with pytest.raises(ValueError, match="must divide"):
        tp.partitioned_conv_tp(torch.from_numpy(x1), hr1, hi1,
                               x1.shape[1] + ln1 - 1, _mesh(3))


def test_reverb_tp_matches_the_jax_node_math():
    rng = np.random.default_rng(1)
    n = RATE // 2
    x = (0.3 * rng.standard_normal((2, n))).astype(np.float32)
    decay_s, pre_ms, damping, wet, dry = 0.25, 4.0, 0.3, 0.35, 0.8
    ref = jrv.reverb_stream(
        JStream(data=jnp.asarray(x), length=jnp.int32(n), rate=RATE,
                channels=2, fmt="flt", t0_us=0.0),
        decay_s, pre_ms, damping, wet, dry)
    ref_len = int(ref.length)
    want = np.asarray(ref.data)[:, :ref_len].astype(np.float64)
    got, got_len = tp.reverb_tp(torch.from_numpy(x), RATE, decay_s, pre_ms,
                                damping, wet, dry, _mesh(4))
    assert got_len == ref_len
    got = got[:, :ref_len].numpy().astype(np.float64)
    assert snr_db(want, got) >= SNR_DB
    assert np.abs(want - got).max() <= PEAK_REL * np.abs(want).max()
