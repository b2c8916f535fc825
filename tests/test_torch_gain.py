"""The port's gain is bitwise equal to the JAX package's (flt, s16, s32),
with samples at the clamp edges and volumes across [0, 10]."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nodey_tpu.core.stream import Stream as JStream
from nodey_tpu.ops import gain as jgain
from nodey_tpu_torch.core.stream import Stream
from nodey_tpu_torch.ops import gain as tgain

VOLUMES = [0.0, 0.37, 1.0, 1.5, 3.3, 7.25, 10.0]


def _samples(fmt: str) -> np.ndarray:
    rng = np.random.default_rng(7)
    if fmt == "s16":
        ints = rng.integers(-32768, 32768, size=(2, 2000))
        ints[:, :6] = [[-32768, 32767, 0, 1, -1, 16384]] * 2
        return (ints / 32768.0).astype(np.float32)
    if fmt == "s32":
        ints = rng.integers(-(2**31), 2**31, size=(2, 2000), dtype=np.int64)
        ints[:, :4] = [[-(2**31), 2**31 - 1, 0, -1]] * 2
        return (ints.astype(np.float64) / 2147483648.0).astype(np.float32)
    x = rng.uniform(-1.5, 1.5, size=(2, 2000)).astype(np.float32)
    x[:, :4] = [[-1.0, 1.0, 0.0, 3.4e38]] * 2
    return x


@pytest.mark.parametrize("volume", VOLUMES)
@pytest.mark.parametrize("fmt", ["flt", "s16", "s32"])
def test_gain_bitwise_equal_to_jax(fmt, volume):
    x = _samples(fmt)
    want = np.asarray(jgain.apply_gain(
        JStream(data=jnp.asarray(x), length=x.shape[1], rate=44_100,
                channels=2, fmt=fmt),
        volume,
    ).data)
    got = tgain.apply_gain(
        Stream(data=torch.from_numpy(x), length=x.shape[1], rate=44_100,
               channels=2, fmt=fmt),
        volume,
    ).data
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_gain_random_volumes_bitwise():
    rng = np.random.default_rng(11)
    x = _samples("s16")
    for volume in rng.uniform(0.0, 10.0, size=8):
        want = jgain.apply_gain_reference(x, float(volume), "s16")
        got = tgain.gain_array(torch.from_numpy(x), float(volume), "s16")
        np.testing.assert_array_equal(got.numpy(), want)
