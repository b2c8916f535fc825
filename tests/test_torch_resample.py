"""The port's resampler against the JAX package's.

* bank design, group factor and output length: bitwise, over rate pairs;
* the plain grouped form against JAX ``apply_filter_bank`` (patches) and
  the Pallas kernel in interpret mode, at one grid step: max|diff| <= 2e-6
  (float32 sums taken in another order; the bank sums to 1 per phase and
  the input is within +/-1.5, so 2e-6 is ~30 ulps at the output's scale);
* SNR >= 120 dB against the float64 per-output reference;
* the -3 dB mono upmix and the zeroed tail;
* the bank's tap support (what the CUDA kernel reads): re-embedding the
  compact bank at its offsets gives the dense bank back bitwise;
* ``NODEY_RESAMPLE_COMPAT`` (measured swr banks, not ported) raises.
The CUDA kernel itself runs only on the card: test_torch_cuda_kernels.py.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nodey_tpu.core.stream import Stream as JStream
from nodey_tpu.ops import pallas_resample
from nodey_tpu.ops import resample as jr
from nodey_tpu_torch.core.errors import ProcessorRuntimeError
from nodey_tpu_torch.core.stream import Stream
from nodey_tpu_torch.ops import chunkops, cuda_resample
from nodey_tpu_torch.ops import resample as tr

from conftest import snr_db

RATES = [8000, 16000, 22050, 32000, 44100, 48000, 96000]
PAIRS = [(a, b) for a, b in itertools.permutations(RATES, 2)]
# The three rate pairs chip_smoke.py checks: R = 4, 2, 2 (the last one
# downsamples with stretched taps).
KERNEL_PAIRS = [(44_100, 48_000), (22_050, 48_000), (44_100, 32_000)]


@pytest.mark.parametrize("in_rate,out_rate", PAIRS)
def test_bank_and_shapes_bitwise(in_rate, out_rate):
    L, M = tr._rational(in_rate, out_rate)
    assert (L, M) == jr._rational(in_rate, out_rate)
    assert tr.group_factor(L, M) == jr.group_factor(L, M)
    assert tr._effective_taps(L, M, 32) == jr._effective_taps(L, M, 32)
    for n in (0, 1, M - 1, M, 12_345, 13_230_000):
        assert tr._out_length(n, L, M) == int(jr._out_length(n, L, M))
        assert tr.out_capacity(n, in_rate, out_rate) == jr.out_capacity(
            n, in_rate, out_rate
        )
    bank, left, W = tr.bank_spec(in_rate, out_rate)
    jbank, jleft, jW = jr.bank_spec(in_rate, out_rate)
    assert (left, W) == (jleft, jW)
    assert bank.dtype == np.float32
    np.testing.assert_array_equal(bank, jbank)


def _padded_input(in_rate, out_rate, n, channels=2, seed=0):
    """The padded [C, N] operand, group count and window resample_data
    builds (ops/resample.py:196-209 of the JAX package)."""
    rng = np.random.default_rng(seed)
    data = (0.5 * rng.standard_normal((channels, n))).clip(-1.5, 1.5)
    data = data.astype(np.float32)
    L, M = jr._rational(in_rate, out_rate)
    bank, left, W = jr.bank_spec(in_rate, out_rate)
    G = -(-(-(-n * L // M)) // L)
    right = max(0, (G + -(-W // M)) * M - left - n)
    x = np.pad(data, ((0, 0), (left, right)))
    return data, x, G, M, W, bank


@pytest.mark.parametrize("in_rate,out_rate", KERNEL_PAIRS)
def test_plain_grouped_matches_jax_and_pallas_interpret(in_rate, out_rate):
    # 9000 input samples is one grid step of the Pallas kernel at these
    # rates (at most 128 group rows), with a ragged last group.
    _, x, G, M, W, bank = _padded_input(in_rate, out_rate, 9000)
    L = bank.shape[0]
    assert tr.group_factor(L, M) > 1
    got = tr.apply_filter_bank_plain(
        torch.from_numpy(x), G, M, W, torch.from_numpy(bank)
    ).numpy()
    patches = np.asarray(
        jr.apply_filter_bank(jnp.asarray(x), G, M, W, jnp.asarray(bank))
    )
    kernel = np.asarray(pallas_resample.apply_filter_bank_grouped_pallas(
        jnp.asarray(x), G, M, W, jnp.asarray(bank), interpret=True
    ))
    assert got.shape == patches.shape == kernel.shape == (2, G * L)
    assert np.abs(got - patches).max() <= 2e-6
    assert np.abs(got - kernel).max() <= 2e-6


@pytest.mark.parametrize(
    "in_rate,out_rate", KERNEL_PAIRS + [(44_100, 22_050), (8_000, 48_000),
                                        (48_000, 44_100)]
)
def test_resample_data_snr_vs_float64_reference(in_rate, out_rate):
    data, *_ = _padded_input(in_rate, out_rate, 7001, seed=3)
    want = jr.resample_data_reference(data.astype(np.float64), in_rate,
                                      out_rate)
    got = tr.resample_data(torch.from_numpy(data), in_rate, out_rate).numpy()
    assert got.shape == want.shape
    assert snr_db(want, got) >= 120.0


@pytest.mark.parametrize("in_rate,out_rate", [(44_100, 22_050),
                                              (8_000, 48_000)])
def test_plain_r1_branches_match_jax(in_rate, out_rate):
    # 44.1 -> 22.05 kHz takes the per-shift GEMM, 8 -> 48 kHz the patch
    # GEMM (M = 1 here, so more than 4 shifts).
    _, x, G, M, W, bank = _padded_input(in_rate, out_rate, 5000)
    assert tr.group_factor(bank.shape[0], M) == 1
    got = tr.apply_filter_bank_plain(
        torch.from_numpy(x), G, M, W, torch.from_numpy(bank)
    ).numpy()
    want = np.asarray(
        jr.apply_filter_bank(jnp.asarray(x), G, M, W, jnp.asarray(bank))
    )
    assert np.abs(got - want).max() <= 2e-6


def test_mono_upmix_and_tail_zeroing_match_jax():
    rng = np.random.default_rng(5)
    n, capacity = 6000, 8192
    data = np.zeros((1, capacity), np.float32)
    data[:, :n] = 0.4 * rng.standard_normal((1, n))
    jout = jr.to_rate_and_stereo(
        JStream(data=jnp.asarray(data), length=n, rate=44_100, channels=1,
                fmt="s16"),
        48_000,
    )
    tout = tr.to_rate_and_stereo(
        Stream(data=torch.from_numpy(data), length=n, rate=44_100,
               channels=1, fmt="s16"),
        48_000,
    )
    assert (tout.rate, tout.channels, tout.fmt) == (48_000, 2, "flt")
    assert tout.length == int(jout.length)
    got, want = tout.data.numpy(), np.asarray(jout.data)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 2e-6
    assert (got[:, tout.length:] == 0.0).all()
    assert got[:, tout.length - 1].any()

    jst = jr.to_stereo(JStream(data=jnp.asarray(data), length=n, rate=44_100,
                               channels=1))
    tst = tr.to_stereo(Stream(data=torch.from_numpy(data), length=n,
                              rate=44_100, channels=1))
    np.testing.assert_array_equal(tst.data.numpy(), np.asarray(jst.data))


def test_cpu_tensor_takes_plain_and_kernel_wrapper_refuses_it():
    _, x, G, M, W, bank = _padded_input(44_100, 48_000, 3000)
    xt, bt = torch.from_numpy(x), torch.from_numpy(bank)
    support = tr.support_on(bank, "cpu")
    before = cuda_resample.launches
    np.testing.assert_array_equal(
        tr.apply_filter_bank(xt, G, M, W, bt, support).numpy(),
        tr.apply_filter_bank_plain(xt, G, M, W, bt).numpy(),
    )
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_resample.apply_filter_bank_cuda(xt, G, M, W, support)
    assert cuda_resample.launches == before


def _re_embed(compact, offsets, L, W):
    """The dense [L, W] bank that a support [nb, T, block] describes."""
    nb, T, block = compact.shape
    dense = np.zeros((nb * block, W), dtype=compact.dtype)
    for b in range(nb):
        dense[b * block : (b + 1) * block, offsets[b] : offsets[b] + T] = \
            compact[b].T
    assert not dense[L:].any()   # phases past L are zero padding
    return dense[:L]


@pytest.mark.parametrize("in_rate,out_rate", PAIRS)
def test_bank_support_re_embeds_the_bank_bitwise(in_rate, out_rate):
    bank, _, W = tr.bank_spec(in_rate, out_rate)
    L, M = tr._rational(in_rate, out_rate)
    taps = tr._effective_taps(L, M, tr.DEFAULT_TAPS)
    block = tr.SUPPORT_BLOCK
    compact, offsets, T = tr.bank_support(bank)
    assert compact.dtype == np.float32 and offsets.dtype == np.int32
    assert compact.shape == (-(-L // block), T, block)
    np.testing.assert_array_equal(_re_embed(compact, offsets, L, W), bank)
    assert (offsets >= 0).all() and (offsets + T <= W).all()
    # The analytic design: phase p's taps start at floor(p*M/L), so a
    # block's start at that of its first phase (unless the block is pushed
    # left by the right edge), and its window, its phases' union, is a few
    # columns wider than one phase's.
    np.testing.assert_array_equal(
        offsets, np.minimum(np.arange(len(offsets)) * block * M // L, W - T))
    assert taps <= T <= taps + -(-(block - 1) * M // L)


def test_bank_support_of_an_irregular_bank():
    """Supports read from the zeros, not from the analytic formula: a row of
    zeros, a zero inside a support, a support at the right edge (offset W -
    T, left of its first non-zero column), one isolated tap."""
    W = 23
    bank = np.zeros((7, W), dtype=np.float32)
    bank[0, 2:7] = [0.5, -0.25, 0.0, 1.5, 2.0]
    bank[2, 9:11] = 3.0
    bank[3, 19:23] = [1.0, 0.0, 0.0, -1.0]
    bank[4, 22] = 7.0
    bank[5, 0] = -2.0
    bank[6, 5:12] = np.arange(1, 8)
    compact, offsets, T = tr.bank_support(bank)
    assert compact.shape == (2, 23, 4) and T == 23   # blocks [2, 22], [0, 22]
    np.testing.assert_array_equal(offsets, [0, 0])
    np.testing.assert_array_equal(_re_embed(compact, offsets, 7, W), bank)
    support = tr.support_on(bank, "cpu")
    assert (support.taps, support.phases, support.width) == (23, 7, W)
    assert support.row_used == 23
    np.testing.assert_array_equal(support.compact.numpy(), compact)
    # Blocks at several offsets, over two 32-phase tiles of the kernel.
    wide = np.zeros((64, W), dtype=np.float32)
    wide[:4, 2:7] = 1.0      # block 0: [2, 6]
    wide[4:8, 10:13] = 1.0   # block 1: [10, 12]
    wide[32:36, 20] = 1.0    # block 8, the second tile: [20, 20]
    compact, offsets, T = tr.bank_support(wide)
    assert T == 5
    np.testing.assert_array_equal(offsets[[0, 1, 8]], [2, 10, 18])
    np.testing.assert_array_equal(_re_embed(compact, offsets, 64, W), wide)
    # Tile 0 spans offsets 0..10 (empty blocks sit at 0), tile 1 0..18.
    assert tr.support_on(wide, "cpu").row_used == 18 + 5


def test_resample_compat_variable_raises_instead_of_rendering(monkeypatch):
    data = torch.zeros((2, 4_000))
    monkeypatch.setenv("NODEY_RESAMPLE_COMPAT", "")
    assert tr.resample_data(data, 44_100, 48_000).shape == (2, 4_354)
    for value, what in (("swr", "not ported"),
                        ("bogus", "Unknown resampler compatibility mode")):
        monkeypatch.setenv("NODEY_RESAMPLE_COMPAT", value)
        with pytest.raises(ProcessorRuntimeError, match=what) as err:
            tr.resample_data(data, 44_100, 48_000)
        assert err.value.detail and err.value.explanation
        with pytest.raises(ProcessorRuntimeError, match=what):
            chunkops.resample_plan(44_100, 48_000, 4_410, "cpu")
