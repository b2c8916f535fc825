"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one: a CUDA kernel
has no CPU mode. The file imports neither jax nor the test conftest, so
on the card's machine it runs alone:

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -q

Tolerance 2e-6 for the resampler: the kernel sums each window in tap
order with FFMA, the plain version through a GEMM in another order; the
bank sums to 1 per phase and the inputs are within +/-1.5 (~30 float32
ulps at that scale). The WSOLA kernel must choose the plain version's
splice offsets exactly on these tone-plus-noise signals (no near ties),
and its audio, blended with the same roundings, within the same 2e-6.
"""

import numpy as np
import pytest
import torch

import nodey_tpu_torch  # noqa: F401  (sets the TF32 flags)
from nodey_tpu_torch.ops import cuda_resample, cuda_wsola, stretch, wsola
from nodey_tpu_torch.ops import resample as tr
from nodey_tpu_torch.ops.wsola import frame_pos

TOL = 2e-6

# (in_rate, out_rate, samples): the grouped (R > 1) pairs chip_smoke.py
# checks, R == 1 pairs (up, down, many phases), a window wide enough to
# shrink the CTA's group tile, a lone group, and a mono clip.
CASES = [
    (44_100, 48_000, 100_003),
    (22_050, 48_000, 50_021),
    (44_100, 32_000, 77_777),
    (44_100, 22_050, 30_001),
    (8_000, 48_000, 9_999),
    (48_000, 44_100, 40_000),
    (192_000, 44_100, 60_013),
    (44_100, 48_000, 1),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _data(device, n, channels=2, seed=0):
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((channels, n))).clip(-1.5, 1.5)
    return torch.from_numpy(x.astype(np.float32)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("in_rate,out_rate,n", CASES)
def test_kernel_matches_plain(cuda_device, in_rate, out_rate, n):
    x, G, M, W, bank = tr.bank_operands(_data(cuda_device, n), in_rate,
                                        out_rate)
    before = cuda_resample.launches
    got = cuda_resample.apply_filter_bank_cuda(x, G, M, W, bank)
    torch.cuda.synchronize()
    assert cuda_resample.launches == before + 1
    want = tr.apply_filter_bank_plain(x, G, M, W, bank)
    assert got.shape == want.shape == (2, G * bank.shape[0])
    assert (got - want).abs().max().item() <= TOL


@pytest.mark.cuda
def test_resample_data_on_card_matches_cpu(cuda_device):
    data = _data(cuda_device, 12_345, channels=1, seed=4)
    before = cuda_resample.launches
    got = tr.resample_data(data, 44_100, 48_000)
    assert cuda_resample.launches == before + 1
    want = tr.resample_data(data.cpu(), 44_100, 48_000)
    assert got.is_cuda and got.shape == want.shape
    assert (got.cpu() - want).abs().max().item() <= TOL


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    x, G, M, W, bank = tr.bank_operands(_data(cuda_device, 5_000), 44_100,
                                        48_000)
    before = cuda_resample.launches
    with pytest.raises(ValueError, match="float32"):
        cuda_resample.apply_filter_bank_cuda(x.double(), G, M, W, bank)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_resample.apply_filter_bank_cuda(x[:, ::2], G // 2, M, W, bank)
    with pytest.raises(ValueError, match="samples"):
        cuda_resample.apply_filter_bank_cuda(x[:, :100].contiguous(), G, M,
                                             W, bank)
    with pytest.raises(ValueError, match="one CUDA device"):
        cuda_resample.apply_filter_bank_cuda(x, G, M, W, bank.cpu())
    assert cuda_resample.launches == before


# -- the WSOLA splice-chain kernel --------------------------------------------

# (rate, tempo, frames, channels): ragged frame counts, a lone frame, mono,
# and the 44.1 kHz geometry (stride 1412, overlap 352).
WSOLA_CASES = [
    (48_000, 0.7937005259840998, 37, 2),
    (48_000, 1.25, 1, 2),
    (48_000, 1.25, 29, 1),
    (44_100, 0.8, 23, 2),
    (8_000, 2.0, 61, 2),
]


def _wsola_operands(device, rate, tempo, K, channels, seed=0):
    seq, seek, overlap = stretch._params(rate)
    num = int(round((seq - overlap) * tempo * 65536))
    n = frame_pos(K - 1, num) + seek + seq + 2
    rng = np.random.default_rng(seed)
    t = np.arange(n) / rate
    x = np.stack([0.4 * np.sin(2 * np.pi * (220.0 + 110 * c) * t)
                  + 0.1 * rng.standard_normal(n) for c in range(channels)])
    x = torch.from_numpy(x.astype(np.float32)).to(device)
    return x, x[:, :overlap], (K, num, 65536, seq, seek, overlap)


@pytest.mark.cuda
@pytest.mark.parametrize("rate,tempo,K,channels", WSOLA_CASES)
def test_wsola_kernel_matches_plain(cuda_device, rate, tempo, K, channels):
    x, head, args = _wsola_operands(cuda_device, rate, tempo, K, channels)
    before = cuda_wsola.launches
    bs, body = cuda_wsola.wsola_chain_cuda(x, head, *args)
    torch.cuda.synchronize()
    assert cuda_wsola.launches == before + 1
    pbs, pbody = wsola.wsola_chain_plain(x, head, *args)
    assert bs.dtype == torch.int32 and bs.shape == (K,)
    assert body.shape == pbody.shape == (channels, K * (args[3] - args[5]))
    assert torch.equal(bs, pbs)
    assert (body - pbody).abs().max().item() <= TOL


@pytest.mark.cuda
def test_wsola_stretch_on_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(8)
    data = (0.3 * rng.standard_normal((2, 30_000))).astype(np.float32)
    before = cuda_wsola.launches
    out, n = stretch.wsola_stretch_at_rate(
        torch.from_numpy(data).to(cuda_device), 29_000, 1.25, 48_000)
    assert cuda_wsola.launches == before + 1
    want, want_n = stretch.wsola_stretch_at_rate(torch.from_numpy(data),
                                                 29_000, 1.25, 48_000)
    assert out.is_cuda and n == want_n and out.shape == want.shape
    assert (out.cpu() - want).abs().max().item() <= TOL


@pytest.mark.cuda
def test_wsola_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    x, head, args = _wsola_operands(cuda_device, 8_000, 1.25, 5, 2)
    before = cuda_wsola.launches
    with pytest.raises(ValueError, match="float32"):
        cuda_wsola.wsola_chain_cuda(x.double(), head.double(), *args)
    with pytest.raises(ValueError, match="window reads"):
        cuda_wsola.wsola_chain_cuda(x[:, :-3].contiguous(), head, *args)
    with pytest.raises(ValueError, match="one CUDA device"):
        cuda_wsola.wsola_chain_cuda(x, head.cpu(), *args)
    with pytest.raises(ValueError, match="head"):
        cuda_wsola.wsola_chain_cuda(x, head[:1], *args)
    assert cuda_wsola.launches == before
