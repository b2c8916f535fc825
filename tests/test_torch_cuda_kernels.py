"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one: a CUDA kernel
has no CPU mode. The file imports neither jax nor the test conftest, so
on the card's machine it runs alone:

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -q

Tolerance 2e-6 for the resampler: the kernel sums each window in tap
order with FFMA, the plain version through a GEMM in another order; the
bank sums to 1 per phase and the inputs are within +/-1.5 (~30 float32
ulps at that scale). The kernel's two register tiles (4-phase blocks, the
main path's, and single phases) sum the same non-zero taps in the same
order, so their outputs are bitwise equal. The WSOLA kernel must choose
the plain version's splice offsets exactly on these tone-plus-noise
signals (no near ties), and its audio, blended with the same roundings,
within the same 2e-6; through its chunk entry too, whose returned tail is
a copy of samples (bitwise), and across its walk's frame blocks. Its
energy prologue within rtol 1e-5 of the plain conv1d energies, rsqrt-ed:
two float32 sums of C*overlap squares in different orders.

The phase-vocoder kernels: the phase path's synthesis planes >= 100 dB
against the plain version fed the same re and im, and every bin with
mag > 0 within a phasor error |kernel - plain| / mag <= 1e-3 (its prefix
is associated otherwise; a different peak choice would show as O(1)); the
lock kernel bitwise the plain lock on finite inputs (the same decisions,
the same roundings, the IEEE sine and cosine), and within 2e-6 of it, NaN
where it is NaN, on inputs that are not finite.

The WSOLA score-table kernel sums each score in another order than the
plain version's bmm, so an entry may differ only where two candidates'
float64 scores lie within 1e-5 of the row's largest |score|; it sums in the
chain kernel's order, so it must agree with the chain kernel exactly. The
walk and the step probes copy or index values: bitwise. The dma probe's
TMA bulk copies take x only on 16-byte boundaries; anything else raises.
"""

import math

import numpy as np
import pytest
import torch

import nodey_tpu_torch  # noqa: F401  (sets the TF32 flags)
from nodey_tpu_torch.ops import cuda_probes, cuda_pv, cuda_resample, cuda_wsola
from nodey_tpu_torch.ops import cuda_wsola_table, pv, stretch, wsola
from nodey_tpu_torch.ops import resample as tr
from nodey_tpu_torch.ops.wsola import frame_pos

TOL = 2e-6

# (in_rate, out_rate, samples, channels): the main paths' pairs (44.1 -> 48
# kHz, the 635/504 pitch transposition, 48 -> 44.1 kHz, M = 160), the
# grouped (R > 1) pairs chip_smoke.py checks, R == 1 pairs (up, down, many
# phases), strong downsampling (a 154-tap block window: wide staged rows;
# L = 1 with 384 taps: 32 groups per CTA), a lone group; mono and stereo,
# ragged last group and phase tiles.
CASES = [
    (44_100, 48_000, 100_003, 2),
    (44_100, 48_000, 77_001, 1),
    (635, 504, 90_017, 2),
    (635, 504, 50_003, 1),
    (48_000, 44_100, 40_000, 2),
    (48_000, 44_100, 33_333, 1),
    (22_050, 48_000, 50_021, 2),
    (22_050, 48_000, 20_011, 1),
    (44_100, 32_000, 77_777, 2),
    (44_100, 32_000, 40_009, 1),
    (44_100, 22_050, 30_001, 2),
    (8_000, 48_000, 9_999, 2),
    (192_000, 44_100, 60_013, 2),
    (96_000, 8_000, 50_000, 1),
    (44_100, 48_000, 1, 2),
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
@pytest.mark.parametrize("in_rate,out_rate,n,channels", CASES)
def test_kernel_matches_plain(cuda_device, in_rate, out_rate, n, channels):
    x, G, M, W, bank, support = tr.bank_operands(
        _data(cuda_device, n, channels), in_rate, out_rate)
    before = cuda_resample.launches
    got = cuda_resample.apply_filter_bank_cuda(x, G, M, W, support)
    torch.cuda.synchronize()
    assert cuda_resample.launches == before + 1
    want = tr.apply_filter_bank_plain(x, G, M, W, bank)
    assert got.shape == want.shape == (channels, G * bank.shape[0])
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
    x, G, M, W, _, sup = tr.bank_operands(_data(cuda_device, 5_000),
                                          44_100, 48_000)
    before = cuda_resample.launches
    with pytest.raises(ValueError, match="float32"):
        cuda_resample.apply_filter_bank_cuda(x.double(), G, M, W, sup)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_resample.apply_filter_bank_cuda(x[:, ::2], G // 2, M, W, sup)
    with pytest.raises(ValueError, match="samples"):
        cuda_resample.apply_filter_bank_cuda(x[:, :100].contiguous(), G, M,
                                             W, sup)
    with pytest.raises(ValueError, match="one CUDA device"):
        cuda_resample.apply_filter_bank_cuda(
            x, G, M, W, sup._replace(compact=sup.compact.cpu()))
    with pytest.raises(ValueError, match="support"):
        cuda_resample.apply_filter_bank_cuda(
            x, G, M, W, sup._replace(compact=sup.compact[:-1]))
    with pytest.raises(ValueError, match="support"):
        cuda_resample.apply_filter_bank_cuda(x, G, M, W + 1, sup)
    with pytest.raises(ValueError, match="float32"):
        cuda_resample.apply_filter_bank_cuda(
            x, G, M, W, sup._replace(offsets=sup.offsets.long()))
    with pytest.raises(ValueError, match="leaves"):
        cuda_resample.apply_filter_bank_cuda(
            x, G, M, W, sup._replace(row_used=W + 1))
    assert cuda_resample.launches == before


# -- the WSOLA splice-chain kernel --------------------------------------------

# (rate, tempo, frames, channels): ragged frame counts, a lone frame, mono,
# the 44.1 kHz geometry (stride 1412, overlap 352, 661 candidates), and
# 8 kHz (121 candidates: not a multiple of the 6-candidate register tile;
# overlap 64), stereo and mono.
WSOLA_CASES = [
    (48_000, 0.7937005259840998, 37, 2),
    (48_000, 1.25, 1, 2),
    (48_000, 1.25, 29, 1),
    (44_100, 0.8, 23, 2),
    (8_000, 2.0, 61, 2),
    (8_000, 1.25, 40, 1),
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
    before = (cuda_wsola.launches, cuda_wsola.energy_launches)
    bs, body = cuda_wsola.wsola_chain_cuda(x, head, *args)
    torch.cuda.synchronize()
    assert (cuda_wsola.launches, cuda_wsola.energy_launches) == (
        before[0] + 1, before[1] + 1)
    pbs, pbody = wsola.wsola_chain_plain(x, head, *args)
    assert bs.dtype == torch.int32 and bs.shape == (K,)
    assert body.shape == pbody.shape == (channels, K * (args[3] - args[5]))
    assert torch.equal(bs, pbs)
    assert (body - pbody).abs().max().item() <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("rate,tempo,K,channels", WSOLA_CASES)
def test_wsola_chunk_kernel_matches_plain(cuda_device, rate, tempo, K, channels):
    """The chunk entry: frames k0 .. k0+K-1 read from column frame_pos(k) -
    base of a column slice of a wider buffer (rows cap apart), seeded from
    a carried head; it returns the tail after its last frame."""
    k0 = 9
    x, _, (n_frames, num, den, seq, seek, overlap) = _wsola_operands(
        cuda_device, rate, tempo, k0 + K, channels, seed=3)
    base = frame_pos(k0, num) - 5
    buf = torch.zeros((channels, x.shape[1] - base + 77), device=cuda_device)
    buf[:, : x.shape[1] - base] = x[:, base:]
    window = buf[:, : x.shape[1] - base]          # not contiguous
    head = torch.from_numpy(np.random.default_rng(K).standard_normal(
        (channels, overlap)).astype(np.float32)).to(cuda_device)
    args = (k0, base, K, num, den, seq, seek, overlap)
    before = cuda_wsola.launches
    bs, body, tail = cuda_wsola.wsola_chunk_chain_cuda(window, head, *args)
    torch.cuda.synchronize()
    assert cuda_wsola.launches == before + 1
    pbs, pbody, ptail = wsola.wsola_chunk_chain_plain(window, head, *args)
    assert torch.equal(bs, pbs)
    assert (body - pbody).abs().max().item() <= TOL
    assert torch.equal(tail, ptail)
    # k0 = base = 0 is the offline entry.
    chain = (n_frames, num, den, seq, seek, overlap)
    obs, obody = cuda_wsola.wsola_chain_cuda(x, x[:, :overlap], *chain)
    cbs, cbody, _ = cuda_wsola.wsola_chunk_chain_cuda(x, x[:, :overlap], 0, 0,
                                                      *chain)
    assert torch.equal(obs, cbs) and torch.equal(obody, cbody)
    # No ready frame: no launch, the head comes back as the tail.
    count = cuda_wsola.launches
    _, _, same = cuda_wsola.wsola_chunk_chain_cuda(window, head, k0, base, 0,
                                                   num, den, seq, seek,
                                                   overlap)
    assert same is head and cuda_wsola.launches == count


@pytest.mark.cuda
@pytest.mark.parametrize("rate,tempo,K,channels", WSOLA_CASES[:5])
def test_wsola_energy_prologue_matches_plain(cuda_device, rate, tempo, K,
                                             channels):
    """The prologue's table for frames k0 .. k0+K-1 read from column
    frame_pos(k) - base of a column slice, against the plain conv1d
    energies (rtol 1e-5: two float32 summation orders)."""
    x, _, (n_frames, num, den, seq, seek, overlap) = _wsola_operands(
        cuda_device, rate, tempo, K + 4, channels, seed=2)
    k0 = 4
    base = frame_pos(k0, num) - 3
    window = x[:, base:]
    before = cuda_wsola.energy_launches
    inv = cuda_wsola.wsola_energy_cuda(window, k0, base, K, num, den, seq,
                                       seek, overlap)
    torch.cuda.synchronize()
    assert cuda_wsola.energy_launches == before + 1
    want = wsola.wsola_energy_plain(window, k0, base, K, num, den, seq, seek,
                                    overlap)
    assert inv.shape == want.shape == (K, seek + 1)
    assert ((inv - want).abs() / want).max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("K,block", [(4095, None), (4096, None),
                                     (4097, None), (37, 16), (33, 16)])
def test_wsola_block_walk_equals_the_plain_chain(cuda_device, monkeypatch, K,
                                                 block):
    """The wrapper walks the chain in blocks of BLOCK_FRAMES frames (a
    prologue and a chain launch each, the next block's head the previous
    tail_out): across a block boundary it is the single plain chain."""
    if block is not None:
        monkeypatch.setattr(cuda_wsola, "BLOCK_FRAMES", block)
    blocks = -(-K // cuda_wsola.BLOCK_FRAMES)
    x, head, args = _wsola_operands(cuda_device, 8_000, 1.25, K, 2, seed=6)
    before = (cuda_wsola.launches, cuda_wsola.energy_launches)
    bs, body, tail = cuda_wsola.wsola_chunk_chain_cuda(x, head, 0, 0, *args)
    torch.cuda.synchronize()
    assert (cuda_wsola.launches, cuda_wsola.energy_launches) == (
        before[0] + blocks, before[1] + blocks)
    pbs, pbody, ptail = wsola.wsola_chunk_chain_plain(x, head, 0, 0, *args)
    assert torch.equal(bs, pbs)
    assert (body - pbody).abs().max().item() <= TOL
    assert torch.equal(tail, ptail)


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
    before, energy_before = cuda_wsola.launches, cuda_wsola.energy_launches
    with pytest.raises(ValueError, match="float32"):
        cuda_wsola.wsola_chain_cuda(x.double(), head.double(), *args)
    with pytest.raises(ValueError, match="window reads"):
        cuda_wsola.wsola_chain_cuda(x[:, :-3].contiguous(), head, *args)
    with pytest.raises(ValueError, match="one CUDA device"):
        cuda_wsola.wsola_chain_cuda(x, head.cpu(), *args)
    with pytest.raises(ValueError, match="head"):
        cuda_wsola.wsola_chain_cuda(x, head[:1], *args)
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_wsola.wsola_energy_cuda(x.cpu(), 0, 0, *args)
    with pytest.raises(ValueError, match="window reads"):
        cuda_wsola.wsola_energy_cuda(x[:, :-3].contiguous(), 0, 0, *args)
    with pytest.raises(ValueError, match="rows contiguous"):
        cuda_wsola.wsola_energy_cuda(x.t().contiguous().t(), 0, 0, *args)
    assert cuda_wsola.launches == before
    assert cuda_wsola.energy_launches == energy_before


# -- the WSOLA score table, its walk, the step probes --------------------------

# (rate, tempo, frames, channels): the tests' 8 kHz geometry, 48 kHz
# (721 candidates: 12 row tiles, a ragged last one, 3 candidate passes),
# 44.1 kHz (seek 660, overlap 352), mono.
TABLE_CASES = [
    (8_000, 1.25, 23, 2),
    (48_000, 1.25, 9, 2),
    (44_100, 0.8, 7, 2),
    (48_000, 0.7937005259840998, 6, 1),
]


def _table_gap(x, args, k, p, b1, b2):
    """|score64(b1) - score64(b2)| / max_b |score64(b)| of table row (k, p)."""
    K, num, den, seq, seek, overlap = args
    pos = frame_pos(k, num, den)
    start = frame_pos(k - 1, num, den) + seq - overlap + p if k else 0
    tail = x[:, start : start + overlap].double().cpu().numpy()
    cand = x[:, pos : pos + seek + overlap].double().cpu().numpy()
    win = np.lib.stride_tricks.sliding_window_view(cand, overlap, axis=1)
    scores = (np.einsum("cv,cbv->b", tail, win)
              / np.sqrt((win * win).sum(axis=(0, 2)) + 1e-9))
    return abs(scores[b1] - scores[b2]) / np.abs(scores).max()


@pytest.mark.cuda
@pytest.mark.parametrize("rate,tempo,K,channels", TABLE_CASES)
def test_score_table_kernel_matches_plain(cuda_device, rate, tempo, K,
                                          channels):
    x, _, args = _wsola_operands(cuda_device, rate, tempo, K, channels, seed=5)
    before = cuda_wsola_table.table_launches
    table = cuda_wsola_table.wsola_score_table_cuda(x, *args)
    torch.cuda.synchronize()
    assert cuda_wsola_table.table_launches == before + 1
    want = wsola.wsola_score_table_plain(x, *args)
    assert table.dtype == torch.int32 and table.shape == want.shape
    assert (table[0] == table[0, 0]).all()
    differ = (table != want).nonzero().tolist()
    assert len(differ) <= 0.01 * table.numel()
    for k, p in differ:
        gap = _table_gap(x, args, k, p, int(table[k, p]), int(want[k, p]))
        assert gap <= 1e-5
    for fps in (2, 4, K + 3):
        assert torch.equal(table, cuda_wsola_table.wsola_score_table_cuda(
            x, *args, frames_per_step=fps))


# The walk kernel's segment length at config 4's velocity stage (K = 7,507
# on 132 SMs); tests/test_torch_wsola_table.py cuts its tables around it.
WALK_SEG = 64


def _walk_cases(seed):
    """(tag, table, the walk in a Python loop): tests/test_torch_wsola_
    table.py's random tables (n_cand 661 and 721, K in {1, L-1, L, L+1,
    3L+7}), and on the 3L+7-frame ones an entry outside [0, n_cand) planted
    on the walk's path at a segment's first row, in a segment's middle and
    on the last frame (the prefix, then -1s), or off the path (no
    change)."""
    rng = np.random.default_rng(seed)
    for n in (661, 721):
        for K in (1, WALK_SEG - 1, WALK_SEG, WALK_SEG + 1, 3 * WALK_SEG + 7):
            rows = rng.integers(0, n, (K, n)).astype(np.int32)
            path, b = [], 0
            for row in rows:
                b = int(row[b])
                path.append(b)
            yield f"n={n} K={K}", rows, path
        for k, bad in ((2 * WALK_SEG, n), (WALK_SEG + 17, -1), (K - 1, n + 9)):
            planted = rows.copy()
            planted[k, path[k - 1]] = bad
            yield (f"n={n} K={K}, {bad} at frame {k}", planted,
                   path[:k] + [-1] * (K - k))
        off = rows.copy()
        off[WALK_SEG + 17, (path[WALK_SEG + 16] + 1) % n] = -1
        yield f"n={n} K={K}, -1 off the path", off, path


@pytest.mark.cuda
@pytest.mark.parametrize("rate,tempo,K,channels", TABLE_CASES)
def test_score_table_walk_is_the_chain_kernel(cuda_device, rate, tempo, K,
                                              channels):
    """The table scores in the chain kernel's order: the row of the chain's
    previous choice holds its next choice, and the walk is the chain."""
    x, head, args = _wsola_operands(cuda_device, rate, tempo, K, channels)
    table = cuda_wsola_table.wsola_score_table_cuda(x, *args)
    bs, _ = cuda_wsola.wsola_chain_cuda(x, head, *args)
    assert table[0, 0] == bs[0]
    assert torch.equal(table[1:].gather(1, bs[:-1].long()[:, None])[:, 0],
                       bs[1:])
    before = cuda_wsola_table.walk_launches
    walk = cuda_wsola_table.walk_table_cuda(table)
    torch.cuda.synchronize()
    assert cuda_wsola_table.walk_launches == before + 1
    assert torch.equal(walk, wsola.walk_table_plain(table))
    assert torch.equal(walk, bs)
    assert torch.equal(wsola.splice_offsets(x, *args), bs)
    # At any segment length the walk kernel is bitwise the plain walk and
    # the composed plain walk: on this table, and on random and planted
    # ones (the -1 contract).
    cases = [("score table", table.cpu().numpy(), bs.tolist()),
             *_walk_cases(K)]
    before = cuda_wsola_table.walk_launches
    for tag, rows, want in cases:
        table = torch.from_numpy(rows).to(cuda_device)
        plain = wsola.walk_table_plain(table)
        assert plain.tolist() == want, tag
        for seg in (None, 1, 3, WALK_SEG, rows.shape[0] + 1):
            assert torch.equal(cuda_wsola_table.walk_table_cuda(table, seg),
                               plain), (tag, seg)
            if seg is not None:
                assert torch.equal(
                    wsola.walk_table_segments_plain(table, seg), plain), (
                    tag, seg)
    torch.cuda.synchronize()
    assert cuda_wsola_table.walk_launches == before + 5 * len(cases)


@pytest.mark.cuda
def test_score_table_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    x, _, args = _wsola_operands(cuda_device, 8_000, 1.25, 5, 2)
    before = (cuda_wsola_table.table_launches, cuda_wsola_table.walk_launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_wsola_table.wsola_score_table_cuda(x.cpu(), *args)
    with pytest.raises(ValueError, match="window reads"):
        cuda_wsola_table.wsola_score_table_cuda(x[:, :-3].contiguous(), *args)
    with pytest.raises(ValueError, match="float32"):
        cuda_wsola_table.wsola_score_table_cuda(x.double(), *args)
    with pytest.raises(ValueError, match="frames_per_step"):
        cuda_wsola_table.wsola_score_table_cuda(x, *args, frames_per_step=0)
    table = wsola.wsola_score_table_plain(x, *args)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_wsola_table.walk_table_cuda(table.cpu())
    with pytest.raises(ValueError, match="int32"):
        cuda_wsola_table.walk_table_cuda(table.long())
    with pytest.raises(ValueError, match="seg_frames"):
        cuda_wsola_table.walk_table_cuda(table, 0)
    wide = cuda_wsola_table._build.load_library(
        "wsola_score_table").nodey_wsola_walk_max_cands() + 1
    with pytest.raises(ValueError, match=f"rows of {wide} candidates"):
        cuda_wsola_table.walk_table_cuda(torch.zeros(
            (2, wide), dtype=torch.int32, device=cuda_device))
    assert (cuda_wsola_table.table_launches,
            cuda_wsola_table.walk_launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 5, 4096])
def test_step_probes_match_plain(cuda_device, K):
    """Each form at K and at 1-4 and 4097 steps: the ring's mbarriers wrap
    their phase parity at steps 3-5, the pair's at 2-3."""
    rng = np.random.default_rng(K)
    block = torch.from_numpy(rng.standard_normal((8, 128)).astype(
        np.float32)).to(cuda_device)
    wide = torch.from_numpy(rng.standard_normal((2, 1 << 16)).astype(
        np.float32)).to(cuda_device)
    steps = sorted({K, 1, 2, 3, 4, 4097})
    before = (cuda_probes.bare_launches, cuda_probes.dma_launches)
    for k in steps:
        for per_step in (True, False):
            got = cuda_probes.step_probe_bare_cuda(block, k, per_step)
            assert torch.equal(got, cuda_probes.step_probe_bare_plain(
                block, k, per_step)), (k, per_step)
        for ring in (True, False):
            got = cuda_probes.step_probe_dma_cuda(wide, k, 1280, ring)
            assert torch.equal(got, cuda_probes.step_probe_dma_plain(
                wide, k, 1280, ring)), (k, ring)
    torch.cuda.synchronize()
    assert (cuda_probes.bare_launches, cuda_probes.dma_launches) == (
        before[0] + 2 * len(steps), before[1] + 2 * len(steps))
    with pytest.raises(ValueError, match="float32"):
        cuda_probes.step_probe_bare_cuda(block.double(), K)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_probes.step_probe_dma_cuda(wide.cpu(), K, 1280)
    # Bulk copies need 16-byte alignment: no other copy path takes these.
    with pytest.raises(ValueError, match="16-byte"):
        cuda_probes.step_probe_dma_cuda(wide[:, 1:], K, 1280)
    with pytest.raises(ValueError, match="16-byte"):
        cuda_probes.step_probe_dma_cuda(
            torch.zeros((2, (1 << 16) + 1), device=cuda_device)[:, :-1], K,
            1280)
    with pytest.raises(ValueError, match="16-byte"):
        cuda_probes.step_probe_bare_cuda(
            torch.zeros(1025, device=cuda_device)[1:].view(8, 128), K)
    with pytest.raises(ValueError, match="16-byte"):
        cuda_probes.step_probe_dma_cuda(wide, K, 1282)
    assert (cuda_probes.bare_launches, cuda_probes.dma_launches) == (
        before[0] + 2 * len(steps), before[1] + 2 * len(steps))


# -- the phase-vocoder kernels -------------------------------------------------

# (rate, tempo, seconds, channels): a ragged last tile, mono, the 22.05 and
# 8 kHz bin counts (513, 257), and a clip shorter than one tile.
PV_CASES = [
    (48_000, 0.7937005259840998, 1.3, 2),
    (48_000, 1.25, 0.9, 1),
    (22_050, 0.8, 1.1, 2),
    (8_000, 2.0, 2.5, 2),
    (48_000, 1.25, 0.2, 2),
]


def _snr_db(reference, test):
    reference = reference.double().cpu()
    noise = ((reference - test.double().cpu()) ** 2).sum().item()
    return math.inf if noise == 0 else 10 * math.log10(
        (reference ** 2).sum().item() / noise)


def _pv_planes(device, rate, tempo, seconds, channels, seed=0):
    rng = np.random.default_rng(seed)
    n = int(rate * seconds)
    t = np.arange(n) / rate
    x = np.stack([0.5 * np.sin(2 * np.pi * (440.0 + 97 * c) * t)
                  + 0.2 * np.sin(2 * np.pi * 1234.5 * t + c)
                  + 0.05 * rng.standard_normal(n) for c in range(channels)])
    data = torch.from_numpy(x.astype(np.float32)).to(device)
    n_fft, hop, pos, dpos, pad_to = pv._pv_geometry(n, tempo, rate)
    re, im = pv._analysis(data, pos, pad_to, n_fft)
    return re, im, dpos, hop, n_fft


# (C, K, n_fft, rows): planes made directly. K around the 64-frame tile
# (1, 63, 64, 65; 100 and 130 are not whole tiles) and grids of more than
# one wave of apply CTAs (K = 8,500: 2 x 133 CTAs, 264 a wave), B = 1025
# (its odd top bin) and 257 (pv_params' smallest row); "special" rows at frames 3, 5, 7 and 9 of every 64 (see
# _special_planes), noise elsewhere.
PV_SYNTHETIC = [
    (2, 1, 2048, "noise"), (1, 63, 2048, "noise"), (2, 64, 2048, "noise"),
    (2, 65, 2048, "noise"), (2, 100, 512, "noise"), (2, 130, 2048, "special"),
    (1, 130, 512, "special"), (2, 8500, 512, "special"),
    (2, 8500, 2048, "special"),
]


def _special_planes(device, C, K, n_fft, rows, seed=1):
    """Noise planes [C, K, n_fft//2 + 1] with, where ``rows`` is "special",
    an all-zero frame (atan2(0, 0) = 0), a frame whose magnitudes rise to
    the top bin (its one peak: no bin has a peak before it), a frame of
    equal magnitudes (bin 0 its one peak: ties in magnitude) and a comb
    with a peak every 10 bins (the bins half way between two take the
    earlier one), at frames 3, 5, 7 and 9 of every 64."""
    rng = np.random.default_rng(seed)
    B = n_fft // 2 + 1
    mag = np.abs(rng.standard_normal((C, K, B))).cumsum(-1) / B
    mag *= rng.uniform(0.5, 1.5, (C, K, B))
    phase = rng.uniform(-np.pi, np.pi, (C, K, B))
    re, im = mag * np.cos(phase), mag * np.sin(phase)
    if rows == "special":
        quarter = np.array([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [0.0, -1.0]])
        for k0 in range(0, K, 64):
            for k, kind in zip(range(k0 + 3, k0 + 10, 2),
                               ("zero", "rise", "equal", "comb")):
                if k >= K:
                    continue
                if kind == "zero":
                    re[:, k], im[:, k] = 0.0, 0.0
                elif kind == "rise":
                    re[:, k] = np.arange(1, B + 1) / B
                    im[:, k] = 0.0
                elif kind == "equal":
                    unit = quarter[rng.integers(0, 4, (C, B))]
                    re[:, k], im[:, k] = unit[..., 0], unit[..., 1]
                else:
                    re[:, k] = np.where(np.arange(B) % 10 == 0, 1.0, 0.5)
                    im[:, k] = 0.0
    hop = n_fft // 4
    dpos = hop + rng.integers(-1, 2, K)
    dpos[0] = hop
    planes = [torch.from_numpy(a.astype(np.float32)).to(device)
              for a in (re, im)]
    return (*planes, dpos, hop, n_fft)


@pytest.mark.cuda
def test_pv_phase_kernel_matches_plain(cuda_device):
    """Every case of PV_CASES and PV_SYNTHETIC, with and without lock, each
    held to its own bars (one item: the count of collected tests decides
    how the parallel test run splits its work)."""
    for case in PV_CASES + PV_SYNTHETIC:
        for lock in (True, False):
            name = f"case {'-'.join(map(str, case))}, lock={lock}"
            if len(case) == 4 and isinstance(case[3], str):
                re, im, dpos, hop, n_fft = _special_planes(cuda_device, *case)
            else:
                re, im, dpos, hop, n_fft = _pv_planes(cuda_device, *case)
            before = cuda_pv.phase_path_launches
            ry, iy = cuda_pv.phase_path_cuda(re, im, dpos, hop, n_fft, lock)
            torch.cuda.synchronize()
            assert cuda_pv.phase_path_launches == before + 1, name
            pry, piy = pv.phase_path_plain(re, im, dpos, hop, n_fft, lock)
            assert ry.shape == pry.shape == re.shape, name
            assert _snr_db(pry, ry) >= 100.0, name
            assert _snr_db(piy, iy) >= 100.0, name
            mag = torch.sqrt(re * re + im * im)
            live = mag > 0
            err = torch.hypot(ry - pry, iy - piy)[live] / mag[live]
            assert err.max().item() <= 1e-3, name


@pytest.mark.cuda
@pytest.mark.parametrize("lock", [True, False])
def test_pv_phase_kernel_makes_no_stream_sync(cuda_device, lock):
    """The wrapper uploads the hops and its tables from pinned memory, once
    per geometry: calls under set_sync_debug_mode("error"), one that
    uploads and one that finds them, raise on any sync."""
    re, im, dpos, hop, n_fft = _pv_planes(cuda_device, 48_000, 1.25, 0.9, 2)
    want = cuda_pv.phase_path_cuda(re, im, dpos, hop, n_fft, lock)
    torch.cuda.synchronize()
    cuda_pv._device_tables.cache_clear()
    before = cuda_pv.phase_path_launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [cuda_pv.phase_path_cuda(re, im, dpos, hop, n_fft, lock)
               for _ in range(2)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert cuda_pv.phase_path_launches == before + 2
    for ry, iy in got:
        assert torch.equal(ry, want[0]) and torch.equal(iy, want[1])


def _lock_planes(device, C, K, B, silent=(), phase_scale=np.pi, seed=None):
    """The lock's four [C, K, B] planes: unit phasors, phases uniform in
    +-phase_scale, random-walk magnitudes; frames ``silent`` all zero."""
    rng = np.random.default_rng(K if seed is None else seed)
    phi = rng.uniform(-np.pi, np.pi, (C, K, B))
    ph_in = rng.uniform(-phase_scale, phase_scale, (C, K, B))
    mag = np.abs(np.cumsum(rng.standard_normal((C, K, B)), axis=-1))
    mag[:, list(silent), :] = 0.0
    return [torch.from_numpy(a.astype(np.float32)).to(device)
            for a in (np.cos(phi), np.sin(phi), ph_in, mag)]


def _locked(planes):
    """The lock kernel's output on ``planes`` (one launch, counted), and the
    plain lock's on the same planes."""
    before = cuda_pv.lock_launches
    got = cuda_pv.lock_to_peaks_cuda(*planes)
    torch.cuda.synchronize()
    assert cuda_pv.lock_launches == before + 1
    return got, pv._lock_to_peaks(*planes)


# (C, K, B, silent frames, phase range): B of pv_params' rows (257 to 4097)
# and others (3, 33), silent frames and a wholly silent clip, phases past
# sincosf's fast path (|d| > 105,615).
@pytest.mark.cuda
@pytest.mark.parametrize("C,K,B,silent,phase_scale", [
    (2, 37, 1025, (), np.pi), (1, 64, 257, (), np.pi),
    (2, 16, 1025, (0, 7, 15), np.pi), (1, 3, 513, (1,), np.pi),
    (1, 7, 2049, (2,), np.pi), (2, 5, 4097, (3,), np.pi),
    (1, 9, 1025, tuple(range(9)), np.pi), (1, 13, 1025, (), 3e5),
    (1, 6, 3, (), np.pi), (2, 5, 33, (1,), np.pi),
])
def test_pv_lock_kernel_matches_plain(cuda_device, C, K, B, silent,
                                      phase_scale):
    """On finite inputs the kernel makes the plain lock's decisions and
    roundings: bitwise its output."""
    (oc, os_), (poc, pos_) = _locked(
        _lock_planes(cuda_device, C, K, B, silent, phase_scale))
    assert torch.equal(oc, poc) and torch.equal(os_, pos_)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [257, 1025, 2049, 4097])
def test_pv_lock_kernel_ragged_last_cta(cuda_device, B):
    """A CTA locks several rows, one a warp: row counts that leave the last
    CTA part empty."""
    from nodey_tpu_torch.ops import _build

    per_cta = _build.load_library("pv_lock").nodey_pv_lock_rows_per_cta(B)
    assert per_cta >= 2
    for rows in (per_cta + 1, 3 * per_cta - 1):
        (oc, os_), (poc, pos_) = _locked(
            _lock_planes(cuda_device, 1, rows, B, seed=rows))
        assert torch.equal(oc, poc) and torch.equal(os_, pos_)


@pytest.mark.cuda
def test_pv_lock_kernel_at_a_mid_clip_chunk_shape(cuda_device):
    """The streamed PV's pitch-stage chunk shape [2, 1,894, 1025], on the
    lock inputs of analysed planes, frames from the middle of the clip."""
    re, im, dpos, hop, n_fft = _pv_planes(cuda_device, 48_000,
                                          2.0 ** (-4 / 12), 40.0, 2)
    mag, ph = pv._magnitude_phase(re, im)
    cos_phi, sin_phi = pv._synthesis_phasors(ph, dpos, hop, n_fft)
    k0 = (mag.shape[1] - 1894) // 2
    planes = [t[:, k0 : k0 + 1894].contiguous()
              for t in (cos_phi, sin_phi, ph, mag)]
    (oc, os_), (poc, pos_) = _locked(planes)
    assert oc.shape == (2, 1894, 1025)
    assert torch.equal(oc, poc) and torch.equal(os_, pos_)


@pytest.mark.cuda
def test_pv_lock_kernel_on_inputs_that_are_not_finite(cuda_device):
    """NaN magnitudes (rows with no peak, or peaks cut off), infinite and
    NaN phases and phasors: within 2e-6 of the plain lock, NaN where it is
    NaN."""
    planes = _lock_planes(cuda_device, 2, 11, 1025, seed=3)
    cos_phi, sin_phi, ph_in, mag = planes
    mag[0, 2] = math.nan
    mag[1, 4, ::7] = math.nan
    ph_in[0, 5, 100:140] = math.inf
    ph_in[1, 6, 600] = -math.inf
    ph_in[1, 7, 300:310] = math.nan
    cos_phi[0, 8, 50] = math.nan
    (oc, os_), (poc, pos_) = _locked(planes)
    for got, want in ((oc, poc), (os_, pos_)):
        assert torch.equal(got.isnan(), want.isnan())
        assert torch.allclose(got, want, rtol=0.0, atol=2e-6, equal_nan=True)


@pytest.mark.cuda
def test_pv_lock_kernel_makes_no_stream_sync(cuda_device):
    """The lock launches without a sync: two calls under
    set_sync_debug_mode("error"), bitwise the first call's output."""
    planes = _lock_planes(cuda_device, 2, 40, 1025)
    want = cuda_pv.lock_to_peaks_cuda(*planes)
    torch.cuda.synchronize()
    before = cuda_pv.lock_launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [cuda_pv.lock_to_peaks_cuda(*planes) for _ in range(2)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert cuda_pv.lock_launches == before + 2
    for oc, os_ in got:
        assert torch.equal(oc, want[0]) and torch.equal(os_, want[1])


def _stretch_input():
    rng = np.random.default_rng(12)
    t = np.arange(40_000) / 48_000
    return np.stack([0.5 * np.sin(2 * np.pi * 330.0 * t),
                     0.3 * rng.standard_normal(40_000)]).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("kwargs,kernel", [
    ({}, "phase_path"),
    ({"lock": False}, "phase_path"),
    ({"transient": True}, "lock"),
])
def test_pv_stretch_on_card_matches_cpu(cuda_device, kwargs, kernel):
    """The card's render (its GEMMs, transcendentals and prefix order
    differ from the CPU's) stays >= 90 dB from the CPU's, and routes as
    the JAX package does: the fused kernel on the main path, the lock
    kernel on the option paths."""
    data = _stretch_input()
    before = (cuda_pv.phase_path_launches, cuda_pv.lock_launches)
    out, n = pv.pv_stretch_at_rate(torch.from_numpy(data).to(cuda_device),
                                   39_000, 1.25, 48_000, **kwargs)
    want, want_n = pv.pv_stretch_at_rate(torch.from_numpy(data), 39_000,
                                         1.25, 48_000, **kwargs)
    after = (cuda_pv.phase_path_launches, cuda_pv.lock_launches)
    assert out.is_cuda and n == want_n and out.shape == want.shape
    assert _snr_db(want[:, :n], out[:, :n]) >= 90.0
    launched = [a - b for a, b in zip(after, before)]
    assert launched == ([1, 0] if kernel == "phase_path" else [0, 1])


@pytest.mark.cuda
def test_pv_formant_path_locks_through_the_kernel(cuda_device, monkeypatch):
    """The formant pre-warp takes the log of every bin's magnitude, and the
    leakage bins of a clean tone hold magnitudes near the GEMMs' rounding
    floor, so the card's render is not held to the CPU's here: it is held
    to the same render on the card with the plain lock in place of the
    kernel (>= 100 dB)."""
    x = torch.from_numpy(_stretch_input()).to(cuda_device)
    args = (x, 39_000, 1.25, 48_000)
    before = cuda_pv.lock_launches
    out, n = pv.pv_stretch_at_rate(*args, formant_ratio=2 ** (4 / 12))
    assert cuda_pv.lock_launches == before + 1
    monkeypatch.setattr(cuda_pv, "lock_to_peaks_cuda", pv._lock_to_peaks)
    want, want_n = pv.pv_stretch_at_rate(*args, formant_ratio=2 ** (4 / 12))
    assert n == want_n and torch.isfinite(out).all()
    assert _snr_db(want[:, :n], out[:, :n]) >= 100.0


def _pv_stream(x, plan, device):
    """The streaming PV over ``x`` [C, n] on ``device``, each step under
    set_sync_debug_mode("error"): (output, steps with frames)."""
    state = pv.pv_stream_init(plan, x.shape[0], device)
    pieces, with_frames, fed = [], 0, 0
    while True:
        n = min(plan.push_cap, x.shape[1] - fed)
        block = torch.zeros((x.shape[0], plan.push_cap), device=device)
        block[:, :n] = x[:, fed : fed + n]
        fed += n
        k0 = state.k
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, out, out_n, done = pv.pv_stream_step(
                plan, state, block, n, fed >= x.shape[1])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        with_frames += state.k > k0
        pieces.append(out[:, :out_n])
        if done:
            return torch.cat(pieces, dim=1), with_frames


@pytest.mark.cuda
@pytest.mark.parametrize("options", [{}, {"transient": True,
                                          "formant_ratio": 2 ** (4 / 12)}])
def test_pv_stream_step_locks_through_the_kernel_without_a_sync(
        cuda_device, monkeypatch, options):
    """Every chunk step with frames launches the lock kernel once, none the
    phase-path kernel, and no step syncs; the output is the same steps'
    with the plain lock (>= 100 dB)."""
    x = torch.from_numpy(_stretch_input()).to(cuda_device)
    plan = pv.pv_stream_plan(1.25, 48_000, 4_800, **options)
    before = (cuda_pv.phase_path_launches, cuda_pv.lock_launches)
    got, with_frames = _pv_stream(x, plan, cuda_device)
    after = (cuda_pv.phase_path_launches, cuda_pv.lock_launches)
    assert with_frames >= 8
    assert [a - b for a, b in zip(after, before)] == [0, with_frames]
    monkeypatch.setattr(cuda_pv, "lock_to_peaks_cuda", pv._lock_to_peaks)
    want, _ = _pv_stream(x, plan, cuda_device)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert _snr_db(want, got) >= 100.0


@pytest.mark.cuda
def test_pv_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    re, im, dpos, hop, n_fft = _pv_planes(cuda_device, 8_000, 1.25, 0.5, 2)
    before = (cuda_pv.phase_path_launches, cuda_pv.lock_launches)
    with pytest.raises(ValueError, match="float32"):
        cuda_pv.phase_path_cuda(re.double(), im.double(), dpos, hop, n_fft)
    with pytest.raises(ValueError, match="one CUDA device"):
        cuda_pv.phase_path_cuda(re, im.cpu(), dpos, hop, n_fft)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_pv.phase_path_cuda(re.transpose(0, 1), im.transpose(0, 1),
                                dpos, hop, n_fft)
    with pytest.raises(ValueError, match="do not fit"):
        cuda_pv.phase_path_cuda(re, im, dpos[:-1], hop, n_fft)
    with pytest.raises(ValueError, match="do not fit"):
        cuda_pv.phase_path_cuda(re, im, dpos, hop, 2 * n_fft)
    with pytest.raises(ValueError, match="power of two"):  # B = 513//2 + 1
        cuda_pv.phase_path_cuda(re, im, dpos, hop, n_fft + 1)
    small = re[..., :129].contiguous()  # n_fft 256: below pv_params' rows
    with pytest.raises(ValueError, match="rows of 257"):
        cuda_pv.phase_path_cuda(small, small, dpos, hop // 2, 256)
    with pytest.raises(ValueError, match="one shape"):
        cuda_pv.lock_to_peaks_cuda(re, im, re, im[:, :-1].contiguous())
    wide = torch.zeros((1, 2, 4098), device=cuda_device)
    with pytest.raises(ValueError, match="rows of 1 to 4097"):
        cuda_pv.lock_to_peaks_cuda(wide, wide, wide, wide)
    assert (cuda_pv.phase_path_launches, cuda_pv.lock_launches) == before


# -- batched serving: a clip axis on the resampler, the WSOLA chain and its
#    prologue, the phase path and the lock ------------------------------------


@pytest.mark.cuda
def test_batched_kernels_take_the_clip_axis(cuda_device, monkeypatch):
    for in_rate, out_rate in ((44_100, 48_000), (635, 504)):
        _check_batched_resampler(cuda_device, in_rate, out_rate)
    for K, block in ((300, None), (37, 16)):
        with monkeypatch.context() as patch:
            if block is not None:
                patch.setattr(cuda_wsola, "BLOCK_FRAMES", block)
            _check_batched_chain(cuda_device, K)
    for kwargs, kernel in (({}, "phase_path_launches"),
                           ({"transient": True, "formant_ratio": 1.26},
                            "lock_launches")):
        _check_batched_pv(cuda_device, kwargs, kernel)


def _check_batched_resampler(cuda_device, in_rate, out_rate):
    """[B, C, N] folds into the kernel's rows: one launch, each clip
    bitwise its own launch, within 2e-6 of the batched plain version."""
    data = torch.stack([_data(cuda_device, 40_001, seed=b) for b in range(3)])
    x, G, M, W, bank, support = tr.bank_operands(data, in_rate, out_rate)
    before = cuda_resample.launches
    got = cuda_resample.apply_filter_bank_cuda(x, G, M, W, support)
    torch.cuda.synchronize()
    assert cuda_resample.launches == before + 1
    for b in range(3):
        one = cuda_resample.apply_filter_bank_cuda(x[b].contiguous(), G, M, W,
                                                   support)
        assert torch.equal(got[b], one)
    want = tr.apply_filter_bank_plain(x, G, M, W, bank)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= TOL


def _check_batched_chain(cuda_device, K):
    """Three clips in one chain launch and one prologue launch per block:
    each clip's splices, body and tail bitwise its single launch's, and its
    splices those of the plain chain."""
    blocks = -(-K // cuda_wsola.BLOCK_FRAMES)
    clips = [_wsola_operands(cuda_device, 8_000, 1.25, K, 2, seed=b)
             for b in range(3)]
    args = clips[0][2]
    x = torch.stack([c[0] for c in clips])
    head = torch.stack([c[1] for c in clips])
    before = (cuda_wsola.launches, cuda_wsola.energy_launches)
    bs, body, tail = cuda_wsola.wsola_chunk_chain_cuda(x, head, 0, 0, *args)
    torch.cuda.synchronize()
    assert (cuda_wsola.launches, cuda_wsola.energy_launches) == (
        before[0] + blocks, before[1] + blocks)
    assert bs.shape == (3, K) and tail.shape == head.shape
    for b in range(3):
        one = cuda_wsola.wsola_chunk_chain_cuda(x[b], head[b], 0, 0, *args)
        assert all(torch.equal(o, g[b]) for o, g in zip(one, (bs, body, tail)))
    pbs, pbody = wsola.wsola_chain_plain(x, head, *args)
    assert torch.equal(bs, pbs)
    assert (body - pbody).abs().max().item() <= TOL
    inv = cuda_wsola.wsola_energy_cuda(x, 0, 0, K, *args[1:])
    want = wsola.wsola_energy_plain(x, 0, 0, K, *args[1:])
    assert inv.shape == want.shape == (3, K, args[4] + 1)
    assert ((inv - want).abs() / want).max().item() <= 1e-5


def _check_batched_pv(cuda_device, kwargs, kernel):
    """The PV of three clips: one launch of its kernel, each clip bitwise
    its single render, each clip's length its own."""
    rng = np.random.default_rng(12)
    data = torch.from_numpy((0.3 * rng.standard_normal((3, 2, 24_000))).astype(
        np.float32)).to(cuda_device)
    lengths = (24_000, 17_000, 8_000)
    for b, n in enumerate(lengths):
        data[b, :, n:] = 0.0
    before = getattr(cuda_pv, kernel)
    out, out_len = pv.pv_stretch_at_rate(data, lengths, 0.8, 48_000, **kwargs)
    assert getattr(cuda_pv, kernel) == before + 1
    for b, n in enumerate(lengths):
        one, one_len = pv.pv_stretch_at_rate(data[b], n, 0.8, 48_000, **kwargs)
        assert out_len[b] == one_len
        assert torch.equal(out[b], one)


@pytest.mark.cuda
def test_sharded_graph_on_a_virtual_mesh_is_the_single_render(cuda_device):
    """The 5-node graph (gain, a 44.1 -> 48 kHz amix, spectrum) at sp = 4
    on a virtual mesh of the card: the master and the spectrum's frames
    bitwise the single render on the card, the length equal, each input's
    windows through the polyphase kernel (a launch per input per shard)."""
    from nodey_tpu_torch.core import compiler
    from nodey_tpu_torch.core.graph import Graph
    from nodey_tpu_torch.parallel import sharded
    from nodey_tpu_torch.parallel.mesh import make_mesh
    from nodey_tpu_torch.processors.amix import AudioAmix
    from nodey_tpu_torch.processors.audio_input import AudioInput
    from nodey_tpu_torch.processors.audio_output import AudioOutput
    from nodey_tpu_torch.processors.audio_vol import AudioVol
    from nodey_tpu_torch.processors.spectrum import AudioSpectrum

    g = Graph()
    src = g.add_node(AudioInput())
    g.nodes[src].processor.file_paths = ["0.wav", "1.wav"]
    g.update_node_pin(src)
    vol = g.add_node(AudioVol())
    g.nodes[vol].processor.set_volume(1.5)
    amix = g.add_node(AudioAmix())
    g.nodes[amix].processor.set_input_num(2)
    g.nodes[amix].processor.volumes = [0.6, 0.4]
    spec = g.add_node(AudioSpectrum())
    out = g.add_node(AudioOutput())

    def pin(n, p):
        return g.nodes[n].pin_name_map[p]

    g.add_link(pin(src, "output_0"), pin(vol, "input"))
    g.add_link(pin(vol, "output"), pin(amix, "input_1"))
    g.add_link(pin(src, "output_1"), pin(amix, "input_2"))
    g.add_link(pin(amix, "output"), pin(spec, "input"))
    g.add_link(pin(spec, "output"), pin(out, "input"))

    mesh = make_mesh({"sp": 4}, [cuda_device] * 4)
    n = 44_100 * 3
    cap = sharded.plan_capacity_for(g, 44_100, n, mesh)
    rng = np.random.default_rng(5)
    arrays, lengths, sources = {}, {}, {}
    for i in range(2):
        x = np.zeros((2, cap), dtype=np.float32)
        valid = n - 4_321 * i
        x[:, :valid] = 0.3 * rng.standard_normal((2, valid))
        key = compiler.external_key(src, f"output_{i}")
        arrays[key] = torch.from_numpy(x).to(cuda_device)
        lengths[key] = valid
        sources[(src, f"output_{i}")] = compiler.SourceSpec(
            rate=44_100, channels=2, fmt="flt", capacity=cap)
    single = compiler.compile_graph(g, sources, device=cuda_device)
    ref, _ = single({k: (v, lengths[k]) for k, v in arrays.items()})
    sc = sharded.compile_graph_sharded(g, sources, mesh)
    before = cuda_resample.launches
    got = sc.run(arrays, lengths)
    torch.cuda.synchronize()
    assert cuda_resample.launches == before + 2 * 4
    assert got["master"][1] == ref["master"][1]
    assert torch.equal(got["master"][0], ref["master"][0])
    key = next(k for k in ref if k.startswith("spectrum_"))
    frames = ref[key].shape[1]
    assert torch.equal(got[key][:, :frames], ref[key])


@pytest.mark.cuda
def test_tp_conv_and_dp_sp_tp_on_a_virtual_mesh(cuda_device):
    """The reverb convolution sharded over tp 2 and 4 on a virtual mesh of
    the card, and the card's unsharded partitioned_conv, each against the
    float64 convolution: the sharded one's SNR at most 1 dB below the
    unsharded one's and its max|error| within 2x. (tests/test_tp.py's 130
    dB between the two cannot hold on the card: the unsharded conv's
    cuBLAS float32 GEMMs are only ~116-126 dB from float64 themselves.)
    Then the 5-node graph and the reverb tail over dp 2 x sp 2 x tp 2, two
    clips a dp shard: each clip's length the card's reference_pipeline's,
    the clip and the reference each against the pipeline in float64 after
    the single render, at the same bar; each input's windows through the
    polyphase kernel."""
    import torch.nn.functional as F

    from nodey_tpu_torch.core import compiler
    from nodey_tpu_torch.ops import reverb
    from nodey_tpu_torch.ops.scans import mask_tail
    from nodey_tpu_torch.parallel import dp_sp_tp, sharded, tp
    from nodey_tpu_torch.parallel.dcn import _dryrun_graph
    from nodey_tpu_torch.parallel.mesh import make_mesh

    def conv64(x, ir, out_len):
        n = 1 << (out_len - 1).bit_length()
        spec = torch.fft.rfft(x.double(), n) * torch.fft.rfft(
            ir.to(x.device).double(), n)
        return torch.fft.irfft(spec, n)[..., :out_len]

    def error(exact, got):
        err = got.double() - exact
        return (10 * math.log10(exact.square().sum().item()
                                / err.square().sum().item()),
                (err.abs().max() / exact.abs().max()).item())

    def no_worse(exact, got, base):
        (db, rel), (base_db, base_rel) = error(exact, got), error(exact, base)
        return db >= base_db - 1.0 and rel <= 2.0 * base_rel

    rng = np.random.default_rng(8)
    x = torch.from_numpy((0.3 * rng.standard_normal((2, 48_000 * 4))
                          ).astype(np.float32)).to(cuda_device)
    ir = torch.from_numpy(reverb.design_ir(48_000, 2, 1.8, 20.0, 0.5))
    hr, hi = reverb.partitions(48_000, 2, 1.8, 20.0, 0.5, cuda_device)
    out_len = x.shape[1] + ir.shape[1] - 1
    exact = conv64(x, ir, out_len)
    want = reverb.partitioned_conv(x, hr, hi, out_len)
    for n in (2, 4):
        got = tp.partitioned_conv_tp(x, hr, hi, out_len,
                                     make_mesh({"tp": n}, [cuda_device] * n))
        assert no_worse(exact, got, want), n

    g, src = _dryrun_graph()
    axes = {"dp": 2, "sp": 2, "tp": 2}
    mesh = make_mesh(axes, [cuda_device] * 8)
    n = 44_100 * 2
    cap = sharded.plan_capacity_for(g, 44_100, n, mesh)
    sources = {(src, f"output_{i}"): compiler.SourceSpec(
        rate=44_100, channels=2, fmt="flt", capacity=cap) for i in range(2)}
    prog = dp_sp_tp.compile_flagship_reverb_dpsptp(g, sources, mesh)
    arrays, lengths = {}, {}
    for i in range(2):
        key = compiler.external_key(src, f"output_{i}")
        clips = np.zeros((4, 2, cap), dtype=np.float32)
        lens = [n - 3_001 * b for b in range(4)]
        for b, m in enumerate(lens):
            clips[b, :, :m] = 0.3 * rng.standard_normal((2, m))
        arrays[key], lengths[key] = clips, lens
    before = cuda_resample.launches
    out, glen = prog.run(arrays, lengths)
    torch.cuda.synchronize()
    assert cuda_resample.launches == before + 2 * 2 * 2
    single = compiler.compile_graph(g, sources, device=cuda_device)
    ir = torch.from_numpy(reverb.design_ir(prog.out_rate, 2, 0.25, 4.0, 0.3))
    for b in range(4):
        clip = {k: torch.from_numpy(v[b]).to(cuda_device)
                for k, v in arrays.items()}
        ref, ref_len = dp_sp_tp.reference_pipeline(
            g, sources, clip, {k: v[b] for k, v in lengths.items()},
            prog.cap_master, prog.cap_out, prog.out_rate, device=cuda_device)
        assert glen[b] == ref_len
        master, mlen = single({k: (v, lengths[k][b]) for k, v in clip.items()}
                              )[0]["master"]
        master = mask_tail(master[:, :prog.cap_master], mlen).double()
        exact = (prog.dry * F.pad(master, (0, prog.cap_out - prog.cap_master))
                 + prog.wet * conv64(master, ir, prog.cap_out))
        assert no_worse(exact, out[b], ref), b
