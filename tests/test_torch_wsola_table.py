"""The port's WSOLA score table and its walk against the JAX package, on the
CPU.

``wsola_score_table_plain`` must equal ``pallas_wsola.wsola_score_table``
(run in interpret mode, as tests/test_pallas_wsola.py runs it) once the JAX
table's permuted rows and entries are mapped back to real offsets, on the
geometry and seeds of that file's table tests. Scores are summed in another
order on the two sides, so the inputs must hold no exact float32 tie: on a
tie the port takes the lowest real candidate, the JAX table the first in its
permuted order; each test asserts there is none. The table route's splices
(``splice_offsets_plain``) must equal ``pallas_wsola.splice_offsets`` and a
float64 NumPy chain, as must the serial chain's.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nodey_tpu.ops import pallas_wsola
from nodey_tpu_torch.core.errors import ProcessorRuntimeError
from nodey_tpu_torch.ops import stretch, wsola

RATE = 8_000
SEQ, SEEK, OVERLAP = stretch._params(RATE)
N_CAND = SEEK + 1


def _numpy_chain(x, K, num, den, seq, seek, overlap):
    """The greedy chain in float64 NumPy (tests/test_pallas_wsola.py's
    mirror): the splice offsets only."""
    stride = seq - overlap
    tail = x[:, :overlap].astype(np.float64)
    bests = []
    for k in range(K):
        pos = (k * num + den // 2) // den
        window = x[:, pos : pos + seek + seq].astype(np.float64)
        scores = np.empty(seek + 1)
        for o in range(seek + 1):
            cand = window[:, o : o + overlap]
            scores[o] = (tail * cand).sum() / math.sqrt((cand * cand).sum() + 1e-9)
        best = int(np.argmax(scores))
        tail = window[:, best + stride : best + stride + overlap]
        bests.append(best)
    return np.array(bests, dtype=np.int32)


def _real_table(table):
    """The JAX table [K, rows] (permuted rows and entries) as [K, n_cand] in
    real order: entry [k, a] is the real candidate for real tail row a."""
    a_of_p, p_of_a = pallas_wsola._perm_tables_np(SEEK)
    return a_of_p[np.asarray(table)[:, p_of_a[:N_CAND]]]


def _signal(K, tempo, seed, scale, extra=16):
    num = int(round((SEQ - OVERLAP) * tempo * 65536))
    n = (K * num) // 65536 + SEEK + SEQ + extra
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((2, n))).astype(np.float32), num


def _assert_no_exact_tie(x, K, num):
    scores = wsola.wsola_scores_plain(torch.from_numpy(x), range(K), num,
                                      65536, SEQ, SEEK, OVERLAP)
    top = scores.max(dim=2, keepdim=True).values
    assert ((scores == top).sum(dim=2) == 1).all()


# (K, tempo, seed, scale): test_score_table_shapes_and_masking's case and
# the larger of test_score_table_frames_per_step_bitwise's two (each
# interpret run of the JAX table takes ~3 s).
TABLE_CASES = [(4, 1.1, 1, 0.3), (8, 1.2, 8, 0.3)]


@pytest.mark.parametrize("K,tempo,seed,scale", TABLE_CASES)
def test_plain_table_equals_jax_table(K, tempo, seed, scale):
    x, num = _signal(K, tempo, seed, scale)
    _assert_no_exact_tie(x, K, num)
    want = _real_table(pallas_wsola.wsola_score_table(
        jnp.asarray(x), K, num, 65536, SEQ, SEEK, OVERLAP, interpret=True))
    got = wsola.wsola_score_table_plain(torch.from_numpy(x), K, num, 65536,
                                        SEQ, SEEK, OVERLAP)
    assert got.dtype == torch.int32 and got.shape == (K, N_CAND)
    np.testing.assert_array_equal(got.numpy(), want)
    # Frame 0 scores the head for every row; every entry is a real offset.
    assert (got[0] == got[0, 0]).all()
    assert ((got >= 0) & (got < N_CAND)).all()


# (tempo, K, tight): test_splice_offsets_match_numpy_chain's two tempos and
# test_last_frame_window_not_clipped's input padded only to the last
# frame's window.
SPLICE_CASES = [(1.25, 10, False), (0.8, 10, False), (1.25, 12, True)]


@pytest.mark.parametrize("tempo,K,tight", SPLICE_CASES)
def test_plain_splices_equal_jax_and_numpy_chain(tempo, K, tight):
    num = int(round((SEQ - OVERLAP) * tempo * 65536))
    if tight:
        n = wsola.frame_pos(K - 1, num) + SEEK + SEQ + 2
        x = (0.4 * np.random.default_rng(3).standard_normal((2, n))).astype(
            np.float32)
    else:
        x, num = _signal(K, tempo, 0, 0.4)
    _assert_no_exact_tie(x, K, num)
    want = _numpy_chain(x, K, num, 65536, SEQ, SEEK, OVERLAP)
    jax_bs = np.asarray(pallas_wsola.splice_offsets(
        jnp.asarray(x), K, num, 65536, SEQ, SEEK, OVERLAP, interpret=True))
    xt = torch.from_numpy(x)
    got = wsola.splice_offsets_plain(xt, K, num, 65536, SEQ, SEEK, OVERLAP)
    np.testing.assert_array_equal(jax_bs, want)
    np.testing.assert_array_equal(got.numpy(), want)
    # The serial chain makes the same choices; the CPU dispatchers take the
    # plain versions.
    chain, _ = wsola.wsola_chain_plain(xt, xt[:, :OVERLAP], K, num, 65536,
                                       SEQ, SEEK, OVERLAP)
    assert torch.equal(chain, got)
    assert torch.equal(wsola.splice_offsets(xt, K, num, 65536, SEQ, SEEK,
                                            OVERLAP, frames_per_step=4), got)


def test_walk_follows_the_previous_choice():
    table = torch.tensor([[2, 2, 2], [1, 0, 2], [0, 2, 1], [2, 1, 0]],
                         dtype=torch.int32)
    # b0 = table[0, 0] = 2, then table[1, 2] = 2, table[2, 2] = 1,
    # table[3, 1] = 1.
    assert wsola.walk_table_plain(table).tolist() == [2, 2, 1, 1]
    assert wsola.walk_table(table).tolist() == [2, 2, 1, 1]
    assert wsola.walk_table_plain(table[:0]).shape == (0,)


def test_table_refuses_short_windows_and_other_devices():
    x, num = _signal(6, 1.25, 2, 0.3)
    xt = torch.from_numpy(x)
    need = wsola.frame_pos(5, num) + SEEK + SEQ
    with pytest.raises(ValueError, match="window reads"):
        wsola.wsola_score_table_plain(xt[:, : need - 1], 6, num, 65536, SEQ,
                                      SEEK, OVERLAP)
    with pytest.raises(ValueError, match="frames_per_step"):
        wsola.wsola_score_table(xt, 6, num, 65536, SEQ, SEEK, OVERLAP,
                                frames_per_step=0)
    meta = torch.empty((2, x.shape[1]), device="meta")
    with pytest.raises(ProcessorRuntimeError):
        wsola.wsola_score_table(meta, 6, num, 65536, SEQ, SEEK, OVERLAP)
    with pytest.raises(ProcessorRuntimeError):
        wsola.walk_table(torch.empty((6, N_CAND), dtype=torch.int32,
                                     device="meta"))
