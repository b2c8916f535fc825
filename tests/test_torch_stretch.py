"""The port's WSOLA chain and stretch ops against the JAX package, on the CPU.

The plain chain (``wsola.wsola_chain_plain``) must make the frozen splice
decisions of ``tests/goldens/wsola.npz`` bitwise and those of a float64
NumPy mirror; the port's ``wsola_stretch_at_rate`` must match the JAX
package's within 1.2e-7 (the goldens' bar: scores are summed in another
order, the decisions are equal, the blend differs by a rounding), and
``transpose_rate`` within 2e-6 (the resampler's bar).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from make_wsola_goldens import CASES, case_signal
from nodey_tpu.ops import pallas_wsola
from nodey_tpu.ops import stretch as jstretch
from nodey_tpu_torch.core.errors import ProcessorRuntimeError
from nodey_tpu_torch.core.stream import Stream
from nodey_tpu_torch.ops import stretch, wsola

GOLDEN_TOL = 1.2e-7


def _geometry(n, tempo, rate):
    seq, seek, overlap = stretch._params(rate)
    K = stretch._out_chunks(n, tempo, seq, overlap)
    num = int(round((seq - overlap) * tempo * 65536))
    return seq, seek, overlap, K, num


def _padded(data, K, num, seq, seek):
    pad_to = wsola.frame_pos(K - 1, num) + seek + seq + 2
    return F.pad(torch.from_numpy(data), (0, max(0, pad_to - data.shape[1])))


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


@pytest.mark.parametrize("rate,tempo", CASES)
def test_plain_chain_matches_goldens(rate, tempo):
    blobs = np.load("tests/goldens/wsola.npz")
    key = f"{rate}_{tempo}"
    data = case_signal(rate)
    n = data.shape[1]
    seq, seek, overlap, K, num = _geometry(n, tempo, rate)
    x = _padded(data, K, num, seq, seek)
    bs, body = wsola.wsola_chain_plain(x, x[:, :overlap], K, num, 65536, seq,
                                       seek, overlap)
    assert bs.dtype == torch.int32 and body.shape == (2, K * (seq - overlap))
    np.testing.assert_array_equal(bs.numpy(), blobs[f"{key}_bs"])

    out, length = stretch.wsola_stretch_at_rate(torch.from_numpy(data), n,
                                                tempo, rate)
    assert length == int(blobs[f"{key}_len"])
    head = blobs[f"{key}_head"]
    np.testing.assert_allclose(out[:, : head.shape[1]].numpy(), head, rtol=0,
                               atol=GOLDEN_TOL)


@pytest.mark.parametrize("tempo", [1.25, 0.8])
def test_plain_chain_matches_numpy_chain(tempo):
    rate = 8_000
    seq, seek, overlap = stretch._params(rate)
    num = int(round((seq - overlap) * tempo * 65536))
    K = 10
    n = (K * num) // 65536 + seek + seq + 16
    x = (0.4 * np.random.default_rng(0).standard_normal((2, n))).astype(np.float32)
    want = _numpy_chain(x, K, num, 65536, seq, seek, overlap)
    xt = torch.from_numpy(x)
    bs, _ = wsola.wsola_chain_plain(xt, xt[:, :overlap], K, num, 65536, seq,
                                    seek, overlap)
    np.testing.assert_array_equal(bs.numpy(), want)


@pytest.mark.parametrize("tempo,rate,K", [(1.25, 8_000, 14), (0.8, 44_100, 6)])
def test_plain_chain_matches_pallas_kernel(tempo, rate, K):
    """The TPU kernel this chain replaces, in interpret mode: equal
    decisions; emitted audio within the goldens' bar."""
    seq, seek, overlap = stretch._params(rate)
    num = int(round((seq - overlap) * tempo * 65536))
    n = wsola.frame_pos(K - 1, num) + seek + seq + 2
    x = (0.4 * np.random.default_rng(9).standard_normal((2, n))).astype(np.float32)
    jbs, jbody = pallas_wsola.wsola_chain_assemble_pallas(
        jnp.asarray(x), K, num, 65536, seq, seek, overlap, interpret=True)
    xt = torch.from_numpy(x)
    bs, body = wsola.wsola_chain_plain(xt, xt[:, :overlap], K, num, 65536,
                                       seq, seek, overlap)
    np.testing.assert_array_equal(bs.numpy(), np.asarray(jbs))
    np.testing.assert_allclose(body.numpy(), np.asarray(jbody), rtol=0,
                               atol=GOLDEN_TOL)


def test_replay_and_assembly_agree_with_the_chain():
    """Given the chain's own decisions, the replay picks them again and
    the assembly emits the chain's audio bitwise: what chip_smoke.py holds
    the kernel to."""
    rate, tempo = 8_000, 1.1
    seq, seek, overlap = stretch._params(rate)
    num = int(round((seq - overlap) * tempo * 65536))
    K = 12
    n = wsola.frame_pos(K - 1, num) + seek + seq
    x = torch.from_numpy(
        (0.3 * np.random.default_rng(5).standard_normal((1, n))).astype(np.float32))
    head = x[:, :overlap]
    bs, body = wsola.wsola_chain_plain(x, head, K, num, 65536, seq, seek, overlap)
    replay = wsola.replay_decisions(x, head, bs, K, num, 65536, seq, seek,
                                    overlap)
    np.testing.assert_array_equal(replay.numpy(), bs.numpy())
    assert torch.equal(
        wsola.assemble_plain(x, head, bs, K, num, 65536, seq, seek, overlap),
        body)
    with pytest.raises(ValueError, match="window reads"):
        wsola.wsola_chain_plain(x[:, :-1], head, K, num, 65536, seq, seek,
                                overlap)


@pytest.mark.parametrize("rate,tempo,seconds", [(48_000, 1.25, 1.2),
                                                (44_100, 0.8, 1.2),
                                                (22_050, 1.7, 3.5)])
def test_stretch_matches_jax(rate, tempo, seconds):
    """The 3.5 s case has K >= 64 frames, where the JAX package's CPU path
    switches from its scan to its blocked formulation."""
    rng = np.random.default_rng(11)
    n = int(rate * seconds)
    t = np.arange(n) / rate
    data = np.stack([0.4 * np.sin(2 * np.pi * 330.0 * t),
                     0.2 * rng.standard_normal(n)]).astype(np.float32)
    length = n - 1000  # a valid length below the buffer width
    jout, jlen = jstretch.wsola_stretch_at_rate(jnp.asarray(data),
                                                jnp.int32(length), tempo, rate)
    out, out_len = stretch.wsola_stretch_at_rate(torch.from_numpy(data),
                                                 length, tempo, rate)
    assert out_len == int(jlen)
    assert out.shape == jout.shape
    assert not out[:, out_len:].any()
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=GOLDEN_TOL)


@pytest.mark.parametrize("semitones", [4.0, -4.0])
def test_transpose_rate_matches_jax(semitones):
    factor = 2.0 ** (semitones / 12.0)
    data = (0.5 * np.random.default_rng(2).standard_normal((2, 30_001))).astype(
        np.float32)
    length = 29_000
    jout, jlen = jstretch.transpose_rate(jnp.asarray(data), jnp.int32(length),
                                         factor)
    out, out_len = stretch.transpose_rate(torch.from_numpy(data), length, factor)
    assert stretch._rational_factor(factor) == jstretch._rational_factor(factor)
    assert out_len == int(jlen) and out.shape == jout.shape
    assert np.abs(out.numpy() - np.asarray(jout)).max() <= 2e-6


def test_positions_and_lengths_match_jax_at_large_k():
    for tempo in (0.7937005259840998, 1.25, 2.0, 0.5):
        num = int(round(1536 * tempo * 65536))
        for k in (0, 1, 255, 256, 7_506, 11_819, 400_000):
            assert wsola.frame_pos(k, num) == int(
                jstretch.frame_pos(jnp.int32(k), num))
        tnum = int(round(tempo * 65536))
        for length in (14_400_000, 18_142_848, 2**24 + 12_345, 500_000_000):
            assert stretch.scale_length_by_num(length, tnum) == int(
                jstretch.scale_length_by_num(jnp.int32(length), tnum))


def test_phase_vocoder_raises_and_does_not_fall_back():
    data = torch.zeros((2, 4_000))
    stream = Stream(data=data, length=4_000, rate=8_000, channels=2)
    with pytest.raises(ProcessorRuntimeError, match="Phase vocoder") as info:
        stretch.soundtouch_like(None, stream, rate=1.0, pitch=1.2,
                                algorithm="pv")
    assert info.value.explanation and info.value.detail
    # Without a tempo stage there is nothing for the PV to do: transpose only.
    out = stretch.soundtouch_like(None, stream, rate=1.25, pitch=1.0,
                                  algorithm="pv")
    assert out.length == 3_200


def test_chain_dispatch_takes_the_plain_version_on_the_cpu():
    x = torch.from_numpy(
        (0.3 * np.random.default_rng(1).standard_normal((2, 2_000))).astype(
            np.float32))
    args = (x, x[:, :64], 3, 5 * 256 * 65536 // 4, 65536, 320, 120, 64)
    got = wsola.wsola_chain(*args)
    want = wsola.wsola_chain_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
