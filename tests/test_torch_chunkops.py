"""The port's chunk ops (``nodey_tpu_torch.ops.chunkops``) against the JAX
package's (``nodey_tpu.ops.chunkops``) on the CPU, chunk by chunk.

Both sides get the same blocks, made with numpy from a seed, and the same
(n, done) per step; the port's counts are host ints, the JAX package's
traced int32. Bars:
- FIFOs: bitwise (pure copies).
- Resample steps: the same out_n and done on every step, samples within
  3e-7 (the JAX package's own streamed-vs-offline bar: the grouped GEMM may
  associate its sums otherwise at another batch geometry).
- STFT steps: the same frame counts, frames >= 100 dB from the JAX step's
  (the port's spectrum bar).
- WSOLA steps: the same out_n on every step as the JAX step on the CPU (its
  conv scan), samples within 2e-6.
- The chunk chain: ``wsola_chunk_chain_plain`` against
  ``pallas_wsola.wsola_chunk_chain_pallas`` in interpret mode for a nonzero
  k0 and base and a carried head: equal splices, body within 2e-6 (the
  kernel may contract the blend into FMAs), and the returned tail equal to
  the window the last splice selects.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nodey_tpu.ops import chunkops as jchunkops
from nodey_tpu.ops import pallas_wsola
from nodey_tpu_torch.ops import chunkops, stretch, wsola

from conftest import snr_db


def _signal(seed, channels, n_total):
    """Tones plus noise, float32 [channels, n_total]."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_total) / 8_000.0
    return np.stack([0.4 * np.sin(2 * np.pi * (230.0 + 70 * c) * t)
                     + 0.05 * rng.standard_normal(n_total)
                     for c in range(channels)]).astype(np.float32)


def _blocks(data, chunk):
    """(block [C, chunk] zero-padded, n, last) pushes covering ``data``,
    then empty pushes for ever."""
    channels, n_total = data.shape
    pos = 0
    while True:
        n = min(chunk, n_total - pos)
        block = np.zeros((channels, chunk), dtype=np.float32)
        block[:, :n] = data[:, pos : pos + n]
        pos += n
        yield block, n, pos >= n_total


def _drive(port_step, port_state, jax_step, jax_state, blocks, max_steps):
    """Run both steps on the same pushes until both are done; returns the
    per-step (port out_n, jax out_n) and the two concatenated outputs."""
    counts, port_parts, jax_parts = [], [], []
    for step, (block, n, last) in enumerate(blocks):
        assert step < max_steps, "streaming stalled"
        port_state, out, out_n, done = port_step(
            port_state, torch.from_numpy(block), n, last)
        jax_state, jout, jn, jdone = jax_step(
            jax_state, jnp.asarray(block), jnp.int32(n), jnp.bool_(last))
        jn = int(jn)
        assert isinstance(out_n, int) and isinstance(done, bool)
        counts.append((out_n, jn))
        assert done == bool(jdone)
        # Audio [C, width] or spectrum frames [C, frames, bins]: the valid
        # part is the first out_n along axis 1 either way.
        port_parts.append(out.numpy()[:, :out_n])
        jax_parts.append(np.asarray(jout)[:, :jn])
        if done:
            break
    return counts, port_parts, jax_parts


# -- FIFOs -------------------------------------------------------------------


@pytest.mark.parametrize("ops", [
    [("push", 7), ("advance", 3), ("push", 9), ("advance", 13)],
    [("prefill", 5), ("push", 10), ("advance", 4), ("advance", 40),
     ("push", 10), ("push", 10)],
])
def test_fifo_ops_equal_the_jax_package(ops):
    rng = np.random.default_rng(len(ops))
    cap = 40
    state, jstate = chunkops.fifo_init(2, cap, "cpu"), jchunkops.fifo_init(2, cap)
    for op, arg in ops:
        if op == "prefill":
            state = chunkops.fifo_prefill(2, cap, arg, "cpu")
            jstate = jchunkops.fifo_prefill(2, cap, arg)
        elif op == "push":
            data = rng.standard_normal((2, 10)).astype(np.float32)
            state = chunkops.fifo_push(state, torch.from_numpy(data), arg)
            jstate = jchunkops.fifo_push(jstate, jnp.asarray(data), arg)
        else:
            state = chunkops.fifo_advance(state, arg)
            jstate = jchunkops.fifo_advance(jstate, jnp.int32(arg))
        assert state.level == int(jchunkops.fifo_level(jstate))
        np.testing.assert_array_equal(state.buf.numpy(), np.asarray(jstate.buf))
        np.testing.assert_array_equal(
            chunkops.fifo_window(state, 12).numpy(),
            np.asarray(jchunkops.fifo_window(jstate, 12)))


# -- resampler -----------------------------------------------------------------


@pytest.mark.parametrize("in_rate,out_rate,chunk,n_total", [
    (44_100, 48_000, 11_025, 40_000),     # the grouped R = 4 pair
    (22_050, 48_000, 5_513, 19_000),      # R = 2
    (48_000, 44_100, 12_000, 30_000),     # a downsample
    (44_100, 48_000, 4_410, 4_410 * 3 + 123),  # a partial final group
])
def test_resample_stream_step_equals_the_jax_step(in_rate, out_rate, chunk,
                                                  n_total):
    plan = chunkops.resample_plan(in_rate, out_rate, chunk, "cpu")
    jplan = jchunkops.resample_plan(in_rate, out_rate, chunk)
    for field in ("L", "M", "taps", "left_ctx", "right_ctx", "take_cap",
                  "cap", "out_cap", "quant"):
        assert getattr(plan, field) == getattr(jplan, field), field
    counts, got, want = _drive(
        functools.partial(chunkops.resample_stream_step, plan),
        chunkops.resample_stream_init(plan, 2, "cpu"),
        jax.jit(functools.partial(jchunkops.resample_stream_step, jplan)),
        jchunkops.resample_stream_init(jplan, 2),
        _blocks(_signal(in_rate, 2, n_total), chunk),
        max_steps=n_total // chunk + 6)
    assert all(a == b for a, b in counts), counts
    assert len(counts) >= 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=3e-7)
    total = sum(a for a, _ in counts)
    L, M = plan.L, plan.M
    assert total == (n_total // M) * L + ((n_total % M) * L + M - 1) // M


# -- STFT ----------------------------------------------------------------------


def test_stft_stream_step_frames_equal_the_jax_step():
    plan = chunkops.stft_plan(1024, 512, 6_000)
    jplan = jchunkops.stft_plan(1024, 512, 6_000)
    assert tuple(plan) == tuple(jplan)
    counts, got, want = _drive(
        functools.partial(chunkops.stft_stream_step, plan),
        chunkops.stft_stream_init(plan, 2, "cpu"),
        jax.jit(functools.partial(jchunkops.stft_stream_step, jplan)),
        jchunkops.stft_stream_init(jplan, 2),
        _blocks(_signal(3, 2, 25_000), 6_000), max_steps=10)
    assert all(a == b for a, b in counts) and sum(a for a, _ in counts) == 47
    got, want = np.concatenate(got, axis=1), np.concatenate(want, axis=1)
    assert got.shape == want.shape == (2, 47, 513)
    assert snr_db(want, got) >= 100.0


# -- WSOLA ---------------------------------------------------------------------


@pytest.mark.parametrize("rate,tempo,chunk,n_total", [
    (8_000, 1.25, 2_000, 9_000),
    (8_000, 0.8, 1_500, 7_000),
    (48_000, 1.25, 12_000, 33_000),
])
def test_wsola_stream_step_equals_the_jax_step(monkeypatch, rate, tempo, chunk,
                                               n_total):
    monkeypatch.setenv("NODEY_WSOLA_CHUNK_FORCE", "scan")
    plan = chunkops.wsola_plan(tempo, rate, chunk)
    jplan = jchunkops.wsola_plan(tempo, rate, chunk)
    for field in ("seq", "seek", "overlap", "stride_out", "num", "num_t",
                  "den", "push_cap", "k_cap", "out_cap"):
        assert getattr(plan, field) == getattr(jplan, field), field
    data = _signal(rate + 1, 2, n_total)
    counts, got, want = _drive(
        functools.partial(chunkops.wsola_stream_step, plan),
        chunkops.wsola_stream_init(plan, 2, "cpu"),
        jax.jit(functools.partial(jchunkops.wsola_stream_step, jplan)),
        jchunkops.wsola_stream_init(jplan, 2),
        _blocks(data, chunk), max_steps=n_total // chunk + 12)
    assert all(a == b for a, b in counts), counts
    assert sum(1 for a, _ in counts if a) >= 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-6)
    # Streamed == the port's offline stretch of the whole clip.
    off, off_n = stretch.wsola_stretch_at_rate(torch.from_numpy(data),
                                               n_total, tempo, rate)
    streamed = np.concatenate(got, axis=1)
    assert streamed.shape[1] == off_n
    np.testing.assert_allclose(streamed, off.numpy()[:, :off_n], rtol=0,
                               atol=2e-6)


@pytest.mark.parametrize("rate,tempo,k0,K", [
    (8_000, 1.25, 7, 12),
    (8_000, 0.8, 31, 20),
    (48_000, 0.7937005259840998, 5, 6),
])
def test_chunk_chain_plain_equals_the_pallas_chunk_entry(rate, tempo, k0, K):
    seq, seek, overlap = stretch._params(rate)
    stride = seq - overlap
    num, den = int(round(stride * tempo * 65536)), 65536
    base = wsola.frame_pos(k0, num) - 9     # column 0 is input sample `base`
    width = (wsola.frame_pos(k0 + K - 1, num) - base + seek + seq
             + pallas_wsola.chunk_window_extra(seq, seek, overlap) + 256)
    rng = np.random.default_rng(K)
    t = np.arange(width) / rate
    x = np.stack([0.4 * np.sin(2 * np.pi * 310.0 * t),
                  0.3 * np.sin(2 * np.pi * 187.0 * t + 1.0)])
    x = (x + 0.05 * rng.standard_normal(x.shape)).astype(np.float32)
    head = (0.3 * rng.standard_normal((2, overlap))).astype(np.float32)

    head_k = np.zeros((2, stride), dtype=np.float32)
    head_k[:, :overlap] = head
    jbs, jbody = pallas_wsola.wsola_chunk_chain_pallas(
        jnp.asarray(x), jnp.asarray(head_k), k0, base, K, num, den, seq,
        seek, overlap, interpret=True)
    bs, body, tail = wsola.wsola_chunk_chain_plain(
        torch.from_numpy(x), torch.from_numpy(head), k0, base, K, num, den,
        seq, seek, overlap)
    assert bs.dtype == torch.int32
    np.testing.assert_array_equal(bs.numpy(), np.asarray(jbs))
    jbody = np.asarray(jbody).reshape(2, K * stride)
    np.testing.assert_allclose(body.numpy(), jbody, rtol=0, atol=2e-6)
    last = wsola.frame_pos(k0 + K - 1, num) - base + int(bs[-1]) + stride
    np.testing.assert_array_equal(tail.numpy(), x[:, last : last + overlap])
    # The dispatcher sends a CPU tensor to the plain version; K = 0 keeps
    # the carried head.
    got = wsola.wsola_chunk_chain(torch.from_numpy(x), torch.from_numpy(head),
                                  k0, base, 0, num, den, seq, seek, overlap)
    assert got[0].numel() == 0 and torch.equal(got[2], torch.from_numpy(head))


def test_chunk_chain_refuses_a_window_outside_x():
    seq, seek, overlap = stretch._params(8_000)
    num = int(round((seq - overlap) * 1.25 * 65536))
    x = torch.zeros((2, 2_000))
    head = torch.zeros((2, overlap))
    with pytest.raises(ValueError, match="window reads"):
        wsola.wsola_chunk_chain(x, head, 3, 0, 10, num, 65536, seq, seek,
                                overlap)
    with pytest.raises(ValueError, match="window reads"):
        wsola.wsola_chunk_chain(x, head, 3, wsola.frame_pos(3, num) + 1, 1,
                                num, 65536, seq, seek, overlap)


def test_stft_stream_step_takes_rfft_above_4096(monkeypatch):
    """The streamed spectrum step goes through magnitude_spectrogram, so at
    n_fft 8,192 it takes the rfft branch too: no basis at plan time or in a
    step, and the frames of the JAX step (>= 100 dB)."""
    def no_basis(n_fft, device):
        raise AssertionError("the rfft branch built the DFT basis")

    monkeypatch.setattr(chunkops.stft_ops, "_device_basis", no_basis)
    plan = chunkops.stft_plan(8192, 2048, 6_000)
    jplan = jchunkops.stft_plan(8192, 2048, 6_000)
    counts, got, want = _drive(
        functools.partial(chunkops.stft_stream_step, plan),
        chunkops.stft_stream_init(plan, 2, "cpu"),
        jax.jit(functools.partial(jchunkops.stft_stream_step, jplan)),
        jchunkops.stft_stream_init(jplan, 2),
        _blocks(_signal(4, 2, 25_000), 6_000), max_steps=10)
    assert all(a == b for a, b in counts)
    got, want = np.concatenate(got, axis=1), np.concatenate(want, axis=1)
    assert got.shape == want.shape == (2, (25_000 - 8192) // 2048 + 1, 4097)
    assert snr_db(want, got) >= 100.0
