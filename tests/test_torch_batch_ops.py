"""The batched plain twins of the kernels that batched serving runs, the
CLI's export progress and the bounded WAV reader, on the CPU.

Kernel twins (each takes the batched operands the kernel takes), against
the JAX op on the same numpy-seeded inputs, at the bars of the port's
single-clip tests of those ops:
- the resampler (kernel 1), ``apply_filter_bank_plain`` and
  ``resample_data`` on [B, C, N]: within 2e-6 of the JAX op under
  ``jax.vmap`` (tests/test_torch_resample.py), and each clip bitwise its own
  single-clip result;
- the WSOLA chain (kernel 4) on [B, C, N]: each clip's splices equal to
  the Pallas chain kernel's in interpret mode under ``jax.vmap`` (its
  ``lax.map`` over clips), the audio within 1.2e-7
  (tests/test_torch_stretch.py); its energy prologue (4c, no Pallas kernel
  of its own) within rtol 2e-6 of float64 sums, clip by clip;
- the PV lock (kernel 5) on [B*C, K, bins] folded planes: within 2e-6 of
  the Pallas lock in interpret mode under ``jax.vmap``
  (tests/test_torch_pv.py);
- the PV phase path (kernel 6) on folded planes: >= 100 dB on both
  synthesis planes against the Pallas kernel in interpret mode, clip by
  clip (tests/test_torch_pv.py).

``run --export`` prints ``  encoded N s`` progress to stderr at most once
per second of audio (the JAX CLI's line, ``nodey_tpu/app/cli.py``), offline
and streamed.

``WavBlockReader``: its blocks concatenate bitwise to the whole-clip read
(s16, s32, float32, a ragged last block); a streamed export without the
codec runtime reads the WAV through it and writes the same bytes as the
whole-clip read did; and it holds about one block of samples at a time
(tracemalloc).
"""

import contextlib
import functools
import io
import json
import re
import tracemalloc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import snr_db
from nodey_tpu.ops import pallas_wsola
from nodey_tpu.ops import resample as jr
from nodey_tpu.ops.pallas_lock import lock_to_peaks_pallas
from nodey_tpu.ops.pallas_phase import phase_path_pallas
from nodey_tpu_torch.app import cli
from nodey_tpu_torch.core import stream_executor
from nodey_tpu_torch.core.graph import Graph
from nodey_tpu_torch.core.runner import Runner
from nodey_tpu_torch.host import decode as host_decode
from nodey_tpu_torch.ops import pv, stretch, wsola
from nodey_tpu_torch.ops import resample as tr
from nodey_tpu_torch.processors.audio_input import AudioInput
from nodey_tpu_torch.processors.audio_output import AudioOutput
from nodey_tpu_torch.processors.audio_vol import AudioVol
from test_torch_batch import one_torch_thread  # noqa: F401  (autouse)

TOL = 2e-6
CHAIN_TOL = 1.2e-7
PLANE_DB = 100.0
B = 3


def _signals(shape, seed):
    rng = np.random.default_rng(seed)
    return (0.5 * rng.standard_normal(shape)).clip(-1.5, 1.5).astype(
        np.float32)


# -- kernel 1: the resampler -------------------------------------------------


def test_batched_resampler_and_wsola_twins_match_jax():
    for in_rate, out_rate in ((44_100, 48_000), (635, 504), (48_000, 44_100)):
        _check_resampler(in_rate, out_rate)
    for tempo, rate, K in ((1.25, 8_000, 14), (0.8, 44_100, 6)):
        _check_chain(tempo, rate, K)
    _check_energy()
    _check_stretch_lengths()


def _check_resampler(in_rate, out_rate):
    data = torch.from_numpy(_signals((B, 2, 9_000), in_rate))
    x, G, M, W, bank, _ = tr.bank_operands(data, in_rate, out_rate)
    got = tr.apply_filter_bank_plain(x, G, M, W, bank)
    assert got.shape == (B, 2, G * bank.shape[0])
    for b in range(B):
        assert torch.equal(got[b], tr.apply_filter_bank_plain(x[b], G, M, W,
                                                              bank))
    want = jax.vmap(lambda xb: jr.apply_filter_bank(
        xb, G, M, W, jnp.asarray(bank.numpy())))(jnp.asarray(x.numpy()))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL
    # The dispatch and resample_data take the batch the same way.
    assert torch.equal(tr.apply_filter_bank(x, G, M, W, bank, None), got)
    out = tr.resample_data(data, in_rate, out_rate)
    jout = jax.vmap(functools.partial(jr.resample_data, in_rate=in_rate,
                                      out_rate=out_rate))(
        jnp.asarray(data.numpy()))
    assert out.shape == jout.shape
    assert np.abs(out.numpy() - np.asarray(jout)).max() <= TOL


# -- kernels 4 and 4c: the WSOLA chain and its energy prologue ---------------


def _check_chain(tempo, rate, K):
    seq, seek, overlap = stretch._params(rate)
    num = int(round((seq - overlap) * tempo * 65536))
    n = wsola.frame_pos(K - 1, num) + seek + seq + 2
    x = torch.from_numpy(_signals((B, 2, n), rate))
    bs, body = wsola.wsola_chain_plain(x, x[..., :overlap], K, num, 65536,
                                       seq, seek, overlap)
    assert bs.shape == (B, K) and body.shape == (B, 2, K * (seq - overlap))
    jbs, jbody = jax.vmap(lambda xb: pallas_wsola.wsola_chain_assemble_pallas(
        xb, K, num, 65536, seq, seek, overlap, interpret=True))(
        jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(bs.numpy(), np.asarray(jbs))
    np.testing.assert_allclose(body.numpy(), np.asarray(jbody), rtol=0,
                               atol=CHAIN_TOL)
    # Clip b is the single-clip chain of clip b, bitwise.
    for b in range(B):
        one = wsola.wsola_chain_plain(x[b], x[b, :, :overlap], K, num, 65536,
                                      seq, seek, overlap)
        assert torch.equal(one[0], bs[b]) and torch.equal(one[1], body[b])
    # So is the dispatch on the CPU.
    got = wsola.wsola_chain(x, x[..., :overlap], K, num, 65536, seq, seek,
                            overlap)
    assert torch.equal(got[0], bs) and torch.equal(got[1], body)


def _check_energy():
    rate, tempo, k0, K = 8_000, 1.25, 2, 7
    seq, seek, overlap = stretch._params(rate)
    num = int(round((seq - overlap) * tempo * 65536))
    n = wsola.frame_pos(k0 + K - 1, num) + seek + seq
    x = _signals((B, 2, n), 7)
    got = wsola.wsola_energy_plain(torch.from_numpy(x), k0, 0, K, num, 65536,
                                   seq, seek, overlap).numpy()
    assert got.shape == (B, K, seek + 1)
    x64 = x.astype(np.float64)
    for b in range(B):
        for i in range(K):
            pos = wsola.frame_pos(k0 + i, num)
            cand = x64[b, :, pos : pos + seek + overlap] ** 2
            win = np.lib.stride_tricks.sliding_window_view(cand, overlap,
                                                           axis=1)
            want = 1.0 / np.sqrt(win.sum(axis=(0, 2)) + 1e-9)
            np.testing.assert_allclose(got[b, i], want, rtol=2e-6, atol=0)


def _check_stretch_lengths():
    """The stage's lengths and zero tails are per clip; the audio is each
    clip's own stretch."""
    rate, tempo = 8_000, 1.25
    data = torch.from_numpy(_signals((B, 2, 4_000), 3))
    lengths = (4_000, 2_800, 1_300)
    for b, n in enumerate(lengths):
        data[b, :, n:] = 0.0
    out, out_len = stretch.wsola_stretch_at_rate(data, lengths, tempo, rate)
    for b, n in enumerate(lengths):
        one, one_len = stretch.wsola_stretch_at_rate(data[b], n, tempo, rate)
        assert out_len[b] == one_len == n * 65536 // round(tempo * 65536)
        assert torch.equal(out[b], one)
        assert not out[b, :, one_len:].any()


# -- kernels 5 and 6: the PV lock and phase path -----------------------------


def _lock_planes(C, K, bins, seed):
    """Unit phasors, phases and smooth magnitudes (tests/test_torch_pv.py)."""
    rng = np.random.default_rng(seed)
    phi = rng.uniform(-np.pi, np.pi, (C, K, bins)).astype(np.float32)
    ph_in = rng.uniform(-np.pi, np.pi, (C, K, bins)).astype(np.float32)
    mag = np.abs(np.cumsum(rng.standard_normal((C, K, bins)), axis=-1)).astype(
        np.float32)
    return np.cos(phi), np.sin(phi), ph_in, mag


def test_batched_pv_twins_match_jax():
    _check_lock()
    for lock in (True, False):
        _check_phase_path(lock)


def _check_lock():
    planes = [np.stack(p) for p in zip(*(_lock_planes(2, 19, 1025, seed)
                                          for seed in range(B)))]
    got = pv._lock_to_peaks(*(torch.from_numpy(p).reshape(B * 2, 19, 1025)
                              for p in planes))
    want = jax.vmap(functools.partial(lock_to_peaks_pallas, interpret=True))(
        *(jnp.asarray(p) for p in planes))
    for g, w in zip(got, want):
        g = g.reshape(B, 2, 19, 1025).numpy()
        assert np.abs(g - np.asarray(w)).max() <= TOL


def _check_phase_path(lock):
    rate, tempo = 8_000, 0.8
    data = _signals((B, 2, 6_000), 11)
    n_fft, hop, pos, dpos, pad_to = pv._pv_geometry(6_000, tempo, rate)
    planes = [pv._analysis(torch.from_numpy(clip), pos, pad_to, n_fft)
              for clip in data]
    K, bins = planes[0][0].shape[1:]
    re = torch.stack([p[0] for p in planes]).reshape(B * 2, K, bins)
    im = torch.stack([p[1] for p in planes]).reshape(B * 2, K, bins)
    got = [g.reshape(B, 2, K, bins)
           for g in pv.phase_path_plain(re, im, dpos, hop, n_fft, lock)]
    for b, (cre, cim) in enumerate(planes):
        want = phase_path_pallas(jnp.asarray(cre.numpy()),
                                 jnp.asarray(cim.numpy()), dpos, hop, n_fft,
                                 lock=lock, interpret=True)
        for g, w in zip(got, want):
            assert snr_db(np.asarray(w).ravel()[None],
                          g[b].numpy().ravel()[None]) >= PLANE_DB


# -- run --export progress ---------------------------------------------------


def _project(tmp_path, seconds=20, rate=8_000):
    """input (one mono track) -> volume 0.5 -> output, as a project file."""
    path = str(tmp_path / "track.wav")
    host_decode.write_wav_s16(path, _signals((1, seconds * rate), 5) * 0.5,
                              rate)
    g = Graph()
    src = g.add_node(AudioInput())
    g.nodes[src].processor.file_paths = [path]
    g.update_node_pin(src)
    vol = g.add_node(AudioVol())
    g.nodes[vol].processor.set_volume(0.5)
    out = g.add_node(AudioOutput())
    g.add_link(g.nodes[src].pin_name_map["output_0"],
               g.nodes[vol].pin_name_map["input"])
    g.add_link(g.nodes[vol].pin_name_map["output"],
               g.nodes[out].pin_name_map["input"])
    project = tmp_path / "project.json"
    project.write_text(json.dumps(g.serialize()))
    return str(project), path


def test_run_export_prints_encode_progress(tmp_path, capsys):
    """Offline (4 s blocks) and streamed (16 s chunks) exports of 20 s."""
    project, _ = _project(tmp_path)
    out = str(tmp_path / "out.wav")
    argv = ["run", project, "--export", out, "--device", "cpu"]
    for flags, want in (([], [4.0, 8.0, 12.0, 16.0, 20.0]),
                        (["--stream"], [16.0, 20.0])):
        capsys.readouterr()
        assert cli.main(argv + flags) == 0
        lines = capsys.readouterr().err.splitlines()
        progress = [line for line in lines if "encoded" in line]
        # The JAX CLI's line: f"  encoded {seconds:8.1f} s".
        assert progress == [f"  encoded {s:8.1f} s" for s in want]
        assert all(re.fullmatch(r"  encoded [ \d]{6}\.\d s", line)
                   for line in progress)

    progress = cli._encode_progress()
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        for seconds in (0.4, 0.9, 1.0, 1.5, 2.2, 2.9, 3.2):
            progress(seconds)
    assert err.getvalue().splitlines() == [
        "  encoded      1.0 s", "  encoded      2.2 s", "  encoded      3.2 s"]


# -- the bounded WAV reader --------------------------------------------------


def _wav(tmp_path, fmt, frames=10_001, channels=2, rate=8_000):
    """A WAV of ``fmt`` ("s16", "s32", "flt"), written by the port's
    writers (s32 by hand: the header of write_wav_s16 with 32 bits)."""
    data = _signals((channels, frames), 21) * 0.6
    path = str(tmp_path / f"clip_{fmt}.wav")
    if fmt == "s16":
        host_decode.write_wav_s16(path, data, rate)
    elif fmt == "flt":
        host_decode.write_wav(path, data, rate)
    else:
        ints = np.round(data.T.astype(np.float64) * 2**31).clip(
            -2**31, 2**31 - 1).astype("<i4")
        payload = np.ascontiguousarray(ints).tobytes()
        with open(path, "wb") as f:
            f.write(host_decode._wav_header(channels, rate, 1, 4, len(payload))
                    + payload)
    return path


def test_wav_block_reader(tmp_path, monkeypatch):
    for fmt in ("s16", "s32", "flt"):
        _check_blocks(tmp_path, fmt)
    _no_runtime(monkeypatch)
    _check_streamed_export(tmp_path, monkeypatch)
    _check_source_feed(tmp_path)
    _check_not_a_wav(tmp_path)


def _check_blocks(tmp_path, fmt):
    path = _wav(tmp_path, fmt)
    whole, rate, whole_fmt = _whole_read(path)
    assert whole_fmt == fmt and whole.shape == (2, 10_001)
    decoded = host_decode._decode_wav_python(path)
    assert (decoded.rate, decoded.fmt) == (rate, fmt)
    np.testing.assert_array_equal(decoded.data, whole)
    for block in (1, 999, 4_096, 20_000):
        with host_decode.WavBlockReader(path) as reader:
            assert (reader.rate, reader.channels, reader.fmt) == (rate, 2, fmt)
            blocks = list(reader.blocks(block))
        assert all(b.shape[1] == block for b in blocks[:-1])
        np.testing.assert_array_equal(np.concatenate(blocks, axis=1), whole)


def _no_runtime(monkeypatch):
    """The card machine's case: no codec runtime, no StreamDecoder."""
    def no_stream_decoder(path):
        raise host_decode.ProcessorRuntimeError("x", "y", "z")

    monkeypatch.setattr(host_decode, "StreamDecoder", no_stream_decoder)
    monkeypatch.setattr(host_decode, "load_native", lambda: None)


def _whole_read(path):
    """The Python WAV reader as it read a clip before the block reader
    (the whole file at once): ``(planar float32 data, rate, fmt)``."""
    import struct

    with open(path, "rb") as f:
        blob = f.read()
    pos, fmt_chunk, data_chunk = 12, None, None
    while pos + 8 <= len(blob):
        cid, size = blob[pos : pos + 4], struct.unpack_from("<I", blob,
                                                          pos + 4)[0]
        body = blob[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt_chunk = body
        elif cid == b"data":
            data_chunk = body
        pos += 8 + size + (size & 1)
    audio_fmt, channels, rate, _, _, bits = struct.unpack_from(
        "<HHIIHH", fmt_chunk, 0)
    if audio_fmt == 1 and bits == 16:
        raw = np.frombuffer(data_chunk, dtype="<i2")
        data = raw.astype(np.float32) / 32768.0
        fmt = "s16"
    elif audio_fmt == 1 and bits == 32:
        raw = np.frombuffer(data_chunk, dtype="<i4")
        data = (raw.astype(np.float64) / 2147483648.0).astype(np.float32)
        fmt = "s32"
    else:
        data = np.frombuffer(data_chunk, dtype="<f4").astype(np.float32)
        fmt = "flt"
    n = len(data) // channels
    planar = data[: n * channels].reshape(n, channels).T
    return np.ascontiguousarray(planar, dtype=np.float32), int(rate), fmt


class _WholeClip:
    """The executor's former fallback: the whole clip read at once
    (``_whole_read``), then sliced into chunks."""

    def __init__(self, path):
        self._data, self.rate, self.fmt = _whole_read(path)
        self.channels = self._data.shape[0]
        self.pts0_us = 0

    def blocks(self, n):
        for start in range(0, self._data.shape[1], n):
            yield self._data[:, start : start + n]

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


def _check_streamed_export(tmp_path, monkeypatch):
    """A streamed export through the reader writes the bytes the former
    whole-clip read wrote."""
    project, _ = _project(tmp_path, seconds=6)
    graph = cli._load_graph(project)
    paths = {}
    block_reader = host_decode.WavBlockReader
    for name, reader in (("whole", _WholeClip), ("blocks", block_reader)):
        monkeypatch.setattr(host_decode, "WavBlockReader", reader)
        paths[name] = str(tmp_path / f"{name}.wav")
        metrics = Runner(graph, device="cpu").export_streamed(
            paths[name], chunk_seconds=1.0)
        assert metrics.mode == "streamed"
    with open(paths["blocks"], "rb") as a, open(paths["whole"], "rb") as b:
        assert a.read() == b.read()


def _check_source_feed(tmp_path):
    path = _wav(tmp_path, "s16", frames=80_000)
    feed = stream_executor._SourceFeed(path, chunk_seconds=0.5)
    assert isinstance(feed._decoder, host_decode.WavBlockReader)
    assert feed._whole is None
    feed.stop()
    feed._decoder.close()
    # One block of 4,000 frames is 32 KB of float32 planar samples; a
    # block's bytes read, its samples and their planar copy are alive at
    # once. The whole clip would be 640 KB.
    tracemalloc.start()
    try:
        with host_decode.WavBlockReader(path) as reader:
            total = 0
            for block in reader.blocks(4_000):
                total += block.shape[1]
                del block
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert total == 80_000
    assert peak <= 3 * 4_000 * 2 * 4
    assert peak < 80_000 * 2 * 4 // 4


def _check_not_a_wav(tmp_path):
    path = str(tmp_path / "clip.mp3")
    with open(path, "wb") as f:
        f.write(b"\0" * 64)
    with pytest.raises(host_decode.ProcessorRuntimeError):
        stream_executor._SourceFeed(path, chunk_seconds=1.0)
