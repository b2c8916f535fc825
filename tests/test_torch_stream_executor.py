"""The port's streamed export (``StreamExecutor``, ``Runner.export_streamed``,
``run --stream``) on the CPU, against the port's offline render and the
JAX package's ``StreamExecutor``.

Graphs are built with the JAX package's processors and carried into the
port by ``graph_from_jax``; tracks are made with numpy from a seed. Bars,
the JAX package's own streamed == offline bars
(tests/test_stream_executor.py): 3e-7 for the two-track mix, 2e-6 for the
graphs with WSOLA stages; the same bars against the JAX executor's blocks.
The JAX executor is given the port's decode: its own would build the JAX
package's codec runtime without a lock, which test workers started
together can race on.
"""

import json
import os

import numpy as np
import pytest

from nodey_tpu.core import errors as jerrors
from nodey_tpu.core import stream_executor as jstream_executor
from nodey_tpu.core.graph import Graph as JGraph
from nodey_tpu.host import decode as jhost_decode
from nodey_tpu.processors.amix import AudioAmix as JAudioAmix
from nodey_tpu.processors.audio_input import AudioInput as JAudioInput
from nodey_tpu.processors.audio_output import AudioOutput as JAudioOutput
from nodey_tpu.processors.audio_vol import AudioVol as JAudioVol
from nodey_tpu.processors.resample_node import AudioResample as JAudioResample
from nodey_tpu.processors.velocity import PitchModifier as JPitchModifier
from nodey_tpu.processors.velocity import VelocityModifier as JVelocityModifier
from nodey_tpu_torch.app import cli
from nodey_tpu_torch.convert import graph_from_jax
from nodey_tpu_torch.core.errors import (ProcessorRuntimeError, RunCancelled,
                                         UnstreamableGraphError)
from nodey_tpu_torch.core.runner import Runner
from nodey_tpu_torch.core.stream_executor import StreamExecutor
from nodey_tpu_torch.host import decode as host_decode


def _write_tracks(tmp_path, seconds, count=2):
    rng = np.random.default_rng(2026)
    n = int(44_100 * seconds)
    t = np.arange(n) / 44_100.0
    paths = []
    for i in range(count):
        data = np.stack([0.4 * np.sin(2 * np.pi * 220.0 * (i + 1) * t)
                         + 0.05 * rng.standard_normal(n),
                         0.3 * np.sin(2 * np.pi * 331.0 * t + i)])
        path = str(tmp_path / f"t{i}.wav")
        host_decode.write_wav_s16(path, data.astype(np.float32), 44_100)
        paths.append(path)
    return paths


def _chain(paths, *stages):
    """A JAX-package graph: input slots -> stages (in a chain from slot 0)
    -> output; a stage "mix" mixes the chain with slot 1."""
    g = JGraph()
    src = g.add_node(JAudioInput())
    g.nodes[src].processor.file_paths = list(paths)
    g.update_node_pin(src)

    def pin(n, p):
        return g.nodes[n].pin_name_map[p]

    prev = pin(src, "output_0")
    for stage in stages:
        if stage == "mix":
            node = g.add_node(JAudioAmix())
            g.nodes[node].processor.set_input_num(2)
            g.nodes[node].processor.volumes = [0.6, 0.4]
            g.add_link(prev, pin(node, "input_1"))
            g.add_link(pin(src, "output_1"), pin(node, "input_2"))
        else:
            node = g.add_node(stage())
            g.add_link(prev, pin(node, "input"))
        prev = pin(node, "output")
    out = g.add_node(JAudioOutput())
    g.add_link(prev, pin(out, "input"))
    return g


def _gain(volume=1.4):
    def make():
        node = JAudioVol()
        node.set_volume(volume)
        return node
    return make


def _pitch(semitones):
    def make():
        node = JPitchModifier()
        node.pitch = semitones
        return node
    return make


def _velocity(velocity, keep_pitch=True):
    def make():
        node = JVelocityModifier()
        node.set_velocity(velocity)
        node.keep_pitch = keep_pitch
        return node
    return make


def _resample(rate):
    def make():
        node = JAudioResample()
        node.set_target_rate(rate)
        return node
    return make


def _run_port(graph, chunk_seconds, **kw):
    blocks = []
    ex = StreamExecutor(graph, mode="export", chunk_seconds=chunk_seconds,
                        device="cpu", **kw)
    metrics = ex.run(sink=lambda b: blocks.append(b.copy()))
    return np.concatenate(blocks, axis=1), metrics, ex


def _run_jax(graph, chunk_seconds, monkeypatch):
    def no_stream_decoder(path):
        raise jerrors.ProcessorRuntimeError("unavailable", "in tests", path)

    monkeypatch.setattr(jhost_decode, "StreamDecoder", no_stream_decoder)
    monkeypatch.setattr(jhost_decode, "decode_file", host_decode.decode_file)
    blocks = []
    jstream_executor.StreamExecutor(
        graph, mode="export", chunk_seconds=chunk_seconds, egress_workers=1,
    ).run(sink=lambda b: blocks.append(np.asarray(b).copy()))
    return np.concatenate(blocks, axis=1)


@pytest.mark.parametrize("name,stages,seconds,chunk,tol", [
    ("two-track mix", (_gain(), "mix"), 2.0, 0.35, 3e-7),
    ("pitch", (_pitch(4.0),), 1.5, 0.3, 2e-6),
    ("velocity -> pitch -> resample",
     (_velocity(0.8), _pitch(3.0), _resample(48_000)), 1.2, 0.25, 2e-6),
])
def test_streamed_export_equals_offline_and_the_jax_executor(
        tmp_path, monkeypatch, name, stages, seconds, chunk, tol):
    jg = _chain(_write_tracks(tmp_path, seconds), *stages)
    tg = graph_from_jax(jg)
    offline = Runner(tg, device="cpu").render("export")
    got, metrics, ex = _run_port(tg, chunk)
    assert metrics.steps >= 4
    assert got.shape == offline.master.shape
    np.testing.assert_allclose(got, offline.master, rtol=0, atol=tol)
    assert metrics.audio_seconds == pytest.approx(
        offline.metrics.audio_seconds, abs=1e-9)
    want = _run_jax(jg, chunk, monkeypatch)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    # The stage queues and carry FIFOs stay readable after the run.
    stats = ex.live_stats()
    assert stats["steps"] == metrics.steps
    for key in ("decode_fill", "egress_fill", "host_fill"):
        assert 0.0 <= stats[key] <= 1.0
    assert all(s["done"] for s in stats["sources"].values())
    assert stats["edges"] and all(0.0 <= v <= 1.0
                                  for v in stats["edges"].values())


def test_streamed_preview_equals_the_offline_preview(tmp_path):
    """mode="preview": the output node resamples the 44.1 kHz master to
    48 kHz stereo through a streaming stage and clamps it, as the offline
    preview does (3e-7)."""
    tg = graph_from_jax(_chain(_write_tracks(tmp_path, 1.2, count=1),
                               _gain(2.5)))
    offline = Runner(tg, device="cpu").preview()
    blocks = []
    ex = StreamExecutor(tg, mode="preview", chunk_seconds=0.3, device="cpu")
    metrics = ex.run(sink=blocks.append)
    got = np.concatenate(blocks, axis=1)
    assert metrics.steps >= 4 and ex.master_meta["rate"] == 48_000
    assert got.shape == offline.master.shape
    assert np.abs(got).max() <= 1.0
    np.testing.assert_allclose(got, offline.master, rtol=0, atol=3e-7)


def test_whole_clip_feed_when_the_streaming_decoder_is_missing(
        tmp_path, monkeypatch):
    """Where the codec runtime does not load (a machine without FFmpeg) the
    feed decodes the whole clip and slices it: the same master."""
    tg = graph_from_jax(_chain(_write_tracks(tmp_path, 1.0), _gain(), "mix"))
    streamed, _, _ = _run_port(tg, 0.25)

    def no_stream_decoder(path):
        raise ProcessorRuntimeError("Streaming decoder unavailable", "test",
                                    path)

    monkeypatch.setattr(host_decode, "StreamDecoder", no_stream_decoder)
    sliced, metrics, _ = _run_port(tg, 0.25)
    assert metrics.steps >= 4
    np.testing.assert_array_equal(sliced, streamed)


def test_stop_midway_drains_early(tmp_path):
    """stop() ends the pump; the blocks already queued (at most the two
    queues' depths) still reach the sink."""
    tg = graph_from_jax(_chain(_write_tracks(tmp_path, 3.0), _gain(), "mix"))
    ex = StreamExecutor(tg, mode="export", chunk_seconds=0.25, device="cpu",
                        egress_depth=2)
    seen = []

    def sink(block):
        seen.append(block)
        if len(seen) == 1:
            ex.stop()

    metrics = ex.run(sink=sink)
    assert 1 <= len(seen) <= 7 and metrics.steps < 12


def test_rss_guard_records_the_peak_and_enforces_the_hard_ceiling(
        tmp_path, monkeypatch):
    tg = graph_from_jax(_chain(_write_tracks(tmp_path, 1.0), _gain(), "mix"))
    _, metrics, ex = _run_port(tg, 0.5)
    assert metrics.rss_peak_bytes > 10 * 2**20
    assert ex.live_stats()["rss_peak_bytes"] == metrics.rss_peak_bytes
    monkeypatch.setenv("NODEY_RSS_HARD_MB", "1")
    with pytest.raises(ProcessorRuntimeError, match="memory ceiling"):
        _run_port(tg, 0.5)


def test_mismatched_cadence_falls_back_to_the_offline_export(tmp_path):
    """A velocity branch mixed with a raw one cannot stream in lockstep:
    the executor refuses it at plan time, and export_streamed writes the
    offline export on the same device instead (the JAX package's
    fallback): byte-identical files."""
    jg = _chain(_write_tracks(tmp_path, 0.6),
                _velocity(2.0, keep_pitch=False), "mix")
    tg = graph_from_jax(jg)
    with pytest.raises(UnstreamableGraphError, match="different rates"):
        _run_port(tg, 0.25)
    streamed, offline = str(tmp_path / "s.wav"), str(tmp_path / "o.wav")
    runner = Runner(tg, device="cpu")
    metrics = runner.export_streamed(streamed)
    assert metrics.mode == "offline" and runner.last_stream_metrics is None
    assert metrics.audio_seconds > 0.5
    Runner(tg, device="cpu").export(offline)
    with open(streamed, "rb") as f1, open(offline, "rb") as f2:
        assert f1.read() == f2.read()


def test_s16_master_wire_writes_the_offline_bytes(tmp_path):
    """A gain-only graph keeps an s16 master: quantized on the device with
    the encoders' clip(trunc(x*32768)), the streamed WAV equals the offline
    one byte for byte."""
    tg = graph_from_jax(_chain(_write_tracks(tmp_path, 1.1, count=1),
                               _gain(0.7)))
    streamed, offline = str(tmp_path / "s.wav"), str(tmp_path / "o.wav")
    runner = Runner(tg, device="cpu")
    metrics = runner.export_streamed(streamed, chunk_seconds=0.3)
    assert metrics.mode == "streamed"
    assert runner.last_stream_metrics.steps >= 4
    Runner(tg, device="cpu").export(offline)
    with open(streamed, "rb") as f1, open(offline, "rb") as f2:
        assert f1.read() == f2.read()


def test_export_streamed_cancels_without_a_partial_file(tmp_path):
    tg = graph_from_jax(_chain(_write_tracks(tmp_path, 3.0), _gain(), "mix"))
    runner = Runner(tg, device="cpu")
    path = str(tmp_path / "cancelled.wav")
    calls = []

    def progress(seconds):
        calls.append(seconds)
        if len(calls) == 1:
            runner.stop()

    with pytest.raises(RunCancelled):
        runner.export_streamed(path, progress=progress, chunk_seconds=0.25)
    assert not os.path.exists(path)


def test_cli_run_stream_exports_the_offline_master(tmp_path, capsys):
    jg = _chain(_write_tracks(tmp_path, 1.0), _pitch(-2.0))
    proj = tmp_path / "p.json"
    proj.write_text(json.dumps(jg.serialize()))
    out = str(tmp_path / "out.wav")
    assert cli.main(["run", str(proj), "--export", out, "--stream",
                     "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert f"exported {out} (streamed)" in printed
    assert "stages:" in printed and "d2h busy" in printed
    offline = Runner(graph_from_jax(jg), device="cpu").render("export")
    master = host_decode.decode_file(out).data
    assert master.shape == offline.master.shape
    np.testing.assert_allclose(master, offline.master, rtol=0, atol=2e-6)
