"""The port's real-time preview session and chunked render
(``nodey_tpu_torch.core.streaming``), its realtime pacer and ``run
--realtime``, on the CPU, mirroring tests/test_streaming.py.

- ``StreamingSession``: the blocks reassemble ``Runner.preview()``'s
  master, bitwise for the whole-clip session and >= 120 dB streamed (the
  JAX package's bars, tests/test_streaming.py:93 and
  tests/test_stream_executor.py:209); equal to the JAX package's session on
  the same graph (120 dB); stop midway; a producer error is re-raised.
- ``render_chunked``: against the whole-clip render (130 dB with the mixer's
  resample, 120 dB through an explicit downsample node) and against the JAX
  package's ``render_chunked`` (130 dB); progress; time-variant graphs
  refused.
- ``RealtimePacer`` under a fake clock; ``run --realtime --device cpu``
  writes the preview WAV, paced at 1.0x.

The JAX package decodes with the port's decoder: its own would build its
codec runtime without a lock, which test workers started together can
race on.
"""

import json
import threading

import numpy as np
import pytest
import torch

from conftest import make_tone, snr_db
from nodey_tpu.core import streaming as jstreaming
from nodey_tpu.core.graph import Graph as JGraph
from nodey_tpu.host import decode as jhost_decode
from nodey_tpu.processors.amix import AudioAmix as JAudioAmix
from nodey_tpu.processors.audio_input import AudioInput as JAudioInput
from nodey_tpu.processors.audio_output import AudioOutput as JAudioOutput
from nodey_tpu.processors.audio_vol import AudioVol as JAudioVol
from nodey_tpu.processors.resample_node import AudioResample as JAudioResample
from nodey_tpu_torch.app import cli
from nodey_tpu_torch.convert import graph_from_jax
from nodey_tpu_torch.core.errors import ProcessorRuntimeError
from nodey_tpu_torch.core.runner import Runner
from nodey_tpu_torch.core.streaming import (StreamingSession, render_chunked,
                                            start_block_egress,
                                            stream_supported, supports_chunked)
from nodey_tpu_torch.host import decode as host_decode
from nodey_tpu_torch.host import streamio
from nodey_tpu_torch.host.streamio import BoundedBlockQueue, RealtimePacer
from nodey_tpu_torch.processors.velocity import VelocityModifier


def _write(tmp_path, name, data, rate):
    path = str(tmp_path / name)
    host_decode.write_wav(path, data, rate)
    return path


def _jax_mix(paths, resample_to=None):
    """Two tracks: gain on the first, amix (to 48 kHz stereo), then an
    optional resample node, output (JAX-package processors)."""
    g = JGraph()
    src = g.add_node(JAudioInput())
    g.nodes[src].processor.file_paths = list(paths)
    g.update_node_pin(src)

    def pin(n, p):
        return g.nodes[n].pin_name_map[p]

    vol = g.add_node(JAudioVol())
    g.nodes[vol].processor.set_volume(1.2)
    g.add_link(pin(src, "output_0"), pin(vol, "input"))
    last = pin(vol, "output")
    if len(paths) == 2:
        amix = g.add_node(JAudioAmix())
        g.nodes[amix].processor.set_input_num(2)
        g.nodes[amix].processor.volumes = [0.5, 0.5]
        g.add_link(last, pin(amix, "input_1"))
        g.add_link(pin(src, "output_1"), pin(amix, "input_2"))
        last = pin(amix, "output")
    if resample_to:
        rs = g.add_node(JAudioResample())
        g.nodes[rs].processor.set_target_rate(resample_to)
        g.add_link(last, pin(rs, "input"))
        last = pin(rs, "output")
    out = g.add_node(JAudioOutput())
    g.add_link(last, pin(out, "input"))
    return g


@pytest.fixture
def two_tracks(tmp_path):
    rate = 44_100
    return [_write(tmp_path, "a.wav", make_tone(rate, 1.0, 220, channels=2),
                   rate),
            _write(tmp_path, "b.wav", make_tone(rate, 0.7, 330, channels=2),
                   rate)]


@pytest.fixture
def jax_decodes_with_the_port(monkeypatch):
    monkeypatch.setattr(jhost_decode, "decode_file", host_decode.decode_file)


@pytest.mark.parametrize("streamed", [False, True])
def test_session_blocks_reassemble_the_preview(two_tracks, streamed):
    jg = _jax_mix(two_tracks)
    reference = Runner(graph_from_jax(jg), device="cpu").preview().master
    session = StreamingSession(graph_from_jax(jg), block_samples=4096,
                               device="cpu").start(streamed=streamed)
    received = list(session.blocks(realtime=False))
    session.stop()
    got = np.concatenate(received, axis=1)
    assert got.shape == reference.shape
    if streamed:
        assert snr_db(reference, got) > 120.0
    else:
        np.testing.assert_array_equal(got, reference)
    assert session.stats.blocks == len(received)
    assert session.stats.rtf_compute > 0
    assert session.duration_seconds == reference.shape[1] / 48_000


def test_session_equals_the_jax_session(two_tracks, jax_decodes_with_the_port):
    jg = _jax_mix(two_tracks)
    jsession = jstreaming.StreamingSession(jg, block_samples=4096).start(
        streamed=False)
    want = np.concatenate(list(jsession.blocks()), axis=1)
    jsession.stop()
    session = StreamingSession(graph_from_jax(jg), block_samples=4096,
                               device="cpu").start()
    got = np.concatenate(list(session.blocks()), axis=1)
    session.stop()
    assert got.shape == want.shape
    assert snr_db(want, got) > 120.0


def test_session_previews_an_unstreamable_mix_whole_clip(two_tracks):
    """A mixer whose branches run at different tempos cannot stream in
    lockstep: the session previews it whole-clip on the same device, as
    the JAX package does (bitwise the preview render)."""
    from test_torch_chunkflow import _velocity_mix_graph

    reference = Runner(_velocity_mix_graph(two_tracks)[0],
                       device="cpu").preview().master
    session = StreamingSession(_velocity_mix_graph(two_tracks)[0],
                               device="cpu").start()
    got = np.concatenate(list(session.blocks()), axis=1)
    session.stop()
    np.testing.assert_array_equal(got, reference)
    assert session._master is not None  # the whole-clip path ran


def test_session_stop_midway(tmp_path):
    path = _write(tmp_path, "in.wav", make_tone(48_000, 3.0, 440, channels=2),
                  48_000)
    session = StreamingSession(graph_from_jax(_jax_mix([path])),
                               block_samples=2048, device="cpu").start()
    it = session.blocks()
    next(it)
    session.stop()
    remaining = list(it)
    assert len(remaining) < 60  # of 71 blocks: ended early, no hang


def test_producer_errors_are_raised_not_silent(tmp_path):
    class ExplodingQueue(BoundedBlockQueue):
        def push(self, item, stop=None, timeout=0.1):
            raise RuntimeError("boom in push")

    queue = ExplodingQueue()
    errors: list = []
    thread = start_block_egress(torch.zeros((2, 8192)), 8192, 2048, queue,
                                threading.Event(), errors)
    thread.join(timeout=10.0)
    assert not thread.is_alive()
    assert errors and "boom in push" in str(errors[0])
    assert queue.pop() is None  # EOF despite the failure

    # A session whose producer fails re-raises from blocks().
    path = _write(tmp_path, "in.wav", make_tone(48_000, 0.2), 48_000)
    g = graph_from_jax(_jax_mix([path]))
    out = next(nid for nid, node in g.nodes.items()
               if node.processor.info().identifier == "audio_output")
    g.remove_node(out)
    session = StreamingSession(g, device="cpu").start()
    with pytest.raises(ProcessorRuntimeError, match="no audio"):
        list(session.blocks())
    session.stop()


def test_chunked_equals_whole_clip_with_resample(two_tracks):
    jg = _jax_mix(two_tracks)
    whole = Runner(graph_from_jax(jg), device="cpu").render("export")
    master, rate, fmt, spectra = render_chunked(
        graph_from_jax(jg), chunk_seconds=0.3, halo_seconds=0.05,
        device="cpu")
    assert rate == whole.rate == 48_000 and fmt == whole.fmt
    assert master.shape == whole.master.shape
    assert snr_db(whole.master, master) > 130.0
    assert spectra == {}


def test_chunked_equals_the_jax_chunked_render(two_tracks,
                                               jax_decodes_with_the_port):
    jg = _jax_mix(two_tracks)
    want, jrate, _, _ = jstreaming.render_chunked(jg, chunk_seconds=0.3,
                                                  halo_seconds=0.05)
    got, rate, _, _ = render_chunked(graph_from_jax(jg), chunk_seconds=0.3,
                                     halo_seconds=0.05, device="cpu")
    assert rate == jrate and got.shape == want.shape
    assert snr_db(want, got) > 130.0


def test_chunked_with_explicit_downsample_node(tmp_path):
    path = _write(tmp_path, "in.wav", make_tone(44_100, 1.2, 220, channels=2),
                  44_100)
    jg = _jax_mix([path], resample_to=32_000)
    whole = Runner(graph_from_jax(jg), device="cpu").render("export")
    master, rate, _, _ = render_chunked(graph_from_jax(jg), chunk_seconds=0.5,
                                        halo_seconds=0.1, device="cpu")
    assert rate == whole.rate == 32_000
    assert master.shape == whole.master.shape
    assert snr_db(whole.master, master) > 120.0


def test_chunked_progress_reported(two_tracks):
    seen = []
    render_chunked(graph_from_jax(_jax_mix(two_tracks)), chunk_seconds=0.3,
                   halo_seconds=0.05, progress=seen.append, device="cpu")
    assert len(seen) >= 2  # chunks are whole resampler quanta
    assert seen == sorted(seen) and seen[-1] == pytest.approx(1.0, abs=0.01)


def test_time_variant_graph_refused(tmp_path):
    path = _write(tmp_path, "in.wav", make_tone(48_000, 0.2), 48_000)
    g = graph_from_jax(_jax_mix([path]))
    assert supports_chunked(g) and stream_supported(g)
    g.add_node(VelocityModifier())
    assert not supports_chunked(g)
    assert stream_supported(g)
    with pytest.raises(ProcessorRuntimeError, match="not chunkable"):
        render_chunked(g, device="cpu")


def test_realtime_pacer_under_a_fake_clock(monkeypatch):
    clock = {"now": 100.0, "slept": 0.0}

    def sleep(seconds):
        clock["now"] += seconds
        clock["slept"] += seconds

    monkeypatch.setattr(streamio.time, "perf_counter", lambda: clock["now"])
    monkeypatch.setattr(streamio.time, "sleep", sleep)
    pacer = RealtimePacer(rate=1000)
    pacer.wait(500)                  # the first block goes at once
    assert clock["slept"] == 0.0
    clock["now"] += 0.2              # the consumer took 0.2 s
    pacer.wait(250)                  # waits to 0.5 s of audio
    assert clock["now"] - 100.0 == pytest.approx(0.5, abs=2e-3)
    pacer.wait(0)                    # the last block's time is waited out
    assert clock["now"] - 100.0 == pytest.approx(0.75, abs=2e-3)


def test_run_realtime_on_the_cpu_writes_the_wav(two_tracks, tmp_path, capsys):
    project = tmp_path / "p.json"
    project.write_text(json.dumps(_jax_mix(two_tracks).serialize()))
    out = tmp_path / "rt.wav"
    rc = cli.main(["run", str(project), "--realtime", "--device", "cpu",
                   "--preview", str(out)])
    printed = capsys.readouterr().out
    assert rc == 0, printed
    audio_s, wall = (float(w) for w in printed.split()[1:6:3])
    assert printed.startswith("streamed ") and "underruns" in printed
    assert wall >= 0.98 * audio_s
    got = host_decode.decode_file(str(out)).data
    want = Runner(cli._load_graph(str(project)), device="cpu").preview().master
    assert got.shape == want.shape
    assert snr_db(want, got) > 120.0
