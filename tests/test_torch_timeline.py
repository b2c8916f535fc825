"""The port's timeline nodes (trim, reverse, crossfade:
``ops/editops.py``, ``ops/crossfade.py``, ``processors/editnodes.py``,
``processors/crossfade.py``) and the offline export's progress and
cancellation, against the JAX package, on the CPU.

- Trim and reverse are bitwise the JAX ops and numpy slicing, offline and
  streamed at several chunkings (pure index selection); reverse refuses
  the stream plan, and ``export_streamed`` falls back to the offline
  export, reporting progress, bitwise its file.
- The crossfade matches the JAX op within 3e-7 and the float64 mirror at
  the JAX test's 120 dB for both laws; it is bitwise A before its window
  and B after it, runs to the longer input, streams within 3e-7 (bitwise
  outside the window), and raises the JAX node's three validation errors
  and its anchor ceiling.
- examples/projects/crossfade_splice.json loads in both packages,
  round-trips byte for byte, and renders on 2 s tones as the JAX render
  does (3e-7; bitwise outside the window), streamed as offline.
- The four cancellation cases of tests/test_cancellation.py:42-115 hold
  on the port's ``Runner`` with ``device="cpu"`` on a 2 s clip: a
  ``stop()`` from the first progress call of ``export`` raises
  ``RunCancelled``, leaves no file and returns the runner to READY; a
  streamed export cancels alike; a stop between decode and dispatch
  cancels the render; the same runner then exports in full.
"""

import json
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import snr_db
from nodey_tpu.core import compiler as jcompiler
from nodey_tpu.core import registry as jregistry
from nodey_tpu.core.errors import ProcessorRuntimeError as JProcessorError
from nodey_tpu.core.graph import Graph as JGraph
from nodey_tpu.core.stream import Stream as JStream
from nodey_tpu.ops import crossfade as jcf
from nodey_tpu.ops import editops as jeditops
from nodey_tpu.processors.crossfade import AudioCrossfade as JCrossfade
from nodey_tpu.processors.editnodes import AudioReverse as JReverse
from nodey_tpu.processors.editnodes import AudioTrim as JTrim
from nodey_tpu_torch.core import chunkflow, compiler
from nodey_tpu_torch.core.errors import (ProcessorRuntimeError, RunCancelled,
                                         UnstreamableGraphError)
from nodey_tpu_torch.core.graph import Graph
from nodey_tpu_torch.core.registry import register_all_processors
from nodey_tpu_torch.core.runner import Runner, RunnerState
from nodey_tpu_torch.core.stream import Stream
from nodey_tpu_torch.host import decode as host_decode
from nodey_tpu_torch.ops import crossfade as cf
from nodey_tpu_torch.ops import editops
from nodey_tpu_torch.processors.audio_input import AudioInput
from nodey_tpu_torch.processors.audio_output import AudioOutput
from nodey_tpu_torch.processors.audio_vol import AudioVol
from nodey_tpu_torch.processors.crossfade import AudioCrossfade
from nodey_tpu_torch.processors.editnodes import AudioReverse, AudioTrim

RATE = 8_000
ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run the port's eager CPU ops on one thread (an oversubscribed
    intra-op pool spends more time in its barriers than in the ops under a
    parallel test run)."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def noise(n, channels=2, seed=0):
    rng = np.random.default_rng(seed)
    return (0.4 * rng.standard_normal((channels, n))).astype(np.float32)


def pin(g, nid, name):
    return g.nodes[nid].pin_name_map[name]


def input_graph(paths):
    """A port graph holding one audio_input on ``paths``; returns (graph,
    its node id)."""
    register_all_processors()
    g = Graph()
    src = g.add_node(AudioInput())
    g.nodes[src].processor.file_paths = list(paths)
    g.update_node_pin(src)
    return g, src


def node_graph(node, slots=1):
    """audio_input (``slots`` files) -> ``node`` -> output in the port;
    a two-input node takes the slots on input_a and input_b."""
    g, src = input_graph([f"{i}.wav" for i in range(slots)])
    nid = g.add_node(node)
    out = g.add_node(AudioOutput())
    if slots == 1:
        g.add_link(pin(g, src, "output_0"), pin(g, nid, "input"))
    else:
        g.add_link(pin(g, src, "output_0"), pin(g, nid, "input_a"))
        g.add_link(pin(g, src, "output_1"), pin(g, nid, "input_b"))
    g.add_link(pin(g, nid, "output"), pin(g, out, "input"))
    return g, src


def offline(g, src, xs):
    """The graph's export render on the CPU, ``xs[i]`` on the source's
    slot i: the master's valid samples."""
    sources, args = {}, {}
    for i, x in enumerate(xs):
        sources[(src, f"output_{i}")] = compiler.SourceSpec(
            rate=RATE, channels=x.shape[0], fmt="flt", capacity=x.shape[1])
        args[compiler.external_key(src, f"output_{i}")] = (
            torch.from_numpy(x), x.shape[1])
    data, length = compiler.compile_graph(g, sources, device="cpu")(
        args)[0]["master"]
    assert not data[:, length:].any()
    return data[:, :length].numpy()


def streamed(g, src, xs, chunk):
    """The graph's chunk steps on the CPU, each slot fed ``chunk`` samples a
    step, then empty chunks until the master is done: its valid samples,
    concatenated."""
    sources = {(src, f"output_{i}"): compiler.SourceSpec(
        rate=RATE, channels=x.shape[0], fmt="flt", capacity=chunk)
        for i, x in enumerate(xs)}
    sc = chunkflow.compile_stream_graph(g, sources, device="cpu")
    states, pos, pieces = sc.init_states, 0, []
    for _ in range(10_000):
        args = {}
        for i, x in enumerate(xs):
            n = max(0, min(chunk, x.shape[1] - pos))
            block = torch.zeros((x.shape[0], chunk))
            block[:, :n] = torch.from_numpy(x[:, pos:pos + n])
            args[compiler.external_key(src, f"output_{i}")] = (
                block, n, pos + chunk >= x.shape[1])
        pos += chunk
        states, outs = sc.step(states, args)
        data, m, done = outs["master"]
        assert not data[:, m:].any()
        pieces.append(data[:, :m].numpy())
        if done:
            return np.concatenate(pieces, axis=1)
    raise AssertionError("the stream never finished")


def jstream(x, t0_us=0.0):
    return JStream(data=jnp.asarray(x), length=jnp.int32(x.shape[1]),
                   rate=RATE, channels=x.shape[0], t0_us=t0_us)


def tstream(x, rate=RATE, t0_us=0.0, length=None):
    return Stream(data=torch.from_numpy(x), rate=rate, channels=x.shape[0],
                  length=x.shape[1] if length is None else length,
                  t0_us=t0_us)


def edited(cls, **params):
    node = cls()
    for key, value in params.items():
        if key == "law":
            node.set_law(value)
        else:
            node.set_param(key, value)
    return node


# -- trim and reverse ----------------------------------------------------------------

TRIMS = [(0.25, 1.0), (0.0, 0.5), (0.1, 0.0), (0.0, 0.0), (2.0, 0.0),
         (0.3, 0.2)]


@pytest.mark.parametrize("start_s,end_s", TRIMS)
def test_trim_is_bitwise_the_jax_op_and_numpy(start_s, end_s):
    x = noise(10_000)
    got = editops.trim_stream(tstream(x), start_s, end_s)
    want = jax.jit(lambda d: (lambda s: (s.data, s.length))(
        jeditops.trim_stream(jstream(d), start_s, end_s)))(jnp.asarray(x))
    assert got.capacity == want[0].shape[1]
    assert got.length == int(want[1])
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want[0]))
    n0, n1 = editops.trim_spec(RATE, start_s, end_s)
    np.testing.assert_array_equal(got.data[:, :got.length].numpy(),
                                  x[:, n0:max(n0, min(n1, x.shape[1]))])


def test_trim_streams_bitwise_at_every_chunking():
    x = noise(10_000, seed=3)
    g, src = node_graph(edited(AudioTrim, start_s=0.33, end_s=1.07))
    off = offline(g, src, [x])
    n0, n1 = editops.trim_spec(RATE, 0.33, 1.07)
    np.testing.assert_array_equal(off, x[:, n0:n1])
    for chunk in (500, 1_000, 2_640, 4_096):
        np.testing.assert_array_equal(streamed(g, src, [x], chunk), off)
    # To the clip's end, and starting past it.
    for start_s, end_s, want in ((0.9, 0.0, x[:, 7_200:]),
                                 (3.0, 0.0, x[:, :0])):
        g, src = node_graph(edited(AudioTrim, start_s=start_s, end_s=end_s))
        np.testing.assert_array_equal(offline(g, src, [x]), want)
        np.testing.assert_array_equal(streamed(g, src, [x], 1_024), want)


def test_reverse_is_bitwise_the_jax_op_and_respects_the_length():
    x = noise(4_000, seed=6)
    x[:, 3_000:] = 0.0
    got = editops.reverse_stream(tstream(x, length=3_000))
    want = jax.jit(lambda d: jeditops.reverse_stream(JStream(
        data=d, length=jnp.int32(3_000), rate=RATE, channels=2)).data)(
        jnp.asarray(x))
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.data[:, :3_000].numpy(),
                                  x[:, 2_999::-1])
    assert got.length == 3_000 and not got.data[:, 3_000:].any()
    back = editops.reverse_stream(editops.reverse_stream(tstream(x)))
    np.testing.assert_array_equal(back.data.numpy(), x)


def test_reverse_refuses_the_stream_and_the_export_falls_back(clip_wav,
                                                              tmp_path):
    g, src = node_graph(AudioReverse())
    with pytest.raises(UnstreamableGraphError):
        chunkflow.compile_stream_graph(g, {
            (src, "output_0"): compiler.SourceSpec(
                rate=RATE, channels=2, fmt="s16", capacity=1_000)},
            device="cpu")
    g.nodes[src].processor.file_paths = [clip_wav]
    runner = Runner(g, device="cpu")
    seen = []
    out = str(tmp_path / "streamed.wav")
    metrics = runner.export_streamed(out, progress=seen.append,
                                     chunk_seconds=0.5)
    assert metrics.mode == "offline" and runner.last_stream_metrics is None
    assert runner.state is RunnerState.FINISHED
    assert seen == sorted(seen) and seen[-1] == 2.0
    Runner(g, device="cpu").export(str(tmp_path / "offline.wav"))
    with open(out, "rb") as f1, open(tmp_path / "offline.wav", "rb") as f2:
        assert f1.read() == f2.read()
    np.testing.assert_array_equal(host_decode.decode_file(out).data,
                                  host_decode.decode_file(clip_wav).data[
                                      :, ::-1])
    # A stop from the fallback's first progress call cancels it.

    def stop(seconds):
        runner.stop()

    with pytest.raises(RunCancelled):
        runner.export_streamed(out, progress=stop, chunk_seconds=0.5)
    assert runner.state is RunnerState.READY and not os.path.exists(out)


# -- crossfade -----------------------------------------------------------------------


@pytest.mark.parametrize("law", cf.LAWS)
def test_crossfade_matches_the_jax_op_and_the_float64_mirror(law):
    a, b = noise(16_000, seed=1), noise(16_000, seed=2)
    got = cf.crossfade_streams(tstream(a), tstream(b), 1.0, 500.0, law)
    want = jax.jit(lambda x, y: jcf.crossfade_streams(
        jstream(x), jstream(y), 1.0, 500.0, law).data)(a, b)
    out = got.data.numpy()
    np.testing.assert_allclose(out, np.asarray(want), rtol=0.0, atol=3e-7)
    assert snr_db(cf.crossfade_reference(a, b, RATE, 1.0, 500.0, law),
                  out) > 120.0
    n0, n_dur = cf.crossfade_spec(RATE, 1.0, 500.0)
    np.testing.assert_array_equal(out[:, :n0], a[:, :n0])
    np.testing.assert_array_equal(out[:, n0 + n_dur:], b[:, n0 + n_dur:])


def test_crossfade_gains_and_selection_keep_negative_zero():
    ga, gb, before, after = cf.crossfade_gains(0, 4_000, 1_000, 2_000,
                                               "equal_power", "cpu")
    assert np.isclose(ga[2_000].item(), np.cos(np.pi / 4), atol=1e-6)
    assert np.isclose(gb[2_000].item(), np.sin(np.pi / 4), atol=1e-6)
    assert (ga[1_000:3_001].diff() <= 1e-7).all()
    assert (gb[1_000:3_001].diff() >= -1e-7).all()
    la, lb, _, _ = cf.crossfade_gains(0, 4_000, 1_000, 2_000, "linear",
                                      "cpu")
    np.testing.assert_allclose((la + lb)[1_000:3_000].numpy(), 1.0,
                               atol=1e-6)
    a = torch.full((1, 4_000), -0.0)
    b = torch.full((1, 4_000), -0.0)
    out = cf.crossfade_blend(a, b, 0, 1_000, 2_000, "linear")
    assert torch.signbit(out[:, :1_000]).all()
    assert torch.signbit(out[:, 3_000:]).all()


def test_crossfade_runs_to_the_longer_input():
    a, b = noise(6_000, seed=3), noise(14_000, seed=4)
    n0, n_dur = cf.crossfade_spec(RATE, 0.5, 300.0)
    s = cf.crossfade_streams(tstream(a), tstream(b), 0.5, 300.0,
                             "equal_power")
    assert s.length == 14_000
    np.testing.assert_array_equal(s.data[:, n0 + n_dur:].numpy(),
                                  b[:, n0 + n_dur:])
    s2 = cf.crossfade_streams(tstream(b), tstream(a), 0.5, 300.0, "linear")
    assert s2.length == 14_000 and n0 + n_dur == 6_400
    assert not s2.data[:, 6_400:].any()


@pytest.mark.parametrize("law,lengths", [("equal_power", (12_000, 12_000)),
                                         ("linear", (7_000, 12_000))])
def test_crossfade_streams_as_it_renders_offline(law, lengths):
    xs = [noise(n, seed=9 + i) for i, n in enumerate(lengths)]
    g, src = node_graph(edited(AudioCrossfade, at_s=0.6, dur_ms=400.0,
                               law=law), slots=2)
    off = offline(g, src, xs)
    assert off.shape == (2, 12_000)
    n0, n_dur = cf.crossfade_spec(RATE, 0.6, 400.0)
    for chunk in (2_048, 3_000):
        got = streamed(g, src, xs, chunk)
        assert got.shape == off.shape
        np.testing.assert_array_equal(got[:, :n0], off[:, :n0])
        np.testing.assert_array_equal(got[:, n0 + n_dur:],
                                      off[:, n0 + n_dur:])
        np.testing.assert_allclose(got, off, rtol=0.0, atol=3e-7)


def test_crossfade_validation_errors_and_anchor_ceiling():
    a = noise(4_000)
    cases = [{"input_a": (a, RATE, 0.0)},
             {"input_a": (a, RATE, 0.0), "input_b": (a, 44_100, 0.0)},
             {"input_a": (a, RATE, 0.0),
              "input_b": (noise(4_000, channels=1), RATE, 0.0)},
             {"input_a": (a, RATE, 0.0), "input_b": (a, RATE, 5e5)}]
    for inputs in cases:
        with pytest.raises(ProcessorRuntimeError) as got:
            AudioCrossfade().lower(None, {
                k: tstream(x, rate, t0) for k, (x, rate, t0)
                in inputs.items()})
        with pytest.raises(JProcessorError) as want:
            JCrossfade().lower(None, {
                k: JStream(data=jnp.asarray(x), length=jnp.int32(4_000),
                           rate=rate, channels=x.shape[0], t0_us=t0)
                for k, (x, rate, t0) in inputs.items()})
        assert (got.value.message, got.value.explanation,
                got.value.detail) == (want.value.message,
                                      want.value.explanation,
                                      want.value.detail)
    with pytest.raises(ProcessorRuntimeError) as got:
        cf.crossfade_spec(192_000, 86_400.0, 2_000.0)
    assert "exact-anchor ceiling" in got.value.message
    assert cf.crossfade_spec(48_000, 3_600.0, 2_000.0) == (
        jcf.crossfade_spec(48_000, 3_600.0, 2_000.0)) == (172_800_000,
                                                          96_000)


@pytest.mark.parametrize("cls,jcls,params", [
    (AudioTrim, JTrim, dict(start_s=1.5, end_s=1e9)),
    (AudioReverse, JReverse, {}),
    (AudioCrossfade, JCrossfade, dict(at_s=12.5, dur_ms=800.0,
                                      law="linear")),
])
def test_node_serde_pins_and_param_spec_equal_the_jax_node(cls, jcls,
                                                           params):
    for src_cls, dst_cls in ((cls, jcls), (jcls, cls)):
        src, dst = edited(src_cls, **params), dst_cls()
        blob = src.serialize()
        dst.deserialize(json.loads(json.dumps(blob)))
        assert json.dumps(dst.serialize()) == json.dumps(blob)
        assert dst.param_spec() == src.param_spec()
        assert (dst.info().identifier, dst.info().display_name,
                dst.info().description, dst.info().singleton) == \
            (src.info().identifier, src.info().display_name,
             src.info().description, src.info().singleton)
        assert [(a.identifier, a.display_name, a.is_input)
                for a in dst.pin_attributes()] == \
            [(a.identifier, a.display_name, a.is_input)
             for a in src.pin_attributes()]
    node, jnode = cls(), jcls()
    for blob in ({k: 1e12 for k in node.serialize()},
                 {k: -1e12 for k in node.serialize()},
                 {"at_s": "junk", "law": 7, "start_s": True}, None):
        node.deserialize(blob)
        jnode.deserialize(blob)
        assert node.serialize() == jnode.serialize()


# -- the shipped project ----------------------------------------------------------


def tone_wav(path, seconds, freq, rate=48_000):
    n = int(seconds * rate)
    t = np.arange(n) / rate
    x = np.stack([0.4 * np.sin(2 * np.pi * freq * t),
                  0.3 * np.sin(2 * np.pi * 1.5 * freq * t)])
    host_decode.write_wav_s16(path, x.astype(np.float32), rate)
    return path


def test_crossfade_splice_project_matches_the_jax_render(tmp_path):
    """examples/projects/crossfade_splice.json (two slots, a 1.5 s
    equal-power splice at 2.0 s) on two 2 s 48 kHz tones of 3 s and 4 s:
    loaded by both packages and round-tripped; the port's render within 3e-7
    of the JAX render and bitwise it outside the window; its streamed
    export (0.5 s chunks) the offline export's, bitwise outside the window,
    within 3e-7 inside it."""
    data = json.loads((ROOT / "examples/projects/crossfade_splice.json")
                      .read_text())
    paths = [tone_wav(str(tmp_path / "a.wav"), 3.0, 220.0),
             tone_wav(str(tmp_path / "b.wav"), 4.0, 330.0)]
    for node in data["nodes"].values():
        if node["identifier"] == "audio_input":
            node["info"]["file_path"] = paths
    jregistry.register_all_processors()
    register_all_processors()
    jg, tg = JGraph.deserialize(data), Graph.deserialize(data)
    assert json.dumps(tg.serialize()) == json.dumps(jg.serialize())
    tg.check_graph()
    runner = Runner(tg, device="cpu")
    got = runner.render("export").master
    arrays, lengths, sources = runner.decode()
    jsources = {key: jcompiler.SourceSpec(
        rate=s.rate, channels=s.channels, fmt=s.fmt, capacity=s.capacity,
        t0_us=s.t0_us) for key, s in sources.items()}
    jdata, jn = jcompiler.compile_graph(jg, jsources, mode="export").run(
        arrays, lengths)["master"]
    want = np.asarray(jdata)[:, :int(jn)]
    assert got.shape == want.shape == (2, 4 * 48_000)
    n0, n_dur = cf.crossfade_spec(48_000, 2.0, 1_500.0)
    np.testing.assert_array_equal(got[:, :n0], want[:, :n0])
    np.testing.assert_array_equal(got[:, n0 + n_dur:], want[:, n0 + n_dur:])
    np.testing.assert_allclose(got, want, rtol=0.0, atol=3e-7)
    metrics = Runner(tg, device="cpu").export_streamed(
        str(tmp_path / "s.wav"), chunk_seconds=0.5)
    assert metrics.mode == "streamed"
    Runner(tg, device="cpu").export(str(tmp_path / "o.wav"))
    st = host_decode.decode_file(str(tmp_path / "s.wav")).data
    off = host_decode.decode_file(str(tmp_path / "o.wav")).data
    assert st.shape == off.shape == got.shape
    np.testing.assert_array_equal(st[:, :n0], off[:, :n0])
    np.testing.assert_array_equal(st[:, n0 + n_dur:], off[:, n0 + n_dur:])
    np.testing.assert_allclose(st, off, rtol=0.0, atol=3e-7)


def gain_graph(path, volume):
    """BASELINE config 1 in the port: the clip -> gain -> output."""
    g, src = input_graph([path])
    vol = g.add_node(AudioVol())
    g.nodes[vol].processor.set_volume(volume)
    out = g.add_node(AudioOutput())
    g.add_link(pin(g, src, "output_0"), pin(g, vol, "input"))
    g.add_link(pin(g, vol, "output"), pin(g, out, "input"))
    return g


# -- cancellation (tests/test_cancellation.py:42-115 on the port) ------------------


@pytest.fixture
def clip_wav(tmp_path):
    """A 2 s stereo clip: exports of it span four 0.5 s blocks."""
    path = str(tmp_path / "clip.wav")
    host_decode.write_wav_s16(path, noise(2 * RATE, seed=3), RATE)
    return path


def test_offline_export_cancels_mid_encode(clip_wav, tmp_path):
    runner = Runner(gain_graph(clip_wav, 1.2), device="cpu")
    out = str(tmp_path / "cancelled.wav")
    seen = []

    def progress(seconds):
        seen.append(seconds)
        runner.stop()                  # cancel after the first block

    with pytest.raises(RunCancelled):
        runner.export(out, progress=progress, block_seconds=0.5)
    assert runner.state is RunnerState.READY
    assert runner.error is None
    assert not os.path.exists(out)
    assert seen == [0.5]               # it did encode before the cancel


def test_streamed_export_cancels(clip_wav, tmp_path):
    runner = Runner(gain_graph(clip_wav, 0.9), device="cpu")
    out = str(tmp_path / "cancelled_streamed.wav")

    def progress(seconds):
        runner.stop()

    with pytest.raises(RunCancelled):
        runner.export_streamed(out, progress=progress, chunk_seconds=0.5)
    assert runner.state is RunnerState.READY
    assert not os.path.exists(out)


def test_stop_before_dispatch_cancels_render(clip_wav):
    runner = Runner(gain_graph(clip_wav, 1.0), device="cpu")
    decode = runner.decode

    def stopping_decode():
        result = decode()
        runner.stop()
        return result

    runner.decode = stopping_decode
    with pytest.raises(RunCancelled):
        runner.render(mode="export", _nested=True)
    assert runner.state is RunnerState.READY


def test_runner_reusable_after_cancel(clip_wav, tmp_path):
    runner = Runner(gain_graph(clip_wav, 1.1), device="cpu")
    out1, out2 = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")

    def cancel_once(seconds):
        runner.stop()

    with pytest.raises(RunCancelled):
        runner.export(out1, progress=cancel_once, block_seconds=0.5)
    assert runner.state is RunnerState.READY
    seen = []
    result = runner.export(out2, progress=seen.append, block_seconds=0.5)
    assert runner.state is RunnerState.FINISHED
    assert result.metrics.audio_seconds == 2.0
    assert seen == [0.5, 1.0, 1.5, 2.0]
    # The same bytes as a fresh runner's export of the graph.
    out3 = str(tmp_path / "c.wav")
    Runner(gain_graph(clip_wav, 1.1), device="cpu").export(out3)
    with open(out2, "rb") as f2, open(out3, "rb") as f3:
        assert f2.read() == f3.read()
    assert host_decode.decode_file(out2).data.shape == (2, 2 * RATE)
