"""The port's single-input effect nodes other than the reverb (delay,
tremolo, chorus, phaser, pan, width, fade) and their ops against the JAX
package, on the CPU.

For each node type, on seeded clips of 1.5 s at 8 kHz (the JAX tests'
rate and signals):
- the node (its ``lower`` on one Stream) matches the JAX node, and the
  JAX package's float64 mirror of its op, at the bar the JAX package's own
  test sets against that mirror (tests/test_delay.py 120 dB,
  tests/test_modfx.py tremolo 120 dB and chorus 95 dB, tests/test_phaser.py
  105 dB, tests/test_fadepan.py and tests/test_width.py 130 dB);
- a one-node graph streamed through the port's chunk flow (2,048-sample
  chunks, a ragged last one) equals its offline render at those files'
  streamed bars (atol 3e-7; the phaser > 110 dB), the delay's grown by
  its echo tail;
- where the JAX node passes its input through bitwise, so does the
  port's, offline and streamed;
- its serde is byte-equal to the JAX node's both ways, with equal
  ``param_spec``, info and pins.
The LFO residues are the JAX package's, bitwise, at equal positions; an
end-anchored fade refuses the stream plan and the export falls back to
the offline render. The shipped channel-strip project at 2 s matches the
JAX render, and the example script's channel strip streams as it renders
offline.
"""

import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import snr_db
from nodey_tpu.core import compiler as jcompiler
from nodey_tpu.core import registry as jregistry
from nodey_tpu.core.graph import Graph as JGraph
from nodey_tpu.core.stream import Stream as JStream
from nodey_tpu.ops import delay as jdl
from nodey_tpu.ops import fadepan as jfp
from nodey_tpu.ops import modfx as jmx
from nodey_tpu.ops import phaser as jph
from nodey_tpu.processors.delay import AudioDelay as JDelay
from nodey_tpu.processors.fade import AudioFade as JFade
from nodey_tpu.processors.modulation import AudioChorus as JChorus
from nodey_tpu.processors.modulation import AudioPhaser as JPhaser
from nodey_tpu.processors.modulation import AudioTremolo as JTremolo
from nodey_tpu.processors.pan import AudioPan as JPan
from nodey_tpu.processors.pan import AudioWidth as JWidth
from nodey_tpu_torch.convert import graph_from_jax
from nodey_tpu_torch.core import chunkflow, compiler
from nodey_tpu_torch.core.errors import UnstreamableGraphError
from nodey_tpu_torch.core.graph import Graph
from nodey_tpu_torch.core.registry import processor_map, register_all_processors
from nodey_tpu_torch.core.runner import Runner
from nodey_tpu_torch.core.stream import Stream
from nodey_tpu_torch.core.streaming import (_LTI_NODES, stream_supported,
                                            supports_chunked)
from nodey_tpu_torch.host import decode as host_decode
from nodey_tpu_torch.ops import delay as dl
from nodey_tpu_torch.ops import fadepan as fp
from nodey_tpu_torch.ops import modfx as mx
from nodey_tpu_torch.ops import phaser as ph
from nodey_tpu_torch.processors.audio_input import AudioInput
from nodey_tpu_torch.processors.audio_output import AudioOutput
from nodey_tpu_torch.processors.delay import AudioDelay
from nodey_tpu_torch.processors.fade import AudioFade
from nodey_tpu_torch.processors.modulation import (AudioChorus, AudioPhaser,
                                                   AudioTremolo)
from nodey_tpu_torch.processors.pan import AudioPan, AudioWidth

RATE = 8_000
CHUNK = 2_048
ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run the port's eager CPU ops on one thread. These tests launch
    thousands of small ops (the scans' doubling rounds), and under a
    parallel test run torch's intra-op thread pool, oversubscribed by the
    other workers, spends more time in its barriers than in the ops."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def noise(n, channels=2, seed=0):
    rng = np.random.default_rng(seed)
    return (0.4 * rng.standard_normal((channels, n))).astype(np.float32)


def edited(cls, **params):
    node = cls()
    for key, value in params.items():
        node.set_param(key, value)
    return node


# -- one node, offline and streamed, in either package ---------------------------


def lower(node, x, rate=RATE):
    """The port node's ``lower`` on one Stream of ``x``."""
    stream = Stream(data=torch.from_numpy(x), length=x.shape[1], rate=rate,
                    channels=x.shape[0])
    return node.lower(None, {"input": stream})["output"]


def jlower(node, x, rate=RATE):
    """The JAX node's ``lower`` on one Stream, under one ``jax.jit`` (a
    single compile costs less than the eager ops' many). Returns (data,
    length) as numpy and int."""

    def run(data):
        stream = JStream(data=data, length=jnp.int32(x.shape[1]), rate=rate,
                         channels=x.shape[0])
        out = node.lower(None, {"input": stream})["output"]
        return out.data, out.length

    data, length = jax.jit(run)(jnp.asarray(x))
    return np.asarray(data), int(length)


def one_node_graph(node, paths=("a.wav",)):
    """audio_input -> ``node`` -> audio_output, in the port."""
    register_all_processors()
    g = Graph()
    src = g.add_node(AudioInput())
    g.nodes[src].processor.file_paths = list(paths)
    g.update_node_pin(src)
    nid = g.add_node(node)
    out = g.add_node(AudioOutput())
    pin = lambda n, p: g.nodes[n].pin_name_map[p]  # noqa: E731
    g.add_link(pin(src, "output_0"), pin(nid, "input"))
    g.add_link(pin(nid, "output"), pin(out, "input"))
    return g, src


def offline(g, src, x, rate=RATE):
    """The graph's export render on the CPU: the master's valid samples."""
    key = compiler.external_key(src, "output_0")
    sources = {(src, "output_0"): compiler.SourceSpec(
        rate=rate, channels=x.shape[0], fmt="flt", capacity=x.shape[1])}
    outputs, _meta = compiler.compile_graph(g, sources, device="cpu")(
        {key: (torch.from_numpy(x), x.shape[1])})
    data, length = outputs["master"]
    assert not data[:, length:].any()
    return data[:, :length].numpy()


def streamed(g, src, x, rate=RATE, chunk=CHUNK):
    """The graph's chunk steps on the CPU, fed ``x`` in ``chunk``-sample
    chunks and then empty chunks until the master is done (a tail flushes
    after the input's end): the master's valid samples, concatenated."""
    key = compiler.external_key(src, "output_0")
    sources = {(src, "output_0"): compiler.SourceSpec(
        rate=rate, channels=x.shape[0], fmt="flt", capacity=chunk)}
    sc = chunkflow.compile_stream_graph(g, sources, device="cpu")
    states, pos, pieces = sc.init_states, 0, []
    for _ in range(10_000):
        n = max(0, min(chunk, x.shape[1] - pos))
        block = torch.zeros((x.shape[0], chunk))
        block[:, :n] = torch.from_numpy(x[:, pos: pos + n])
        pos += chunk
        states, outs = sc.step(states, {key: (block, n, pos >= x.shape[1])})
        data, m, done = outs["master"]
        # The chunk's padding stays zero past its valid count.
        assert not data[:, m:].any()
        pieces.append(data[:, :m].numpy())
        if done:
            return np.concatenate(pieces, axis=1)
    raise AssertionError("the stream never finished")


# -- the node types ----------------------------------------------------------------

# name: (port class, JAX class, params, float64 mirror of the op on x,
#        node bar vs JAX and mirror, streamed bar: ("db", x) / ("atol", x))
NODES = {
    "audio_delay": (
        AudioDelay, JDelay,
        dict(delay_ms=93.0, feedback=0.6, wet=0.5, dry=0.7),
        lambda x: jdl.delay_reference(x, RATE, 93.0, 0.6, 0.5, 0.7),
        ("db", 120.0), ("atol", 3e-7)),
    "audio_tremolo": (
        AudioTremolo, JTremolo, dict(rate_hz=5.3, depth=0.7),
        lambda x: jmx.tremolo_reference(x, RATE, 5.3, 0.7),
        ("db", 120.0), ("atol", 3e-7)),
    "audio_chorus": (
        AudioChorus, JChorus,
        dict(rate_hz=0.8, base_ms=20.0, depth_ms=6.0, voices=3, wet=0.5,
             dry=0.8),
        lambda x: jmx.chorus_reference(x, RATE, 0.8, 20.0, 6.0, 3, 0.5, 0.8),
        ("db", 95.0), ("atol", 3e-7)),
    "audio_phaser": (
        AudioPhaser, JPhaser,
        dict(rate_hz=0.7, f_min_hz=200.0, f_max_hz=3000.0, stages=4,
             wet=0.7, dry=1.0),
        lambda x: jph.phaser_reference(x, RATE, 0.7, 200.0, 3000.0, 4, 0.7,
                                       1.0),
        ("db", 105.0), ("db", 110.0)),
    "audio_pan": (
        AudioPan, JPan, dict(pan=0.4), lambda x: jfp.pan_reference(x, 0.4),
        ("db", 130.0), ("atol", 3e-7)),
    "audio_width": (
        AudioWidth, JWidth, dict(width=1.4),
        lambda x: jfp.width_reference(x, 1.4), ("db", 130.0),
        ("atol", 3e-7)),
    "audio_fade": (
        AudioFade, JFade, dict(in_ms=60.0, out_start_s=1.0, out_ms=250.0),
        lambda x: jfp.fade_reference(x, RATE, 60.0, 1.0, 250.0),
        ("db", 130.0), ("atol", 0.0)),
}


def _nodes(name):
    cls, jcls, params = NODES[name][:3]
    return edited(cls, **params), edited(jcls, **params)


def _agree(bar, want, got, what):
    kind, value = bar
    assert want.shape == got.shape, what
    if kind == "atol":
        np.testing.assert_allclose(got, want, rtol=0, atol=value,
                                   err_msg=what)
    else:
        assert snr_db(want, got) > value, what


@pytest.mark.parametrize("name", sorted(NODES))
def test_node_matches_the_jax_node_and_the_float64_mirror(name):
    node, jnode = _nodes(name)
    x = noise(12_000, seed=9)
    got = lower(node, x)
    want, want_len = jlower(jnode, x)
    assert (got.length, got.rate, got.channels, got.fmt) == \
        (want_len, RATE, 2, "flt")
    assert got.data.shape == want.shape
    got = got.data.numpy()
    assert np.isfinite(got).all()
    _agree(NODES[name][4], want, got, "port node vs JAX node")
    mirror = NODES[name][3](x)
    _agree(NODES[name][4], mirror, got[:, :mirror.shape[1]],
           "port node vs float64 mirror")


@pytest.mark.parametrize("name", sorted(NODES))
def test_node_streams_as_it_renders_offline(name):
    node, _ = _nodes(name)
    x = noise(12_000 + 123, seed=5)
    g, src = one_node_graph(node)
    off = offline(g, src, x)
    got = streamed(g, src, x)
    if name == "audio_delay":
        d, k = dl.delay_params(RATE, 93.0, 0.6)
        assert off.shape[1] == x.shape[1] + k * d
    else:
        assert off.shape == x.shape
    _agree(NODES[name][5], off, got, "streamed vs offline")
    if name == "audio_delay":
        assert snr_db(off, got) > 120.0


# name: (params, the mono input passes too)
PASSTHROUGH = {
    "audio_delay": (dict(wet=0.0, dry=1.0), True),
    "audio_tremolo": (dict(depth=0.0), True),
    "audio_chorus": (dict(wet=0.0, dry=1.0), True),
    "audio_phaser": (dict(wet=0.0, dry=1.0), True),
    "audio_pan": (dict(pan=0.0), False),
    "audio_width": (dict(width=1.0), True),
    "audio_fade": (dict(), True),
}


@pytest.mark.parametrize("name", sorted(PASSTHROUGH))
def test_passthrough_is_bitwise_offline_and_streamed(name):
    params, mono = PASSTHROUGH[name]
    node = edited(NODES[name][0], **params)
    jnode = edited(NODES[name][1], **params)
    x = noise(4_000, seed=1)
    np.testing.assert_array_equal(lower(node, x).data.numpy(), x)
    np.testing.assert_array_equal(jlower(jnode, x)[0], x)
    g, src = one_node_graph(node)
    np.testing.assert_array_equal(streamed(g, src, x), x)
    if mono:
        x1 = noise(4_000, channels=1, seed=2)
        np.testing.assert_array_equal(lower(node, x1).data.numpy(), x1)
    if name == "audio_width":
        # Mono input to a width of 1.4: nothing to widen.
        x1 = noise(4_000, channels=1, seed=2)
        node = edited(AudioWidth, width=1.4)
        np.testing.assert_array_equal(lower(node, x1).data.numpy(), x1)


def test_dry_only_paths_equal_the_jax_nodes():
    """Wet 0 with dry below 1: the dry path alone, offline and streamed."""
    x = noise(6_000, seed=3)
    for cls, jcls in ((AudioDelay, JDelay), (AudioChorus, JChorus),
                      (AudioPhaser, JPhaser)):
        node = edited(cls, wet=0.0, dry=0.6)
        want = jlower(edited(jcls, wet=0.0, dry=0.6), x)[0]
        np.testing.assert_array_equal(lower(node, x).data.numpy(), want)
        g, src = one_node_graph(node)
        np.testing.assert_array_equal(streamed(g, src, x), want)


# -- the ops ---------------------------------------------------------------------


def test_delay_truncation_law_equals_the_jax_package():
    for rate in (8_000, 44_100, 48_000):
        for ms in (0.01, 37.5, 93.0, 240.0, 1000.0):
            for fb in (0.0, 0.1, 0.35, 0.45, 0.5, 0.7, 0.89, 0.9):
                assert dl.delay_params(rate, ms, fb) == \
                    jdl.delay_params(rate, ms, fb)


@pytest.mark.parametrize("fb,ms", [(0.0, 50.0), (0.5, 37.5), (0.9, 125.0)])
def test_delay_op_matches_the_float64_mirror(fb, ms):
    """tests/test_delay.py::test_offline_matches_float64, in the port."""
    x = noise(4_000)
    d, k = dl.delay_params(RATE, ms, fb)
    out = dl.delay_stream(Stream(data=torch.from_numpy(x), length=4_000,
                                 rate=RATE, channels=2), ms, fb, 0.4, 0.8)
    got = out.data.numpy()
    assert out.length == 4_000 + k * d
    ref = jdl.delay_reference(x, RATE, ms, fb, 0.4, 0.8)
    assert snr_db(ref, got[:, :out.length]) > 120.0
    assert not got[:, out.length:].any()


def test_lfo_residues_are_the_jax_package_residues():
    """At positions past float32's 2^24 integer ceiling: the port's int32
    residues equal Python's bignum arithmetic, and its turns are the JAX
    package's, bitwise; the residue carried across chunks likewise."""
    num, m = mx.lfo_quantize(5.3, RATE)
    assert (num, m) == jmx.lfo_quantize(5.3, RATE)
    w = 4_096
    for pos in (0, 12_345, 2**24 + 7, 10**9):
        r0 = (pos * num) % m
        got = mx.lfo_residues(r0, w, num, m, "cpu").numpy()
        want = [((pos + i) * num) % m for i in range(w)]
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            mx.lfo_turns(r0, w, num, m, "cpu").numpy(),
            np.asarray(jmx.lfo_turns(jnp.int32(r0), w, num, m)))
    for rate_hz in (0.05, 0.4, 0.8, 5.0, 20.0):
        for sample_rate in (8_000, 44_100, 48_000):
            assert mx.lfo_quantize(rate_hz, sample_rate) == \
                jmx.lfo_quantize(rate_hz, sample_rate)
    num, m = mx.lfo_quantize(0.8, RATE)
    r, jr = 0, jnp.int32(0)
    for n in (4_096, 1, 777, 3_000):
        r = mx.advance_residue(r, n, num, m)
        jr = jmx.advance_residue(jr, jnp.int32(n), num, m, 4_096)
        assert r == int(jr)


def test_tremolo_op_matches_the_float64_mirror():
    x = noise(20_000)
    out = mx.tremolo_stream(Stream(data=torch.from_numpy(x), length=20_000,
                                   rate=RATE, channels=2), 5.3, 0.7)
    assert snr_db(jmx.tremolo_reference(x, RATE, 5.3, 0.7),
                  out.data.numpy()) > 120.0


def test_chorus_stream_steps_equal_the_offline_op():
    """tests/test_modfx.py::test_streamed_equals_offline_ops, in the port:
    1,536-sample chunks against the whole-clip op, atol 3e-7."""
    x = noise(20_000, seed=2)
    num, m = mx.lfo_quantize(0.8, RATE)
    base, depth, hist = mx.chorus_spec(RATE, 20.0, 6.0, 3)
    params = (num, m, base, depth, 3, 0.5, 0.8)
    off = mx.chorus_stream(Stream(data=torch.from_numpy(x), length=20_000,
                                  rate=RATE, channels=2),
                           0.8, 20.0, 6.0, 3, 0.5, 0.8).data.numpy()
    state = mx.chorus_stream_init(2, hist, "cpu")
    outs = []
    for i in range(0, x.shape[1], 1_536):
        k = min(1_536, x.shape[1] - i)
        chunk = torch.zeros((2, 1_536))
        chunk[:, :k] = torch.from_numpy(x[:, i:i + k])
        state, o = mx.chorus_stream_step(params, state, chunk, k)
        outs.append(o[:, :k].numpy())
    np.testing.assert_allclose(np.concatenate(outs, axis=1), off, rtol=0.0,
                               atol=3e-7)


def test_phaser_spec_and_coefficients_equal_the_jax_package():
    for args in ((RATE, 0.7, 200.0, 3000.0), (RATE, 2.0, 100.0, 9000.0),
                 (48_000, 0.4, 300.0, 2500.0)):
        assert ph.phaser_spec(*args) == jph.phaser_spec(*args)
    num, m, k0, k1 = ph.phaser_spec(RATE, 2.0, 100.0, 9000.0)
    assert np.isclose(np.exp(k0 + k1), 0.45 * RATE)
    got = ph.phaser_coeffs(123, 4_096, num, m, k0, k1, RATE, "cpu").numpy()
    want = np.asarray(jph.phaser_coeffs(jnp.int32(123), 4_096, num, m, k0,
                                        k1, RATE))
    # The float32 cos, exp and tan of torch and of XLA differ by an ulp
    # here and there, and tan(0.45 pi) amplifies that: a few ulps of a.
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_phaser_stream_steps_and_the_empty_chunk():
    """tests/test_phaser.py::test_streamed_equals_offline_ops, in the
    port: 6 stages at 1,536-sample chunks > 110 dB against the offline
    op; an all-padding chunk leaves the carry untouched."""
    x = noise(20_000, seed=2)
    off = ph.phaser_stream(Stream(data=torch.from_numpy(x), length=20_000,
                                  rate=RATE, channels=2),
                           0.8, 150.0, 2500.0, 6, 0.6, 0.9).data.numpy()
    num, m, k0, k1 = ph.phaser_spec(RATE, 0.8, 150.0, 2500.0)
    params = (num, m, k0, k1, RATE, 6, 0.6, 0.9)
    mx.lfo_prepare(num, m, 1_536, "cpu")
    state = ph.phaser_stream_init(2, 6, "cpu")
    outs = []
    for i in range(0, x.shape[1], 1_536):
        k = min(1_536, x.shape[1] - i)
        chunk = torch.zeros((2, 1_536))
        chunk[:, :k] = torch.from_numpy(x[:, i:i + k])
        state, o = ph.phaser_stream_step(params, state, chunk, k)
        outs.append(o[:, :k].numpy())
    assert snr_db(off, np.concatenate(outs, axis=1)) > 110.0
    state2, out = ph.phaser_stream_step(params, state,
                                        torch.zeros((2, 1_536)), 0)
    assert not out.any()
    assert torch.equal(state2[0], state[0])
    assert torch.equal(state2[1], state[1])
    assert state2[2] == state[2]


def test_pan_width_and_fade_ops_equal_the_jax_package():
    """The pan law (stereo balance, mono placement), the width matrix and
    the fade gains: the port's outputs against the JAX package's, and its
    mirrors above 130 dB."""
    x2, x1 = noise(12_000, seed=4), noise(12_000, channels=1, seed=5)
    for pan in (-1.0, -0.3, 0.5, 1.0):
        for x in (x2, x1):
            got = fp.pan_array(torch.from_numpy(x), pan).numpy()
            np.testing.assert_array_equal(
                got, np.asarray(jfp.pan_array(jnp.asarray(x), pan)))
            assert snr_db(jfp.pan_reference(x, pan), got) > 130.0
    for width in (0.0, 0.5, 1.4, 2.0):
        got = fp.width_array(torch.from_numpy(x2), width).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jfp.width_array(jnp.asarray(x2), width)))
    cases = [(60.0, 1.0, 250.0, False), (0.0, 0.5, 0.0, False),
             (100.0, 0.0, 0.0, False), (60.0, 0.0, 500.0, True),
             (0.0, 0.0, 300.0, True)]
    for in_ms, out_s, out_ms, end in cases:
        spec = fp.fade_spec(RATE, in_ms, out_s, out_ms, end)
        jspec = jfp.fade_spec(RATE, in_ms, out_s, out_ms, end)
        assert dataclass_values(spec) == dataclass_values(jspec)
        for pos0 in (0, 7_000, 2**24 + 3):
            if end:
                got = fp.fade_gain_end(spec, pos0, 4_096, 12_000, "cpu")
                want = jfp.fade_gain_end(jspec, jnp.int32(pos0), 4_096,
                                         jnp.int32(12_000))
            else:
                got = fp.fade_gain(spec, pos0, 4_096, "cpu")
                want = jfp.fade_gain(jspec, jnp.int32(pos0), 4_096)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        out = fp.fade_stream(Stream(data=torch.from_numpy(x2),
                                    length=12_000, rate=RATE, channels=2),
                             spec).data.numpy()
        ref = jfp.fade_reference(x2, RATE, in_ms, out_s, out_ms, end)
        assert snr_db(ref, out) > 130.0 or np.array_equal(ref, out)


def dataclass_values(spec):
    return (spec.n_in, spec.out_start, spec.n_out, spec.anchor_end,
            spec.is_noop)


def test_fade_streams_bitwise_at_every_chunk_width():
    x = noise(20_000, seed=6)
    spec = fp.fade_spec(RATE, 80.0, 1.2, 300.0)
    off = fp.fade_stream(Stream(data=torch.from_numpy(x), length=20_000,
                                rate=RATE, channels=2), spec).data.numpy()
    for w in (1_536, 4_096):
        state, outs = fp.fade_stream_init(), []
        for i in range(0, x.shape[1], w):
            k = min(w, x.shape[1] - i)
            chunk = torch.zeros((2, w))
            chunk[:, :k] = torch.from_numpy(x[:, i:i + k])
            state, o = fp.fade_stream_step(spec, state, chunk, k)
            outs.append(o[:, :k].numpy())
        np.testing.assert_array_equal(np.concatenate(outs, axis=1), off)


def test_end_anchored_fade_refuses_the_stream_and_the_export_falls_back(
        tmp_path):
    path = str(tmp_path / "a.wav")
    host_decode.write_wav_s16(path, noise(RATE, seed=7), RATE)
    node = edited(AudioFade, in_ms=20.0, out_ms=200.0)
    node.set_param("anchor_end", True)
    g, src = one_node_graph(node, [path])
    with pytest.raises(UnstreamableGraphError):
        chunkflow.compile_stream_graph(g, {
            (src, "output_0"): compiler.SourceSpec(
                rate=RATE, channels=2, fmt="s16", capacity=CHUNK)},
            device="cpu")
    runner = Runner(g, device="cpu")
    metrics = runner.export_streamed(str(tmp_path / "streamed.wav"),
                                     chunk_seconds=0.1)
    assert metrics.mode == "offline" and runner.last_stream_metrics is None
    Runner(g, device="cpu").export(str(tmp_path / "offline.wav"))
    got = host_decode.decode_file(str(tmp_path / "streamed.wav")).data
    want = host_decode.decode_file(str(tmp_path / "offline.wav")).data
    assert got.shape == (2, RATE)
    np.testing.assert_array_equal(got, want)
    # The ramp ends at the clip's end.
    assert np.abs(got[:, -1]).max() < 1e-3
    # Without a fade-out ramp the end anchor is causal, and streams.
    node = edited(AudioFade, in_ms=50.0, out_ms=0.0)
    node.set_param("anchor_end", True)
    g, src = one_node_graph(node)
    x = noise(12_000, seed=21)
    np.testing.assert_allclose(streamed(g, src, x), offline(g, src, x),
                               rtol=0.0, atol=3e-7)


# -- serde, registration ------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(NODES))
def test_node_serde_pins_and_param_spec_equal_the_jax_node(name):
    for make_from, make_to in ((1, 0), (0, 1)):
        pair = _nodes(name)
        src, dst = pair[make_from], NODES[name][make_to]()
        blob = src.serialize()
        dst.deserialize(json.loads(json.dumps(blob)))
        assert json.dumps(dst.serialize()) == json.dumps(blob)
        assert dst.param_spec() == src.param_spec()
        assert dst.snapshot_params() == src.snapshot_params()
        assert (dst.info().identifier, dst.info().display_name,
                dst.info().description, dst.info().singleton) == \
            (src.info().identifier, src.info().display_name,
             src.info().description, src.info().singleton)
        assert [(a.identifier, a.display_name, a.is_input)
                for a in dst.pin_attributes()] == \
            [(a.identifier, a.display_name, a.is_input)
             for a in src.pin_attributes()]
        for attr in ("receptive_seconds", "hop"):
            assert getattr(dst, attr, None) == getattr(src, attr, None)
    # Hand-edited files clamp alike.
    node, jnode = NODES[name][0](), NODES[name][1]()
    for value in (1e9, -1e9):
        edits = {key: value for key in node.serialize()}
        edits["anchor_end"] = True
        node.deserialize(edits)
        jnode.deserialize(edits)
        assert node.serialize() == jnode.serialize()


def test_the_port_registers_the_eight_effect_nodes():
    register_all_processors()
    lti = {"audio_reverb", "audio_delay", "audio_pan", "audio_width"}
    for identifier in ("audio_reverb", "audio_delay", "audio_tremolo",
                       "audio_chorus", "audio_phaser", "audio_pan",
                       "audio_width", "audio_fade"):
        node = processor_map[identifier].generate()
        assert node.info().identifier == identifier
        assert (identifier in _LTI_NODES) == (identifier in lti)
        g, _ = one_node_graph(node)
        assert stream_supported(g)
        assert supports_chunked(g) == (identifier in lti)
    # With the generator, crossfade, trim and reverse: all 30 node types.
    assert len(processor_map) == 30


# -- the channel strips ---------------------------------------------------------------


def _tone_wav(path, seconds, rate=48_000):
    """bench.py's style of test tone (220 Hz with a little noise, seeded),
    with a quiet passage so the gate acts."""
    n = int(seconds * rate)
    t = np.arange(n) / rate
    rng = np.random.default_rng(11)
    x = np.stack([0.4 * np.sin(2 * np.pi * 220.0 * t),
                  0.4 * np.sin(2 * np.pi * 330.0 * t)])
    x += 0.01 * rng.standard_normal(x.shape)
    x[:, n // 2: 3 * n // 4] *= 0.002
    host_decode.write_wav_s16(path, x.astype(np.float32), rate)
    return path


def _jax_render(jg, runner):
    arrays, lengths, sources = runner.decode()
    jsources = {key: jcompiler.SourceSpec(
        rate=s.rate, channels=s.channels, fmt=s.fmt, capacity=s.capacity,
        t0_us=s.t0_us) for key, s in sources.items()}
    data, length = jcompiler.compile_graph(jg, jsources, mode="export").run(
        arrays, lengths)["master"]
    return np.asarray(data)[:, :int(length)]


def test_channel_strip_project_matches_the_jax_render(tmp_path):
    """examples/projects/channel_strip.json (gate, EQ, de-esser,
    compressor, phaser, width, reverb, normalize, limiter) on a 2 s 48 kHz
    stereo tone: loaded by both packages, the port's render on the CPU
    >= 90 dB against the JAX render (the de-esser's bar, the weakest node
    in it), grown by the reverb's tail; its streamed export falls back to
    the offline one (normalize refuses the stream plan)."""
    data = json.loads((ROOT / "examples/projects/channel_strip.json")
                      .read_text())
    for node in data["nodes"].values():
        if node["identifier"] == "audio_input":
            node["info"]["file_path"] = [_tone_wav(str(tmp_path / "t.wav"),
                                                   2.0)]
    jregistry.register_all_processors()
    register_all_processors()
    jg = JGraph.deserialize(data)
    tg = Graph.deserialize(data)
    assert json.dumps(tg.serialize()) == json.dumps(jg.serialize())
    runner = Runner(tg, device="cpu")
    want = _jax_render(jg, runner)
    got = runner.render("export")
    assert got.master.shape == want.shape
    assert got.master.shape[1] == 2 * 48_000 + int(1.2 * 48_000) + 960 - 1
    assert np.isfinite(got.master).all()
    assert snr_db(want, got.master) >= 90.0
    project = tmp_path / "strip.json"
    project.write_text(json.dumps(data))
    from nodey_tpu_torch.app import cli

    graph = cli._load_graph(str(project))
    metrics = Runner(graph, device="cpu").export_streamed(
        str(tmp_path / "s.wav"), chunk_seconds=0.5)
    assert metrics.mode == "offline"


def _example_graph(path):
    """examples/channel_strip.py's graph (gate, EQ, compressor, phaser,
    width, pan, delay, reverb, fade, limiter) built by the script in the
    JAX package, and carried into the port."""
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import channel_strip
    finally:
        sys.path.remove(str(ROOT / "examples"))
    jg = channel_strip.build_graph([path])
    return jg, graph_from_jax(jg)


def test_example_channel_strip_streams_as_it_renders_offline(tmp_path):
    """The script's chain on a 2 s 48 kHz tone: its streamed export (0.5 s
    chunks, the delay's and the reverb's tails flushed after the input's
    end) >= 88 dB against the offline export (the EQ's streamed bar, the
    weakest link), both grown by the two tails."""
    path = _tone_wav(str(tmp_path / "t.wav"), 2.0)
    jg, tg = _example_graph(path)
    assert json.dumps(tg.serialize()) == json.dumps(jg.serialize())
    for nid, node in jg.nodes.items():
        assert tg.nodes[nid].processor.snapshot_params() == \
            node.processor.snapshot_params()
    Runner(tg, device="cpu").export(str(tmp_path / "offline.wav"))
    metrics = Runner(tg, device="cpu").export_streamed(
        str(tmp_path / "streamed.wav"), chunk_seconds=0.5)
    assert metrics.mode == "streamed"
    off = host_decode.decode_file(str(tmp_path / "offline.wav")).data
    got = host_decode.decode_file(str(tmp_path / "streamed.wav")).data
    d, k = dl.delay_params(48_000, 240.0, 0.35)
    assert got.shape == off.shape == (2, 2 * 48_000 + k * d
                                      + int(1.2 * 48_000) + 960 - 1)
    assert snr_db(off, got) >= 88.0
