"""The channel split and the two bimix nodes of the port against the JAX
package, on the CPU.

- Ops: ``split_channels`` (mono and stereo, the s16 origin tag kept, so a
  gain after the split clamps then truncates bitwise as in JAX), ``bimix``
  at four biases with sides of unequal length and rate, the chunk helpers.
  Bar 2e-6 where a side goes through the resampler (its float32 sums run
  in another order), bitwise elsewhere.
- ``bimix_v2`` on the four alignment cases of tests/test_bimix_alignment.py
  (disjoint, partial overlap, fractional rounding, one-sided tail), offline
  and streamed through the port's chunk flow, bitwise the numpy golden and
  the JAX package's render; and one case at 44.1 kHz, through the
  resampler, at 2e-6.
- Nodes: serde, refused ``bias`` values, ``param_spec``, and a project
  holding all three nodes, byte-equal in both packages; the ``param_spec``
  of the input, gain, amix and spectrum nodes.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nodey_tpu.core import chunkflow as jchunkflow
from nodey_tpu.core import compiler as jcompiler
from nodey_tpu.core import registry as jregistry
from nodey_tpu.core.errors import ProcessorRuntimeError as JProcessorRuntimeError
from nodey_tpu.core.graph import Graph as JGraph
from nodey_tpu.core.stream import Stream as JStream
from nodey_tpu.ops import gain as jgain
from nodey_tpu.ops import mix as jmix
from nodey_tpu.processors.amix import AudioAmix as JAudioAmix
from nodey_tpu.processors.audio_input import AudioInput as JAudioInput
from nodey_tpu.processors.audio_output import AudioOutput as JAudioOutput
from nodey_tpu.processors.audio_vol import AudioVol as JAudioVol
from nodey_tpu.processors.bimix import AudioBimix as JAudioBimix
from nodey_tpu.processors.bimix import AudioBimixV2 as JAudioBimixV2
from nodey_tpu.processors.spectrum import AudioSpectrum as JAudioSpectrum
from nodey_tpu.processors.split import AudioSplit as JAudioSplit
from nodey_tpu_torch.core import chunkflow, compiler
from nodey_tpu_torch.core.errors import ProcessorRuntimeError
from nodey_tpu_torch.core.graph import Graph
from nodey_tpu_torch.core.registry import processor_map, register_all_processors
from nodey_tpu_torch.core.stream import Stream
from nodey_tpu_torch.ops import gain
from nodey_tpu_torch.ops import mix
from nodey_tpu_torch.processors.amix import AudioAmix
from nodey_tpu_torch.processors.audio_input import AudioInput
from nodey_tpu_torch.processors.audio_output import AudioOutput
from nodey_tpu_torch.processors.audio_vol import AudioVol
from nodey_tpu_torch.processors.bimix import AudioBimix, AudioBimixV2
from nodey_tpu_torch.processors.spectrum import AudioSpectrum
from nodey_tpu_torch.processors.split import AudioSplit

TOL = 2e-6
RATE = 48_000


def _signal(channels, n, seed, amp=0.5, s16=False):
    rng = np.random.default_rng(seed)
    data = (amp * rng.standard_normal((channels, n))).astype(np.float32)
    if s16:
        data = (np.clip(np.round(data * 32768), -32768, 32767)
                / 32768).astype(np.float32)
    return data


def _streams(data, rate, fmt="flt", t0_us=0.0):
    """The same samples as a port Stream and a JAX Stream."""
    kw = dict(length=data.shape[1], rate=rate, channels=data.shape[0],
              fmt=fmt, t0_us=t0_us)
    return Stream(data=torch.from_numpy(data), **kw), \
        JStream(data=jnp.asarray(data), **kw)


@pytest.mark.parametrize("channels", [1, 2])
def test_split_channels_keeps_the_format_and_matches_jax(channels):
    data = _signal(channels, 4_410, seed=channels, amp=0.9, s16=True)
    port, jax_stream = _streams(data, 44_100, fmt="s16")
    sides = mix.split_channels(port)
    jsides = jmix.split_channels(jax_stream)
    for side, jside, row in zip(sides, jsides, (0, channels - 1)):
        assert (side.channels, side.fmt, side.length) == (1, "s16", 4_410)
        np.testing.assert_array_equal(side.data.numpy(), data[row : row + 1])
        np.testing.assert_array_equal(side.data.numpy(), np.asarray(jside.data))
        # The s16 tag keeps the gain's clamp-then-truncate path: bitwise.
        got = gain.apply_gain(side, 1.4).data.numpy()
        want = np.asarray(jgain.apply_gain(jside, 1.4).data)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bias", [-1.0, 0.0, 0.3, 1.0])
def test_bimix_matches_jax_with_unequal_sides(bias):
    # A stereo 44.1 kHz left side of 0.3 s and a mono 44.1 kHz right side
    # of 0.2 s (upmixed -3 dB, then averaged).
    left, jleft = _streams(_signal(2, 13_230, seed=1), 44_100)
    right, jright = _streams(_signal(1, 8_820, seed=2), 44_100)
    got = mix.bimix(left, right, bias)
    want = jmix.bimix(jleft, jright, bias)
    assert (got.rate, got.channels, got.fmt) == (48_000, 2, "flt")
    assert got.length == int(want.length) == 14_400
    assert got.data.shape == want.data.shape
    assert np.abs(got.data.numpy() - np.asarray(want.data)).max() <= TOL


def test_chunk_helpers_match_jax():
    stereo = _signal(2, 256, seed=3)
    mono = _signal(1, 256, seed=4)
    for data in (stereo, mono):
        spec = chunkflow.ChunkSpec(rate=RATE, channels=data.shape[0],
                                   fmt="flt", width=256)
        jspec = jchunkflow.ChunkSpec(rate=RATE, channels=data.shape[0],
                                     fmt="flt", width=256)
        chunk = chunkflow.ChunkStream(torch.from_numpy(data), 200, False, spec)
        jchunk = jchunkflow.ChunkStream(jnp.asarray(data), jnp.int32(200),
                                        jnp.bool_(False), jspec)
        for fn, jfn in ((chunkflow.to_mono_chunk, jchunkflow.to_mono_chunk),
                        (chunkflow.side_mono_chunk,
                         jchunkflow.side_mono_chunk)):
            got, want = fn(chunk), jfn(jchunk)
            assert got.spec.channels == want.spec.channels == 1
            assert got.n == 200
            np.testing.assert_array_equal(got.data.numpy(),
                                          np.asarray(want.data))


# -- bimix_v2 placement ----------------------------------------------------------


def _golden(left, right, t0_l_us, t0_r_us):
    """tests/test_bimix_alignment.py's golden: each side's mono mean placed
    at its rounded start offset, zeros elsewhere."""
    t0 = min(t0_l_us, t0_r_us)
    off_l = round((t0_l_us - t0) * 1e-6 * RATE)
    off_r = round((t0_r_us - t0) * 1e-6 * RATE)
    mono_l = (left[0] + left[1]) * np.float32(0.5)
    mono_r = (right[0] + right[1]) * np.float32(0.5)
    n = max(off_l + mono_l.shape[0], off_r + mono_r.shape[0])
    out = np.zeros((2, n), dtype=np.float32)
    out[0, off_l : off_l + mono_l.shape[0]] = mono_l
    out[1, off_r : off_r + mono_r.shape[0]] = mono_r
    return out


def _v2_graph(graph_cls, input_cls, bimix_cls, output_cls):
    g = graph_cls()
    src = g.add_node(input_cls())
    g.nodes[src].processor.file_paths = ["l.wav", "r.wav"]
    g.update_node_pin(src)
    merge = g.add_node(bimix_cls())
    out = g.add_node(output_cls())

    def pin(n, p):
        return g.nodes[n].pin_name_map[p]

    g.add_link(pin(src, "output_0"), pin(merge, "input_l"))
    g.add_link(pin(src, "output_1"), pin(merge, "input_r"))
    g.add_link(pin(merge, "output"), pin(out, "input"))
    return g, src


def _jax_v2(sides, rate):
    jregistry.register_all_processors()
    g, src = _v2_graph(JGraph, JAudioInput, JAudioBimixV2, JAudioOutput)
    arrays, lengths, sources = {}, {}, {}
    for pin, (data, t0) in zip(("output_0", "output_1"), sides):
        key = jcompiler.external_key(src, pin)
        arrays[key], lengths[key] = data, data.shape[1]
        sources[(src, pin)] = jcompiler.SourceSpec(
            rate=rate, channels=2, fmt="flt", capacity=data.shape[1],
            t0_us=t0)
    master, length = jcompiler.compile_graph(g, sources, mode="export").run(
        arrays, lengths)["master"]
    return np.asarray(master)[:, : int(length)]


def _port_v2(sides, rate, chunk=None):
    """The port's bimix_v2 graph on the CPU: offline, or streamed through
    its chunk steps at ``chunk`` samples a step."""
    register_all_processors()
    g, src = _v2_graph(Graph, AudioInput, AudioBimixV2, AudioOutput)
    pins = ("output_0", "output_1")
    if chunk is None:
        sources, args = {}, {}
        for pin, (data, t0) in zip(pins, sides):
            sources[(src, pin)] = compiler.SourceSpec(
                rate=rate, channels=2, fmt="flt", capacity=data.shape[1],
                t0_us=t0)
            args[compiler.external_key(src, pin)] = (torch.from_numpy(data),
                                                     data.shape[1])
        outputs, _ = compiler.compile_graph(g, sources, device="cpu")(args)
        master, length = outputs["master"]
        return master[:, :length].numpy()
    sources = {(src, pin): compiler.SourceSpec(
        rate=rate, channels=2, fmt="flt", capacity=chunk, t0_us=t0)
        for pin, (_, t0) in zip(pins, sides)}
    sc = chunkflow.compile_stream_graph(g, sources, device="cpu")
    full = {compiler.external_key(src, pin): data
            for pin, (data, _) in zip(pins, sides)}
    states, pos, pieces = sc.init_states, 0, []
    for _ in range(200):
        args = {}
        for key, data in full.items():
            n = max(0, min(chunk, data.shape[1] - pos))
            block = torch.zeros((2, chunk))
            block[:, :n] = torch.from_numpy(data[:, pos : pos + n])
            args[key] = (block, n, pos + n >= data.shape[1])
        pos += chunk
        states, outs = sc.step(states, args)
        data, n, done = outs["master"]
        pieces.append(data[:, :n].numpy())
        if done:
            break
    assert done, "the streamed bimix_v2 did not drain"
    return np.concatenate(pieces, axis=1)


V2_CASES = {
    # name: (left samples, right samples, t0 left, t0 right)
    "disjoint": (RATE // 5, RATE // 5, 0.0, 500_000.0),
    "partial overlap": (RATE, RATE, 0.0, 250_000.0),
    "fractional rounding": (2_048, 2_048, 0.0, 13_021.0),
    "one-sided tail": (RATE, RATE // 4, 0.0, 0.0),
}


@pytest.mark.parametrize("case", sorted(V2_CASES))
def test_bimix_v2_alignment_offline_and_streamed(case):
    n_l, n_r, t0_l, t0_r = V2_CASES[case]
    sides = [(_signal(2, n_l, seed=11), t0_l), (_signal(2, n_r, seed=12), t0_r)]
    want = _golden(sides[0][0], sides[1][0], t0_l, t0_r)
    np.testing.assert_array_equal(_jax_v2(sides, RATE), want)
    np.testing.assert_array_equal(_port_v2(sides, RATE), want)
    np.testing.assert_array_equal(_port_v2(sides, RATE, chunk=4_800), want)


def test_bimix_v2_through_the_resampler_matches_jax():
    """44.1 kHz sides, the right one (0.3 s) starting 0.4 s after the left
    (0.5 s): its offset is 19,200 samples of the 48 kHz grid, after its
    resampler (2e-6), streamed as offline."""
    sides = [(_signal(2, 22_050, seed=13), 0.0),
             (_signal(2, 13_230, seed=14), 400_000.0)]
    want = _jax_v2(sides, 44_100)
    got = _port_v2(sides, 44_100)
    streamed = _port_v2(sides, 44_100, chunk=4_410)
    assert got.shape == streamed.shape == want.shape == (2, 19_200 + 14_400)
    assert np.abs(got - want).max() <= TOL
    assert np.abs(streamed - got).max() <= TOL


# -- nodes -------------------------------------------------------------------


def test_the_port_registers_the_three_nodes():
    register_all_processors()
    for identifier, cls in (("audio_split", AudioSplit),
                            ("audio_bimix", AudioBimix),
                            ("audio_bimix_v2", AudioBimixV2)):
        assert processor_map[identifier].generate is cls
    # 11 node types of the earlier slices, the seven master-bus nodes, the
    # eight single-input effects, and the generator, crossfade, trim and
    # reverse.
    assert len(processor_map) == 30


@pytest.mark.parametrize("make_jax,make_port,edit", [
    (JAudioSplit, AudioSplit, lambda p: None),
    (JAudioBimix, AudioBimix, lambda p: p.set_bias(0.35)),
    (JAudioBimix, AudioBimix, lambda p: p.set_bias(-7.0)),
    (JAudioBimixV2, AudioBimixV2, lambda p: None),
])
def test_node_serde_pins_and_param_spec_equal_the_jax_nodes(make_jax,
                                                            make_port, edit):
    for make_from, make_to in ((make_jax, make_port), (make_port, make_jax)):
        src = make_from()
        edit(src)
        blob = src.serialize()
        dst = make_to()
        dst.deserialize(json.loads(json.dumps(blob)))
        assert json.dumps(dst.serialize()) == json.dumps(blob)
        assert dst.info().identifier == src.info().identifier
        assert dst.info().display_name == src.info().display_name
        assert dst.info().description == src.info().description
        assert [(a.identifier, a.display_name, a.is_input)
                for a in dst.pin_attributes()] == \
            [(a.identifier, a.display_name, a.is_input)
             for a in src.pin_attributes()]
        assert dst.param_spec() == src.param_spec()


@pytest.mark.parametrize("value", [
    {"bias": True}, {"bias": "0.5"}, {"bias": None}, {}, [0.5], 0.5,
])
def test_bimix_refuses_the_bias_values_jax_refuses(value):
    with pytest.raises(JProcessorRuntimeError) as jinfo:
        JAudioBimix().deserialize(value)
    with pytest.raises(ProcessorRuntimeError) as info:
        AudioBimix().deserialize(value)
    assert (info.value.message, info.value.explanation, info.value.detail) \
        == (jinfo.value.message, jinfo.value.explanation, jinfo.value.detail)


@pytest.mark.parametrize("value", [-3, -1.0, 0, 0.25, 1, 2.5])
def test_bimix_clamps_the_bias_as_jax_does(value):
    node, jnode = AudioBimix(), JAudioBimix()
    node.deserialize({"bias": value})
    jnode.deserialize({"bias": value})
    assert node.bias == jnode.bias
    node.set_bias(value * 3)
    jnode.set_bias(value * 3)
    assert node.bias == jnode.bias


def test_missing_inputs_raise_the_jax_errors():
    for port_node, jax_node, inputs in (
            (AudioSplit(), JAudioSplit(), {}),
            (AudioBimix(), JAudioBimix(), {"input_l": object()}),
            (AudioBimixV2(), JAudioBimixV2(), {"input_r": object()})):
        with pytest.raises(JProcessorRuntimeError) as jinfo:
            jax_node.lower(None, inputs)
        with pytest.raises(ProcessorRuntimeError) as info:
            port_node.lower(None, inputs)
        assert (info.value.message, info.value.detail) == \
            (jinfo.value.message, jinfo.value.detail)


def test_project_with_the_three_nodes_round_trips_byte_equal():
    jregistry.register_all_processors()
    g = JGraph()
    src = g.add_node(JAudioInput())
    g.nodes[src].processor.file_paths = ["a.wav", "b.wav"]
    g.update_node_pin(src)
    split = g.add_node(JAudioSplit())
    v1 = g.add_node(JAudioBimix())
    g.nodes[v1].processor.set_bias(-0.4)
    v2 = g.add_node(JAudioBimixV2())
    amix = g.add_node(JAudioAmix())
    out = g.add_node(JAudioOutput())

    def pin(n, p):
        return g.nodes[n].pin_name_map[p]

    g.add_link(pin(src, "output_0"), pin(split, "input"))
    g.add_link(pin(split, "output_l"), pin(v1, "input_l"))
    g.add_link(pin(split, "output_r"), pin(v1, "input_r"))
    g.add_link(pin(src, "output_1"), pin(v2, "input_l"))
    g.add_link(pin(split, "output_l"), pin(v2, "input_r"))
    g.add_link(pin(v1, "output"), pin(amix, "input_1"))
    g.add_link(pin(v2, "output"), pin(amix, "input_2"))
    g.add_link(pin(amix, "output"), pin(out, "input"))
    text = json.dumps(g.serialize(), indent=2)
    tg = Graph.deserialize(json.loads(text))
    assert json.dumps(tg.serialize(), indent=2) == text
    assert json.dumps(JGraph.deserialize(json.loads(json.dumps(
        tg.serialize(), indent=2))).serialize(), indent=2) == text
    tg.check_graph()
    assert tg.nodes[v1].processor.bias == -0.4


@pytest.mark.parametrize("make_jax,make_port,edit", [
    (JAudioInput, AudioInput,
     lambda p: setattr(p, "file_paths", ["a.wav", "b.wav"])),
    (JAudioVol, AudioVol, lambda p: p.set_volume(1.7)),
    (JAudioAmix, AudioAmix,
     lambda p: (p.set_input_num(3), p.set_volume_at([1, 0.25]))),
    (JAudioSpectrum, AudioSpectrum, lambda p: None),
    (JAudioSpectrum, AudioSpectrum, lambda p: p.deserialize(
        {"n_fft": 8_192, "hop": 300})),
])
def test_param_spec_equals_the_jax_nodes(make_jax, make_port, edit):
    port, jax_node = make_port(), make_jax()
    edit(port)
    edit(jax_node)
    assert port.param_spec() is not None
    assert port.param_spec() == jax_node.param_spec()
    assert json.dumps(port.serialize()) == json.dumps(jax_node.serialize())
