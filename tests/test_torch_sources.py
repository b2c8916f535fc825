"""The port's signal generator (``ops/oscillator.py``,
``processors/generator.py``) and the core work a source with no host feed
needs (``LowerCtx.device``, ``StreamPlanCtx.hints``, the executor's
generator branch), against the JAX package, on the CPU.

- Every waveform of the port's offline op matches the float64 mirror at the
  JAX test's bar (> 125 dB, tests/test_generator.py:62-70); square, saw,
  triangle and noise are bitwise the JAX ``generator_stream``, the sine
  within 3e-7 of it (torch's ``sin`` against XLA's).
- The node's chunk steps (a partial last chunk) equal its offline render:
  bitwise but for the sine, which may differ by one ulp on the CPU, where
  torch's ``sin`` takes a vectorised path for the bulk of a tensor and a
  scalar one for its tail.
- The int64 Murmur3 finalizer is bitwise the numpy mirror's uint32 one over
  edge words, and the noise bitwise the JAX ``noise_block`` at edge seeds
  and near the int32 position limit.
- A generator-only graph renders with no source (bitwise the JAX render)
  and exports streamed, into a WAV, bitwise its offline export; a
  generator mixed with a decoded source streams through ``plan_hints``
  within 3e-7 of the offline render; the executor's hint widths follow
  the rate-gcd quantum.
- Serde, clamps, ``param_spec``, info and pins equal the JAX node's.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nodey_tpu.core import compiler as jcompiler
from nodey_tpu.core import registry as jregistry
from nodey_tpu.core import stream_executor as jstream_executor
from nodey_tpu.core.graph import Graph as JGraph
from nodey_tpu.ops import oscillator as josc
from nodey_tpu.processors.audio_output import AudioOutput as JOutput
from nodey_tpu.processors.generator import AudioGenerator as JGenerator
from nodey_tpu_torch.convert import graph_from_jax
from nodey_tpu_torch.core import chunkflow, compiler
from nodey_tpu_torch.core.errors import ProcessorRuntimeError
from nodey_tpu_torch.core.graph import Graph
from nodey_tpu_torch.core.registry import register_all_processors
from nodey_tpu_torch.core.runner import Runner, RunnerState
from nodey_tpu_torch.core.stream_executor import StreamExecutor
from nodey_tpu_torch.host import decode as host_decode
from nodey_tpu_torch.ops import oscillator as osc
from nodey_tpu_torch.processors.amix import AudioAmix
from nodey_tpu_torch.processors.audio_input import AudioInput
from nodey_tpu_torch.processors.audio_output import AudioOutput
from nodey_tpu_torch.processors.generator import AudioGenerator

from conftest import snr_db

RATE = 48_000
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run the port's eager CPU ops on one thread (an oversubscribed
    intra-op pool spends more time in its barriers than in the ops under a
    parallel test run)."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def edited(cls, **params):
    node = cls()
    for key, value in params.items():
        node.set_param(key, value)
    return node


def pin(g, nid, name):
    return g.nodes[nid].pin_name_map[name]


class PlanCtx:
    """The contexts a node sees: the device, no hints, one clip."""

    node_id = 1
    device = CPU
    hints = {}
    batch = None


def node_offline(gen):
    """The port node's ``lower`` on the CPU: its valid samples."""
    out = gen.lower(PlanCtx(), {})["output"]
    assert out.length == gen.total_samples
    assert not out.data[:, out.length:].any()
    return out.data[:, :out.length].numpy()


def node_streamed(gen, width):
    """The port node's chunk steps at ``width`` (its plan hint): the valid
    samples of every step, concatenated."""
    ctx = chunkflow.StreamPlanCtx("export", {}, CPU,
                                  hints={1: {"chunk_width": width}})
    ctx.node_id = 1
    specs, state = gen.plan_stream(ctx, {})
    assert specs["output"].width == width
    pieces = []
    for _ in range(10_000):
        outs, state = gen.lower_stream(None, {}, state)
        chunk = outs["output"]
        assert not chunk.data[:, chunk.n:].any()
        pieces.append(chunk.data[:, :chunk.n].numpy())
        if chunk.done:
            return np.concatenate(pieces, axis=1)
    raise AssertionError("the generator never signalled done")


def jax_offline(kind, freq, gain, seed, channels, total):
    capacity = -(-total // 256) * 256
    data = jax.jit(lambda: josc.generator_stream(
        kind, freq, gain, seed, RATE, channels, total, capacity).data)()
    return np.asarray(data)[:, :total]


def ulps(a, b):
    """|a - b| in units of the last place of ``a`` (float32)."""
    return np.abs(a.astype(np.float64) - b) / np.spacing(np.abs(a))


# -- the ops -------------------------------------------------------------------


@pytest.mark.parametrize("kind", osc.WAVEFORMS)
def test_waveform_matches_the_jax_op_and_the_float64_mirror(kind):
    gen = edited(AudioGenerator, waveform=kind, freq=440.7, duration_s=0.8,
                 seed=3)
    got = node_offline(gen)
    ref = osc.generator_reference(kind, gen.freq, gen._gain(), gen.seed,
                                  RATE, 2, gen.total_samples)
    assert snr_db(ref, got) > 125.0
    want = jax_offline(kind, gen.freq, gen._gain(), gen.seed, 2,
                       gen.total_samples)
    assert got.shape == want.shape == (2, 38_400)
    if kind == "sine":
        np.testing.assert_allclose(got, want, rtol=0.0, atol=3e-7)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", osc.WAVEFORMS)
def test_streamed_equals_offline_with_a_partial_last_chunk(kind):
    gen = edited(AudioGenerator, waveform=kind, freq=333.3, duration_s=1.3,
                 seed=11)
    off = node_offline(gen)
    width = 4_096
    assert gen.total_samples % width != 0
    got = node_streamed(gen, width)
    assert got.shape == off.shape
    if kind == "sine":
        # One ulp at most (torch's CPU sin: vector bulk, scalar tail).
        assert ulps(off, got).max() <= 1.0
    else:
        np.testing.assert_array_equal(got, off)


def test_square_is_exactly_the_gain_with_an_integer_period():
    gen = edited(AudioGenerator, waveform="square", freq=1_000.0,
                 level_db=-6.0, duration_s=0.25)
    out = node_offline(gen)
    g = np.float32(gen._gain())
    assert set(np.unique(out)) == {g, -g}
    np.testing.assert_array_equal(out[:, :-48], out[:, 48:])
    assert out[0, :48].sum() == 0.0


def test_fmix32_is_bitwise_the_numpy_mirror_over_edge_words():
    rng = np.random.default_rng(0)
    words = np.concatenate([
        np.array([0, 1, 2**16 - 1, 2**16, 2**31 - 1, 2**31, 2**31 + 1,
                  2**32 - 2, 2**32 - 1], dtype=np.uint64),
        rng.integers(0, 2**32, 4_096, dtype=np.uint64)])
    got = osc._fmix32(torch.from_numpy(words.astype(np.int64)))
    with np.errstate(over="ignore"):
        want = osc._fmix32_np(words.astype(np.uint32))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 2**31 - 1])
def test_noise_is_bitwise_the_jax_noise_at_edge_seeds_and_positions(seed):
    for pos0 in (0, 2**31 - 1 - 1_000):
        for channel in (0, 1):
            got = osc.noise_block(seed, channel, pos0, 1_000, 0.3, CPU)
            want = josc.noise_block(seed, channel, jnp.int32(pos0), 1_000,
                                    0.3)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            i = np.arange(pos0, pos0 + 1_000, dtype=np.int64)
            key = np.uint32((seed * 0x9E3779B9 + channel * 0x7FEB352D)
                            & 0xFFFFFFFF)
            with np.errstate(over="ignore"):
                h = osc._fmix32_np(i.astype(np.uint32) ^ key)
            mirror = (h >> 9).astype(np.float64) * 2.0 ** -22 - 1.0
            np.testing.assert_allclose(got.numpy(), 0.3 * mirror,
                                       rtol=0.0, atol=3e-8)


# -- graphs --------------------------------------------------------------------


def generator_graph(cls_gen, cls_out, graph_cls, **params):
    g = graph_cls()
    nid = g.add_node(edited(cls_gen, **params))
    out = g.add_node(cls_out())
    g.add_link(pin(g, nid, "output"), pin(g, out, "input"))
    return g, nid


def test_generator_only_graph_renders_offline_with_no_source():
    register_all_processors()
    jregistry.register_all_processors()
    params = dict(waveform="noise", duration_s=0.4, seed=5, level_db=-9.0)
    tg, nid = generator_graph(AudioGenerator, AudioOutput, Graph, **params)
    data, n = compiler.compile_graph(tg, {}, device="cpu")({})[0]["master"]
    assert n == round(0.4 * RATE)
    got = data[:, :n].numpy()
    np.testing.assert_array_equal(got, node_offline(
        tg.nodes[nid].processor))
    jg, _ = generator_graph(JGenerator, JOutput, JGraph, **params)
    jdata, jn = jcompiler.compile_graph(jg, {}, mode="export").run(
        {}, {})["master"]
    np.testing.assert_array_equal(got, np.asarray(jdata)[:, :int(jn)])
    assert Runner(tg, device="cpu").render().master.shape == (2, n)


def test_generator_only_graph_exports_streamed_as_offline(tmp_path):
    register_all_processors()

    def build():
        return generator_graph(AudioGenerator, AudioOutput, Graph,
                               waveform="saw", freq=110.0, duration_s=0.9,
                               level_db=-12.0)[0]

    st, off = str(tmp_path / "streamed.wav"), str(tmp_path / "offline.wav")
    runner = Runner(build(), device="cpu")
    seen = []
    metrics = runner.export_streamed(st, progress=seen.append,
                                     chunk_seconds=0.25)
    assert metrics.mode == "streamed" and runner.state is RunnerState.FINISHED
    assert runner.last_stream_metrics.steps == 4
    assert seen[-1] == 0.9
    Runner(build(), device="cpu").export(off)
    a, b = host_decode.decode_file(st), host_decode.decode_file(off)
    assert a.num_samples == b.num_samples == round(0.9 * RATE)
    np.testing.assert_array_equal(a.data, b.data)


def mixed_graph(path, graph_cls, input_cls, gen_cls, amix_cls, out_cls):
    """A decoded track and a 97 Hz triangle generator -> amix -> output
    (tests/test_generator.py:130-171), in either package."""
    g = graph_cls()
    src = g.add_node(input_cls())
    g.nodes[src].processor.file_paths = [path]
    g.update_node_pin(src)
    gen = g.add_node(edited(gen_cls, waveform="triangle", freq=97.0,
                            duration_s=0.7, level_db=-18.0))
    mix = g.add_node(amix_cls())
    out = g.add_node(out_cls())
    g.add_link(pin(g, src, "output_0"), pin(g, mix, "input_1"))
    g.add_link(pin(g, gen, "output"), pin(g, mix, "input_2"))
    g.add_link(pin(g, mix, "output"), pin(g, out, "input"))
    return g, src, gen


def test_generator_merges_with_a_decoded_source_through_plan_hints():
    from nodey_tpu.processors.amix import AudioAmix as JAmix
    from nodey_tpu.processors.audio_input import AudioInput as JInput

    register_all_processors()
    jregistry.register_all_processors()
    rng = np.random.default_rng(5)
    x = (0.3 * rng.standard_normal((2, RATE))).astype(np.float32)
    tg, src, gen = mixed_graph("a.wav", Graph, AudioInput, AudioGenerator,
                               AudioAmix, AudioOutput)
    key = compiler.external_key(src, "output_0")
    spec = dict(rate=RATE, channels=2, fmt="flt", capacity=RATE)
    data, n = compiler.compile_graph(
        tg, {(src, "output_0"): compiler.SourceSpec(**spec)},
        device="cpu")({key: (torch.from_numpy(x), RATE)})[0]["master"]
    assert n == RATE                    # the mix drains the longer input
    off = data[:, :n].numpy()
    jg, _, _ = mixed_graph("a.wav", JGraph, JInput, JGenerator, JAmix,
                           JOutput)
    jdata, jn = jcompiler.compile_graph(
        jg, {(src, "output_0"): jcompiler.SourceSpec(**spec)},
        mode="export").run({key: x}, {key: RATE})["master"]
    np.testing.assert_allclose(off, np.asarray(jdata)[:, :int(jn)],
                               rtol=0.0, atol=3e-7)

    chunk = 4_800
    sc = chunkflow.compile_stream_graph(
        tg, {(src, "output_0"): compiler.SourceSpec(
            **{**spec, "capacity": chunk})},
        device="cpu", plan_hints={gen: {"chunk_width": chunk}})
    states, pieces = sc.init_states, []
    for step in range(64):
        lo = step * chunk
        m = max(0, min(chunk, RATE - lo))
        block = torch.zeros((2, chunk))
        block[:, :m] = torch.from_numpy(x[:, lo:lo + m])
        states, outs = sc.step(states, {key: (block, m, lo + chunk >= RATE)})
        out, k, done = outs["master"]
        pieces.append(out[:, :k].numpy())
        if done:
            break
    got = np.concatenate(pieces, axis=1)
    assert got.shape == off.shape
    np.testing.assert_allclose(got, off, rtol=0.0, atol=3e-7)


def test_executor_hint_widths_follow_the_rate_gcd_quantum(tmp_path):
    """A 44.1 kHz track and a 48 kHz generator at 16 s chunks: the quantum
    is 1/300 s, so the feed takes 705,600 samples a step and the generator
    768,000 (chip_smoke phase 29's path (c)); the JAX executor plans the
    same hints. With neither a feed nor a generator both raise the same
    error."""
    register_all_processors()
    jregistry.register_all_processors()
    path = str(tmp_path / "a.wav")
    host_decode.write_wav_s16(path, np.zeros((2, 4_410), np.float32),
                              44_100)
    from nodey_tpu.processors.amix import AudioAmix as JAmix
    from nodey_tpu.processors.audio_input import AudioInput as JInput

    tg, src, gen = mixed_graph(path, Graph, AudioInput, AudioGenerator,
                               AudioAmix, AudioOutput)
    executor = StreamExecutor(tg, chunk_seconds=16.0, device="cpu")
    feeds, sources, hints = executor._open_feeds()
    for feed in feeds.values():
        feed.stop()
    assert sources[(src, "output_0")].capacity == 705_600
    assert hints == {gen: {"chunk_width": 768_000}}
    jg, _, _ = mixed_graph(path, JGraph, JInput, JGenerator, JAmix, JOutput)
    jfeeds, _jsources, jhints = jstream_executor.StreamExecutor(
        jg, chunk_seconds=16.0)._open_feeds()
    for feed in jfeeds.values():
        feed.stop()
    assert jhints == hints

    empty = Graph()
    empty.add_node(AudioOutput())
    jempty = JGraph()
    jempty.add_node(JOutput())
    with pytest.raises(ProcessorRuntimeError) as port_error:
        StreamExecutor(empty, device="cpu")._open_feeds()
    with pytest.raises(Exception) as jax_error:
        jstream_executor.StreamExecutor(jempty)._open_feeds()
    assert (port_error.value.message, port_error.value.explanation) == (
        jax_error.value.message, jax_error.value.explanation)


# -- serde -----------------------------------------------------------------------


def test_serde_pins_and_param_spec_equal_the_jax_node():
    params = dict(waveform="noise", freq=99.5, level_db=-3.0,
                  duration_s=2.5, rate=44_100, channels=1, seed=42)
    for src_cls, dst_cls in ((AudioGenerator, JGenerator),
                             (JGenerator, AudioGenerator)):
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
    # Clamps and invalid values alike, never raising.
    node, jnode = edited(AudioGenerator, **params), edited(JGenerator,
                                                           **params)
    for key, value in (("freq", 10**9), ("level_db", 5.0),
                       ("waveform", "sawtooth-from-mars"), ("rate", 12_345),
                       ("channels", 7), ("duration_s", -1.0),
                       ("seed", 2**40)):
        node.set_param(key, value)
        jnode.set_param(key, value)
        assert node.serialize() == jnode.serialize()
    for blob in ({"seed": True}, {"waveform": 3}, None, {"freq": "x"}):
        node.deserialize(blob)
        jnode.deserialize(blob)
        assert node.serialize() == jnode.serialize()
    assert node.freq == 20_000.0 and node.level_db == 0.0
    assert node.waveform == "noise" and node.rate == 44_100
    assert node.channels == 1 and node.seed == 2**31 - 1


def test_a_jax_generator_graph_carries_into_the_port():
    jregistry.register_all_processors()
    jg, _ = generator_graph(JGenerator, JOutput, JGraph, waveform="sine",
                            freq=220.0, duration_s=0.4)
    tg = graph_from_jax(jg)
    assert json.dumps(tg.serialize()) == json.dumps(jg.serialize())
