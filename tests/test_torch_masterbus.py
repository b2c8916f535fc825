"""The seven master-bus nodes of the port (EQ, filter, compressor,
limiter, gate, de-esser, normalize) and their ops against the JAX
package, on the CPU.

For each node type, on seeded clips of 0.5-1 s:
- the node (its ``lower`` on one Stream) matches
  the JAX node, and its op the JAX package's float64 mirror, at the bar
  the JAX package's own test sets against that mirror (tests/test_biquad.py
  110 dB, tests/test_dynamics.py limiter atol 3e-7 and compressor 95 dB,
  tests/test_gate.py 110 dB, tests/test_deesser.py 90 dB,
  tests/test_loudness.py 0.05 LU);
- a one-node graph streamed through the port's chunk flow equals its
  offline render at those files' streamed bars (EQ and filter > 88 dB,
  limiter and compressor > 120 dB, gate > 110 dB, de-esser > 90 dB), and
  the limiter's and compressor's stream steps at 4,096-sample chunks
  their offline op within atol 3e-7 (tests/test_dynamics.py's op bar);
- where the JAX node passes its input through bitwise, so does the port's,
  offline and streamed;
- its serde is byte-equal to the JAX node's both ways, with equal
  ``param_spec``, info and pins, and ``graph_from_jax`` carries its live
  parameters.
The normalize node refuses streaming and ``Runner.export_streamed`` falls
back to the offline render. bench.py's config 6 (EQ -> compressor ->
limiter) at 2 s matches the JAX render, and streams.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from conftest import snr_db
from nodey_tpu.core import compiler as jcompiler
from nodey_tpu.core import registry as jregistry
from nodey_tpu.core.graph import Graph as JGraph
from nodey_tpu.core.stream import Stream as JStream
from nodey_tpu.ops import biquad as jbq
from nodey_tpu.ops import dynamics as jdyn
from nodey_tpu.ops import loudness as jld
from nodey_tpu.processors.audio_input import AudioInput as JAudioInput
from nodey_tpu.processors.audio_output import AudioOutput as JAudioOutput
from nodey_tpu.processors.compressor import AudioCompressor as JCompressor
from nodey_tpu.processors.deesser import AudioDeesser as JDeesser
from nodey_tpu.processors.equalizer import AudioEq as JEq
from nodey_tpu.processors.equalizer import AudioFilter as JFilter
from nodey_tpu.processors.gate import AudioGate as JGate
from nodey_tpu.processors.limiter import AudioLimiter as JLimiter
from nodey_tpu.processors.normalize import AudioNormalize as JNormalize
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
from nodey_tpu_torch.ops import biquad as bq
from nodey_tpu_torch.ops import dynamics as dyn
from nodey_tpu_torch.ops import loudness as ld
from nodey_tpu_torch.processors.audio_input import AudioInput
from nodey_tpu_torch.processors.audio_output import AudioOutput
from nodey_tpu_torch.processors.compressor import AudioCompressor
from nodey_tpu_torch.processors.deesser import AudioDeesser
from nodey_tpu_torch.processors.equalizer import AudioEq, AudioFilter
from nodey_tpu_torch.processors.gate import AudioGate
from nodey_tpu_torch.processors.limiter import AudioLimiter
from nodey_tpu_torch.processors.normalize import AudioNormalize

RATE = 48_000
CHUNK = 4_800


# -- signals (the JAX tests' shapes) -----------------------------------------


def noise(n, amp=0.3, seed=0):
    rng = np.random.default_rng(seed)
    return (amp * rng.standard_normal((2, n))).astype(np.float32)


def burst(n, seed=0):
    x = noise(n, 0.2, seed)
    x[:, 6000:6200] *= 8.0
    x[:, 15000:15050] *= 6.0
    return x


def gated(n, seed=0):
    """Loud phrase - near-silence (hiss) - loud phrase."""
    x = noise(n, 0.3, seed)
    x[:, n // 4: 3 * n // 4] *= 0.003
    return x


def sibilant(n, seed=0):
    """A broadband body plus a loud 6.5 kHz 'ess' in the middle third."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / RATE
    env = np.zeros(n)
    env[n // 3: 2 * n // 3] = 1.0
    x = 0.1 * rng.standard_normal((2, n)) \
        + 0.5 * np.sin(2 * np.pi * 6_500.0 * t) * env[None, :]
    return x.astype(np.float32)


# -- the node types ----------------------------------------------------------


def _set(**params):
    def edit(p):
        for key, value in params.items():
            if hasattr(p, f"set_{key}"):
                getattr(p, f"set_{key}")(value)
            else:
                p.set_param(key, value)
    return edit


def _mirror_biquad(x, node):
    return jbq.cascade_reference(x, node._design(RATE))


# name: (port class, JAX class, edit, signal, float64 mirror of the edited
#        node's op or None, node bar vs JAX and mirror: ("db", x) / ("atol", x),
#        streamed bar)
NODES = {
    "audio_eq": (
        AudioEq, JEq,
        _set(ls_gain_db=4.0, p1_freq=60.0, p1_gain_db=12.0, p1_q=10.0,
             p2_gain_db=-6.0, p2_q=2.0, hs_gain_db=-3.0),
        lambda n: noise(n), _mirror_biquad, ("db", 110.0), ("db", 88.0)),
    "audio_filter": (
        AudioFilter, JFilter, _set(filter_type="bandpass", freq=300.0, q=2.0),
        lambda n: noise(n), _mirror_biquad, ("db", 110.0), ("db", 88.0)),
    # tests/test_biquad.py::test_real_and_repeated_poles's section and bar.
    "audio_filter real poles": (
        AudioFilter, JFilter, _set(filter_type="lowpass", freq=500.0, q=0.4),
        lambda n: noise(n), _mirror_biquad, ("db", 120.0), ("db", 88.0)),
    "audio_compressor": (
        AudioCompressor, JCompressor,
        _set(threshold_db=-18.0, ratio=4.0, knee_db=6.0, attack_ms=5.0,
             release_ms=100.0, makeup_db=3.0),
        burst,
        lambda x, p: jdyn.compressor_reference(
            x, p.threshold_db, p.ratio, p.knee_db, p.attack_ms,
            p.release_ms, p.makeup_db, RATE),
        ("db", 95.0), ("db", 120.0)),
    "audio_limiter": (
        AudioLimiter, JLimiter, _set(threshold_db=-6.0, release_ms=50.0),
        burst,
        lambda x, p: jdyn.limiter_reference(x, p.threshold_db, p.release_ms,
                                            RATE),
        ("atol", 3e-7), ("db", 120.0)),
    "audio_gate": (
        AudioGate, JGate,
        _set(threshold_db=-40.0, ratio=4.0, range_db=60.0, attack_ms=1.0,
             release_ms=150.0),
        gated,
        lambda x, p: jdyn.gate_reference(x, p.threshold_db, p.ratio,
                                         p.range_db, p.attack_ms,
                                         p.release_ms, RATE),
        ("db", 110.0), ("db", 110.0)),
    "audio_deesser": (
        AudioDeesser, JDeesser,
        _set(threshold_db=-30.0, ratio=4.0, freq=6_500.0, q=1.0,
             attack_ms=1.0, release_ms=60.0),
        sibilant,
        lambda x, p: jdyn.deesser_reference(x, p.threshold_db, p.ratio,
                                            p.freq, p.q, p.attack_ms,
                                            p.release_ms, RATE),
        ("db", 90.0), ("db", 90.0)),
    "audio_normalize": (
        AudioNormalize, JNormalize, _set(target_db=-14.0),
        lambda n: noise(n, 0.05), None, ("lufs", 0.05), None),
}
STREAMING = sorted(k for k, v in NODES.items() if v[6] is not None)


def _nodes(name):
    cls, jcls, edit = NODES[name][:3]
    node, jnode = cls(), jcls()
    edit(node)
    edit(jnode)
    return node, jnode


def _agree(bar, want, got, what):
    kind, value = bar
    if kind == "atol":
        assert np.abs(got - want).max() <= value, what
    elif kind == "db":
        assert snr_db(want, got) > value, what
    else:
        gap = ld_lufs(got) - jld.loudness_reference(want, RATE)
        assert abs(gap) < value, what


def ld_lufs(x):
    return float(ld.integrated_lufs(torch.from_numpy(x), x.shape[1], RATE))


def _lower(node, x, length=None):
    length = x.shape[1] if length is None else length
    stream = Stream(data=torch.from_numpy(x), length=length, rate=RATE,
                    channels=x.shape[0])
    return node.lower(None, {"input": stream})["output"]


def _jlower(node, x, length=None):
    """The JAX node's ``lower`` on one Stream, under one ``jax.jit`` (a
    single compile costs less than the eager ops' many)."""
    length = x.shape[1] if length is None else length

    def lower(data):
        stream = JStream(data=data, length=jnp.int32(length), rate=RATE,
                         channels=x.shape[0])
        out = node.lower(None, {"input": stream})["output"]
        return out.data, out.length

    data, out_length = jax.jit(lower)(jnp.asarray(x))
    return JStream(data=data, length=out_length, rate=RATE,
                   channels=x.shape[0], fmt="flt")


def _graph(node):
    """audio_input -> ``node`` -> audio_output, in the port."""
    register_all_processors()
    g = Graph()
    src = g.add_node(AudioInput())
    g.nodes[src].processor.file_paths = ["a.wav"]
    g.update_node_pin(src)
    nid = g.add_node(node)
    out = g.add_node(AudioOutput())
    pin = lambda n, p: g.nodes[n].pin_name_map[p]  # noqa: E731
    g.add_link(pin(src, "output_0"), pin(nid, "input"))
    g.add_link(pin(nid, "output"), pin(out, "input"))
    return g, src


def _offline(g, src, x):
    key = compiler.external_key(src, "output_0")
    sources = {(src, "output_0"): compiler.SourceSpec(
        rate=RATE, channels=2, fmt="flt", capacity=x.shape[1])}
    outputs, meta = compiler.compile_graph(g, sources, device="cpu")(
        {key: (torch.from_numpy(x), x.shape[1])})
    data, length = outputs["master"]
    assert meta["master"]["fmt"] == "flt"
    return data[:, :length].numpy()


def _streamed(g, src, x, chunk=CHUNK):
    key = compiler.external_key(src, "output_0")
    sources = {(src, "output_0"): compiler.SourceSpec(
        rate=RATE, channels=2, fmt="flt", capacity=chunk)}
    sc = chunkflow.compile_stream_graph(g, sources, device="cpu")
    states, pos, pieces = sc.init_states, 0, []
    while True:
        n = max(0, min(chunk, x.shape[1] - pos))
        block = torch.zeros((2, chunk))
        block[:, :n] = torch.from_numpy(x[:, pos: pos + n])
        pos += chunk
        states, outs = sc.step(states, {key: (block, n, pos >= x.shape[1])})
        data, m, done = outs["master"]
        # The chunk's padding stays zero past its valid count.
        assert not data[:, m:].any()
        pieces.append(data[:, :m].numpy())
        if done:
            return np.concatenate(pieces, axis=1)


# -- ops and nodes against the JAX package -------------------------------------


@pytest.mark.parametrize("name", sorted(NODES))
def test_node_matches_the_jax_node_and_the_float64_mirror(name):
    node, jnode = _nodes(name)
    x = NODES[name][3](RATE // 2)
    got = _lower(node, x)
    want = _jlower(jnode, x)
    assert (got.length, got.rate, got.channels, got.fmt) == \
        (int(want.length), want.rate, want.channels, "flt")
    got, want = got.data.numpy(), np.asarray(want.data)
    assert got.shape == want.shape == x.shape
    assert np.isfinite(got).all()
    mirror, bar = NODES[name][4], NODES[name][5]
    _agree(bar, want, got, "port node vs JAX node")
    if mirror is not None:
        _agree(bar, mirror(x, jnode), got, "port node vs float64 mirror")
    else:
        assert abs(ld_lufs(got) - (-14.0)) < 0.1


@pytest.mark.parametrize("name", STREAMING)
def test_node_streams_as_it_renders_offline(name):
    node, _ = _nodes(name)
    # A ragged last chunk: 1 s and 123 samples at 4,800 samples a chunk.
    x = NODES[name][3](RATE + 123)
    g, src = _graph(node)
    off = _offline(g, src, x)
    got = _streamed(g, src, x)
    assert got.shape == off.shape == x.shape
    _agree(NODES[name][6], off, got, "streamed vs offline")


@pytest.mark.parametrize("name", ["audio_limiter", "audio_compressor"])
def test_dynamics_stream_steps_equal_the_offline_op(name):
    """tests/test_dynamics.py's streamed tests: 1 s of the burst signal in
    4,096-sample chunks against the whole-clip op, atol 3e-7."""
    x = burst(RATE)
    if name == "audio_limiter":
        T, c = dyn.limiter_params(-3.0, 80.0, RATE)
        full = dyn.limit_block(torch.from_numpy(x), T, c)[0]
        state = dyn.limiter_stream_init(2, torch.device("cpu"))

        def step(state, chunk, m):
            return dyn.limiter_stream_step(T, c, state, chunk, m)
    else:
        p = dyn.compressor_params(-18.0, 4.0, 6.0, 5.0, 100.0, 3.0, RATE)
        full = dyn.compress_block(torch.from_numpy(x), p)[0]
        dyn.compressor_stream_prepare(p, 4_096, torch.device("cpu"))
        state = dyn.compressor_stream_init(2, torch.device("cpu"))

        def step(state, chunk, m):
            return dyn.compressor_stream_step(p, state, chunk, m)
    outs = []
    for i in range(0, x.shape[1], 4_096):
        m = min(4_096, x.shape[1] - i)
        chunk = torch.zeros((2, 4_096))
        chunk[:, :m] = torch.from_numpy(x[:, i:i + m])
        state, out = step(state, chunk, m)
        assert not out[:, m:].any()
        outs.append(out[:, :m])
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), full.numpy(),
                               rtol=0, atol=3e-7)


PASSTHROUGH = {
    # name: (edit, signal, first sample held bitwise)
    "audio_eq": (_set(), lambda n: noise(n), 0),
    "audio_limiter": (_set(threshold_db=-6.0),
                      lambda n: noise(n, 0.1, seed=3), 0),
    "audio_compressor": (_set(makeup_db=0.0),
                         lambda n: noise(n, 0.02, seed=5), 0),
    # The gate opens at the attack rate from a closed start.
    "audio_gate": (_set(threshold_db=-30.0, release_ms=100.0),
                   lambda n: np.where(noise(n, 1.0, 3) < 0, -0.6, 0.6)
                   .astype(np.float32), 2_000),
    "audio_deesser": (_set(threshold_db=-20.0, ratio=8.0),
                      lambda n: noise(n, 0.001, seed=1), 0),
}


@pytest.mark.parametrize("name", sorted(PASSTHROUGH))
def test_passthrough_is_bitwise_offline_and_streamed(name):
    edit, signal, start = PASSTHROUGH[name]
    node, jnode = NODES[name][0](), NODES[name][1]()
    edit(node)
    edit(jnode)
    x = signal(RATE // 2)
    got = _lower(node, x).data.numpy()
    np.testing.assert_array_equal(got[:, start:], x[:, start:])
    np.testing.assert_array_equal(
        got[:, start:], np.asarray(_jlower(jnode, x).data)[:, start:])
    g, src = _graph(node)
    np.testing.assert_array_equal(_streamed(g, src, x)[:, start:],
                                  x[:, start:])


def test_ops_keep_the_padding_zero_and_match_jax():
    """A Stream's samples past ``length`` stay zero through every op (the
    filter rings past it); the masked offline op equals the JAX op."""
    x = noise(6_000)
    x[:, 4_000:] = 0.0
    x[:, 3_900:4_000] = 0.5
    node, jnode = _nodes("audio_eq")
    out = _lower(node, x, length=4_000).data.numpy()
    assert not out[:, 4_000:].any()
    assert snr_db(np.asarray(_jlower(jnode, x, length=4_000).data), out) \
        > 110.0
    for name in ("audio_deesser", "audio_limiter", "audio_compressor",
                 "audio_gate"):
        node, _ = _nodes(name)
        assert not _lower(node, x, length=4_000).data.numpy()[:, 4_000:].any()


def test_biquad_designs_and_sections_equal_the_jax_package():
    designs = [bq.peaking(1_000, -6.0, 2.0, RATE), bq.low_shelf(100, 4.0, RATE),
               bq.high_shelf(8_000, -3.0, RATE), bq.lowpass(500, 0.5, RATE),
               bq.highpass(80, 0.45, RATE), bq.bandpass(6_500, 1.0, 44_100),
               bq.notch(1_000, 4.0, RATE), *ld.k_weight_coeffs(RATE),
               *ld.k_weight_coeffs(44_100)]
    jdesigns = [jbq.peaking(1_000, -6.0, 2.0, RATE),
                jbq.low_shelf(100, 4.0, RATE), jbq.high_shelf(8_000, -3.0, RATE),
                jbq.lowpass(500, 0.5, RATE), jbq.highpass(80, 0.45, RATE),
                jbq.bandpass(6_500, 1.0, 44_100), jbq.notch(1_000, 4.0, RATE),
                *jld.k_weight_coeffs(RATE), *jld.k_weight_coeffs(44_100)]
    for got, want in zip(designs, jdesigns):
        sec, jsec = bq.prepare(got), jbq.prepare(want)
        assert vars(got.f32()) == vars(want.f32())
        assert (vars(sec.coef), sec.conj, sec.p, sec.g, sec.p2) == \
            (vars(jsec.coef), jsec.conj, jsec.p, jsec.g, jsec.p2)


def test_loudness_matches_jax_and_the_calibration_anchor():
    """BS.1770-4: a 0 dBFS 997 Hz sine in one channel reads -3.01 LKFS;
    0.6 s of noise (three gating blocks) at 48 and 44.1 kHz within 0.05 LU
    of the JAX op and mirror."""
    t = np.arange(2 * RATE) / RATE
    x = np.zeros((2, t.size), np.float32)
    x[0] = np.sin(2 * np.pi * 997.0 * t)
    assert abs(ld_lufs(x) - (-3.01)) < 0.05
    rng = np.random.default_rng(0)
    for rate in (48_000, 44_100):
        n = int(0.6 * rate)
        x = (0.2 * rng.standard_normal((2, n))).astype(np.float32)
        got = float(ld.integrated_lufs(torch.from_numpy(x), n, rate))
        want = float(jax.jit(jld.integrated_lufs, static_argnums=2)(
            jnp.asarray(x), jnp.int32(n), rate))
        assert abs(got - want) < 0.05
        assert abs(got - jld.loudness_reference(x, rate)) < 0.05
    node = AudioNormalize()
    node.set_mode("peak")
    node.set_param("target_db", -1.0)
    out = _lower(node, noise(RATE // 4)).data.numpy()
    assert abs(20 * np.log10(np.abs(out).max()) - (-1.0)) < 0.01
    silence = np.zeros((2, RATE // 4), np.float32)
    for mode in ("lufs", "peak"):
        node.set_mode(mode)
        np.testing.assert_array_equal(_lower(node, silence).data.numpy(),
                                      silence)


def test_no_complex_dtype_reaches_an_op():
    """The modal scan runs on split re/im float32 tensors: no operation of
    a cascade (offline or a chunk step) or of a detector takes or makes a
    complex tensor (the counterpart of tests/test_biquad.py::
    test_no_complex_dtypes_in_device_program)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Dtypes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for value in (*args, *(kwargs or {}).values(), out):
                for t in value if isinstance(value, (tuple, list)) \
                        else (value,):
                    if isinstance(t, torch.Tensor):
                        self.seen.add(t.dtype)
            return out

    eq, _ = _nodes("audio_eq")
    sections = bq.prepare_all(eq._design(RATE))
    x = torch.from_numpy(noise(4_096))
    cpu = torch.device("cpu")
    with Dtypes() as mode:
        bq.cascade_apply(x, sections)
        bq.cascade_stream_step(sections,
                               bq.cascade_stream_init(2, sections, cpu), x,
                               4_000)
        dyn.compress_block(x, dyn.compressor_params(-18.0, 4.0, 6.0, 5.0,
                                                    100.0, 0.0, RATE))
    assert torch.float32 in mode.seen
    assert not any(dtype.is_complex for dtype in mode.seen), mode.seen


def test_cli_validates_previews_and_streams_the_seven_nodes(tmp_path,
                                                            capsys):
    """`validate`, `run --preview` and `run --export --stream` on the CPU
    accept a project holding all seven nodes; with normalize in the graph
    the streamed export renders offline, as the CLI reports."""
    from nodey_tpu_torch.app import cli

    path = str(tmp_path / "a.wav")
    host_decode.write_wav_s16(path, sibilant(RATE // 2, seed=4), RATE)
    project = tmp_path / "seven.json"
    project.write_text(json.dumps(_jax_chain([path]).serialize()))
    assert cli.main(["validate", str(project)]) == 0
    assert cli.main(["run", str(project), "--preview",
                     str(tmp_path / "p.wav"), "--device", "cpu"]) == 0
    assert cli.main(["run", str(project), "--export",
                     str(tmp_path / "s.wav"), "--stream", "--device",
                     "cpu"]) == 0
    out = capsys.readouterr().out
    assert "(offline)" in out
    preview = host_decode.decode_file(str(tmp_path / "p.wav")).data
    assert preview.shape == (2, RATE // 2) and np.isfinite(preview).all()
    assert np.abs(preview).max() <= 1.0


# -- serde, registration, conversion ------------------------------------------


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
    # Hand-edited files clamp (or are refused) alike.
    node, jnode = NODES[name][0](), NODES[name][1]()
    edits = {key: 1e9 for key in node.serialize()}
    edits.update({"filter_type": "nonsense", "mode": 3, "q": -1.0})
    node.deserialize(edits)
    jnode.deserialize(edits)
    assert node.serialize() == jnode.serialize()


def test_the_port_registers_the_seven_master_bus_nodes():
    register_all_processors()
    for identifier, cls in (
            ("audio_eq", AudioEq), ("audio_filter", AudioFilter),
            ("audio_compressor", AudioCompressor),
            ("audio_limiter", AudioLimiter), ("audio_gate", AudioGate),
            ("audio_deesser", AudioDeesser),
            ("audio_normalize", AudioNormalize)):
        assert processor_map[identifier].generate is cls
        # Not time-invariant: no overlap-discard chunked render.
        assert identifier not in _LTI_NODES
        g, _ = _graph(cls())
        assert stream_supported(g) and not supports_chunked(g)
    # With the eight single-input effects and the generator, crossfade, trim
    # and reverse beside them.
    assert len(processor_map) == 30


def _jax_chain(paths):
    """audio_input -> the seven nodes, each edited -> audio_output, in the
    JAX package."""
    jregistry.register_all_processors()
    g = JGraph()
    src = g.add_node(JAudioInput())
    g.nodes[src].processor.file_paths = list(paths)
    g.update_node_pin(src)
    prev = g.nodes[src].pin_name_map["output_0"]
    for name in ("audio_filter", "audio_eq", "audio_gate", "audio_deesser",
                 "audio_compressor", "audio_limiter", "audio_normalize"):
        nid = g.add_node(_nodes(name)[1])
        g.add_link(prev, g.nodes[nid].pin_name_map["input"])
        prev = g.nodes[nid].pin_name_map["output"]
    out = g.add_node(JAudioOutput())
    g.add_link(prev, g.nodes[out].pin_name_map["input"])
    return g


def test_graph_from_jax_carries_every_live_parameter():
    jg = _jax_chain(["a.wav"])
    tg = graph_from_jax(jg)
    assert json.dumps(tg.serialize()) == json.dumps(jg.serialize())
    for nid, node in jg.nodes.items():
        assert tg.nodes[nid].processor.snapshot_params() == \
            node.processor.snapshot_params()


# -- normalize refuses streaming; the export falls back ------------------------


def test_normalize_refuses_streaming_and_the_export_falls_back(tmp_path):
    path = str(tmp_path / "a.wav")
    host_decode.write_wav_s16(path, noise(RATE, 0.05, seed=2), RATE)
    graph = graph_from_jax(_jax_chain([path]))
    with pytest.raises(UnstreamableGraphError):
        chunkflow.compile_stream_graph(graph, {
            (0, "output_0"): compiler.SourceSpec(
                rate=RATE, channels=2, fmt="s16", capacity=CHUNK)},
            device="cpu")
    runner = Runner(graph, device="cpu")
    metrics = runner.export_streamed(str(tmp_path / "streamed.wav"),
                                     chunk_seconds=0.1)
    assert metrics.mode == "offline" and runner.last_stream_metrics is None
    Runner(graph, device="cpu").export(str(tmp_path / "offline.wav"))
    got = host_decode.decode_file(str(tmp_path / "streamed.wav")).data
    want = host_decode.decode_file(str(tmp_path / "offline.wav")).data
    assert got.shape == (2, RATE)
    np.testing.assert_array_equal(got, want)


# -- config 6 ----------------------------------------------------------------


def test_config6_matches_the_jax_render_and_streams(tmp_path, monkeypatch):
    """bench.py's config 6 (EQ ls +3, p2 -4, hs +2 -> compressor -18 dB 4:1
    -> limiter -1 dB) on its 2 s 48 kHz stereo tone: the port's render on
    the CPU >= 95 dB (the compressor's bar) against the JAX render, and its
    streamed export >= 88 dB (the EQ's) against its offline one."""

    def write_tracks(tmp, count, seconds, rate, channels):
        n = int(rate * seconds)
        paths = []
        for i in range(count):
            path = f"{tmp}/track{i}.wav"
            host_decode.write_wav_s16(
                path, bench._tone(n, rate, 220.0 * (i + 1), channels, i), rate)
            paths.append(path)
        return paths

    monkeypatch.setattr(bench, "_write_tracks", write_tracks)
    jg, mode = bench.config6_masterbus(str(tmp_path), 2.0)
    tg = graph_from_jax(jg)
    runner = Runner(tg, device="cpu")
    arrays, lengths, sources = runner.decode()
    jsources = {key: jcompiler.SourceSpec(
        rate=s.rate, channels=s.channels, fmt=s.fmt, capacity=s.capacity,
        t0_us=s.t0_us) for key, s in sources.items()}
    data, length = jcompiler.compile_graph(jg, jsources, mode=mode).run(
        arrays, lengths)["master"]
    want = np.asarray(data)[:, :int(length)]
    got = runner.render(mode)
    assert (got.rate, got.fmt) == (RATE, "flt")
    assert got.master.shape == want.shape == (2, 2 * RATE)
    assert snr_db(want, got.master) >= 95.0
    assert np.abs(got.master).max() <= 10 ** (-1 / 20) * (1 + 1e-5)
    out = str(tmp_path / "config6.wav")
    metrics = Runner(tg, device="cpu").export_streamed(out, chunk_seconds=0.25)
    assert metrics.mode == "streamed"
    streamed = host_decode.decode_file(out).data
    # Both through the WAV sink (float32 samples for a float master).
    Runner(tg, device="cpu").export(str(tmp_path / "offline.wav"))
    offline = host_decode.decode_file(str(tmp_path / "offline.wav")).data
    assert streamed.shape == offline.shape == (2, 2 * RATE)
    assert snr_db(offline, streamed) >= 88.0
