"""Every public name of the JAX package has a counterpart in the port, and
the names ported last behave as the JAX package's, on the CPU.

``test_every_public_name_has_a_port_counterpart`` walks every
``nodey_tpu/**/*.py`` with ``ast`` and requires each public module-level
``def`` and ``class``, and each public method, to exist in the port module
at the same path (imported; a method may be inherited). The exceptions are
two tables, each entry with its reason: ``RELOCATED`` maps a name to its
counterpart elsewhere in the port, which must exist; ``NOT_PORTED`` holds
ROADMAP's "Not to port" list. An entry that no longer excuses anything
fails the test too, so the tables stay exact.

``test_last_ported_names_match_the_jax_package`` holds those names to the
JAX package's on the same inputs: slot editing through the graph's serde,
``CompiledGraph.run`` / ``run_device``, ``get_processor_info``,
``Stream.valid_mask``, the queue's non-blocking calls, ``zero_chunk``,
``fifo_level``, ``ResamplePlan.rates``, ``osc_residues``, ``to_mono``
(bitwise), ``wsola_stream_plan`` (equal), and ``wsola_chain_blocked`` and
``wsola_stream_step`` (the same splices; samples within 1e-6: the blend
is the same arithmetic, the JAX scores come from a GEMM in another order).
``encode_mp3`` is held byte-equal to the JAX encoder in
tests/test_torch_mp3.py, where the codec runtime loads.
"""

import ast
import importlib
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nodey_tpu.core import chunkflow as jchunkflow
from nodey_tpu.core import compiler as jcompiler
from nodey_tpu.core import registry as jregistry
from nodey_tpu.core.graph import Graph as JGraph
from nodey_tpu.core.stream import Stream as JStream
from nodey_tpu.host import streamio as jstreamio
from nodey_tpu.ops import chunkops as jchunkops
from nodey_tpu.ops import oscillator as josc
from nodey_tpu.ops import resample as jresample
from nodey_tpu.ops import stretch as jstretch
from nodey_tpu_torch.core import chunkflow, compiler, registry
from nodey_tpu_torch.core.errors import ProcessorRuntimeError
from nodey_tpu_torch.core.graph import Graph
from nodey_tpu_torch.core.stream import AudioStreamType, SpectrumStreamType
from nodey_tpu_torch.core.stream import Stream
from nodey_tpu_torch.host import streamio
from nodey_tpu_torch.ops import chunkops, oscillator, resample, stretch
from nodey_tpu_torch.processors.audio_input import AudioInput
from nodey_tpu_torch.processors.audio_output import AudioOutput
from nodey_tpu_torch.processors.audio_vol import AudioVol
from test_torch_effects import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-6

_PALLAS_WSOLA = "ops/pallas_wsola.py"

# JAX name (path under nodey_tpu/ and dotted name) -> its port counterpart
# ("module:name" under nodey_tpu_torch), and why it lives there.
RELOCATED = {
    ("ops/pallas_lock.py", "lock_to_peaks_pallas"): (
        "ops.cuda_pv:lock_to_peaks_cuda", "the lock kernel's wrapper"),
    ("ops/pallas_phase.py", "phase_path_pallas"): (
        "ops.cuda_pv:phase_path_cuda", "the phase-path kernel's wrapper"),
    ("ops/pallas_resample.py", "apply_filter_bank_grouped_pallas"): (
        "ops.cuda_resample:apply_filter_bank_cuda",
        "the resampler kernel's wrapper"),
    ("ops/pallas_resample.py", "resample_data_pallas"): (
        "ops.resample:resample_data",
        "the resampler kernel on a CUDA tensor (no code of its own)"),
    (_PALLAS_WSOLA, "wsola_score_table"): (
        "ops.wsola:wsola_score_table", "the score kernel's dispatcher"),
    (_PALLAS_WSOLA, "splice_offsets"): (
        "ops.wsola:splice_offsets", "score table, then its walk"),
    (_PALLAS_WSOLA, "wsola_chain_pallas"): (
        "ops.cuda_wsola:wsola_chain_cuda", "the chain kernel's wrapper"),
    (_PALLAS_WSOLA, "wsola_chain_assemble_pallas"): (
        "ops.cuda_wsola:wsola_chain_cuda",
        "the chain kernel always emits its audio (fused assembly)"),
    (_PALLAS_WSOLA, "wsola_chunk_chain_pallas"): (
        "ops.cuda_wsola:wsola_chunk_chain_cuda",
        "the chain kernel's chunk entry"),
}

# JAX name -> why the port has none (ROADMAP §1, "Not to port").
NOT_PORTED = {
    ("config.py", "set_platform"): "JAX platform selection",
    ("config.py", "resolve_platforms"): "JAX platform selection",
    ("config.py", "enable_compile_cache"): "JAX's persistent compile cache",
    ("ops/resample.py", "form_override"): "the NODEY_RESAMPLE_FORM switch",
    ("ops/resample.py", "resolve_form"): "the NODEY_RESAMPLE_FORM switch",
    ("ops/resample.py", "form_in_use"): "the NODEY_RESAMPLE_FORM switch",
    ("ops/resample.py", "to_rate_and_stereo_many"):
        "no batched caller wants it (ops/mix.py:28-36)",
    ("ops/pallas_resample.py", "kernel_ready"):
        "the TPU's Mosaic compile probe",
    (_PALLAS_WSOLA, "score_frames_per_step"): "the NODEY_WSOLA_FPS switch",
    (_PALLAS_WSOLA, "chunk_window_extra"):
        "lane slack that only the TPU kernel's 128-lane DMA windows read",
    (_PALLAS_WSOLA, "can_fuse_assembly"):
        "the TPU kernel's lane condition for its fused assembly",
    **{(path, name): "a NumPy mirror of an op (the tests use the JAX "
                     "package's)"
       for path, name in (
           ("ops/biquad.py", "cascade_reference"),
           ("ops/delay.py", "delay_reference"),
           ("ops/dynamics.py", "compressor_reference"),
           ("ops/dynamics.py", "deesser_reference"),
           ("ops/dynamics.py", "gate_reference"),
           ("ops/dynamics.py", "limiter_reference"),
           ("ops/fadepan.py", "fade_reference"),
           ("ops/fadepan.py", "pan_reference"),
           ("ops/fadepan.py", "width_reference"),
           ("ops/gain.py", "apply_gain_reference"),
           ("ops/loudness.py", "loudness_reference"),
           ("ops/modfx.py", "chorus_reference"),
           ("ops/modfx.py", "tremolo_reference"),
           ("ops/phaser.py", "phaser_reference"),
           ("ops/pv.py", "pv_stretch_reference"),
           ("ops/resample.py", "resample_data_reference"),
           ("ops/stft.py", "magnitude_spectrogram_reference"),
           ("ops/stretch.py", "wsola_stretch_reference"),
       )},
}


def _public_names(path: pathlib.Path):
    """Public module-level defs and classes of ``path``, and the public
    methods of its public classes (``Class.method``)."""
    defs = (ast.FunctionDef, ast.AsyncFunctionDef)
    for node in ast.parse(path.read_text()).body:
        if not isinstance(node, (*defs, ast.ClassDef)) \
                or node.name.startswith("_"):
            continue
        yield node.name
        if isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, defs) and not sub.name.startswith("_"):
                    yield f"{node.name}.{sub.name}"


def _lookup(module: str, dotted: str):
    """``nodey_tpu_torch.<module>``'s ``dotted`` name ("" is the package
    itself), or None."""
    try:
        obj = importlib.import_module(
            f"nodey_tpu_torch.{module}" if module else "nodey_tpu_torch")
    except ModuleNotFoundError:
        return None
    for part in dotted.split("."):
        obj = getattr(obj, part, None)
        if obj is None:
            return None
    return obj


def _module(rel: str) -> str:
    """The dotted module of a path under the package ("" for its
    ``__init__.py``)."""
    parts = rel[: -len(".py")].split("/")
    if parts[-1] == "__init__":
        parts.pop()
    return ".".join(parts)


def test_every_public_name_has_a_port_counterpart():
    jax_root = ROOT / "nodey_tpu"
    missing, used = [], set()
    for path in sorted(jax_root.rglob("*.py")):
        rel = path.relative_to(jax_root).as_posix()
        module = _module(rel)
        for name in _public_names(path):
            key = (rel, name)
            if key in NOT_PORTED:
                used.add(key)
                continue
            if key in RELOCATED:
                used.add(key)
                target = RELOCATED[key][0]
                if _lookup(*target.split(":")) is None:
                    missing.append(f"{rel}::{name} -> {target} (absent)")
                continue
            if _lookup(module, name) is None:
                missing.append(f"{rel}::{name}")
    assert not missing, "no port counterpart:\n" + "\n".join(missing)
    stale = sorted((set(RELOCATED) | set(NOT_PORTED)) - used)
    assert not stale, f"exception entries that excuse nothing: {stale}"


def _project(paths):
    """A port graph input -> vol(0.5) -> output with the input's slots
    (the project file does not hold the volume: set it on a copy too)."""
    g = Graph()
    src = g.add_node(AudioInput())
    g.nodes[src].processor.file_paths = list(paths)
    g.update_node_pin(src)
    vol = g.add_node(AudioVol())
    g.nodes[vol].processor.volume = 0.5
    out = g.add_node(AudioOutput())
    g.add_link(g.nodes[src].pin_name_map["output_0"],
               g.nodes[vol].pin_name_map["input"])
    g.add_link(g.nodes[vol].pin_name_map["output"],
               g.nodes[out].pin_name_map["input"])
    return g, src, vol


def _slot_editing():
    registry.register_all_processors()
    jregistry.register_all_processors()
    g, src, _vol = _project(["a.wav"])
    jg = JGraph.deserialize(g.serialize())
    for graph in (g, jg):
        proc = graph.nodes[src].processor
        proc.add_slot("b.wav")
        proc.add_slot()
        proc.remove_slot(0)
        graph.update_node_pin(src)
    assert g.serialize() == jg.serialize()
    assert g.nodes[src].processor.file_paths == ["b.wav", ""]
    assert Graph.deserialize(jg.serialize()).serialize() == g.serialize()
    for graph in (g, jg):
        graph.nodes[src].processor.remove_slot(-1)
    errors = []
    for graph in (g, jg):
        with pytest.raises(Exception) as err:
            graph.nodes[src].processor.remove_slot(0)
        errors.append((type(err.value).__name__, err.value.message,
                       err.value.explanation, err.value.detail))
    assert errors[0] == errors[1]
    assert errors[0][0] == ProcessorRuntimeError.__name__
    assert g.serialize() == jg.serialize()


def _run_and_run_device():
    g, src, vol = _project(["a.wav"])
    jg = JGraph.deserialize(g.serialize())
    jg.nodes[vol].processor.volume = 0.5
    x = np.random.default_rng(4).uniform(-1, 1, (2, 960)).astype(np.float32)
    x[:, 800:] = 0.0
    spec = dict(rate=48_000, channels=2, fmt="flt", capacity=960)
    key = compiler.external_key(src, "output_0")
    arrays, lengths = {key: x}, {key: 800}
    compiled = compiler.compile_graph(
        g, {(src, "output_0"): compiler.SourceSpec(**spec)}, device="cpu")
    jcompiled = jcompiler.compile_graph(
        jg, {(src, "output_0"): jcompiler.SourceSpec(**spec)})
    got, want = compiled.run(arrays, lengths), jcompiled.run(arrays, lengths)
    assert sorted(got) == sorted(want)
    for name in got:
        np.testing.assert_array_equal(got[name][0], want[name][0])
        assert got[name][1] == int(want[name][1])
    on_device = compiled.run_device({key: torch.from_numpy(x)}, lengths)
    called, _meta = compiled({key: (torch.from_numpy(x), 800)})
    for name in got:
        assert torch.is_tensor(on_device[name][0])
        assert on_device[name][0].device.type == "cpu"
        assert torch.equal(on_device[name][0], called[name][0])


def _registry_and_streams():
    registry.register_all_processors()
    jregistry.register_all_processors()
    for ident in jregistry.processor_map:
        info, jinfo = (registry.get_processor_info(ident),
                       jregistry.get_processor_info(ident))
        assert (info.identifier, info.display_name) == (
            jinfo.identifier, jinfo.display_name)
    assert registry.get_processor_info("no_such_node") is None
    assert SpectrumStreamType is not AudioStreamType
    x = np.random.default_rng(1).standard_normal((2, 8)).astype(np.float32)
    for length in (0, 5, 8):
        got = Stream(torch.from_numpy(x), length, 48_000, 2).valid_mask()
        want = JStream(jnp.asarray(x), length, 48_000, 2).valid_mask()
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    batch = Stream(torch.zeros((2, 2, 8)), (3, 8), 48_000, 2).valid_mask()
    assert batch.shape == (2, 1, 8)
    assert batch.sum(-1).flatten().tolist() == [3.0, 8.0]
    mono = JStream(jnp.asarray(x), 8, 48_000, 2)
    np.testing.assert_array_equal(
        resample.to_mono(Stream(torch.from_numpy(x), 8, 48_000, 2)
                         ).data.numpy(),
        np.asarray(jresample.to_mono(mono).data))
    assert resample.to_mono(Stream(torch.from_numpy(x[:1]), 8, 48_000, 1)
                            ).data.shape == (1, 8)


def _queue_and_chunks():
    logs = []
    for mod in (streamio, jstreamio):
        q = mod.BoundedBlockQueue(capacity=2)
        log = [q.try_pop(), q.try_push("a"), q.try_push("b"),
               q.try_push("c"), q.buffered_count(), q.try_pop(),
               q.buffered_count(), q.try_pop(), q.try_pop()]
        s = q.stats
        logs.append((log, s.pushed, s.popped, s.buffered))
    assert logs[0] == logs[1]

    spec = chunkflow.ChunkSpec(rate=48_000, channels=2, fmt="flt", width=64)
    jspec = jchunkflow.ChunkSpec(rate=48_000, channels=2, fmt="flt", width=64)
    zero, jzero = chunkflow.zero_chunk(spec, "cpu"), jchunkflow.zero_chunk(
        jspec)
    np.testing.assert_array_equal(zero.data.numpy(), np.asarray(jzero.data))
    assert (zero.n, zero.done) == (int(jzero.n), bool(jzero.done))

    data = np.arange(2 * 10, dtype=np.float32).reshape(2, 10)
    fifo = chunkops.fifo_push(chunkops.fifo_init(2, 32, "cpu"),
                              torch.from_numpy(data), 7)
    jfifo = jchunkops.fifo_push(jchunkops.fifo_init(2, 32),
                                jnp.asarray(data), 7)
    assert chunkops.fifo_level(fifo) == int(jchunkops.fifo_level(jfifo)) == 7
    for in_rate, out_rate in ((44_100, 48_000), (48_000, 22_050)):
        plan = chunkops.resample_plan(in_rate, out_rate, 4096, "cpu")
        jplan = jchunkops.resample_plan(in_rate, out_rate, 4096)
        assert plan.rates == jplan.rates == (plan.M, plan.L)

    for r0, width, num, m in ((0, 1000, 441, 48_000),
                              (47_999, 9000, 12_345, 48_000),
                              (17, 5000, 3, 44_100)):
        np.testing.assert_array_equal(
            oscillator.osc_residues(r0, width, num, m, "cpu").numpy(),
            np.asarray(josc.osc_residues(r0, width, num, m)))


def _wsola_entries():
    rate, tempo = 8_000, 1.25
    rng = np.random.default_rng(9)
    n = rate * 2
    t = np.arange(n) / rate
    x = (0.5 * np.sin(2 * np.pi * 220 * t)[None]
         + 0.2 * rng.standard_normal((2, n))).astype(np.float32)
    geo = stretch.wsola_geometry(n, tempo, rate)
    args = (geo["num"], geo["den"], geo["seq"], geo["seek"], geo["overlap"])
    k0, K = 3, 24
    base = stretch.frame_pos(k0, geo["num"], geo["den"]) - 5
    tail0 = x[:, 100 : 100 + geo["overlap"]]
    bs, body = stretch.wsola_chain_blocked(
        torch.from_numpy(x[:, base:]), torch.from_numpy(tail0), k0, K, *args,
        win_start=base)
    jbs, jbody = jstretch.wsola_chain_blocked(
        jnp.asarray(x[:, base:]), jnp.asarray(tail0), k0, K, *args,
        win_start=base, block=8)
    np.testing.assert_array_equal(bs.numpy(), np.asarray(jbs))
    np.testing.assert_allclose(body.numpy(), np.asarray(jbody), rtol=0,
                               atol=TOL)

    plan = stretch.wsola_stream_plan(tempo, rate, 16)
    assert plan == jstretch.wsola_stream_plan(tempo, rate, 16)
    tail = x[:, : plan["overlap"]]
    jtail = jnp.asarray(tail)
    tail = torch.from_numpy(tail)
    for k0 in (0, 16, 32):
        start = stretch.frame_pos(k0, plan["num"], plan["den"])
        window = x[:, start : start + plan["window"]]
        tail, chunk = stretch.wsola_stream_step(
            plan, torch.from_numpy(window), tail, k0)
        jtail, jchunk = jstretch.wsola_stream_step(
            plan, jnp.asarray(window), jtail, k0)
        assert chunk.shape == (2, 16 * plan["stride_out"])
        np.testing.assert_allclose(chunk.numpy(), np.asarray(jchunk), rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(tail.numpy(), np.asarray(jtail), rtol=0,
                                   atol=TOL)


def test_last_ported_names_match_the_jax_package():
    for check in (_slot_editing, _run_and_run_device, _registry_and_streams,
                  _queue_and_chunks, _wsola_entries):
        check()
