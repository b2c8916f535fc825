"""The port's chunk-flow compiler (``nodey_tpu_torch.core.chunkflow``)
against the JAX package's, on the CPU.

The plan pass of both packages runs on the same graph (built with the JAX
package's processors, carried into the port by ``graph_from_jax``) and the
same sources: every node's planned output specs (rate, channels, width,
cadence), the emitted output metadata, the FIFO gauge labels and the
stages' plans must be equal. The step itself, driven by hand, must give the
offline render's master (3e-7) and spectrum frames (>= 100 dB).
"""

import dataclasses

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from nodey_tpu.core import chunkflow as jchunkflow
from nodey_tpu.core import compiler as jcompiler
from nodey_tpu_torch.convert import graph_from_jax
from nodey_tpu_torch.core import chunkflow, compiler
from nodey_tpu_torch.core.errors import UnstreamableGraphError
from nodey_tpu_torch.core.runner import Runner
from nodey_tpu_torch.host.decode import write_wav_s16

from conftest import snr_db
from test_torch_config4 import config4_graph as jax_config4_graph


def _tracks(tmp_path, seconds, count=2):
    rng = np.random.default_rng(77)
    n = int(44_100 * seconds)
    t = np.arange(n) / 44_100.0
    paths = []
    for i in range(count):
        data = np.stack([0.4 * np.sin(2 * np.pi * 220.0 * (i + 1) * t),
                         0.25 * rng.standard_normal(n)])
        path = str(tmp_path / f"track_{i}.wav")
        write_wav_s16(path, data.astype(np.float32), 44_100)
        paths.append(path)
    return paths


def _jax_graph(name, paths):
    if name == "5node":
        return graft._flagship_graph(paths)[0]
    return jax_config4_graph(paths[0])


def _record_specs(graph):
    """Wrap every node's plan_stream to record its planned output specs."""
    planned = {}
    for nid, node in graph.nodes.items():
        def plan(ctx, in_specs, _plan=node.processor.plan_stream, _nid=nid):
            out_specs, state = _plan(ctx, in_specs)
            planned[_nid] = {pin: (s.rate, s.channels, s.width, s.cadence)
                             for pin, s in out_specs.items()}
            return out_specs, state
        node.processor.plan_stream = plan
    return planned


@pytest.mark.parametrize("name", ["5node", "config4"])
@pytest.mark.parametrize("chunk_seconds", [0.5, 16.0])
def test_planned_specs_equal_the_jax_plan(tmp_path, name, chunk_seconds):
    jg = _jax_graph(name, _tracks(tmp_path, 0.2))
    tg = graph_from_jax(jg)
    chunk = int(44_100 * chunk_seconds)
    sources = {(0, f"output_{i}"): compiler.SourceSpec(
        rate=44_100, channels=2, fmt="s16", capacity=chunk)
        for i in range(len(jg.nodes[0].processor.file_paths))}
    jsources = {key: jcompiler.SourceSpec(**dataclasses.asdict(spec))
                for key, spec in sources.items()}
    jplanned, planned = _record_specs(jg), _record_specs(tg)
    jcompiled = jchunkflow.compile_stream_graph(jg, jsources, jit=False)
    compiled = chunkflow.compile_stream_graph(tg, sources, device="cpu")

    assert planned == jplanned and len(planned) == len(jg.nodes)
    assert compiled.output_meta == jcompiled.output_meta
    assert compiled.gauge_keys == jcompiled.gauge_keys != ()
    assert compiled.chunk_in == jcompiled.chunk_in
    assert compiled.input_keys == jcompiled.input_keys
    # The stages' plans: the port keeps the JAX package's widths and caps
    # (the WSOLA FIFO without the TPU kernel's lane slack).
    for nid, node in tg.nodes.items():
        jproc = jg.nodes[nid].processor
        for attr in ("_stream_plan", "_wsola_plan", "_rs_plan"):
            plan, jplan = getattr(node.processor, attr, None), getattr(
                jproc, attr, None)
            assert (plan is None) == (jplan is None), (nid, attr)
            if plan is None:
                continue
            for field in ("out_cap", "quant", "k_cap", "take_cap",
                          "frames_cap", "stride_out", "num"):
                if hasattr(jplan, field):
                    assert getattr(plan, field) == getattr(jplan, field)
        for plan, jplan in zip(getattr(node.processor, "_rs_plans", []),
                               getattr(jproc, "_rs_plans", [])):
            assert (plan.out_cap, plan.quant) == (jplan.out_cap, jplan.quant)


def test_step_driven_by_hand_equals_the_offline_render(tmp_path):
    """Decoded blocks of 0.3 s through the 5-node graph's chunk step: the
    master equals the offline render's within 3e-7, the spectrum frames
    the offline frames that lie inside the clip at >= 100 dB, and every
    step reports each FIFO's fill in [0, 1]."""
    paths = _tracks(tmp_path, 1.3)
    tg = graph_from_jax(graft._flagship_graph(paths)[0])
    offline = Runner(tg, device="cpu").render("export")
    arrays, lengths, _ = Runner(tg, device="cpu").decode()
    chunk = int(44_100 * 0.3)
    sources = {(0, f"output_{i}"): compiler.SourceSpec(
        rate=44_100, channels=2, fmt="s16", capacity=chunk) for i in range(2)}
    compiled = chunkflow.compile_stream_graph(tg, sources, device="cpu")
    [spec_key] = [k for k, m in compiled.output_meta.items()
                  if m["kind"] == "frames"]

    states, master, frames, pos = compiled.init_states, [], [], 0
    for _ in range(20):
        args = {}
        for key in compiled.input_keys:
            n = max(0, min(chunk, lengths[key] - pos))
            block = torch.zeros((2, chunk), dtype=torch.int16)
            block[:, :n] = torch.from_numpy(arrays[key][:, pos : pos + n])
            args[key] = (block, n, pos + n >= lengths[key])
        pos += chunk
        states, outs = compiled.step(states, args)
        gauges = outs[chunkflow.GAUGES_KEY]
        assert len(gauges) == len(compiled.gauge_keys)
        assert all(0.0 <= g <= 1.0 for g in gauges)
        data, n, done = outs["master"]
        master.append(data[:, :n].numpy())
        f_data, f_n, _ = outs[spec_key]
        frames.append(f_data[:, :f_n].numpy())
        if done:
            break
    assert done
    master = np.concatenate(master, axis=1)
    assert master.shape == offline.master.shape
    np.testing.assert_allclose(master, offline.master, rtol=0, atol=3e-7)
    frames = np.concatenate(frames, axis=1)
    want = offline.spectra[spec_key][:, : frames.shape[1]]
    assert frames.shape[1] == (master.shape[1] - 1024) // 512 + 1
    assert snr_db(want, frames) >= 100.0


def _velocity_mix_graph(paths, velocity=2.0, algorithm="wsola"):
    """Track 1 through a velocity change, mixed with track 2: the branches
    arrive at different cadences."""
    from nodey_tpu_torch.core.graph import Graph
    from nodey_tpu_torch.processors.amix import AudioAmix
    from nodey_tpu_torch.processors.audio_input import AudioInput
    from nodey_tpu_torch.processors.audio_output import AudioOutput
    from nodey_tpu_torch.processors.velocity import VelocityModifier

    g = Graph()
    src = g.add_node(AudioInput())
    g.nodes[src].processor.file_paths = list(paths)
    g.update_node_pin(src)
    vel = g.add_node(VelocityModifier())
    g.nodes[vel].processor.set_velocity(velocity)
    g.nodes[vel].processor.set_algorithm(algorithm)
    amix = g.add_node(AudioAmix())
    g.nodes[amix].processor.set_input_num(2)
    out = g.add_node(AudioOutput())

    def pin(n, p):
        return g.nodes[n].pin_name_map[p]

    g.add_link(pin(src, "output_0"), pin(vel, "input"))
    g.add_link(pin(vel, "output"), pin(amix, "input_1"))
    g.add_link(pin(src, "output_1"), pin(amix, "input_2"))
    g.add_link(pin(amix, "output"), pin(out, "input"))
    return g, amix, vel


def test_mismatched_cadence_is_unstreamable_and_names_the_mixer(tmp_path):
    g, amix, _ = _velocity_mix_graph(_tracks(tmp_path, 0.2))
    sources = {(0, f"output_{i}"): compiler.SourceSpec(
        rate=44_100, channels=2, fmt="s16", capacity=4_410) for i in range(2)}
    with pytest.raises(UnstreamableGraphError,
                       match="different rates") as info:
        chunkflow.compile_stream_graph(g, sources, device="cpu")
    assert f"[node {amix}: audio_amix]" in info.value.detail


def test_phase_vocoder_under_streaming_raises_naming_the_node(tmp_path):
    """A velocity node on the phase vocoder streams (its chunk step plans);
    mixed with an unstretched branch its cadence differs, so the plan
    refuses the mixer, naming it, as the JAX package does."""
    g, amix, vel = _velocity_mix_graph(_tracks(tmp_path, 0.2), velocity=1.0,
                                       algorithm="pv")
    g.nodes[vel].processor.keep_pitch = True
    g.nodes[vel].processor.set_velocity(1.25)
    sources = {(0, f"output_{i}"): compiler.SourceSpec(
        rate=44_100, channels=2, fmt="s16", capacity=4_410) for i in range(2)}
    with pytest.raises(UnstreamableGraphError,
                       match="different rates") as info:
        chunkflow.compile_stream_graph(g, sources, device="cpu")
    assert f"[node {amix}: audio_amix]" in info.value.detail
    assert g.nodes[vel].processor._pv_plan is not None
