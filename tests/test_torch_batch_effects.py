"""Batched serving (``CompiledGraph.run_batch``) of the eleven node types
that BASELINE configs 1-7 do not hold: the seven channel nodes (delay,
tremolo, chorus, phaser, pan, width, fade) and the four that make, join or
cut streams (generator, crossfade, trim, reverse), on the CPU.

Each batch holds three clips of different content and length (the shares
``SHARES`` of tests/test_torch_batch.py: 100%, 71% and 33% of the longest)
in one capacity, as float32 samples. One test item loops over the graphs
(the Tier-1 run's length turns on the collected count):

- every clip of the port's ``run_batch`` is bitwise the port's own single
  render of that clip (``CompiledGraph.__call__``), master and length, and
  zero past its own length, for: a chain of all seven channel nodes, in
  examples/channel_strip.py's order and with the chorus ahead of the
  phaser; mono
  -> pan -> an unanchored fade (the pan makes the mono batch stereo); a
  fade anchored at each clip's own end; two inputs of opposite lengths ->
  a crossfade placed past the shortest clip -> trim -> reverse (each clip
  runs to its longer input, then reverses over its own length); a 44.1
  kHz input and a 48 kHz generator -> amix (the generator's one clip
  broadcast to the batch); examples/projects/channel_strip.json and
  examples/channel_strip.py's chain (gate, EQ, compressor, phaser, width,
  pan, delay, reverb, fade, limiter);
- the port's batch against the JAX package's ``run_batch`` (its vmap on the
  CPU) at the bar of the weakest node of each chain in the single-clip
  tests: the channel chain in the example's order >= 95 dB (the chorus's,
  tests/test_torch_effects.py ``NODES``; with the chorus ahead of the
  phaser, the JAX package's whole-graph render falls to 54 dB against the
  float64 mirror of its own phaser at the chorus LFO's half period, where
  the port's holds 132 dB, so that order is held to the port's single
  renders only), the anchored fade >= 130 dB (the fade's), the
  timeline chain within 3e-7 (the crossfade's, tests/test_torch_timeline
  .py; trim and reverse are bitwise), the generator mix within 2e-6 (the
  resampler's, tests/test_torch_slice.py); equal lengths;
- a graph whose streams all come from a generator has no clip count: the
  port's ``run_batch`` refuses it before any synthesis, and the JAX
  package's vmap raises on its empty argument tree.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from conftest import snr_db
from nodey_tpu.core import compiler as jcompiler
from nodey_tpu.core import registry as jregistry
from nodey_tpu.core.graph import Graph as JGraph
from nodey_tpu.processors.amix import AudioAmix as JAmix
from nodey_tpu.processors.audio_input import AudioInput as JInput
from nodey_tpu.processors.audio_output import AudioOutput as JOutput
from nodey_tpu.processors.crossfade import AudioCrossfade as JCrossfade
from nodey_tpu.processors.editnodes import AudioReverse as JReverse
from nodey_tpu.processors.editnodes import AudioTrim as JTrim
from nodey_tpu.processors.fade import AudioFade as JFade
from nodey_tpu.processors.generator import AudioGenerator as JGenerator
from nodey_tpu.processors.pan import AudioPan as JPan
from nodey_tpu_torch.convert import graph_from_jax
from nodey_tpu_torch.core import compiler
from nodey_tpu_torch.core.errors import ProcessorRuntimeError
from nodey_tpu_torch.core.registry import register_all_processors
from nodey_tpu_torch.ops import oscillator as osc
from test_torch_batch import SHARES, _jax_run_batch
from test_torch_batch import one_torch_thread  # noqa: F401  (autouse)
from test_torch_effects import NODES, _example_graph, edited

ROOT = pathlib.Path(__file__).resolve().parent.parent
RATE = 8_000                  # the single-clip tests' rate for these nodes
SECONDS = 1.5
CHANNEL_DB = 95.0             # the chorus's bar, the chain's weakest
FADE_DB = 130.0               # the fade's bar
TIMELINE_TOL = 3e-7           # the crossfade's; trim and reverse bitwise
MIX_TOL = 2e-6                # the resampler's (44.1 -> 48 kHz)


def _clips(rate, channels, capacity, lengths, seed):
    """[B, channels, capacity] float32 clips of ``lengths``: a tone of its
    own pitch under a noise floor, each zero past its length."""
    data = np.zeros((len(lengths), channels, capacity), dtype=np.float32)
    for b, n in enumerate(lengths):
        t = np.arange(n) / rate
        tone = 0.3 * np.sin(2.0 * np.pi * (150.0 + 60.0 * b + 35.0 * seed)
                            * t)
        rng = np.random.default_rng(10 * seed + b)
        data[b, :, :n] = tone + 0.05 * rng.standard_normal((channels, n))
    return data


def _input(g, paths):
    src = g.add_node(JInput())
    g.nodes[src].processor.file_paths = list(paths)
    g.update_node_pin(src)
    return src


def _pin(g, nid, name):
    return g.nodes[nid].pin_name_map[name]


def _chain(g, from_pin, nodes):
    """``nodes`` in a row from ``from_pin`` -> output."""
    for node in nodes:
        nid = g.add_node(node)
        g.add_link(from_pin, _pin(g, nid, "input"))
        from_pin = _pin(g, nid, "output")
    out = g.add_node(JOutput())
    g.add_link(from_pin, _pin(g, out, "input"))


def _one_input(nodes, channels=2):
    """One input at RATE -> ``nodes`` -> output, in the JAX package."""
    g = JGraph()
    src = _input(g, ["a.wav"])
    _chain(g, _pin(g, src, "output_0"), nodes)
    n = int(RATE * SECONDS)
    lengths = tuple(int(n * s) for s in SHARES)
    return g, {(src, "output_0"): (RATE, channels, n, lengths)}


def channel_chain(names=("audio_phaser", "audio_width", "audio_pan",
                         "audio_delay", "audio_tremolo", "audio_chorus",
                         "audio_fade")):
    """All seven channel nodes at the single-clip tests' parameters, by
    default in examples/channel_strip.py's order (phaser, width, pan,
    delay; the modulation pair and the fade after them)."""
    return _one_input([edited(NODES[k][1], **NODES[k][2]) for k in names])


def chorus_into_phaser():
    """The seven with the chorus ahead of the phaser."""
    return channel_chain(("audio_delay", "audio_tremolo", "audio_chorus",
                          "audio_phaser", "audio_pan", "audio_width",
                          "audio_fade"))


def mono_pan_fade():
    return _one_input([edited(JPan, pan=-0.3),
                       edited(JFade, in_ms=60.0, out_start_s=1.0,
                              out_ms=250.0)], channels=1)


def anchored_fade():
    return _one_input([edited(JFade, in_ms=60.0, out_ms=250.0,
                              anchor_end=True)])


def timeline_chain():
    """Two inputs of opposite lengths -> crossfade at 0.8 s for 300 ms
    (past the shortest clip) -> trim 0.1 s to 1.3 s -> reverse."""
    g = JGraph()
    src = _input(g, ["a.wav", "b.wav"])
    xf = g.add_node(edited(JCrossfade, at_s=0.8, dur_ms=300.0))
    g.add_link(_pin(g, src, "output_0"), _pin(g, xf, "input_a"))
    g.add_link(_pin(g, src, "output_1"), _pin(g, xf, "input_b"))
    _chain(g, _pin(g, xf, "output"),
           [edited(JTrim, start_s=0.1, end_s=1.3), JReverse()])
    n = int(RATE * SECONDS)
    lengths = tuple(int(n * s) for s in SHARES)
    return g, {(src, "output_0"): (RATE, 2, n, lengths),
               (src, "output_1"): (RATE, 2, n, lengths[::-1])}


def generator_mix():
    """A 44.1 kHz input and a 48 kHz triangle generator (0.4 s, longer
    than the shortest clip) -> amix 0.6 / 0.4 -> output."""
    g = JGraph()
    src = _input(g, ["a.wav"])
    gen = g.add_node(edited(JGenerator, waveform="triangle", freq=97.0,
                            duration_s=0.4, level_db=-18.0))
    mix = g.add_node(JAmix())
    g.nodes[mix].processor.set_input_num(2)
    g.nodes[mix].processor.volumes = [0.6, 0.4]
    g.update_node_pin(mix)
    g.add_link(_pin(g, src, "output_0"), _pin(g, mix, "input_1"))
    g.add_link(_pin(g, gen, "output"), _pin(g, mix, "input_2"))
    _chain(g, _pin(g, mix, "output"), [])
    n = 22_050
    return g, {(src, "output_0"): (44_100, 2, n,
                                   tuple(int(n * s) for s in SHARES))}


def channel_strip_project():
    data = json.loads((ROOT / "examples/projects/channel_strip.json")
                      .read_text())
    jg = JGraph.deserialize(data)
    [src] = [nid for nid, node in jg.nodes.items()
             if node.processor.info().identifier == "audio_input"]
    return jg, _strip_inputs(src)


def example_strip():
    jg, _ = _example_graph("a.wav")
    [src] = [nid for nid, node in jg.nodes.items()
             if node.processor.info().identifier == "audio_input"]
    return jg, _strip_inputs(src)


def _strip_inputs(src):
    n = 24_000
    return {(src, "output_0"): (48_000, 2, n,
                                tuple(int(n * s) for s in SHARES))}


# name: (the function making the graph, the JAX run_batch bar or None)
GRAPHS = {
    "channel_chain": (channel_chain, ("db", CHANNEL_DB)),
    "chorus_into_phaser": (chorus_into_phaser, None),
    "mono_pan_fade": (mono_pan_fade, None),
    "anchored_fade": (anchored_fade, ("db", FADE_DB)),
    "timeline_chain": (timeline_chain, ("tol", TIMELINE_TOL)),
    "generator_mix": (generator_mix, ("tol", MIX_TOL)),
    "channel_strip_project": (channel_strip_project, None),
    "example_strip": (example_strip, None),
}


def _batch(inputs):
    """(port SourceSpecs, arrays, lengths) of the graph's inputs: each
    input's clips in a capacity a little past its longest."""
    sources, arrays, lengths = {}, {}, {}
    for j, ((nid, pin), (rate, channels, n, lens)) in enumerate(
            sorted(inputs.items())):
        capacity = -(-(n + 300) // 256) * 256
        sources[(nid, pin)] = compiler.SourceSpec(
            rate=rate, channels=channels, fmt="flt", capacity=capacity)
        key = compiler.external_key(nid, pin)
        arrays[key] = _clips(rate, channels, capacity, lens, seed=j)
        lengths[key] = lens
    return sources, arrays, lengths


def _check_clips(name, compiled, arrays, lengths):
    """Each clip of the batch bitwise its single render, zero past its own
    length. Returns the batch's master and lengths."""
    outs, meta = compiled.run_batch(arrays, lengths)
    data, lens = outs["master"]
    assert data.shape[0] == len(SHARES) and isinstance(lens, tuple), name
    for b in range(len(SHARES)):
        single, single_meta = compiled({
            k: (torch.from_numpy(arrays[k][b]), lengths[k][b])
            for k in compiled.input_keys})
        assert single_meta == meta, name
        one, n = single["master"]
        assert lens[b] == n, (name, b)
        assert torch.equal(data[b], one), (name, b)
        assert not data[b, :, n:].any(), (name, b)
    return data, lens


def _check_jax(name, jg, sources, arrays, lengths, data, lens, bar):
    want, wlens = _jax_run_batch(jg, "export", sources, arrays,
                                 lengths)["master"]
    assert list(lens) == wlens.tolist(), name
    for b, n in enumerate(lens):
        got, ref = data[b, :, :n].numpy(), want[b, :, :n]
        assert np.isfinite(got).all(), (name, b)
        if bar[0] == "tol":
            assert np.abs(got - ref).max() <= bar[1], (name, b)
        else:
            assert snr_db(ref, got) >= bar[1], (name, b)


def test_effect_and_timeline_batches(monkeypatch):
    register_all_processors()
    jregistry.register_all_processors()
    for name, (build, bar) in GRAPHS.items():
        jg, inputs = build()
        sources, arrays, lengths = _batch(inputs)
        compiled = compiler.compile_graph(graph_from_jax(jg), sources,
                                          "export", "cpu")
        data, lens = _check_clips(name, compiled, arrays, lengths)
        if name == "timeline_chain":
            # Each clip ran to the longer of its two inputs, then was
            # trimmed: 1.3 s for the longest two, 1.065 - 0.1 s for the
            # middle one, whose inputs both end there.
            n = int(RATE * SECONDS)
            assert lens == (int(1.3 * RATE) - int(0.1 * RATE),
                            int(n * SHARES[1]) - int(0.1 * RATE),
                            int(1.3 * RATE) - int(0.1 * RATE))
        if name == "anchored_fade":
            # Each clip's ramp ends at its own length: its last sample is
            # 1/n_out of its input's there.
            n_out = round(0.25 * RATE)
            key = compiler.external_key(*next(iter(inputs)))
            for b, n in enumerate(lens):
                np.testing.assert_allclose(
                    data[b, :, n - 1].numpy(),
                    arrays[key][b, :, n - 1] / n_out, rtol=1e-6)
        if bar is not None:
            _check_jax(name, jg, sources, arrays, lengths, data, lens, bar)

    # A graph fed by a generator alone has no clip count.
    jg = JGraph()
    gen = jg.add_node(edited(JGenerator, duration_s=0.2))
    _chain(jg, _pin(jg, gen, "output"), [])
    compiled = compiler.compile_graph(graph_from_jax(jg), {}, "export", "cpu")
    synthesized = []
    monkeypatch.setattr(osc, "generator_block",
                        lambda *a: synthesized.append(a))
    with pytest.raises(ProcessorRuntimeError) as err:
        compiled.run_batch({}, {})
    assert err.value.detail == "no external input"
    assert synthesized == []
    with pytest.raises(ValueError, match="at least one argument"):
        jcompiler.compile_graph(jg, {}, mode="export").run_batch({}, {})
