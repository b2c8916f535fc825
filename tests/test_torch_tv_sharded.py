"""The port's sequence-parallel time-variant chains
(``nodey_tpu_torch.parallel.tv_sharded``) on the CPU, on a mesh of eight
CPU shards.

The chains are the JAX package's own sp chain tests' (tests/test_tv_sharded.py
and the sp chain tests of tests/test_gate.py, test_deesser.py,
test_modfx.py, test_phaser.py, test_fadepan.py and test_width.py): the
same JAX graphs and signals, carried into the port by ``graph_from_jax``.
Each chain's sharded render is held against the port's own single render
(``compile_graph`` on the CPU) at the bar the JAX test sets for the same
chain against the JAX single render: the limiter 120 dB, the compressor
110, the EQ 80, the full master bus 70, LTI-only 100; the gate 100, the
de-esser 90, tremolo 110, chorus 100, the phaser 110, modulation beside
the dynamics 95, pan and fade 120, the width 110. Lengths are exact, and
the output is zero past its length.

The PV chains (a tempo stage on the phase vocoder) at the JAX bars: one PV
stage 70 dB, with transient resets 85, two PV stages in series 45 (the
second stage's instantaneous frequency amplifies the first's last-ulp
differences; tests/test_tv_sharded.py's docstring). The sharded stretch
itself (``pv_stretch_sharded``) against the port's offline stretch at
tests/test_pv_sharded.py's bars: 70 dB, 60 without the lock, 100 with
transient resets. The port's offline PV is held against the JAX one in
tests/test_torch_pv.py, so no JAX PV program is compiled here.

WSOLA stages, non-linear graphs and several sources are refused with the
JAX package's messages.
"""

import numpy as np
import pytest
import torch

from conftest import make_tone, snr_db
from nodey_tpu.core.graph import Graph as JGraph
from nodey_tpu.core import registry as jregistry
from nodey_tpu.processors.audio_input import AudioInput as JAudioInput
from nodey_tpu.processors.audio_output import AudioOutput as JAudioOutput
from nodey_tpu_torch.convert import graph_from_jax
from nodey_tpu_torch.core import compiler
from nodey_tpu_torch.core.errors import ProcessorRuntimeError
from nodey_tpu_torch.ops import pv
from nodey_tpu_torch.parallel import pv_sharded as pvs
from nodey_tpu_torch.parallel import tv_sharded
from nodey_tpu_torch.parallel.mesh import make_mesh
from test_deesser import _deesser, sibilant
from test_fadepan import _fade, _pan
from test_gate import _gate, gated_signal
from test_modfx import _chorus, _tremolo, noise
from test_phaser import _phaser
from test_tv_sharded import (_chain, _compressor, _eq, _limiter, _pitch,
                             _resample, _velocity, _vol)
from test_width import _width

RATE = 44_100
SP = 8


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's eager CPU ops on one thread (see
    tests/test_torch_effects.py)."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _mesh(sp=SP):
    return make_mesh({"sp": sp}, ["cpu"] * sp)


def _run_both(jgraph, src, data, sp=SP):
    """(single render, its length, sharded render, its length) of the JAX
    chain ``jgraph`` carried into the port, on ``data`` [C, n]."""
    g = graph_from_jax(jgraph)
    n = data.shape[1]
    sources = {(src, "output_0"): compiler.SourceSpec(
        rate=RATE, channels=data.shape[0], fmt="flt", capacity=n)}
    key = compiler.external_key(src, "output_0")
    single = compiler.compile_graph(g, sources, device="cpu")
    ref, ref_len = single({key: (torch.from_numpy(data), n)})[0]["master"]
    chain = tv_sharded.compile_chain_sp_tv(g, sources, _mesh(sp))
    out, out_len = chain.run(data, n)
    return ref.numpy(), ref_len, out.numpy(), out_len


def _check(name, procs, data, bar):
    ref, ref_len, out, out_len = _run_both(*_chain(*procs), data)
    assert out_len == ref_len, name
    assert not out[:, out_len:].any(), name
    n = min(ref_len, ref.shape[1], out.shape[1])
    db = snr_db(ref[:, :n], out[:, :n])
    assert db > bar, (name, db)


def test_masterbus_chains_match_the_single_render():
    loud = make_tone(rate=RATE, seconds=0.7, channels=2)
    _check("limiter", (_vol(2.0), _limiter(-1.0, 50.0)), loud, 120.0)
    _check("compressor", (_vol(2.0), _compressor(-12.0, 6.0, 2.0)), loud,
           110.0)
    _check("eq", (_eq(ls_gain_db=4.0, p2_gain_db=-6.0, hs_gain_db=-3.0),),
           loud, 80.0)
    _check("gate", (_gate(threshold_db=-40.0, ratio=6.0, release_ms=80.0),),
           gated_signal(n=RATE // 2, seed=4), 100.0)
    _check("deesser", (_deesser(threshold_db=-32.0, ratio=6.0),),
           sibilant(RATE // 2, seed=4), 90.0)
    _check("deesser after gain", (_vol(1.3), _deesser(threshold_db=-30.0)),
           sibilant(RATE // 2, seed=5), 90.0)

    # One burst at the head of shard 0 whose 500 ms release decays through
    # several later shards: the cross-shard prefix must carry it.
    burst = np.zeros((1, int(0.7 * RATE)), dtype=np.float32)
    burst[0, 100:500] = 1.5
    burst[0, 500:] = 0.05
    ref, _, out, _ = _run_both(*_chain(_limiter(-6.0, 500.0)), burst)
    assert snr_db(ref, out[:, :ref.shape[1]]) > 120.0
    assert abs(ref[0, burst.shape[1] // 2]) < 0.05

    # Below threshold the limiter passes its input bitwise, sharded too.
    quiet = (0.1 * make_tone(rate=RATE, seconds=0.6)).astype(np.float32)
    _, _, out, out_len = _run_both(*_chain(_limiter(-1.0, 50.0)), quiet)
    _, _, plain, plain_len = _run_both(*_chain(), quiet)
    assert out_len == plain_len
    np.testing.assert_array_equal(out, plain)


def test_modulation_and_channel_chains_match_the_single_render():
    _check("tremolo", (_tremolo(rate_hz=6.0, depth=0.8),),
           noise(RATE // 2, seed=4), 110.0)
    _check("chorus", (_chorus(rate_hz=0.8, base_ms=20.0, depth_ms=6.0,
                              voices=2),), noise(RATE // 2, seed=5), 100.0)
    _check("chorus with dynamics", (_vol(1.5), _chorus(rate_hz=1.0),
                                    _limiter(-3.0)),
           noise(RATE // 2, seed=6), 95.0)
    _check("phaser", (_phaser(rate_hz=0.8, f_min_hz=200.0, f_max_hz=3000.0,
                              stages=4),), noise(RATE // 2, seed=4), 110.0)
    _check("phaser with dynamics", (_vol(1.5), _phaser(rate_hz=1.0,
                                                       stages=2),
                                    _limiter(-3.0)),
           noise(RATE // 2, seed=6), 95.0)
    _check("pan", (_pan(0.5),), noise(RATE // 2, seed=12), 120.0)
    _check("pan mono", (_pan(0.2),), noise(RATE // 2, channels=1, seed=13),
           120.0)
    _check("fade", (_fade(in_ms=40.0, out_start_s=0.3, out_ms=150.0),),
           noise(RATE // 2, seed=14), 120.0)
    _check("fade anchored at the end",
           (_fade(in_ms=20.0, out_ms=200.0, anchor_end=True),),
           noise(RATE // 2, seed=16), 120.0)
    _check("pan and fade with dynamics",
           (_vol(1.4), _pan(-0.4),
            _fade(in_ms=30.0, out_start_s=0.4, out_ms=100.0),
            _limiter(-3.0)), noise(RATE // 2, seed=15), 95.0)
    _check("width", (_vol(1.2), _width(1.8),
                     _tremolo(rate_hz=4.0, depth=0.5)),
           noise(RATE // 2, seed=6), 110.0)


def test_pv_chains_match_the_single_render():
    tone = make_tone(rate=RATE, seconds=0.8, channels=2)
    _check("lti only", (_vol(0.8), _resample(48_000)),
           make_tone(rate=RATE, seconds=0.7, channels=2), 100.0)
    _check("pv only", (_velocity(0.8),), make_tone(rate=RATE, seconds=0.6),
           70.0)
    _check("full master bus", (_vol(2.0), _resample(48_000), _velocity(1.25),
                               _eq(p2_gain_db=-3.0),
                               _compressor(-18.0, 4.0, 3.0), _limiter(-1.0)),
           tone, 70.0)
    _check("limiter after pv", (_vol(2.0), _resample(48_000),
                                _velocity(1.25), _limiter(-3.0)), tone, 70.0)
    _check("config 4 shape", (_vol(1.3), _resample(48_000), _pitch(12),
                              _velocity(1.3)), tone, 45.0)

    # Onsets far above the flux threshold, so the reset decisions are the
    # same on both paths.
    onsets = 0.02 * make_tone(rate=RATE, seconds=0.6)
    for k in (1, 2):
        i = int(k * 0.18 * RATE)
        onsets[:, i:i + 400] += (
            np.sin(2 * np.pi * 1000 * np.arange(400) / RATE)
            * np.hanning(400)).astype(np.float32) * 0.9
    vel = _velocity(0.8)
    vel.pv_transient = True
    _check("pv transient", (vel,), onsets, 85.0)

    # The planner threads pv_transient and preserve_formants into its PV
    # stage (the formant ratio the node's transposition).
    p = _pitch(7)
    p.pv_transient = True
    p.preserve_formants = True
    stages, _ = tv_sharded._extract_stages(graph_from_jax(_chain(p)[0]),
                                           RATE)
    [st] = [s for s in stages if isinstance(s, tv_sharded._PvStage)]
    assert st.transient is True
    assert st.formant_ratio == pytest.approx(2 ** (7 / 12))


def test_sharded_stretch_matches_the_offline_stretch():
    rate = 48_000
    n = int(rate * 0.6)
    t = np.arange(n) / rate
    tone = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)[None]
    stereo = np.concatenate(
        [tone, (0.3 * np.sin(2 * np.pi * 660 * t)).astype(np.float32)[None]])
    onsets = (0.01 * np.sin(2 * np.pi * 330 * t)).astype(np.float32)[None]
    for k in (1, 2, 3):
        i = int(k * 0.15 * rate)
        onsets[0, i:i + 400] += (np.sin(2 * np.pi * 1000 * t[:400])
                                 * np.hanning(400)).astype(np.float32)
    for data, tempo, sp, lock, transient, bar in (
            (tone, 0.75, SP, True, False, 70.0),
            (tone, 1.9, SP, True, False, 70.0),
            (stereo, 1.25, SP, True, False, 70.0),
            (tone, 0.8, SP, False, False, 60.0),
            (tone, 1.25, 1, True, False, 70.0),
            (onsets, 1.25, SP, True, True, 100.0)):
        cap = pvs.pv_sharded_capacity(n, sp)
        out, out_len = pvs.pv_stretch_sharded(
            _mesh(sp), np.pad(data, ((0, 0), (0, cap - n))), n, tempo, rate,
            lock=lock, transient=transient)
        ref, ref_len = pv.pv_stretch_at_rate(torch.from_numpy(data), n,
                                             tempo, rate, lock=lock,
                                             transient=transient)
        assert out_len == ref_len
        assert out.shape[1] > out_len and not out[:, out_len:].any()
        m = min(out_len, ref.shape[1])
        assert snr_db(ref[:, :m].numpy(), out[:, :m].numpy()) > bar, (
            tempo, sp, lock, transient)
    with pytest.raises(ValueError, match="divisible"):
        pvs.plan_pv_sharded(1.25, rate, rate + 1, SP)
    _, hop = pv.pv_params(rate)
    with pytest.raises(ValueError, match="too short"):
        pvs.plan_pv_sharded(1.0, rate, pvs.pv_sharded_capacity(4 * hop, SP),
                            SP)


def test_chain_refusals():
    n = RATE // 2
    mesh = _mesh()

    def sources_of(src):
        return {(src, "output_0"): compiler.SourceSpec(
            rate=RATE, channels=1, fmt="flt", capacity=n)}

    jg, src = _chain(_velocity(1.3, algorithm="wsola"))
    with pytest.raises(ProcessorRuntimeError, match="serial"):
        tv_sharded.compile_chain_sp_tv(graph_from_jax(jg), sources_of(src),
                                       mesh)

    jregistry.register_all_processors()
    jg = JGraph()
    src = jg.add_node(JAudioInput())
    jg.nodes[src].processor.file_paths = ["a.wav"]
    jg.update_node_pin(src)
    v1, v2 = jg.add_node(_vol(1.0)), jg.add_node(_vol(0.5))
    out = jg.add_node(JAudioOutput())

    def pin(nid, p):
        return jg.nodes[nid].pin_name_map[p]

    jg.add_link(pin(src, "output_0"), pin(v1, "input"))
    jg.add_link(pin(src, "output_0"), pin(v2, "input"))
    jg.add_link(pin(v1, "output"), pin(out, "input"))
    with pytest.raises(ProcessorRuntimeError, match="linear chain"):
        tv_sharded.compile_chain_sp_tv(graph_from_jax(jg), sources_of(src),
                                       mesh)

    jg, src = _chain(_velocity(1.2))
    sources = sources_of(src)
    sources[(src, "output_1")] = next(iter(sources.values()))
    with pytest.raises(ProcessorRuntimeError, match="one source"):
        tv_sharded.compile_chain_sp_tv(graph_from_jax(jg), sources, mesh)
