"""The port's meshes, collectives and sharded graphs
(``nodey_tpu_torch.parallel``) on the CPU.

The port's meshes here are CPU devices passed explicitly (``["cpu"] *
8``): one process loops over the shards, as it does over a virtual mesh of
one card. The JAX package's side runs on its 8 forced CPU devices
(tests/conftest.py).

- ``make_mesh``: shapes, the -1 axis and the device-count check as the JAX
  one; a repeated device is a virtual mesh; with no card and no devices
  named it raises instead of falling back to the CPU. ``ppermute`` gives
  zeros where no pair ends, ``psum`` sums host ints.
- ``halo_exchange_nd``, multi-hop halos included, and the one-hop
  ``_halo_exchange`` equal the JAX ones under ``shard_map`` at tiny shapes, and ``sharded_resample`` (sp, and dp x sp)
  is bitwise the port's ``resample_data``.
- The plans equal the JAX planners' field by field on the JAX package's
  8-device mesh (the planners compile nothing there): ``ShardPlan`` of the
  5-node graph at sp and dp x sp, mixed input rates, a nonzero t0 and a
  halo wider than a shard, the capacities; ``PvShardPlan`` over tempos,
  rates, shard counts and alignments; ``ChainPlan`` of chains holding every
  stage type, the PV stages' plans and the resample stages' banks
  included.
- ``compile_graph_sharded`` is bitwise the port's single render wherever
  tests/test_sharded_graph.py asserts bitwise for the JAX package: the
  5-node graph at sp 8 (its spectrum too) and at dp 2 x sp 4, mixed input
  rates, a nonzero t0, the multi-hop halo; the 22.05 + 48 kHz mix within
  the 3e-7 that file allows. Each master is held against the JAX
  package's single-device render at tests/test_torch_batch.py's bar for
  the 5-node graph: 2e-6 (the resampler sums in another order), the
  spectrum >= 100 dB. A time-variant graph is refused.
- ``compile_graph_dp`` of the config-4-shaped graph on WSOLA and on the
  phase vocoder, dp 4: every clip bitwise its single render, the WSOLA
  clips within 2e-6 of the JAX single render (tests/test_torch_batch.py's
  config-4 bar; the port's PV against the JAX PV is in
  tests/test_torch_pv.py). ``run_batch(mesh=)`` is bitwise ``run_batch``;
  a batch that does not split over dp, and an input on another device,
  raise.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from conftest import make_tone, snr_db
from nodey_tpu.core import compiler as jcompiler
from nodey_tpu.core import registry as jregistry
from nodey_tpu.core.graph import Graph as JGraph
from nodey_tpu.parallel import ops as jops
from nodey_tpu.parallel import pv_sharded as jpvs
from nodey_tpu.parallel import sharded as jsharded
from nodey_tpu.parallel import tv_sharded as jtv
from nodey_tpu.parallel.mesh import make_mesh as jmake_mesh
from nodey_tpu.processors.audio_input import AudioInput as JAudioInput
from nodey_tpu.processors.audio_output import AudioOutput as JAudioOutput
from nodey_tpu.processors.bimix import AudioBimixV2 as JAudioBimixV2
from nodey_tpu.processors.resample_node import AudioResample as JAudioResample
from nodey_tpu.processors.velocity import PitchModifier as JPitchModifier
from nodey_tpu.processors.velocity import VelocityModifier as JVelocity
from nodey_tpu_torch.convert import graph_from_jax
from nodey_tpu_torch.core import compiler
from nodey_tpu_torch.core.errors import LogicError, ProcessorRuntimeError
from nodey_tpu_torch.ops import resample as tr
from nodey_tpu_torch.parallel import ops as pops
from nodey_tpu_torch.parallel import pv_sharded as pvs
from nodey_tpu_torch.parallel import sharded, tv_sharded
from nodey_tpu_torch.parallel.mesh import make_mesh
from test_deesser import _deesser
from test_fadepan import _fade, _pan
from test_gate import _gate
from test_modfx import _chorus, _tremolo
from test_phaser import _phaser
from test_sharded_graph import _flagship, _sources_and_args, _two_source_mix_graph
from test_tv_sharded import (_chain, _compressor, _eq, _limiter, _pitch,
                             _resample, _velocity, _vol)
from test_width import _width

TOL = 2e-6
SPECTRUM_DB = 100.0


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's eager CPU ops on one thread (see
    tests/test_torch_effects.py)."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _meshes(axes):
    """(the JAX package's mesh, the port's mesh of CPU devices)."""
    n = int(np.prod(list(axes.values())))
    return jmake_mesh(axes), make_mesh(axes, ["cpu"] * n)


def _port_sources(jsources):
    return {k: compiler.SourceSpec(**dataclasses.asdict(v))
            for k, v in jsources.items()}


def _same(a, b) -> bool:
    """Field-by-field equality of plans: dataclasses by their fields,
    arrays bitwise, sequences element by element."""
    if dataclasses.is_dataclass(a) and dataclasses.is_dataclass(b):
        fa, fb = dataclasses.fields(a), dataclasses.fields(b)
        return (type(a).__name__ == type(b).__name__
                and [f.name for f in fa] == [f.name for f in fb]
                and all(_same(getattr(a, f.name), getattr(b, f.name))
                        for f in fa))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (np.asarray(a).dtype == np.asarray(b).dtype
                and np.array_equal(a, b))
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return type(a) is type(b) and a == b


def test_make_mesh_and_collectives(monkeypatch):
    mesh = make_mesh({"dp": 2, "sp": 4}, ["cpu"] * 8)
    assert mesh.shape == {"dp": 2, "sp": 4}
    assert mesh.axis_names == ("dp", "sp")
    assert make_mesh({"dp": 2, "sp": -1}, ["cpu"] * 8).shape["sp"] == 4
    assert mesh.distinct_devices() == [torch.device("cpu")]
    assert mesh.axis_devices("sp", dp=1) == [torch.device("cpu")] * 4
    with pytest.raises(ValueError, match="needs 16 devices"):
        make_mesh({"dp": 16}, ["cpu"] * 8)
    with pytest.raises(ValueError, match="at most one"):
        make_mesh({"dp": -1, "sp": -1}, ["cpu"] * 8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ProcessorRuntimeError, match="No CUDA device"):
        make_mesh({"sp": 4})
    with pytest.raises(ProcessorRuntimeError, match="No CUDA device"):
        make_mesh({"sp": 4}, ["cuda:0"] * 4)

    xs = [torch.full((2, 3), float(i)) for i in range(4)]
    got = pops.ppermute(xs, [(0, 2), (1, 3)])
    assert [float(g[0, 0]) for g in got] == [0.0, 0.0, 0.0, 1.0]
    assert pops.psum([3, 4, 5]) == 12


def test_halo_exchange_and_sharded_resample_match():
    rng = np.random.default_rng(0)
    for sp, n, left, right in ((8, 5, 12, 3), (4, 16, 3, 40), (2, 7, 0, 5),
                               (8, 64, 2, 0)):
        x = rng.standard_normal((2, sp * n)).astype(np.float32)
        jmesh, mesh = _meshes({"sp": sp})
        fn = jops.shard_map(
            lambda v: jops.halo_exchange_nd(v, left, right, "sp"),
            mesh=jmesh, in_specs=(P(None, "sp"),), out_specs=P(None, "sp"),
            check_vma=False)
        want = np.asarray(fn(jnp.asarray(x)))
        got = pops.halo_exchange_nd(
            pops.split_time(torch.from_numpy(x), mesh.axis_devices("sp")),
            left, right)
        np.testing.assert_array_equal(torch.cat(got, -1).numpy(), want)
        if max(left, right) <= n:
            fn = jops.shard_map(
                lambda v: jops._halo_exchange(v, left, right, "sp"),
                mesh=jmesh, in_specs=(P(None, "sp"),),
                out_specs=P(None, "sp"), check_vma=False)
            got = pops._halo_exchange(
                pops.split_time(torch.from_numpy(x), mesh.axis_devices("sp")),
                left, right)
            np.testing.assert_array_equal(torch.cat(got, -1).numpy(),
                                          np.asarray(fn(jnp.asarray(x))))

    for axes, batch in (({"sp": 8}, ()), ({"dp": 2, "sp": 4}, (4,))):
        jmesh, mesh = _meshes(axes)
        for in_rate, out_rate in ((44_100, 48_000), (48_000, 32_000)):
            q = pops.sharded_time_quantum(mesh, in_rate, out_rate)
            assert q == jops.sharded_time_quantum(jmesh, in_rate, out_rate)
            # tests/test_sharding.py's lengths: at a few groups a shard the
            # plain version's CPU GEMM rounds by its row count.
            n = q * 20 if batch else ((in_rate * 2) // q + 1) * q
            x = torch.from_numpy((0.3 * rng.standard_normal(
                batch + (2, n))).astype(np.float32))
            got = pops.sharded_resample(mesh, x, in_rate, out_rate,
                                        batch_axes=("dp",) if batch else ())
            want = tr.resample_data(x, in_rate, out_rate)
            m = min(got.shape[-1], want.shape[-1])
            assert torch.equal(got[..., :m], want[..., :m])


def _t0_graph():
    """bimix_v2 of two sources (tests/test_sharded_graph.py's t0 graph)."""
    jregistry.register_all_processors()
    g = JGraph()
    src = g.add_node(JAudioInput())
    g.nodes[src].processor.file_paths = ["0.wav", "1.wav"]
    g.update_node_pin(src)
    merge = g.add_node(JAudioBimixV2())
    out = g.add_node(JAudioOutput())

    def pin(n, p):
        return g.nodes[n].pin_name_map[p]

    g.add_link(pin(src, "output_0"), pin(merge, "input_l"))
    g.add_link(pin(src, "output_1"), pin(merge, "input_r"))
    g.add_link(pin(merge, "output"), pin(out, "input"))
    return g, src


def _mixed_case(g, src, jmesh, rates, seconds, t0s=(0.0, 0.0), cut=997,
                fmt="s16"):
    """(sources, arrays, lengths) of two sources at ``rates`` padded to one
    shard-aligned duration (the JAX test's capacities), each a tone plus
    noise, the second ``cut`` samples shorter."""
    spread = int(max(rates) * (max(t0s) - min(t0s)) * 1e-6)
    caps = jsharded.plan_capacities_for(
        g, {i: (r, int(r * seconds) + spread) for i, r in enumerate(rates)},
        jmesh)
    rng = np.random.default_rng(3)
    arrays, lengths, sources = {}, {}, {}
    for i, r in enumerate(rates):
        n = int(r * seconds) - cut * i
        tone = make_tone(rate=r, seconds=seconds, freq=180.0 * (i + 1),
                         channels=2)
        tone = tone + 0.01 * rng.standard_normal(tone.shape).astype(np.float32)
        padded = np.zeros((2, caps[i]), dtype=np.float32)
        padded[:, :n] = tone[:, :n]
        key = jcompiler.external_key(src, f"output_{i}")
        arrays[key], lengths[key] = padded, n
        sources[(src, f"output_{i}")] = jcompiler.SourceSpec(
            rate=r, channels=2, fmt=fmt, capacity=caps[i], t0_us=t0s[i])
    return sources, arrays, lengths


def _cases():
    """(name, JAX graph, JAX sources, arrays, lengths, mesh axes, dp axis)
    of tests/test_sharded_graph.py's sharded cases."""
    jregistry.register_all_processors()
    out = []
    jmesh, _ = _meshes({"sp": 8})
    g, src = _flagship()
    arrays, lengths, sources = _sources_and_args(g, src, jmesh)
    out.append(("5-node sp 8", g, sources, arrays, lengths, {"sp": 8}, None))
    jmesh, _ = _meshes({"dp": 2, "sp": 4})
    g, src = _flagship(with_spectrum=False)
    arrays, lengths, sources = _sources_and_args(g, src, jmesh)
    rng = np.random.default_rng(7)
    batch = {k: np.stack([a] + [a * rng.uniform(0.5, 1.0) for _ in range(3)]
                         ).astype(np.float32) for k, a in arrays.items()}
    blens = {k: [lengths[k], lengths[k] - 777, lengths[k], 0]
             for k in arrays}
    for k, n in blens.items():
        for b, m in enumerate(n):
            batch[k][b, :, m:] = 0.0
    out.append(("5-node dp 2 x sp 4", g, sources, batch, blens,
                {"dp": 2, "sp": 4}, "dp"))
    jmesh, _ = _meshes({"sp": 8})
    g, src = _flagship(with_spectrum=False)
    out.append(("mixed rates", g, *_mixed_case(g, src, jmesh,
                                               (44_100, 48_000), 1.3),
                {"sp": 8}, None))
    g, src = _t0_graph()
    out.append(("t0", g, *_mixed_case(g, src, jmesh, (48_000, 48_000), 2.1,
                                      t0s=(0.0, 150_000.0), cut=1113,
                                      fmt="flt"), {"sp": 8}, None))
    g, src = _two_source_mix_graph()
    out.append(("multi-hop halo", g, *_mixed_case(g, src, jmesh,
                                                  (8_000, 48_000), 1.0,
                                                  cut=31, fmt="flt"),
                {"sp": 8}, None))
    out.append(("22.05 + 48 kHz", g, *_mixed_case(g, src, jmesh,
                                                  (22_050, 48_000), 1.0,
                                                  cut=31, fmt="flt"),
                {"sp": 8}, None))
    return out


def test_plans_equal_the_jax_planners():
    for name, g, jsources, _, _, axes, _ in _cases():
        jmesh, mesh = _meshes(axes)
        want = jsharded.plan_sharded(g, jsources, jmesh)
        got = sharded.plan_sharded(graph_from_jax(g), _port_sources(jsources),
                                   mesh)
        assert _same(got, want), name
        assert got.window == want.window and got.capacity == want.capacity
        rl = {i: (s.rate, s.capacity - 5) for i, s in
              enumerate(jsources.values())}
        assert (sharded.plan_capacities_for(graph_from_jax(g), rl, mesh)
                == jsharded.plan_capacities_for(g, rl, jmesh)), name
        rate = next(iter(jsources.values())).rate
        for n in (1, 12_345, 99_999):
            assert (sharded.plan_capacity_for(graph_from_jax(g), rate, n, mesh)
                    == jsharded.plan_capacity_for(g, rate, n, jmesh)), name

    for tempo, rate, cap, sp, align in ((1.25, 48_000, 48_000, 8, 1),
                                        (0.75, 44_100, 44_104, 4, 1),
                                        (1.9, 48_000, 96_000, 8, 3),
                                        (2 ** (-4 / 12), 48_000, 72_000, 4,
                                         5),
                                        (1.0, 22_050, 22_050, 1, 1)):
        assert _same(pvs.plan_pv_sharded(tempo, rate, cap, sp, align),
                     jpvs.plan_pv_sharded(tempo, rate, cap, sp, align))
    assert pvs.pv_sharded_capacity(1001, 8) == jpvs.pv_sharded_capacity(1001,
                                                                         8)

    pitch = _pitch(7)
    pitch.pv_transient = True
    pitch.preserve_formants = True
    chains = (
        (_vol(2.0), _resample(48_000), _velocity(1.25), _eq(p2_gain_db=-3.0),
         _compressor(-18.0, 4.0, 3.0), _limiter(-1.0)),
        (_vol(1.3), _resample(48_000), _pitch(12), _velocity(1.3)),
        (pitch, _gate(threshold_db=-40.0), _deesser(threshold_db=-30.0),
         _tremolo(rate_hz=6.0, depth=0.8), _chorus(rate_hz=0.8),
         _phaser(rate_hz=0.8, stages=4), _pan(-0.3), _width(1.5),
         _fade(in_ms=30.0, out_start_s=0.4, out_ms=100.0)),
        (_resample(32_000), _velocity(0.8), _resample(44_100)),
    )
    for sp in (8, 3):
        jmesh, mesh = _meshes({"sp": sp})
        for procs in chains:
            g, _src = _chain(*procs)
            want = jtv.plan_chain(g, 44_100, 33_333, jmesh)
            got = tv_sharded.plan_chain(graph_from_jax(g), 44_100, 33_333,
                                        mesh)
            assert _same(got, want), [type(s).__name__ for s in want.stages]
            assert got.out_capacity == want.out_capacity


def test_sharded_graphs_match_the_single_render_and_jax():
    for name, g, jsources, arrays, lengths, axes, dp_axis in _cases():
        _, mesh = _meshes(axes)
        pg, sources = graph_from_jax(g), _port_sources(jsources)
        sc = sharded.compile_graph_sharded(pg, sources, mesh, dp_axis=dp_axis)
        out = sc.run(arrays, lengths)
        assert not sc.dropped_outputs, name
        master, glen = out["master"]
        single = compiler.compile_graph(pg, sources, device="cpu")
        clips = range(len(glen)) if dp_axis else [None]
        for b in clips:
            args = {k: (torch.from_numpy(v if b is None else v[b]),
                        lengths[k] if b is None else lengths[k][b])
                    for k, v in arrays.items()}
            ref, _ = single(args)
            ref_master, ref_len = ref["master"]
            got = master if b is None else master[b]
            got_len = glen if b is None else glen[b]
            assert got_len == ref_len, name
            n = ref_len
            if name == "22.05 + 48 kHz":
                # tests/test_sharded_graph.py's last-ulp allowance.
                assert (got[..., :n] - ref_master[..., :n]).abs().max() \
                    <= 3e-7, name
            else:
                assert torch.equal(got[..., :n], ref_master[..., :n]), name
                assert not got[..., n:].any(), name
            for k, frames in ref.items():
                if k.startswith("spectrum_"):
                    f = frames.shape[1]
                    assert torch.equal(out[k][:, :f], frames), name
        if name not in ("5-node sp 8", "5-node dp 2 x sp 4"):
            continue
        # The JAX package's single-device render of the same samples.
        jsingle = jcompiler.compile_graph(g, jsources, mode="export")
        b0 = {k: (v if dp_axis is None else v[0]) for k, v in arrays.items()}
        l0 = {k: (v if dp_axis is None else v[0]) for k, v in lengths.items()}
        want = jsingle.run(b0, l0)
        got = master if dp_axis is None else master[0]
        assert int(want["master"][1]) == (glen if dp_axis is None
                                          else glen[0])
        assert np.abs(got.numpy() - np.asarray(want["master"][0])).max() \
            <= TOL, name
        for k, frames in want.items():
            if k.startswith("spectrum_"):
                f = np.asarray(frames).shape[1]
                assert snr_db(np.asarray(frames),
                              out[k][:, :f].numpy()) >= SPECTRUM_DB

    jregistry.register_all_processors()
    g = JGraph()
    src = g.add_node(JAudioInput())
    g.nodes[src].processor.file_paths = ["a.wav"]
    g.update_node_pin(src)
    vel = g.add_node(JVelocity())
    out = g.add_node(JAudioOutput())
    g.add_link(g.nodes[src].pin_name_map["output_0"],
               g.nodes[vel].pin_name_map["input"])
    g.add_link(g.nodes[vel].pin_name_map["output"],
               g.nodes[out].pin_name_map["input"])
    with pytest.raises(ProcessorRuntimeError, match="not time-shardable"):
        sharded.compile_graph_sharded(
            graph_from_jax(g), {(src, "output_0"): compiler.SourceSpec(
                rate=48_000, channels=2, fmt="flt", capacity=48_000 * 8)},
            _meshes({"sp": 8})[1])


def _config4_shaped(algorithm):
    """tests/test_sharded_graph.py's dp graph: resample 48 kHz -> pitch +3
    -> velocity 1.25 keep_pitch."""
    jregistry.register_all_processors()
    g = JGraph()
    src = g.add_node(JAudioInput())
    g.nodes[src].processor.file_paths = ["0.wav"]
    g.update_node_pin(src)
    rs = g.add_node(JAudioResample())
    g.nodes[rs].processor.target_rate = 48_000
    pitch = g.add_node(JPitchModifier())
    g.nodes[pitch].processor.pitch = 3.0
    vel = g.add_node(JVelocity())
    g.nodes[vel].processor.set_velocity(1.25)
    g.nodes[vel].processor.keep_pitch = True
    out = g.add_node(JAudioOutput())
    for nid in (pitch, vel):
        g.nodes[nid].processor.algorithm = algorithm

    def pin(n, p):
        return g.nodes[n].pin_name_map[p]

    g.add_link(pin(src, "output_0"), pin(rs, "input"))
    g.add_link(pin(rs, "output"), pin(pitch, "input"))
    g.add_link(pin(pitch, "output"), pin(vel, "input"))
    g.add_link(pin(vel, "output"), pin(out, "input"))
    return g, src


def test_dp_graphs_match_the_single_render():
    rate, cap, B = 44_100, 11_025, 4
    rng = np.random.default_rng(7)
    batch = (0.3 * rng.standard_normal((B, 2, cap))).astype(np.float32)
    lens = [cap - 17 * i for i in range(B)]
    for b, n in enumerate(lens):
        batch[b, :, n:] = 0.0
    _, mesh = _meshes({"dp": B})
    for algorithm in ("wsola", "pv"):
        g, src = _config4_shaped(algorithm)
        key = jcompiler.external_key(src, "output_0")
        jsources = {(src, "output_0"): jcompiler.SourceSpec(
            rate=rate, channels=2, fmt="flt", capacity=cap)}
        pg, sources = graph_from_jax(g), _port_sources(jsources)
        dp = sharded.compile_graph_dp(pg, sources, mesh)
        data, got_lens = dp.run({key: batch}, {key: lens})["master"]
        single = compiler.compile_graph(pg, sources, device="cpu")
        for b in range(B):
            ref, ref_len = single({key: (torch.from_numpy(batch[b]),
                                         lens[b])})[0]["master"]
            assert got_lens[b] == ref_len
            assert torch.equal(data[b], ref), (algorithm, b)
        if algorithm == "wsola":
            want, want_len = jcompiler.compile_graph(
                g, jsources, mode="export").run(
                    {key: batch[1]}, {key: lens[1]})["master"]
            assert int(want_len) == got_lens[1]
            assert np.abs(data[1].numpy() - np.asarray(want)).max() <= TOL

        # run_batch(mesh=) is run_batch; the batch must split over dp.
        bargs, blens = {key: torch.from_numpy(batch)}, {key: lens}
        plain, _ = single.run_batch(bargs, blens)
        meshed, _ = single.run_batch(bargs, blens, mesh=mesh, dp_axis="dp")
        assert torch.equal(plain["master"][0], meshed["master"][0])
        assert plain["master"][1] == meshed["master"][1]
    with pytest.raises(LogicError, match="does not split"):
        single.run_batch({key: torch.from_numpy(batch[:3])},
                         {key: lens[:3]}, mesh=mesh)
    jmesh, smesh = _meshes({"sp": 8})
    g, src = _flagship(with_spectrum=False)
    arrays, lengths, jsources = _sources_and_args(g, src, jmesh)
    sc = sharded.compile_graph_sharded(graph_from_jax(g),
                                       _port_sources(jsources), smesh)
    with pytest.raises(LogicError, match="first device"):
        sc.run({k: torch.from_numpy(v).to("meta") for k, v in arrays.items()},
               lengths)
