"""BASELINE config 4 through both packages on the CPU.

One 1.5 s 44.1 kHz stereo track -> ``audio_resample`` (48 kHz) ->
``pitch_modifier`` (+4 semitones: WSOLA at tempo 2^(-1/3), then a 635/504
transposition) -> ``velocity_modifier`` (1.25, keep_pitch: WSOLA at tempo
1.25) -> ``audio_output`` (export), built as ``bench.py`` builds it. The
JAX side runs ``compile_graph`` on the port's decode of the track (the
same samples; the pitch stage's 118 frames take its blocked formulation);
the port runs ``Runner(device="cpu")`` on the graph carried over by
``graph_from_jax``. The master must
have an equal length and agree within 2e-6 (the resampler's bar: its sums
run in another order; the splice decisions are equal). With both tempo
stages on the phase vocoder the bar is 90 dB.
"""

import dataclasses
import json

import numpy as np
import pytest

from nodey_tpu.core import compiler as jcompiler
from nodey_tpu.core.graph import Graph as JGraph
from nodey_tpu.processors.audio_input import AudioInput as JAudioInput
from nodey_tpu.processors.audio_output import AudioOutput as JAudioOutput
from nodey_tpu.processors.resample_node import AudioResample as JAudioResample
from nodey_tpu.processors.velocity import PitchModifier as JPitchModifier
from nodey_tpu.processors.velocity import VelocityModifier as JVelocityModifier
from nodey_tpu_torch.convert import graph_from_jax
from nodey_tpu_torch.core.errors import ProcessorRuntimeError
from nodey_tpu_torch.core.graph import Graph
from nodey_tpu_torch.core.runner import Runner
from nodey_tpu_torch.host.decode import write_wav_s16
from nodey_tpu_torch.processors.resample_node import AudioResample
from nodey_tpu_torch.processors.velocity import PitchModifier, VelocityModifier

from conftest import snr_db


@pytest.fixture
def track(tmp_path):
    rng = np.random.default_rng(44)
    n = int(44_100 * 1.5)
    t = np.arange(n) / 44_100.0
    data = np.stack([0.4 * np.sin(2 * np.pi * 220.0 * t)
                     + 0.05 * rng.standard_normal(n),
                     0.3 * np.sin(2 * np.pi * 331.0 * t + 0.4)])
    path = str(tmp_path / "track.wav")
    write_wav_s16(path, data.astype(np.float32), 44_100)
    return path


@pytest.fixture
def noisy_track(tmp_path):
    """The tones of ``track``, each over a noise floor.

    Where a bin's phase advance sits within an ulp of the wrap's +-pi
    edge, the phase vocoder's output turns on the last bit of its analysis
    GEMMs, which no two GEMM implementations share: a noiseless tone's
    leakage bins sit there frame after frame, and now and then a noise bin
    lands there. This seeded track has no such bin in either package's
    analysis; given equal analysis planes, the phase paths are held to
    >= 100 dB in tests/test_torch_pv.py."""
    rng = np.random.default_rng(44)
    n = int(44_100 * 1.5)
    t = np.arange(n) / 44_100.0
    data = np.stack([0.4 * np.sin(2 * np.pi * 220.0 * t)
                     + 0.05 * rng.standard_normal(n),
                     0.3 * np.sin(2 * np.pi * 331.0 * t + 0.4)
                     + 0.05 * rng.standard_normal(n)])
    path = str(tmp_path / "noisy_track.wav")
    write_wav_s16(path, data.astype(np.float32), 44_100)
    return path


def config4_graph(path, algorithm="wsola"):
    """bench.py:172-192 with the JAX package's processors; ``algorithm``
    sets both tempo stages (bench.py's rtf_config4_pv uses "pv")."""
    g = JGraph()
    src = g.add_node(JAudioInput())
    g.nodes[src].processor.file_paths = [path]
    g.update_node_pin(src)
    rs = g.add_node(JAudioResample())
    g.nodes[rs].processor.target_rate = 48_000
    pitch = g.add_node(JPitchModifier())
    g.nodes[pitch].processor.pitch = 4.0
    vel = g.add_node(JVelocityModifier())
    g.nodes[vel].processor.set_velocity(1.25)
    g.nodes[vel].processor.keep_pitch = True
    out = g.add_node(JAudioOutput())

    def pin(n, p):
        return g.nodes[n].pin_name_map[p]

    g.add_link(pin(src, "output_0"), pin(rs, "input"))
    g.add_link(pin(rs, "output"), pin(pitch, "input"))
    g.add_link(pin(pitch, "output"), pin(vel, "input"))
    g.add_link(pin(vel, "output"), pin(out, "input"))
    g.nodes[pitch].processor.algorithm = algorithm
    g.nodes[vel].processor.algorithm = algorithm
    return g


def _jax_master(jg, tg):
    """The JAX compiler's master for ``jg`` on the port's decode of its
    track (the same samples)."""
    arrays, lengths, sources = Runner(tg, device="cpu").decode()
    sources = {key: jcompiler.SourceSpec(**dataclasses.asdict(spec))
               for key, spec in sources.items()}
    jout = jcompiler.compile_graph(jg, sources, mode="export").run(arrays,
                                                                    lengths)
    jmaster, jlen = jout["master"]
    return np.asarray(jmaster)[:, : int(jlen)]


def test_config4_matches_jax(track):
    jg = config4_graph(track)
    tg = graph_from_jax(jg)
    jmaster = _jax_master(jg, tg)

    result = Runner(tg, device="cpu").render("export")
    assert result.rate == 48_000 and result.fmt == "flt"
    # 66,150 -> 72,000 (48 kHz) -> 90,714 (tempo 2^(-1/3)) -> 72,000
    # (635/504) -> 57,600 (tempo 1.25).
    assert result.master.shape == jmaster.shape == (2, 57_600)
    assert np.isfinite(result.master).all()
    assert np.abs(result.master - jmaster).max() <= 2e-6


def test_config4_on_the_phase_vocoder_matches_jax(noisy_track):
    """Both tempo stages on algorithm "pv" (bench.py's rtf_config4_pv):
    equal master length, >= 90 dB (two PV stages, each holding >= 95 dB
    against the JAX package; their GEMMs, transcendentals and prefix order
    differ from XLA's by ulps, and the resampler ahead of each by 2e-6)."""
    jg = config4_graph(noisy_track, algorithm="pv")
    tg = graph_from_jax(jg)
    assert {n.processor.algorithm for n in tg.nodes.values()
            if hasattr(n.processor, "algorithm")} == {"pv"}
    jmaster = _jax_master(jg, tg)
    result = Runner(tg, device="cpu").render("export")
    assert result.master.shape == jmaster.shape == (2, 57_600)
    assert np.isfinite(result.master).all()
    assert snr_db(jmaster, result.master) >= 90.0


def test_graph_from_jax_carries_the_config4_parameters(track):
    jg = config4_graph(track)
    tg = graph_from_jax(jg)
    by_id = {n.processor.info().identifier: n.processor
             for n in tg.nodes.values()}
    assert by_id["audio_resample"].target_rate == 48_000
    assert by_id["pitch_modifier"].pitch == 4.0
    assert by_id["velocity_modifier"].velocity == 1.25
    assert by_id["velocity_modifier"].keep_pitch is True
    assert sorted(tg.links) == sorted(jg.links)


def test_project_json_is_byte_identical_in_both_packages(track):
    jg = config4_graph(track)
    text = json.dumps(jg.serialize(), indent=2)
    tg = Graph.deserialize(json.loads(text))
    assert json.dumps(tg.serialize(), indent=2) == text
    assert json.dumps(JGraph.deserialize(json.loads(
        json.dumps(tg.serialize(), indent=2))).serialize(), indent=2) == text


@pytest.mark.parametrize("make_jax,make_port,edit", [
    (JAudioResample, AudioResample,
     lambda p: setattr(p, "target_rate", 22_050)),
    (JVelocityModifier, VelocityModifier,
     lambda p: (p.set_velocity(0.75), setattr(p, "keep_pitch", True))),
    (JVelocityModifier, VelocityModifier,
     lambda p: (setattr(p, "algorithm", "pv"), setattr(p, "pv_transient", True),
                setattr(p, "preserve_formants", True))),
    (JPitchModifier, PitchModifier, lambda p: setattr(p, "pitch", -3.5)),
    (JPitchModifier, PitchModifier,
     lambda p: (setattr(p, "pitch", 7.0), setattr(p, "algorithm", "pv"))),
])
def test_node_serde_round_trips_between_packages(make_jax, make_port, edit):
    for make_from, make_to in ((make_jax, make_port), (make_port, make_jax)):
        src = make_from()
        edit(src)
        blob = src.serialize()
        dst = make_to()
        dst.deserialize(json.loads(json.dumps(blob)))
        assert json.dumps(dst.serialize()) == json.dumps(blob)
        assert dst.info().identifier == src.info().identifier
        assert [(a.identifier, a.is_input) for a in dst.pin_attributes()] == \
            [(a.identifier, a.is_input) for a in src.pin_attributes()]
        assert dst.param_spec() == src.param_spec()
    # Defaults write neither the algorithm nor the PV flags.
    assert "algorithm" not in make_port().serialize()


def test_load_clamps_like_the_jax_package():
    for value in (0, -5, 10**9, 44_100.7):
        port, jax_node = AudioResample(), JAudioResample()
        port.deserialize({"target_rate": value})
        jax_node.deserialize({"target_rate": value})
        assert port.target_rate == jax_node.target_rate
    for value in (0.1, 9.0, 1.3):
        port, jax_node = VelocityModifier(), JVelocityModifier()
        port.deserialize({"velocity": value})
        jax_node.deserialize({"velocity": value})
        assert port.velocity == jax_node.velocity


def test_pv_and_rate_guard_raise_attributed_to_their_node(track):
    jg = config4_graph(track)
    tg = graph_from_jax(jg)
    [pitch_id] = [nid for nid, n in tg.nodes.items()
                  if n.processor.info().identifier == "pitch_modifier"]
    tg.nodes[pitch_id].processor.set_algorithm("pv")
    # The phase vocoder renders (it raised before it was ported).
    master = Runner(tg, device="cpu").render("export").master
    assert master.shape == (2, 57_600) and np.isfinite(master).all()
    # An unknown algorithm is refused by the node's setter.
    with pytest.raises(ProcessorRuntimeError, match="Unknown tempo") as info:
        tg.nodes[pitch_id].processor.set_algorithm("granular")
    assert "granular" in info.value.detail

    tg = graph_from_jax(jg)
    [rs] = [n.processor for n in tg.nodes.values()
            if n.processor.info().identifier == "audio_resample"]
    rs.set_target_rate(96_000)
    with pytest.raises(ProcessorRuntimeError, match="Unsupported sample rate"):
        Runner(tg, device="cpu").render("export")
