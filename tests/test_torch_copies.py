"""The port's own copies of the JAX package's jax-free modules stay equal
to them where it matters: config values, error classes and messages, the
graph's rules and quirks, the codec runtime's sources (byte-equal) and
build, the phase vocoder's constants, geometry and host bases, and the
effect nodes' constants (the reverb's partition, the delay's echo
truncation, the LFO quantization and phase tables, the fade's ramp cap),
the timeline nodes' constants (the oscillator's waveforms and hash
constants, the generator's rates and clamps, trim's clamps, the
crossfade's ceiling, duration cap and laws), and the registry: both
packages hold the same 30 node types."""

import inspect
import json

import numpy as np
import pytest

from nodey_tpu import config as jconfig
from nodey_tpu.core import errors as jerrors
from nodey_tpu.core.graph import Graph as JGraph
from nodey_tpu.core import registry as jregistry
from nodey_tpu.ops import crossfade as jcrossfade
from nodey_tpu.ops import delay as jdelay
from nodey_tpu.ops import dynamics as jdynamics
from nodey_tpu.ops import fadepan as jfadepan
from nodey_tpu.ops import loudness as jloudness
from nodey_tpu.ops import modfx as jmodfx
from nodey_tpu.ops import oscillator as josc
from nodey_tpu.ops import pv as jpv
from nodey_tpu.ops import reverb as jreverb
from nodey_tpu.ops import scans as jscans
from nodey_tpu.ops.stft import _dft_matrices as j_dft_matrices
from nodey_tpu.processors import editnodes as jeditnodes
from nodey_tpu.processors import generator as jgenerator
from nodey_tpu_torch import config
from nodey_tpu_torch.core import errors
from nodey_tpu_torch.core import registry
from nodey_tpu_torch.core.graph import Graph
from nodey_tpu_torch.host import decode, native_lib
from nodey_tpu_torch.ops import (crossfade, delay, dynamics, fadepan,
                                 loudness, modfx, oscillator, pv, reverb,
                                 scans)
from nodey_tpu_torch.ops.stft import _dft_matrices
from nodey_tpu_torch.processors.amix import AudioAmix
from nodey_tpu_torch.processors.audio_input import AudioInput
from nodey_tpu_torch.processors.audio_output import AudioOutput
from nodey_tpu_torch.processors import editnodes, generator
from nodey_tpu_torch.processors.audio_vol import AudioVol


@pytest.mark.parametrize("name", [
    "SAMPLE_RATE", "AUDIO_INPUT_NODE_NAME", "AUDIO_VOLUME_MAX",
    "AMIX_STD_SAMPLE_RATE", "BIMIX_STD_SAMPLE_RATE",
    "AUDIO_STREAM_BUFFER_SIZE", "BUFFER_SIZE",
    "MAX_BUFFER_ITEMS",
])
def test_config_values_equal_the_jax_package(name):
    assert getattr(config, name) == getattr(jconfig, name)


@pytest.mark.parametrize("module,jmodule,name", [
    (scans, jscans, "_W"), (scans, jscans, "_BLOCK_THRESHOLD"),
    (scans, jscans, "_NEG"), (dynamics, jdynamics, "_LOG_FLOOR"),
    (dynamics, jdynamics, "_NAT_TO_DB"), (dynamics, jdynamics, "_DB_TO_NAT"),
    (loudness, jloudness, "_SHELF_48K"), (loudness, jloudness, "_HP_48K"),
    (loudness, jloudness, "ABS_GATE_LKFS"), (loudness, jloudness, "BLOCK_S"),
    (loudness, jloudness, "HOP_S"), (loudness, jloudness, "REL_GATE_LU"),
    (loudness, jloudness, "_OFFSET"), (loudness, jloudness, "_SILENCE_FLOOR"),
])
def test_master_bus_constants_equal_the_jax_package(module, jmodule, name):
    got, want = getattr(module, name), getattr(jmodule, name)
    assert got == want and type(got) is type(want)


@pytest.mark.parametrize("module,jmodule,name", [
    (reverb, jreverb, "PARTITION"), (reverb, jreverb, "_F"),
    (reverb, jreverb, "_BINS"), (delay, jdelay, "_MAX_ECHOES"),
    (delay, jdelay, "_TRUNCATE_DB"), (modfx, jmodfx, "_DEN_MAX"),
    (modfx, jmodfx, "_LO_BITS"), (modfx, jmodfx, "_LO"),
    (fadepan, jfadepan, "_RAMP_MAX_MS"),
])
def test_effect_constants_equal_the_jax_package(module, jmodule, name):
    got, want = getattr(module, name), getattr(jmodule, name)
    assert got == want and type(got) is type(want)


@pytest.mark.parametrize("module,jmodule,name", [
    (oscillator, josc, "WAVEFORMS"), (oscillator, josc, "_M_MAX"),
    (oscillator, josc, "_FMIX_C1"), (oscillator, josc, "_FMIX_C2"),
    (generator, jgenerator, "_STD_RATES"), (crossfade, jcrossfade,
                                             "_ANCHOR_MAX"),
    (crossfade, jcrossfade, "_DUR_MAX_MS"), (crossfade, jcrossfade, "LAWS"),
])
def test_timeline_constants_equal_the_jax_package(module, jmodule, name):
    got, want = getattr(module, name), getattr(jmodule, name)
    assert got == want and type(got) is type(want)


@pytest.mark.parametrize("cls,jcls", [
    (generator.AudioGenerator, jgenerator.AudioGenerator),
    (editnodes.AudioTrim, jeditnodes.AudioTrim),
])
def test_timeline_clamps_equal_the_jax_package(cls, jcls):
    assert cls._CLAMPS == jcls._CLAMPS
    for key, (lo, hi) in cls._CLAMPS.items():
        assert type(lo) is type(jcls._CLAMPS[key][0])
        assert type(hi) is type(jcls._CLAMPS[key][1])


def test_oscillator_quantization_equals_the_jax_package():
    for rate in generator._STD_RATES:
        for freq in (0.001, 1.0, 97.0, 333.3, 440.7, 20_000.0, 1e6):
            assert oscillator.osc_quantize(freq, rate) == josc.osc_quantize(
                freq, rate)


def test_the_registries_hold_the_same_30_node_types():
    """Identifiers, pins, param_spec and the default instance's serialize,
    node type by node type."""
    registry.register_all_processors()
    jregistry.register_all_processors()
    assert sorted(registry.processor_map) == sorted(jregistry.processor_map)
    assert len(registry.processor_map) == 30
    for identifier, info in registry.processor_map.items():
        node, jnode = info.generate(), jregistry.processor_map[
            identifier].generate()
        assert node.info().identifier == identifier
        assert [(a.identifier, a.display_name, a.is_input)
                for a in node.pin_attributes()] == \
            [(a.identifier, a.display_name, a.is_input)
             for a in jnode.pin_attributes()], identifier
        assert node.param_spec() == jnode.param_spec(), identifier
        assert json.dumps(node.serialize()) == json.dumps(
            jnode.serialize()), identifier


def test_lfo_phase_tables_equal_the_jax_package():
    for rate_hz, sample_rate, width in ((0.4, 48_000, 768_000),
                                        (5.3, 8_000, 4_096),
                                        (20.0, 44_100, 1)):
        num, m = modfx.lfo_quantize(rate_hz, sample_rate)
        for got, want in zip(modfx._phase_tables(num, m, width),
                             jmodfx._phase_tables(num, m, width)):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype == np.int32


def test_exec_config_pad_quantum_equals_the_jax_package():
    assert config.DEFAULT_EXEC.pad_quantum == jconfig.DEFAULT_EXEC.pad_quantum


def test_error_classes_and_messages_equal_the_jax_package():
    names = sorted(n for n, v in inspect.getmembers(jerrors, inspect.isclass)
                   if issubclass(v, Exception) and v.__module__ == jerrors.__name__)
    assert names == sorted(
        n for n, v in inspect.getmembers(errors, inspect.isclass)
        if issubclass(v, Exception) and v.__module__ == errors.__name__)
    cases = [("MismatchedPinError", (3, 5)), ("LoopDetectedError", ()),
             ("MultipleInputError", (7,)), ("InvalidFileError", ("bad",)),
             ("ProcessorRuntimeError", ("m", "e", "d")),
             ("UnstreamableGraphError", ("m", "e")), ("RunCancelled", ("x",))]
    for name, args in cases:
        assert str(getattr(errors, name)(*args)) == str(getattr(jerrors, name)(*args))
    assert issubclass(errors.ProcessorRuntimeError, errors.NodeyError)
    assert not issubclass(errors.NodeyError, jerrors.NodeyError)


def _chain():
    g = Graph()
    src = g.add_node(AudioInput())
    vol = g.add_node(AudioVol())
    out = g.add_node(AudioOutput())
    g.add_link(g.nodes[src].pin_name_map["output_0"],
               g.nodes[vol].pin_name_map["input"])
    g.add_link(g.nodes[vol].pin_name_map["output"],
               g.nodes[out].pin_name_map["input"])
    return g, src, vol, out


def test_graph_keeps_the_reference_quirks():
    g, src, vol, out = _chain()
    assert not isinstance(g, JGraph)
    g.check_graph()
    # A second link into an occupied input pin is accepted by add_link
    # and reported by check_graph (reference parity).
    amix = g.add_node(AudioAmix())
    g.add_link(g.nodes[amix].pin_name_map["output"],
               g.nodes[out].pin_name_map["input"])
    with pytest.raises(errors.MultipleInputError):
        g.check_graph()
    with pytest.raises(errors.MultipleInputError):
        g.add_link(g.nodes[src].pin_name_map["output_0"],
                   g.nodes[out].pin_name_map["input"])
    # Smallest-free IDs, singleton bookkeeping.
    g.remove_node(vol)
    assert g.add_node(AudioVol()) == vol
    with pytest.raises(errors.LogicError):
        g.add_node(AudioOutput())


def test_graph_rejects_bad_files_like_the_jax_package():
    bad = [[], {"nodes": [], "links": []}, {"nodes": {"1x": {}}, "links": []},
           {"nodes": {"0": {"identifier": "nope"}}, "links": []},
           {"nodes": {}, "links": [{"from": {"node": 0, "pin": "a"},
                                    "to": {"node": 1, "pin": "b"}}]}]
    for blob in bad:
        with pytest.raises(errors.InvalidFileError) as port_err:
            Graph.deserialize(blob)
        with pytest.raises(jerrors.InvalidFileError) as jax_err:
            JGraph.deserialize(blob)
        assert str(port_err.value) == str(jax_err.value)


def test_codec_runtime_builds_in_the_port_build_directory():
    # The port's codec sources are byte-for-byte the JAX package's (so the
    # JAX package's ASan build covers them too), the swr shim that the
    # compat="swr" banks measure through included.
    port_dir = native_lib._NATIVE_DIR
    jax_dir = port_dir.parents[2] / "nodey_tpu" / "host" / "native"
    for name in ("decode.cpp", "encode.cpp", "swr_shim.cpp", "nodey_host.h"):
        assert (port_dir / name).read_bytes() == (jax_dir / name).read_bytes(), \
            name
    lib = decode.load_native()
    if lib is None:
        pytest.skip("the codec runtime does not build on this machine")
    path = native_lib.library_path()
    assert path.parts[-3:] == ("nodey_tpu_torch", "native", "libnodey_host.so")
    assert path.exists() and (path.parent / "build.lock").exists()
    assert native_lib.load() is lib


def test_geometry_and_bases_equal_the_jax_package():
    for rate in (8_000, 22_050, 44_100, 48_000):
        assert pv.pv_params(rate) == jpv.pv_params(rate)
        for tempo in (0.7937005259840998, 1.25, 2.0):
            got, want = pv._pv_geometry(12_345, tempo, rate), jpv._pv_geometry(
                12_345, tempo, rate)
            assert got[:2] == want[:2] and got[4] == want[4]
            np.testing.assert_array_equal(got[2], want[2])
            np.testing.assert_array_equal(got[3], want[3])
    for n_fft in (512, 1024, 2048):
        for mine, theirs in ((_dft_matrices(n_fft), j_dft_matrices(n_fft)),
                             (pv._idft_matrices(n_fft), jpv._idft_matrices(n_fft)),
                             (pv._cepstral_matrices(n_fft),
                              jpv._cepstral_matrices(n_fft))):
            for a, b in zip(mine, theirs):
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(pv._pv_window(n_fft), jpv._pv_window(n_fft))
    assert pv.PV_TRANSIENT_FLUX == jpv.PV_TRANSIENT_FLUX
    assert pv.PV_FORMANT_LIFTER_DIV == jpv.PV_FORMANT_LIFTER_DIV
