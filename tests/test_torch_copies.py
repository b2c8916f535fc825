"""The port's own copies of the JAX package's jax-free modules stay equal
to them where it matters: config values, error classes and messages, the
graph's rules and quirks, the codec runtime's build, and the phase
vocoder's constants, geometry and host bases."""

import inspect

import numpy as np
import pytest

from nodey_tpu import config as jconfig
from nodey_tpu.core import errors as jerrors
from nodey_tpu.core.graph import Graph as JGraph
from nodey_tpu.ops import pv as jpv
from nodey_tpu.ops.stft import _dft_matrices as j_dft_matrices
from nodey_tpu_torch import config
from nodey_tpu_torch.core import errors
from nodey_tpu_torch.core.graph import Graph
from nodey_tpu_torch.host import decode, native_lib
from nodey_tpu_torch.ops import pv
from nodey_tpu_torch.ops.stft import _dft_matrices
from nodey_tpu_torch.processors.amix import AudioAmix
from nodey_tpu_torch.processors.audio_input import AudioInput
from nodey_tpu_torch.processors.audio_output import AudioOutput
from nodey_tpu_torch.processors.audio_vol import AudioVol


@pytest.mark.parametrize("name", [
    "SAMPLE_RATE", "AUDIO_INPUT_NODE_NAME", "AUDIO_VOLUME_MAX",
    "AMIX_STD_SAMPLE_RATE", "AUDIO_STREAM_BUFFER_SIZE", "BUFFER_SIZE",
    "MAX_BUFFER_ITEMS",
])
def test_config_values_equal_the_jax_package(name):
    assert getattr(config, name) == getattr(jconfig, name)


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
