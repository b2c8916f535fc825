"""The 5-node stereo graph through both packages on the CPU.

Two 0.5 s 44.1 kHz stereo s16 tracks -> gain 1.5 on track 1 -> amix
0.6/0.4 (both resampled to 48 kHz) -> spectrum tap -> output. The JAX side
runs ``compile_graph`` on its own decode; the port runs
``Runner(device="cpu")`` on a graph carried over by ``graph_from_jax``.
The master must have an equal length and agree within 2e-6 (the
resampler's float32 sums are taken in another order); the spectrum within
100 dB SNR.
"""

import json

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from nodey_tpu.core import compiler as jcompiler
from nodey_tpu_torch.core.errors import ProcessorRuntimeError
from nodey_tpu.core.graph import Graph as JGraph
from nodey_tpu.core.runner import Runner as JRunner
from nodey_tpu_torch.convert import graph_from_jax
from nodey_tpu_torch.core.graph import Graph
from nodey_tpu_torch.core.runner import Runner
from nodey_tpu_torch.host.decode import write_wav_s16

from conftest import snr_db


@pytest.fixture
def tracks(tmp_path):
    rng = np.random.default_rng(1234)
    n = 22_050
    paths = []
    for i in range(2):
        t = np.arange(n) / 44_100.0
        tone = 0.4 * np.sin(2 * np.pi * (220.0 * (i + 1)) * t)
        data = np.stack([tone, 0.25 * rng.standard_normal(n)])
        path = str(tmp_path / f"track_{i}.wav")
        write_wav_s16(path, data.astype(np.float32), 44_100)
        paths.append(path)
    return paths


def test_flagship_graph_matches_jax(tracks):
    jg, _ = graft._flagship_graph(tracks)
    arrays, lengths, sources = JRunner(jg)._decode_inputs()
    jout = jcompiler.compile_graph(jg, sources, mode="export").run(
        arrays, lengths
    )
    jmaster, jlen = jout["master"]
    jmaster = jmaster[:, : int(jlen)]
    [spec_key] = [k for k in jout if k.startswith("spectrum_")]

    result = Runner(graph_from_jax(jg), device="cpu").render("export")
    assert result.rate == 48_000 and result.fmt == "flt"
    assert result.metrics.render_clock == "host"
    assert result.master.shape == jmaster.shape == (2, -(-22_050 * 160 // 147))
    assert np.isfinite(result.master).all()
    assert np.abs(result.master - jmaster).max() <= 2e-6
    spec = result.spectra[spec_key]
    assert spec.shape == jout[spec_key].shape
    assert snr_db(jout[spec_key], spec) >= 100.0


def test_preview_matches_jax(tracks):
    jg, _ = graft._flagship_graph(tracks)
    jres = JRunner(jg).preview()
    res = Runner(graph_from_jax(jg), device="cpu").preview()
    assert res.master.shape == jres.master.shape
    assert np.abs(res.master - jres.master).max() <= 2e-6
    assert np.abs(res.master).max() <= 1.0


def test_project_json_round_trips_between_packages():
    with open("examples/projects/two_track_mix.json") as f:
        blob = json.load(f)
    tg = Graph.deserialize(blob)
    assert tg.serialize() == blob
    jg = JGraph.deserialize(tg.serialize())
    assert jg.serialize() == blob
    assert Graph.deserialize(jg.serialize()).serialize() == blob
    assert type(tg.nodes[3].processor).__module__.startswith("nodey_tpu_torch")


def test_graph_from_jax_carries_the_gain_volume(tracks):
    jg, _ = graft._flagship_graph(tracks)
    [vol_id] = [nid for nid, node in jg.nodes.items()
                if node.processor.info().identifier == "audio_volume_adjust"]
    # The project JSON drops the volume (reference quirk) ...
    assert Graph.deserialize(jg.serialize()).nodes[vol_id].processor.volume == 1.0
    # ... the converter keeps it, and the amix volumes.
    tg = graph_from_jax(jg)
    assert tg.nodes[vol_id].processor.volume == 1.5
    [amix] = [n.processor for n in tg.nodes.values()
              if n.processor.info().identifier == "audio_amix"]
    assert amix.volumes == [0.6, 0.4]
    assert sorted(tg.links) == sorted(jg.links)


def test_missing_amix_input_is_attributed_to_its_node(tracks):
    jg, _ = graft._flagship_graph(tracks)
    tg = graph_from_jax(jg)
    [amix_id] = [nid for nid, n in tg.nodes.items()
                 if n.processor.info().identifier == "audio_amix"]
    pin = tg.nodes[amix_id].pin_name_map["input_2"]
    [link_id] = [lid for lid, link in tg.links.items() if link.to_pin == pin]
    tg.remove_link(link_id)
    with pytest.raises(ProcessorRuntimeError) as info:
        Runner(tg, device="cpu").render("export")
    assert f"[node {amix_id}: audio_amix]" in info.value.detail
    assert "input_2" in info.value.detail


def test_cuda_runner_raises_without_a_card(tracks):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    jg, _ = graft._flagship_graph(tracks)
    with pytest.raises(ProcessorRuntimeError, match="No CUDA device"):
        Runner(graph_from_jax(jg), device="cuda")
    with pytest.raises(ProcessorRuntimeError, match="No CUDA device"):
        Runner(graph_from_jax(jg))  # the default device is cuda
