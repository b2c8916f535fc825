"""BASELINE configs 1, 2, 3 and 5 through both packages on the CPU.

Each graph comes from bench.py's own graph function (``config1_passthrough``,
``config2_split_merge``, ``config3_two_track_mix``, ``config5_full_editor``)
on 0.5 s clips of bench.py's tones, written with the port's
``write_wav_s16`` (bench.py's own writer goes through the JAX package's
codec runtime). The JAX side runs ``compile_graph`` on the port's decode of
the tracks; the port runs ``Runner(device="cpu")`` on the graph carried
over by ``graph_from_jax``.

- Config 1 (one mono track, gain 1.2 on its s16 samples): the master
  bitwise, and through a WAV export and back.
- Configs 2, 3 and 5: equal length and within 2e-6 (the resampler's float32
  sums run in another order); config 5's spectrum >= 100 dB.
- Config 2 streamed (``Runner.export_streamed``) within 3e-7 of its offline
  render (the streamed two-track mix's bar, tests/test_torch_stream_executor.py)
  and chunked (``render_chunked``) >= 130 dB (tests/test_torch_streaming.py's
  bar with the mixer's resample).
- Config 5 streams in lockstep (its pitch branch keeps the clip's
  duration): ``run --stream`` streams, within 2e-6 of the offline export.
"""

import contextlib
import dataclasses
import json

import numpy as np
import pytest

import bench
from conftest import snr_db
from nodey_tpu.core import chunkflow as jchunkflow
from nodey_tpu.core import compiler as jcompiler
from nodey_tpu_torch.app import cli
from nodey_tpu_torch.convert import graph_from_jax
from nodey_tpu_torch.core import chunkflow
from nodey_tpu_torch.core.runner import Runner
from nodey_tpu_torch.core.streaming import render_chunked, supports_chunked
from nodey_tpu_torch.host import decode as host_decode

SECONDS = 0.5
TOL = 2e-6
STREAM_TOL = 3e-7
CHUNKED_DB = 130.0
CONFIGS = {1: bench.config1_passthrough, 2: bench.config2_split_merge,
            3: bench.config3_two_track_mix, 5: bench.config5_full_editor}


def _write_tracks(tmp, count, seconds, rate, channels):
    """bench._write_tracks with the port's WAV writer: the same tones."""
    n = int(rate * seconds)
    paths = []
    for i in range(count):
        path = f"{tmp}/track{i}.wav"
        host_decode.write_wav_s16(
            path, bench._tone(n, rate, 220.0 * (i + 1), channels, i), rate)
        paths.append(path)
    return paths


@contextlib.contextmanager
def _bench_writes_with_the_port():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "_write_tracks", _write_tracks)
        yield


def _render(config, tmp):
    """(JAX graph, port graph, mode, the JAX master [C, length], the JAX
    spectra) of one config on SECONDS-long tracks in ``tmp``."""
    with _bench_writes_with_the_port():
        jg, mode = CONFIGS[config](str(tmp), SECONDS)
    tg = graph_from_jax(jg)
    arrays, lengths, sources = Runner(tg, device="cpu").decode()
    sources = {key: jcompiler.SourceSpec(**dataclasses.asdict(spec))
               for key, spec in sources.items()}
    jout = jcompiler.compile_graph(jg, sources, mode=mode).run(arrays, lengths)
    data, length = jout["master" if mode == "export" else "preview"]
    spectra = {k: np.asarray(v) for k, v in jout.items()
               if k.startswith("spectrum_")}
    return jg, tg, mode, np.asarray(data)[:, : int(length)], spectra


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    """Each config's JAX render, made once for the module."""
    cache = {}

    def get(config):
        if config not in cache:
            cache[config] = _render(
                config, tmp_path_factory.mktemp(f"config{config}"))
        return cache[config]

    return get


def test_config1_mono_master_is_bitwise_the_jax_render(rendered, tmp_path):
    _, tg, mode, jmaster, _ = rendered(1)
    result = Runner(tg, device="cpu").render(mode)
    assert (result.rate, result.fmt) == (44_100, "s16")
    assert result.master.shape == jmaster.shape == (1, int(44_100 * SECONDS))
    np.testing.assert_array_equal(result.master, jmaster)
    # The mono WAV write and read keep every sample of the s16 master.
    path = str(tmp_path / "config1.wav")
    Runner(tg, device="cpu").export(path)
    back = host_decode.decode_file(path)
    assert (back.rate, back.data.shape[0]) == (44_100, 1)
    np.testing.assert_array_equal(back.data, jmaster)


@pytest.mark.parametrize("config", [2, 3, 5])
def test_config_matches_jax(rendered, config):
    _, tg, mode, jmaster, jspectra = rendered(config)
    result = Runner(tg, device="cpu").render(mode)
    assert (result.rate, result.fmt) == (48_000, "flt")
    assert result.master.shape == jmaster.shape == (2, int(48_000 * SECONDS))
    assert np.isfinite(result.master).all()
    assert np.abs(result.master - jmaster).max() <= TOL
    assert sorted(result.spectra) == sorted(jspectra)
    for key, spectrum in jspectra.items():
        assert result.spectra[key].shape == spectrum.shape
        assert snr_db(spectrum, result.spectra[key]) >= 100.0
    if mode == "preview":
        assert np.abs(result.master).max() <= 1.0


def test_graph_from_jax_carries_config5(rendered):
    jg, tg, _, _, _ = rendered(5)
    by_kind = {}
    for node in tg.nodes.values():
        by_kind.setdefault(node.processor.info().identifier, []).append(
            node.processor)
    [amix] = by_kind["audio_amix"]
    assert amix.volumes == [0.3, 0.3, 0.2, 0.2]
    assert [a.identifier for a in amix.pin_attributes()] == [
        "output", "input_1", "input_2", "input_3", "input_4"]
    assert [v.volume for v in by_kind["audio_volume_adjust"]] == [0.7, 1.3]
    assert [b.bias for b in by_kind["audio_bimix"]] == [0.0]
    assert [p.pitch for p in by_kind["pitch_modifier"]] == [-3.0]
    assert sorted(tg.links) == sorted(jg.links)


def test_config2_streamed_and_chunked_match_its_offline_render(rendered,
                                                               tmp_path):
    _, tg, _, _, _ = rendered(2)
    offline = Runner(tg, device="cpu").render("export").master
    path = str(tmp_path / "streamed.wav")
    runner = Runner(tg, device="cpu")
    metrics = runner.export_streamed(path, chunk_seconds=0.1)
    assert metrics.mode == "streamed"
    assert runner.last_stream_metrics.steps >= 4
    streamed = host_decode.decode_file(path).data
    assert streamed.shape == offline.shape
    np.testing.assert_allclose(streamed, offline, rtol=0, atol=STREAM_TOL)

    assert supports_chunked(tg)
    chunked, rate, fmt, _ = render_chunked(tg, chunk_seconds=0.15,
                                           halo_seconds=0.05, device="cpu")
    assert (rate, fmt) == (48_000, "flt")
    assert chunked.shape == offline.shape
    assert snr_db(offline, chunked) >= CHUNKED_DB


def test_config5_streams_in_lockstep(rendered, tmp_path, capsys):
    """The pitch branch keeps the clip's duration (WSOLA at tempo 2^(-1/4),
    then the transposition back), so all four mixer inputs arrive at one
    cadence and config 5 streams, in both packages: ``run --stream``
    streams, within 2e-6 of the offline export (the WSOLA graphs' bar)."""
    jg, tg, _, _, _ = rendered(5)
    _, _, sources = Runner(tg, device="cpu").decode()
    compiled = chunkflow.compile_stream_graph(tg, sources, device="cpu")
    assert compiled.output_meta["master"]["rate"] == 48_000
    # The JAX package plans the same graph as streamable too.
    jcompiled = jchunkflow.compile_stream_graph(jg, {
        key: jcompiler.SourceSpec(**dataclasses.asdict(spec))
        for key, spec in sources.items()}, jit=False)
    assert jcompiled.output_meta["master"]["rate"] == 48_000
    proj = tmp_path / "config5.json"
    proj.write_text(json.dumps(jg.serialize()))
    streamed = str(tmp_path / "s.wav")
    assert cli.main(["run", str(proj), "--export", streamed, "--stream",
                     "--device", "cpu"]) == 0
    assert f"exported {streamed} (streamed)" in capsys.readouterr().out
    # The project file holds no gain volumes (the reference's quirk), so
    # the offline render reads the same file.
    offline = Runner(cli._load_graph(str(proj)),
                     device="cpu").render("export").master
    got = host_decode.decode_file(streamed).data
    assert got.shape == offline.shape
    np.testing.assert_allclose(got, offline, rtol=0, atol=TOL)
