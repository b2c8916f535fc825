"""Batched serving (``CompiledGraph.run_batch``) of the port on the CPU.

Graphs come from bench.py's graph functions (BASELINE configs 1-7, with
its tones, written by the port's WAV writer), ``_flagship_graph`` (the
5-node graph) and three more built here (graph A: filter, gate, de-esser,
normalize to -14 LUFS; a gain of 4 into the limiter and a peak normalize;
split -> bimix_v2), carried into the port by ``graph_from_jax``. Each
batch holds three clips of different content (bench.py's ``_tone`` at
other seeds and pitches, a noise floor on both channels) and different
lengths (0.5 s, 71% and 33% of it, in a capacity of 32,768 samples), as
s16 samples. In the batches of config 6, graph A and the peak graph the
second clip is 40 dB below the others: a detector, envelope, loudness or
peak taken across clips instead of within one would move it.

- Every clip of the port's ``run_batch`` is bitwise the port's own single
  render of that clip (``CompiledGraph.__call__``), master or preview,
  length and spectrum, for configs 1, 2, 3, 5 (preview), 6 and 7, the
  5-node graph, config 4 on WSOLA, on the phase vocoder, and on the phase
  vocoder with ``pv_transient`` and ``preserve_formants``, graph A, the
  peak graph and split -> bimix_v2; the tail past each clip's length is
  zero.
- The port's ``run_batch`` against the JAX package's ``run_batch`` (its
  vmap, on the CPU) on the same samples, at the bars of the single-clip
  tests of those graphs: tests/test_batch.py's volume graph bitwise (the
  gain's float32 product, tests/test_torch_gain.py); the 5-node graph,
  configs 2, 4 on WSOLA and 5, and split -> bimix_v2 within 2e-6
  (tests/test_torch_slice.py, tests/test_torch_config4.py,
  tests/test_torch_configs.py, tests/test_torch_split_bimix.py: the
  resampler's sums run in another order), the spectrum >= 100 dB; config 6
  and graph A >= 95 dB (tests/test_torch_masterbus.py), config 7 >= 100
  dB (tests/test_torch_reverb.py). Config 4 on the phase vocoder against
  the JAX package is in tests/test_torch_batch_pv.py.
- Every registered node type has a batched lowering. A graph with a node
  that has none (the delay, its ``batched`` patched to False) is refused
  before anything runs, naming the node, and serves once the delay has
  its own back; malformed batches are refused.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import bench
from conftest import snr_db
from nodey_tpu.core import compiler as jcompiler
from nodey_tpu.core import registry as jregistry
from nodey_tpu.processors.audio_output import AudioOutput as JAudioOutput
from nodey_tpu.processors.audio_vol import AudioVol as JAudioVol
from nodey_tpu.processors.bimix import AudioBimixV2 as JAudioBimixV2
from nodey_tpu.processors.deesser import AudioDeesser as JAudioDeesser
from nodey_tpu.processors.delay import AudioDelay as JAudioDelay
from nodey_tpu.processors.equalizer import AudioFilter as JAudioFilter
from nodey_tpu.processors.gate import AudioGate as JAudioGate
from nodey_tpu.processors.limiter import AudioLimiter as JAudioLimiter
from nodey_tpu.processors.normalize import AudioNormalize as JAudioNormalize
from nodey_tpu.processors.resample_node import AudioResample as JAudioResample
from nodey_tpu.processors.split import AudioSplit as JAudioSplit
from nodey_tpu_torch.convert import graph_from_jax
from nodey_tpu_torch.core import compiler
from nodey_tpu_torch.core.errors import LogicError, ProcessorRuntimeError
from nodey_tpu_torch.core.registry import (processor_map,
                                           register_all_processors)
from nodey_tpu_torch.core.runner import Runner
from nodey_tpu_torch.core.stream import (Stream, map_lengths, max_length,
                                         zero_tail)
from nodey_tpu_torch.host import decode as host_decode
from nodey_tpu_torch.ops import resample as tr

SECONDS = 0.5
CAPACITY = 32_768     # every input's (0.5 s at 44.1 or 48 kHz fits)
SHARES = (1.0, 0.71, 0.33)
QUIET = 10.0 ** (-40.0 / 20.0)   # the second clip's scale where QUIET_GRAPHS
TOL = 2e-6
SPECTRUM_DB = 100.0
# The JAX run_batch bars: an absolute max|diff|, or an SNR in dB.
JAX_BARS = {"5node": ("tol", TOL), "config2": ("tol", TOL),
            "config4_wsola": ("tol", TOL), "config5": ("tol", TOL),
            "bimix_v2": ("tol", TOL), "config6": ("db", 95.0),
            "graph_a": ("db", 95.0), "config7": ("db", 100.0)}
BATCHED = {"audio_input", "audio_volume_adjust", "audio_amix",
           "audio_spectrum", "audio_output", "audio_resample",
           "pitch_modifier", "velocity_modifier", "audio_split",
           "audio_bimix", "audio_bimix_v2", "audio_eq", "audio_filter",
           "audio_compressor", "audio_limiter", "audio_gate",
           "audio_deesser", "audio_normalize", "audio_reverb",
           "audio_delay", "audio_tremolo", "audio_chorus", "audio_phaser",
           "audio_pan", "audio_width", "audio_fade", "audio_generator",
           "audio_crossfade", "audio_trim", "audio_reverse"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's eager CPU ops on one thread (see
    tests/test_torch_effects.py)."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


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


def _flagship(tmp, seconds):
    graph, _ = graft._flagship_graph(_write_tracks(tmp, 2, seconds, 44_100, 2))
    return graph, "export"


def _volume(tmp, seconds):
    """tests/test_batch.py's graph: input -> volume 2.0 -> output."""
    g, src = bench._new_graph(_write_tracks(tmp, 1, seconds, 48_000, 2))
    vol = g.add_node(JAudioVol())
    g.nodes[vol].processor.set_volume(2.0)
    out = g.add_node(JAudioOutput())
    g.add_link(bench._pin(g, src, "output_0"), bench._pin(g, vol, "input"))
    g.add_link(bench._pin(g, vol, "output"), bench._pin(g, out, "input"))
    return g, "export"


def _config4_pv_options(tmp, seconds):
    g, mode = bench.config4_pv(tmp, seconds)
    for node in g.nodes.values():
        if node.processor.info().identifier in ("pitch_modifier",
                                                "velocity_modifier"):
            node.processor.pv_transient = True
        if node.processor.info().identifier == "pitch_modifier":
            node.processor.preserve_formants = True
    return g, mode


def _chain(tmp, seconds, rate, processors):
    """One stereo track at ``rate`` -> ``processors`` in a row -> output."""
    g, src = bench._new_graph(_write_tracks(tmp, 1, seconds, rate, 2))
    prev = bench._pin(g, src, "output_0")
    for processor in processors:
        node = g.add_node(processor)
        g.add_link(prev, bench._pin(g, node, "input"))
        prev = bench._pin(g, node, "output")
    out = g.add_node(JAudioOutput())
    g.add_link(prev, bench._pin(g, out, "input"))
    return g, "export"


def _graph_a(tmp, seconds):
    """chip_smoke.py's graph A: highpass 80 Hz -> gate -> de-esser ->
    normalize to -14 LUFS."""
    hp = JAudioFilter()
    hp.set_filter_type("highpass")
    hp.set_freq(80.0)
    norm = JAudioNormalize()
    norm.set_mode("lufs")
    norm.set_param("target_db", -14.0)
    return _chain(tmp, seconds, 48_000,
                  [hp, JAudioGate(), JAudioDeesser(), norm])


def _peak_normalize(tmp, seconds):
    """A 44.1 kHz track -> resample to 48 kHz (a capacity of 35,667, no
    multiple of the CPU's vector width) -> gain 4 -> limiter -1 dB (acting
    on the loud clips) -> normalize the peak to -3 dBFS."""
    rs = JAudioResample()
    rs.target_rate = 48_000
    vol = JAudioVol()
    vol.set_volume(4.0)
    lim = JAudioLimiter()
    lim.set_threshold_db(-1.0)
    norm = JAudioNormalize()
    norm.set_mode("peak")
    norm.set_param("target_db", -3.0)
    return _chain(tmp, seconds, 44_100, [rs, vol, lim, norm])


def _bimix_v2(tmp, seconds):
    """A 44.1 kHz stereo track -> split -> bimix_v2 -> output."""
    g, src = bench._new_graph(_write_tracks(tmp, 1, seconds, 44_100, 2))
    split = g.add_node(JAudioSplit())
    merge = g.add_node(JAudioBimixV2())
    out = g.add_node(JAudioOutput())
    g.add_link(bench._pin(g, src, "output_0"), bench._pin(g, split, "input"))
    g.add_link(bench._pin(g, split, "output_l"),
               bench._pin(g, merge, "input_l"))
    g.add_link(bench._pin(g, split, "output_r"),
               bench._pin(g, merge, "input_r"))
    g.add_link(bench._pin(g, merge, "output"), bench._pin(g, out, "input"))
    return g, "export"


GRAPHS = {"config1": bench.config1_passthrough,
          "config2": bench.config2_split_merge,
          "config3": bench.config3_two_track_mix,
          "config5": bench.config5_full_editor,
          "config6": bench.config6_masterbus,
          "config7": bench.config7_reverb,
          "graph_a": _graph_a,
          "peak_normalize": _peak_normalize,
          "bimix_v2": _bimix_v2,
          "5node": _flagship,
          "config4_wsola": bench.config4_resample_pitch_tempo,
          "config4_pv": bench.config4_pv,
          "config4_pv_options": _config4_pv_options,
          "volume": _volume}


QUIET_GRAPHS = {"config6", "graph_a", "peak_normalize"}


def _batch(sources, quiet=False):
    """Three clips per input: bench tones at other seeds and pitches with a
    noise floor, s16, each zero past its own length; with ``quiet`` the
    second clip 40 dB below the others."""
    arrays, lengths = {}, {}
    for j, ((nid, pin), spec) in enumerate(sorted(sources.items())):
        n = int(spec.rate * SECONDS)
        clips = np.zeros((len(SHARES), spec.channels, spec.capacity),
                         dtype=np.int16)
        lens = []
        for b, share in enumerate(SHARES):
            m = int(n * share)
            tone = bench._tone(m, spec.rate, 180.0 + 70.0 * b + 30.0 * j,
                               spec.channels, seed=10 * j + b)
            noise = np.random.default_rng(100 + 10 * j + b).standard_normal(
                (spec.channels, m))
            scale = QUIET if quiet and b == 1 else 1.0
            clips[b, :, :m] = np.round(
                scale * (tone + 0.05 * noise) * 32768.0).clip(-32768, 32767)
            lens.append(m)
        key = compiler.external_key(nid, pin)
        arrays[key] = clips
        lengths[key] = tuple(lens)
    return arrays, lengths


@contextlib.contextmanager
def _bench_writes_with_the_port():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "_write_tracks", _write_tracks)
        yield


def _compiled(name, tmp):
    """(JAX graph, the port's CompiledGraph on the CPU, mode, sources)."""
    with _bench_writes_with_the_port():
        jg, mode = GRAPHS[name](str(tmp), SECONDS)
    tg = graph_from_jax(jg)
    _, _, sources = Runner(tg, device="cpu").decode()
    sources = {key: dataclasses.replace(spec, capacity=CAPACITY)
               for key, spec in sources.items()}
    return jg, compiler.compile_graph(tg, sources, mode, "cpu"), mode, sources


def test_each_clip_is_bitwise_its_single_render(tmp_path):
    for name in ("config1", "config2", "config3", "5node", "config4_wsola",
                 "config4_pv", "config4_pv_options", "config5", "config6",
                 "config7", "graph_a", "peak_normalize", "bimix_v2"):
        tmp = tmp_path / name
        tmp.mkdir()
        _check_clips(*_compiled(name, tmp)[1:], quiet=name in QUIET_GRAPHS)


def _check_clips(compiled, mode, sources, quiet=False):
    """Each clip of ``compiled``'s batch against its own single render."""
    arrays, lengths = _batch(sources, quiet)
    outs, meta = compiled.run_batch(arrays, lengths)
    key = "master" if mode == "export" else "preview"
    data, lens = outs[key]
    assert data.shape[0] == len(SHARES) and isinstance(lens, tuple)
    for b in range(len(SHARES)):
        single, single_meta = compiled({
            k: (torch.from_numpy(arrays[k][b]), lengths[k][b])
            for k in compiled.input_keys})
        assert single_meta == meta
        for out_key, value in single.items():
            if isinstance(value, tuple):
                assert outs[out_key][1][b] == value[1]
                assert torch.equal(outs[out_key][0][b], value[0]), out_key
            else:
                assert torch.equal(outs[out_key][b], value), out_key
        assert not data[b, :, lens[b]:].any()
    # Each clip's own length, not the batch's longest.
    assert len(set(lens)) == len(SHARES)


def _jax_run_batch(jg, mode, sources, arrays, lengths):
    sources = {key: jcompiler.SourceSpec(**dataclasses.asdict(spec))
               for key, spec in sources.items()}
    jout = jcompiler.compile_graph(jg, sources, mode=mode).run_batch(
        arrays, {k: np.asarray(v, dtype=np.int32) for k, v in lengths.items()})
    return {k: (np.asarray(v[0]), np.asarray(v[1])) if isinstance(v, tuple)
            else np.asarray(v) for k, v in jout.items()}


def test_run_batch_matches_the_jax_run_batch(tmp_path):
    for name in ("volume", "5node", "config4_wsola", "config2", "config5",
                 "bimix_v2", "config6", "graph_a", "config7"):
        tmp = tmp_path / name
        tmp.mkdir()
        _check_jax(name, *_compiled(name, tmp))


def _check_jax(name, jg, compiled, mode, sources):
    """``compiled``'s batch against the JAX package's ``run_batch``."""
    arrays, lengths = _batch(sources, quiet=name in QUIET_GRAPHS)
    want = _jax_run_batch(jg, mode, sources, arrays, lengths)
    outs, _ = compiled.run_batch(arrays, lengths)
    key = "master" if mode == "export" else "preview"
    data, lens = outs[key]
    jdata, jlens = want[key]
    assert list(lens) == jlens.tolist()
    for b, n in enumerate(lens):
        got, ref = data[b, :, :n].numpy(), jdata[b, :, :n]
        assert np.isfinite(got).all()
        if name == "volume":
            np.testing.assert_array_equal(got, ref)
        elif JAX_BARS[name][0] == "tol":
            assert np.abs(got - ref).max() <= JAX_BARS[name][1], (name, b)
        else:
            assert snr_db(ref, got) >= JAX_BARS[name][1], (name, b)
    for key, spectrum in want.items():
        if key.startswith("spectrum_"):
            assert outs[key].shape == spectrum.shape
            for b in range(len(SHARES)):
                assert snr_db(spectrum[b], outs[key][b].numpy()) >= SPECTRUM_DB


def test_run_batch_refuses_what_it_cannot_run(tmp_path, monkeypatch):
    """All thirty node types are batched. With the delay's batched lowering
    taken away, input -> resample -> delay -> output is refused before the
    resampler ahead of the delay runs; with it back, the graph serves.
    Malformed batches are refused."""
    register_all_processors()
    assert {ident for ident, info in processor_map.items()
            if info.generate().batched} == BATCHED == set(processor_map)
    jregistry.register_all_processors()
    g, src = bench._new_graph(_write_tracks(str(tmp_path), 1, SECONDS,
                                            44_100, 2))
    rs = g.add_node(JAudioResample())
    g.nodes[rs].processor.target_rate = 48_000
    dl = g.add_node(JAudioDelay())
    out = g.add_node(JAudioOutput())
    g.add_link(bench._pin(g, src, "output_0"), bench._pin(g, rs, "input"))
    g.add_link(bench._pin(g, rs, "output"), bench._pin(g, dl, "input"))
    g.add_link(bench._pin(g, dl, "output"), bench._pin(g, out, "input"))
    tg = graph_from_jax(g)
    _, _, sources = Runner(tg, device="cpu").decode()
    compiled = compiler.compile_graph(tg, sources, "export", "cpu")
    calls = []
    monkeypatch.setattr(tr, "apply_filter_bank",
                        lambda *a: calls.append(a))
    monkeypatch.setattr(type(tg.nodes[dl].processor), "batched", False)
    arrays, lengths = _batch(sources)
    with pytest.raises(ProcessorRuntimeError) as err:
        compiled.run_batch(arrays, lengths)
    assert f"node {dl} (audio_delay)" in err.value.detail
    assert compiled.unbatched_nodes() == [(dl, "audio_delay")]
    assert calls == []
    monkeypatch.undo()
    assert compiled.unbatched_nodes() == []
    data, lens = compiled.run_batch(arrays, lengths)[0]["master"]
    assert data.shape[0] == len(SHARES) and len(set(lens)) == len(SHARES)

    tmp = tmp_path / "config1"
    tmp.mkdir()
    _, compiled, _, sources = _compiled("config1", tmp)
    arrays, lengths = _batch(sources)
    [key] = compiled.input_keys
    with pytest.raises(LogicError, match="lengths"):
        compiled.run_batch(arrays, {key: lengths[key][:2]})
    with pytest.raises(LogicError, match="want"):
        compiled.run_batch({key: arrays[key][0]}, {key: lengths[key][:1]})
    with pytest.raises(LogicError, match="outside"):
        compiled.run_batch(arrays, {key: (1, 2, 10**9)})
    # Tensors on the graph's device run as numpy does; lengths may be a
    # host tensor.
    outs, _ = compiled.run_batch({key: torch.from_numpy(arrays[key])},
                                 {key: torch.tensor(lengths[key])})
    ref, _ = compiled.run_batch(arrays, lengths)
    assert torch.equal(outs["master"][0], ref["master"][0])
    assert outs["master"][1] == ref["master"][1]


def test_a_batched_stream_keeps_each_clips_length():
    one = Stream(data=torch.ones((2, 8)), length=5, rate=8_000, channels=2)
    batch = Stream(data=torch.ones((3, 2, 8)), length=[8, 5, 2], rate=8_000,
                   channels=2)
    assert one.batch is None and batch.batch == 3
    assert batch.length == (8, 5, 2) and batch.capacity == 8
    assert batch.with_data(batch.data[:, :1]).channels == 1
    with pytest.raises(ValueError, match="lengths"):
        Stream(data=torch.ones((3, 2, 8)), length=(8, 5), rate=8_000,
               channels=2)
    tails = zero_tail(batch.data.clone(), batch.length)
    assert tails.sum(dim=(1, 2)).tolist() == [16.0, 10.0, 4.0]
    assert zero_tail(one.data.clone(), one.length).sum().item() == 10.0
    assert zero_tail(batch.data.clone(), (3, 3, 3)).sum().item() == 18.0
    assert map_lengths((8, 5, 2), lambda n: 2 * n) == (16, 10, 4)
    assert map_lengths(5, lambda n: 2 * n) == 10
    assert max_length([(8, 5, 2), (1, 7, 3)]) == (8, 7, 3)
    assert max_length([4, 9]) == 9
