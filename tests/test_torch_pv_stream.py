"""The port's streaming phase vocoder (``pv.pv_stream_*`` and the velocity
and pitch nodes on ``"pv"`` under chunk streaming) against the JAX
package, on the CPU.

- ``pv_stream_plan`` equals the JAX plan field by field, and the step's
  overlap-add coverage rows its ``_ola_row_partials`` bitwise.
- ``pv_stream_step`` against the JAX package's (jitted once per plan) on
  the same numpy-seeded chunks: the host counts (``out_n``, the next
  frame, ``consumed``, ``in_len``, done) equal at every step, the output
  >= 60 dB (the prefix products associate otherwise: a Hillis-Steele
  doubling here, ``associative_scan`` there).
- The streamed render against the port's offline render at the JAX
  package's own bars (tests/test_pv.py): 60 dB for tones, 100 dB for the
  transient click train, 30 dB with the formant pre-warp; equal lengths.
- A velocity or pitch node on ``"pv"`` through the streaming executor
  against the offline graph render (60 dB plain, 30 dB with
  ``pv_transient`` and ``preserve_formants``).
- The lock runs once per step with frames and never on a step without;
  a device that is neither CUDA nor the CPU raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import snr_db
from nodey_tpu.ops import pv as jpv
from nodey_tpu_torch.core.errors import ProcessorRuntimeError
from nodey_tpu_torch.core.graph import Graph
from nodey_tpu_torch.core.runner import Runner
from nodey_tpu_torch.core.stream_executor import StreamExecutor
from nodey_tpu_torch.host.decode import write_wav
from nodey_tpu_torch.ops import pv
from nodey_tpu_torch.processors.audio_input import AudioInput
from nodey_tpu_torch.processors.audio_output import AudioOutput
from nodey_tpu_torch.processors.velocity import PitchModifier, VelocityModifier
from test_pv import _click_train, _vowel

RATE = 48_000


def _tones(seconds, channels=2, seed=9):
    """Two tones and a little noise, [channels, n] float32."""
    rng = np.random.default_rng(seed)
    n = int(RATE * seconds)
    t = np.arange(n) / RATE
    rows = [0.5 * np.sin(2 * np.pi * 440.0 * t),
            0.3 * np.sin(2 * np.pi * 660.0 * t + 0.4)]
    data = np.stack(rows[:channels]) + 0.01 * rng.standard_normal((channels, n))
    return data.astype(np.float32)


def _chunks(data, push):
    """(block [C, push] zero-padded, n, done) over ``data``, then nothing
    more: the caller stops at out_done."""
    n_total = data.shape[1]
    fed = 0
    while True:
        n = max(0, min(push, n_total - fed))
        block = np.zeros((data.shape[0], push), np.float32)
        block[:, :n] = data[:, fed : fed + n]
        fed += n
        yield block, n, fed >= n_total


def _stream_port(plan, data):
    """(output, per-step host counts) of the port's chunk steps."""
    state = pv.pv_stream_init(plan, data.shape[0], "cpu")
    pieces, counts = [], []
    for block, n, done in _chunks(data, plan.push_cap):
        state, out, out_n, out_done = pv.pv_stream_step(
            plan, state, torch.from_numpy(block), n, done)
        pieces.append(out[:, :out_n].numpy())
        counts.append((out_n, state.k, state.consumed, state.in_len, out_done))
        if out_done:
            break
        assert len(counts) < 200
    return np.concatenate(pieces, axis=1), counts


@pytest.mark.parametrize("tempo,rate,push,options", [
    (0.8, 48_000, 4_800, {}),
    (1.25, 44_100, 768_640, {"transient": True}),
    (2.0 ** (-4 / 12), 48_000, 770_616,
     {"formant_ratio": 2.0 ** (4 / 12), "lock": False}),
    (1.0 / 2.0 ** (7 / 12), 22_050, 12_000,
     {"transient": True, "formant_ratio": 2.0 ** (7 / 12)}),
])
def test_stream_plan_equals_the_jax_plan(tempo, rate, push, options):
    plan = pv.pv_stream_plan(tempo, rate, push, **options)
    jplan = jpv.pv_stream_plan(tempo, rate, push, **options)
    assert plan._fields == jplan._fields
    assert tuple(plan) == tuple(jplan)
    # The step's overlap-add coverage rows, bitwise.
    P1 = pv._stream_tables(plan.n_fft, torch.device("cpu"))[1].numpy()
    assert np.array_equal(P1.view(np.int32),
                          jpv._ola_row_partials(plan.n_fft).view(np.int32))


def test_stream_step_against_jax():
    data = _tones(0.6)
    plan = pv.pv_stream_plan(0.8, RATE, 4_800)
    jplan = jpv.pv_stream_plan(0.8, RATE, 4_800)
    got, counts = _stream_port(plan, data)

    step = jax.jit(jpv.pv_stream_step, static_argnums=0)
    state = jpv.pv_stream_init(jplan, 2)
    pieces = []
    for i, (block, n, done) in enumerate(_chunks(data, jplan.push_cap)):
        state, out, out_n, out_done = step(jplan, state, jnp.asarray(block),
                                           jnp.int32(n), jnp.bool_(done))
        want = (int(out_n), int(state[6]), int(state[7]), int(state[8]),
                bool(out_done))
        assert counts[i] == want, i
        pieces.append(np.asarray(out)[:, : int(out_n)])
        if want[-1]:
            break
    assert len(pieces) == len(counts) >= 6
    want = np.concatenate(pieces, axis=1)
    assert got.shape == want.shape
    assert snr_db(want, got) >= 60.0


@pytest.mark.parametrize("case,bar", [
    ("tone_0.8", 60.0), ("tone_1.25", 60.0), ("transient", 100.0),
    ("formants", 30.0),
])
def test_streamed_equals_offline_at_the_jax_bars(case, bar):
    options = {}
    if case.startswith("tone"):
        data, tempo, push = _tones(1.0), float(case[5:]), 4_800
    elif case == "transient":
        click = _click_train()
        data, tempo, push = np.concatenate([click, 0.8 * click]), 1.25, RATE // 4
        options = {"transient": True}
    else:
        data, tempo, push = _vowel()[0], 1.0 / 2 ** (7 / 12), RATE // 4
        options = {"formant_ratio": 2 ** (7 / 12)}
    off, off_n = pv.pv_stretch_at_rate(torch.from_numpy(data), data.shape[1],
                                       tempo, RATE, **options)
    got, counts = _stream_port(pv.pv_stream_plan(tempo, RATE, push, **options),
                               data)
    assert len(counts) >= 4
    assert got.shape[1] == off_n
    assert snr_db(off[:, :off_n].numpy(), got) > bar


def _graph(path, node, options):
    g = Graph()
    src = g.add_node(AudioInput())
    g.nodes[src].processor.file_paths = [path]
    g.update_node_pin(src)
    if node == "velocity":
        stretch = g.add_node(VelocityModifier())
        g.nodes[stretch].processor.set_velocity(1.25)
        g.nodes[stretch].processor.keep_pitch = True
    else:
        stretch = g.add_node(PitchModifier())
        g.nodes[stretch].processor.pitch = 3.0
    processor = g.nodes[stretch].processor
    processor.set_algorithm("pv")
    processor.pv_transient = options
    processor.preserve_formants = options
    out = g.add_node(AudioOutput())
    g.add_link(g.nodes[src].pin_name_map["output_0"],
               g.nodes[stretch].pin_name_map["input"])
    g.add_link(g.nodes[stretch].pin_name_map["output"],
               g.nodes[out].pin_name_map["input"])
    return g


@pytest.mark.parametrize("node,options,bar", [
    ("velocity", False, 60.0), ("velocity", True, 30.0), ("pitch", True, 30.0),
])
def test_node_on_pv_streams_like_its_offline_render(tmp_path, node, options,
                                                    bar):
    click = _click_train(n=int(RATE * 1.2))
    data = np.concatenate([click, 0.8 * click]) if options else _tones(1.2)
    path = str(tmp_path / "in.wav")
    write_wav(path, data, RATE)
    offline = Runner(_graph(path, node, options), device="cpu").render(
        "export").master
    blocks = []
    metrics = StreamExecutor(_graph(path, node, options), mode="export",
                             chunk_seconds=0.25, device="cpu").run(
        sink=blocks.append)
    got = np.concatenate(blocks, axis=1)
    assert metrics.steps >= 4
    assert got.shape == offline.shape
    assert snr_db(offline, got) > bar


def test_lock_runs_once_per_step_with_frames(monkeypatch):
    locks = []
    lock_phases = pv.lock_phases

    def counting(*planes):
        locks.append(planes[3].shape)
        return lock_phases(*planes)

    monkeypatch.setattr(pv, "lock_phases", counting)
    plan = pv.pv_stream_plan(1.25, RATE, 1_200)  # a chunk under one window
    _, counts = _stream_port(plan, _tones(0.3))
    ks = [0] + [c[1] for c in counts]
    with_frames = sum(b > a for a, b in zip(ks, ks[1:]))
    assert 0 < with_frames < len(counts)  # the first step waits for a window
    assert locks == [(2, plan.k_cap, plan.n_fft // 2 + 1)] * with_frames


def test_lock_on_another_device_raises():
    plane = torch.empty((1, 3, 257), device="meta")
    with pytest.raises(ProcessorRuntimeError, match="Unsupported device"):
        pv.lock_phases(plane, plane, plane, plane)
