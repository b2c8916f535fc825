"""A witness at length: does the streamed phase vocoder drift from the
offline one over a long clip in the JAX package as it does in the port?

Config 4 on the PV (resample 44.1 -> 48 kHz, pitch +4, velocity 1.25
keep_pitch, both tempo stages on ``"pv"``) renders one seeded 120 s
stereo track four times on the CPU: each package offline (``Runner``) and
through its streaming executor at 16 s chunks. The test prints, for each
package, the SNR of streamed against offline over the whole master and by
30 s of output. It asserts only what must hold whatever the figures are:
equal lengths and finite masters. It is marked ``slow`` (the Tier-1 run
deselects it) and is run by hand, alone:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_pv_drift.py -m slow -s -q

It takes about a minute on 8 cores and 12 GiB of host memory, most of it
the JAX package's offline render, which grows with the clip (6.3 GiB at 60
s): at 300 s it would need ~30 GiB, so the clip is 120 s, 7.5 chunks.
"""

import time

import numpy as np
import pytest

from conftest import snr_db
from nodey_tpu.core.graph import Graph as JGraph
from nodey_tpu.core.runner import Runner as JRunner
from nodey_tpu.core.stream_executor import StreamExecutor as JStreamExecutor
from nodey_tpu.processors.audio_input import AudioInput as JAudioInput
from nodey_tpu.processors.audio_output import AudioOutput as JAudioOutput
from nodey_tpu.processors.resample_node import AudioResample as JAudioResample
from nodey_tpu.processors.velocity import PitchModifier as JPitchModifier
from nodey_tpu.processors.velocity import VelocityModifier as JVelocityModifier
from nodey_tpu_torch.convert import graph_from_jax
from nodey_tpu_torch.core.runner import Runner
from nodey_tpu_torch.core.stream_executor import StreamExecutor
from nodey_tpu_torch.host.decode import write_wav_s16

SECONDS = 120
CHUNK_SECONDS = 16.0
WINDOW_SECONDS = 30
IN_RATE = 44_100
OUT_RATE = 48_000


def _track(seconds: int, seed: int = 0) -> np.ndarray:
    """[2, n] float32 at 44.1 kHz: a tone plus noise, and noise (the
    signal chip_smoke.py's config-4 phases render)."""
    rng = np.random.default_rng(seed)
    n = IN_RATE * seconds
    t = np.arange(n, dtype=np.float64) / IN_RATE
    return np.stack([0.35 * np.sin(2 * np.pi * 220.0 * t)
                     + 0.1 * rng.standard_normal(n),
                     0.3 * rng.standard_normal(n)]).astype(np.float32)


def _config4_pv(path: str) -> JGraph:
    """Config 4 on the PV (bench.py:195-206) with the JAX processors."""
    g = JGraph()
    pin = lambda n, p: g.nodes[n].pin_name_map[p]  # noqa: E731
    src = g.add_node(JAudioInput())
    g.nodes[src].processor.file_paths = [path]
    g.update_node_pin(src)
    rs = g.add_node(JAudioResample())
    g.nodes[rs].processor.set_target_rate(OUT_RATE)
    pitch = g.add_node(JPitchModifier())
    g.nodes[pitch].processor.pitch = 4
    vel = g.add_node(JVelocityModifier())
    g.nodes[vel].processor.set_velocity(1.25)
    g.nodes[vel].processor.keep_pitch = True
    out = g.add_node(JAudioOutput())
    g.add_link(pin(src, "output_0"), pin(rs, "input"))
    g.add_link(pin(rs, "output"), pin(pitch, "input"))
    g.add_link(pin(pitch, "output"), pin(vel, "input"))
    g.add_link(pin(vel, "output"), pin(out, "input"))
    for node in (pitch, vel):
        g.nodes[node].processor.set_algorithm("pv")
    return g


def _by_window(reference, test):
    window = WINDOW_SECONDS * OUT_RATE
    return [snr_db(reference[:, i : i + window], test[:, i : i + window])
            for i in range(0, reference.shape[1], window)]


def _streamed(executor) -> np.ndarray:
    blocks = []
    executor.run(sink=lambda b: blocks.append(np.array(b)))
    return np.concatenate(blocks, axis=1)


@pytest.mark.slow
def test_streamed_pv_against_offline_at_length(tmp_path):
    path = str(tmp_path / "track.wav")
    write_wav_s16(path, _track(SECONDS), IN_RATE)
    jgraph = _config4_pv(path)
    masters = {}
    for name, offline, streamed in (
        ("JAX", lambda: JRunner(jgraph).render("export").master,
         lambda: _streamed(JStreamExecutor(
             jgraph, mode="export", chunk_seconds=CHUNK_SECONDS))),
        ("port", lambda: Runner(graph_from_jax(jgraph), device="cpu")
         .render("export").master,
         lambda: _streamed(StreamExecutor(
             graph_from_jax(jgraph), mode="export",
             chunk_seconds=CHUNK_SECONDS, device="cpu"))),
    ):
        t0 = time.perf_counter()
        want = np.asarray(offline())
        t1 = time.perf_counter()
        got = streamed()
        t2 = time.perf_counter()
        masters[name] = (want, got)
        print(f"{name}, {SECONDS} s at {CHUNK_SECONDS:g} s chunks (CPU; "
              f"offline {t1 - t0:.1f} s, streamed {t2 - t1:.1f} s wall): "
              f"master {list(want.shape)}, streamed vs offline SNR "
              f"{snr_db(want, got):.1f} dB; by {WINDOW_SECONDS} s of output: "
              f"{', '.join(f'{db:.1f}' for db in _by_window(want, got))} dB",
              flush=True)
    for want, got in masters.values():
        assert got.shape == want.shape
        assert np.isfinite(want).all() and np.isfinite(got).all()
    assert masters["JAX"][0].shape == masters["port"][0].shape
