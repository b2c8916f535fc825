#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``nodey_tpu_torch``) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, in order; the first failure exits non-zero:
  1. device  — a CUDA card, its name and power limit, TF32 off;
  2. build   — every kernel library from nodey_tpu_torch/csrc, one nvcc per
               source, all started together;
  3. kernel  — the polyphase kernel against its plain PyTorch version on the
               card at the main paths' shapes (44.1->48 kHz on the 300 s
               track; the 635/504 pitch transposition on config 4's 300 s
               intermediate), 22.05->48 and 44.1->32 kHz, stereo, ragged
               last tile: max|diff| <= 2e-6;
  4. slice   — the 5-node stereo graph through the port's CLI on two 300 s
               44.1 kHz stereo s16 tracks (export to WAV), then a 10 s
               excerpt of the same graph in code rendered on the card and on
               the CPU: master max|diff| <= 2e-6, spectrum SNR >= 100 dB;
  5. times   — CUDA events after a warm-up: the polyphase kernel and its
               plain version at the 5-node path's shape, beside its bound,
               and the whole graph's device render as audio-seconds per
               device-second;
  6. wsola   — the WSOLA chain kernel against its plain version on the card:
               splice offsets bitwise on the 7 golden signals; at config 4's
               two 300 s shapes (K 11,820 and 7,507) every frame's choice
               against the plain scoring given the kernel's previous choice
               (a differing frame must be a near tie: float64 scores within
               1e-5 of the frame's max |score|, at most 0.1% of K) and the
               audio against the plain assembly of the same choices (2e-6);
               the chain's energy prologue against its plain version at both
               shapes (relative 1e-5);
  7. config4 — the config-4 graph (resample -> pitch +4 -> velocity 1.25
               keep_pitch) through the CLI on a 300 s 44.1 kHz stereo track,
               exported to WAV: length 11,519,994, finite, >= 2 launches of
               each kernel; a 10 s excerpt on the card and on the CPU: equal
               splice decisions, master max|diff| <= 2e-6;
  8. times   — CUDA events: the WSOLA kernel (prologue and chain) and its
               plain version at both shapes, its us per frame beside the
               serial floor (an estimate); the prologue alone and its plain
               version; the 635/504 resample (kernel, plain, conv1d);
               conv1d at 44.1->48 kHz; the config-4 render as audio-seconds
               per device-second, and one render under torch.profiler
               (device time by kernel, the device's idle share);
  9. pv-kernels — the phase-vocoder kernels against their plain versions on
               the card, at config 4's two PV shapes (K 35,460 and 22,520, on
               the main path's own data) and on the 7 golden signals: the
               phase path's synthesis planes >= 100 dB, with and without
               lock, and every bin with mag > 0 within a phasor error
               |kernel - plain| / mag <= 1e-3 (with the count of plane
               elements that are not bitwise the plain version's, as the
               prefix is associated otherwise, and a digest of the kernel's
               planes to hold two builds of it to each other); the lock kernel, fed the
               plain path's unlocked planes, within 2e-6 of the plain lock
               and bitwise it on finite inputs, there, at the streamed PV's
               two chunk shapes (the frames a step of each stage's stream
               plan at 16 s chunks, from the middle of its planes) and at
               the pitch stage's shape with silent, rising, flat and comb
               frames;
 10. config4-pv — config 4 with both tempo nodes on algorithm "pv" through
               the CLI on the 300 s track, exported to WAV: length
               11,519,994, finite, >= 2 launches of the phase-path kernel, 0
               of the lock kernel, >= 2 of the resampler; a 10 s excerpt on
               the card through the kernels and through the plain versions:
               master SNR >= 90 dB; on the card and on the CPU: equal shape,
               SNR >= 40 dB (the PV's own conditioning: the CPU's change for
               re moved by one ulp is printed beside it);
 11. config4-pv-options — the same graph with pv_transient on both nodes and
               preserve_formants on the pitch node, 300 s through the CLI:
               >= 2 launches of the lock kernel, 0 of the phase-path kernel,
               the length, finite;
 12. times   — CUDA events: both PV kernels and their plain versions at both
               shapes beside their bounds; the phase kernel's three passes
               (totals, carry, apply) by torch.profiler device time beside
               its whole call; the PV config-4 render as audio-seconds per
               device-second (rtf_config4_pv), and one render under
               torch.profiler.
 13. stream-kernel — config 4 streamed at 16 s chunks on phase 6's track
               (the graph's chunk steps driven by hand): every launch of the
               WSOLA kernel's chunk entry against the plain chunk chain on
               the same (x, head, k0, base, K): splices equal (or a float64
               near tie on at most 0.1% of the frames), body and tail_out
               within 2e-6; each stage's splices of all steps equal the
               offline chain kernel's (phase 6) over the whole clip;
 14. streamed — `run --stream --export` on the 300 s 5-node project and
               config 4, every chunk step under
               torch.cuda.set_sync_debug_mode("error"): masters of the
               offline card render's length (phases 4 and 7) within 3e-7 and
               2e-6, >= 1 resampler launch, >= 2 WSOLA kernel launches on
               config 4; then each graph exported again at 100 s and at
               300 s: the 300 s export's peak device memory no more than 2
               MiB above the 100 s export's, and below the offline render's;
 15. stream times — e2e_streamed_wav and e2e_streamed_timevariant: the wall
               RTF of three more exports each (WAV sinks, nothing
               instrumented), median, min and max, and the median export's
               stage budget; the chunk entry per launch at both stages'
               k_cap beside its bound and the plain chunk chain, and its time
               summed over the export's launches.
 16. wsola-table — the score-table kernel against wsola_score_table_plain
               on the card, on the 7 golden signals and on phase 6's two
               config-4 chains (K 11,820 and 7,507): differing entries each
               a float64 near tie (TIE_REL) on at most TIE_SHARE of the
               K*(seek+1) entries, the table bitwise the same at
               frames_per_step 1, 2 and 4, the walk kernel bitwise the plain
               walk; against the chain kernel: F[k][bs[k-1]] == bs[k] but for
               near ties on at most TIE_SHARE of K, frame 0 exactly, and the
               plain assembly of the walk's splices within 2e-6 of the chain
               kernel's body where they agree. Times at both shapes: the
               kernel, the plain table, the library yardstick (chunked
               torch.bmm + argmax), the walk and the plain walk, with bounds;
 17. probes  — both step probes in both forms against their plain outputs
               (exactly); tools.probes.wsola_step_overhead (bare and dma us
               per step by K-slope) beside the chain's us per frame; then
               `python -m nodey_tpu_torch.tools.ab_wsola_fps 30 8` in process:
               its whole output, fps 2 and 4 tables equal to fps 1, and a
               launch of each of its five kernels;
 18. resample-data — resample.resample_data (the polyphase kernel, the
               counterpart of resample_data_pallas) against its plain version
               (2e-6) at tests/test_pallas.py's shapes (44.1<->48 kHz, C 1
               and 2, 0.5 s) and at 48->44.1 kHz on 300 s stereo; then
               tools.probes.resample_ab at 48->44.1 and 44.1->48 kHz (kernel,
               plain, F.conv1d, 300 s stereo); the kernel alone at 48->44.1
               kHz in both register tiles beside its bound.
 19. stream-pv — config 4 with both tempo nodes on "pv", streamed at 16 s
               chunks on phase 6's track: driven by hand, every launch of the
               lock kernel and of the resampler inside every step within 2e-6
               of its plain version on its operands (the lock's launches
               bitwise it on finite inputs, and at the plans' frames a step,
               phase 9's chunk shapes), and the master through the kernels
               >= 90 dB against the same steps with the plain lock, and
               bitwise it where every lock launch had finite inputs
               (the resampler is held launch by launch only: the PV turns on
               the ulps by which its inputs move); then `run --stream --export`, every
               step under torch.cuda.set_sync_debug_mode("error"), plain and
               with pv_transient and preserve_formants: length 11,519,994,
               finite, one lock launch per PV stage step with frames, no
               phase-path launch; streamed vs offline on the 10 s excerpt at
               2 s chunks >= 40 dB on the card (the CPU's figure and the 300 s
               exports' printed beside it); a witness at 300 s by 30 s of
               output, printed: offline on the card vs on the CPU, and
               streamed vs offline on the CPU; whole-export device peaks at 100 s
               and 300 s within 2 MiB, below the offline PV render's; the lock
               per launch at both chunk shapes beside its bound and the plain
               lock, and the export's wall RTF (median of 3) and stage budget;
 20. realtime — `run --realtime` on a 10 s 5-node project: wall >= 0.98x the
               audio; the default (streamed) session's blocks >= 120 dB against
               Runner.preview() on the card, the whole-clip session's bitwise
               equal; first-block latency and underruns;
 21. chunked — render_chunked on the 300 s 5-node graph: master >= 130 dB
               against the offline render, the same length, its spectrum's
               frames the clip's and >= 100 dB against the offline spectrum's;
               resampler launches per chunk; peak device memory below the
               offline render's.
Each path's launch counts are set to 0 just before it runs and read just
after (phases 17-18's paths: the step-overhead measurement, the A/B tool,
the resampler's A/B; phases 19-21's: the streamed PV exports, the realtime
preview, the chunked render). The line before the last is one JSON object
describing the kernels;
the last is ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CARD = "cuda"                    # the device the port renders on
TOL = 2e-6
SNR_DB = 100.0
SECONDS = 300
EXCERPT_SECONDS = 10
RATE = 44_100
PITCH = 4.0                      # config 4's pitch_modifier, semitones
VELOCITY = 1.25                  # config 4's velocity_modifier, keep_pitch
# Config 4's valid lengths for one 300 s track (the JAX package's formulas):
# 13,230,000 -> 14,400,000 (48 kHz) -> 18,142,848 (tempo 2^(-1/3)) ->
# 14,399,993 (635/504) -> 11,519,994 (tempo 1.25).
CONFIG4_LENGTH = 11_519_994
CONFIG4_FRAMES = (11_820, 7_507)
CONFIG4_PV_FRAMES = (35_460, 22_520)   # the phase vocoder's K, both stages
PV_PLANE_DB = 100.0
PV_PHASOR_TOL = 1e-3
PV_EXCERPT_DB = 90.0
PV_PASSES = ("totals", "carry", "apply")  # the phase-path kernel's launches
# Card vs CPU on the PV excerpt. The two differ in the analysis GEMMs and in
# atan2/cos/sin by ulps, and a steady tone's sidelobe bins sit where the
# phase wrap is decided by such ulps, so the PV output itself moves by tens
# of dB: phase 10 prints the CPU's own change for re moved by one ulp.
PV_DEVICE_DB = 40.0
TIE_REL = 1e-5                   # a differing choice must be this near a tie
TIE_SHARE = 1e-3                 # ... on at most this share of the frames
# The WSOLA energy prologue against its plain version (conv1d of the squared
# window): two float32 sums of C*overlap squares in different orders.
ENERGY_REL = 1e-5
# One FFMA's latency on this card, in cycles (an estimate for the chain's
# serial floor: C*overlap dependent FFMAs per frame).
FFMA_LATENCY_CYCLES = 4
# (in_rate, out_rate, samples): the two main-path pairs first.
MAIN_CAPACITY = -(-RATE * SECONDS // 65_536) * 65_536  # Runner._bucket
KERNEL_PAIRS = [
    (44_100, 48_000, MAIN_CAPACITY),
    (635, 504, 18_155_904),  # config 4's pitch-stage WSOLA output width
    (22_050, 48_000, 22_050 * EXCERPT_SECONDS + 4_321),
    (44_100, 32_000, 44_100 * EXCERPT_SECONDS + 4_321),
]
GOLDEN_CASES = [
    (48_000, 0.8), (48_000, 1.25), (48_000, 2.0), (48_000, 1.1037),
    (44_100, 0.8), (44_100, 1.25), (44_100, 2.0),
]
# Streaming (phases 13-15): export_streamed's chunk length, the 5-node
# mix's streamed == offline bar (the JAX package's), the short clip of the
# memory check, and how far the 300 s export's device peak may exceed the
# 100 s export's: 2 MiB, a third of one 16 s master block (a buffer that
# grew with the clip would add 0.37 MiB per audio-second, one a step kept
# alive 6 MiB per step).
STREAM_CHUNK_SECONDS = 16
STREAM_MIX_TOL = 3e-7
SHORT_SECONDS = 100
STREAM_SLACK_BYTES = 2 * 2**20
STREAM_TIMED_RUNS = 3
# Phase 19: the streamed PV's 10 s excerpt against its offline render at 2 s
# chunks (so the carries cross chunk boundaries), and the lock's inputs of
# which launch per chunk shape are timed (a mid-clip step of 19).
STREAM_EXCERPT_CHUNK_SECONDS = 2
STREAM_LOCK_TIMED_STEP = 9
# Launches of the lock kernel timed at each chunk shape (queued behind a spin
# of the card: its wrapper's host time exceeds the kernel's there).
LOCK_TIMED_LAUNCHES = 200
# Phases 16-18: the A/B tool's arguments (python -m
# nodey_tpu_torch.tools.ab_wsola_fps 30 8), the probes' step count for their
# checks and times (bench.py's larger K), tests/test_pallas.py's rate pairs.
TOOL_ARGS = ["30", "8"]
PROBE_STEPS = 4096
RESAMPLE_DATA_PAIRS = [(44_100, 48_000), (48_000, 44_100)]
# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


def fail(message: str) -> None:
    print(f"chip_smoke FAILED: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, message: str) -> None:
    if not ok:
        fail(message)


def cuda_ms(fn, iters: int, warmup: int = 2, queued: bool = False):
    """Milliseconds of each of ``iters`` back-to-back calls by CUDA events,
    after ``warmup`` calls. ``queued``: the card first spins for ~0.1 ms a
    call (torch.cuda._sleep), so the calls queue up behind it and the events
    time the device work alone, where a call's host time (a wrapper's tens
    of us) would exceed it."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    if queued:
        torch.cuda._sleep(max(10**7, 200_000 * iters))
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in events]


def device_peak(fn) -> int:
    """Bytes of device memory allocated at the peak of ``fn()`` above what
    was allocated before it (garbage collected first, so no earlier tensor
    is freed during ``fn``)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def summary(times):
    """(median, min, max, count) of a list of milliseconds."""
    times = sorted(times)
    return times[len(times) // 2], times[0], times[-1], len(times)


def bound(nbytes: float, flops: float):
    """(ms, "bytes" | "operations"): the least time the card could take to
    move ``nbytes`` and do ``flops`` FP32 operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def resample_work_bound(x, G: int, M: int, bank):
    """The polyphase resampler's bound on these inputs: x and the bank read
    once, y written once; 2 flops for each of the taps a phase really has
    (not the dense W-wide window)."""
    from nodey_tpu_torch.ops import resample as tr

    C, L = x.shape[0], bank.shape[0]
    taps = tr._effective_taps(L, M, tr.DEFAULT_TAPS)
    return bound(4 * (x.numel() + bank.numel() + C * G * L),
                 2 * taps * C * G * L)


def time_resampler(tag: str, label: str, fns: dict, order, iters: int,
                   card: str, work_bound):
    """Median ms of each of ``fns`` (timed in ``order``, CUDA events),
    printed, the kernels' beside ``work_bound``; returns the medians by
    name."""
    runs = {name: [] for name in fns}
    for name in order:
        runs[name] += cuda_ms(fns[name], iters)
    for name in fns:
        med, lo, hi, count = summary(runs[name])
        share = (f"; the bound {work_bound[0]:.4f} ms by {work_bound[1]} is "
                 f"{work_bound[0] / med:.2%} of it"
                 if name.startswith("kernel") else "")
        print(f"[{tag}] {label}, {name}: median {med:.4f} ms (min {lo:.4f}, "
              f"max {hi:.4f}, n={count}){share} ({card})")
    return {name: summary(runs[name])[0] for name in fns}


def snr_db(reference, test) -> float:
    import numpy as np

    reference = np.asarray(reference, dtype=np.float64)
    noise = reference - np.asarray(test, dtype=np.float64)
    denom = float(np.sum(noise ** 2))
    if denom == 0.0:
        return math.inf
    return 10.0 * math.log10(float(np.sum(reference ** 2)) / denom)


def make_signals(seconds: int, seed: int = 0):
    """Two 44.1 kHz stereo tracks [2, n] float32: tones plus noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = RATE * seconds
    t = np.arange(n, dtype=np.float64) / RATE
    return [
        np.stack([
            0.35 * np.sin(2 * np.pi * 220.0 * (i + 1) * t)
            + 0.1 * rng.standard_normal(n),
            0.3 * rng.standard_normal(n),
        ]).astype(np.float32)
        for i in range(2)
    ]


def golden_signal(rate: int):
    """The WSOLA goldens' seeded signal (tests/make_wsola_goldens.py)."""
    import numpy as np

    n = int(rate * 1.2)
    t = np.arange(n, dtype=np.float64) / rate
    sig = (
        0.35 * np.sin(2 * np.pi * 220.0 * t)
        + 0.2 * np.sin(2 * np.pi * 513.0 * t + 0.7)
        + 0.1 * np.sin(2 * np.pi * 1877.0 * t + 1.3)
    )
    rng = np.random.default_rng(20260817)
    noise = 0.05 * rng.standard_normal((2, n))
    return (np.stack([sig, sig * 0.85]) + noise).astype(np.float32)


def write_tracks(directory: str, signals, tag: str):
    """The signals as s16 WAVs; returns their paths."""
    from nodey_tpu_torch.host.decode import write_wav_s16

    paths = []
    for i, data in enumerate(signals):
        path = os.path.join(directory, f"track_{i + 1}_{tag}.wav")
        write_wav_s16(path, data, RATE)
        paths.append(path)
    return paths


def _pin(g, n, p):
    return g.nodes[n].pin_name_map[p]


def flagship_graph(paths, volume=1.5, mix=(0.6, 0.4)):
    """The 5-node graph as __graft_entry__._flagship_graph builds it, with
    the port's processors."""
    from nodey_tpu_torch.core.graph import Graph
    from nodey_tpu_torch.processors.amix import AudioAmix
    from nodey_tpu_torch.processors.audio_input import AudioInput
    from nodey_tpu_torch.processors.audio_output import AudioOutput
    from nodey_tpu_torch.processors.audio_vol import AudioVol
    from nodey_tpu_torch.processors.spectrum import AudioSpectrum

    g = Graph()
    src = g.add_node(AudioInput())
    g.nodes[src].processor.file_paths = list(paths)
    g.update_node_pin(src)
    vol = g.add_node(AudioVol())
    g.nodes[vol].processor.set_volume(volume)
    amix = g.add_node(AudioAmix())
    g.nodes[amix].processor.set_input_num(2)
    g.nodes[amix].processor.volumes = list(mix)
    spec = g.add_node(AudioSpectrum())
    out = g.add_node(AudioOutput())
    g.add_link(_pin(g, src, "output_0"), _pin(g, vol, "input"))
    g.add_link(_pin(g, vol, "output"), _pin(g, amix, "input_1"))
    g.add_link(_pin(g, src, "output_1"), _pin(g, amix, "input_2"))
    g.add_link(_pin(g, amix, "output"), _pin(g, spec, "input"))
    g.add_link(_pin(g, spec, "output"), _pin(g, out, "input"))
    return g


def config4_graph(path, algorithm="wsola", transient=False, formants=False):
    """BASELINE config 4 as bench.py:172-192 builds it, with the port's
    processors: resample 48 kHz -> pitch +4 -> velocity 1.25 keep_pitch.
    ``algorithm`` sets both tempo stages (with "pv", ``transient`` sets
    pv_transient on both nodes and ``formants`` preserve_formants on the
    pitch node, as bench.py's rtf_config4_pv variants do)."""
    from nodey_tpu_torch.core.graph import Graph
    from nodey_tpu_torch.processors.audio_input import AudioInput
    from nodey_tpu_torch.processors.audio_output import AudioOutput
    from nodey_tpu_torch.processors.resample_node import AudioResample
    from nodey_tpu_torch.processors.velocity import PitchModifier, VelocityModifier

    g = Graph()
    src = g.add_node(AudioInput())
    g.nodes[src].processor.file_paths = [path]
    g.update_node_pin(src)
    rs = g.add_node(AudioResample())
    g.nodes[rs].processor.set_target_rate(48_000)
    pitch = g.add_node(PitchModifier())
    g.nodes[pitch].processor.pitch = PITCH
    vel = g.add_node(VelocityModifier())
    g.nodes[vel].processor.set_velocity(VELOCITY)
    g.nodes[vel].processor.keep_pitch = True
    out = g.add_node(AudioOutput())
    g.add_link(_pin(g, src, "output_0"), _pin(g, rs, "input"))
    g.add_link(_pin(g, rs, "output"), _pin(g, pitch, "input"))
    g.add_link(_pin(g, pitch, "output"), _pin(g, vel, "input"))
    g.add_link(_pin(g, vel, "output"), _pin(g, out, "input"))
    for node in (pitch, vel):
        processor = g.nodes[node].processor
        processor.set_algorithm(algorithm)
        processor.pv_transient = transient
    g.nodes[pitch].processor.preserve_formants = formants
    return g


def zero_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    from nodey_tpu_torch.ops import cuda_probes, cuda_pv, cuda_resample
    from nodey_tpu_torch.ops import cuda_wsola, cuda_wsola_table

    cuda_resample.launches = 0
    cuda_wsola.launches = 0
    cuda_wsola.energy_launches = 0
    cuda_pv.phase_path_launches = 0
    cuda_pv.lock_launches = 0
    cuda_wsola_table.table_launches = 0
    cuda_wsola_table.walk_launches = 0
    cuda_probes.bare_launches = 0
    cuda_probes.dma_launches = 0


def read_counts() -> dict:
    """Every kernel wrapper's launch count, by kernel name."""
    from nodey_tpu_torch.ops import cuda_probes, cuda_pv, cuda_resample
    from nodey_tpu_torch.ops import cuda_wsola, cuda_wsola_table

    return {"polyphase_resample": cuda_resample.launches,
            "wsola_chain": cuda_wsola.launches,
            "wsola_energy": cuda_wsola.energy_launches,
            "pv_phase_path": cuda_pv.phase_path_launches,
            "pv_lock": cuda_pv.lock_launches,
            "wsola_score_table": cuda_wsola_table.table_launches,
            "wsola_table_walk": cuda_wsola_table.walk_launches,
            "step_probe_bare": cuda_probes.bare_launches,
            "step_probe_dma": cuda_probes.dma_launches}


def cli_export(cli, project: str, out_wav: str, tag: str, card: str):
    """Render ``project`` through the port's CLI on the card into
    ``out_wav``, launch counts set to 0 just before; returns (master,
    launches by kernel)."""
    import numpy as np

    from nodey_tpu_torch.host.decode import decode_file

    stdout = io.StringIO()
    zero_counts()
    with contextlib.redirect_stdout(stdout):
        rc = cli.main(["run", project, "--export", out_wav, "--device", CARD])
    counts = read_counts()
    print("\n".join(f"[{tag}] cli: {line}"
                    for line in stdout.getvalue().splitlines()))
    check(rc == 0, f"{tag}: cli run exited {rc}")
    master = decode_file(out_wav).data
    print(f"[{tag}] {SECONDS} s export: master {list(master.shape)}, finite "
          f"{bool(np.isfinite(master).all())}; launches {counts} ({card})")
    check(master.shape == (2, CONFIG4_LENGTH),
          f"{tag}: master {master.shape}, want (2, {CONFIG4_LENGTH})")
    check(bool(np.isfinite(master).all()), f"{tag}: master not finite")
    return master, counts


def pv_operands(data, tempo: float, rate: int):
    """``(re, im, dpos, hop, n_fft)``: the analysis planes and geometry that
    ``pv._pv_impl`` hands the phase path for ``data`` [C, N]."""
    from nodey_tpu_torch.ops import pv

    n_fft, hop, pos, dpos, pad_to = pv._pv_geometry(data.shape[1], tempo, rate)
    re, im = pv._analysis(data, pos, pad_to, n_fft)
    return re, im, dpos, hop, n_fft


def plane_snr_db(reference, test) -> float:
    """SNR of a plane on the card, summed in float64 on the card."""
    reference = reference.double()
    noise = float(((reference - test.double()) ** 2).sum())
    if noise == 0.0:
        return math.inf
    return 10.0 * math.log10(float((reference ** 2).sum()) / noise)


def check_pv(tag: str, operands, card: str):
    """Both PV kernels against their plain versions on ``operands`` (from
    pv_operands). Returns ({"abs": worst max|diff| of the phase path,
    "lock": the lock's}, the lock's inputs: the plain path's unlocked
    phasors, phases and magnitudes)."""
    import torch

    from nodey_tpu_torch.ops import cuda_pv, pv

    re, im, dpos, hop, n_fft = operands
    mag, ph = pv._magnitude_phase(re, im)
    live = mag > 0
    worst = 0.0
    for lock in (True, False):
        ry, iy = cuda_pv.phase_path_cuda(re, im, dpos, hop, n_fft, lock)
        pry, piy = pv.phase_path_plain(re, im, dpos, hop, n_fft, lock)
        torch.cuda.synchronize()
        snr = min(plane_snr_db(pry, ry), plane_snr_db(piy, iy))
        phasor = (torch.hypot(ry - pry, iy - piy)[live] / mag[live]).max().item()
        err = max((ry - pry).abs().max().item(), (iy - piy).abs().max().item())
        differ = int((ry != pry).sum()) + int((iy != piy).sum())
        digest = hashlib.sha256(
            torch.stack([ry, iy]).cpu().numpy().tobytes()).hexdigest()[:16]
        print(f"[9 pv-kernels] {tag}: phase path, lock {lock}: planes SNR "
              f"{snr:.1f} dB (min {PV_PLANE_DB:.0f}), max phasor error "
              f"{phasor:.3e} (max {PV_PHASOR_TOL:g}), max|kernel - plain| "
              f"{err:.3e}, {differ} of {2 * ry.numel()} plane elements not "
              f"bitwise the plain version's, kernel planes' sha256 "
              f"{digest} ({card})")
        check(snr >= PV_PLANE_DB, f"{tag}: phase-path planes below the bar")
        check(phasor <= PV_PHASOR_TOL, f"{tag}: a bin's phasor disagrees")
        worst = max(worst, err)
        del ry, iy, pry, piy
    cos_phi, sin_phi = pv._synthesis_phasors(ph, dpos, hop, n_fft)
    lock_in = (cos_phi, sin_phi, ph, mag)
    lock_err = check_lock(f"{tag}: lock", lock_in, card)
    return {"abs": worst, "lock": lock_err}, lock_in


def lock_against_plain(got, lock_in):
    """(max|kernel - plain|, elements not bitwise the plain lock's, whether
    the inputs are finite) of the lock kernel's planes ``got`` on
    ``lock_in`` (cos_phi, sin_phi, ph, mag). The kernel must be within TOL
    of the plain lock, and bitwise it where the inputs are finite (the same
    decisions and roundings)."""
    import torch

    from nodey_tpu_torch.ops import pv

    want = pv._lock_to_peaks(*lock_in)
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    differ = sum(int((g != w).sum()) for g, w in zip(got, want))
    finite = all(bool(torch.isfinite(t).all()) for t in lock_in)
    return err, differ, finite


def check_lock(tag: str, lock_in, card: str) -> float:
    """The lock kernel against the plain lock on ``lock_in``
    (``lock_against_plain``). Returns max|kernel - plain|."""
    from nodey_tpu_torch.ops import cuda_pv

    err, differ, finite = lock_against_plain(
        cuda_pv.lock_to_peaks_cuda(*lock_in), lock_in)
    print(f"[9 pv-kernels] {tag}, {list(lock_in[3].shape)}: max|kernel - "
          f"plain| = {err:.3e} (tol {TOL:.0e}), {differ} of "
          f"{2 * lock_in[3].numel()} elements not bitwise the plain lock's "
          f"(inputs finite: {finite}) ({card})")
    check(err <= TOL, f"{tag}: the lock kernel disagrees with the plain lock")
    check(differ == 0 or not finite,
          f"{tag}: the lock kernel is not bitwise the plain lock")
    return err


def lock_cases(lock_inputs, card: str) -> float:
    """Phase 9's lock cases beyond check_pv's: the streamed PV's two chunk
    shapes (a step's frames from the middle of each stage's lock inputs),
    and the pitch stage's whole shape with special frames (silent, rising to
    the top bin, equal magnitudes, a comb of ties) at frames 3, 5, 7 and 9 of
    every 64. Returns the worst max|kernel - plain|."""
    import torch

    from nodey_tpu_torch.tools.pv_phase_ab import chunk_frames

    worst = 0.0
    for tag, frames in chunk_frames(STREAM_CHUNK_SECONDS, RATE).items():
        planes = lock_inputs[tag]
        k0 = (planes[3].shape[1] - frames) // 2
        step = tuple(t[:, k0 : k0 + frames].contiguous() for t in planes)
        worst = max(worst, check_lock(
            f"lock at the {tag} stage's chunk shape, frames {k0} to "
            f"{k0 + frames - 1}", step, card))
    cos_phi, sin_phi, ph, mag = (t.clone() for t in lock_inputs["pitch"])
    B = mag.shape[2]
    bins = torch.arange(B, device=mag.device, dtype=mag.dtype)
    special = {3: torch.zeros_like(bins), 5: (bins + 1) / B,
               7: torch.full_like(bins, 0.5),
               9: torch.where(bins % 10 == 0, 1.0, 0.5)}
    for k, row in special.items():
        mag[:, k::64] = row
    worst = max(worst, check_lock("lock at the pitch stage's shape with "
                                  "special frames", (cos_phi, sin_phi, ph,
                                                     mag), card))
    return worst


def wsola_operands(data, tempo: float, rate: int):
    """``(x, head, geometry)`` that ``stretch._wsola_impl`` hands the chain
    for ``data`` [C, N] on its device."""
    import torch.nn.functional as F

    from nodey_tpu_torch.ops import stretch

    geo = stretch.wsola_geometry(data.shape[1], tempo, rate)
    x = F.pad(data, (0, max(0, geo["pad_to"] - data.shape[1])))
    return x, x[:, : geo["overlap"]], geo


def chain_args(geo):
    return (geo["K"], geo["num"], geo["den"], geo["seq"], geo["seek"],
            geo["overlap"])


def near_tie(x, head, bs, k: int, other: int, geo, k0: int = 0,
             base: int = 0) -> float:
    """|score64(bs[k]) - score64(other)| / max_b |score64(b)| of the chain's
    k-th frame (frame k0 + k, read from column frame_pos(k0 + k) - base),
    in float64 with the tail that the chain's choice bs[k-1] realized."""
    import numpy as np

    from nodey_tpu_torch.ops.wsola import frame_pos

    seq, seek, ov = geo["seq"], geo["seek"], geo["overlap"]
    num, den = geo["num"], geo["den"]
    if k == 0:
        tail = head
    else:
        start = (frame_pos(k0 + k - 1, num, den) - base + int(bs[k - 1])
                 + seq - ov)
        tail = x[:, start : start + ov]
    pos = frame_pos(k0 + k, num, den) - base
    cand = x[:, pos : pos + seek + ov].double().cpu().numpy()
    tail = tail.double().cpu().numpy()
    win = np.lib.stride_tricks.sliding_window_view(cand, ov, axis=1)
    scores = (np.einsum("cv,cbv->b", tail, win)
              / np.sqrt((win * win).sum(axis=(0, 2)) + 1e-9))
    return abs(scores[int(bs[k])] - scores[other]) / np.abs(scores).max()


def check_chain(tag: str, x, head, geo, card: str):
    """The kernel's chain on (x, head) against the plain version: every
    frame's choice given the kernel's previous one, and the audio given all
    of them. Returns (bs, body, max|body - plain|)."""
    import numpy as np
    import torch

    from nodey_tpu_torch.ops import cuda_wsola, wsola

    bs, body = cuda_wsola.wsola_chain_cuda(x, head, *chain_args(geo))
    torch.cuda.synchronize()
    bs_host = bs.cpu().numpy()
    replay = wsola.replay_decisions(x, head, bs_host, *chain_args(geo))
    differ = np.nonzero(replay.cpu().numpy() != bs_host)[0]
    want = wsola.assemble_plain(x, head, bs_host, *chain_args(geo))
    err = (body - want).abs().max().item()
    gaps = [near_tie(x, head, bs_host, int(k), int(replay[k]), geo)
            for k in differ]
    worst = max(gaps, default=0.0)
    K = geo["K"]
    print(f"[6 wsola] {tag}: K={K}, x {list(x.shape)}: {len(differ)} frames "
          f"choose otherwise than the plain scoring given the kernel's "
          f"previous choice (max share {TIE_SHARE:g}), worst float64 gap "
          f"{worst:.3e} of the frame's max |score| (max {TIE_REL:g}); "
          f"max|body - plain assembly| = {err:.3e} (tol {TOL:.0e}) ({card})")
    check(len(differ) <= TIE_SHARE * K, f"{tag}: {len(differ)} frames differ")
    check(worst <= TIE_REL, f"{tag}: a differing frame is no near tie")
    check(err <= TOL, f"{tag}: kernel audio disagrees with the plain assembly")
    return bs, body, err


def check_energy(tag: str, x, geo, card: str):
    """The chain's energy prologue against its plain version on one chain's
    operands, every frame, in the wrapper's blocks of BLOCK_FRAMES: max
    relative difference <= ENERGY_REL. Returns (max relative, max abs)."""
    from nodey_tpu_torch.ops import cuda_wsola, wsola

    K, args = geo["K"], chain_args(geo)[1:]
    rel = err = 0.0
    for k0 in range(0, K, cuda_wsola.BLOCK_FRAMES):
        n = min(cuda_wsola.BLOCK_FRAMES, K - k0)
        got = cuda_wsola.wsola_energy_cuda(x, k0, 0, n, *args)
        want = wsola.wsola_energy_plain(x, k0, 0, n, *args)
        rel = max(rel, ((got - want).abs() / want).max().item())
        err = max(err, (got - want).abs().max().item())
        del got, want
    print(f"[6 wsola] {tag}: energy prologue, table [{K}, {geo['seek'] + 1}]"
          f" in {-(-K // cuda_wsola.BLOCK_FRAMES)} launches: max|kernel - "
          f"plain| / plain = {rel:.3e} (tol {ENERGY_REL:.0e}), max|kernel - "
          f"plain| = {err:.3e} ({card})")
    check(rel <= ENERGY_REL, f"{tag}: the energy prologue disagrees with plain")
    return rel, err


def table_gaps(x, geo, entries, table, other):
    """For score-table rows (k, p) in ``entries`` [n, 2]: |score64(table[k,
    p]) - score64(other[k, p])| / max_b |score64(b)| of that row, in
    float64 on x's device (row p of frame k >= 1 scores the tail
    x[:, frame_pos(k-1) + stride + p :], frame 0 the head)."""
    import torch

    from nodey_tpu_torch.ops.wsola import frame_pos

    seq, seek, ov = geo["seq"], geo["seek"], geo["overlap"]
    num, den = geo["num"], geo["den"]
    rows = {}
    for k, p in entries.tolist():
        rows.setdefault(k, []).append(p)
    gaps = []
    for k, ps in rows.items():
        pos = frame_pos(k, num, den)
        cand = x[:, pos : pos + seek + ov].double().unfold(1, ov, 1)
        p = torch.tensor(ps, device=x.device)
        start = frame_pos(k - 1, num, den) + seq - ov if k else 0
        cols = (p[:, None] * (k > 0) + start
                + torch.arange(ov, device=x.device))
        scores = (torch.einsum("cpv,cbv->pb", x[:, cols].double(), cand)
                  / torch.sqrt((cand * cand).sum((0, 2)) + 1e-9))
        i = torch.arange(len(ps), device=x.device)
        gap = scores[i, table[k, p].long()] - scores[i, other[k, p].long()]
        gaps += (gap.abs() / scores.abs().max(dim=1).values).tolist()
    return gaps


def library_table(x, geo):
    """The score table's library yardstick, timed by this script only (the
    port never calls it): per 64 frames one ``torch.bmm`` of the
    channel-stacked Hankel operands [F, n, C*overlap] (TF32 off), the
    candidates' rsqrt norms, then ``torch.argmax``."""
    import torch

    from nodey_tpu_torch.ops.wsola import frame_pos

    K, num, den, seq, seek, ov = chain_args(geo)
    C, n = x.shape[0], seek + 1
    cols = torch.arange(seek + ov, device=x.device)
    table = torch.empty((K, n), dtype=torch.int32, device=x.device)
    for k0 in range(0, K, 64):
        ks = range(k0, min(K, k0 + 64))
        pos = torch.tensor([frame_pos(k, num, den) for k in ks],
                           device=x.device)
        prev = torch.tensor([frame_pos(k - 1, num, den) + seq - ov if k else 0
                             for k in ks], device=x.device)

        def stacked(starts):
            return (x[:, starts[:, None] + cols].unfold(2, ov, 1)
                    .permute(1, 2, 0, 3).reshape(len(ks), n, C * ov))

        cand, tail = stacked(pos), stacked(prev)
        if k0 == 0:
            tail[0] = x[:, :ov].reshape(1, C * ov)
        scores = torch.bmm(tail, cand.transpose(1, 2))
        scores *= torch.rsqrt((cand * cand).sum(2) + 1e-9)[:, None, :]
        table[k0 : k0 + len(ks)] = torch.argmax(scores, dim=2).int()
    return table


def check_table(tag: str, x, head, geo, card: str, chain=None):
    """Phase 16 on one (x, geometry): the score kernel against the plain
    table (differing entries float64 near ties, on at most TIE_SHARE of
    them), bitwise the same at frames_per_step 1, 2 and 4; the walk kernel
    against the plain walk of the same table, bitwise. With ``chain`` = the
    chain kernel's (bs, body) on the same operands: F[k][bs[k-1]] == bs[k]
    but for near ties on at most TIE_SHARE of K, frame 0 exactly, and
    ``wsola.assemble_plain`` of the walk's splices within TOL of the chain
    kernel's body on every frame where the walk and the chain agree (and
    agreed the frame before). Returns (table, worst gap, worst body err)."""
    import torch

    from nodey_tpu_torch.ops import cuda_wsola_table, wsola

    args = chain_args(geo)
    K, n_cand = geo["K"], geo["seek"] + 1
    tables = {f: cuda_wsola_table.wsola_score_table_cuda(
        x, *args, frames_per_step=f) for f in (1, 2, 4)}
    table = tables[1]
    plain = wsola.wsola_score_table_plain(x, *args)
    same_fps = all(torch.equal(table, tables[f]) for f in (2, 4))
    differ = (table != plain).nonzero()
    gaps = table_gaps(x, geo, differ, table, plain)
    walk = cuda_wsola_table.walk_table_cuda(table)
    same_walk = torch.equal(walk, wsola.walk_table_plain(table))
    torch.cuda.synchronize()
    worst = max(gaps, default=0.0)
    print(f"[16 wsola-table] {tag}: K={K}, table [{K}, {n_cand}]: "
          f"{len(differ)} entries differ from the plain table (max share "
          f"{TIE_SHARE:g} = {int(TIE_SHARE * K * n_cand)}), worst float64 gap "
          f"{worst:.3e} of the row's max |score| (max {TIE_REL:g}); "
          f"frames_per_step 1, 2, 4 {'bitwise equal' if same_fps else 'DIFFER'}"
          f"; walk kernel vs plain walk "
          f"{'bitwise equal' if same_walk else 'DIFFER'} ({card})")
    check(len(differ) <= TIE_SHARE * K * n_cand,
          f"{tag}: {len(differ)} table entries differ from the plain table")
    check(worst <= TIE_REL, f"{tag}: a differing table entry is no near tie")
    check(same_fps, f"{tag}: the table depends on frames_per_step")
    check(same_walk, f"{tag}: the walk kernel disagrees with the plain walk")
    err = 0.0
    if chain is not None:
        bs, body = chain
        bs_host = bs.cpu().numpy()
        pred = table[1:].gather(1, bs[:-1].long()[:, None])[:, 0]
        off = ((pred != bs[1:]).nonzero()[:, 0] + 1).tolist()
        cross = [near_tie(x, head, bs_host, k, int(pred[k - 1]), geo)
                 for k in off]
        frame0 = bool((table[0] == bs[0]).all())
        agree = walk == bs
        agree[1:] &= agree[:-1].clone()
        stride = geo["seq"] - geo["overlap"]
        want = wsola.assemble_plain(x, head, walk.cpu().numpy(), *args)
        cols = agree.repeat_interleave(stride)
        if bool(cols.any()):
            err = (body[:, cols] - want[:, cols]).abs().max().item()
        print(f"[16 wsola-table] {tag}: against the chain kernel: "
              f"F[k][bs[k-1]] != bs[k] on {len(off)} of {K} frames (max share "
              f"{TIE_SHARE:g}), worst float64 gap {max(cross, default=0.0):.3e}"
              f"; frame 0 {'equal' if frame0 else 'DIFFERS'}; the walk equals "
              f"the chain on {int(agree.sum())} of {K} frames; plain assembly "
              f"of the walk's splices vs the chain kernel's body there: "
              f"max|diff| {err:.3e} (tol {TOL:.0e}) ({card})")
        check(len(off) <= TIE_SHARE * K, f"{tag}: the table and the chain "
              f"kernel disagree on {len(off)} frames")
        check(max(cross, default=0.0) <= TIE_REL, f"{tag}: a frame where the "
              "table and the chain differ is no near tie")
        check(frame0, f"{tag}: frame 0's row is not the chain's first choice")
        check(err <= TOL, f"{tag}: the walk's audio disagrees with the chain's")
    return table, worst, err


def table_and_probe_phases(card: str, dev, stages, chain_us: float):
    """Phases 16-18 (see the module docstring). ``stages``: config 4's two
    chains from phase 6, (tag, x, head, geo, bs, body) each; ``chain_us``:
    the chain kernel's microseconds per frame (phase 8). Returns (the launch
    counts of the three paths run here, by path; the kernels' entries of the
    ``kernels`` line, without their launches)."""
    import numpy as np
    import torch

    from nodey_tpu_torch.ops import cuda_probes, cuda_resample, cuda_wsola
    from nodey_tpu_torch.ops import cuda_wsola_table, wsola
    from nodey_tpu_torch.ops import resample as tr
    from nodey_tpu_torch.tools import ab_wsola_fps, probes

    # -- 16. wsola-table -------------------------------------------------------
    table_gap = 0.0
    for rate, tempo in GOLDEN_CASES:
        sig = torch.from_numpy(golden_signal(rate)).to(dev)
        x, head, geo = wsola_operands(sig, tempo, rate)
        chain = cuda_wsola.wsola_chain_cuda(x, head, *chain_args(geo))
        _, gap, _ = check_table(f"golden signal {rate} Hz, tempo {tempo}", x,
                                head, geo, card, chain)
        table_gap = max(table_gap, gap)
    times = {}
    for tag, x, head, geo, bs, body in stages:
        table, gap, _ = check_table(f"config-4 {tag} stage", x, head, geo,
                                    card, (bs, body))
        table_gap = max(table_gap, gap)
        args = chain_args(geo)
        fns = {
            "kernel": lambda: cuda_wsola_table.wsola_score_table_cuda(x, *args),
            "plain": lambda: wsola.wsola_score_table_plain(x, *args),
            "library": lambda: library_table(x, geo),
            "walk kernel": lambda: cuda_wsola_table.walk_table_cuda(table),
            "walk plain": lambda: wsola.walk_table_plain(table),
        }
        runs = {name: [] for name in fns}
        for name in ("plain", "library", "kernel", "kernel", "library",
                     "plain", "walk plain", "walk kernel", "walk kernel",
                     "walk plain"):
            runs[name] += cuda_ms(fns[name], 2, warmup=1)
        K, n, C, ov = geo["K"], geo["seek"] + 1, x.shape[0], geo["overlap"]
        times[tag] = {name: summary(runs[name])[0] for name in fns}
        # Least work: x read once, the table written once; C*ov*n multiply-
        # adds for each of frame 0's candidates and each (p, b) pair of the
        # other frames. The walk: one entry read and one splice written per
        # frame.
        times[tag]["bound"] = bound(4 * (x.numel() + K * n),
                                    2 * C * ov * n * (n * (K - 1) + 1))
        times[tag]["walk bound"] = bound(8 * K, 0)
        for name in fns:
            med, lo, hi, count = summary(runs[name])
            label = " (library yardstick)" if name == "library" else ""
            print(f"[16 wsola-table] times, {tag} stage, K={K}, x "
                  f"{list(x.shape)}, {name}{label}: median {med:.4f} ms (min {lo:.4f}, max {hi:.4f}, "
                  f"n={count}) ({card})")
        for what, key in (("score table", "kernel"), ("walk", "walk kernel")):
            ms, by = times[tag][("walk " if what == "walk" else "") + "bound"]
            print(f"[16 wsola-table] {what} bound, {tag} stage: {ms:.4f} ms "
                  f"by {by}; kernel at {ms / times[tag][key]:.2%} of it; "
                  f"{times[tag][key] * 1e3 / K:.4f} us per frame ({card})")
        del table, fns

    # -- 17. probes -----------------------------------------------------------
    rng = np.random.default_rng(17)
    block = torch.from_numpy(rng.standard_normal(cuda_probes.BLOCK).astype(
        np.float32)).to(dev)
    wide = torch.from_numpy(rng.standard_normal(
        (2, probes.DMA_COLUMNS)).astype(np.float32)).to(dev)
    span = probes.span_dma()
    probe_fns = {}
    for per_step in (True, False):
        probe_fns[("bare", per_step)] = (
            lambda p=per_step: cuda_probes.step_probe_bare_cuda(
                block, PROBE_STEPS, p),
            lambda p=per_step: cuda_probes.step_probe_bare_plain(
                block, PROBE_STEPS, p))
    for ring in (True, False):
        probe_fns[("dma", ring)] = (
            lambda r=ring: cuda_probes.step_probe_dma_cuda(
                wide, PROBE_STEPS, span, r),
            lambda r=ring: cuda_probes.step_probe_dma_plain(
                wide, PROBE_STEPS, span, r))
    what = {("bare", True): "out[k] per step (bench.py)",
            ("bare", False): "one fixed block (the tool)",
            ("dma", True): "3-slot ring, one-step prefetch (bench.py)",
            ("dma", False): "two copies per step, both waited (the tool)"}
    for key, (kernel, plain) in probe_fns.items():
        same = torch.equal(kernel(), plain())
        print(f"[17 probes] {key[0]} probe, {what[key]}, K={PROBE_STEPS}: "
              f"{'equal to' if same else 'DIFFERS from'} its plain output "
              f"({card})")
        check(same, f"the {key[0]} probe disagrees with its plain output")
    # Least bytes: x read once (the dma probe: the union of its windows),
    # each output written once.
    limit = cuda_probes.dma_limit(probes.DMA_COLUMNS, span)
    window_cols = min((PROBE_STEPS - 1) * cuda_probes.LANE, limit) + span
    bounds = {
        ("bare", True): bound(4 * 1024 * (1 + PROBE_STEPS), 0),
        ("bare", False): bound(4 * 1024 * 2, 0),
        ("dma", True): bound(
            4 * 2 * (window_cols + PROBE_STEPS * cuda_probes.LANE), 0),
        ("dma", False): bound(4 * 2 * (window_cols + cuda_probes.LANE), 0),
    }
    probe_times = {}
    for key, (kernel, plain) in probe_fns.items():
        runs = {"kernel": [], "plain": []}
        for name in ("plain", "kernel", "kernel", "plain"):
            runs[name] += cuda_ms(kernel if name == "kernel" else plain, 5)
        t = probe_times[key] = {k: summary(v)[0] for k, v in runs.items()}
        t["bound"] = bounds[key]
        print(f"[17 probes] {key[0]} probe, {what[key]}, K={PROBE_STEPS}, per "
              f"launch: kernel {t['kernel']:.4f} ms, plain {t['plain']:.4f} "
              f"ms, bound {t['bound'][0]:.6f} ms by {t['bound'][1]} ({card})")
    zero_counts()
    bare_s, dma_s = probes.wsola_step_overhead(8, device=CARD)
    counts_steps = read_counts()
    print(f"[17 probes] step overhead by K-slope ({probes.STEP_KS[0]} -> "
          f"{probes.STEP_KS[1]} steps, CUDA events): bare {bare_s * 1e6:.4f} "
          f"us per step, dma {dma_s * 1e6:.4f} us per step; the chain kernel "
          f"{chain_us:.4f} us per frame (phase 8, K={stages[0][3]['K']}); "
          f"launches {counts_steps} ({card})")
    check(counts_steps["step_probe_bare"] >= 2
          and counts_steps["step_probe_dma"] >= 2,
          "wsola_step_overhead did not run both probe kernels")
    probe_times[("bare", True)]["us_per_step"] = bare_s * 1e6
    probe_times[("dma", True)]["us_per_step"] = dma_s * 1e6

    stdout = io.StringIO()
    zero_counts()
    with contextlib.redirect_stdout(stdout):
        rc = ab_wsola_fps.main(TOOL_ARGS)
    counts_tool = read_counts()
    print("\n".join(f"[17 probes] ab_wsola_fps {' '.join(TOOL_ARGS)}: {line}"
                    for line in stdout.getvalue().splitlines()))
    print(f"[17 probes] ab_wsola_fps launches {counts_tool} ({card})")
    check(rc == 0, f"ab_wsola_fps exited {rc}")
    for fps in (2, 4):
        check(f"table fps={fps} == fps=1: True" in stdout.getvalue(),
              f"ab_wsola_fps: the table at fps={fps} differs")
    for name in ("wsola_score_table", "wsola_table_walk", "step_probe_bare",
                 "step_probe_dma", "wsola_chain"):
        check(counts_tool[name] >= 1, f"ab_wsola_fps did not launch {name}")

    # -- 18. resample-data ----------------------------------------------------
    resample_err = 0.0
    cases = [(i, o, c, i // 2) for i, o in RESAMPLE_DATA_PAIRS for c in (1, 2)]
    cases.append((48_000, 44_100, 2, 48_000 * SECONDS))
    for in_rate, out_rate, channels, n in cases:
        data = torch.from_numpy((0.3 * np.random.default_rng(0).standard_normal(
            (channels, n))).astype(np.float32)).to(dev)
        got = tr.resample_data(data, in_rate, out_rate)
        x, G, M, W, bank, _ = tr.bank_operands(data, in_rate, out_rate)
        want = tr.apply_filter_bank_plain(x, G, M, W, bank)[:, : got.shape[1]]
        err = (got - want).abs().max().item()
        print(f"[18 resample-data] resample_data {in_rate}->{out_rate} Hz, "
              f"[{channels}, {n}] -> {list(got.shape)}: max|kernel - plain| "
              f"{err:.3e} (tol {TOL:.0e}) ({card})")
        check(err <= TOL, f"resample_data disagrees at {in_rate}->{out_rate}")
        resample_err = max(resample_err, err)
        del data, got, x, want
    zero_counts()
    ab = {pair: probes.resample_ab(*pair, SECONDS, device=CARD) for pair in (
        (48_000, 44_100), (44_100, 48_000))}
    counts_ab = read_counts()
    for (in_rate, out_rate), r in ab.items():
        print(f"[18 resample-data] resample_ab {in_rate}->{out_rate} Hz, "
              f"{SECONDS} s stereo: resample_data (the polyphase kernel) "
              f"{r['kernel_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"F.conv1d (library yardstick) {r['conv1d_ms']:.4f} ms, "
              f"max|kernel - plain| {r['max_diff']:.3e} ({card})")
        check(r["max_diff"] <= TOL, f"resample_ab: kernel and plain disagree "
              f"at {in_rate}->{out_rate}")
        resample_err = max(resample_err, r["max_diff"])
    print(f"[18 resample-data] resample_ab launches {counts_ab} ({card})")
    check(counts_ab["polyphase_resample"] >= 2,
          "resample_ab did not launch the polyphase kernel")
    data = torch.from_numpy((0.3 * np.random.default_rng(0).standard_normal(
        (2, 48_000 * SECONDS))).astype(np.float32)).to(dev)
    x, G, M, W, bank, support = tr.bank_operands(data, 48_000, 44_100)
    resample_bound = resample_work_bound(x, G, M, bank)
    print(f"[18 resample-data] 48->44.1 kHz, {SECONDS} s stereo bound: "
          f"{resample_bound[0]:.4f} ms by {resample_bound[1]}; resample_data "
          f"at {resample_bound[0] / ab[(48_000, 44_100)]['kernel_ms']:.2%} of "
          f"it ({card})")
    kernel_times = time_resampler(
        "18 resample-data", f"48->44.1 kHz, {SECONDS} s stereo, the polyphase "
        f"kernel alone (no pad, no slice)", {
            "kernel": functools.partial(cuda_resample.apply_filter_bank_cuda,
                                        x, G, M, W, support)},
        ("kernel", "kernel"), 10, card, resample_bound)
    del data, x

    pitch = times[stages[0][0]]
    r = ab[(48_000, 44_100)]
    entries = [
        {"name": "wsola_score_table", "route": "cuda",
         "source": "nodey_tpu_torch/csrc/wsola_score_table.cu",
         "replaces": "nodey_tpu/ops/pallas_wsola.py:71",
         "max_abs_err": table_gap,
         "max_abs_err_is": "worst float64 score gap / row max |score| of an "
                           "entry that differs from the plain table",
         "ms": pitch["kernel"], "plain_ms": pitch["plain"],
         "bound_ms": pitch["bound"][0], "bound_by": pitch["bound"][1],
         "library_ms": pitch["library"]},
        {"name": "wsola_table_walk", "route": "cuda",
         "source": "nodey_tpu_torch/csrc/wsola_score_table.cu",
         "replaces": "nodey_tpu/ops/pallas_wsola.py:307",
         "max_abs_err": 0.0,
         "ms": pitch["walk kernel"], "plain_ms": pitch["walk plain"],
         "bound_ms": pitch["walk bound"][0],
         "bound_by": pitch["walk bound"][1], "library_ms": None},
    ]
    for probe, replaces in (
            ("bare", "bench.py:979 and tools/ab_wsola_fps.py:42"),
            ("dma", "bench.py:994 and tools/ab_wsola_fps.py:60")):
        t, tool = probe_times[(probe, True)], probe_times[(probe, False)]
        entries.append({
            "name": f"step_probe_{probe}", "route": "cuda",
            "source": "nodey_tpu_torch/csrc/step_probes.cu",
            "replaces": replaces, "max_abs_err": 0.0,
            "ms": t["kernel"], "plain_ms": t["plain"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": None, "us_per_step": t["us_per_step"],
            "tool_form": {"ms": tool["kernel"], "plain_ms": tool["plain"],
                          "bound_ms": tool["bound"][0],
                          "bound_by": tool["bound"][1]}})
    entries.append({
        "name": "resample_data", "route": "cuda",
        "source": "nodey_tpu_torch/csrc/polyphase_resample.cu",
        "replaces": "nodey_tpu/ops/pallas_resample.py:56",
        "max_abs_err": resample_err,
        "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
        "bound_ms": resample_bound[0], "bound_by": resample_bound[1],
        "library_ms": r["conv1d_ms"],
        "kernel_alone_ms": kernel_times["kernel"]})
    paths = {"ab_wsola_fps": counts_tool, "step_overhead": counts_steps,
             "resample_ab": counts_ab}
    return paths, entries


def check_chunk_calls(tag: str, calls, geo, card: str):
    """Every recorded chunk-chain launch of one WSOLA stage against the plain
    chunk chain on the same (x, head, k0, base, K): splices equal, or a
    float64 near tie on at most TIE_SHARE of the frames; body and tail_out
    within TOL of the plain version given the kernel's own splices. Returns
    (the kernel's splices of all steps in order, worst max|diff|)."""
    import numpy as np
    import torch

    from nodey_tpu_torch.ops import wsola
    from nodey_tpu_torch.ops.wsola import frame_pos

    decisions, worst, differ_total, gap_worst, frames = [], 0.0, 0, 0.0, 0
    stride = geo["seq"] - geo["overlap"]
    for args, (bs, body, tail) in calls:
        x, head, k0, base, K = args[:5]
        pbs, pbody, ptail = wsola.wsola_chunk_chain_plain(*args)
        if torch.equal(bs, pbs):
            err = max((body - pbody).abs().max().item(),
                      (tail - ptail).abs().max().item())
        else:
            bs_host = bs.cpu().numpy()
            replay = wsola.replay_decisions(x, head, bs_host, *args[4:],
                                            k0=k0, base=base)
            differ = np.nonzero(replay.cpu().numpy() != bs_host)[0]
            differ_total += len(differ)
            gap_worst = max([gap_worst] + [
                near_tie(x, head, bs_host, int(k), int(replay[k]), geo,
                         k0=k0, base=base) for k in differ])
            want = wsola.assemble_plain(x, head, bs_host, *args[4:], k0=k0,
                                        base=base)
            last = frame_pos(k0 + K - 1, geo["num"], geo["den"]) - base \
                + int(bs_host[-1]) + stride
            err = max((body - want).abs().max().item(),
                      (tail - x[:, last : last + geo["overlap"]]).abs()
                      .max().item())
        worst = max(worst, err)
        frames += K
        decisions.append(bs)
    print(f"[13 stream-kernel] {tag}: {len(calls)} chunk launches, {frames} "
          f"frames, K {min(c[0][4] for c in calls)}..{max(c[0][4] for c in calls)}"
          f" per launch: {differ_total} frames choose otherwise than the plain "
          f"chunk chain given the kernel's previous choice (max share "
          f"{TIE_SHARE:g}), worst float64 gap {gap_worst:.3e} (max "
          f"{TIE_REL:g}); max|body, tail_out - plain| = {worst:.3e} (tol "
          f"{TOL:.0e}) ({card})")
    check(differ_total <= TIE_SHARE * frames, f"{tag}: {differ_total} frames "
          "differ from the plain chunk chain")
    check(gap_worst <= TIE_REL, f"{tag}: a differing frame is no near tie")
    check(worst <= TOL, f"{tag}: chunk kernel audio disagrees with plain")
    return torch.cat(decisions), worst


@contextlib.contextmanager
def checked_steps(spans):
    """Every chunk step of the streaming runs inside this block runs under
    torch.cuda.set_sync_debug_mode("error"), so a device-to-host sync inside
    a step raises; the executor's h2d, d2h hand-off and egress run outside
    the mode. ``spans`` gets a pair of CUDA events around each step on the
    compute stream (read after the run)."""
    import torch

    from nodey_tpu_torch.core import chunkflow

    compile_stream_graph = chunkflow.compile_stream_graph

    def compile_checked(*args, **kwargs):
        compiled = compile_stream_graph(*args, **kwargs)
        step = compiled.step

        def checked_step(states, step_args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return step(states, step_args)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                end.record()
                spans.append((start, end))

        compiled.step = checked_step
        return compiled

    chunkflow.compile_stream_graph = compile_checked
    try:
        yield
    finally:
        chunkflow.compile_stream_graph = compile_stream_graph


def project_with_tracks(project: str, paths, out: str) -> str:
    """Write to ``out`` a copy of the project whose audio_input reads
    ``paths``; returns ``out``."""
    with open(project) as f:
        data = json.load(f)
    for node in data["nodes"].values():
        if node["identifier"] == "audio_input":
            node["info"]["file_path"] = list(paths)
    with open(out, "w") as f:
        json.dump(data, f)
    return out


def stream_export(cli, project: str, out_wav: str):
    """``run --stream --export`` of ``project`` on the card through the
    port's CLI; returns (exit code, its output, the export's StreamMetrics
    or None)."""
    from nodey_tpu_torch.core.runner import Runner

    captured = []
    export_streamed = Runner.export_streamed

    def capture(self, *args, **kwargs):
        metrics = export_streamed(self, *args, **kwargs)
        captured.append(self.last_stream_metrics)
        return metrics

    stdout = io.StringIO()
    Runner.export_streamed = capture
    try:
        with contextlib.redirect_stdout(stdout):
            rc = cli.main(["run", project, "--stream", "--export", out_wav,
                           "--device", CARD])
    finally:
        Runner.export_streamed = export_streamed
    return rc, stdout.getvalue(), captured[0] if captured else None


def profile_render(render, card: str, tag: str = "8 times",
                   what: str = "config-4", top: int = 6) -> None:
    """One render under torch.profiler: device time by kernel and the
    share of the render's CUDA-event span that no kernel occupied."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    activities = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
                  if a in torch.profiler.supported_activities()]
    with profile(activities=activities) as prof:
        start.record()
        render()
        end.record()
        torch.cuda.synchronize()
    span_ms = start.elapsed_time(end)
    rows = []
    for event in prof.key_averages():
        us = getattr(event, "self_device_time_total",
                     getattr(event, "self_cuda_time_total", 0))
        if us > 0 and getattr(event, "device_type", None) != \
                torch.autograd.DeviceType.CPU:
            rows.append((us / 1e3, event.count, event.key))
    rows.sort(reverse=True)
    busy_ms = sum(ms for ms, _, _ in rows)
    if busy_ms == 0.0:
        print(f"[{tag}] {what} profile: the profiler saw no device time "
              f"(breakdown not measured) ({card})")
        return
    for ms, count, key in rows[:top]:
        print(f"[{tag}] {what} profile: {ms:.4f} ms in {count} launches "
              f"({ms / span_ms:.1%}) {key[:70]} ({card})")
    print(f"[{tag}] {what} profile: kernels {busy_ms:.4f} ms of a "
          f"{span_ms:.4f} ms render; device idle share "
          f"{max(0.0, 1.0 - busy_ms / span_ms):.2%} ({card})")


def pass_ms(fn, iters: int) -> dict:
    """Device ms per call of each phase-path pass (its kernel's name holds
    pv_phase_<pass>), from torch.profiler over ``iters`` calls of ``fn``;
    {} if the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for event in prof.key_averages():
        us = getattr(event, "self_device_time_total",
                     getattr(event, "self_cuda_time_total", 0))
        for name in PV_PASSES:
            if f"pv_phase_{name}" in event.key and us > 0:
                out[name] = out.get(name, 0.0) + us / 1e3 / iters
    return out


@contextlib.contextmanager
def recorded_pv_steps(steps):
    """Every streaming PV step run inside this block appends (its plan,
    its frames: the next frame's index minus the one it started from) to
    ``steps``."""
    from nodey_tpu_torch.ops import pv

    step = pv.pv_stream_step

    def recording(plan, state, *args):
        out = step(plan, state, *args)
        steps.append((plan, out[0].k - state.k))
        return out

    pv.pv_stream_step = recording
    try:
        yield
    finally:
        pv.pv_stream_step = step


def streamed_master(graph, device: str, chunk_seconds: float):
    """The export master of ``graph`` through the streaming executor on
    ``device`` (float32 wire), [C, n] on the host."""
    import numpy as np

    from nodey_tpu_torch.core.stream_executor import StreamExecutor

    blocks = []
    StreamExecutor(graph, mode="export", chunk_seconds=chunk_seconds,
                   device=device).run(sink=lambda b: blocks.append(np.array(b)))
    return np.concatenate(blocks, axis=1)


def snr_by_window(reference, test, seconds: int = 30, rate: int = 48_000):
    """The SNR of each ``seconds`` of two [C, n] masters (config 4's
    output is 48 kHz)."""
    window = seconds * rate
    return [snr_db(reference[:, i : i + window], test[:, i : i + window])
            for i in range(0, reference.shape[1], window)]


def lock_work_bound(shape):
    """The lock's bound on [C, K, B] planes: four read and two written once;
    ~15 operations per element, each transcendental counted as one."""
    n = math.prod(shape)
    return bound(4 * 6 * n, 15 * n)


def stream_pv_phase(cli, card: str, dev, tmp: str, track1, track_path: str,
                    excerpt4: str, short_track: str):
    """Phase 19 (see the module docstring). ``track1``: phase 6's 300 s
    track [2, n] float32 on the host; ``track_path``: the config-4 track
    whose offline PV renders phases 10 and 11 exported
    (``config4_pv*.json`` and ``.wav`` in ``tmp``); ``excerpt4``: its 10 s
    excerpt; ``short_track``: a 100 s track. Returns (launch counts by path,
    the lock's figures at both chunk shapes, its worst max|kernel - plain|
    in the steps)."""
    import numpy as np
    import torch

    from nodey_tpu_torch.core import chunkflow
    from nodey_tpu_torch.core.compiler import SourceSpec
    from nodey_tpu_torch.core.runner import Runner
    from nodey_tpu_torch.host.decode import decode_file
    from nodey_tpu_torch.ops import cuda_pv, pv
    from nodey_tpu_torch.ops import resample as tr
    from nodey_tpu_torch.tools.pv_phase_ab import chunk_frames

    tag = "19 stream-pv"
    chunk = STREAM_CHUNK_SECONDS * RATE
    kernel_lock, kernel_resampler = pv.lock_phases, tr.apply_filter_bank
    lock_checks, lock_in, seen, resample_errs = [], {}, {}, []

    def checked_lock(cos_phi, sin_phi, ph, mag):
        """The lock kernel, held against the plain lock on its inputs."""
        got = kernel_lock(cos_phi, sin_phi, ph, mag)
        lock_checks.append(lock_against_plain(got, (cos_phi, sin_phi, ph,
                                                    mag)))
        check(bool(torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()),
              f"{tag}: the lock kernel gave a value that is not finite")
        K = mag.shape[1]
        seen[K] = seen.get(K, 0) + 1
        if seen[K] == STREAM_LOCK_TIMED_STEP:
            lock_in[K] = tuple(t.clone() for t in (cos_phi, sin_phi, ph, mag))
        return got

    def checked_resampler(x, G, M, W, bank, support):
        """The resampler kernel, held against the plain resampler on its
        operands."""
        got = kernel_resampler(x, G, M, W, bank, support)
        want = tr.apply_filter_bank_plain(x, G, M, W, bank)
        resample_errs.append((list(x.shape), M, bank.shape[0],
                              (got - want).abs().max().item()))
        check(bool(torch.isfinite(got).all()),
              f"{tag}: the resampler kernel gave a value that is not finite")
        return got

    def drive(lock, resampler=None):
        """Config 4 on the PV streamed at 16 s chunks on track1, the graph's
        chunk steps driven by hand with ``lock`` (and ``resampler``) in
        place of the dispatchers; returns (master on the host, steps, the
        PV stage steps that had frames)."""
        graph = config4_graph(track_path, algorithm="pv")
        compiled = chunkflow.compile_stream_graph(
            graph, {(0, "output_0"): SourceSpec(
                rate=RATE, channels=2, fmt="flt", capacity=chunk)},
            device=CARD)
        saved = pv.lock_phases, tr.apply_filter_bank
        pv.lock_phases, tr.apply_filter_bank = lock, resampler or saved[1]
        parts, pos, steps, pv_steps = [], 0, 0, []
        try:
            with recorded_pv_steps(pv_steps):
                states = compiled.init_states
                while True:
                    n = max(0, min(chunk, track1.shape[1] - pos))
                    block = torch.zeros((2, chunk), device=dev)
                    block[:, :n] = torch.from_numpy(
                        track1[:, pos : pos + n]).to(dev)
                    pos += chunk
                    states, outs = compiled.step(states, {"n0:output_0": (
                        block, n, pos >= track1.shape[1])})
                    steps += 1
                    data, n_out, finished = outs["master"]
                    parts.append(data[:, :n_out].clone())
                    if finished:
                        break
        finally:
            pv.lock_phases, tr.apply_filter_bank = saved
        check(len(pv_steps) == 2 * steps, f"{tag}: {len(pv_steps)} PV stage "
              f"steps in {steps} graph steps")
        with_frames = [(plan.k_cap, frames) for plan, frames in pv_steps
                       if frames]
        return torch.cat(parts, dim=1).cpu().numpy(), steps, with_frames

    # Every launch of both kernels inside the steps is held against its
    # plain version on its own operands. The master bar swaps the lock
    # only, as phase 10 swaps only the phase path: with the plain resampler
    # as well, the first PV stage reads inputs that differ by ulps, and the
    # PV turns on the last bits of its analysis (a wrap decided otherwise
    # rotates a bin for the rest of the clip), so for the resampler the
    # per-launch check is the bar.
    zero_counts()
    kernels, steps, with_frames = drive(checked_lock, checked_resampler)
    hand = read_counts()
    plain_lock, _, _ = drive(pv._lock_to_peaks)
    check(kernels.shape == plain_lock.shape,
          f"{tag}: masters {kernels.shape}, {plain_lock.shape}")
    lock_err = max(err for err, _, _ in lock_checks)
    lock_bitwise = sum(differ == 0 for _, differ, _ in lock_checks)
    lock_finite = sum(finite for *_, finite in lock_checks)
    resample_err = max(err for *_, err in resample_errs)
    lock_db = snr_db(plain_lock, kernels)
    master_differ = int(np.count_nonzero(kernels != plain_lock))
    print(f"[{tag}] config 4 on the PV, {SECONDS} s at {STREAM_CHUNK_SECONDS} s "
          f"chunks, driven by hand: {steps} steps, {len(with_frames)} PV stage "
          f"steps with frames (k_cap {sorted(set(k for k, _ in with_frames))},"
          f" frames {min(f for _, f in with_frames)}.."
          f"{max(f for _, f in with_frames)} a step), {hand['pv_lock']} lock "
          f"launches at K {sorted(seen)}; every "
          f"launch against the plain lock on its inputs: max|kernel - plain| "
          f"{lock_err:.3e} (tol {TOL:.0e}), {lock_bitwise} of "
          f"{len(lock_checks)} launches bitwise ({lock_finite} on finite "
          f"inputs); {hand['polyphase_resample']} "
          f"resampler launches (x, M, L: "
          f"{sorted(set((tuple(x), M, L) for x, M, L, _ in resample_errs))}), "
          f"every one against the plain resampler on its operands: "
          f"max|kernel - plain| {resample_err:.3e} (tol {TOL:.0e}); master "
          f"{list(kernels.shape)} through the kernels vs the same steps with "
          f"the plain lock: SNR {lock_db:.1f} dB (min {PV_EXCERPT_DB:.0f}), "
          f"{master_differ} of {kernels.size} samples not bitwise it "
          f"({card})")
    check(hand["pv_lock"] == len(lock_checks) == len(with_frames) > 0,
          f"{tag}: {hand['pv_lock']} lock launches, {len(with_frames)} stage "
          "steps with frames")
    check(hand["polyphase_resample"] == len(resample_errs) >= steps,
          f"{tag}: {hand['polyphase_resample']} resampler launches, "
          f"{len(resample_errs)} checked, in {steps} steps")
    check(hand["pv_phase_path"] == 0,
          f"{tag}: the phase-path kernel launched in a hand-driven step")
    plans = sorted(set(k for k, _ in with_frames))
    shapes = sorted(chunk_frames(STREAM_CHUNK_SECONDS, RATE).values())
    check(sorted(seen) == plans == shapes, f"{tag}: the lock saw K "
          f"{sorted(seen)}, the plans' k_cap {plans}, phase 9's chunk shapes "
          f"{shapes}")
    check(lock_err <= TOL, f"{tag}: the lock kernel disagrees inside a step")
    check(all(differ == 0 for _, differ, finite in lock_checks if finite),
          f"{tag}: the lock kernel is not bitwise the plain lock inside a "
          "step")
    check(resample_err <= TOL,
          f"{tag}: the resampler kernel disagrees inside a step")
    check(lock_db >= PV_EXCERPT_DB,
          f"{tag}: the streamed PV through the lock kernel disagrees with the "
          f"plain lock")
    check(master_differ == 0 or lock_finite < len(lock_checks),
          f"{tag}: the streamed PV through the lock kernel is not bitwise the "
          "plain lock's")
    check(bool(np.isfinite(kernels).all()), f"{tag}: master not finite")
    del kernels, plain_lock

    # `run --stream --export`, every step under the sync debug mode, plain
    # and with both options; the PV's lock runs once in every stage step
    # that has frames.
    offline = {}
    streamed = {}
    for name, suffix in (("plain", ""), ("options", "_options")):
        proj = os.path.join(tmp, f"config4_pv{suffix}.json")
        out_wav = os.path.join(tmp, f"config4_pv{suffix}_streamed.wav")
        spans, pv_steps = [], []
        zero_counts()
        with checked_steps(spans), recorded_pv_steps(pv_steps):
            rc, text, metrics = stream_export(cli, proj, out_wav)
        counts = read_counts()
        print("\n".join(f"[{tag}] {name} cli: {line}"
                        for line in text.splitlines()))
        check(rc == 0 and metrics is not None,
              f"{tag}: {name}: run --stream exited {rc} or did not stream")
        got = decode_file(out_wav).data
        with_frames = sum(frames > 0 for _, frames in pv_steps)
        print(f"[{tag}] {name}: streamed master {list(got.shape)}, finite "
              f"{bool(np.isfinite(got).all())}; {metrics.steps} steps under "
              f"sync debug mode 'error' ({len(spans)} checked), {len(pv_steps)} "
              f"PV stage steps of which {with_frames} with frames; launches "
              f"{counts} ({card})")
        check(got.shape == (2, CONFIG4_LENGTH),
              f"{tag}: {name}: master {got.shape}, want (2, {CONFIG4_LENGTH})")
        check(bool(np.isfinite(got).all()), f"{tag}: {name}: master not finite")
        check(len(spans) == metrics.steps >= 4 and len(pv_steps) == 2 * len(spans),
              f"{tag}: {name}: {len(spans)} checked steps of {metrics.steps}")
        check(counts["pv_lock"] == with_frames > 0,
              f"{tag}: {name}: {counts['pv_lock']} lock launches, "
              f"{with_frames} stage steps with frames")
        check(counts["pv_phase_path"] == 0,
              f"{tag}: {name}: the phase-path kernel launched")
        offline[name] = decode_file(os.path.join(tmp, f"config4_pv{suffix}.wav")).data
        streamed[name] = dict(counts=counts, device_ms=sum(
            a.elapsed_time(b) for a, b in spans), master=got)
    full_db = {name: snr_db(offline[name], streamed[name]["master"])
               for name in offline}
    # Where the 300 s export departs from the offline render: the SNR of
    # each 30 s of output (a wrap decided otherwise shows as a step).
    got, want = streamed["plain"]["master"], offline["plain"]
    by_window = snr_by_window(want, got)
    for record in streamed.values():
        del record["master"]
    del offline, got, want

    # Streamed against offline: the 10 s excerpt on the card and on the CPU
    # (at 2 s chunks, so the carries cross chunks), and the 300 s exports.
    excerpt_db = {}
    for device in (CARD, "cpu"):
        graph = config4_graph(excerpt4, algorithm="pv")
        want = Runner(graph, device=device).render("export").master
        got = streamed_master(config4_graph(excerpt4, algorithm="pv"), device,
                              STREAM_EXCERPT_CHUNK_SECONDS)
        check(got.shape == want.shape,
              f"{tag}: {device}: excerpt streamed {got.shape}, offline "
              f"{want.shape}")
        excerpt_db[device] = snr_db(want, got)
    print(f"[{tag}] streamed vs offline: {EXCERPT_SECONDS} s excerpt at "
          f"{STREAM_EXCERPT_CHUNK_SECONDS} s chunks on the card SNR "
          f"{excerpt_db[CARD]:.1f} dB (min {PV_DEVICE_DB:.0f}), on the CPU "
          f"{excerpt_db['cpu']:.1f} dB; {SECONDS} s exports at "
          f"{STREAM_CHUNK_SECONDS} s chunks on the card: {full_db['plain']:.1f} "
          f"dB, with both options {full_db['options']:.1f} dB; the plain "
          f"export by 30 s of output: "
          f"{', '.join(f'{db:.1f}' for db in by_window)} dB ({card})")
    check(excerpt_db[CARD] >= PV_DEVICE_DB,
          f"{tag}: the streamed PV excerpt disagrees with the offline render")

    # A witness at length for the 300 s figure's fall: the same clip where
    # only ulps differ and no chunk carry runs (offline on the card against
    # offline on the CPU), and where the same plain math runs chunked and
    # whole (streamed against offline on the CPU), by 30 s of output.
    cpu_offline = Runner(config4_graph(track_path, algorithm="pv"),
                         device="cpu").render("export").master
    card_offline = Runner(config4_graph(track_path, algorithm="pv"),
                          device=CARD).render("export").master
    cpu_streamed = streamed_master(config4_graph(track_path, algorithm="pv"),
                                   "cpu", STREAM_CHUNK_SECONDS)
    check(cpu_offline.shape == card_offline.shape == cpu_streamed.shape,
          f"{tag}: {SECONDS} s masters {cpu_offline.shape}, "
          f"{card_offline.shape}, {cpu_streamed.shape}")
    witness = {
        "card offline vs CPU offline": (cpu_offline, card_offline),
        "CPU streamed vs CPU offline": (cpu_offline, cpu_streamed),
    }
    for name, (want, got) in witness.items():
        print(f"[{tag}] witness, {SECONDS} s, {name}: SNR "
              f"{snr_db(want, got):.1f} dB; by 30 s of output: "
              f"{', '.join(f'{db:.1f}' for db in snr_by_window(want, got))} "
              f"dB ({card})")
    del cpu_offline, card_offline, cpu_streamed, witness

    # Device memory over a whole export at 100 s and at 300 s (after the
    # exports above, so the one-time bases are in place), and the offline
    # render's.
    proj = os.path.join(tmp, "config4_pv.json")
    short_proj = project_with_tracks(
        proj, [short_track], os.path.join(tmp, f"config4_pv_{SHORT_SECONDS}s.json"))
    out_wav = os.path.join(tmp, "config4_pv_memory.wav")
    peaks = {}
    for seconds, project in ((SHORT_SECONDS, short_proj), (SECONDS, proj)):
        result = []
        peaks[seconds] = device_peak(lambda: result.append(
            stream_export(cli, project, out_wav)))
        check(result[0][0] == 0 and result[0][2] is not None,
              f"{tag}: the {seconds} s streamed export failed")
    offline_peak = device_peak(lambda: Runner(
        cli._load_graph(proj), device=CARD).render("export"))
    print(f"[{tag}] peak device memory of a whole streamed export "
          f"{peaks[SHORT_SECONDS] / 2**20:.1f} MiB at {SHORT_SECONDS} s, "
          f"{peaks[SECONDS] / 2**20:.1f} MiB at {SECONDS} s (max "
          f"+{STREAM_SLACK_BYTES / 2**20:.0f} MiB); offline PV render "
          f"{offline_peak / 2**20:.1f} MiB ({card})")
    check(peaks[SECONDS] <= peaks[SHORT_SECONDS] + STREAM_SLACK_BYTES,
          f"{tag}: streamed device memory grows with clip length")
    check(peaks[SECONDS] < offline_peak,
          f"{tag}: streaming took more memory than the offline render")

    # Times: the lock per launch at both chunk shapes (a mid-clip step's
    # inputs), and the export's wall RTF.
    lock_times = {}
    for K, planes in sorted(lock_in.items(), reverse=True):
        fns = {"kernel": lambda: cuda_pv.lock_to_peaks_cuda(*planes),
               "plain": lambda: pv._lock_to_peaks(*planes)}
        runs = {name: [] for name in fns}
        for name in ("plain", "kernel", "kernel", "plain"):
            runs[name] += cuda_ms(fns[name], LOCK_TIMED_LAUNCHES // 2,
                                  warmup=1, queued=True)
        lock_times[K] = {name: summary(runs[name])[0] for name in fns}
        lock_times[K]["bound"] = lock_work_bound(planes[3].shape)
        lock_times[K]["shape"] = list(planes[3].shape)
        for name in fns:
            med, lo, hi, count = summary(runs[name])
            print(f"[{tag}] times: lock at {list(planes[3].shape)}, {name}: "
                  f"median {med:.4f} ms per launch (min {lo:.4f}, max {hi:.4f}, "
                  f"n={count}) ({card})")
        ms, by = lock_times[K]["bound"]
        print(f"[{tag}] times: lock bound at {list(planes[3].shape)}: {ms:.4f} "
              f"ms by {by}; kernel at {ms / lock_times[K]['kernel']:.2%} of it "
              f"({card})")
    runs = []
    for _ in range(STREAM_TIMED_RUNS):
        rc, _text, m = stream_export(cli, proj, out_wav)
        check(rc == 0 and m is not None, f"{tag}: a timed streamed export failed")
        runs.append(m)
    runs.sort(key=lambda r: r.rtf)
    m = runs[len(runs) // 2]
    print(f"[{tag}] times: config 4 on the PV streamed ({SECONDS} s, "
          f"{STREAM_CHUNK_SECONDS} s chunks, WAV sink, nothing instrumented): "
          f"wall RTF median {m.rtf:.1f} (min {runs[0].rtf:.1f}, max "
          f"{runs[-1].rtf:.1f}, n={len(runs)}); the median export: "
          f"{m.audio_seconds:.3f} audio-s in {m.wall_seconds:.4f} s wall, "
          f"{m.steps} steps, plan {m.compile_seconds:.4f} s, decode wait "
          f"{m.decode_wait_seconds:.4f} s, egress wait "
          f"{m.egress_wait_seconds:.4f} s, d2h busy {m.d2h_busy_seconds:.4f} "
          f"s, sink busy {m.sink_busy_seconds:.4f} s; the steps' device span "
          f"(CUDA events around each step of the checked export) "
          f"{streamed['plain']['device_ms']:.4f} ms, with both options "
          f"{streamed['options']['device_ms']:.4f} ms ({card})")
    paths = {"config4_pv_streamed": streamed["plain"]["counts"],
             "config4_pv_options_streamed": streamed["options"]["counts"]}
    return paths, lock_times, lock_err


def realtime_and_chunked_phases(cli, card: str, tmp: str, proj_5node: str,
                                excerpt_tracks):
    """Phases 20 and 21 (see the module docstring). ``proj_5node``: phase
    4's 300 s project; ``excerpt_tracks``: its 10 s tracks. Returns the
    launch counts of both paths, by path."""
    import numpy as np

    from nodey_tpu_torch.core.runner import Runner
    from nodey_tpu_torch.core.streaming import StreamingSession, render_chunked
    from nodey_tpu_torch.host import playback
    from nodey_tpu_torch.host.decode import decode_file

    # -- 20. realtime ------------------------------------------------------------
    tag = "20 realtime"
    proj = project_with_tracks(proj_5node, excerpt_tracks,
                               os.path.join(tmp, "two_track_mix_10s.json"))
    out_wav = os.path.join(tmp, "realtime.wav")
    stdout = io.StringIO()
    zero_counts()
    with contextlib.redirect_stdout(stdout):
        rc = cli.main(["run", proj, "--realtime", "--preview", out_wav,
                       "--device", CARD])
    counts_rt = read_counts()
    text = stdout.getvalue()
    print("\n".join(f"[{tag}] cli: {line}" for line in text.splitlines()))
    check(rc == 0, f"{tag}: run --realtime exited {rc}")
    words = text.split()
    audio_s, wall = float(words[1]), float(words[4])
    sdl = playback.device_available()
    print(f"[{tag}] {audio_s:.2f} audio-s in {wall:.2f} s wall "
          f"({wall / audio_s:.4f}x the audio, min 0.98); SDL device "
          f"{'present' if sdl else 'absent: paced by the wall clock'}; "
          f"launches {counts_rt} ({card})")
    check(wall >= 0.98 * audio_s, f"{tag}: the realtime preview ran ahead")
    check(counts_rt["polyphase_resample"] >= 1,
          f"{tag}: the resampler did not run")
    reference = Runner(cli._load_graph(proj), device=CARD).preview().master
    check(decode_file(out_wav).data.shape == reference.shape,
          f"{tag}: the preview WAV's shape")
    got = {}
    for streamed in (True, False):
        session = StreamingSession(cli._load_graph(proj), device=CARD).start(
            streamed=streamed)
        blocks = list(session.blocks())
        session.stop()
        got[streamed] = (np.concatenate(blocks, axis=1), session.stats)
    streamed_db = snr_db(reference, got[True][0])
    whole_same = np.array_equal(reference, got[False][0])
    print(f"[{tag}] sessions vs Runner.preview() {list(reference.shape)}: "
          f"streamed {list(got[True][0].shape)} SNR {streamed_db:.1f} dB (min "
          f"120), first block after {got[True][1].first_block_seconds:.4f} s, "
          f"{got[True][1].underruns} underruns; whole-clip "
          f"{'bitwise equal' if whole_same else 'DIFFERS'}, first block after "
          f"{got[False][1].first_block_seconds:.4f} s ({card})")
    check(got[True][0].shape == reference.shape and streamed_db >= 120.0,
          f"{tag}: the streamed session disagrees with the preview render")
    check(whole_same, f"{tag}: the whole-clip session is not the preview")
    del reference, got

    # -- 21. chunked ------------------------------------------------------------
    tag = "21 chunked"
    graph = cli._load_graph(proj_5node)
    whole = Runner(graph, device=CARD).render("export")
    progress = []
    result = []
    zero_counts()
    chunked_peak = device_peak(lambda: result.append(render_chunked(
        graph, progress=progress.append, device=CARD)))
    counts_chunked = read_counts()
    master, rate, _fmt, spectra = result[0]
    offline_peak = device_peak(lambda: Runner(graph, device=CARD).render(
        "export"))
    db = snr_db(whole.master, master)
    [key] = whole.spectra
    frames = (master.shape[1] - 1024) // 512 + 1
    spec = spectra.get(key)
    spec_db = (snr_db(whole.spectra[key][:, :frames], spec)
               if spec is not None and spec.shape[1] == frames else -math.inf)
    print(f"[{tag}] render_chunked, {SECONDS} s 5-node graph, {len(progress)} "
          f"chunks of 30 s: master {list(master.shape)} at {rate} Hz vs the offline "
          f"render {list(whole.master.shape)}: SNR {db:.1f} dB (min 130); "
          f"spectrum {list(spec.shape) if spec is not None else None}, "
          f"{frames} frames in the clip, SNR {spec_db:.1f} dB against the "
          f"offline spectrum's first {frames} frames of "
          f"{whole.spectra[key].shape[1]}; resampler launches "
          f"{counts_chunked['polyphase_resample']} "
          f"({counts_chunked['polyphase_resample'] / len(progress):g} per "
          f"chunk); peak device memory {chunked_peak / 2**20:.1f} MiB, "
          f"offline render {offline_peak / 2**20:.1f} MiB ({card})")
    check(master.shape == whole.master.shape and db >= 130.0,
          f"{tag}: the chunked master disagrees with the offline render")
    check(spec is not None and spec.shape[1] == frames and spec_db >= SNR_DB,
          f"{tag}: the chunked spectrum disagrees with the offline render")
    check(counts_chunked["polyphase_resample"] >= 2 * len(progress),
          f"{tag}: resampler launched {counts_chunked['polyphase_resample']}")
    check(chunked_peak < offline_peak,
          f"{tag}: chunked rendering took more memory than the offline one")
    return {"realtime": counts_rt, "5node_chunked": counts_chunked}


def main() -> int:
    sys.path.insert(0, ROOT)
    try:
        import nodey_tpu_torch  # noqa: F401  (sets the TF32 flags)
        from nodey_tpu_torch.app import cli
        from nodey_tpu_torch.core import chunkflow
        from nodey_tpu_torch.core.compiler import SourceSpec
        from nodey_tpu_torch.core.runner import Runner
        from nodey_tpu_torch.core.stream import Stream
        from nodey_tpu_torch.host.decode import decode_file
        from nodey_tpu_torch.ops import _build, cuda_pv, cuda_resample, cuda_wsola
        from nodey_tpu_torch.ops import pv, stretch, wsola
        from nodey_tpu_torch.ops import resample as tr
    except ImportError as exc:
        fail(f"the nodey_tpu_torch package is not beside this script ({exc})")
    import numpy as np
    import torch
    import torch.nn.functional as F

    # -- 1. device -------------------------------------------------------------
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    dev = torch.device(CARD)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"[1 device] {card}")
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    check(clocks.returncode == 0, f"nvidia-smi failed: {clocks.stderr.strip()}")
    sm_clock_mhz = float(clocks.stdout.strip().splitlines()[0])
    print(f"[1 device] max SM clock {sm_clock_mhz:.0f} MHz")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    # -- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    print(f"[2 build] {len(_build.kernel_names())} libraries ready in "
          f"{time.perf_counter() - t0:.2f} s (one nvcc per source, in parallel)"
          f" ({card})")
    for name in _build.kernel_names():
        _build.load_library(name)
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[2 build] {name}: ptxas: {line.strip()}")

    # -- 3. kernel against its plain version -----------------------------------
    rng = np.random.default_rng(1)
    resample_err = {}
    for in_rate, out_rate, n in KERNEL_PAIRS:
        data = torch.from_numpy(
            (0.5 * rng.standard_normal((2, n))).astype(np.float32)
        ).to(dev)
        x, G, M, W, bank, support = tr.bank_operands(data, in_rate, out_rate)
        got = cuda_resample.apply_filter_bank_cuda(x, G, M, W, support)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        want = tr.apply_filter_bank_plain(x, G, M, W, bank)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        err = (got - want).abs().max().item()
        print(f"[3 kernel] {in_rate}->{out_rate} Hz, bank {list(bank.shape)}, "
              f"support {list(support.compact.shape)}, rows of "
              f"{support.row_used}, x {list(x.shape)}, G={G}, group tile "
              f"ragged={G % 128 != 0}: max|kernel - plain| = {err:.3e} (tol "
              f"{TOL:.0e}); plain version's peak {peak:.1f} MiB above its "
              f"inputs ({card})")
        check(err <= TOL, f"kernel disagrees with plain at {in_rate}->{out_rate}")
        resample_err[(in_rate, out_rate)] = err
        del data, x, got, want
    kernel_err = max(resample_err[p[:2]] for p in KERNEL_PAIRS[:2])

    with tempfile.TemporaryDirectory(prefix="nodey_chip_smoke_") as tmp:
        # -- 4. slice ----------------------------------------------------------
        signals = make_signals(SECONDS)
        n = signals[0].shape[1]
        paths = write_tracks(tmp, signals, f"{SECONDS}s")
        with open(os.path.join(ROOT, "examples/projects/two_track_mix.json")) as f:
            project = json.load(f)
        project["nodes"]["0"]["info"]["file_path"] = paths
        proj = os.path.join(tmp, "two_track_mix.json")
        with open(proj, "w") as f:
            json.dump(project, f)
        out_wav = os.path.join(tmp, "master.wav")
        proj_5node, wav_5node, paths_5node = proj, out_wav, paths

        zero_counts()
        stdout = io.StringIO()
        with contextlib.redirect_stdout(stdout):
            rc = cli.main(["run", proj, "--export", out_wav, "--device", CARD])
        counts_5node = read_counts()
        launches_5node = counts_5node["polyphase_resample"]
        print("\n".join(f"[4 slice] cli: {line}"
                        for line in stdout.getvalue().splitlines()))
        check(rc == 0, f"cli run exited {rc}")
        master = decode_file(out_wav).data
        n_out = -(-n * 160 // 147)
        check(master.shape == (2, n_out),
              f"exported master {master.shape}, want (2, {n_out})")
        check(bool(np.isfinite(master).all()), "exported master not finite")
        cap_out = -(-MAIN_CAPACITY * 160 // 147)
        frames = (cap_out - 1024) // 512 + 1
        want_line = f"spectrum 'spectrum_4': shape [2, {frames}, 513]"
        check(want_line in stdout.getvalue(), f"missing '{want_line}'")
        print(f"[4 slice] {SECONDS} s export: master {list(master.shape)} finite, "
              f"spectrum [2, {frames}, 513], kernel launches {launches_5node} "
              f"({card})")
        check(launches_5node >= 2,
              f"resample kernel launched {launches_5node} times, want >= 2")

        excerpt = write_tracks(
            tmp, [s[:, : RATE * EXCERPT_SECONDS] for s in signals],
            f"{EXCERPT_SECONDS}s",
        )
        on_card = Runner(flagship_graph(excerpt), device=CARD).render("export")
        on_cpu = Runner(flagship_graph(excerpt), device="cpu").render("export")
        check(on_card.master.shape == on_cpu.master.shape,
              f"master {on_card.master.shape} vs {on_cpu.master.shape}")
        err = float(np.abs(on_card.master - on_cpu.master).max())
        [key] = on_card.spectra
        snr = snr_db(on_cpu.spectra[key], on_card.spectra[key])
        print(f"[4 slice] {EXCERPT_SECONDS} s excerpt, gain 1.5, amix 0.6/0.4: "
              f"max|card - cpu| master = {err:.3e} (tol {TOL:.0e}), "
              f"spectrum SNR {snr:.1f} dB (min {SNR_DB:.0f}) ({card})")
        check(err <= TOL, "card master disagrees with the CPU plain path")
        check(snr >= SNR_DB, "card spectrum disagrees with the CPU plain path")

        # -- 5. times ----------------------------------------------------------
        data = torch.from_numpy(
            (0.5 * rng.standard_normal((2, MAIN_CAPACITY))).astype(np.float32)
        ).to(dev)
        x, G, M, W, bank, support = tr.bank_operands(data, *KERNEL_PAIRS[0][:2])
        resample_bound = resample_work_bound(x, G, M, bank)
        fns = {
            "kernel": functools.partial(cuda_resample.apply_filter_bank_cuda,
                                        x, G, M, W, support),
            "plain": functools.partial(tr.apply_filter_bank_plain, x, G, M, W,
                                       bank),
        }
        resample_times = {"44.1->48": time_resampler(
            "5 times", f"44.1->48 kHz, one {SECONDS} s stereo track",
            fns, ("plain", "kernel", "kernel", "plain"), 10, card,
            resample_bound)}
        kernel_ms = resample_times["44.1->48"]["kernel"]
        plain_ms = resample_times["44.1->48"]["plain"]
        del data, x, fns

        runner = Runner(flagship_graph(paths), device=CARD)
        arrays, lengths, sources = runner.decode()
        compiled = runner.compile(sources, "export")
        args = runner.ingest(arrays, lengths)
        outputs, meta = compiled(args)
        audio_s = outputs["master"][1] / meta["master"]["rate"]
        med, lo, hi, count = summary(cuda_ms(lambda: compiled(args), 10))
        print(f"[5 times] 5-node graph, {audio_s:.3f} audio-s: device render "
              f"median {med:.4f} ms (min {lo:.4f}, max {hi:.4f}, n={count}), "
              f"RTF {audio_s / (med / 1e3):.1f} audio-s per device-s "
              f"({card})")
        del runner, arrays, compiled, args, outputs, paths

        # -- 6. wsola ----------------------------------------------------------
        for rate, tempo in GOLDEN_CASES:
            sig = torch.from_numpy(golden_signal(rate)).to(dev)
            x, head, geo = wsola_operands(sig, tempo, rate)
            bs, body = cuda_wsola.wsola_chain_cuda(x, head, *chain_args(geo))
            pbs, pbody = wsola.wsola_chain_plain(x, head, *chain_args(geo))
            torch.cuda.synchronize()
            same = torch.equal(bs, pbs)
            err = (body - pbody).abs().max().item()
            print(f"[6 wsola] golden signal {rate} Hz, tempo {tempo}: K="
                  f"{geo['K']}, offsets {'bitwise equal' if same else 'DIFFER'}"
                  f", max|body - plain| = {err:.3e} ({card})")
            check(same, f"WSOLA offsets differ on the golden {rate}_{tempo}")
            check(err <= TOL, f"WSOLA audio differs on the golden {rate}_{tempo}")

        # Config 4's two chains at full width, on the main path's own data:
        # track 1 at 48 kHz, then the pitch stage's transposed output.
        track = torch.zeros((2, MAIN_CAPACITY), device=dev)
        track[:, :n] = torch.from_numpy(signals[0]).to(dev)
        track1 = signals[0]
        del signals
        s48 = tr.resample_stream(Stream(data=track, length=n, rate=RATE,
                                        channels=2), 48_000)
        del track
        pitch = 2.0 ** (PITCH / 12.0)
        x1, head1, geo1 = wsola_operands(s48.data, 1.0 / pitch, 48_000)
        bs1, body1, err1 = check_chain(
            f"pitch +{PITCH:g} stage, tempo {1.0 / pitch:.5f}", x1, head1, geo1,
            card)
        out1 = torch.cat([head1, body1], dim=1)
        len1 = min(stretch._scale_length_exact(s48.length, 1.0 / pitch),
                   out1.shape[1])
        out1[:, len1:] = 0.0
        s2, len2 = stretch.transpose_rate(out1, len1, pitch)
        del s48, out1
        x2, head2, geo2 = wsola_operands(s2, VELOCITY, 48_000)
        bs2, body2, err2 = check_chain(f"velocity {VELOCITY:g} stage, tempo "
                                 f"{VELOCITY:g}", x2, head2, geo2, card)
        check((geo1["K"], geo2["K"]) == CONFIG4_FRAMES,
              f"frames {(geo1['K'], geo2['K'])}, want {CONFIG4_FRAMES}")
        wsola_err = max(err1, err2)
        energy_err = [check_energy(f"{tag} stage", x, geo, card)
                      for tag, x, geo in (("pitch", x1, geo1),
                                          ("velocity", x2, geo2))]
        del s2

        # -- 7. config4 --------------------------------------------------------
        [track_path] = write_tracks(tmp, [make_signals(SECONDS, seed=4)[0]],
                                    f"{SECONDS}s_config4")
        proj = os.path.join(tmp, "config4.json")
        with open(proj, "w") as f:
            json.dump(config4_graph(track_path).serialize(), f)
        out_wav = os.path.join(tmp, "config4.wav")
        proj_c4, wav_c4 = proj, out_wav
        zero_counts()
        stdout = io.StringIO()
        with contextlib.redirect_stdout(stdout):
            rc = cli.main(["run", proj, "--export", out_wav, "--device", CARD])
        counts_config4 = read_counts()
        config4_resample = counts_config4["polyphase_resample"]
        config4_wsola = counts_config4["wsola_chain"]
        print("\n".join(f"[7 config4] cli: {line}"
                        for line in stdout.getvalue().splitlines()))
        check(rc == 0, f"cli run exited {rc}")
        master = decode_file(out_wav).data
        print(f"[7 config4] {SECONDS} s export: master {list(master.shape)}, "
              f"finite {bool(np.isfinite(master).all())}; launches: wsola_chain "
              f"{config4_wsola}, polyphase_resample {config4_resample} ({card})")
        check(master.shape == (2, CONFIG4_LENGTH),
              f"config-4 master {master.shape}, want (2, {CONFIG4_LENGTH})")
        check(bool(np.isfinite(master).all()), "config-4 master not finite")
        check(config4_wsola >= 2, f"WSOLA kernel launched {config4_wsola} times")
        check(counts_config4["wsola_energy"] == config4_wsola,
              f"WSOLA energy prologue launched {counts_config4['wsola_energy']}"
              f" times beside {config4_wsola} chain launches")
        check(config4_resample >= 2,
              f"resample kernel launched {config4_resample} times")
        del master

        [excerpt4] = write_tracks(
            tmp, [make_signals(EXCERPT_SECONDS, seed=4)[0]],
            f"{EXCERPT_SECONDS}s_config4")
        decisions = []
        chain = wsola.wsola_chain

        def recording_chain(*a):
            bs, body = chain(*a)
            decisions.append(bs.cpu())
            return bs, body

        wsola.wsola_chain = recording_chain
        try:
            on_card = Runner(config4_graph(excerpt4), device=CARD).render("export")
            on_cpu = Runner(config4_graph(excerpt4), device="cpu").render("export")
        finally:
            wsola.wsola_chain = chain
        check(len(decisions) == 4, f"{len(decisions)} WSOLA chains, want 4")
        same = all(torch.equal(a, b) for a, b in zip(decisions[:2], decisions[2:]))
        check(on_card.master.shape == on_cpu.master.shape,
              f"master {on_card.master.shape} vs {on_cpu.master.shape}")
        err = float(np.abs(on_card.master - on_cpu.master).max())
        print(f"[7 config4] {EXCERPT_SECONDS} s excerpt: master "
              f"{list(on_card.master.shape)}, splice decisions card vs cpu "
              f"{'equal' if same else 'DIFFER'} ({[len(d) for d in decisions[:2]]}"
              f" frames), max|card - cpu| master = {err:.3e} (tol {TOL:.0e}) "
              f"({card})")
        check(same, "card and CPU chose different splices")
        check(err <= TOL, "card master disagrees with the CPU plain path")

        # -- 8. times ----------------------------------------------------------
        wsola_times, energy_times = {}, {}
        for tag, (x, head, geo) in (("pitch", (x1, head1, geo1)),
                                    ("velocity", (x2, head2, geo2))):
            args = (x, head, *chain_args(geo))
            runs = {"kernel": [], "plain": []}
            for name in ("plain", "kernel", "kernel", "plain"):
                fn = (cuda_wsola.wsola_chain_cuda if name == "kernel"
                      else wsola.wsola_chain_plain)
                runs[name] += cuda_ms(lambda: fn(*args), 2, warmup=1)
            K, n_cand = geo["K"], geo["seek"] + 1
            C, ov, stride = x.shape[0], geo["overlap"], geo["seq"] - geo["overlap"]
            # Least work: x read once, bs and the body written once; the
            # correlations 2*C*overlap*(seek+1) flops per frame (the energies
            # could be running sums).
            wsola_times[tag] = dict(
                K=K,
                kernel=summary(runs["kernel"])[0],
                plain=summary(runs["plain"])[0],
                bound=bound(4 * (x.numel() + K + C * K * stride),
                            2 * C * ov * n_cand * K),
            )
            for name in ("kernel", "plain"):
                med, lo, hi, count = summary(runs[name])
                print(f"[8 times] WSOLA {tag} stage, K={K}, x {list(x.shape)}, "
                      f"{name}: median {med:.4f} ms (min {lo:.4f}, max "
                      f"{hi:.4f}, n={count}) ({card})")
            ms, by = wsola_times[tag]["bound"]
            print(f"[8 times] WSOLA {tag} stage bound: {ms:.4f} ms by {by}; "
                  f"kernel at {ms / wsola_times[tag]['kernel']:.2%} of it "
                  f"({card})")
            # The serial floor (an estimate): each candidate's correlation
            # is a chain of C*overlap dependent FFMAs (2*C*overlap flops).
            floor_us = C * ov * FFMA_LATENCY_CYCLES / sm_clock_mhz
            per_frame = wsola_times[tag]["kernel"] * 1e3 / K
            wsola_times[tag]["us_per_frame"] = per_frame
            print(f"[8 times] WSOLA {tag} stage: {per_frame:.4f} us per frame "
                  f"(prologue and chain, {-(-K // cuda_wsola.BLOCK_FRAMES)} "
                  f"launches each); serial floor ~{floor_us:.4f} us (estimate:"
                  f" {C * ov} dependent FFMAs x {FFMA_LATENCY_CYCLES} cycles at"
                  f" the {sm_clock_mhz:.0f} MHz max SM clock) ({card})")
            eargs = (x, 0, 0, *chain_args(geo))
            runs = {"kernel": [], "plain": []}
            for name in ("plain", "kernel", "kernel", "plain"):
                fn = (cuda_wsola.wsola_energy_cuda if name == "kernel"
                      else wsola.wsola_energy_plain)
                runs[name] += cuda_ms(lambda: fn(*eargs), 3, warmup=1)
            # Least work: x read once, the table written once; a multiply
            # and an add per (candidate, channel, tap).
            energy_times[tag] = dict(
                kernel=summary(runs["kernel"])[0],
                plain=summary(runs["plain"])[0],
                bound=bound(4 * (x.numel() + K * n_cand),
                            2 * C * ov * n_cand * K))
            for name in ("kernel", "plain"):
                med, lo, hi, count = summary(runs[name])
                print(f"[8 times] WSOLA energy prologue, {tag} stage, K={K} "
                      f"in one launch, {name}: median {med:.4f} ms (min "
                      f"{lo:.4f}, max {hi:.4f}, n={count}) ({card})")
            ms, by = energy_times[tag]["bound"]
            print(f"[8 times] WSOLA energy prologue, {tag} stage bound: "
                  f"{ms:.4f} ms by {by}; kernel at "
                  f"{ms / energy_times[tag]['kernel']:.2%} of it ({card})")

        def conv1d_call(x3, weight, M_):
            return F.conv1d(x3, weight, stride=M_)

        data = torch.from_numpy(
            (0.5 * rng.standard_normal((2, KERNEL_PAIRS[1][2]))).astype(
                np.float32)).to(dev)
        x, G, M, W, bank, support = tr.bank_operands(data,
                                                     *KERNEL_PAIRS[1][:2])
        transpose_bound = resample_work_bound(x, G, M, bank)
        fns = {
            "kernel": functools.partial(cuda_resample.apply_filter_bank_cuda,
                                        x, G, M, W, support),
            "plain": functools.partial(tr.apply_filter_bank_plain, x, G, M, W,
                                       bank),
            "conv1d": functools.partial(conv1d_call, x.view(2, 1, -1),
                                        bank.view(-1, 1, W), M),
        }
        resample_times["635/504"] = time_resampler(
            "8 times", f"635/504 transposition, bank {list(bank.shape)}, x "
            f"{list(x.shape)}", fns,
            ("plain", "conv1d", "kernel", "kernel", "conv1d", "plain"), 5,
            card, transpose_bound)
        del data, x, fns

        data = torch.from_numpy(
            (0.5 * rng.standard_normal((2, MAIN_CAPACITY))).astype(np.float32)
        ).to(dev)
        x, G, M, W, bank, _ = tr.bank_operands(data, *KERNEL_PAIRS[0][:2])
        med, lo, hi, count = summary(cuda_ms(functools.partial(
            conv1d_call, x.view(2, 1, -1), bank.view(-1, 1, W), M), 10))
        library_ms = med
        print(f"[8 times] 44.1->48 kHz, one {SECONDS} s stereo track, conv1d: "
              f"median {med:.4f} ms (min {lo:.4f}, max {hi:.4f}, n={count}); "
              f"bound {resample_bound[0]:.4f} ms by {resample_bound[1]}; the "
              f"kernel {kernel_ms:.4f} ms ({card})")
        del data, x

        runner = Runner(config4_graph(track_path), device=CARD)
        arrays, lengths, sources = runner.decode()
        compiled = runner.compile(sources, "export")
        args = runner.ingest(arrays, lengths)
        outputs, meta = compiled(args)
        audio_s = outputs["master"][1] / meta["master"]["rate"]
        med, lo, hi, count = summary(cuda_ms(lambda: compiled(args), 3, warmup=1))
        print(f"[8 times] config 4, {audio_s:.3f} audio-s: device render "
              f"median {med:.4f} ms (min {lo:.4f}, max {hi:.4f}, n={count}), "
              f"RTF {audio_s / (med / 1e3):.1f} audio-s per device-s "
              f"({card})")
        profile_render(lambda: compiled(args), card)
        del runner, arrays, compiled, args, outputs

        # -- 9. pv-kernels -----------------------------------------------------
        pv_worst = {"abs": 0.0, "lock": 0.0}
        for rate, tempo in GOLDEN_CASES:
            sig = torch.from_numpy(golden_signal(rate)).to(dev)
            worst, _ = check_pv(f"golden signal {rate} Hz, tempo {tempo}",
                                pv_operands(sig, tempo, rate), card)
            pv_worst = {k: max(pv_worst[k], worst[k]) for k in pv_worst}
        # Config 4's two PV stages at full width, on the main path's own
        # data: the 300 s track at 48 kHz, then the pitch stage's
        # transposed output.
        decoded = decode_file(track_path)
        track = torch.zeros((2, MAIN_CAPACITY), device=dev)
        track[:, : decoded.num_samples] = torch.from_numpy(decoded.data).to(dev)
        s48 = tr.resample_stream(Stream(data=track, length=decoded.num_samples,
                                        rate=RATE, channels=2), 48_000)
        del track, decoded
        pitch = 2.0 ** (PITCH / 12.0)
        pv_ops = {"pitch": pv_operands(s48.data, 1.0 / pitch, 48_000)}
        out1, len1 = pv.pv_stretch_at_rate(s48.data, s48.length, 1.0 / pitch,
                                           48_000)
        s2, _ = stretch.transpose_rate(out1, len1, pitch)
        del s48, out1
        pv_ops["velocity"] = pv_operands(s2, VELOCITY, 48_000)
        del s2
        frames = tuple(pv_ops[t][0].shape[1] for t in ("pitch", "velocity"))
        check(frames == CONFIG4_PV_FRAMES,
              f"PV frames {frames}, want {CONFIG4_PV_FRAMES}")
        lock_inputs = {}
        for tag, ops in pv_ops.items():
            worst, lock_inputs[tag] = check_pv(
                f"config-4 {tag} stage, K={ops[0].shape[1]}, planes "
                f"{list(ops[0].shape)}", ops, card)
            pv_worst = {k: max(pv_worst[k], worst[k]) for k in pv_worst}
        pv_worst["lock"] = max(pv_worst["lock"], lock_cases(lock_inputs, card))

        # -- 10. config4-pv ----------------------------------------------------
        proj = os.path.join(tmp, "config4_pv.json")
        with open(proj, "w") as f:
            json.dump(config4_graph(track_path, algorithm="pv").serialize(), f)
        _, counts_pv = cli_export(cli, proj, os.path.join(tmp, "config4_pv.wav"),
                                  "10 config4-pv", card)
        check(counts_pv["pv_phase_path"] >= 2,
              f"phase-path kernel launched {counts_pv['pv_phase_path']} times")
        check(counts_pv["pv_lock"] == 0,
              f"lock kernel launched {counts_pv['pv_lock']} times, want 0")
        check(counts_pv["polyphase_resample"] >= 2,
              f"resample kernel launched {counts_pv['polyphase_resample']} times")
        def render_excerpt(device, phase_path=None, analysis=None):
            """The PV config-4 excerpt's master; optionally with the phase
            path or the analysis replaced for this render only."""
            saved = pv.phase_path, pv._analysis
            pv.phase_path = phase_path or saved[0]
            pv._analysis = analysis or saved[1]
            try:
                return Runner(config4_graph(excerpt4, algorithm="pv"),
                              device=device).render("export").master
            finally:
                pv.phase_path, pv._analysis = saved

        def nudged_analysis(*a):
            """The analysis planes with re moved one ulp up or down."""
            re, im = saved_analysis(*a)
            up = torch.from_numpy(np.random.default_rng(0).random(re.shape)
                                  < 0.5).to(re.device)
            away = torch.where(up, math.inf, -math.inf).to(re.dtype)
            return torch.nextafter(re, away), im

        saved_analysis = pv._analysis
        on_card = render_excerpt(CARD)
        card_plain = render_excerpt(CARD, phase_path=pv.phase_path_plain)
        on_cpu = render_excerpt("cpu")
        cpu_nudged = render_excerpt("cpu", analysis=nudged_analysis)
        check(on_card.shape == card_plain.shape == on_cpu.shape,
              f"master {on_card.shape} vs {card_plain.shape}, {on_cpu.shape}")
        pv_excerpt_db = snr_db(card_plain, on_card)
        device_db = snr_db(on_cpu, on_card)
        nudge_db = snr_db(on_cpu, cpu_nudged)
        print(f"[10 config4-pv] {EXCERPT_SECONDS} s excerpt: master "
              f"{list(on_card.shape)}; kernels vs the plain versions, both on "
              f"the card: SNR {pv_excerpt_db:.1f} dB (min {PV_EXCERPT_DB:.0f}),"
              f" max|diff| {float(np.abs(on_card - card_plain).max()):.3e}; "
              f"card vs cpu: SNR {device_db:.1f} dB (min {PV_DEVICE_DB:.0f}); "
              f"cpu vs cpu with re one ulp off: SNR {nudge_db:.1f} dB ({card})")
        check(pv_excerpt_db >= PV_EXCERPT_DB,
              "the card's PV kernels disagree with its plain versions")
        check(device_db >= PV_DEVICE_DB,
              "card PV master disagrees with the CPU plain path")
        del on_card, card_plain, on_cpu, cpu_nudged

        # -- 11. config4-pv-options --------------------------------------------
        proj = os.path.join(tmp, "config4_pv_options.json")
        with open(proj, "w") as f:
            json.dump(config4_graph(track_path, algorithm="pv", transient=True,
                                    formants=True).serialize(), f)
        _, counts_opt = cli_export(
            cli, proj, os.path.join(tmp, "config4_pv_options.wav"),
            "11 config4-pv-options", card)
        check(counts_opt["pv_lock"] >= 2,
              f"lock kernel launched {counts_opt['pv_lock']} times, want >= 2")
        check(counts_opt["pv_phase_path"] == 0,
              f"phase-path kernel launched {counts_opt['pv_phase_path']} times")

        # -- 12. times ---------------------------------------------------------
        pv_times = {}
        for tag, (re, im, dpos, hop, n_fft) in pv_ops.items():
            lock_in = lock_inputs[tag]
            fns = {
                "phase kernel": lambda: cuda_pv.phase_path_cuda(
                    re, im, dpos, hop, n_fft, True),
                "phase plain": lambda: pv.phase_path_plain(
                    re, im, dpos, hop, n_fft, True),
                "lock kernel": lambda: cuda_pv.lock_to_peaks_cuda(*lock_in),
                "lock plain": lambda: pv._lock_to_peaks(*lock_in),
            }
            runs = {name: [] for name in fns}
            for name in ("phase plain", "phase kernel", "phase kernel",
                         "phase plain"):
                runs[name] += cuda_ms(fns[name], 3, warmup=1)
            for name in ("lock plain", "lock kernel", "lock kernel",
                         "lock plain"):
                runs[name] += cuda_ms(
                    fns[name], 3 if "plain" in name else 50, warmup=1,
                    queued=True)
            n = re.numel()
            # Least work: the phase path reads re, im and writes two planes;
            # ~33 operations per element, each transcendental counted as
            # one (magnitude, phase, wrap, advance, rotation, lock,
            # products). The lock: lock_work_bound.
            pv_times[tag] = {name: summary(runs[name])[0] for name in fns}
            pv_times[tag]["phase bound"] = bound(4 * 4 * n, 33 * n)
            pv_times[tag]["lock bound"] = lock_work_bound(re.shape)
            for name in fns:
                med, lo, hi, count = summary(runs[name])
                print(f"[12 times] PV {tag} stage, planes {list(re.shape)}, "
                      f"{name}: median {med:.4f} ms (min {lo:.4f}, max "
                      f"{hi:.4f}, n={count}) ({card})")
            for what in ("phase", "lock"):
                ms, by = pv_times[tag][f"{what} bound"]
                print(f"[12 times] PV {tag} stage {what} bound: {ms:.4f} ms by "
                      f"{by}; kernel at {ms / pv_times[tag][what + ' kernel']:.2%}"
                      f" of it ({card})")
            # The phase kernel's three passes, by the profiler's device time.
            passes = pass_ms(fns["phase kernel"], 5)
            pv_times[tag]["passes"] = passes
            parts = ", ".join(f"{name} {passes[name]:.4f} ms"
                              for name in PV_PASSES if name in passes)
            print(f"[12 times] PV {tag} stage, phase kernel by pass "
                  f"(torch.profiler, 5 calls): "
                  f"{parts or 'not measured (no device time seen)'}; sum "
                  f"{sum(passes.values()):.4f} ms beside the call's "
                  f"{pv_times[tag]['phase kernel']:.4f} ms and the bound "
                  f"{pv_times[tag]['phase bound'][0]:.4f} ms ({card})")
        del pv_ops, lock_inputs, fns

        runner = Runner(config4_graph(track_path, algorithm="pv"), device=CARD)
        arrays, lengths, sources = runner.decode()
        compiled = runner.compile(sources, "export")
        args = runner.ingest(arrays, lengths)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        outputs, meta = compiled(args)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        audio_s = outputs["master"][1] / meta["master"]["rate"]
        del outputs
        med, lo, hi, count = summary(cuda_ms(lambda: compiled(args), 3, warmup=1))
        print(f"[12 times] config 4 on the phase vocoder, {audio_s:.3f} audio-s: "
              f"device render median {med:.4f} ms (min {lo:.4f}, max {hi:.4f}, "
              f"n={count}), rtf_config4_pv {audio_s / (med / 1e3):.1f} audio-s "
              f"per device-s; peak {peak:.2f} GiB above its inputs ({card})")
        profile_render(lambda: compiled(args), card, "12 times", "config-4 PV")
        del runner, arrays, compiled, args

        # -- 13. stream-kernel -------------------------------------------------
        # Config 4 streamed at 16 s chunks on phase 6's data (track 1, float
        # samples): the graph's own chunk steps, driven by hand, cut the
        # pitch stage's 48 kHz input as the streaming plan does. Every launch
        # of the chunk entry is held against the plain chunk chain on the
        # same operands, and each stage's splices of all steps against the
        # offline chain kernel's over the whole clip.
        chunk = STREAM_CHUNK_SECONDS * RATE
        graph13 = config4_graph(track_path)
        compiled = chunkflow.compile_stream_graph(
            graph13, {(0, "output_0"): SourceSpec(
                rate=RATE, channels=2, fmt="flt", capacity=chunk)},
            device=CARD)
        by_kind = {node.processor.info().identifier: node.processor
                   for node in graph13.nodes.values()}
        plans = {"pitch": by_kind["pitch_modifier"]._wsola_plan,
                 "velocity": by_kind["velocity_modifier"]._wsola_plan}
        calls = {"pitch": [], "velocity": []}
        chunk_chain = wsola.wsola_chunk_chain

        def recording_chunk_chain(*a):
            out = chunk_chain(*a)
            if a[4]:
                tag = "pitch" if a[5] == plans["pitch"].num else "velocity"
                calls[tag].append(((a[0].clone(), a[1].clone(), *a[2:]), out))
            return out

        wsola.wsola_chunk_chain = recording_chunk_chain
        try:
            states, pos, steps13 = compiled.init_states, 0, 0
            while True:
                n = max(0, min(chunk, track1.shape[1] - pos))
                block = torch.zeros((2, chunk), device=dev)
                block[:, :n] = torch.from_numpy(track1[:, pos : pos + n]).to(dev)
                pos += chunk
                states, outs = compiled.step(states, {"n0:output_0": (
                    block, n, pos >= track1.shape[1])})
                steps13 += 1
                if outs["master"][2]:
                    break
        finally:
            wsola.wsola_chunk_chain = chunk_chain
        torch.cuda.synchronize()
        del compiled, states, outs, block
        print(f"[13 stream-kernel] config 4 at {STREAM_CHUNK_SECONDS} s chunks: "
              f"{steps13} steps; plans k_cap pitch {plans['pitch'].k_cap}, "
              f"velocity {plans['velocity'].k_cap}; FIFO snapshot x "
              f"[2, {plans['pitch'].window + plans['pitch'].push_cap}] and "
              f"[2, {plans['velocity'].window + plans['velocity'].push_cap}] "
              f"({card})")
        stream_err = 0.0
        for tag, geo, offline_bs in (("pitch", geo1, bs1),
                                     ("velocity", geo2, bs2)):
            streamed_bs, err = check_chunk_calls(
                f"{tag} stage", calls[tag], geo, card)
            stream_err = max(stream_err, err)
            same = torch.equal(streamed_bs,
                               offline_bs[: streamed_bs.numel()])
            print(f"[13 stream-kernel] {tag} stage: splices of all "
                  f"{len(calls[tag])} steps ({streamed_bs.numel()} frames) "
                  f"{'equal' if same else 'DIFFER from'} the offline chain "
                  f"kernel's first {streamed_bs.numel()} of K={geo['K']} "
                  f"({card})")
            check(same, f"{tag}: streamed splices differ from offline")

        # -- 14. streamed export -----------------------------------------------
        # Both graphs at 300 s through `run --stream`, every step under the
        # sync debug mode, against the offline card renders of phases 4 and
        # 7, launch counts set to 0 just before. Then device memory: each
        # graph exported again at 100 s and at 300 s (after that first
        # export, so the one-time allocations, filter banks and the DFT
        # basis, are in place), the whole export's peak each, beside the
        # offline render's peak on the same project.
        short_paths = write_tracks(tmp, make_signals(SHORT_SECONDS, seed=5),
                                   f"{SHORT_SECONDS}s")
        streamed = {}
        for tag, proj, offline_wav, tol, short_tracks in (
                ("5node", proj_5node, wav_5node, STREAM_MIX_TOL, short_paths),
                ("config4", proj_c4, wav_c4, TOL, short_paths[:1])):
            out_wav = os.path.join(tmp, f"{tag}_streamed.wav")
            spans = []
            zero_counts()
            with checked_steps(spans):
                rc, text, metrics = stream_export(cli, proj, out_wav)
            counts = read_counts()
            print("\n".join(f"[14 streamed] {tag} cli: {line}"
                            for line in text.splitlines()))
            check(rc == 0, f"{tag}: cli run --stream exited {rc}")
            check(metrics is not None, f"{tag}: the export did not stream")
            got = decode_file(out_wav).data
            want = decode_file(offline_wav).data
            check(got.shape == want.shape,
                  f"{tag}: streamed master {got.shape}, offline {want.shape}")
            err = float(np.abs(got - want).max())
            del got, want
            device_ms = sum(a.elapsed_time(b) for a, b in spans)

            short_proj = project_with_tracks(
                proj, short_tracks,
                os.path.join(tmp, f"{tag}_{SHORT_SECONDS}s.json"))
            peaks = {}
            for seconds, project in ((SHORT_SECONDS, short_proj),
                                     (SECONDS, proj)):
                result = []
                peaks[seconds] = device_peak(lambda: result.append(
                    stream_export(cli, project, out_wav)))
                check(result[0][0] == 0 and result[0][2] is not None,
                      f"{tag}: the {seconds} s streamed export failed")
            offline_peak = device_peak(lambda: Runner(
                cli._load_graph(proj), device=CARD).render("export"))
            streamed[tag] = dict(counts=counts, err=err, device_ms=device_ms)
            print(f"[14 streamed] {tag}: {SECONDS} s streamed master equal "
                  f"in length to the offline card render, max|diff| "
                  f"{err:.3e} (tol {tol:.0e}); launches {counts}; "
                  f"{len(spans)} steps under sync debug mode 'error'; peak "
                  f"device memory of a whole streamed export "
                  f"{peaks[SHORT_SECONDS] / 2**20:.1f} MiB at {SHORT_SECONDS}"
                  f" s, {peaks[SECONDS] / 2**20:.1f} MiB at {SECONDS} s (max "
                  f"+{STREAM_SLACK_BYTES / 2**20:.0f} MiB), offline render "
                  f"{offline_peak / 2**20:.1f} MiB; host RSS peak of this "
                  f"process {metrics.rss_peak_bytes / 2**20:.0f} MiB ({card})")
            check(err <= tol, f"{tag}: streamed master disagrees with offline")
            check(counts["polyphase_resample"] >= 1,
                  f"{tag}: resampler launched {counts['polyphase_resample']}")
            check(len(spans) == metrics.steps >= 4,
                  f"{tag}: {len(spans)} checked steps of {metrics.steps}")
            check(peaks[SECONDS] <= peaks[SHORT_SECONDS] + STREAM_SLACK_BYTES,
                  f"{tag}: streamed device memory grows with clip length")
            check(peaks[SECONDS] < offline_peak,
                  f"{tag}: streaming took more memory than the offline render")
        check(streamed["config4"]["counts"]["wsola_chain"] >= 2
              and streamed["config4"]["counts"]["wsola_energy"] >= 2,
              "the WSOLA kernel did not run on the streamed config 4")

        # -- 15. stream times --------------------------------------------------
        for tag, proj, name, what in (
                ("5node", proj_5node, "e2e_streamed_wav",
                 "5-node graph, two tracks"),
                ("config4", proj_c4, "e2e_streamed_timevariant",
                 "config 4 on WSOLA, WAV sink")):
            runs = []
            for _ in range(STREAM_TIMED_RUNS):
                rc, _text, m = stream_export(
                    cli, proj, os.path.join(tmp, f"{tag}_timed.wav"))
                check(rc == 0 and m is not None,
                      f"{tag}: a timed streamed export failed")
                runs.append(m)
            runs.sort(key=lambda r: r.rtf)
            m = runs[len(runs) // 2]
            print(f"[15 stream times] {name} ({what}, {SECONDS} s, "
                  f"{STREAM_CHUNK_SECONDS} s chunks, nothing instrumented): "
                  f"wall RTF median {m.rtf:.1f} (min {runs[0].rtf:.1f}, max "
                  f"{runs[-1].rtf:.1f}, n={len(runs)}); the median export: "
                  f"{m.audio_seconds:.3f} audio-s in {m.wall_seconds:.4f} s "
                  f"wall, {m.steps} steps, plan {m.compile_seconds:.4f} s, "
                  f"decode wait {m.decode_wait_seconds:.4f} s, egress wait "
                  f"{m.egress_wait_seconds:.4f} s, d2h busy "
                  f"{m.d2h_busy_seconds:.4f} s, sink busy "
                  f"{m.sink_busy_seconds:.4f} s; the steps' device span "
                  f"(CUDA events around each step of phase 14's export) "
                  f"{streamed[tag]['device_ms']:.4f} ms ({card})")
        chunk_times = {}
        for tag in ("pitch", "velocity"):
            plan = plans[tag]
            args, _ = calls[tag][len(calls[tag]) // 2]
            args = (*args[:4], plan.k_cap, *args[5:])
            runs = {"kernel": [], "plain": []}
            for name in ("plain", "kernel", "kernel", "plain"):
                fn = (cuda_wsola.wsola_chunk_chain_cuda if name == "kernel"
                      else wsola.wsola_chunk_chain_plain)
                runs[name] += cuda_ms(lambda: fn(*args), 2, warmup=1)
            C, ov = 2, plan.overlap
            span = plan.window - 2          # the k_cap frames' windows
            chunk_times[tag] = dict(
                K=plan.k_cap,
                kernel=summary(runs["kernel"])[0],
                plain=summary(runs["plain"])[0],
                bound=bound(4 * (C * span + C * ov + plan.k_cap
                                 + C * plan.k_cap * plan.stride_out + C * ov),
                            2 * C * ov * (plan.seek + 1) * plan.k_cap),
                total=sum(cuda_ms(lambda a=a: cuda_wsola.wsola_chunk_chain_cuda(
                    *a), 1, warmup=0)[0] for a, _ in calls[tag]),
            )
            t = chunk_times[tag]
            for name in ("kernel", "plain"):
                med, lo, hi, count = summary(runs[name])
                print(f"[15 stream times] chunk chain, {tag} stage, K=k_cap="
                      f"{plan.k_cap}, {name}: median {med:.4f} ms per launch "
                      f"(min {lo:.4f}, max {hi:.4f}, n={count}) ({card})")
            print(f"[15 stream times] chunk chain, {tag} stage bound: "
                  f"{t['bound'][0]:.4f} ms by {t['bound'][1]}; kernel at "
                  f"{t['bound'][0] / t['kernel']:.2%} of it; the kernel over "
                  f"the export's {len(calls[tag])} launches: {t['total']:.4f} "
                  f"ms ({card})")
        del calls

        # -- 16-18. wsola-table, probes, resample-data ----------------------
        stages = [("pitch", x1, head1, geo1, bs1, body1),
                  ("velocity", x2, head2, geo2, bs2, body2)]
        del x1, x2, head1, head2, body1, body2
        chain_us = wsola_times["pitch"]["kernel"] * 1e3 / geo1["K"]
        tool_paths, tool_entries = table_and_probe_phases(card, dev, stages,
                                                          chain_us)
        del stages

        # -- 19. stream-pv --------------------------------------------------
        pv_stream_paths, lock_chunk, stream_lock_err = stream_pv_phase(
            cli, card, dev, tmp, track1, track_path, excerpt4, short_paths[0])
        del track1

        # -- 20-21. realtime, chunked --------------------------------------
        session_paths = realtime_and_chunked_phases(cli, card, tmp, proj_5node,
                                                    excerpt)

    def by_path(name):
        return {path: counts[name] for path, counts in (
            ("5node", counts_5node), ("config4", counts_config4),
            ("config4_pv", counts_pv), ("config4_pv_options", counts_opt),
            ("5node_streamed", streamed["5node"]["counts"]),
            ("config4_streamed", streamed["config4"]["counts"]),
            *pv_stream_paths.items(), *session_paths.items(),
            *tool_paths.items())}

    def with_launches(entry):
        # resample_data is the polyphase kernel reached through the A/B
        # entry: its launches are those of that path alone.
        if entry["name"] == "resample_data":
            paths = {"resample_ab":
                     tool_paths["resample_ab"]["polyphase_resample"]}
        else:
            paths = by_path(entry["name"])
        return {**entry, "launches": sum(paths.values()),
                "launches_by_path": paths}

    pitch_times = wsola_times["pitch"]
    pv_pitch = pv_times["pitch"]
    print(json.dumps({"kernels": [
        {
            "name": "polyphase_resample",
            "route": "cuda",
            "source": "nodey_tpu_torch/csrc/polyphase_resample.cu",
            "replaces": "nodey_tpu/ops/pallas_resample.py:245",
            "launches": sum(by_path("polyphase_resample").values()),
            "launches_by_path": by_path("polyphase_resample"),
            "max_abs_err": kernel_err,
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": resample_bound[0],
            "bound_by": resample_bound[1],
            "library_ms": library_ms,
            "transposition_635_504": {
                "ms": resample_times["635/504"]["kernel"],
                "plain_ms": resample_times["635/504"]["plain"],
                "bound_ms": transpose_bound[0],
                "bound_by": transpose_bound[1],
                "library_ms": resample_times["635/504"]["conv1d"]},
        },
        {
            "name": "wsola_chain",
            "route": "cuda",
            "source": "nodey_tpu_torch/csrc/wsola_chain.cu",
            "replaces": "nodey_tpu/ops/pallas_wsola.py:452",
            "launches": config4_wsola,
            "launches_by_path": by_path("wsola_chain"),
            "max_abs_err": wsola_err,
            "ms": pitch_times["kernel"],
            "plain_ms": pitch_times["plain"],
            "bound_ms": pitch_times["bound"][0],
            "bound_by": pitch_times["bound"][1],
            "library_ms": None,
            "us_per_frame": pitch_times["us_per_frame"],
        },
        {
            "name": "wsola_chunk_chain",
            "route": "cuda",
            "source": "nodey_tpu_torch/csrc/wsola_chain.cu",
            "replaces": "nodey_tpu/ops/pallas_wsola.py:408",
            "launches": streamed["config4"]["counts"]["wsola_chain"],
            "launches_by_path": by_path("wsola_chain"),
            "max_abs_err": stream_err,
            "ms": chunk_times["pitch"]["kernel"],
            "plain_ms": chunk_times["pitch"]["plain"],
            "bound_ms": chunk_times["pitch"]["bound"][0],
            "bound_by": chunk_times["pitch"]["bound"][1],
            "library_ms": None,
        },
        {
            "name": "wsola_energy",
            "route": "cuda",
            "source": "nodey_tpu_torch/csrc/wsola_chain.cu",
            "replaces": "nodey_tpu/ops/pallas_wsola.py:452",
            "helper_of": "wsola_chain: no Pallas kernel of its own (the TPU "
                         "chain sums its energies in its serial loop)",
            "launches": sum(by_path("wsola_energy").values()),
            "launches_by_path": by_path("wsola_energy"),
            "max_abs_err": max(e[1] for e in energy_err),
            "max_rel_err": max(e[0] for e in energy_err),
            "ms": energy_times["pitch"]["kernel"],
            "plain_ms": energy_times["pitch"]["plain"],
            "bound_ms": energy_times["pitch"]["bound"][0],
            "bound_by": energy_times["pitch"]["bound"][1],
            "library_ms": None,
        },
        {
            "name": "pv_phase_path",
            "route": "cuda",
            "source": "nodey_tpu_torch/csrc/pv_phase_path.cu",
            "replaces": "nodey_tpu/ops/pallas_phase.py:174",
            "launches": counts_pv["pv_phase_path"],
            "launches_by_path": by_path("pv_phase_path"),
            "max_abs_err": pv_worst["abs"],
            "ms": pv_pitch["phase kernel"],
            "plain_ms": pv_pitch["phase plain"],
            "bound_ms": pv_pitch["phase bound"][0],
            "bound_by": pv_pitch["phase bound"][1],
            "library_ms": None,
            "passes_ms": pv_pitch["passes"],
        },
        {
            # The main path is the streamed PV: its launches, and its times at
            # the pitch stage's chunk shape; the velocity stage's chunk shape
            # and the offline render's shape beside them.
            "name": "pv_lock",
            "route": "cuda",
            "source": "nodey_tpu_torch/csrc/pv_lock.cu",
            "replaces": "nodey_tpu/ops/pallas_lock.py:126",
            "launches": pv_stream_paths["config4_pv_streamed"]["pv_lock"],
            "launches_by_path": by_path("pv_lock"),
            "max_abs_err": max(pv_worst["lock"], stream_lock_err),
            "shape": lock_chunk[max(lock_chunk)]["shape"],
            "ms": lock_chunk[max(lock_chunk)]["kernel"],
            "plain_ms": lock_chunk[max(lock_chunk)]["plain"],
            "bound_ms": lock_chunk[max(lock_chunk)]["bound"][0],
            "bound_by": lock_chunk[max(lock_chunk)]["bound"][1],
            "library_ms": None,
            "velocity_chunk": {
                "shape": lock_chunk[min(lock_chunk)]["shape"],
                "ms": lock_chunk[min(lock_chunk)]["kernel"],
                "plain_ms": lock_chunk[min(lock_chunk)]["plain"],
                "bound_ms": lock_chunk[min(lock_chunk)]["bound"][0]},
            "offline": {
                "shape": [2, CONFIG4_PV_FRAMES[0], 1025],
                "ms": pv_pitch["lock kernel"],
                "plain_ms": pv_pitch["lock plain"],
                "bound_ms": pv_pitch["lock bound"][0]},
        },
        *map(with_launches, tool_entries),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
