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
  5. times   — CUDA events after a warm-up: the polyphase kernel and its plain
               version at the 5-node path's shape, and the whole graph's
               device render as audio-seconds per device-second;
  6. wsola   — the WSOLA chain kernel against its plain version on the card:
               splice offsets bitwise on the 7 golden signals; at config 4's
               two 300 s shapes (K 11,820 and 7,507) every frame's choice
               against the plain scoring given the kernel's previous choice
               (a differing frame must be a near tie: float64 scores within
               1e-5 of the frame's max |score|, at most 0.1% of K) and the
               audio against the plain assembly of the same choices (2e-6);
  7. config4 — the config-4 graph (resample -> pitch +4 -> velocity 1.25
               keep_pitch) through the CLI on a 300 s 44.1 kHz stereo track,
               exported to WAV: length 11,519,994, finite, >= 2 launches of
               each kernel; a 10 s excerpt on the card and on the CPU: equal
               splice decisions, master max|diff| <= 2e-6;
  8. times   — CUDA events: the WSOLA kernel and its plain version at both
               shapes; the 635/504 resample (kernel, plain, conv1d); conv1d at
               44.1->48 kHz; the config-4 render as audio-seconds per
               device-second, and one render under torch.profiler (device
               time by kernel, the device's idle share).
The line before the last is one JSON object describing the kernels; the last
is ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import functools
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
TIE_REL = 1e-5                   # a differing choice must be this near a tie
TIE_SHARE = 1e-3                 # ... on at most this share of the frames
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
# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


def fail(message: str) -> None:
    print(f"chip_smoke FAILED: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, message: str) -> None:
    if not ok:
        fail(message)


def cuda_ms(fn, iters: int, warmup: int = 2):
    """Milliseconds of each of ``iters`` back-to-back calls by CUDA events,
    after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in events]


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


def config4_graph(path):
    """BASELINE config 4 as bench.py:172-192 builds it, with the port's
    processors: resample 48 kHz -> pitch +4 -> velocity 1.25 keep_pitch."""
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
    return g


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


def near_tie(x, head, bs, k: int, other: int, geo) -> float:
    """|score64(bs[k]) - score64(other)| / max_b |score64(b)| of frame k,
    in float64 with the tail that the chain's choice bs[k-1] realized."""
    import numpy as np

    from nodey_tpu_torch.ops.wsola import frame_pos

    seq, seek, ov = geo["seq"], geo["seek"], geo["overlap"]
    num, den = geo["num"], geo["den"]
    if k == 0:
        tail = head
    else:
        start = frame_pos(k - 1, num, den) + int(bs[k - 1]) + seq - ov
        tail = x[:, start : start + ov]
    pos = frame_pos(k, num, den)
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


def profile_render(render, card: str, top: int = 6) -> None:
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
        print(f"[8 times] config-4 profile: the profiler saw no device time "
              f"(breakdown not measured) ({card})")
        return
    for ms, count, key in rows[:top]:
        print(f"[8 times] config-4 profile: {ms:.4f} ms in {count} launches "
              f"({ms / span_ms:.1%}) {key[:70]} ({card})")
    print(f"[8 times] config-4 profile: kernels {busy_ms:.4f} ms of a "
          f"{span_ms:.4f} ms render; device idle share "
          f"{max(0.0, 1.0 - busy_ms / span_ms):.2%} ({card})")


def main() -> int:
    sys.path.insert(0, ROOT)
    try:
        import nodey_tpu_torch  # noqa: F401  (sets the TF32 flags)
        from nodey_tpu_torch.app import cli
        from nodey_tpu_torch.core.runner import Runner
        from nodey_tpu_torch.core.stream import Stream
        from nodey_tpu_torch.host.decode import decode_file
        from nodey_tpu_torch.ops import _build, cuda_resample, cuda_wsola
        from nodey_tpu_torch.ops import resample as tr
        from nodey_tpu_torch.ops import stretch, wsola
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
        x, G, M, W, bank = tr.bank_operands(data, in_rate, out_rate)
        got = cuda_resample.apply_filter_bank_cuda(x, G, M, W, bank)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        want = tr.apply_filter_bank_plain(x, G, M, W, bank)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        err = (got - want).abs().max().item()
        print(f"[3 kernel] {in_rate}->{out_rate} Hz, bank {list(bank.shape)}, "
              f"x {list(x.shape)}, G={G}, tile ragged="
              f"{G % cuda_resample._TILE_G != 0}: max|kernel - plain| = "
              f"{err:.3e} (tol {TOL:.0e}); plain version's peak "
              f"{peak:.1f} MiB above its inputs ({card})")
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

        cuda_resample.launches = 0
        cuda_wsola.launches = 0
        stdout = io.StringIO()
        with contextlib.redirect_stdout(stdout):
            rc = cli.main(["run", proj, "--export", out_wav, "--device", CARD])
        launches_5node = cuda_resample.launches
        wsola_5node = cuda_wsola.launches
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
        x, G, M, W, bank = tr.bank_operands(data, *KERNEL_PAIRS[0][:2])
        kernel = functools.partial(
            cuda_resample.apply_filter_bank_cuda, x, G, M, W, bank)
        plain = functools.partial(tr.apply_filter_bank_plain, x, G, M, W, bank)
        runs = {"kernel": [], "plain": []}
        for name in ("plain", "kernel", "kernel", "plain"):  # in turns
            runs[name] += cuda_ms(kernel if name == "kernel" else plain, 10)
        kernel_ms, plain_ms = (summary(runs[k])[0] for k in ("kernel", "plain"))
        for name in ("kernel", "plain"):
            med, lo, hi, count = summary(runs[name])
            print(f"[5 times] 44.1->48 kHz, one {SECONDS} s stereo track, "
                  f"{name}: median {med:.4f} ms (min {lo:.4f}, max {hi:.4f}, "
                  f"n={count}) ({card})")
        resample_bound = resample_work_bound(x, G, M, bank)
        del data, x, kernel, plain

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
        del signals
        s48 = tr.resample_stream(Stream(data=track, length=n, rate=RATE,
                                        channels=2), 48_000)
        del track
        pitch = 2.0 ** (PITCH / 12.0)
        x1, head1, geo1 = wsola_operands(s48.data, 1.0 / pitch, 48_000)
        _, body1, err1 = check_chain(
            f"pitch +{PITCH:g} stage, tempo {1.0 / pitch:.5f}", x1, head1, geo1,
            card)
        out1 = torch.cat([head1, body1], dim=1)
        len1 = min(stretch._scale_length_exact(s48.length, 1.0 / pitch),
                   out1.shape[1])
        out1[:, len1:] = 0.0
        s2, len2 = stretch.transpose_rate(out1, len1, pitch)
        del s48, out1, body1
        x2, head2, geo2 = wsola_operands(s2, VELOCITY, 48_000)
        _, _, err2 = check_chain(f"velocity {VELOCITY:g} stage, tempo "
                                 f"{VELOCITY:g}", x2, head2, geo2, card)
        check((geo1["K"], geo2["K"]) == CONFIG4_FRAMES,
              f"frames {(geo1['K'], geo2['K'])}, want {CONFIG4_FRAMES}")
        wsola_err = max(err1, err2)
        del s2

        # -- 7. config4 --------------------------------------------------------
        [track_path] = write_tracks(tmp, [make_signals(SECONDS, seed=4)[0]],
                                    f"{SECONDS}s_config4")
        proj = os.path.join(tmp, "config4.json")
        with open(proj, "w") as f:
            json.dump(config4_graph(track_path).serialize(), f)
        out_wav = os.path.join(tmp, "config4.wav")
        cuda_resample.launches = 0
        cuda_wsola.launches = 0
        stdout = io.StringIO()
        with contextlib.redirect_stdout(stdout):
            rc = cli.main(["run", proj, "--export", out_wav, "--device", CARD])
        config4_resample = cuda_resample.launches
        config4_wsola = cuda_wsola.launches
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
        wsola_times = {}
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
        del x1, x2, head1, head2

        def conv1d_call(x3, weight, M_):
            return F.conv1d(x3, weight, stride=M_)

        data = torch.from_numpy(
            (0.5 * rng.standard_normal((2, KERNEL_PAIRS[1][2]))).astype(
                np.float32)).to(dev)
        x, G, M, W, bank = tr.bank_operands(data, *KERNEL_PAIRS[1][:2])
        fns = {
            "kernel": functools.partial(cuda_resample.apply_filter_bank_cuda,
                                        x, G, M, W, bank),
            "plain": functools.partial(tr.apply_filter_bank_plain, x, G, M, W,
                                       bank),
            "conv1d": functools.partial(conv1d_call, x.view(2, 1, -1),
                                        bank.view(-1, 1, W), M),
        }
        runs = {name: [] for name in fns}
        for name in ("plain", "conv1d", "kernel", "kernel", "conv1d", "plain"):
            runs[name] += cuda_ms(fns[name], 5)
        transpose_bound = resample_work_bound(x, G, M, bank)
        for name in fns:
            med, lo, hi, count = summary(runs[name])
            print(f"[8 times] 635/504 transposition, bank "
                  f"{list(bank.shape)}, x {list(x.shape)}, {name}: median "
                  f"{med:.4f} ms (min {lo:.4f}, max {hi:.4f}, n={count}) "
                  f"({card})")
        print(f"[8 times] 635/504 transposition bound: "
              f"{transpose_bound[0]:.4f} ms by {transpose_bound[1]} ({card})")
        del data, x, fns

        data = torch.from_numpy(
            (0.5 * rng.standard_normal((2, MAIN_CAPACITY))).astype(np.float32)
        ).to(dev)
        x, G, M, W, bank = tr.bank_operands(data, *KERNEL_PAIRS[0][:2])
        med, lo, hi, count = summary(cuda_ms(functools.partial(
            conv1d_call, x.view(2, 1, -1), bank.view(-1, 1, W), M), 10))
        library_ms = med
        print(f"[8 times] 44.1->48 kHz, one {SECONDS} s stereo track, conv1d: "
              f"median {med:.4f} ms (min {lo:.4f}, max {hi:.4f}, n={count}); "
              f"bound {resample_bound[0]:.4f} ms by {resample_bound[1]} "
              f"({card})")
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

    pitch_times = wsola_times["pitch"]
    print(json.dumps({"kernels": [
        {
            "name": "polyphase_resample",
            "route": "cuda",
            "source": "nodey_tpu_torch/csrc/polyphase_resample.cu",
            "replaces": "nodey_tpu/ops/pallas_resample.py:245",
            "launches": launches_5node + config4_resample,
            "launches_by_path": {"5node": launches_5node,
                                 "config4": config4_resample},
            "max_abs_err": kernel_err,
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": resample_bound[0],
            "bound_by": resample_bound[1],
            "library_ms": library_ms,
        },
        {
            "name": "wsola_chain",
            "route": "cuda",
            "source": "nodey_tpu_torch/csrc/wsola_chain.cu",
            "replaces": "nodey_tpu/ops/pallas_wsola.py:452",
            "launches": config4_wsola,
            "launches_by_path": {"5node": wsola_5node,
                                 "config4": config4_wsola},
            "max_abs_err": wsola_err,
            "ms": pitch_times["kernel"],
            "plain_ms": pitch_times["plain"],
            "bound_ms": pitch_times["bound"][0],
            "bound_by": pitch_times["bound"][1],
            "library_ms": None,
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
