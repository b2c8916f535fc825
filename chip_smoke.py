#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``nodey_tpu_torch``) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, in order; the first failure exits non-zero:
  1. device  — a CUDA card, its name and power limit, TF32 off;
  2. build   — the kernel library from nodey_tpu_torch/csrc with nvcc;
  3. kernel  — the polyphase kernel against its plain PyTorch version on the
               card at 44.1->48 kHz (the main path's 300 s shape), 22.05->48
               and 44.1->32 kHz, stereo, ragged last tile: max|diff| <= 2e-6;
  4. slice   — the 5-node stereo graph through the port's CLI on two 300 s
               44.1 kHz stereo s16 tracks (export to WAV), then a 10 s
               excerpt of the same graph in code rendered on the card and on
               the CPU: master max|diff| <= 2e-6, spectrum SNR >= 100 dB;
  5. times   — CUDA events after a warm-up: kernel and plain version at the
               main path's shape, and the whole graph's device render as
               audio-seconds per device-second.
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
TOL = 2e-6
SNR_DB = 100.0
SECONDS = 300
EXCERPT_SECONDS = 10
RATE = 44_100
KERNEL_PAIRS = [(44_100, 48_000), (22_050, 48_000), (44_100, 32_000)]


def fail(message: str) -> None:
    print(f"chip_smoke FAILED: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, message: str) -> None:
    if not ok:
        fail(message)


def cuda_ms(fn, iters: int):
    """Milliseconds of each of ``iters`` back-to-back calls by CUDA events,
    after two warm-up calls."""
    import torch

    for _ in range(2):
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


def write_tracks(directory: str, signals, tag: str):
    """The signals as s16 WAVs; returns their paths."""
    from nodey_tpu_torch.host.decode import write_wav_s16

    paths = []
    for i, data in enumerate(signals):
        path = os.path.join(directory, f"track_{i + 1}_{tag}.wav")
        write_wav_s16(path, data, RATE)
        paths.append(path)
    return paths


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

    def pin(n, p):
        return g.nodes[n].pin_name_map[p]

    g.add_link(pin(src, "output_0"), pin(vol, "input"))
    g.add_link(pin(vol, "output"), pin(amix, "input_1"))
    g.add_link(pin(src, "output_1"), pin(amix, "input_2"))
    g.add_link(pin(amix, "output"), pin(spec, "input"))
    g.add_link(pin(spec, "output"), pin(out, "input"))
    return g


def main() -> int:
    sys.path.insert(0, ROOT)
    try:
        import nodey_tpu_torch  # noqa: F401  (sets the TF32 flags)
    except ImportError as exc:
        fail(f"the nodey_tpu_torch package is not beside this script ({exc})")
    import numpy as np
    import torch

    from nodey_tpu_torch.ops import _build, cuda_resample
    from nodey_tpu_torch.ops import resample as tr

    # -- 1. device -------------------------------------------------------------
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    dev = torch.device("cuda", 0)
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
    _build.load_library()
    print(f"[2 build] {_build.library_path().name} ready in "
          f"{time.perf_counter() - t0:.2f} s")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[2 build] ptxas: {line.strip()}")

    # -- 3. kernel against its plain version -----------------------------------
    rng = np.random.default_rng(1)
    main_capacity = -(-RATE * SECONDS // 65_536) * 65_536  # Runner._bucket
    kernel_err = None
    for in_rate, out_rate in KERNEL_PAIRS:
        n = main_capacity if (in_rate, out_rate) == KERNEL_PAIRS[0] \
            else in_rate * EXCERPT_SECONDS + 4_321
        data = torch.from_numpy(
            (0.5 * rng.standard_normal((2, n))).astype(np.float32)
        ).to(dev)
        x, G, M, W, bank = tr.bank_operands(data, in_rate, out_rate)
        got = cuda_resample.apply_filter_bank_cuda(x, G, M, W, bank)
        want = tr.apply_filter_bank_plain(x, G, M, W, bank)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        print(f"[3 kernel] {in_rate}->{out_rate} Hz, x {list(x.shape)}, "
              f"G={G}, tile ragged={G % cuda_resample._TILE_G != 0}: "
              f"max|kernel - plain| = {err:.3e} (tol {TOL:.0e})")
        check(err <= TOL, f"kernel disagrees with plain at {in_rate}->{out_rate}")
        if kernel_err is None:
            kernel_err = err
        del data, x, got, want

    # -- 4. slice --------------------------------------------------------------
    from nodey_tpu_torch.app import cli
    from nodey_tpu_torch.core.runner import Runner
    from nodey_tpu_torch.host.decode import decode_file

    with tempfile.TemporaryDirectory(prefix="nodey_chip_smoke_") as tmp:
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
        stdout = io.StringIO()
        with contextlib.redirect_stdout(stdout):
            rc = cli.main(["run", proj, "--export", out_wav, "--device", "cuda"])
        launches = cuda_resample.launches
        print("\n".join(f"[4 slice] cli: {line}"
                        for line in stdout.getvalue().splitlines()))
        check(rc == 0, f"cli run exited {rc}")
        master = decode_file(out_wav).data
        n_out = -(-n * 160 // 147)
        check(master.shape == (2, n_out),
              f"exported master {master.shape}, want (2, {n_out})")
        check(bool(np.isfinite(master).all()), "exported master not finite")
        cap_out = -(-main_capacity * 160 // 147)
        frames = (cap_out - 1024) // 512 + 1
        want_line = f"spectrum 'spectrum_4': shape [2, {frames}, 513]"
        check(want_line in stdout.getvalue(), f"missing '{want_line}'")
        print(f"[4 slice] {SECONDS} s export: master {list(master.shape)} finite, "
              f"spectrum [2, {frames}, 513], kernel launches {launches}")
        check(launches >= 2, f"resample kernel launched {launches} times, want >= 2")

        excerpt = write_tracks(
            tmp, [s[:, : RATE * EXCERPT_SECONDS] for s in signals],
            f"{EXCERPT_SECONDS}s",
        )
        del signals
        on_card = Runner(flagship_graph(excerpt), device="cuda").render("export")
        on_cpu = Runner(flagship_graph(excerpt), device="cpu").render("export")
        check(on_card.master.shape == on_cpu.master.shape,
              f"master {on_card.master.shape} vs {on_cpu.master.shape}")
        err = float(np.abs(on_card.master - on_cpu.master).max())
        [key] = on_card.spectra
        snr = snr_db(on_cpu.spectra[key], on_card.spectra[key])
        print(f"[4 slice] {EXCERPT_SECONDS} s excerpt, gain 1.5, amix 0.6/0.4: "
              f"max|card - cpu| master = {err:.3e} (tol {TOL:.0e}), "
              f"spectrum SNR {snr:.1f} dB (min {SNR_DB:.0f})")
        check(err <= TOL, "card master disagrees with the CPU plain path")
        check(snr >= SNR_DB, "card spectrum disagrees with the CPU plain path")

        # -- 5. times ----------------------------------------------------------
        data = torch.from_numpy(
            (0.5 * rng.standard_normal((2, main_capacity))).astype(np.float32)
        ).to(dev)
        x, G, M, W, bank = tr.bank_operands(data, *KERNEL_PAIRS[0])
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
        del data, x

        runner = Runner(flagship_graph(paths), device="cuda")
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

    print(json.dumps({"kernels": [{
        "name": "polyphase_resample",
        "route": "cuda",
        "source": "nodey_tpu_torch/csrc/polyphase_resample.cu",
        "replaces": "nodey_tpu/ops/pallas_resample.py:245",
        "launches": launches,
        "max_abs_err": kernel_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
