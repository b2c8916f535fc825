"""On-card A/B of the phase-vocoder kernels: the phase path pass by pass,
and the lock.

    python nodey_tpu_torch/tools/pv_phase_ab.py [--root DIR ...] [--iters N]

    e.g. git archive HEAD~1 | tar -x -C checkouts/parent, then
    python nodey_tpu_torch/tools/pv_phase_ab.py --root checkouts/parent --root .

For each checkout given by ``--root`` (default: the one this file is in),
in turns (A B ... B A: the first root first and last), a fresh process
imports that checkout's ``nodey_tpu_torch`` and, on planes analysed from
one seeded signal (tones whose pitch glides, plus noise), times

- its ``cuda_pv.phase_path_cuda`` at config 4's two PV shapes ([2, 35,460,
  1025] and [2, 22,520, 1025]: 48 kHz, tempo 2^(-1/3) and 1.25), with the
  lock on and off;
- its ``cuda_pv.lock_to_peaks_cuda`` on the lock's inputs of those planes
  (the plain path's unlocked phasors, phases and magnitudes) at the same
  two shapes, and at the streamed PV's two chunk shapes (``chunk_frames``
  at 16 s chunks: [2, 1,894, 1025] and [2, 1,207, 1025], the frames of a
  step from the middle of each).

Per case it prints:

- the whole call's time (CUDA events around each of ``iters`` back-to-back
  calls, ``LOCK_ITERS`` for the lock, after warm-up and queued behind a
  spin of the card, so that the events time the kernels and not the host:
  median, min, max), beside the bound (each input plane read once and each
  output plane written once, at 3.35 TB/s);
- for the phase path, each pass's device time per call (``torch.profiler``
  over ``iters`` calls, by kernel name: totals, carry, apply) and their sum;
- a digest of the input planes and one of the output planes, so that the
  checkouts are seen to get the same inputs and whether they give bitwise
  the same planes.

Then, per case, each checkout's median over its runs and whether its
planes equal the first checkout's; where they do not, how many elements
differ and by how much at most (the outputs of each checkout's first run,
kept in a temporary directory meanwhile). Compare checkouts only within
one run of this tool, on one card. Without a CUDA card it exits 1. The
tool uses nothing of a checkout but ``pv``, ``cuda_pv`` and the stream
plans of config 4's stages, so it times checkouts older than itself.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile

RATE = 48_000
# Config 4's two PV stages: (tempo, K).
CASES = {"pitch": (2.0 ** (-4.0 / 12.0), 35_460), "velocity": (1.25, 22_520)}
# Config 4's source rate and the streamed export's chunk length, which give
# the lock's chunk shapes (``chunk_frames``), and the lock's timed launches.
SOURCE_RATE = 44_100
CHUNK_SECONDS = 16
LOCK_ITERS = 200
HBM_BYTES_PER_S = 3.35e12
DEVICE = "cuda"          # the card; the kernel runs nowhere else
PASSES = ("totals", "carry", "apply")


def chunk_frames(chunk_seconds: float, source_rate: int = SOURCE_RATE) -> dict:
    """{stage: k_cap}: the frames a step of config 4's two PV stages (pitch
    +4, velocity 1.25 keeping the pitch, after a resampler to 48 kHz) when
    a ``source_rate`` stereo source streams in chunks of ``chunk_seconds``:
    the lock's chunk shapes. Read from the stages' own stream plans, made
    on the CPU."""
    import torch

    from nodey_tpu_torch.core import chunkflow
    from nodey_tpu_torch.processors.resample_node import AudioResample
    from nodey_tpu_torch.processors.velocity import (PitchModifier,
                                                     VelocityModifier)

    resampler, pitch, velocity = (AudioResample(), PitchModifier(),
                                  VelocityModifier())
    resampler.set_target_rate(RATE)
    pitch.pitch = 4.0
    velocity.set_velocity(1.25)
    velocity.keep_pitch = True
    ctx = chunkflow.StreamPlanCtx("export", {}, torch.device("cpu"))
    spec = chunkflow.ChunkSpec(rate=source_rate, channels=2, fmt="flt",
                               width=int(chunk_seconds * source_rate))
    spec = resampler.plan_stream(ctx, {"input": spec})[0]["output"]
    frames = {}
    for tag, stage in (("pitch", pitch), ("velocity", velocity)):
        stage.set_algorithm("pv")
        spec = stage.plan_stream(ctx, {"input": spec})[0]["output"]
        frames[tag] = stage._pv_plan.k_cap
    return frames


def _length_for(pv, frames: int, tempo: float) -> int:
    """The smallest clip length whose PV geometry has ``frames`` frames."""
    lo, hi = 1, 1 << 26
    while lo < hi:
        mid = (lo + hi) // 2
        pos = pv._pv_geometry(mid, tempo, RATE)[2]
        if len(pos) >= frames:
            hi = mid
        else:
            lo = mid + 1
    return lo


def _signal(n: int, seed: int = 8):
    """[2, n] float32: three tones whose pitch glides, plus noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64) / RATE
    sig = sum(a * np.sin(2 * np.pi * f * t * (1.0 + 0.05 * t / t[-1]))
              for a, f in ((0.35, 220.0), (0.2, 513.0), (0.1, 1877.0)))
    return (np.stack([sig, 0.8 * sig]) + 0.05 * rng.standard_normal(
        (2, n))).astype(np.float32)


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def pass_ms(fn, iters: int) -> dict:
    """Device ms per call of each phase-path pass (by kernel name), from
    torch.profiler over ``iters`` calls; {} if it saw no device time.
    (chip_smoke.py has its own: this file imports nothing of it.)"""
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
        for name in PASSES:
            if f"pv_phase_{name}" in event.key and us > 0:
                out[name] = out.get(name, 0.0) + us / 1e3 / iters
    return out


def _tool_planes(pv, dev):
    """(tag, (re, im, dpos, hop, n_fft)) of the tool's own signal."""
    import torch

    for tag, (tempo, frames) in CASES.items():
        n = _length_for(pv, frames, tempo)
        data = torch.from_numpy(_signal(n)).to(dev)
        n_fft, hop, pos, dpos, pad_to = pv._pv_geometry(n, tempo, RATE)
        re, im = pv._analysis(data, pos, pad_to, n_fft)
        del data
        yield tag, (re, im, dpos, hop, n_fft)


def _call_ms(call, iters: int) -> list:
    """[median, min, max] ms of ``iters`` back-to-back calls by CUDA
    events, after three warm-up calls. The card first spins for ~0.1 ms a
    call (``torch.cuda._sleep``), so the calls queue up behind it and each
    pair of events times the kernels alone: a wrapper's host time (tens of
    us) would otherwise be timed wherever it exceeds its kernel's."""
    import torch

    for _ in range(3):
        call()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(max(10**7, 200_000 * iters))
    for start, end in events:
        start.record()
        call()
        end.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in events)
    return [times[len(times) // 2], times[0], times[-1]]


def _keep(keep: str, name: str, planes) -> None:
    import numpy as np
    import torch

    if keep:
        np.save(os.path.join(keep, f"{name}.npy"),
                torch.stack(planes).cpu().numpy())


def child(root: str, iters: int, keep: str = "") -> dict:
    """Time ``root``'s phase-path and lock kernels on every case (in this
    process); with ``keep``, save the locked phase-path planes and the lock's
    outputs there as ``<case>.npy``."""
    sys.path.insert(0, root)
    import torch

    from nodey_tpu_torch.ops import cuda_pv, pv

    dev = torch.device(DEVICE)
    step_frames = chunk_frames(CHUNK_SECONDS)
    results = {}
    for tag, (re, im, dpos, hop, n_fft) in _tool_planes(pv, dev):
        in_digest = _digest(re, im)
        for lock in (True, False):
            def call():
                return cuda_pv.phase_path_cuda(re, im, dpos, hop, n_fft, lock)

            ry, iy = call()
            torch.cuda.synchronize()
            out_digest = _digest(ry, iy)
            if lock:
                _keep(keep, tag, (ry, iy))
            del ry, iy
            results[f"{tag} lock={lock}"] = {
                "shape": list(re.shape),
                "call_ms": _call_ms(call, iters),
                "passes_ms": pass_ms(call, iters),
                "bound_ms": 16 * re.numel() / HBM_BYTES_PER_S * 1e3,
                "in": in_digest, "out": out_digest,
            }
        mag, ph = pv._magnitude_phase(re, im)
        del re, im
        cos_phi, sin_phi = pv._synthesis_phasors(ph, dpos, hop, n_fft)
        whole = (cos_phi, sin_phi, ph, mag)
        K = mag.shape[1]
        k0 = (K - step_frames[tag]) // 2
        step = tuple(t[:, k0 : k0 + step_frames[tag]].contiguous()
                     for t in whole)
        for planes in (whole, step):
            name = f"lock {tag} K={planes[3].shape[1]}"

            def call():
                return cuda_pv.lock_to_peaks_cuda(*planes)

            out = call()
            torch.cuda.synchronize()
            _keep(keep, name.replace(" ", "-"), out)
            results[name] = {
                "shape": list(planes[3].shape),
                "call_ms": _call_ms(call, LOCK_ITERS),
                "passes_ms": {},
                "bound_ms": 24 * planes[3].numel() / HBM_BYTES_PER_S * 1e3,
                "in": _digest(*planes), "out": _digest(*out),
            }
            del out
        del whole, step, cos_phi, sin_phi, ph, mag
    return results


def card_line() -> str:
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        lines = smi.stdout.strip().splitlines()
    except OSError as exc:
        return f"power limit not read ({exc})"
    return lines[0] if lines else "nvidia-smi printed nothing"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", action="append", default=None)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--child", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--keep", default="", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.child is not None:
        print(json.dumps(child(args.child, args.iters, args.keep)),
              flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("pv_phase_ab: no CUDA card (torch.cuda.is_available() is "
              "False): the kernel runs only on one", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    roots = [os.path.abspath(r) for r in (args.root or [here])]
    print(f"card: {card_line()}", flush=True)
    runs = {root: [] for root in roots}
    planes = tempfile.mkdtemp(prefix="pv_phase_ab_")
    try:
        return _compare(roots, runs, planes, args.iters)
    finally:
        shutil.rmtree(planes, ignore_errors=True)


def _compare(roots, runs, planes, iters: int) -> int:
    import numpy as np

    for root in roots + roots[::-1]:
        keep = ""
        if not runs[root]:
            keep = os.path.join(planes, str(roots.index(root)))
            os.makedirs(keep)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", root,
             "--iters", str(iters), "--keep", keep],
            capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[root].append(result)
        for case, r in result.items():
            med, lo, hi = r["call_ms"]
            if case.startswith("lock "):
                timing = (f"n={LOCK_ITERS}); bound {r['bound_ms']:.4f} ms by "
                          f"bytes, {r['bound_ms'] / med:.1%} of it")
            else:
                parts = ", ".join(f"{p} {r['passes_ms'][p]:.4f}"
                                  for p in PASSES if p in r["passes_ms"])
                timing = (f"n={iters}); passes [{parts or 'not measured'}] "
                          f"sum {sum(r['passes_ms'].values()):.4f} ms; bound "
                          f"{r['bound_ms']:.4f} ms by bytes")
            print(f"{root}: {case} {r['shape']}: call median {med:.4f} ms "
                  f"(min {lo:.4f}, max {hi:.4f}, {timing}; planes in "
                  f"{r['in']} out {r['out']}", flush=True)
    first = runs[roots[0]][0]
    for case in first:
        for root in roots:
            mine = [run[case] for run in runs[root]]
            calls = sorted(m["call_ms"][0] for m in mine)
            spread = (min(m["call_ms"][1] for m in mine),
                      max(m["call_ms"][2] for m in mine))
            same_in = all(m["in"] == first[case]["in"] for m in mine)
            same_out = all(m["out"] == first[case]["out"] for m in mine)
            passes = {p: sorted(m["passes_ms"][p] for m in mine)
                      for p in PASSES if all(p in m["passes_ms"] for m in mine)}
            print(f"summary {case}: {root}: call {calls[len(calls) // 2]:.4f}"
                  f" ms over {len(calls)} runs (min {spread[0]:.4f}, max "
                  f"{spread[1]:.4f}"
                  + "".join(f", {p} {v[len(v) // 2]:.4f}"
                            for p, v in passes.items())
                  + f"); inputs equal to the first root's: {same_in}; "
                  f"planes bitwise the first root's: {same_out}", flush=True)
            name = (case.replace(" ", "-") if case.startswith("lock ")
                    else case.split()[0])
            if same_out or case.endswith("lock=False"):
                continue
            ref = np.load(os.path.join(planes, "0", f"{name}.npy"),
                          mmap_mode="r")
            got = np.load(os.path.join(planes, str(roots.index(root)),
                                       f"{name}.npy"), mmap_mode="r")
            differ = int(np.count_nonzero(ref != got))
            worst = float(np.abs(ref.astype(np.float64) - got).max())
            print(f"summary {case}: {root}: {differ} of {ref.size} plane "
                  f"elements differ from the first root's, max|diff| "
                  f"{worst:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
