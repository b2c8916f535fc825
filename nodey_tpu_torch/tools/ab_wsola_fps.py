"""On-card A/B of the WSOLA step floor, the serial chain kernel and the
score-table route (the port of ``tools/ab_wsola_fps.py``).

    python -m nodey_tpu_torch.tools.ab_wsola_fps [seconds] [iters]

On a stereo clip of ``seconds`` (default 30) at 48 kHz, 0.3 * N(0, 1) from
seed 5, stretched at tempo 1.25, it prints in the JAX tool's order, after
the card's name and power limit:

1. K, seq, seek, overlap;
2. the bare and the dma step probes (``ops/cuda_probes.py``, in the JAX
   tool's forms: one fixed output block; two window copies per step, both
   waited) run for K steps: microseconds per step, the launch's time over K;
3. the production stretch, ``stretch.wsola_stretch_at_rate`` (the serial
   chain kernel): milliseconds total and microseconds per frame;
4. the table route (score kernel + walk, ``wsola.splice_offsets``) at
   frames_per_step 1, 2 and 4: milliseconds total and microseconds per
   frame;
5. ``table fps=F == fps=1: True/False`` for F = 2 and 4 (whole tables).

Times are CUDA events over ``iters`` calls (default 8) after one warm-up.
The probes and kernels mean something only on the card: without one it
exits 1.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

from nodey_tpu_torch.ops import cuda_probes, stretch, wsola
from nodey_tpu_torch.tools import probes

RATE = 48_000
TEMPO = 1.25
DEVICE = "cuda"          # the card; the probes measure nothing elsewhere


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        lines = smi.stdout.strip().splitlines()
    except OSError as exc:
        lines = [f"{torch.cuda.get_device_name(0)}, power limit not read "
                 f"({exc})"]
    return lines[0] if lines else "nvidia-smi printed nothing"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    seconds = float(argv[0]) if argv else 30.0
    iters = int(argv[1]) if len(argv) > 1 else 8
    if not torch.cuda.is_available():
        print("ab_wsola_fps: no CUDA card (torch.cuda.is_available() is "
              "False): the probes and the WSOLA kernels run only on one",
              file=sys.stderr)
        return 1
    dev = torch.device(DEVICE)
    print(f"card: {card_line()}", flush=True)
    print(f"devices: {torch.cuda.device_count()} x "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    n = int(RATE * seconds)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(
        (0.3 * rng.standard_normal((2, n))).astype(np.float32)).to(dev)
    geo = stretch.wsola_geometry(n, TEMPO, RATE)
    K = geo["K"]
    args = (K, geo["num"], geo["den"], geo["seq"], geo["seek"], geo["overlap"])
    print(f"K={K} seq={geo['seq']} seek={geo['seek']} "
          f"overlap={geo['overlap']}", flush=True)

    block = torch.zeros(cuda_probes.BLOCK, device=dev)
    t = probes.cuda_seconds(
        lambda: cuda_probes.step_probe_bare(block, K, per_step=False), iters)
    print(f"bare grid step: {t / K * 1e6:.3f} us/step", flush=True)
    wide = torch.zeros((2, probes.DMA_COLUMNS), device=dev)
    span = probes.span_dma(RATE)
    t = probes.cuda_seconds(
        lambda: cuda_probes.step_probe_dma(wide, K, span, ring=False), iters)
    print(f"dma-only step:  {t / K * 1e6:.3f} us/step", flush=True)

    t = probes.cuda_seconds(
        lambda: stretch.wsola_stretch_at_rate(x, n, TEMPO, RATE), iters)
    print(f"chain kernel (wsola_stretch_at_rate): {t * 1e3:.3f} ms total, "
          f"{t / K * 1e6:.3f} us/frame", flush=True)

    xp = F.pad(x, (0, max(0, geo["pad_to"] - n)))
    tables = {}
    for fps in (1, 2, 4):
        t = probes.cuda_seconds(
            lambda f=fps: wsola.splice_offsets(xp, *args, frames_per_step=f),
            iters)
        print(f"fps={fps}: {t * 1e3:.3f} ms total, {t / K * 1e6:.3f} "
              f"us/frame (score kernel + walk)", flush=True)
        tables[fps] = wsola.wsola_score_table(xp, *args, frames_per_step=fps)
    for fps in (2, 4):
        print(f"table fps={fps} == fps=1: "
              f"{bool(torch.equal(tables[fps], tables[1]))}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
