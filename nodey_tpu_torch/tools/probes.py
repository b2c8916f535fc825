"""Measurement functions for the card, for the port's benchmark to reuse.

- ``wsola_step_overhead``: the fixed cost of one step of the serial WSOLA
  chain, as ``bench.py::_wsola_step_overhead`` measures it on the TPU: the
  bare and dma step probes (``ops/cuda_probes.py``, their bench.py forms)
  timed at K 2048 and 4096, and the K-slope ``(t(4096) - t(2048)) / 2048``,
  in which the launch's own cost cancels.
- ``resample_ab``: the resampler's A/B of ``bench.py``'s pallas-ab section
  (``bench.py:449-476``): ``resample.resample_data`` (on the card the
  polyphase kernel, the counterpart of ``resample_data_pallas``) against
  its plain version, beside one ``F.conv1d`` with the same bank as the
  library yardstick.

Times are CUDA events (``cuda_seconds``); both take a ``device`` and a
``timer``, which a test replaces to run the arithmetic on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from nodey_tpu_torch.ops import cuda_probes, stretch
from nodey_tpu_torch.ops import resample as resample_ops

LANE = cuda_probes.LANE
STEP_KS = (2048, 4096)
DMA_COLUMNS = 1 << 20       # the dma probe's x: [2, 2^20], as bench.py's


def span_dma(rate: int = 48_000) -> int:
    """The TPU chain kernel's window width at ``rate``
    (``pallas_wsola._geometry``'s padded span + 128): 1280 at 48 kHz."""
    _seq, seek, overlap = stretch._params(rate)
    rows = -(-(seek + 1) // LANE) * LANE
    span = rows - 1 + overlap
    return -(-span // LANE) * LANE + LANE


def cuda_seconds(fn, iters: int) -> float:
    """Seconds per call of ``fn``: CUDA events around ``iters``
    back-to-back calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def k_slope(seconds_at, ks=STEP_KS) -> float:
    """Seconds per step, ``(t(k2) - t(k1)) / (k2 - k1)`` with ``t =
    seconds_at(K)``, at least 1e-9 (bench.py's floor)."""
    k1, k2 = ks
    t1 = seconds_at(k1)
    t2 = seconds_at(k2)
    return max((t2 - t1) / (k2 - k1), 1e-9)


def wsola_step_overhead(iters: int = 8, device="cuda", timer=cuda_seconds):
    """``(bare_s, dma_s)``: seconds per step of the bare probe (out[k] per
    step) and of the dma probe (3-slot ring, one-step prefetch, the 48 kHz
    window width) by K-slope."""
    block = torch.zeros(cuda_probes.BLOCK, device=device)
    wide = torch.zeros((2, DMA_COLUMNS), device=device)
    span = span_dma()
    bare = k_slope(lambda K: timer(
        lambda: cuda_probes.step_probe_bare(block, K, per_step=True), iters))
    dma = k_slope(lambda K: timer(
        lambda: cuda_probes.step_probe_dma(wide, K, span, ring=True), iters))
    return bare, dma


def resample_ab(rate_in: int, rate_out: int, seconds: float, iters: int = 10,
                device="cuda", timer=cuda_seconds) -> dict:
    """The A/B on a stereo clip of ``seconds`` at ``rate_in`` (0.3 * N(0, 1),
    seed 0): milliseconds per call of ``resample_data`` (``kernel_ms``), of
    its plain version on the same padded input (``plain_ms``) and of one
    ``F.conv1d(x, bank, stride=M)`` (``conv1d_ms``, TF32 off), timed in
    turns (plain, conv1d, kernel, kernel, conv1d, plain; the mean of each
    pair), and ``max_diff``, max|resample_data - plain|."""
    n = int(rate_in * seconds)
    rng = np.random.default_rng(0)
    data = torch.from_numpy(
        (0.3 * rng.standard_normal((2, n))).astype(np.float32)).to(device)
    x, G, M, W, bank, _ = resample_ops.bank_operands(data, rate_in, rate_out)
    L = bank.shape[0]
    n_out = -(-n * L // M)
    fns = {
        "kernel": lambda: resample_ops.resample_data(data, rate_in, rate_out),
        "plain": lambda: resample_ops.apply_filter_bank_plain(
            x, G, M, W, bank)[:, :n_out],
        "conv1d": lambda: F.conv1d(x.view(2, 1, -1), bank.view(L, 1, W),
                                   stride=M),
    }
    max_diff = (fns["kernel"]() - fns["plain"]()).abs().max().item()
    ms = dict.fromkeys(fns, 0.0)
    for name in ("plain", "conv1d", "kernel", "kernel", "conv1d", "plain"):
        ms[name] += timer(fns[name], iters) * 1e3 / 2
    return {"kernel_ms": ms["kernel"], "plain_ms": ms["plain"],
            "conv1d_ms": ms["conv1d"], "max_diff": max_diff}
