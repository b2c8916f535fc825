"""Tensor parallelism: the reverb's convolution sharded across its width
(port of nodey_tpu.parallel.tp).

The sp mesh (parallel/sharded.py) splits the TIME axis; tp splits the WIDE
axis of one op: the frequency bins of the convolution reverb's partitioned
real-DFT convolution (ops/reverb.py, F = 4096, 2049 bins, K IR
partitions). One process runs the tp shards stage by stage, and a
collective is a function over the list of the shards' tensors
(parallel/ops.py):

1. **Forward DFT**: the analysis bases [F, BINS] shard on their bin
   columns (zero-padded to a multiple of tp); each shard computes its
   bins' slice of Xr and Xi.
2. **Frequency-domain delay line**: Hr and Hi shard on bins; the K shifted
   multiply-adds are per bin, so a shard needs nothing of another. Each
   shard runs the unsharded op's forward GEMMs and delay line
   (``ops.reverb._spectrum``) on its columns, so the delay line takes 4 K
   launches a shard.
3. **all_gather** of the shards' Yr and Yi slices: the full spectrum.
4. **Inverse DFT**: the stacked inverse basis [2 * BINS, F], zero-row-padded
   to the gathered [Yr_pad | Yi_pad] layout, shards on its OUTPUT sample
   columns; each shard computes its samples from the full spectrum.
5. **all_gather** of the output samples.

The decomposition adds no approximation: the gathers only move data and
the pad columns and rows contribute exact zeros. But the per-shard GEMMs
have other shapes than the unsharded ones, and a BLAS (cuBLAS or the CPU's)
may associate a dot product's sum otherwise at another shape, so the
result equals the unsharded convolution to float32 rounding, not bitwise.
On one CPU thread that is >= 130 dB and max-abs <= 1e-6 of the peak (the
JAX package's bar, tests/test_torch_tp.py). cuBLAS's float32 GEMMs are
coarser: on the card the unsharded conv itself is 116-126 dB from the
float64 convolution, so chip_smoke.py holds each render against float64,
the sharded one no worse than the unsharded one. GEMMs are full float32
(``scans._gemm``).
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nodey_tpu_torch.ops import reverb as reverb_ops
from nodey_tpu_torch.ops import scans
from nodey_tpu_torch.ops.scans import f32 as _f32
from nodey_tpu_torch.parallel.mesh import Mesh
from nodey_tpu_torch.parallel.ops import all_gather, to_device


def _padded_bins(tp: int) -> int:
    return -(-reverb_ops._BINS // tp) * tp


@functools.lru_cache(maxsize=8)
def _tp_mats(tp: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(cos, -sin) forward bases zero-padded on the bin axis to a tp
    multiple, and the inverse basis zero-ROW-padded to match the gathered
    [2 * BINS_pad] spectrum layout [Yr_pad | Yi_pad]."""
    cos_m, msin_m = reverb_ops._fwd_mats()
    bins = reverb_ops._BINS
    pad = _padded_bins(tp) - bins
    cos_p = np.pad(cos_m, ((0, 0), (0, pad)))
    msin_p = np.pad(msin_m, ((0, 0), (0, pad)))
    inv = reverb_ops._inv_mat()                       # [2*BINS, F]
    inv_p = np.concatenate([
        np.pad(inv[:bins], ((0, pad), (0, 0))),       # Yr rows
        np.pad(inv[bins:], ((0, pad), (0, 0))),       # Yi rows
    ], axis=0)                                        # [2*bins_pad, F]
    return cos_p, msin_p, inv_p


@functools.lru_cache(maxsize=32)
def _shard_mats(tp: int, index: int, device: torch.device):
    """Shard ``index`` of tp's bases on ``device``: its bin columns of the
    forward pair [F, bins_pad / tp] and its output columns of the inverse
    basis [2 * bins_pad, F / tp], contiguous."""
    cos_p, msin_p, inv_p = _tp_mats(tp)
    bl = cos_p.shape[1] // tp
    fl = reverb_ops._F // tp
    return tuple(
        torch.from_numpy(np.ascontiguousarray(m)).to(device)
        for m in (cos_p[:, index * bl:(index + 1) * bl],
                  msin_p[:, index * bl:(index + 1) * bl],
                  inv_p[:, index * fl:(index + 1) * fl]))


def _tp_operands(hr, hi, devices: Sequence[torch.device]):
    """Per shard of ``devices`` (the tp axis): (cos_l, msin_l, hr_l, hi_l,
    inv_l) on its device, the partition spectra [C, K, BINS] (numpy or
    tensors) zero-padded on bins and cut to the shard's bins."""
    tp = len(devices)
    pad = _padded_bins(tp) - reverb_ops._BINS
    bl = _padded_bins(tp) // tp
    hr, hi = (F.pad(torch.as_tensor(h), (0, pad)) for h in (hr, hi))
    out = []
    for index, dev in enumerate(devices):
        cos_l, msin_l, inv_l = _shard_mats(tp, index, torch.device(dev))
        hr_l, hi_l = (to_device(h[..., index * bl:(index + 1) * bl]
                                .contiguous(), dev) for h in (hr, hi))
        out.append((cos_l, msin_l, hr_l, hi_l, inv_l))
    return out


def _check_tp(tp: int) -> None:
    if reverb_ops._F % tp:
        raise ValueError(f"tp={tp} must divide F={reverb_ops._F}")


def partitioned_conv_tp(x: torch.Tensor, hr, hi, out_len: int, mesh: Mesh,
                        axis: str = "tp") -> torch.Tensor:
    """``ops.reverb.partitioned_conv`` with the bin and sample axes sharded
    over ``mesh[axis]`` (see the module docstring).

    ``x`` [C, N] (a tensor on any device, or numpy); ``hr``, ``hi`` the
    partition spectra [C, K, BINS] (numpy or tensors). Returns [C,
    out_len] on the first shard's device."""
    devices = mesh.axis_devices(axis)
    tp = len(devices)
    _check_tp(tp)
    x = torch.as_tensor(x)
    t = -(-out_len // reverb_ops.PARTITION)
    need = t * reverb_ops.PARTITION
    n = x.shape[-1]
    x = F.pad(x, (0, need - n)) if need > n else x[..., :need]
    seg = reverb_ops._segments(x)                     # [C, T, F]
    y = _conv_local([to_device(seg, d) for d in devices],
                    _tp_operands(hr, hi, devices))
    c = x.shape[0]
    out = y[..., reverb_ops.PARTITION:].reshape(c, t * reverb_ops.PARTITION)
    return out[:, :out_len]


def _conv_local(segs: List[torch.Tensor], operands,
                clips: bool = False) -> torch.Tensor:
    """The tp shards' body of the partitioned convolution, stage by stage
    with the two gathers between (module-level so the dp x sp x tp
    composition, parallel/dp_sp_tp.py, runs the same math on each dp
    shard's clips).

    ``segs``: the overlap-save segments [.., C, T, F] on each shard's
    device; ``operands``: ``_tp_operands``' per-shard tuples. With
    ``clips``, the first axis holds a batch's clips and each GEMM runs clip
    by clip on one clip's shapes. Returns the gathered [.., C, T, F] on
    the first shard's device."""
    planes = [reverb_ops._spectrum(seg, cos_l, msin_l, hr_l, hi_l, clips)
              for seg, (cos_l, msin_l, hr_l, hi_l, _inv_l)
              in zip(segs, operands)]
    # Gather every shard's bins: [.., T, 2, bins_pad] is [Yr_pad | Yi_pad].
    spectra = all_gather(planes, dim=-1)
    del planes
    outs = []
    for spec, (_c, _m, _hr, _hi, inv_l) in zip(spectra, operands):
        full = spec.reshape(*spec.shape[:-2], -1)
        # This shard's output sample columns, from the full spectrum.
        outs.append(scans._gemm(full, inv_l, clips))
    del spectra
    return all_gather(outs, dim=-1)[0]


def reverb_tp(x: torch.Tensor, rate: int, decay_s: float, pre_delay_ms: float,
              damping: float, wet: float, dry: float, mesh: Mesh,
              axis: str = "tp"):
    """The reverb node's wet/dry law (ops/reverb.reverb_stream, tail growth
    included) with the convolution tensor-parallel over ``mesh[axis]``.
    Returns (out [C, n + the IR's partitions], valid length n + L - 1) on
    the first shard's device."""
    x = torch.as_tensor(x)
    channels, n = x.shape
    hr, hi, _ln = reverb_ops.ir_partitions(
        rate, channels, float(decay_s), float(pre_delay_ms), float(damping))
    ln_total = reverb_ops.ir_length(rate, decay_s, pre_delay_ms)
    cap_out = n + -(-ln_total // reverb_ops.PARTITION) * reverb_ops.PARTITION
    wetpath = partitioned_conv_tp(x, hr, hi, cap_out, mesh, axis)
    drypath = F.pad(to_device(x, wetpath.device), (0, cap_out - n))
    return _f32(dry) * drypath + _f32(wet) * wetpath, n + ln_total - 1
