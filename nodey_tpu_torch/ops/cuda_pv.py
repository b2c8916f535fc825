"""Wrappers of the CUDA phase-vocoder kernels (``csrc/pv_phase_path.cu``,
``csrc/pv_lock.cu``).

``phase_path_cuda`` replaces ``nodey_tpu/ops/pallas_phase.py::
phase_path_pallas`` and ``lock_to_peaks_cuda`` replaces
``nodey_tpu/ops/pallas_lock.py::lock_to_peaks_pallas`` on the card; their
sources say what bounds them and what their design does about that. The
plain PyTorch versions are ``nodey_tpu_torch.ops.pv.phase_path_plain`` and
``pv._lock_to_peaks``, which the CPU path and ``chip_smoke.py`` use; on a
CUDA tensor nothing else runs. Both keep the JAX package's [C, K, B]
layout.

``phase_path_launches`` and ``lock_launches`` count the kernels' launches
made through these wrappers (one phase-path launch runs its three passes).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from nodey_tpu_torch.ops import _build

# Launches through phase_path_cuda and lock_to_peaks_cuda.
phase_path_launches = 0
lock_launches = 0


def _check_planes(names, planes, what: str):
    first = planes[0]
    for name, t in zip(names, planes):
        if not (t.is_cuda and t.device == first.device):
            raise ValueError(
                f"{what} needs {', '.join(names)} on one CUDA device, got "
                f"{name} on {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{what} takes float32, got {name} {t.dtype}")
        if t.dim() != 3 or t.shape != first.shape:
            raise ValueError(
                f"{what} needs [C, K, B] planes of one shape, got "
                f"{name} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what} needs contiguous planes ({name})")


def _check_power_of_two(n_fft: int) -> None:
    if n_fft <= 0 or n_fft & (n_fft - 1):
        raise ValueError(f"PV phase-path kernel: n_fft={n_fft} is not a "
                         f"power of two")


def phase_tables(dpos, hop: int, n_fft: int):
    """``(hop_over_dpos [K], omega_hop [B = n_fft//2 + 1])`` float32: the
    per-frame and per-bin constants of the phase advance, exactly the values
    that the plain ``pv._advance`` uses (``float32(hop / dpos)`` in float64,
    and ``((b*hop) mod n_fft) * 2pi/n_fft`` rounded once), for the kernel to
    read instead of computing them per element. Entry 0 of ``hop_over_dpos``
    is unused (1.0). ``n_fft`` must be a power of two: the kernel takes
    ``(b*dpos) mod n_fft`` as ``& (n_fft - 1)``."""
    _check_power_of_two(n_fft)
    dpos = np.asarray(dpos, dtype=np.int64)
    hop_over_dpos = np.ones(dpos.shape, dtype=np.float32)
    hop_over_dpos[1:] = float(hop) / dpos[1:]
    omega_hop = (np.mod(np.arange(n_fft // 2 + 1) * hop, n_fft).astype(
        np.float64) * (2.0 * math.pi / n_fft)).astype(np.float32)
    return hop_over_dpos, omega_hop


@functools.lru_cache(maxsize=8)
def _device_tables(device: str, stream: int, dpos: bytes, hop: int,
                   n_fft: int) -> torch.Tensor:
    """int32 [2K + B] on ``device``: the hops ``dpos`` (int64 bytes), then
    the bits of ``phase_tables``; uploaded from pinned memory without
    waiting for the card, once per geometry and stream (a render calls the
    kernel with the same geometry at every stage; the kernels only read the
    tables, on the stream that uploaded them)."""
    dpos = np.frombuffer(dpos, dtype=np.int64)
    hop_over_dpos, omega_hop = phase_tables(dpos, hop, n_fft)
    K = len(dpos)
    host = torch.empty(2 * K + len(omega_hop), dtype=torch.int32,
                       pin_memory=True)
    tables = host.numpy()
    tables[:K] = dpos
    tables[K : 2 * K] = hop_over_dpos.view(np.int32)
    tables[2 * K :] = omega_hop.view(np.int32)
    return host.to(device, non_blocking=True)


def phase_path_cuda(re: torch.Tensor, im: torch.Tensor, dpos, hop: int,
                    n_fft: int, lock: bool = True):
    """``(mag*cos_phi, mag*sin_phi)`` [C, K, B] from the forward-DFT planes
    ``re``, ``im`` [C, K, B = n_fft//2 + 1] and the integer analysis hops
    ``dpos`` [K] (dpos[0] unused), with or without the identity lock. The
    hops and ``phase_tables`` go up in one copy from pinned memory, once
    per geometry, so the call never waits for the card."""
    global phase_path_launches
    what = "PV phase-path kernel"
    _check_planes(("re", "im"), (re, im), what)
    C, K, B = re.shape
    dpos = np.asarray(dpos, dtype=np.int64)
    if B != n_fft // 2 + 1 or dpos.shape != (K,):
        raise ValueError(
            f"{what}: planes {tuple(re.shape)} and dpos {dpos.shape} do not "
            f"fit n_fft={n_fft}")
    if not (hop > 0 and n_fft > 0 and (K == 0 or dpos[1:].min(initial=1) > 0)):
        raise ValueError(f"{what}: bad geometry hop={hop} n_fft={n_fft}")
    _check_power_of_two(n_fft)
    # (b * dpos) is formed in int32.
    if (B - 1) * int(dpos.max(initial=0)) >= 2**31:
        raise ValueError(f"{what}: hops too long for int32 bin products")
    lib = _build.load_library("pv_phase_path")
    smem = lib.nodey_pv_phase_smem_bytes(B, int(bool(lock)))
    if not 0 <= smem <= _build.SMEM_LIMIT:
        raise ValueError(f"{what}: takes rows of 257 to 4097 bins (n_fft "
                         f"512 to 8192, those of pv_params), got {B}")
    ry = torch.empty_like(re)
    iy = torch.empty_like(re)
    if ry.numel() == 0:
        return ry, iy
    with torch.cuda.device(re.device):
        stream = torch.cuda.current_stream(re.device).cuda_stream
        tables_d = _device_tables(str(re.device), stream, dpos.tobytes(), hop,
                                  n_fft)
        scratch = torch.empty(lib.nodey_pv_phase_scratch_floats(C, K, B),
                              dtype=torch.float32, device=re.device)
        base = tables_d.data_ptr()
        rc = lib.nodey_pv_phase_path(
            re.data_ptr(), im.data_ptr(), base, base + 4 * K, base + 8 * K,
            ry.data_ptr(), iy.data_ptr(), scratch.data_ptr(), C, K, B, n_fft,
            int(bool(lock)), float(np.float32(2.0 * math.pi / n_fft)), stream)
    _build.check_launch(lib, rc, what)
    phase_path_launches += 1
    return ry, iy


def lock_to_peaks_cuda(cos_phi: torch.Tensor, sin_phi: torch.Tensor,
                       ph_in: torch.Tensor, mag: torch.Tensor):
    """Identity phase locking of [C, K, B] phasor planes: ``(oc, os)``."""
    global lock_launches
    what = "PV lock kernel"
    _check_planes(("cos_phi", "sin_phi", "ph_in", "mag"),
                  (cos_phi, sin_phi, ph_in, mag), what)
    C, K, B = mag.shape
    oc = torch.empty_like(mag)
    os_ = torch.empty_like(mag)
    if oc.numel() == 0:
        return oc, os_
    if C * K >= 2**31:
        raise ValueError(f"{what}: {C * K} rows, more than a grid holds")
    lib = _build.load_library("pv_lock")
    if lib.nodey_pv_lock_rows_per_cta(B) == 0:
        raise ValueError(f"{what}: takes rows of 1 to 4097 bins (n_fft up "
                         f"to 8192, those of pv_params), got {B}")
    with torch.cuda.device(mag.device):
        stream = torch.cuda.current_stream(mag.device).cuda_stream
        rc = lib.nodey_pv_lock(
            cos_phi.data_ptr(), sin_phi.data_ptr(), ph_in.data_ptr(),
            mag.data_ptr(), oc.data_ptr(), os_.data_ptr(), C * K, B, stream)
    _build.check_launch(lib, rc, what)
    lock_launches += 1
    return oc, os_
