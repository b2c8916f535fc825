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

import math

import numpy as np
import torch

from nodey_tpu_torch.ops import _build

# Launches through phase_path_cuda and lock_to_peaks_cuda.
phase_path_launches = 0
lock_launches = 0

# The card allows 227 KB of shared memory per block.
_SMEM_LIMIT = 227 * 1024


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


def _raise_on(lib, rc: int, what: str):
    if rc != 0:
        raise RuntimeError(
            f"{what} launch failed: "
            f"{lib.nodey_cuda_error_string(rc).decode()} (cudaError {rc})")


def phase_path_cuda(re: torch.Tensor, im: torch.Tensor, dpos, hop: int,
                    n_fft: int, lock: bool = True):
    """``(mag*cos_phi, mag*sin_phi)`` [C, K, B] from the forward-DFT planes
    ``re``, ``im`` [C, K, B = n_fft//2 + 1] and the integer analysis hops
    ``dpos`` [K] (dpos[0] unused), with or without the identity lock."""
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
    # (b * dpos) and (b * hop) are formed in int32.
    if (B - 1) * max(int(dpos.max(initial=0)), hop) >= 2**31:
        raise ValueError(f"{what}: hops too long for int32 bin products")
    if 9 * 4 * B > _SMEM_LIMIT:  # seven float rows and two int rows
        raise ValueError(f"{what}: {B} bins need more shared memory than a "
                         f"block has")
    ry = torch.empty_like(re)
    iy = torch.empty_like(re)
    if ry.numel() == 0:
        return ry, iy
    lib = _build.load_library("pv_phase_path")
    dpos_t = torch.from_numpy(dpos.astype(np.int32)).to(re.device)
    scratch = torch.empty(lib.nodey_pv_phase_scratch_floats(C, K, B),
                          dtype=torch.float32, device=re.device)
    with torch.cuda.device(re.device):
        stream = torch.cuda.current_stream(re.device).cuda_stream
        rc = lib.nodey_pv_phase_path(
            re.data_ptr(), im.data_ptr(), dpos_t.data_ptr(), ry.data_ptr(),
            iy.data_ptr(), scratch.data_ptr(), C, K, B, hop, n_fft,
            int(bool(lock)), float(np.float32(2.0 * math.pi / n_fft)),
            2.0 * math.pi / n_fft, stream)
    _raise_on(lib, rc, what)
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
    if lib.nodey_pv_lock_smem_bytes(B) > _SMEM_LIMIT:
        raise ValueError(f"{what}: {B} bins need more shared memory than a "
                         f"block has")
    with torch.cuda.device(mag.device):
        stream = torch.cuda.current_stream(mag.device).cuda_stream
        rc = lib.nodey_pv_lock(
            cos_phi.data_ptr(), sin_phi.data_ptr(), ph_in.data_ptr(),
            mag.data_ptr(), oc.data_ptr(), os_.data_ptr(), C * K, B, stream)
    _raise_on(lib, rc, what)
    lock_launches += 1
    return oc, os_
