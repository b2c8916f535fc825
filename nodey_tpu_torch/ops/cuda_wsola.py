"""Wrapper of the CUDA WSOLA splice-chain kernel (``csrc/wsola_chain.cu``).

Replaces ``nodey_tpu/ops/pallas_wsola.py::_wsola_chain_pallas_impl``
(through ``wsola_chain_assemble_pallas``) on the card. The chain is serial
over frames, so the kernel is one CTA per clip that loops over all frames;
its source says what bounds it and what its design does about that. Its
plain PyTorch version is ``nodey_tpu_torch.ops.wsola.wsola_chain_plain``,
which the CPU path and ``chip_smoke.py`` use; on a CUDA tensor nothing
else runs.

``launches`` counts the kernel's launches made through this wrapper.
"""

from __future__ import annotations

import torch

from nodey_tpu_torch.ops import _build
from nodey_tpu_torch.ops.wsola import check_window

# Launches of the kernel through wsola_chain_cuda.
launches = 0

# The card allows 227 KB of shared memory per block.
_SMEM_LIMIT = 227 * 1024


def wsola_chain_cuda(x: torch.Tensor, head: torch.Tensor, K: int, num: int,
                     den: int, seq: int, seek: int, overlap: int):
    """``(bs int32 [K], body float32 [C, K*(seq - overlap)])`` of the greedy
    WSOLA chain over ``x`` [C, N], frame 0's tail being ``head``
    [C, overlap]. ``x`` must cover frame K-1's window."""
    global launches
    if not (x.is_cuda and head.is_cuda and x.device == head.device):
        raise ValueError(
            f"WSOLA kernel needs x and head on one CUDA device, got "
            f"{x.device} and {head.device}"
        )
    if x.dtype != torch.float32 or head.dtype != torch.float32:
        raise ValueError(
            f"WSOLA kernel takes float32, got {x.dtype} and {head.dtype}"
        )
    if not x.is_contiguous():
        raise ValueError("WSOLA kernel needs a contiguous x")
    if x.dim() != 2 or tuple(head.shape) != (x.shape[0], overlap):
        raise ValueError(
            f"WSOLA kernel needs x [C, N] and head [C, {overlap}], got "
            f"{tuple(x.shape)} and {tuple(head.shape)}"
        )
    if not (0 < overlap < seq and seek >= 0 and num > 0 and den > 0 and K >= 0):
        raise ValueError(
            f"WSOLA kernel: bad geometry seq={seq} seek={seek} "
            f"overlap={overlap} num={num} den={den} K={K}"
        )
    C, N = x.shape
    stride = seq - overlap
    check_window(x, K, num, den, seq, seek)
    if K >= 2**31:
        raise ValueError(f"WSOLA kernel: {K} frames, more than an int32 holds")
    bs = torch.empty(K, dtype=torch.int32, device=x.device)
    body = torch.empty((C, K * stride), dtype=torch.float32, device=x.device)
    if K == 0 or C == 0:
        return bs, body
    head = head.contiguous()
    lib = _build.load_library("wsola_chain")
    smem = lib.nodey_wsola_smem_bytes(C, seek + seq, overlap)
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"WSOLA kernel: {C} channels of a {seek + seq}-sample window need "
            f"{smem} bytes of shared memory (max {_SMEM_LIMIT})"
        )
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.nodey_wsola_chain(
            x.data_ptr(), head.data_ptr(), bs.data_ptr(), body.data_ptr(),
            C, N, K, num, den, seq, seek, overlap, stream,
        )
    if rc != 0:
        raise RuntimeError(
            "WSOLA kernel launch failed: "
            f"{lib.nodey_cuda_error_string(rc).decode()} (cudaError {rc})"
        )
    launches += 1
    return bs, body
