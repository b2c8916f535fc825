"""Wrapper of the CUDA WSOLA splice-chain kernel (``csrc/wsola_chain.cu``).

Replaces ``nodey_tpu/ops/pallas_wsola.py::_wsola_chain_pallas_impl`` on
the card through both of its entries: the offline one
(``wsola_chain_assemble_pallas``, ``wsola_chain_cuda`` here) and the chunk
one of the streaming WSOLA step (``wsola_chunk_chain_pallas``,
``wsola_chunk_chain_cuda`` here). The chain is serial over frames, so the
kernel is one CTA that loops over the frames it is given; its source says
what bounds it and what its design does about that. Its plain PyTorch
versions are ``nodey_tpu_torch.ops.wsola.wsola_chain_plain`` and
``wsola_chunk_chain_plain``, which the CPU path and ``chip_smoke.py`` use;
on a CUDA tensor nothing else runs.

The offline entry is the chunk entry at ``k0 = base = 0``: both go
through the library's one C entry, and ``launches`` counts the kernel's
launches made through either.
"""

from __future__ import annotations

import torch

from nodey_tpu_torch.ops import _build
from nodey_tpu_torch.ops.wsola import check_window

# Launches of the kernel, offline and in streaming chunk steps.
launches = 0


def _check(x: torch.Tensor, head: torch.Tensor, K: int, num: int, den: int,
           seq: int, seek: int, overlap: int, k0: int, base: int):
    """Refuse what the kernel does not take; returns the library."""
    if not (x.is_cuda and head.is_cuda and x.device == head.device):
        raise ValueError(
            f"WSOLA kernel needs x and head on one CUDA device, got "
            f"{x.device} and {head.device}"
        )
    if x.dtype != torch.float32 or head.dtype != torch.float32:
        raise ValueError(
            f"WSOLA kernel takes float32, got {x.dtype} and {head.dtype}"
        )
    if x.dim() != 2 or tuple(head.shape) != (x.shape[0], overlap):
        raise ValueError(
            f"WSOLA kernel needs x [C, N] and head [C, {overlap}], got "
            f"{tuple(x.shape)} and {tuple(head.shape)}"
        )
    if x.shape[1] > 1 and x.stride(1) != 1:
        raise ValueError("WSOLA kernel needs x's rows contiguous")
    if not (0 < overlap < seq and seek >= 0 and num > 0 and den > 0 and K >= 0
            and k0 >= 0):
        raise ValueError(
            f"WSOLA kernel: bad geometry seq={seq} seek={seek} "
            f"overlap={overlap} num={num} den={den} K={K} k0={k0}"
        )
    check_window(x, K, num, den, seq, seek, k0=k0, base=base)
    if K >= 2**31:
        raise ValueError(f"WSOLA kernel: {K} frames, more than an int32 holds")
    lib = _build.load_library("wsola_chain")
    smem = lib.nodey_wsola_smem_bytes(x.shape[0], seek + seq, overlap)
    if smem > _build.SMEM_LIMIT:
        raise ValueError(
            f"WSOLA kernel: {x.shape[0]} channels of a {seek + seq}-sample "
            f"window need {smem} bytes of shared memory (max "
            f"{_build.SMEM_LIMIT})"
        )
    return lib


def wsola_chunk_chain_cuda(x: torch.Tensor, head: torch.Tensor, k0: int,
                           base: int, K: int, num: int, den: int, seq: int,
                           seek: int, overlap: int):
    """``(bs int32 [K], body float32 [C, K*(seq - overlap)], tail_out
    float32 [C, overlap])`` of frames k0 .. k0+K-1 of the chain, each
    reading ``x`` from column ``frame_pos(k0 + i) - base``, frame k0's tail
    being ``head``. ``tail_out`` is the tail realized after the last frame.
    ``x`` [C, N] may be a column slice of a wider buffer (its rows need only
    be contiguous) and must cover every frame's window. ``K == 0`` launches
    nothing and returns ``head`` as the tail."""
    global launches
    lib = _check(x, head, K, num, den, seq, seek, overlap, k0, base)
    C = x.shape[0]
    bs = torch.empty(K, dtype=torch.int32, device=x.device)
    body = torch.empty((C, K * (seq - overlap)), dtype=torch.float32,
                       device=x.device)
    if K == 0 or C == 0:
        return bs, body, head
    head = head.contiguous()
    tail_out = torch.empty_like(head)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.nodey_wsola_chain(
            x.data_ptr(), head.data_ptr(), bs.data_ptr(), body.data_ptr(),
            tail_out.data_ptr(), C, x.stride(0), K, k0, base, num, den, seq,
            seek, overlap, stream,
        )
    _build.check_launch(lib, rc, "WSOLA kernel")
    launches += 1
    return bs, body, tail_out


def wsola_chain_cuda(x: torch.Tensor, head: torch.Tensor, K: int, num: int,
                     den: int, seq: int, seek: int, overlap: int):
    """``(bs int32 [K], body float32 [C, K*(seq - overlap)])`` of the greedy
    WSOLA chain over ``x`` [C, N], frame 0's tail being ``head``
    [C, overlap]: the chunk entry at ``k0 = base = 0``. ``x`` must cover
    frame K-1's window."""
    return wsola_chunk_chain_cuda(x, head, 0, 0, K, num, den, seq, seek,
                                  overlap)[:2]
