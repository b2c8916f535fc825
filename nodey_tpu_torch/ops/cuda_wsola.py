"""Wrapper of the CUDA WSOLA splice-chain kernel and its energy prologue
(``csrc/wsola_chain.cu``).

Replaces ``nodey_tpu/ops/pallas_wsola.py::_wsola_chain_pallas_impl`` on
the card through both of its entries: the offline one
(``wsola_chain_assemble_pallas``, ``wsola_chain_cuda`` here) and the chunk
one of the streaming WSOLA step (``wsola_chunk_chain_pallas``,
``wsola_chunk_chain_cuda`` here). The chain is serial over frames, so the
chain kernel is one CTA that loops over the frames it is given; the
candidates' energies do not depend on the chain, so a parallel prologue
kernel computes their normalizers first (``wsola_energy_cuda``). The
source says what bounds each and what the design does about it. Their
plain PyTorch versions are ``nodey_tpu_torch.ops.wsola.wsola_chain_plain``,
``wsola_chunk_chain_plain`` and ``wsola_energy_plain``, which the CPU path
and ``chip_smoke.py`` use; on a CUDA tensor nothing else runs.

The offline entry is the chunk entry at ``k0 = base = 0``. Either walks its
frames in blocks of ``BLOCK_FRAMES``: the prologue over the block, then the
chain over it from the previous block's tail, so the prologue's scratch
stays bounded whatever the clip's length and nothing synchronizes. Both
take a batch of clips, ``x`` [B, C, N] with ``head`` [B, C, overlap]: the
chain kernel runs one CTA per clip (each its own serial loop) and the
prologue a (frames, clips) grid, so a block is still one prologue and one
chain launch whatever B is. The streaming chunk steps pass one clip.
``launches`` counts the chain kernel's launches made through either entry,
``energy_launches`` the prologue's.
"""

from __future__ import annotations

import torch

from nodey_tpu_torch.ops import _build
from nodey_tpu_torch.ops.wsola import check_window

# Launches of the chain kernel, offline and in streaming chunk steps, and of
# the energy prologue.
launches = 0
energy_launches = 0

# Frames of one prologue + chain launch pair: bounds the prologue's table to
# BLOCK_FRAMES x (seek + 1) floats (11.8 MB at 48 kHz).
BLOCK_FRAMES = 4096


def _check(x: torch.Tensor, K: int, num: int, den: int, seq: int, seek: int,
           overlap: int, k0: int, base: int):
    """Refuse what the kernels do not take; returns the library."""
    if not x.is_cuda:
        raise ValueError(f"WSOLA kernels need x on a CUDA device, got {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"WSOLA kernels take float32, got {x.dtype}")
    if x.dim() not in (2, 3):
        raise ValueError(f"WSOLA kernels need x [C, N] or [B, C, N], got "
                         f"{tuple(x.shape)}")
    if x.shape[-1] > 1 and x.stride(-1) != 1:
        raise ValueError("WSOLA kernels need x's rows contiguous")
    if not (0 < overlap < seq and seek >= 0 and num > 0 and den > 0 and K >= 0
            and k0 >= 0):
        raise ValueError(
            f"WSOLA kernel: bad geometry seq={seq} seek={seek} "
            f"overlap={overlap} num={num} den={den} K={K} k0={k0}"
        )
    check_window(x, K, num, den, seq, seek, k0=k0, base=base)
    if K >= 2**31:
        raise ValueError(f"WSOLA kernel: {K} frames, more than an int32 holds")
    if x.dim() == 3 and x.shape[0] > 65535:
        raise ValueError(f"WSOLA kernel: {x.shape[0]} clips, more than a "
                         f"grid holds")
    lib = _build.load_library("wsola_chain")
    if lib.nodey_wsola_threads(seek) > 1024:
        raise ValueError(f"WSOLA kernel: {seek + 1} candidates need more than "
                         f"1024 threads")
    C = x.shape[-2]
    smem = max(lib.nodey_wsola_smem_bytes(C, seq, seek, overlap),
               lib.nodey_wsola_energy_smem_bytes(C, seek, overlap))
    if smem > _build.SMEM_LIMIT:
        raise ValueError(
            f"WSOLA kernel: {C} channels of a {seek + seq}-sample "
            f"window need {smem} bytes of shared memory (max "
            f"{_build.SMEM_LIMIT})"
        )
    return lib


def _clips(x: torch.Tensor):
    """``(clips, x's clip stride)``: one clip, stride 0, for x [C, N]."""
    return (x.shape[0], x.stride(0)) if x.dim() == 3 else (1, 0)


def _energy(lib, x: torch.Tensor, k0: int, base: int, K: int, num: int,
            den: int, seek: int, overlap: int, out: torch.Tensor) -> None:
    """Launch the prologue for frames k0 .. k0+K-1 of every clip into
    ``out`` [K, seek+1] (a batch: [B, rows, seek+1], rows >= K)."""
    global energy_launches
    clips, x_clip = _clips(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.nodey_wsola_energy(
            x.data_ptr(), x.stride(-2), x.shape[-2], K, k0, base, num, den,
            seek, overlap, out.data_ptr(), clips, x_clip,
            out.stride(0) if out.dim() == 3 else 0, stream)
    _build.check_launch(lib, rc, "WSOLA energy prologue")
    energy_launches += 1


def wsola_energy_cuda(x: torch.Tensor, k0: int, base: int, K: int, num: int,
                      den: int, seq: int, seek: int,
                      overlap: int) -> torch.Tensor:
    """float32 [K, seek+1]: ``1 / sqrtf(energy + 1e-9)`` of every candidate
    of frames k0 .. k0+K-1, each frame reading ``x`` from column
    ``frame_pos(k0 + i) - base`` (one prologue launch; what the chain kernel
    reads in place of summing energies itself). A batch ``x`` [B, C, N]
    gives [B, K, seek+1] from the same one launch."""
    lib = _check(x, K, num, den, seq, seek, overlap, k0, base)
    inv = torch.empty((*x.shape[:-2], K, seek + 1), dtype=torch.float32,
                      device=x.device)
    if K and x.shape[-2] and inv.numel():
        _energy(lib, x, k0, base, K, num, den, seek, overlap, inv)
    return inv


def wsola_chunk_chain_cuda(x: torch.Tensor, head: torch.Tensor, k0: int,
                           base: int, K: int, num: int, den: int, seq: int,
                           seek: int, overlap: int):
    """``(bs int32 [K], body float32 [C, K*(seq - overlap)], tail_out
    float32 [C, overlap])`` of frames k0 .. k0+K-1 of the chain, each
    reading ``x`` from column ``frame_pos(k0 + i) - base``, frame k0's tail
    being ``head``. ``tail_out`` is the tail realized after the last frame.
    ``x`` [C, N] may be a column slice of a wider buffer (its rows need only
    be contiguous) and must cover every frame's window. ``K == 0`` launches
    nothing and returns ``head`` as the tail. A batch ``x`` [B, C, N] with
    ``head`` [B, C, overlap] gives ``(bs [B, K], body [B, C, K*stride],
    tail_out [B, C, overlap])``, every clip's chain in the same launches."""
    global launches
    lib = _check(x, K, num, den, seq, seek, overlap, k0, base)
    if not (head.is_cuda and head.device == x.device
            and head.dtype == torch.float32):
        raise ValueError(
            f"WSOLA kernel needs x and head on one CUDA device in float32, "
            f"got {x.device} and {head.device} ({head.dtype})"
        )
    lead = tuple(x.shape[:-2])
    if tuple(head.shape) != (*lead, x.shape[-2], overlap):
        raise ValueError(
            f"WSOLA kernel needs x [C, N] and head [C, {overlap}] (or x "
            f"[B, C, N] and head [B, C, {overlap}]), got {tuple(x.shape)} and "
            f"{tuple(head.shape)}"
        )
    C, stride = x.shape[-2], seq - overlap
    clips, x_clip = _clips(x)
    bs = torch.empty((*lead, K), dtype=torch.int32, device=x.device)
    body = torch.empty((*lead, C, K * stride), dtype=torch.float32,
                       device=x.device)
    if K == 0 or C == 0 or clips == 0:
        return bs, body, head
    head = head.contiguous()
    tail_out = torch.empty_like(head)
    n_max = min(K, BLOCK_FRAMES)
    inv = torch.empty((*lead, n_max, seek + 1), dtype=torch.float32,
                      device=x.device)
    for start in range(0, K, BLOCK_FRAMES):
        n = min(BLOCK_FRAMES, K - start)
        _energy(lib, x, k0 + start, base, n, num, den, seek, overlap, inv)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = lib.nodey_wsola_chain(
                x.data_ptr(), (head if start == 0 else tail_out).data_ptr(),
                inv.data_ptr(), bs[..., start:].data_ptr(),
                body[..., start * stride :].data_ptr(), body.stride(-2),
                tail_out.data_ptr(), C, x.stride(-2), n, k0 + start, base,
                num, den, seq, seek, overlap, clips, x_clip,
                n_max * (seek + 1), K, C * K * stride, stream,
            )
        _build.check_launch(lib, rc, "WSOLA kernel")
        launches += 1
    return bs, body, tail_out


def wsola_chain_cuda(x: torch.Tensor, head: torch.Tensor, K: int, num: int,
                     den: int, seq: int, seek: int, overlap: int):
    """``(bs int32 [K], body float32 [C, K*(seq - overlap)])`` of the greedy
    WSOLA chain over ``x`` [C, N], frame 0's tail being ``head``
    [C, overlap]: the chunk entry at ``k0 = base = 0``. ``x`` must cover
    frame K-1's window. A batch (``x`` [B, C, N], ``head`` [B, C,
    overlap]) gives ``(bs [B, K], body [B, C, K*stride])``."""
    return wsola_chunk_chain_cuda(x, head, 0, 0, K, num, den, seq, seek,
                                  overlap)[:2]
