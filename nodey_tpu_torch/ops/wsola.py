"""The WSOLA greedy splice chain: the plain PyTorch version and dispatch.

For output frames k = 0 .. K-1, frame k reads the input window
``x[:, pos(k) : pos(k) + seek + seq]`` with ``pos(k) = frame_pos(k, num,
den)``. It scores its ONE realized previous tail [C, overlap] against the
seek + 1 candidate offsets b of that window,

    corr[b]   = sum_{c,v} tail[c, v] * w[c, b + v]
    energy[b] = sum_{c,v} w[c, b + v]**2
    score[b]  = corr[b] * rsqrt(energy[b] + 1e-9),

takes the FIRST maximum (as ``np.argmax`` and ``jnp.argmax`` do), and
emits one stride of audio from the chosen segment ``seg = w[:, b : b +
seq]``: ``tail * fade_out + seg * fade_in`` over the first ``overlap``
samples, then ``seg`` up to ``stride = seq - overlap``. The next tail is
``seg[:, stride : stride + overlap]``; frame 0's tail is ``head``.

This is the function of ``nodey_tpu/ops/pallas_wsola.py::
wsola_chain_assemble_pallas`` (``_wsola_chain_pallas_impl`` with
``emit_audio=True``). Its chunk entry ``wsola_chunk_chain_pallas`` runs
frames k0 .. k0+K-1 of the same chain over a FIFO snapshot whose column 0
is input sample ``base``, seeded from a carried tail: that is
``wsola_chunk_chain_plain`` here, which also returns the tail realized
after its last frame (the JAX step slices it out of the snapshot itself).
``wsola_chain`` and ``wsola_chunk_chain`` send a CUDA tensor to the
hand-written kernel (:mod:`nodey_tpu_torch.ops.cuda_wsola`) and a CPU
tensor to the plain versions; neither falls back to the other.

The same chain has a parallel formulation, the score table of
``nodey_tpu/ops/pallas_wsola.py::wsola_score_table``: F[k, p] is the first
best candidate of frame k for the tail that frame k-1's choice p would
realize, ``x[:, frame_pos(k-1) + stride + p :][:, :overlap]`` (frame 0: the
head ``x[:, :overlap]`` for every p), and the walk ``b_k = F[k, b_{k-1}]``
from ``b_{-1} = 0`` (``splice_offsets``) gives the chain's splices. Every
frame's row of the table is independent; only the walk is serial. Here the
table is [K, seek+1] in real order (the JAX table's permuted 128-lane rows
are TPU layout). ``wsola_score_table``, ``walk_table`` and
``splice_offsets`` dispatch as the chain does, to
:mod:`nodey_tpu_torch.ops.cuda_wsola_table` on the card.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from nodey_tpu_torch.core.errors import ProcessorRuntimeError


def frame_pos(k: int, num: int, den: int = 65536) -> int:
    """Input position of output frame k: floor((k*num + den//2) / den).

    Host integers do not overflow; the JAX package's carry-decomposed
    int32 form (``stretch.frame_pos``) gives the same value for every
    k < 8.4M frames."""
    return (k * num + den // 2) // den


def fades(overlap: int, device) -> tuple:
    """``(fade_in, fade_out)`` float32 [overlap]: fade_in = (v + 0.5) /
    overlap by IEEE float32 division (computed in NumPy, because a CUDA
    tensor divided by a Python scalar is multiplied by its reciprocal),
    fade_out = 1 - fade_in. The kernel computes the same values."""
    fade_in = ((np.arange(overlap, dtype=np.float32) + np.float32(0.5))
               / np.float32(overlap))
    fade_out = np.float32(1.0) - fade_in
    return (torch.from_numpy(fade_in).to(device),
            torch.from_numpy(fade_out).to(device))


def check_window(x: torch.Tensor, K: int, num: int, den: int, seq: int,
                 seek: int, k0: int = 0, base: int = 0) -> None:
    """Raise unless every window of frames k0 .. k0+K-1, read from column
    ``frame_pos(k) - base`` of ``x``, lies inside ``x``."""
    if K <= 0:
        return
    first = frame_pos(k0, num, den) - base
    need = frame_pos(k0 + K - 1, num, den) - base + seek + seq
    if first < 0 or x.shape[1] < need:
        raise ValueError(
            f"WSOLA chain: x has {x.shape[1]} samples from input sample "
            f"{base}, frames {k0}..{k0 + K - 1}'s window reads columns "
            f"{first}..{need}"
        )


def best_offset(cand: torch.Tensor, tail: torch.Tensor,
                ones: torch.Tensor) -> torch.Tensor:
    """0-d int64 tensor: the first argmax over b of the normalized
    cross-correlation of ``tail`` [C, overlap] with ``cand`` [C, seek +
    overlap] (both float32; ``ones`` is [1, C, overlap])."""
    corr = F.conv1d(cand[None], tail[None])[0, 0]
    energy = F.conv1d((cand * cand)[None], ones)[0, 0]
    return torch.argmax(corr * torch.rsqrt(energy + 1e-9))


def _blend(tail, seg, fade_in, fade_out, overlap: int, stride: int):
    head = tail * fade_out + seg[:, :overlap] * fade_in
    return torch.cat([head, seg[:, overlap:]], dim=1)[:, :stride]


def wsola_chunk_chain_plain(x: torch.Tensor, head: torch.Tensor, k0: int,
                            base: int, K: int, num: int, den: int, seq: int,
                            seek: int, overlap: int):
    """``(bs int32 [K], body float32 [C, K*stride], tail_out [C, overlap])``
    of frames k0 .. k0+K-1 of the greedy chain, one frame at a time in
    Python (see the module docstring): frame k reads ``x`` from column
    ``frame_pos(k) - base``, frame k0's tail is ``head``, and ``tail_out``
    is a fresh tensor holding the tail realized after the last frame
    (``head`` itself when K == 0)."""
    check_window(x, K, num, den, seq, seek, k0=k0, base=base)
    C = x.shape[0]
    stride = seq - overlap
    fade_in, fade_out = fades(overlap, x.device)
    ones = torch.ones((1, C, overlap), dtype=x.dtype, device=x.device)
    bs = []
    body = torch.empty((C, K * stride), dtype=x.dtype, device=x.device)
    tail = head
    for i in range(K):
        pos = frame_pos(k0 + i, num, den) - base
        window = x[:, pos : pos + seek + seq]
        best = int(best_offset(window[:, : seek + overlap], tail, ones))
        seg = window[:, best : best + seq]
        body[:, i * stride : (i + 1) * stride] = _blend(
            tail, seg, fade_in, fade_out, overlap, stride)
        tail = seg[:, stride : stride + overlap]
        bs.append(best)
    return (torch.tensor(bs, dtype=torch.int32, device=x.device), body,
            tail.clone() if K else head)


def wsola_chain_plain(x: torch.Tensor, head: torch.Tensor, K: int, num: int,
                      den: int, seq: int, seek: int, overlap: int):
    """``(bs int32 [K], body float32 [C, K*stride])`` of the whole chain
    (frames 0 .. K-1 of ``x`` [C, N], which must cover frame K-1's
    window)."""
    bs, body, _ = wsola_chunk_chain_plain(x, head, 0, 0, K, num, den, seq,
                                          seek, overlap)
    return bs, body


def replay_decisions(x: torch.Tensor, head: torch.Tensor, bs, K: int,
                     num: int, den: int, seq: int, seek: int, overlap: int,
                     k0: int = 0, base: int = 0) -> torch.Tensor:
    """int64 [K]: the plain scoring of every frame given the chain's own
    choice for the frame before it (frame k0 scores ``head``), frames and
    columns as in ``wsola_chunk_chain_plain``. Where a chain's decisions
    are right, this equals ``bs``; a frame where it differs is a decision
    the plain version would have made otherwise."""
    check_window(x, K, num, den, seq, seek, k0=k0, base=base)
    C = x.shape[0]
    stride = seq - overlap
    bs = [int(b) for b in bs]
    ones = torch.ones((1, C, overlap), dtype=x.dtype, device=x.device)
    picks = []
    tail = head
    for i in range(K):
        pos = frame_pos(k0 + i, num, den) - base
        picks.append(best_offset(x[:, pos : pos + seek + overlap], tail, ones))
        start = pos + bs[i] + stride
        tail = x[:, start : start + overlap]
    return torch.stack(picks) if picks else torch.empty(0, dtype=torch.int64)


def assemble_plain(x: torch.Tensor, head: torch.Tensor, bs, K: int, num: int,
                   den: int, seq: int, seek: int, overlap: int,
                   k0: int = 0, base: int = 0) -> torch.Tensor:
    """float32 [C, K*stride]: the audio a chain with splice choices ``bs``
    emits, by the plain version's blend (frames and columns as in
    ``wsola_chunk_chain_plain``)."""
    check_window(x, K, num, den, seq, seek, k0=k0, base=base)
    C = x.shape[0]
    stride = seq - overlap
    bs = [int(b) for b in bs]
    fade_in, fade_out = fades(overlap, x.device)
    body = torch.empty((C, K * stride), dtype=x.dtype, device=x.device)
    tail = head
    for i in range(K):
        start = frame_pos(k0 + i, num, den) - base + bs[i]
        seg = x[:, start : start + seq]
        body[:, i * stride : (i + 1) * stride] = _blend(
            tail, seg, fade_in, fade_out, overlap, stride)
        tail = seg[:, stride : stride + overlap]
    return body


# Frames scored together by the plain table (bounds its working set:
# ~13 MB a frame at 48 kHz stereo, operands, products and temporaries).
TABLE_CHUNK_FRAMES = 64


def _hankel(x: torch.Tensor, starts, width: int, overlap: int):
    """float32 [C*F, width - overlap + 1, overlap], a fresh tensor: row r of
    frame f is ``x[:, starts[f] + r :][:, :overlap]``, channel-major."""
    cols = (torch.tensor(starts, device=x.device)[:, None]
            + torch.arange(width, device=x.device))
    rows = x[:, cols].unfold(2, overlap, 1)      # [C, F, n, overlap]
    return rows.reshape(-1, width - overlap + 1, overlap).contiguous()


def wsola_scores_plain(x: torch.Tensor, ks, num: int, den: int, seq: int,
                       seek: int, overlap: int) -> torch.Tensor:
    """float32 [len(ks), seek+1, seek+1]: score[f, p, b] of frame ks[f],
    tail row p against candidate b, by ``unfold`` and one ``bmm`` per
    (channel, frame): ``corr * rsqrt(energy + 1e-9)`` with corr and energy
    summed over channels."""
    C = x.shape[0]
    stride, span, n = seq - overlap, seek + overlap, seek + 1
    ks = list(ks)
    cand = _hankel(x, [frame_pos(k, num, den) for k in ks], span, overlap)
    tail = _hankel(x, [frame_pos(k - 1, num, den) + stride if k else 0
                       for k in ks], span, overlap)
    if ks and ks[0] == 0:
        # Frame 0 scores the head for every tail row.
        tail.view(C, len(ks), n, overlap)[:, 0] = x[:, None, :overlap]
    corr = torch.bmm(tail, cand.transpose(1, 2)).view(C, len(ks), n, n).sum(0)
    energy = (cand * cand).sum(2).view(C, len(ks), n).sum(0)
    return corr * torch.rsqrt(energy + 1e-9)[:, None, :]


def wsola_score_table_plain(x: torch.Tensor, K: int, num: int, den: int,
                            seq: int, seek: int, overlap: int) -> torch.Tensor:
    """int32 [K, seek+1]: the score table (see the module docstring), the
    first maximum of each row of ``wsola_scores_plain``, chunked over
    frames. ``x`` [C, N] must cover frame K-1's window."""
    check_window(x, K, num, den, seq, seek)
    table = torch.empty((K, seek + 1), dtype=torch.int32, device=x.device)
    for k0 in range(0, K, TABLE_CHUNK_FRAMES):
        ks = range(k0, min(K, k0 + TABLE_CHUNK_FRAMES))
        scores = wsola_scores_plain(x, ks, num, den, seq, seek, overlap)
        table[k0 : k0 + len(ks)] = torch.argmax(scores, dim=2).int()
    return table


def walk_table_plain(table: torch.Tensor) -> torch.Tensor:
    """int32 [K]: b_k = table[k, b_{k-1}] from b_{-1} = 0, one gather per
    frame on ``table``'s device."""
    bs = torch.empty(table.shape[0], dtype=torch.int32, device=table.device)
    b = torch.zeros(1, dtype=torch.int64, device=table.device)
    for k in range(table.shape[0]):
        b = table[k].gather(0, b).long()
        bs[k : k + 1] = b
    return bs


def splice_offsets_plain(x: torch.Tensor, K: int, num: int, den: int,
                         seq: int, seek: int, overlap: int) -> torch.Tensor:
    """int32 [K]: the chain's splices by the table route, plain."""
    return walk_table_plain(
        wsola_score_table_plain(x, K, num, den, seq, seek, overlap))


def _check_device(x: torch.Tensor) -> None:
    if x.device.type != "cpu":
        raise ProcessorRuntimeError(
            "Unsupported device for time stretching",
            "The WSOLA chain runs on a CUDA card (kernel) or on the CPU.",
            f"device={x.device}",
        )


def wsola_chain(x: torch.Tensor, head: torch.Tensor, K: int, num: int,
                den: int, seq: int, seek: int, overlap: int):
    """``(bs, body)`` of the chain: a CUDA tensor launches the kernel (or
    raises); a CPU tensor takes the plain version."""
    if x.is_cuda:
        from nodey_tpu_torch.ops import cuda_wsola

        return cuda_wsola.wsola_chain_cuda(x, head, K, num, den, seq, seek,
                                           overlap)
    _check_device(x)
    return wsola_chain_plain(x, head, K, num, den, seq, seek, overlap)


def wsola_chunk_chain(x: torch.Tensor, head: torch.Tensor, k0: int, base: int,
                      K: int, num: int, den: int, seq: int, seek: int,
                      overlap: int):
    """``(bs, body, tail_out)`` of frames k0 .. k0+K-1: a CUDA tensor
    launches the kernel's chunk entry (or raises); a CPU tensor takes
    ``wsola_chunk_chain_plain``."""
    if x.is_cuda:
        from nodey_tpu_torch.ops import cuda_wsola

        return cuda_wsola.wsola_chunk_chain_cuda(x, head, k0, base, K, num,
                                                 den, seq, seek, overlap)
    _check_device(x)
    return wsola_chunk_chain_plain(x, head, k0, base, K, num, den, seq, seek,
                                   overlap)


def wsola_score_table(x: torch.Tensor, K: int, num: int, den: int, seq: int,
                      seek: int, overlap: int,
                      frames_per_step: int = 1) -> torch.Tensor:
    """The score table: a CUDA tensor launches the score kernel (each CTA
    scoring ``frames_per_step`` frames in a loop; the table is the same at
    any value), a CPU tensor takes the plain version."""
    if x.is_cuda:
        from nodey_tpu_torch.ops import cuda_wsola_table

        return cuda_wsola_table.wsola_score_table_cuda(
            x, K, num, den, seq, seek, overlap, frames_per_step)
    _check_device(x)
    if frames_per_step < 1:
        raise ValueError(f"frames_per_step must be >= 1, got {frames_per_step}")
    return wsola_score_table_plain(x, K, num, den, seq, seek, overlap)


def walk_table(table: torch.Tensor) -> torch.Tensor:
    """The walk of a score table: the walk kernel on a CUDA tensor, the
    plain walk on a CPU tensor."""
    if table.is_cuda:
        from nodey_tpu_torch.ops import cuda_wsola_table

        return cuda_wsola_table.walk_table_cuda(table)
    _check_device(table)
    return walk_table_plain(table)


def splice_offsets(x: torch.Tensor, K: int, num: int, den: int, seq: int,
                   seek: int, overlap: int,
                   frames_per_step: int = 1) -> torch.Tensor:
    """int32 [K]: the chain's splices by the table route (score table, then
    its walk), as ``pallas_wsola.splice_offsets`` computes them."""
    return walk_table(wsola_score_table(x, K, num, den, seq, seek, overlap,
                                        frames_per_step))
