"""Wrapper of the CUDA WSOLA score-table and walk kernels
(``csrc/wsola_score_table.cu``).

Replaces ``nodey_tpu/ops/pallas_wsola.py::wsola_score_table`` on the card
(``wsola_score_table_cuda``) and the ``lax.scan`` walk of its consumer
``splice_offsets`` (``walk_table_cuda``). The score kernel is bound by FP32
operations (every tail row against every candidate, every frame); its
source says how it blocks the Hankel operands in registers. The walk
composes segment maps in parallel, carries the segments' starts, then walks
every 8 frames from their checkpoint (three launches; the source says what
bounds each), and keeps the table on the card. Their plain PyTorch versions
are ``nodey_tpu_torch.ops.wsola.wsola_score_table_plain`` and
``walk_table_plain``, which the CPU path and ``chip_smoke.py`` use, and
``walk_table_segments_plain``, the walk kernel's formulation; on a CUDA
tensor nothing else runs.

``table_launches`` and ``walk_launches`` count the kernels' launches made
through these wrappers (a walk's three passes count as one).
"""

from __future__ import annotations

import torch

from nodey_tpu_torch.ops import _build
from nodey_tpu_torch.ops.wsola import check_window

# Launches of the score kernel and of the walk kernel.
table_launches = 0
walk_launches = 0


def wsola_score_table_cuda(x: torch.Tensor, K: int, num: int, den: int,
                           seq: int, seek: int, overlap: int,
                           frames_per_step: int = 1) -> torch.Tensor:
    """int32 [K, seek+1]: F[k, p], the first best candidate of frame k for
    the tail that frame k-1's choice p realizes (frame 0: the head
    ``x[:, :overlap]``), real layout; ``x`` [C, N] float32 must cover frame
    K-1's window (its rows need only be contiguous). ``frames_per_step``
    frames are scored by each CTA, in a loop; the table is bitwise the same
    at any value."""
    global table_launches
    if not x.is_cuda:
        raise ValueError(
            f"WSOLA score kernel needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"WSOLA score kernel takes float32, got {x.dtype}")
    if x.dim() != 2 or x.shape[0] < 1:
        raise ValueError(
            f"WSOLA score kernel needs x [C, N], C >= 1, got {tuple(x.shape)}")
    if x.shape[1] > 1 and x.stride(1) != 1:
        raise ValueError("WSOLA score kernel needs x's rows contiguous")
    if not (0 < overlap < seq and seek >= 0 and num > 0 and den > 0
            and 0 <= K < 2**31 and frames_per_step >= 1):
        raise ValueError(
            f"WSOLA score kernel: bad geometry seq={seq} seek={seek} "
            f"overlap={overlap} num={num} den={den} K={K} "
            f"frames_per_step={frames_per_step}"
        )
    # Frame k's tail rows read up to frame_pos(k-1) + seq + seek, which is
    # no further than its candidates (frame_pos grows with k).
    check_window(x, K, num, den, seq, seek)
    lib = _build.load_library("wsola_score_table")
    C = x.shape[0]
    smem = lib.nodey_wsola_table_smem_bytes(C, seek, overlap)
    if smem > _build.SMEM_LIMIT:
        raise ValueError(
            f"WSOLA score kernel: {C} channels at seek={seek}, "
            f"overlap={overlap} need {smem} bytes of shared memory (max "
            f"{_build.SMEM_LIMIT})"
        )
    table = torch.empty((K, seek + 1), dtype=torch.int32, device=x.device)
    if K == 0:
        return table
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.nodey_wsola_score_table(
            x.data_ptr(), x.stride(0), C, K, min(frames_per_step, K), num,
            den, seq, seek, overlap, table.data_ptr(), stream,
        )
    _build.check_launch(lib, rc, "WSOLA score kernel")
    table_launches += 1
    return table


def walk_segment_frames(K: int, sms: int) -> int:
    """The walk kernel's segment length for K frames on a card of ``sms``
    SMs: a segment per SM, rounded up to whole 8-frame emit blocks (so a
    segment's rows start 16-byte aligned in a table that does)."""
    return max(8, (-(-K // sms) + 7) // 8 * 8)


def walk_table_cuda(table: torch.Tensor,
                    seg_frames: int | None = None) -> torch.Tensor:
    """int32 [K]: b_k = table[k, b_{k-1}] from b_{-1} = 0, on the card.
    ``table`` int32 [K, n_cand], contiguous, entries in [0, n_cand) (an
    entry outside stops the walk: it and the rest come back -1). The kernel
    cuts K into segments of ``seg_frames`` frames (default
    ``walk_segment_frames``); the splices are bitwise the same at any
    length."""
    global walk_launches
    if not table.is_cuda:
        raise ValueError(
            f"WSOLA walk kernel needs a CUDA tensor, got {table.device}")
    if table.dtype != torch.int32 or table.dim() != 2 or table.shape[1] < 1:
        raise ValueError(
            f"WSOLA walk kernel needs an int32 [K, n_cand] table, got "
            f"{table.dtype} {tuple(table.shape)}"
        )
    if not table.is_contiguous():
        raise ValueError("WSOLA walk kernel needs a contiguous table")
    K, n_cand = table.shape
    if max(K, n_cand) >= 2**31:
        raise ValueError(
            f"WSOLA walk kernel: table {tuple(table.shape)} too large")
    if seg_frames is not None and seg_frames < 1:
        raise ValueError(
            f"WSOLA walk kernel: seg_frames must be >= 1, got {seg_frames}")
    lib = _build.load_library("wsola_score_table")
    max_cands = lib.nodey_wsola_walk_max_cands()
    if n_cand > max_cands:
        raise ValueError(
            f"WSOLA walk kernel: rows of {n_cand} candidates; it takes at "
            f"most {max_cands} (a state row and 4 staged rows of int32 in "
            f"{_build.SMEM_LIMIT} bytes of shared memory)"
        )
    bs = torch.empty(K, dtype=torch.int32, device=table.device)
    if K == 0:
        return bs
    if seg_frames is None:
        seg_frames = walk_segment_frames(
            K, torch.cuda.get_device_properties(
                table.device).multi_processor_count)
    scratch = torch.empty(
        lib.nodey_wsola_walk_scratch_ints(n_cand, K, seg_frames),
        dtype=torch.int32, device=table.device)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = lib.nodey_wsola_table_walk(table.data_ptr(), n_cand, K,
                                        seg_frames, scratch.data_ptr(),
                                        bs.data_ptr(), stream)
    _build.check_launch(lib, rc, "WSOLA walk kernel")
    walk_launches += 1
    return bs
