"""Wrapper of the CUDA polyphase resampler (``csrc/polyphase_resample.cu``).

Replaces ``nodey_tpu/ops/pallas_resample.py::apply_filter_bank_grouped_pallas``
on the card. The kernel sums only each phase block's tap support
(``resample.BankSupport``), reading the compact bank in place of the dense
one, which it is never given; its source says what bounds it and how its
register tile and staged input rows deal with that. Its plain PyTorch
version is
``nodey_tpu_torch.ops.resample.apply_filter_bank_plain`` (the dense bank),
which the CPU path and ``chip_smoke.py`` use; on a CUDA tensor nothing else
runs.

``launches`` counts the kernel's launches made through this wrapper.
"""

from __future__ import annotations

import torch

from nodey_tpu_torch.ops import _build
from nodey_tpu_torch.ops.resample import SUPPORT_BLOCK, TILE_PHASES

# Launches of the kernel through apply_filter_bank_cuda.
launches = 0

# Output groups per lane of a CTA (32 lanes x this many groups), tried in
# order: 4 keeps 16 accumulators a thread; 1 only where the staged input
# rows of 128 groups would not fit in shared memory (windows of several
# hundred taps, strong downsampling).
_GROUPS_PER_LANE = (4, 1)


def apply_filter_bank_cuda(x: torch.Tensor, G: int, M: int, W: int,
                           support) -> torch.Tensor:
    """``y[c, g*L + p] = sum_w x[c, g*M + w] * bank[p, w]`` -> [C, G*L],
    summed over ``support`` (``resample.BankSupport`` of the [L, W] bank)
    only.

    ``x`` [C, N] must already be padded so that N >= (G - 1)*M + W. A batch
    ``x`` [B, C, N] folds its clips into the kernel's rows, [B*C, N] (the
    grid is (tiles, rows), and every row is summed alone), so a batch is
    one launch; the result is [B, C, G*L]."""
    global launches
    if x.dim() == 3:
        if not x.is_contiguous():
            raise ValueError("polyphase kernel needs a contiguous batch x")
        y = apply_filter_bank_cuda(x.reshape(-1, x.shape[2]), G, M, W,
                                   support)
        return y.reshape(x.shape[0], x.shape[1], -1)
    compact, offsets = support.compact, support.offsets
    if not (x.is_cuda and x.device == compact.device == offsets.device):
        raise ValueError(
            f"polyphase kernel needs x and the bank's support on one CUDA "
            f"device, got {x.device}, {compact.device} and {offsets.device}"
        )
    if not (x.dtype == compact.dtype == torch.float32
            and offsets.dtype == torch.int32):
        raise ValueError(
            f"polyphase kernel takes float32 (int32 offsets), got {x.dtype}, "
            f"{compact.dtype} and {offsets.dtype}"
        )
    L, T = support.phases, support.taps
    B = SUPPORT_BLOCK
    nb = -(-L // B)
    if (x.dim() != 2 or support.width != W
            or tuple(compact.shape) != (nb, T, B)
            or tuple(offsets.shape) != (nb,)):
        raise ValueError(
            f"polyphase kernel needs x [C, N] or [B, C, N] and a support of "
            f"a [L, {W}] "
            f"bank, [ceil(L/{B}), T, {B}] with offsets [ceil(L/{B})], got "
            f"{tuple(x.shape)}, a [{L}, {support.width}] bank, "
            f"{tuple(compact.shape)} and {tuple(offsets.shape)}"
        )
    if not (x.is_contiguous() and compact.is_contiguous()
            and offsets.is_contiguous()):
        raise ValueError("polyphase kernel needs contiguous x and support")
    row_used = support.row_used
    if not 0 < T <= row_used <= W:
        raise ValueError(f"polyphase kernel: a support of {T} taps in "
                         f"{row_used}-column input rows leaves the {W}-wide "
                         f"window")
    C, N = x.shape
    if G < 0 or M < 1 or (G > 0 and N < (G - 1) * M + W):
        raise ValueError(
            f"polyphase kernel: x has {N} samples, {G} groups at M={M}, "
            f"W={W} read {(G - 1) * M + W}"
        )
    if max(N, G * L) >= 2**31 or C > 65535:
        raise ValueError(f"polyphase kernel: shape {C}x{N} -> {G * L} too large")
    y = torch.empty((C, G * L), dtype=torch.float32, device=x.device)
    if G == 0 or C == 0:
        return y
    lib = _build.load_library("polyphase_resample")
    row_ld = row_used | 1   # odd: the lanes' rows fall in distinct banks
    for gpt in _GROUPS_PER_LANE:
        smem = lib.nodey_polyphase_smem_bytes(gpt, T, row_ld)
        if 0 < smem <= _build.SMEM_LIMIT:
            break
    else:
        raise ValueError(
            f"polyphase kernel: {T} taps and {row_used}-column input rows "
            f"need more than {_build.SMEM_LIMIT} bytes of shared memory even "
            f"at 32 groups per CTA"
        )
    ctas = -(-L // TILE_PHASES) * -(-G // (32 * gpt))
    if ctas >= 2**31:
        raise ValueError(f"polyphase kernel: {ctas} CTAs, too many")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.nodey_polyphase_resample(
            x.data_ptr(), compact.data_ptr(), offsets.data_ptr(), y.data_ptr(),
            C, N, G, L, nb, M, T, gpt, row_used, row_ld, stream,
        )
    _build.check_launch(lib, rc, "polyphase kernel")
    launches += 1
    return y
