"""Wrapper of the CUDA polyphase resampler (``csrc/polyphase_resample.cu``).

Replaces ``nodey_tpu/ops/pallas_resample.py::apply_filter_bank_grouped_pallas``
on the card. The kernel is FFMA-bound (about 2*W flops per output sample
against 8 bytes of traffic); its source says how the design keeps the
input span and the bank tile in shared memory. Its plain PyTorch version
is ``nodey_tpu_torch.ops.resample.apply_filter_bank_plain``, which the CPU
path and ``chip_smoke.py`` use; on a CUDA tensor nothing else runs.

``launches`` counts the kernel's launches made through this wrapper.
"""

from __future__ import annotations

import torch

from nodey_tpu_torch.ops import _build

# Launches of the kernel through apply_filter_bank_cuda.
launches = 0

# Output groups per CTA: 64 keeps all 8 warps busy with 8 groups each; it
# halves (to at least 8) when the input span and the bank tile would not
# fit this shared-memory budget (the card allows 227 KB per block).
_TILE_G = 64
_SMEM_BUDGET = 200 * 1024


def _tile_groups(lib, M: int, W: int) -> int:
    tile = _TILE_G
    while tile > 8 and lib.nodey_polyphase_smem_bytes(M, W, tile) > _SMEM_BUDGET:
        tile //= 2
    if lib.nodey_polyphase_smem_bytes(M, W, tile) > _SMEM_BUDGET:
        raise ValueError(
            f"polyphase kernel: M={M}, W={W} need more shared memory than "
            f"{_SMEM_BUDGET} bytes even at 8 groups per block"
        )
    return tile


def apply_filter_bank_cuda(x: torch.Tensor, G: int, M: int, W: int,
                           bank: torch.Tensor) -> torch.Tensor:
    """``y[c, g*L + p] = sum_w x[c, g*M + w] * bank[p, w]`` -> [C, G*L].

    ``x`` [C, N] must already be padded so that N >= (G - 1)*M + W."""
    global launches
    if not (x.is_cuda and bank.is_cuda and x.device == bank.device):
        raise ValueError(
            f"polyphase kernel needs x and bank on one CUDA device, got "
            f"{x.device} and {bank.device}"
        )
    if x.dtype != torch.float32 or bank.dtype != torch.float32:
        raise ValueError(
            f"polyphase kernel takes float32, got {x.dtype} and {bank.dtype}"
        )
    if x.dim() != 2 or bank.dim() != 2 or bank.shape[1] != W:
        raise ValueError(
            f"polyphase kernel needs x [C, N] and bank [L, {W}], got "
            f"{tuple(x.shape)} and {tuple(bank.shape)}"
        )
    if not (x.is_contiguous() and bank.is_contiguous()):
        raise ValueError("polyphase kernel needs contiguous x and bank")
    C, N = x.shape
    L = bank.shape[0]
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
    tile_g = _tile_groups(lib, M, W)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.nodey_polyphase_resample(
            x.data_ptr(), bank.data_ptr(), y.data_ptr(),
            C, N, G, L, M, W, tile_g, stream,
        )
    _build.check_launch(lib, rc, "polyphase kernel")
    launches += 1
    return y
