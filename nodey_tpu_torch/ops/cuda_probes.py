"""The step-cost probes (``csrc/step_probes.cu``): wrappers, plain versions
and dispatch.

They replace the TPU's grid-step probes, ``bench.py::_wsola_step_overhead``
(``bare``, ``dma``) and ``tools/ab_wsola_fps.py`` (``bare_grid``,
``dma_grid``), as what they measure on this card: the floor of one step of
the serial WSOLA chain kernel, which is one CTA looping over its frames. So
each probe is one CTA of the chain kernel's 768 threads looping over K
steps (the source says what a step does):

- ``step_probe_bare(x, K, per_step)``: x float32 [8, 128]; out = x + 1,
  stored at every step to out[k] ([K, 8, 128], bench.py's form) or to one
  fixed block ([8, 128], the tool's form);
- ``step_probe_dma(x, K, span, ring)``: x float32 [2, N]; step k copies the
  window ``x[:, s_k : s_k + span]``, ``s_k = (k*128) mod limit``,
  ``limit = ((N - span) // 128) * 128``, into shared memory and stores its
  first 128 columns: through a 3-slot ring with one-step prefetch, out[k] =
  those columns + 1 ([K, 2, 128], bench.py's form), or as two copies per
  step into 2 slots, both waited, out = the last step's columns ([2, 128],
  the tool's form).

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
version, which gives the same output tensor. ``bare_launches`` and
``dma_launches`` count the kernels' launches.
"""

from __future__ import annotations

import torch

from nodey_tpu_torch.ops import _build

LANE = 128
BLOCK = (8, LANE)

# Launches of the bare probe and of the dma probe.
bare_launches = 0
dma_launches = 0


def dma_limit(n: int, span: int) -> int:
    """The dma probe's window starts wrap at this column (bench.py's
    ``limit``)."""
    return ((n - span) // LANE) * LANE


def _check_bare(x: torch.Tensor, K: int) -> None:
    if x.dtype != torch.float32 or tuple(x.shape) != BLOCK:
        raise ValueError(
            f"bare probe takes float32 {list(BLOCK)}, got {x.dtype} "
            f"{list(x.shape)}"
        )
    if not 1 <= K < 2**31:
        raise ValueError(f"bare probe: {K} steps")


def _check_dma(x: torch.Tensor, K: int, span: int) -> int:
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[0] != 2:
        raise ValueError(
            f"dma probe takes float32 [2, N], got {x.dtype} {list(x.shape)}")
    limit = dma_limit(x.shape[1], span)
    if not (1 <= K < 2**31 and span >= LANE and limit >= LANE):
        raise ValueError(
            f"dma probe: {K} steps of a {span}-column window of "
            f"{x.shape[1]} columns"
        )
    return limit


def _check_device(x: torch.Tensor) -> None:
    if x.device.type != "cpu":
        raise ValueError(
            f"the step probes run on a CUDA card (kernel) or on the CPU, "
            f"got device={x.device}"
        )


def step_probe_bare_plain(x: torch.Tensor, K: int,
                          per_step: bool = True) -> torch.Tensor:
    _check_bare(x, K)
    y = x + 1.0
    return y.expand(K, *BLOCK).clone() if per_step else y


def step_probe_dma_plain(x: torch.Tensor, K: int, span: int,
                         ring: bool = True) -> torch.Tensor:
    limit = _check_dma(x, K, span)
    if not ring:
        start = ((K - 1) * LANE) % limit
        return x[:, start : start + LANE].clone()
    starts = (torch.arange(K, device=x.device) * LANE) % limit
    cols = starts[:, None] + torch.arange(LANE, device=x.device)
    return x[:, cols].permute(1, 0, 2) + 1.0


def step_probe_bare_cuda(x: torch.Tensor, K: int,
                         per_step: bool = True) -> torch.Tensor:
    global bare_launches
    _check_bare(x, K)
    if not (x.is_cuda and x.is_contiguous()):
        raise ValueError(
            f"bare probe needs a contiguous CUDA tensor, got {x.device}")
    out = torch.empty((K, *BLOCK) if per_step else BLOCK,
                      dtype=torch.float32, device=x.device)
    lib = _build.load_library("step_probes")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.nodey_step_probe_bare(x.data_ptr(), out.data_ptr(), K,
                                       int(per_step), stream)
    _build.check_launch(lib, rc, "bare probe")
    bare_launches += 1
    return out


def step_probe_dma_cuda(x: torch.Tensor, K: int, span: int,
                        ring: bool = True) -> torch.Tensor:
    global dma_launches
    limit = _check_dma(x, K, span)
    if not (x.is_cuda and x.stride(1) == 1):
        raise ValueError(
            f"dma probe needs a CUDA tensor with contiguous rows, got "
            f"{x.device}")
    lib = _build.load_library("step_probes")
    smem = lib.nodey_step_probe_dma_smem_bytes(span, int(ring))
    if smem > _build.SMEM_LIMIT:
        raise ValueError(
            f"dma probe: a {span}-column window needs {smem} bytes of shared "
            f"memory (max {_build.SMEM_LIMIT})"
        )
    out = torch.empty((K, 2, LANE) if ring else (2, LANE),
                      dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.nodey_step_probe_dma(x.data_ptr(), x.stride(0), K, span,
                                      limit, int(ring), out.data_ptr(),
                                      stream)
    _build.check_launch(lib, rc, "dma probe")
    dma_launches += 1
    return out


def step_probe_bare(x: torch.Tensor, K: int,
                    per_step: bool = True) -> torch.Tensor:
    if x.is_cuda:
        return step_probe_bare_cuda(x, K, per_step)
    _check_device(x)
    return step_probe_bare_plain(x, K, per_step)


def step_probe_dma(x: torch.Tensor, K: int, span: int,
                   ring: bool = True) -> torch.Tensor:
    if x.is_cuda:
        return step_probe_dma_cuda(x, K, span, ring)
    _check_device(x)
    return step_probe_dma_plain(x, K, span, ring)
