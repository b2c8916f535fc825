"""On-card A/B of the step probes (``csrc/step_probes.cu``): checkouts in
turns, beside two variants of their design.

    python -m nodey_tpu_torch.tools.probe_ab [--root DIR ...] [--iters N]

    e.g. git archive HEAD~1 | tar -x -C checkouts/parent, then
    python -m nodey_tpu_torch.tools.probe_ab --root checkouts/parent --root .

Each checkout's ``nodey_tpu_torch/csrc/step_probes.cu`` is built with
``nvcc`` (the package's flags) into ``build/probe_ab/`` beside
``VARIANTS_SOURCE``, all together, and called through its C entries, which
every checkout since the port shares. The variants:

- ``bare_tma_store``: the bare probe storing its [8, 128] block, staged once
  in shared memory, by one TMA bulk store a step (``cp.async.bulk.global.
  shared::cta.bulk_group``; ``wait_group.read 0`` before exit) in place of
  256 threads' 16-byte stores;
- ``dma_ring2``: the dma probe's ring with step k+2's window issued at step
  k (the same three slots and one barrier a step), where the probe issues
  step k+1's: how much of the TMA round trip a deeper prefetch hides.

On a seeded x (the dma probe's [2, 2^20] at the 48 kHz window of 1280
columns, and an [8, 128] block) every form of every library is first held
bitwise against the plain versions (``ops/cuda_probes.py``) at K = 1, 2,
3, 4, 751 and 4097. Then each form is timed at K = 751, 2048 and 4096 (CUDA
events over ``iters`` calls after one warm-up), in turns (the libraries in
order, then in reverse, twice), and the tool prints per form and library
the median ms per launch, its spread at K = 4096, us a step by K-slope
(2048 -> 4096) and t / K at 751 (the A/B tool's K), then one JSON line with
all of it and the card's name and power limit. Compare checkouts only
within one run of this tool, on one card. Without a CUDA card it exits 1.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import torch

from nodey_tpu_torch.ops import _build, cuda_probes
from nodey_tpu_torch.tools import probes
from nodey_tpu_torch.tools.ab_wsola_fps import card_line

ROOT = pathlib.Path(__file__).resolve().parents[2]
BUILD = ROOT / "build" / "probe_ab"
CHECK_KS = (1, 2, 3, 4, 751, 4097)
TIME_KS = (751,) + probes.STEP_KS
DEVICE = "cuda"          # the card; the kernels run nowhere else

VARIANTS_SOURCE = r"""
#include <cuda_runtime.h>
namespace {
constexpr int kThreads = 768;
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}
__device__ __forceinline__ void issue(float* dst, const float* x,
                                      long long ld, int span,
                                      long long start,
                                      unsigned long long* bar) {
  const unsigned bytes = 4u * static_cast<unsigned>(span);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(2u * bytes) : "memory");
  for (int c = 0; c < 2; ++c) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n"
        :: "r"(smem_addr(dst + c * span)), "l"(x + c * ld + start),
           "r"(bytes), "r"(smem_addr(bar)) : "memory");
  }
}
__global__ void __launch_bounds__(kThreads)
bare_tma_store_kernel(const float* __restrict__ x, float* __restrict__ out,
                      int steps, int per_step) {
  __shared__ __align__(128) float blk[1024];
  for (int i = threadIdx.x; i < 1024; i += kThreads) blk[i] = x[i] + 1.0f;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  for (int k = 0; k < steps; ++k) {
    __syncthreads();
    if (threadIdx.x == 0) {
      float* dst = out + (per_step ? static_cast<long long>(k) * 1024 : 0LL);
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], 4096;\n"
          :: "l"(dst), "r"(smem_addr(blk)) : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if (threadIdx.x == 0) {
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}
__global__ void __launch_bounds__(kThreads)
dma_ring2_kernel(const float* __restrict__ x, long long ld, int steps,
                 int span, long long limit, float* __restrict__ out) {
  extern __shared__ __align__(16) float win[];
  const int slot_len = 2 * span;
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(win + 3 * slot_len);
  const int t = threadIdx.x;
  if (t == 0) {
    for (int i = 0; i < 3; ++i) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_addr(&full[i])) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < 2 && k < steps; ++k) {
      issue(win + k * slot_len, x, ld, span, (k * 128LL) % limit, &full[k]);
    }
  }
  for (int k = 0; k < steps; ++k) {
    __syncthreads();  // slot (k+2) % 3 was last read at step k - 1
    if (t == 0 && k + 2 < steps) {
      const int next = (k + 2) % 3;
      issue(win + next * slot_len, x, ld, span, ((k + 2) * 128LL) % limit,
            &full[next]);
    }
    mbar_wait(&full[k % 3], static_cast<unsigned>(k / 3) & 1u);
    if (t < 64) {
      float4 v = *reinterpret_cast<const float4*>(
          win + (k % 3) * slot_len + (t / 32) * span + 4 * (t % 32));
      v.x += 1.0f; v.y += 1.0f; v.z += 1.0f; v.w += 1.0f;
      reinterpret_cast<float4*>(out)[k * 64LL + t] = v;
    }
  }
}
}  // namespace
extern "C" int probe_ab_bare_tma_store(const float* x, float* out, int steps,
                                       int per_step, void* stream) {
  bare_tma_store_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      x, out, steps, per_step);
  return (int)cudaGetLastError();
}
extern "C" int probe_ab_dma_ring2(const float* x, long long ld, int steps,
                                  int span, long long limit, float* out,
                                  void* stream) {
  const int smem = 4 * 3 * 2 * span + 3 * 8;
  cudaError_t err = cudaFuncSetAttribute(
      dma_ring2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dma_ring2_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      x, ld, steps, span, limit, out);
  return (int)cudaGetLastError();
}
"""


def build(roots) -> dict:
    """{name: CDLL}: each root's probes ("root0", "root1", ...) and the
    variants, built by one nvcc each, all started together."""
    BUILD.mkdir(parents=True, exist_ok=True)
    variants = BUILD / "variants.cu"
    variants.write_text(VARIANTS_SOURCE)
    sources = {f"root{i}": pathlib.Path(root) / "nodey_tpu_torch" / "csrc" /
               "step_probes.cu" for i, root in enumerate(roots)}
    sources["variants"] = variants
    nvcc = _build._nvcc()
    procs = {}
    for name, src in sources.items():
        so = BUILD / f"lib{name}.{os.getpid()}.so"
        procs[name] = (so, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {sources[name]}:\n{out}")
        lib = libs[name] = ctypes.CDLL(str(so))
        if name == "variants":
            lib.probe_ab_bare_tma_store.argtypes = [vp, vp, i32, i32, vp]
            lib.probe_ab_dma_ring2.argtypes = [vp, i64, i32, i32, i64, vp, vp]
        else:
            lib.nodey_step_probe_bare.argtypes = [vp, vp, i32, i32, vp]
            lib.nodey_step_probe_dma.argtypes = [vp, i64, i32, i32, i64, i32,
                                                 vp, vp]
    return libs


def forms(libs, block, wide, span):
    """{(form, library): fn(K) -> out} with {form: plain(K) -> out}."""
    limit = cuda_probes.dma_limit(wide.shape[1], span)

    def launch(fn, shape, args):
        def run(K):
            out = torch.empty(shape(K), device=block.device)
            stream = torch.cuda.current_stream().cuda_stream
            rc = fn(*args(K, out), stream)
            if rc:
                raise RuntimeError(f"launch failed: cudaError {rc}")
            return out
        return run

    bare = lambda p: (lambda K, o: (block.data_ptr(), o.data_ptr(), K, p))
    dma = lambda K, o: (wide.data_ptr(), wide.stride(0), K, span, limit)
    shapes = {"bare_step": lambda K: (K, 8, 128),
              "bare_fixed": lambda K: (8, 128),
              "dma_ring": lambda K: (K, 2, 128),
              "dma_pair": lambda K: (2, 128)}
    fns = {}
    for name, lib in libs.items():
        if name == "variants":
            fns[("bare_step", "bare_tma_store")] = launch(
                lib.probe_ab_bare_tma_store, shapes["bare_step"], bare(1))
            fns[("bare_fixed", "bare_tma_store")] = launch(
                lib.probe_ab_bare_tma_store, shapes["bare_fixed"], bare(0))
            fns[("dma_ring", "dma_ring2")] = launch(
                lib.probe_ab_dma_ring2, shapes["dma_ring"],
                lambda K, o: (*dma(K, o), o.data_ptr()))
            continue
        for per_step, form in ((1, "bare_step"), (0, "bare_fixed")):
            fns[(form, name)] = launch(lib.nodey_step_probe_bare,
                                       shapes[form], bare(per_step))
        for ring, form in ((1, "dma_ring"), (0, "dma_pair")):
            fns[(form, name)] = launch(
                lib.nodey_step_probe_dma, shapes[form],
                lambda K, o, r=ring: (*dma(K, o), r, o.data_ptr()))
    plain = {
        "bare_step": lambda K: cuda_probes.step_probe_bare_plain(block, K),
        "bare_fixed": lambda K: cuda_probes.step_probe_bare_plain(
            block, K, False),
        "dma_ring": lambda K: cuda_probes.step_probe_dma_plain(wide, K, span),
        "dma_pair": lambda K: cuda_probes.step_probe_dma_plain(
            wide, K, span, False)}
    return fns, plain


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", action="append", default=None,
                        help="a checkout (repeatable; default: this one)")
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_ab: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    roots = args.root or [str(ROOT)]
    card = card_line()
    print(f"card: {card}; roots: {dict(enumerate(roots))}", flush=True)
    libs = build(roots)
    rng = np.random.default_rng(17)
    block = torch.from_numpy(rng.standard_normal(cuda_probes.BLOCK).astype(
        np.float32)).to(DEVICE)
    wide = torch.from_numpy(rng.standard_normal(
        (2, probes.DMA_COLUMNS)).astype(np.float32)).to(DEVICE)
    fns, plain = forms(libs, block, wide, probes.span_dma())
    equal = {}
    for (form, name), fn in fns.items():
        equal[f"{form}/{name}"] = all(
            torch.equal(fn(K), plain[form](K)) for K in CHECK_KS)
    torch.cuda.synchronize()
    print(f"bitwise plain at K {CHECK_KS}: {equal}", flush=True)
    runs = {key: {K: [] for K in TIME_KS} for key in fns}
    order = list(fns) + list(reversed(fns))
    for _ in range(2):
        for key in order:
            for K in TIME_KS:
                runs[key][K].append(probes.cuda_seconds(
                    lambda: fns[key](K), args.iters) * 1e3)
    results = {}
    k1, k2 = probes.STEP_KS
    for (form, name), by_k in runs.items():
        ms = {K: float(np.median(v)) for K, v in by_k.items()}
        row = results.setdefault(form, {})[name] = {
            "ms": ms, "spread_ms_4096": [min(by_k[4096]), max(by_k[4096])],
            "us_per_step": (ms[k2] - ms[k1]) / (k2 - k1) * 1e3,
            "us_per_step_751": ms[751] / 751 * 1e3}
        print(f"{form} {name}: K=4096 {ms[4096]:.4f} ms (spread "
              f"{row['spread_ms_4096'][0]:.4f}-{row['spread_ms_4096'][1]:.4f})"
              f", K=2048 {ms[2048]:.4f}, K=751 {ms[751]:.4f}; "
              f"{row['us_per_step']:.4f} us a step by K-slope, "
              f"{row['us_per_step_751']:.4f} us as t/K at 751", flush=True)
    print(json.dumps({"card": card, "roots": roots, "equal": equal,
                      "results": results}))
    return 0 if all(equal.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
