"""Build and load the package's CUDA kernels.

Each source ``nodey_tpu_torch/csrc/<name>.cu`` compiles with ``nvcc`` into
its own shared library with a plain C interface, loaded with ``ctypes``.
The build runs at first use, into ``build/nodey_tpu_torch/`` at the
repository root, keyed on a hash of the source, the headers and the
flags, so a fresh checkout builds and an unchanged one reuses.
``build_all()`` starts one ``nvcc`` per source, all together. A missing
``nvcc`` or a failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

_CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "nodey_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# The card allows 227 KB of shared memory per block.
SMEM_LIMIT = 227 * 1024

_lock = threading.Lock()
_libs: dict = {}


def kernel_names() -> list:
    """The kernel sources, by name (``csrc/<name>.cu``)."""
    return sorted(src.stem for src in _CSRC.glob("*.cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of nodey_tpu_torch build from "
            "source with the CUDA toolkit (PATH or /usr/local/cuda/bin)"
        )
    return path


def library_path(name: str) -> pathlib.Path:
    """Where the library of ``csrc/<name>.cu`` lives (built or not)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [_CSRC / f"{name}.cu", *sorted(_CSRC.glob("*.cuh"))]:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return _BUILD_DIR / f"libnodey_{name}_{digest.hexdigest()[:16]}.so"


def build_all(names=None) -> None:
    """Build every library that is missing (or those of ``names``), one
    ``nvcc`` process per source, started together."""
    todo = [(name, library_path(name)) for name in (names or kernel_names())]
    todo = [(name, so) for name, so in todo if not so.exists()]
    if not todo:
        return
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, so in todo:
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs.append((so, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for so, tmp, cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed with exit code {proc.returncode}:\n"
                            f"{' '.join(cmd)}\n{out}")
            continue
        # The -Xptxas -v report (registers, shared memory, spills).
        so.with_suffix(".log").write_text(out)
        os.replace(tmp, so)
    if failures:
        raise RuntimeError("\n".join(failures))


def _bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if name == "polyphase_resample":
        lib.nodey_polyphase_resample.argtypes = [
            vp, vp, vp, vp, i32, i32, i64, i32, i32, i32, i32, i32, i32, i32,
            vp,
        ]
        lib.nodey_polyphase_resample.restype = i32
        lib.nodey_polyphase_smem_bytes.argtypes = [i32, i32, i32]
        lib.nodey_polyphase_smem_bytes.restype = i64
    elif name == "wsola_chain":
        lib.nodey_wsola_chain.argtypes = [
            vp, vp, vp, vp, vp, i64, vp, i32, i64, i32, i64, i64, i64, i64,
            i32, i32, i32, i32, i64, i64, i64, i64, vp,
        ]
        lib.nodey_wsola_chain.restype = i32
        lib.nodey_wsola_energy.argtypes = [
            vp, i64, i32, i32, i64, i64, i64, i64, i32, i32, vp, i32, i64,
            i64, vp,
        ]
        lib.nodey_wsola_energy.restype = i32
        lib.nodey_wsola_smem_bytes.argtypes = [i32, i32, i32, i32]
        lib.nodey_wsola_smem_bytes.restype = i64
        lib.nodey_wsola_energy_smem_bytes.argtypes = [i32, i32, i32]
        lib.nodey_wsola_energy_smem_bytes.restype = i64
        lib.nodey_wsola_threads.argtypes = [i32]
        lib.nodey_wsola_threads.restype = i32
    elif name == "pv_phase_path":
        lib.nodey_pv_phase_path.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32,
            ctypes.c_float, vp,
        ]
        lib.nodey_pv_phase_path.restype = i32
        lib.nodey_pv_phase_scratch_floats.argtypes = [i32, i32, i32]
        lib.nodey_pv_phase_scratch_floats.restype = i64
        lib.nodey_pv_phase_smem_bytes.argtypes = [i32, i32]
        lib.nodey_pv_phase_smem_bytes.restype = i64
    elif name == "pv_lock":
        lib.nodey_pv_lock.argtypes = [vp, vp, vp, vp, vp, vp, i32, i32, vp]
        lib.nodey_pv_lock.restype = i32
        lib.nodey_pv_lock_rows_per_cta.argtypes = [i32]
        lib.nodey_pv_lock_rows_per_cta.restype = i32
    elif name == "wsola_score_table":
        lib.nodey_wsola_score_table.argtypes = [
            vp, i64, i32, i32, i32, i64, i64, i32, i32, i32, vp, vp,
        ]
        lib.nodey_wsola_score_table.restype = i32
        lib.nodey_wsola_table_walk.argtypes = [vp, i32, i32, i32, vp, vp, vp]
        lib.nodey_wsola_table_walk.restype = i32
        lib.nodey_wsola_walk_scratch_ints.argtypes = [i32, i32, i32]
        lib.nodey_wsola_walk_scratch_ints.restype = i64
        lib.nodey_wsola_walk_max_cands.argtypes = []
        lib.nodey_wsola_walk_max_cands.restype = i32
        lib.nodey_wsola_table_smem_bytes.argtypes = [i32, i32, i32]
        lib.nodey_wsola_table_smem_bytes.restype = i64
    elif name == "step_probes":
        lib.nodey_step_probe_bare.argtypes = [vp, vp, i32, i32, vp]
        lib.nodey_step_probe_bare.restype = i32
        lib.nodey_step_probe_dma.argtypes = [vp, i64, i32, i32, i64, i32, vp,
                                             vp]
        lib.nodey_step_probe_dma.restype = i32
        lib.nodey_step_probe_dma_smem_bytes.argtypes = [i32, i32]
        lib.nodey_step_probe_dma_smem_bytes.restype = i64
    lib.nodey_cuda_error_string.argtypes = [i32]
    lib.nodey_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load_library(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, building it first if its source
    changed."""
    with _lock:
        if name not in _libs:
            so = library_path(name)
            if not so.exists():
                build_all([name])
            _libs[name] = _bind(name, ctypes.CDLL(str(so)))
        return _libs[name]


def check_launch(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise unless ``rc``, the cudaError_t a library's C entry returned
    after its launch, is 0."""
    if rc != 0:
        raise RuntimeError(
            f"{what} launch failed: "
            f"{lib.nodey_cuda_error_string(rc).decode()} (cudaError {rc})"
        )


def build_log(name: str) -> str:
    """nvcc's report for the current library ("" before the first build)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
