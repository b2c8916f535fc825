"""Build and load the package's CUDA kernels.

The sources under ``nodey_tpu_torch/csrc/`` compile with ``nvcc`` into one
shared library with a plain C interface, loaded with ``ctypes``. The build
runs at first use, into ``build/nodey_tpu_torch/`` at the repository root,
keyed on a hash of the sources and flags, so a fresh checkout builds it
and an unchanged one reuses it. A missing ``nvcc`` or a failed build
raises; nothing falls back.
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

_lock = threading.Lock()
_lib = None


def _sources():
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


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


def library_path() -> pathlib.Path:
    """Where the library for the current sources lives (built or not)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return _BUILD_DIR / f"libnodey_kernels_{digest.hexdigest()[:16]}.so"


def _compile(so: pathlib.Path) -> None:
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in _sources() if s.suffix == ".cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    # The -Xptxas -v report (registers, shared memory, spills per kernel).
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.nodey_polyphase_resample.argtypes = [
        vp, vp, vp, i32, i32, i32, i32, i32, i32, i32, vp,
    ]
    lib.nodey_polyphase_resample.restype = i32
    lib.nodey_polyphase_smem_bytes.argtypes = [i32, i32, i32]
    lib.nodey_polyphase_smem_bytes.restype = ctypes.c_longlong
    lib.nodey_cuda_error_string.argtypes = [i32]
    lib.nodey_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load_library() -> ctypes.CDLL:
    """The kernel library, building it first if the sources changed."""
    global _lib
    with _lock:
        if _lib is None:
            so = library_path()
            if not so.exists():
                _compile(so)
            _lib = _bind(ctypes.CDLL(str(so)))
        return _lib


def build_log() -> str:
    """nvcc's report for the current library ("" before the first build)."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""
