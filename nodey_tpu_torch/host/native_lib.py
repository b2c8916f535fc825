"""ctypes binding to the port's copy of the native codec runtime.

The sources under ``nodey_tpu_torch/host/native/`` (FFmpeg decode, LAME
export through ``dlopen``, a libswresample shim) build with cmake+ninja
at first use into ``build/nodey_tpu_torch/native/`` at the repository
root. The build runs under an exclusive ``fcntl.flock`` on a lock file
there, so test workers or processes that start together build once and
never load a half-written library.

``load()`` returns None where the runtime does not build (no cmake, or no
FFmpeg development files): the port then reads WAV in Python and cannot
export MP3. A library that builds but cannot load (codec runtime libraries
missing on this machine) raises ``OSError``; ``host.decode.load_native``
treats that the same way. Nothing else falls back.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import pathlib
import subprocess
import threading
from typing import Optional

_NATIVE_DIR = pathlib.Path(__file__).resolve().parent / "native"
_BUILD_DIR = (pathlib.Path(__file__).resolve().parents[2]
              / "build" / "nodey_tpu_torch" / "native")
_SOURCES = ("CMakeLists.txt", "decode.cpp", "encode.cpp", "swr_shim.cpp",
            "nodey_host.h")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed: Optional[str] = None


class NaDecoded(ctypes.Structure):
    _fields_ = [
        ("sample_rate", ctypes.c_int32),
        ("channels", ctypes.c_int32),
        ("fmt", ctypes.c_int32),
        ("num_samples", ctypes.c_int64),
        ("pts0_us", ctypes.c_int64),
        ("data", ctypes.POINTER(ctypes.c_float)),
    ]


def _digest() -> str:
    digest = hashlib.sha256()
    for name in _SOURCES:
        digest.update(name.encode())
        digest.update((_NATIVE_DIR / name).read_bytes())
    return digest.hexdigest()[:16]


def library_path() -> pathlib.Path:
    return _BUILD_DIR / "libnodey_host.so"


def _build() -> None:
    """cmake+ninja into the build directory; records the source digest
    beside the library so a source edit rebuilds."""
    subprocess.run(
        ["cmake", "-S", str(_NATIVE_DIR), "-B", str(_BUILD_DIR), "-G", "Ninja"],
        check=True, capture_output=True,
    )
    subprocess.run(["ninja", "-C", str(_BUILD_DIR)], check=True,
                   capture_output=True)
    (_BUILD_DIR / "sources.sha256").write_text(_digest())


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_float_p = ctypes.POINTER(ctypes.c_float)
    lib.na_decode_file.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(NaDecoded), ctypes.c_char_p,
        ctypes.c_int,
    ]
    lib.na_decode_file.restype = ctypes.c_int
    lib.na_free_decoded.argtypes = [ctypes.POINTER(NaDecoded)]
    lib.na_free_decoded.restype = None
    lib.na_decoder_open.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(NaDecoded), ctypes.c_char_p,
        ctypes.c_int,
    ]
    lib.na_decoder_open.restype = ctypes.c_void_p
    lib.na_decoder_read.argtypes = [ctypes.c_void_p, c_float_p,
                                    ctypes.c_int64]
    lib.na_decoder_read.restype = ctypes.c_int64
    lib.na_decoder_close.argtypes = [ctypes.c_void_p]
    lib.na_decoder_close.restype = None

    lib.na_mp3_open_ex.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.na_mp3_open_ex.restype = ctypes.c_void_p
    lib.na_mp3_write_flt.argtypes = [ctypes.c_void_p, c_float_p,
                                     ctypes.c_int64]
    lib.na_mp3_write_flt.restype = ctypes.c_int
    lib.na_mp3_write_s16.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16), ctypes.c_int64,
    ]
    lib.na_mp3_write_s16.restype = ctypes.c_int
    lib.na_mp3_close.argtypes = [ctypes.c_void_p]
    lib.na_mp3_close.restype = ctypes.c_int

    lib.na_swr_convert_full.argtypes = [
        c_float_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(c_float_p), ctypes.c_char_p, ctypes.c_int,
    ]
    lib.na_swr_convert_full.restype = ctypes.c_int64
    lib.na_free_buffer.argtypes = [c_float_p]
    lib.na_free_buffer.restype = None
    return lib


def load() -> Optional[ctypes.CDLL]:
    """The codec runtime, building it first if missing or stale; None if
    it does not build. Raises OSError if the built library cannot load."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed is not None:
            return None
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(_BUILD_DIR / "build.lock", "w") as lock_file:
            fcntl.flock(lock_file, fcntl.LOCK_EX)
            stamp = _BUILD_DIR / "sources.sha256"
            fresh = (library_path().exists() and stamp.exists()
                     and stamp.read_text() == _digest())
            if not fresh:
                try:
                    _build()
                except (subprocess.CalledProcessError, FileNotFoundError) as exc:
                    _build_failed = str(exc)
                    return None
            # Loaded while the lock is held: no other process is writing it.
            _lib = _bind(ctypes.CDLL(str(library_path())))
        return _lib


def available() -> bool:
    """True where the codec runtime builds and loads."""
    try:
        return load() is not None
    except OSError:
        return False
