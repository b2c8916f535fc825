"""Host-side audio decode (port of nodey_tpu.host.decode, without jax).

Primary path: the native FFmpeg runtime (``nodey_tpu_torch.host.native_lib``,
which builds itself on first use). Where that library does not build or
load, a pure-Python RIFF/WAV reader covers PCM16, PCM32 and float32 WAV;
any other input then raises the same three-part error as the JAX package.
:class:`StreamDecoder` is the native pull decoder with bounded memory that
the streaming executor reads chunks from; it raises where the runtime is
missing, and the executor then decodes the whole clip and slices it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import struct

import numpy as np

from nodey_tpu_torch.core.errors import ProcessorRuntimeError
from nodey_tpu_torch.host import native_lib
from nodey_tpu_torch.core.stream import FMT_FLT, FMT_S16, FMT_S32

_FMT_FROM_TAG = {0: FMT_FLT, 1: FMT_S16, 2: FMT_S32}


@dataclasses.dataclass
class DecodedAudio:
    """Decoded clip: planar float32 [channels, n] normalized to [-1, 1]."""

    data: np.ndarray
    rate: int
    fmt: str
    pts0_us: int = 0

    @property
    def channels(self) -> int:
        return self.data.shape[0]

    @property
    def num_samples(self) -> int:
        return self.data.shape[1]


def load_native():
    """The native codec runtime, or None where it does not build, or was
    built against codec libraries this machine does not have."""
    try:
        return native_lib.load()
    except OSError:
        return None


def decode_file(path: str) -> DecodedAudio:
    """Decode any supported audio file to normalized planar f32."""
    if not path or not os.path.exists(path):
        # Reference validates slots before starting (audio-io.cpp:234-240).
        raise ProcessorRuntimeError(
            "Failed to open input file",
            "The program fails to open the input file, check if the path is "
            "valid",
            f"File path: {path or '(empty)'}",
        )
    lib = load_native()
    if lib is not None:
        return _decode_native(lib, path)
    if path.lower().endswith(".wav"):
        return _decode_wav_python(path)
    raise ProcessorRuntimeError(
        "Failed to open input file",
        "Native decode library unavailable and the file is not a WAV.",
        f"File path: {path}",
    )


def _decode_native(lib, path: str) -> DecodedAudio:
    out = native_lib.NaDecoded()
    errbuf = ctypes.create_string_buffer(512)
    rc = lib.na_decode_file(
        path.encode(), ctypes.byref(out), errbuf, len(errbuf)
    )
    if rc != 0:
        raise ProcessorRuntimeError(
            errbuf.value.decode() or "Failed to decode input file",
            "The program cannot decode the audio file, check the audio file",
            f"File path: {path}",
        )
    try:
        n = out.num_samples * out.channels
        flat = np.ctypeslib.as_array(out.data, shape=(n,)).copy()
    finally:
        lib.na_free_decoded(ctypes.byref(out))
    data = flat.reshape(out.num_samples, out.channels).T
    return DecodedAudio(
        data=np.ascontiguousarray(data, dtype=np.float32),
        rate=int(out.sample_rate),
        fmt=_FMT_FROM_TAG.get(int(out.fmt), FMT_FLT),
        pts0_us=int(out.pts0_us),
    )


class StreamDecoder:
    """Streaming pull decoder with bounded host memory (native API
    ``na_decoder_*`` in ``host/native/decode.cpp``): the counterpart of the
    reference's incremental decode fiber (audio-io.cpp:86-226) for clips
    too long to hold decoded. Raises the three-part error where the native
    runtime does not load."""

    def __init__(self, path: str):
        lib = load_native()
        if lib is None:
            raise ProcessorRuntimeError(
                "Streaming decoder unavailable",
                "The native host runtime (libnodey_host) could not be "
                "loaded.",
                "na_decoder_open",
            )
        self._lib = lib
        info = native_lib.NaDecoded()
        errbuf = ctypes.create_string_buffer(512)
        self._handle = lib.na_decoder_open(
            path.encode(), ctypes.byref(info), errbuf, len(errbuf)
        )
        if not self._handle:
            raise ProcessorRuntimeError(
                errbuf.value.decode() or "Failed to open input file",
                "The program fails to open the input file, check if the "
                "path is valid",
                f"File path: {path}",
            )
        self.rate = int(info.sample_rate)
        self.channels = int(info.channels)
        self.fmt = _FMT_FROM_TAG.get(int(info.fmt), FMT_FLT)
        self.pts0_us = int(info.pts0_us)

    def read(self, max_samples: int):
        """Next planar float32 [channels, n] block (n <= max_samples); None
        at EOF."""
        if self._handle is None:
            return None
        buf = np.empty(max_samples * self.channels, dtype=np.float32)
        n = self._lib.na_decoder_read(
            self._handle,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            max_samples,
        )
        if n < 0:
            raise ProcessorRuntimeError(
                "Failed to decode input file",
                "The program cannot decode the audio file, check the audio "
                "file",
                "na_decoder_read",
            )
        if n == 0:
            return None
        block = buf[: n * self.channels].reshape(n, self.channels).T
        return np.ascontiguousarray(block, dtype=np.float32)

    def close(self) -> None:
        if self._handle is not None:
            self._lib.na_decoder_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def blocks(self, block_samples: int):
        """Iterate planar blocks until EOF."""
        while True:
            block = self.read(block_samples)
            if block is None:
                return
            yield block


def _bad_structure(path: str, what: str = "") -> ProcessorRuntimeError:
    return ProcessorRuntimeError(
        "Failed to find stream info",
        "The program cannot analyze the audio file structure, check the "
        "audio file",
        f"File path: {path}{what}",
    )


def _no_stream(path: str, what: str = "") -> ProcessorRuntimeError:
    return ProcessorRuntimeError(
        "No audio stream found",
        "The file does not contain any audio streams, check the audio file",
        f"File path: {path}{what}",
    )


def _decode_wav_python(path: str) -> DecodedAudio:
    """Minimal RIFF/WAVE reader: PCM 16/32-bit and IEEE float."""
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < 12 or blob[:4] != b"RIFF" or blob[8:12] != b"WAVE":
        raise _bad_structure(path)
    pos = 12
    fmt_chunk = None
    data_chunk = None
    while pos + 8 <= len(blob):
        cid, size = blob[pos : pos + 4], struct.unpack_from("<I", blob, pos + 4)[0]
        body = blob[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt_chunk = body
        elif cid == b"data":
            data_chunk = body
        pos += 8 + size + (size & 1)
    if fmt_chunk is None or data_chunk is None:
        raise _no_stream(path)
    if len(fmt_chunk) < 16:
        raise _bad_structure(path, " (truncated fmt chunk)")
    audio_fmt, channels, rate, _, _, bits = struct.unpack_from(
        "<HHIIHH", fmt_chunk, 0
    )
    if channels < 1:
        raise _no_stream(path, f" (channels={channels})")
    if audio_fmt == 0xFFFE and len(fmt_chunk) >= 40:  # WAVE_FORMAT_EXTENSIBLE
        audio_fmt = struct.unpack_from("<H", fmt_chunk, 24)[0]

    if audio_fmt == 1 and bits == 16:
        raw = np.frombuffer(data_chunk, dtype="<i2")
        data = raw.astype(np.float32) / 32768.0
        fmt = FMT_S16
    elif audio_fmt == 1 and bits == 32:
        raw = np.frombuffer(data_chunk, dtype="<i4")
        data = (raw.astype(np.float64) / 2147483648.0).astype(np.float32)
        fmt = FMT_S32
    elif audio_fmt == 3 and bits == 32:
        data = np.frombuffer(data_chunk, dtype="<f4").astype(np.float32)
        fmt = FMT_FLT
    else:
        raise ProcessorRuntimeError(
            "Unsupported sample format",
            "The WAV fallback reader supports PCM16/PCM32/float32.",
            f"format={audio_fmt} bits={bits}",
        )
    n = len(data) // channels
    planar = data[: n * channels].reshape(n, channels).T
    return DecodedAudio(
        data=np.ascontiguousarray(planar, dtype=np.float32),
        rate=int(rate),
        fmt=fmt,
    )


def _wav_header(channels: int, rate: int, tag: int, bps: int,
                nbytes: int) -> bytes:
    hdr = b"RIFF" + struct.pack("<I", 36 + nbytes) + b"WAVE"
    hdr += b"fmt " + struct.pack(
        "<IHHIIHH", 16, tag, channels, rate, rate * channels * bps,
        channels * bps, bps * 8,
    )
    return hdr + b"data" + struct.pack("<I", nbytes)


def write_wav(path: str, data: np.ndarray, rate: int) -> None:
    """Write planar float32 [channels, n] as an IEEE-float WAV."""
    payload = np.ascontiguousarray(data.T, dtype="<f4").tobytes()
    with open(path, "wb") as f:
        f.write(_wav_header(data.shape[0], rate, 3, 4, len(payload)) + payload)


def write_wav_s16(path: str, data: np.ndarray, rate: int) -> None:
    """Write planar float32 [channels, n] as PCM16 WAV (x -> round(x*32768))."""
    ints = np.clip(np.round(data.T * 32768.0), -32768, 32767).astype("<i2")
    payload = np.ascontiguousarray(ints).tobytes()
    with open(path, "wb") as f:
        f.write(_wav_header(data.shape[0], rate, 1, 2, len(payload)) + payload)
