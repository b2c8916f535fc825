"""Host-side audio decode (port of nodey_tpu.host.decode, without jax).

Primary path: the native FFmpeg runtime (``nodey_tpu_torch.host.native_lib``,
which builds itself on first use). Where that library does not build or
load, a pure-Python RIFF/WAV reader covers PCM16, PCM32 and float32 WAV;
any other input then raises the same three-part error as the JAX package.
:class:`StreamDecoder` is the native pull decoder with bounded memory that
the streaming executor reads chunks from; it raises where the runtime is
missing, and the executor then reads a WAV block by block through
:class:`WavBlockReader`, the Python reader with bounded memory.
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
    """Minimal RIFF/WAVE reader: PCM 16/32-bit and IEEE float, the whole
    clip at once (``WavBlockReader`` in one block)."""
    with WavBlockReader(path) as reader:
        data = reader.read(reader.num_samples)
    if data is None:
        data = np.zeros((reader.channels, 0), dtype=np.float32)
    return DecodedAudio(data=data, rate=reader.rate, fmt=reader.fmt)


# WAV sample formats the Python reader takes: (format tag, bits) -> (origin
# format, little-endian dtype).
_WAV_FORMATS = {(1, 16): (FMT_S16, "<i2"), (1, 32): (FMT_S32, "<i4"),
                (3, 32): (FMT_FLT, "<f4")}


class WavBlockReader:
    """The Python WAV reader (PCM16, PCM32, float32) with bounded memory:
    the header is parsed up front (the last ``fmt `` and ``data`` chunks
    count, a data chunk running past the file's end is cut there), and
    ``read``/``blocks`` return the data chunk's frames a block at a time as
    normalized planar float32, each sample converted exactly as a whole-clip
    read converts it (s16: /32768 in float32; s32: /2^31 in float64, then
    float32). It holds one block: what the streaming executor reads where
    the codec runtime does not load."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        try:
            self._parse(path)
        except BaseException:
            self._f.close()
            raise
        self.pts0_us = 0
        self._next = 0

    def _parse(self, path: str) -> None:
        f = self._f
        size_all = os.fstat(f.fileno()).st_size
        riff = f.read(12)
        if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise _bad_structure(path)
        pos = 12
        fmt_chunk = None
        data = None   # (offset, bytes)
        while pos + 8 <= size_all:
            f.seek(pos)
            cid, size = struct.unpack("<4sI", f.read(8))
            avail = min(size, size_all - pos - 8)
            if cid == b"fmt ":
                fmt_chunk = f.read(avail)
            elif cid == b"data":
                data = (pos + 8, avail)
            pos += 8 + size + (size & 1)
        if fmt_chunk is None or data is None:
            raise _no_stream(path)
        if len(fmt_chunk) < 16:
            raise _bad_structure(path, " (truncated fmt chunk)")
        audio_fmt, channels, rate, _, _, bits = struct.unpack_from(
            "<HHIIHH", fmt_chunk, 0
        )
        if channels < 1:
            raise _no_stream(path, f" (channels={channels})")
        if audio_fmt == 0xFFFE and len(fmt_chunk) >= 40:  # EXTENSIBLE
            audio_fmt = struct.unpack_from("<H", fmt_chunk, 24)[0]
        if (audio_fmt, bits) not in _WAV_FORMATS:
            raise ProcessorRuntimeError(
                "Unsupported sample format",
                "The WAV fallback reader supports PCM16/PCM32/float32.",
                f"format={audio_fmt} bits={bits}",
            )
        self.fmt, self._dtype = _WAV_FORMATS[(audio_fmt, bits)]
        self.channels = int(channels)
        self.rate = int(rate)
        self._offset, nbytes = data
        self._frame_bytes = (bits // 8) * self.channels
        self.num_samples = nbytes // (bits // 8) // self.channels

    def read(self, max_samples: int):
        """The next block of at most ``max_samples`` frames, planar float32
        [channels, n]; None at the end of the data."""
        n = min(max_samples, self.num_samples - self._next)
        if n <= 0:
            return None
        self._f.seek(self._offset + self._next * self._frame_bytes)
        raw = np.frombuffer(self._f.read(n * self._frame_bytes),
                            dtype=self._dtype)
        self._next += n
        # In place where it can be: the block's only copies are the bytes
        # read, the converted samples and the planar result.
        if self.fmt == FMT_S16:
            data = raw.astype(np.float32)
            data /= 32768.0
        elif self.fmt == FMT_S32:
            wide = raw.astype(np.float64)
            wide /= 2147483648.0
            data = wide.astype(np.float32)
        else:
            data = raw.astype(np.float32)
        return np.ascontiguousarray(data.reshape(n, self.channels).T,
                                    dtype=np.float32)

    def blocks(self, block_samples: int):
        """Iterate planar blocks until the end of the data (holding no
        reference to a block once it is handed out)."""
        while self._next < self.num_samples:
            yield self.read(block_samples)

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


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
