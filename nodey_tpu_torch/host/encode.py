"""Host-side export sinks (port of nodey_tpu.host.encode, without jax).

``.wav`` paths take the incremental :class:`WavWriter`; anything else is
MP3 through LAME in the native runtime (``nodey_tpu_torch.host.native_lib``),
on the same terms as decode: where the library does not build or load, MP3 export
raises the three-part error. The JAX package's segmented parallel MP3
encoder is not ported yet; MP3 here is the serial reference-parity path.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from nodey_tpu_torch import config
from nodey_tpu_torch.core.errors import ProcessorRuntimeError
from nodey_tpu_torch.core.stream import FMT_S16
from nodey_tpu_torch.host.decode import load_native


def _to_s16(block: np.ndarray) -> np.ndarray:
    """Interleaved int16 [n, channels] from a planar block. Integer-origin
    samples are exact multiples of 1/32768, so the trunc re-quantization is
    lossless (reference: audio-io.cpp:705-714)."""
    if block.dtype == np.int16:
        return np.ascontiguousarray(block.T, dtype="<i2")
    return np.ascontiguousarray(np.clip(
        np.trunc(block.T.astype(np.float32) * 32768.0), -32768, 32767
    ).astype("<i2"))


class Mp3Encoder:
    """Incremental serial MP3 encoder: planar float32 blocks in, file out
    (reference: do_export, audio-io.cpp:640-844 — CBR, 48 kHz output,
    integer-origin PCM through LAME's integer API)."""

    def __init__(self, path: str, rate: int, channels: int, kbps: int,
                 fmt: str = "flt", out_rate: int = config.SAMPLE_RATE):
        lib = load_native()
        if lib is None:
            raise ProcessorRuntimeError(
                "MP3 encoder unavailable",
                "The native host runtime (libnodey_host) could not be "
                "loaded.",
                "na_mp3_open",
            )
        self._lib = lib
        self._fmt = fmt
        self._path = path
        errbuf = ctypes.create_string_buffer(512)
        self._handle = lib.na_mp3_open_ex(
            path.encode(), int(rate), int(channels), int(kbps),
            int(out_rate), 0, errbuf, len(errbuf),
        )
        if not self._handle:
            raise ProcessorRuntimeError(
                errbuf.value.decode() or "Failed to open output file",
                "Cannot open the output file for writing. Check if the path "
                "is valid and writable.",
                f"Output path: {path}",
            )

    def write(self, block: np.ndarray) -> None:
        if self._handle is None:
            raise ProcessorRuntimeError(
                "Encoder already closed", "Mp3Encoder.write after close.",
                self._path,
            )
        if self._fmt == FMT_S16:
            ints = _to_s16(block)
            rc = self._lib.na_mp3_write_s16(
                self._handle,
                ints.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                ints.shape[0],
            )
        else:
            chunk = np.ascontiguousarray(block.T, dtype=np.float32)
            rc = self._lib.na_mp3_write_flt(
                self._handle,
                chunk.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                chunk.shape[0],
            )
        if rc != 0:
            self.close()
            raise ProcessorRuntimeError(
                "Failed to encode audio frame",
                "Cannot encode the audio frame. Internal error may have "
                "occurred.",
                f"Output path: {self._path}",
            )

    def close(self) -> None:
        if self._handle is not None:
            rc = self._lib.na_mp3_close(self._handle)
            self._handle = None
            if rc != 0:
                raise ProcessorRuntimeError(
                    "Failed to finalize MP3 file",
                    "Flushing/closing the encoder failed.",
                    f"Output path: {self._path}",
                )

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *rest):
        if exc_type is None:
            self.close()
        elif self._handle is not None:
            try:
                self._lib.na_mp3_close(self._handle)
            finally:
                self._handle = None


class WavWriter:
    """Incremental WAV writer with the Mp3Encoder block interface.

    Integer-origin masters write PCM16 (trunc re-quantization, as the MP3
    path); float masters write IEEE float32. RIFF/data sizes are patched
    on close."""

    def __init__(self, path: str, rate: int, channels: int,
                 fmt: str = "flt"):
        self._path = path
        self._pcm16 = fmt == FMT_S16
        self._bps = 2 if self._pcm16 else 4
        self._channels = int(channels)
        self._frames = 0
        try:
            self._f = open(path, "wb")
        except OSError as exc:
            raise ProcessorRuntimeError(
                "Failed to open output file",
                "Cannot open the output file for writing. Check if the "
                "path is valid and writable.",
                f"Output path: {path} ({exc})",
            ) from exc
        tag = 1 if self._pcm16 else 3
        hdr = b"RIFF" + struct.pack("<I", 0) + b"WAVE"
        hdr += b"fmt " + struct.pack(
            "<IHHIIHH", 16, tag, self._channels, int(rate),
            int(rate) * self._channels * self._bps,
            self._channels * self._bps, self._bps * 8,
        )
        hdr += b"data" + struct.pack("<I", 0)
        self._f.write(hdr)

    def write(self, block: np.ndarray) -> None:
        """Append a planar [channels, n] float32 (or int16) block."""
        if self._f is None:
            raise ProcessorRuntimeError(
                "Encoder already closed", "WavWriter.write after close.",
                self._path,
            )
        # RIFF sizes are u32: refuse before the data chunk crosses 4 GiB.
        nbytes_after = (self._frames + block.shape[1]) \
            * self._channels * self._bps
        if nbytes_after + 36 > 0xFFFFFFFF:
            raise ProcessorRuntimeError(
                "WAV output exceeds the 4 GiB RIFF limit",
                "The WAV container's 32-bit sizes cap a file at 4 GiB "
                "(about 3.1 hours of float32 stereo at 48 kHz). Export "
                "to MP3, or split the project into shorter exports.",
                f"{self._path}: data would reach {nbytes_after} bytes",
            )
        if self._pcm16:
            payload = _to_s16(block).tobytes()
        else:
            if block.dtype == np.int16:
                block = block.astype(np.float32) * np.float32(1.0 / 32768.0)
            payload = np.ascontiguousarray(block.T, dtype="<f4").tobytes()
        self._f.write(payload)
        self._frames += block.shape[1]

    def close(self) -> None:
        if self._f is not None:
            f, self._f = self._f, None
            try:
                nbytes = self._frames * self._channels * self._bps
                f.seek(4)
                f.write(struct.pack("<I", 36 + nbytes))
                f.seek(40)
                f.write(struct.pack("<I", nbytes))
            finally:
                f.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *rest):
        self.close()


def open_sink(path: str, rate: int, channels: int, kbps: int,
              fmt: str = "flt"):
    """Export sink factory: ``.wav``/``.wave`` -> WavWriter, else MP3."""
    if path.lower().endswith((".wav", ".wave")):
        return WavWriter(path, rate, channels, fmt)
    return Mp3Encoder(path, rate, channels, kbps, fmt)
