"""Host-side export sinks (port of nodey_tpu.host.encode, without jax).

``.wav`` paths take the incremental :class:`WavWriter`; anything else is
MP3 through LAME in the native runtime (``nodey_tpu_torch.host.native_lib``),
on the same terms as decode: where the library does not build or load, MP3 export
raises the three-part error. ``open_sink`` picks the segmented parallel
encoder (:class:`ParallelMp3Encoder`) by the JAX package's rule: more than
one worker (``mp3_workers``: ``NODEY_MP3_WORKERS``, else the CPU count) and
a 48 kHz master, which needs no LAME-side resample; else the serial
reference-parity :class:`Mp3Encoder`.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import os
import struct
import tempfile

import numpy as np

from nodey_tpu_torch import config
from nodey_tpu_torch.core.errors import ProcessorRuntimeError
from nodey_tpu_torch.core.stream import FMT_S16
from nodey_tpu_torch.host.decode import load_native

_CHUNK = 1 << 18  # samples per LAME call; keeps the scratch buffer bounded


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
    integer-origin PCM through LAME's integer API).

    ``flags`` (for ParallelMp3Encoder's segments): bit 0 leaves out the
    Xing/Info header frame, bit 1 turns off the bit reservoir (frames that
    do not depend on each other)."""

    def __init__(self, path: str, rate: int, channels: int, kbps: int,
                 fmt: str = "flt", out_rate: int = config.SAMPLE_RATE,
                 flags: int = 0):
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
            int(out_rate), int(flags), errbuf, len(errbuf),
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


# -- segmented parallel MP3 ----------------------------------------------------
#
# Why a serial LAME stream cannot be split bit-exactly:
# an MP3 frame is not self-contained under LAME's default CBR settings —
# (a) the BIT RESERVOIR lets frame k store part of its Huffman data in the
#     spare bytes of frames k-1..k-~5 (main_data_begin back-pointer), so a
#     frame sequence only decodes against the exact bytes of its
#     predecessors;
# (b) the psychoacoustic model and MDCT window switching carry history —
#     the bits chosen for frame k depend on several preceding granules;
# (c) the encoder pads the stream start (encoder delay, 576 samples) and
#     end (flush), which exist once per LAME instance, not once per
#     segment.
# Therefore parallel workers encoding disjoint PCM ranges can never
# reproduce the DEFAULT serial byte stream. What CAN be reproduced exactly
# is the no-reservoir stream: with the reservoir disabled
# (main_data_begin == 0, every frame self-contained) and each worker fed
# WARM frames of true preceding PCM (LAME's psymodel/window-switch state
# converges within a few frames) plus TAIL lookahead frames (so no worker
# flush lands inside the stream), dropping each worker's warm-up/tail
# frames yields a stream BIT-IDENTICAL frame-for-frame to the serial
# no-reservoir encode of the same PCM (tests/test_parallel_mp3.py for the
# JAX package, tests/test_torch_mp3.py for this port: byte-identical to
# it and to the JAX package's segmented encoder).
#
# The default export path stays the serial reference-parity encoder
# (bit reservoir ON, like audio-io.cpp:809-831); the segmented encoder is
# chosen by open_sink only when >1 CPU is available (or forced via
# NODEY_MP3_WORKERS) since parallel LAME cannot help a 1-core host.

_MP3_FRAME = 1152          # MPEG-1 Layer III samples per frame
_SEG_WARM_FRAMES = 16      # preceding true-PCM frames fed to each worker
_SEG_TAIL_FRAMES = 4       # lookahead frames so worker flush is dropped
_SEG_SECONDS_DEFAULT = 24.0

_BITRATES = {
    None: 0, 0b0001: 32, 0b0010: 40, 0b0011: 48, 0b0100: 56, 0b0101: 64,
    0b0110: 80, 0b0111: 96, 0b1000: 112, 0b1001: 128, 0b1010: 160,
    0b1011: 192, 0b1100: 224, 0b1101: 256, 0b1110: 320,
}
_SAMPLERATES = {0b00: 44_100, 0b01: 48_000, 0b10: 32_000}


def _mp3_frames(data: bytes):
    """Yield (offset, size) of each MPEG-1 Layer III frame in ``data``.

    Only the grid this framework emits (LAME CBR, MPEG-1) is supported;
    anything else raises — the splicer must never guess."""
    pos, n = 0, len(data)
    while pos + 4 <= n:
        b0, b1, b2 = data[pos], data[pos + 1], data[pos + 2]
        if b0 != 0xFF or (b1 & 0xE0) != 0xE0:
            raise ProcessorRuntimeError(
                "MP3 splice lost frame sync",
                "A worker segment did not parse as MPEG-1 Layer III.",
                f"offset {pos}",
            )
        if (b1 & 0x18) != 0x18 or (b1 & 0x06) != 0x02:
            raise ProcessorRuntimeError(
                "MP3 splice: not MPEG-1 Layer III",
                "Segmented encode only supports the LAME CBR frames this "
                "framework emits.",
                f"header byte {b1:#x} at {pos}",
            )
        bitrate = _BITRATES.get(b2 >> 4)
        rate = _SAMPLERATES.get((b2 >> 2) & 0x3)
        if not bitrate or not rate:
            raise ProcessorRuntimeError(
                "MP3 splice: bad bitrate/samplerate index",
                "Segmented encode only supports LAME CBR frames.",
                f"byte {b2:#x} at {pos}",
            )
        padding = (b2 >> 1) & 0x1
        size = 144_000 * bitrate // rate + padding
        if pos + size > n:
            break  # truncated trailing frame: caller decides
        yield pos, size
        pos += size


def _is_info_tag(frame: bytes) -> bool:
    return b"Xing" in frame[:64] or b"Info" in frame[:64]


def _patch_info_tag(tag: bytearray, total_frames: int, total_bytes: int,
                    padding: int) -> bytes:
    """Update the segment-0 Xing/Info frame so its totals describe the
    SPLICED file: frame count, byte count, the LAME end-padding field, and
    the music-length field. (The tag CRC is zeroed rather than recomputed;
    decoders — FFmpeg's mp3 demuxer included — read delay/padding without
    verifying it, and a zero CRC marks the field as unset.)"""
    magic = tag.find(b"Xing")
    if magic < 0:
        magic = tag.find(b"Info")
    if magic < 0:
        return bytes(tag)
    flags = struct.unpack_from(">I", tag, magic + 4)[0]
    pos = magic + 8
    if flags & 1:
        struct.pack_into(">I", tag, pos, total_frames)
        pos += 4
    if flags & 2:
        struct.pack_into(">I", tag, pos, total_bytes)
        pos += 4
    if flags & 4:
        pos += 100  # TOC: CBR is linear, leave as written
    if flags & 8:
        pos += 4
    # LAME extension: 9-byte version string, then fixed offsets; the
    # delay/padding triple is 3 bytes at +21 (delay:12 | padding:12).
    lame = pos
    if lame + 36 <= len(tag):
        trip = int.from_bytes(tag[lame + 21:lame + 24], "big")
        delay = (trip >> 12) & 0xFFF     # keep encoder delay as written
        packed = (delay << 12) | (max(0, min(padding, 0xFFF)))
        tag[lame + 21:lame + 24] = packed.to_bytes(3, "big")
        struct.pack_into(">I", tag, lame + 28, total_bytes)
        tag[lame + 34:lame + 36] = b"\x00\x00"  # tag CRC: unset
    return bytes(tag)


def _tag_encoder_delay(tag: bytes) -> int:
    """Encoder delay recorded in a LAME Info tag (0 if unreadable)."""
    magic = tag.find(b"Xing")
    if magic < 0:
        magic = tag.find(b"Info")
    if magic < 0:
        return 0
    flags = struct.unpack_from(">I", tag, magic + 4)[0]
    pos = magic + 8
    pos += 4 if flags & 1 else 0
    pos += 4 if flags & 2 else 0
    pos += 100 if flags & 4 else 0
    pos += 4 if flags & 8 else 0
    if pos + 24 > len(tag):
        return 0
    return int.from_bytes(tag[pos + 21:pos + 24], "big") >> 12


class ParallelMp3Encoder:
    """Segmented multi-worker LAME encoder with the Mp3Encoder interface.

    Blocks buffer into frame-aligned segments; each segment encodes on a
    thread pool (ctypes releases the GIL inside libmp3lame, so separate
    LAME handles encode in true parallel on multi-core hosts) with WARM
    preceding frames + TAIL lookahead frames of real PCM; close() drops
    every worker's warm-up/tail frames and splices the rest — a gapless
    CBR stream on the exact serial frame grid (see module comment above
    for why bit-exact splitting is impossible and what this guarantees
    instead). Requires in_rate == out_rate (LAME's internal resampler
    would break the sample-to-frame alignment the splice relies on)."""

    def __init__(self, path: str, rate: int, channels: int, kbps: int,
                 fmt: str = "flt", out_rate: int = config.SAMPLE_RATE,
                 workers: int = 2,
                 seg_seconds: float = _SEG_SECONDS_DEFAULT):
        if rate != out_rate:
            raise ProcessorRuntimeError(
                "Segmented MP3 encode needs in_rate == out_rate",
                "LAME's internal resampler breaks frame alignment; "
                "resample in the graph or use the serial encoder.",
                f"in {rate} Hz vs out {out_rate} Hz",
            )
        self._path = path
        self._rate = int(rate)
        self._channels = int(channels)
        self._kbps = int(kbps)
        self._fmt = fmt
        self._closed = False
        seg_frames = max(8, int(seg_seconds * rate) // _MP3_FRAME)
        self._seg_len = seg_frames * _MP3_FRAME
        self._warm = _SEG_WARM_FRAMES * _MP3_FRAME
        self._tail = _SEG_TAIL_FRAMES * _MP3_FRAME
        self._buf: list = []          # pending blocks (channels-major)
        self._buf_n = 0
        self._total_in = 0            # true PCM samples written (per ch)
        self._context = None          # last WARM samples already consumed
        self._seg_index = 0
        self._futures: list = []
        self._tmpdir = tempfile.TemporaryDirectory(prefix="nodey_mp3_")
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, int(workers))
        )

    # -- buffering -------------------------------------------------------------

    def write(self, block: np.ndarray) -> None:
        if self._closed:
            raise ProcessorRuntimeError(
                "Encoder already closed",
                "ParallelMp3Encoder.write after close.", self._path,
            )
        if block.shape[1] == 0:
            return
        self._buf.append(block)
        self._buf_n += block.shape[1]
        self._total_in += block.shape[1]
        # Dispatch every full segment once its TAIL lookahead is buffered.
        while self._buf_n >= self._seg_len + self._tail:
            self._dispatch_segment(last=False)

    def _dispatch_segment(self, last: bool) -> None:
        joined = (
            np.concatenate(self._buf, axis=1) if self._buf
            else np.zeros((self._channels, 0), np.float32)
        )
        if last:
            seg = joined
            rest = joined[:, :0]
        else:
            seg = joined[:, : self._seg_len + self._tail]
            rest = joined[:, self._seg_len:]
        ctx = self._context
        if ctx is not None and ctx.shape[1]:
            pcm = np.concatenate([ctx, seg], axis=1)
            warm_frames = ctx.shape[1] // _MP3_FRAME
        else:
            pcm = seg
            warm_frames = 0
        keep_frames = (
            None if last
            else self._seg_len // _MP3_FRAME
        )
        idx = self._seg_index
        self._seg_index += 1
        tmp = f"{self._tmpdir.name}/seg_{idx:05d}.mp3"
        pcm = np.ascontiguousarray(pcm)
        self._futures.append(self._pool.submit(
            self._encode_segment, idx, pcm, tmp, warm_frames, keep_frames
        ))
        # Next segment's warm context = the tail of what this segment
        # consumed for real (not its TAIL lookahead).
        consumed_end = self._buf_n if last else self._seg_len
        ctx_start = max(0, consumed_end - self._warm)
        self._context = np.ascontiguousarray(
            joined[:, ctx_start:consumed_end]
        )
        self._buf = [rest] if rest.shape[1] else []
        self._buf_n = rest.shape[1]

    def _encode_segment(self, idx: int, pcm: np.ndarray, tmp: str,
                        warm_frames: int, keep_frames):
        """Worker: encode PCM to a temp file, return the retained bytes."""
        flags = 2 | (1 if idx > 0 else 0)  # no reservoir; tag on seg 0 only
        enc = Mp3Encoder(
            tmp, self._rate, self._channels, self._kbps, self._fmt,
            out_rate=self._rate, flags=flags,
        )
        enc.write(pcm)
        enc.close()
        with open(tmp, "rb") as f:
            data = f.read()
        frames = list(_mp3_frames(data))
        tag = None
        body_start = 0
        if idx == 0 and frames:
            # Segment 0 opens with the tag ENABLED (flags bit 0 clear), so
            # LAME's first frame is the Xing/Info frame by construction —
            # finalized by na_mp3_close via lame_get_lametag_frame.
            tag = data[frames[0][0]:frames[0][0] + frames[0][1]]
            body_start = 1
            if not _is_info_tag(tag):
                raise ProcessorRuntimeError(
                    "MP3 splice: segment 0 lacks a finalized Info tag",
                    "The native runtime did not finalize LAME's header "
                    "frame (libmp3lame without lame_get_lametag_frame?); "
                    "rebuild build/nodey_tpu_torch/native or use "
                    "NODEY_MP3_WORKERS=1.",
                    self._path,
                )
        audio = frames[body_start:]
        start = warm_frames
        end = len(audio) if keep_frames is None else start + keep_frames
        if end > len(audio) or start > len(audio):
            raise ProcessorRuntimeError(
                "MP3 splice: segment produced too few frames",
                "A worker's encode emitted fewer frames than the PCM it "
                "was fed should yield.",
                f"segment {idx}: {len(audio)} frames, want "
                f"[{start}:{end})",
            )
        kept = audio[start:end]
        if kept:
            lo = kept[0][0]
            hi = kept[-1][0] + kept[-1][1]
            body = data[lo:hi]
        else:
            body = b""
        return tag, body, len(kept)

    # -- finalization ----------------------------------------------------------

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            # Always dispatch a final flush segment: even with zero
            # leftover PCM the last `delay` true samples are still inside
            # LAME's pipeline and only a flush emits them.
            self._dispatch_segment(last=True)
            results = [f.result() for f in self._futures]
            total_frames = sum(r[2] for r in results)
            tag = results[0][0] if results else None
            bodies = [r[1] for r in results]
            body_bytes = sum(len(b) for b in bodies)
            with open(self._path, "wb") as out:
                if tag is not None:
                    total = body_bytes + len(tag)
                    # True end padding: the flush pads the stream to the
                    # 1152 grid past delay + real samples; decoders trim
                    # it via the LAME field.
                    delay = _tag_encoder_delay(tag)
                    padding = max(
                        0,
                        total_frames * _MP3_FRAME - delay - self._total_in,
                    )
                    out.write(_patch_info_tag(
                        bytearray(tag), total_frames, total,
                        padding=padding,
                    ))
                for b in bodies:
                    out.write(b)
        finally:
            self._pool.shutdown(wait=False)
            self._tmpdir.cleanup()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *rest):
        if exc_type is None:
            self.close()
        else:
            self._closed = True
            self._pool.shutdown(wait=False)
            self._tmpdir.cleanup()


def mp3_workers() -> int:
    """Effective segmented-encode worker count: NODEY_MP3_WORKERS wins;
    otherwise the CPU count (1 on single-core hosts => serial encoder —
    time-slicing LAME on one core only adds splice overhead)."""
    env = os.environ.get("NODEY_MP3_WORKERS")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            return 1
    return os.cpu_count() or 1


def open_sink(path: str, rate: int, channels: int, kbps: int,
              fmt: str = "flt"):
    """Export sink factory: ``.wav`` paths get the lossless incremental
    WavWriter; MP3 gets the segmented parallel encoder when more than one
    CPU is available AND the rate needs no LAME-side resample, else the
    serial reference-parity Mp3Encoder."""
    if path.lower().endswith((".wav", ".wave")):
        return WavWriter(path, rate, channels, fmt)
    workers = mp3_workers()
    if workers > 1 and rate == config.SAMPLE_RATE:
        return ParallelMp3Encoder(
            path, rate, channels, kbps, fmt, workers=workers
        )
    return Mp3Encoder(path, rate, channels, kbps, fmt)


def encode_mp3(path: str, data, rate: int, kbps: int, fmt: str = "flt",
               out_rate: int = config.SAMPLE_RATE, progress=None) -> None:
    """Encode planar [channels, n] PCM (a numpy array or a tensor on any
    device) to an MP3 file in one call, through the serial Mp3Encoder.

    ``progress``: optional callable(seconds_done) — the host-side stand-in
    for the reference's shared atomic<double> progress channel
    (include/processor/audio-io.hpp:67, app.cpp:2074).
    """
    if not isinstance(data, np.ndarray):
        data = data.detach().cpu().numpy()
    channels, n = data.shape
    with Mp3Encoder(path, rate, channels, kbps, fmt, out_rate) as enc:
        for start in range(0, n, _CHUNK):
            block = data[:, start : start + _CHUNK]
            enc.write(block)
            if progress is not None:
                progress((start + block.shape[1]) / rate)
