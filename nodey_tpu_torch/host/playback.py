"""Real-time audio-device playback sink, SDL2 by ctypes with the queue API
(the port's copy of nodey_tpu.host.playback).

The reference previews through an SDL queued-audio device: 48 kHz f32
stereo, 2048-sample buffer, backpressure by waiting while the queued bytes
exceed 3 packets (reference: src/frontend/sdl-context.cpp:40-59,
include/config.hpp:20-28, src/processor/audio-io.cpp:620-636). This module
reproduces that sink against libSDL2 loaded with ctypes, with no compiled
dependency. ``device_available()`` is False on a host without libSDL2 (a
headless server), where the WAV file sink and the wall-clock pacer
(host/streamio.RealtimePacer) stand in.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import time
from typing import Optional

from nodey_tpu_torch import config
from nodey_tpu_torch.core.errors import ProcessorRuntimeError

_AUDIO_F32LSB = 0x8120          # SDL_AUDIO_F32LSB
_INIT_AUDIO = 0x00000010        # SDL_INIT_AUDIO


class _SDLAudioSpec(ctypes.Structure):
    _fields_ = [
        ("freq", ctypes.c_int),
        ("format", ctypes.c_uint16),
        ("channels", ctypes.c_uint8),
        ("silence", ctypes.c_uint8),
        ("samples", ctypes.c_uint16),
        ("padding", ctypes.c_uint16),
        ("size", ctypes.c_uint32),
        ("callback", ctypes.c_void_p),
        ("userdata", ctypes.c_void_p),
    ]


def _load_sdl():
    for name in ("SDL2-2.0", "SDL2"):
        path = ctypes.util.find_library(name)
        if path:
            try:
                return ctypes.CDLL(path)
            except OSError:
                continue
    return None


def device_available() -> bool:
    """True when libSDL2 is present and an audio device can open."""
    return _load_sdl() is not None


class SdlPlaybackSink:
    """Queued-audio playback: call ``write(block)`` with planar float32
    [2, n] 48 kHz blocks; blocks are interleaved and queued, waiting while
    the device queue exceeds the reference's 3-packet cap — the same
    backpressure loop that paces the reference's preview at 1.0x
    (audio-io.cpp:620-624)."""

    def __init__(
        self,
        rate: int = config.SAMPLE_RATE,
        channels: int = 2,
        buffer_samples: int = config.BUFFER_SIZE,
        max_packets: int = config.MAX_BUFFER_ITEMS,
    ):
        sdl = _load_sdl()
        if sdl is None:
            raise ProcessorRuntimeError(
                "Audio device unavailable",
                "libSDL2 is not present on this host; use the WAV file "
                "sink or the realtime pacer instead.",
                "SdlPlaybackSink",
            )
        self._sdl = sdl
        if sdl.SDL_Init(_INIT_AUDIO) != 0:
            raise ProcessorRuntimeError(
                "Audio device unavailable",
                "SDL_Init(SDL_INIT_AUDIO) failed — no usable audio "
                "backend on this host.",
                sdl.SDL_GetError().decode()
                if isinstance(sdl.SDL_GetError(), bytes) else "SDL_Init",
            )
        want = _SDLAudioSpec(
            freq=rate, format=_AUDIO_F32LSB, channels=channels,
            samples=buffer_samples,
        )
        have = _SDLAudioSpec()
        sdl.SDL_OpenAudioDevice.restype = ctypes.c_uint32
        self._dev = sdl.SDL_OpenAudioDevice(
            None, 0, ctypes.byref(want), ctypes.byref(have), 0
        )
        if self._dev == 0:
            raise ProcessorRuntimeError(
                "Audio device unavailable",
                "SDL_OpenAudioDevice returned no device.",
                "SdlPlaybackSink",
            )
        self.rate = rate
        self.channels = channels
        # Backpressure bound: 3 packets of the device buffer, like the
        # reference's max_buffer_size (config.hpp:24-25).
        self._max_queued_bytes = (
            max_packets * buffer_samples * channels * 4
        )
        sdl.SDL_PauseAudioDevice(self._dev, 0)  # start playback

    def write(self, block) -> None:
        import numpy as np

        interleaved = np.ascontiguousarray(
            np.asarray(block, dtype=np.float32).T
        )
        sdl = self._sdl
        sdl.SDL_GetQueuedAudioSize.restype = ctypes.c_uint32
        while (
            sdl.SDL_GetQueuedAudioSize(self._dev) > self._max_queued_bytes
        ):
            time.sleep(0.002)
        rc = sdl.SDL_QueueAudio(
            self._dev,
            interleaved.ctypes.data_as(ctypes.c_void_p),
            interleaved.nbytes,
        )
        if rc != 0:
            raise ProcessorRuntimeError(
                "Audio playback failed",
                "SDL_QueueAudio rejected the block.",
                "SdlPlaybackSink.write",
            )

    def drain(self, timeout: float = 10.0) -> None:
        deadline = time.time() + timeout
        self._sdl.SDL_GetQueuedAudioSize.restype = ctypes.c_uint32
        while (
            self._sdl.SDL_GetQueuedAudioSize(self._dev) > 0
            and time.time() < deadline
        ):
            time.sleep(0.01)

    def close(self) -> None:
        if getattr(self, "_dev", 0):
            self._sdl.SDL_CloseAudioDevice(self._dev)
            self._dev = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def make_preview_sink(wav_path: Optional[str] = None):
    """Best sink for this host: a real audio device when present, else a
    WAV file sink (the survey's headless CI target, SURVEY.md §4.3).
    Returns (sink_callable, close_callable, kind)."""
    if device_available():
        try:
            dev = SdlPlaybackSink()
            return dev.write, dev.close, "sdl"
        except ProcessorRuntimeError:
            pass
    if wav_path is None:
        raise ProcessorRuntimeError(
            "No preview sink available",
            "No audio device is present and no WAV path was given.",
            "make_preview_sink",
        )
    import numpy as np

    blocks = []

    def sink(block):
        blocks.append(np.asarray(block).copy())

    def close():
        from nodey_tpu_torch.host import decode as host_decode

        if blocks:
            host_decode.write_wav(
                wav_path, np.concatenate(blocks, axis=1), config.SAMPLE_RATE
            )

    return sink, close, "wav"
