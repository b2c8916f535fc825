"""Stream values flowing between nodes (port of nodey_tpu.core.stream).

An edge carries a planar ``[channels, N]`` float32 tensor plus its valid
length. The graph runs eagerly, so the length is a plain Python int and
not a traced scalar as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

# Sample-format tags (see nodey_tpu.core.stream for the integer-origin
# semantics they carry through the gain node and the encoders).
FMT_FLT = "flt"
FMT_S16 = "s16"
FMT_S32 = "s32"

# Integer PCM -> float scale (reference: src/processor/audio-velocity.cpp).
FMT_SCALE = {FMT_FLT: 1.0, FMT_S16: 32768.0, FMT_S32: 2147483648.0}


@dataclasses.dataclass
class Stream:
    """An audio stream value.

    data:     ``[channels, N]`` float32 tensor; samples at index >= length
              are zero padding.
    length:   number of valid samples per channel.
    rate:     sample rate in Hz.
    channels: 1 or 2.
    fmt:      origin sample-format tag.
    t0_us:    stream start timestamp in microseconds.
    """

    data: torch.Tensor
    length: int
    rate: int
    channels: int
    fmt: str = FMT_FLT
    t0_us: float = 0.0

    def __post_init__(self) -> None:
        if self.channels not in (1, 2):
            raise ValueError(f"channels must be 1 or 2, got {self.channels}")

    @property
    def capacity(self) -> int:
        """Padded length of the underlying buffer."""
        return self.data.shape[-1]

    def with_data(self, data: torch.Tensor, **overrides) -> "Stream":
        kw = dict(
            length=self.length,
            rate=self.rate,
            channels=data.shape[0],
            fmt=self.fmt,
            t0_us=self.t0_us,
        )
        kw.update(overrides)
        return Stream(data=data, **kw)


class AudioStreamType:
    """Pin product-type marker for audio streams of this package.

    Distinct from ``nodey_tpu.core.stream.AudioStreamType``: link checks
    compare markers by identity, and the port's processors link only to
    each other."""
