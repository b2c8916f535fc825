"""Stream values flowing between nodes (port of nodey_tpu.core.stream).

An edge carries a planar ``[channels, N]`` float32 tensor plus its valid
length. The graph runs eagerly, so the length is a plain Python int and
not a traced scalar as in the JAX package. A batched run
(``CompiledGraph.run_batch``) carries ``[B, channels, N]`` with one valid
length per clip, a tuple of host ints, so that no step waits on the card
for a length; every shape still comes from the capacity, and the lengths
only set each clip's zero tail (``zero_tail``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple, Union

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

    data:     ``[channels, N]`` float32 tensor, or ``[B, channels, N]``
              for a batch of clips; samples at index >= length are zero
              padding.
    length:   number of valid samples per channel; for a batch, a tuple of
              the B clips' lengths.
    rate:     sample rate in Hz.
    channels: 1 or 2.
    fmt:      origin sample-format tag.
    t0_us:    stream start timestamp in microseconds.
    """

    data: torch.Tensor
    length: Union[int, Tuple[int, ...]]
    rate: int
    channels: int
    fmt: str = FMT_FLT
    t0_us: float = 0.0

    def __post_init__(self) -> None:
        if self.channels not in (1, 2):
            raise ValueError(f"channels must be 1 or 2, got {self.channels}")
        if self.data.dim() == 3:
            self.length = tuple(int(n) for n in self.length)
            if len(self.length) != self.data.shape[0]:
                raise ValueError(
                    f"a batch of {self.data.shape[0]} clips needs as many "
                    f"lengths, got {len(self.length)}")

    @property
    def batch(self):
        """The number of clips of a batched stream; None for one clip."""
        return self.data.shape[0] if self.data.dim() == 3 else None

    @property
    def capacity(self) -> int:
        """Padded length of the underlying buffer."""
        return self.data.shape[-1]

    def with_data(self, data: torch.Tensor, **overrides) -> "Stream":
        kw = dict(
            length=self.length,
            rate=self.rate,
            channels=data.shape[-2],
            fmt=self.fmt,
            t0_us=self.t0_us,
        )
        kw.update(overrides)
        return Stream(data=data, **kw)

    def valid_mask(self) -> torch.Tensor:
        """``[1, N]`` float32 mask of valid samples (``[B, 1, N]`` for a
        batch, each clip's own), on the stream's device."""
        idx = torch.arange(self.capacity, device=self.data.device)
        return (idx < device_lengths(self.length, self.data.device)
                ).to(torch.float32).expand(*self.data.shape[:-2], 1, -1)


def map_lengths(length, fn):
    """``fn`` applied to one clip's length, or to each of a batch's."""
    if isinstance(length, tuple):
        return tuple(fn(n) for n in length)
    return fn(length)


def zero_tail(data: torch.Tensor, length) -> torch.Tensor:
    """Zero ``data`` [C, N] past ``length``, or each clip of ``data``
    [B, C, N] past its own length (a tuple), in place; returns ``data``.
    A batch whose clips share one length takes one fill."""
    if not isinstance(length, tuple):
        data[..., length:] = 0.0
    elif len(set(length)) == 1:
        data[..., length[0]:] = 0.0
    else:
        for b, n in enumerate(length):
            data[b, :, n:] = 0.0
    return data


def max_length(lengths: Sequence):
    """The longest of several streams' lengths, clip by clip for batches."""
    if isinstance(lengths[0], tuple):
        return tuple(max(ns) for ns in zip(*lengths))
    return max(lengths)


def device_lengths(length, device):
    """A batch's lengths as int32 [B, 1, 1] on ``device``, to broadcast
    against its [B, C, N] data in position arithmetic; copied from pinned
    memory without waiting for the card. One clip's length stays a host
    int."""
    if not isinstance(length, tuple):
        return length
    host = torch.tensor(length, dtype=torch.int32).view(-1, 1, 1)
    if torch.device(device).type == "cuda":
        host = host.pin_memory()
    return host.to(device, non_blocking=True)


class AudioStreamType:
    """Pin product-type marker for audio streams of this package.

    Distinct from ``nodey_tpu.core.stream.AudioStreamType``: link checks
    compare markers by identity, and the port's processors link only to
    each other."""


class SpectrumStreamType:
    """Pin product-type marker for STFT spectrum streams (BASELINE config
    5) of this package."""
