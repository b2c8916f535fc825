"""Mixer ops: the amix weighted sum, the bimix channel combiners (v1 and
v2) and the channel split (port of nodey_tpu.ops.mix).

Every mixer input is normalized to 48 kHz stereo float by the resampler
(the reference's per-input SwrContext, audio-amix.cpp:206-243,
audio-bimix.cpp:196-243), with libswresample's -3 dB mono upmix, then
combined elementwise with float32 weights. Early-ending inputs contribute
zero padding; the output runs to the longest input. A batch of clips
(``[B, C, N]``, one host length a clip) takes the same ops: channels are
the second axis from the end, and each clip's output runs to its own
longest input (``max_length``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nodey_tpu_torch import config
from nodey_tpu_torch.core.stream import (FMT_FLT, Stream, map_lengths,
                                         max_length)
from nodey_tpu_torch.ops import resample as resample_ops


def _pad_to(data: torch.Tensor, capacity: int) -> torch.Tensor:
    if data.shape[-1] == capacity:
        return data
    return F.pad(data, (0, capacity - data.shape[-1]))


def _common_grid(streams: Sequence[Stream]) -> Tuple[List[Stream], int]:
    """Normalize every stream to 48 kHz stereo; returns them with the
    largest capacity among them."""
    normed = [
        resample_ops.to_rate_and_stereo(s, config.AMIX_STD_SAMPLE_RATE)
        for s in streams
    ]
    return normed, max(s.capacity for s in normed)


def amix(streams: Sequence[Stream], volumes: Sequence[float]) -> Stream:
    """out[ch][j] = sum_i in_i[ch][j] * volumes[i] (volumes cast to float32
    before the multiply, as in the JAX package). Batched streams mix clip by
    clip; each clip's output runs to its own longest input."""
    normed, capacity = _common_grid(streams)
    acc = torch.zeros((*normed[0].data.shape[:-2], 2, capacity),
                      dtype=torch.float32, device=normed[0].data.device)
    for s, vol in zip(normed, volumes):
        acc = acc + _pad_to(s.data, capacity) * float(np.float32(vol))
    return Stream(
        data=acc,
        length=max_length([s.length for s in normed]),
        rate=config.AMIX_STD_SAMPLE_RATE,
        channels=2,
        fmt=FMT_FLT,
        t0_us=0.0,
    )


def _side_mono(stream: Stream) -> Stream:
    """One bimix side: 48 kHz stereo through the resampler, then the mean of
    its two channels (audio-bimix.cpp:310-316 / 620-629)."""
    s = resample_ops.to_rate_and_stereo(stream, config.BIMIX_STD_SAMPLE_RATE)
    return s.with_data((s.data[..., 0:1, :] + s.data[..., 1:2, :]) * 0.5)


def bimix(left: Stream, right: Stream, bias: float) -> Stream:
    """v1: the two sides' monos paired from their first samples, left
    weighted by (1 - bias), right by (1 + bias) (audio-bimix.cpp:302-317)."""
    mono_l = _side_mono(left)
    mono_r = _side_mono(right)
    capacity = max(mono_l.capacity, mono_r.capacity)
    out = torch.cat([
        _pad_to(mono_l.data, capacity) * float(np.float32(1.0 - bias)),
        _pad_to(mono_r.data, capacity) * float(np.float32(1.0 + bias)),
    ], dim=-2)
    return Stream(
        data=out,
        length=max_length([mono_l.length, mono_r.length]),
        rate=config.BIMIX_STD_SAMPLE_RATE,
        channels=2,
        fmt=FMT_FLT,
        t0_us=0.0,
    )


def bimix_v2(left: Stream, right: Stream) -> Stream:
    """v2: each side's mono placed on a shared 48 kHz grid at its own start
    timestamp, zeros where a side has no samples (audio-bimix.cpp:776-872).
    The offsets round as the reference does (:817-824; Python's round agrees
    with its std::round on every integer-microsecond timestamp)."""
    mono_l = _side_mono(left)
    mono_r = _side_mono(right)
    rate = config.BIMIX_STD_SAMPLE_RATE
    t0 = min(mono_l.t0_us, mono_r.t0_us)
    off_l = round((mono_l.t0_us - t0) * 1e-6 * rate)
    off_r = round((mono_r.t0_us - t0) * 1e-6 * rate)
    capacity = max(off_l + mono_l.capacity, off_r + mono_r.capacity)

    def place(mono: Stream, off: int) -> torch.Tensor:
        return F.pad(mono.data, (off, capacity - off - mono.capacity))

    return Stream(
        data=torch.cat([place(mono_l, off_l), place(mono_r, off_r)], dim=-2),
        length=max_length([map_lengths(mono_l.length, lambda n: off_l + n),
                           map_lengths(mono_r.length, lambda n: off_r + n)]),
        rate=rate,
        channels=2,
        fmt=FMT_FLT,
        t0_us=t0,
    )


def split_channels(stream: Stream) -> Tuple[Stream, Stream]:
    """Stereo -> (left, right) mono streams; a mono stream goes to both. The
    origin format tag is kept, so a gain after the split keeps its integer
    clamp-then-truncate path."""
    if stream.channels == 1:
        return stream, stream
    return (stream.with_data(stream.data[..., 0:1, :]),
            stream.with_data(stream.data[..., 1:2, :]))
