"""The amix weighted mixer (port of nodey_tpu.ops.mix.amix).

Every input is normalized to 48 kHz stereo float by the resampler (the
reference's per-input SwrContext, audio-amix.cpp:206-243), then summed with
its float32 volume (audio-amix.cpp:296-307). Early-ending inputs contribute
zero padding; the output runs to the longest input.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nodey_tpu_torch import config
from nodey_tpu_torch.core.stream import FMT_FLT, Stream
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
    before the multiply, as in the JAX package)."""
    normed, capacity = _common_grid(streams)
    acc = torch.zeros((2, capacity), dtype=torch.float32,
                      device=normed[0].data.device)
    for s, vol in zip(normed, volumes):
        acc = acc + _pad_to(s.data, capacity) * float(np.float32(vol))
    return Stream(
        data=acc,
        length=max(s.length for s in normed),
        rate=config.AMIX_STD_SAMPLE_RATE,
        channels=2,
        fmt=FMT_FLT,
        t0_us=0.0,
    )
