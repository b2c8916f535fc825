"""Per-sample gain with origin-format arithmetic (port of nodey_tpu.ops.gain).

Bit-exact with ``nodey_tpu.ops.gain._gain_array``: the same float32
operation order — ``data*scale*volume``, clip, ``trunc``, ``/scale`` —
with every scalar a float32 value, so nothing widens to float64. The
reference is ``apply_volume<T>`` (src/processor/audio-vol.cpp:14-29).
Elementwise work; PyTorch's own kernels run it on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from nodey_tpu_torch.core.stream import FMT_FLT, FMT_S16, FMT_S32, Stream

# Integer clamp bounds as float32 (audio-vol.cpp:17-27). float32(INT32_MAX)
# rounds UP to 2^31 — kept, as in the JAX package.
_CLAMP = {
    FMT_S16: (-32768.0, 32767.0),
    FMT_S32: (-2147483648.0, 2147483648.0),
}


def _f32(value: float) -> float:
    """``value`` rounded to float32, as a Python float (exact in float32,
    so torch's float32 kernels see the same scalar as ``xp.float32``)."""
    return float(np.float32(value))


def gain_array(data: torch.Tensor, volume: float, fmt: str) -> torch.Tensor:
    volume = _f32(volume)
    if fmt == FMT_FLT:
        return data * volume
    lo, hi = _CLAMP[fmt]
    scale = -lo
    scaled = data * scale * volume
    clipped = torch.clamp(scaled, lo, hi)
    return torch.trunc(clipped) / scale


def apply_gain(stream: Stream, volume: float) -> Stream:
    return stream.with_data(gain_array(stream.data, volume, stream.fmt))
