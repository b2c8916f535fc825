"""Timeline editing ops, trim and reverse (port of nodey_tpu.ops.editops).

Both are pure index selection: no arithmetic touches a sample, so every
execution plan gives bitwise the same output, and the port's bitwise the
JAX package's. Trim streams with one input-position carry (a host int):
each step copies the chunk's surviving segment, a host slice, left-aligned
into a zeroed buffer, where the JAX step takes a traced dynamic slice.
Reverse is a whole-clip permutation; its node refuses the stream plan.
Offline, both take one clip [C, N] or a batch [B, C, N] with per-clip
lengths: trim's start is static, so one slice serves every clip, and each
clip reverses over its own length by one gather.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from nodey_tpu_torch.core.stream import (Stream, device_lengths,
                                         map_lengths, zero_tail)

_INT32_MAX = 2**31 - 1


def trim_spec(rate: int, start_s: float, end_s: float) -> Tuple[int, int]:
    """(n0, n1): first kept sample and one-past-last kept sample.
    ``end_s <= 0`` means "to the end" (n1 = INT32_MAX sentinel)."""
    n0 = max(0, round(float(start_s) * rate))
    n1 = round(float(end_s) * rate) if end_s > 0 else (2**31 - 1)
    return n0, max(n1, n0)


def trim_stream(stream: Stream, start_s: float, end_s: float) -> Stream:
    """Offline trim: keep [n0, n1) and close the gap to t=0. The buffer
    keeps the JAX package's capacity, ``max(cap - n0, 256)``, so the
    capacities downstream (and the spectrum's frame counts) are its
    own."""
    n0, n1 = trim_spec(stream.rate, start_s, end_s)
    cap = stream.capacity
    n0c = min(n0, cap)
    keep = max(cap - n0c, 256)
    new_len = map_lengths(stream.length, lambda n: min(
        max(min(n, min(n1, _INT32_MAX)) - n0, 0), keep))
    width = int(np.max(new_len))
    data = stream.data.new_zeros(stream.data.shape[:-1] + (keep,))
    data[..., :width] = stream.data[..., n0c:n0c + width]
    return stream.with_data(zero_tail(data, new_len), length=new_len)


# -- trim chunk streaming: one input-position carry (a host int) -------------


def trim_stream_init():
    return {"pos": 0}


def trim_stream_step(n0: int, n1: int, state, data: torch.Tensor, n: int,
                     done: bool):
    """One streamed chunk [C, width] with ``n`` valid samples: drop what
    lies before n0 or from n1 on, left-align the rest. Returns (state,
    out, n_out, done)."""
    pos = state["pos"]
    end = min(n1, _INT32_MAX)
    lo = min(max(n0 - pos, 0), n)
    hi = min(max(end - pos, 0), n)
    n_out = max(hi - lo, 0)
    out = torch.zeros_like(data)
    out[:, :n_out] = data[:, lo:lo + n_out]
    new_pos = pos + n
    return {"pos": new_pos}, out, n_out, done or new_pos >= end


# -- reverse -----------------------------------------------------------------


def reverse_stream(stream: Stream) -> Stream:
    """Whole-clip reverse: out[i] = x[length-1-i], each clip of a batch
    over its own length (the JAX form: a gather at clamped indices under
    a mask); the padding stays zero past the length."""
    data = stream.data
    cap = stream.capacity
    n = device_lengths(stream.length, data.device)
    i = torch.arange(cap, dtype=torch.int32, device=data.device)
    src = torch.clamp(n - 1 - i, 0, cap - 1).long()
    out = torch.gather(data, -1, src.expand(data.shape))
    return stream.with_data(torch.where(i < n, out, 0.0))
