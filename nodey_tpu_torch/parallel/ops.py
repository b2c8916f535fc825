"""Collectives and sharded pipeline ops (port of nodey_tpu.parallel.ops).

The JAX package runs a sharded program under ``shard_map``: one body per
device, collectives (``lax.ppermute``, ``lax.psum``) between them. Here a
sharded program is a loop over the shards of a mesh axis, stage by stage,
and a collective is a plain function over the LIST of the shards' tensors
(index = position on the axis):

* ``ppermute`` moves each source shard's tensor to its destination's
  device (``to_device``: ``Tensor.to(device, non_blocking=True)`` to a
  card; on a virtual mesh of one card the copy is a no-op, across cards a
  peer copy ordered after the source's stream); a shard no pair addresses
  receives zeros;
* ``psum`` sums host ints (lengths stay host ints, so no step waits on a
  device for one);
* ``all_gather`` concatenates the shards' tensors along an axis, one copy
  on each device of the shards;
* ``halo_exchange_nd`` fetches neighbors' tails and heads, several hops
  where a halo is wider than a shard, with zeros past the edges.

No thread and no process group: one process queues every shard's work on
its device's current stream, as JAX's single controller does. The one
exception is the mesh that spans processes (``parallel.dcn``): there a
shard held by another process is ``None`` in the list, and
``halo_exchange_nd`` takes that mesh's ``permute``, which moves the pairs
that cross processes through ``torch.distributed``.

The polyphase resampler's receptive field is its tap span, so sharding the
time axis needs a halo of tap-sized edges between neighbor shards. With
shard lengths aligned to the downsample stride M (times the grouped GEMM's
cycle factor), the shards' outputs concatenate to the single render.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from nodey_tpu_torch.ops import resample as resample_ops
from nodey_tpu_torch.parallel.mesh import Mesh


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``, itself where it is there already. A copy to a
    card is queued without waiting (ordered after the source's stream); a
    copy to the host waits, so its values are there when it returns."""
    return t.to(device, non_blocking=torch.device(device).type == "cuda")


def ppermute(xs: Sequence[torch.Tensor],
             perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """``out[dst] = xs[src]`` on ``xs[dst]``'s device for every (src, dst)
    pair, zeros of ``xs[dst]``'s shape where no pair ends (as
    ``lax.ppermute``). The result may alias ``xs``: callers never write
    into it."""
    out = [None] * len(xs)
    for src, dst in perm:
        out[dst] = to_device(xs[src], xs[dst].device)
    return [o if o is not None else torch.zeros_like(x)
            for o, x in zip(out, xs)]


def psum(values: Sequence[int]) -> int:
    """The sum of the shards' host ints (``lax.psum`` of a length)."""
    return sum(int(v) for v in values)


def all_gather(xs: Sequence[torch.Tensor], dim: int) -> List[torch.Tensor]:
    """Every shard's tensor concatenated along ``dim`` (axis order), on each
    shard's device (``lax.all_gather(..., tiled=True)``). Shards on one
    device share one copy: callers never write into it."""
    gathered = {}
    out = []
    for x in xs:
        if x.device not in gathered:
            gathered[x.device] = torch.cat(
                [to_device(y, x.device) for y in xs], dim=dim)
        out.append(gathered[x.device])
    return out


def _halo_exchange(xs: Sequence[torch.Tensor], left_halo: int,
                   right_halo: int) -> List[torch.Tensor]:
    """Fetch tail/head slices of [C, N] shards from the previous/next
    shard (time order = axis order). Edge shards receive zeros, matching
    the zero padding of the unsharded op."""
    size = len(xs)
    lefts = [x.new_zeros((x.shape[0], left_halo)) for x in xs]
    rights = [x.new_zeros((x.shape[0], right_halo)) for x in xs]
    if size > 1:
        if left_halo:
            # shard i sends its tail to shard i+1
            lefts = ppermute([x[:, -left_halo:] for x in xs],
                             [(i, i + 1) for i in range(size - 1)])
        if right_halo:
            # shard i sends its head to shard i-1
            rights = ppermute([x[:, :right_halo] for x in xs],
                              [(i + 1, i) for i in range(size - 1)])
    return [torch.cat([lf, x, rt], dim=1)
            for lf, x, rt in zip(lefts, xs, rights)]


def halo_exchange_nd(xs: Sequence[Optional[torch.Tensor]], left_halo: int,
                     right_halo: int, permute=ppermute
                     ) -> List[Optional[torch.Tensor]]:
    """``_halo_exchange`` generalized to ``[..., N]`` shards (time axis
    last).

    Shard i receives the previous shards' tails as its left halo and the
    next shards' heads as its right halo; edge shards receive zeros
    (matching the zero padding of the unsharded computation). Halos WIDER
    than one shard fetch from several neighbors: ceil(halo/N) hops each way
    (a one-hop exchange would clamp the slice and corrupt the window).

    A shard that another process holds is ``None`` in ``xs`` and in the
    result; ``permute`` (``ppermute``'s signature) then moves the pairs
    that cross processes (``dcn.DistPermute``)."""
    size = len(xs)
    N = next(x for x in xs if x is not None).shape[-1]

    def cut(sl):
        return [None if x is None else x[..., sl] for x in xs]

    def zeros(segs):
        return [None if s is None else torch.zeros_like(s) for s in segs]

    def from_left(hop: int, width: int):
        """The LAST ``width`` samples of shard (i - hop), zeros off-edge."""
        segs = cut(slice(N - width, None))
        if size <= hop:
            return zeros(segs)
        return permute(segs, [(i, i + hop) for i in range(size - hop)])

    def from_right(hop: int, width: int):
        """The FIRST ``width`` samples of shard (i + hop), zeros off-edge."""
        segs = cut(slice(None, width))
        if size <= hop:
            return zeros(segs)
        return permute(segs, [(i + hop, i) for i in range(size - hop)])

    parts = []
    if left_halo:
        hops = -(-left_halo // N)
        # The farthest hop contributes only the remainder; nearer hops are
        # whole shards.
        widths = [left_halo - (hops - 1) * N] + [N] * (hops - 1)
        parts.extend(from_left(h, w)
                     for h, w in zip(range(hops, 0, -1), widths))
    parts.append(list(xs))
    if right_halo:
        hops = -(-right_halo // N)
        widths = [N] * (hops - 1) + [right_halo - (hops - 1) * N]
        parts.extend(from_right(h, w)
                     for h, w in zip(range(1, hops + 1), widths))
    if len(parts) == 1:
        return list(xs)
    return [None if xs[i] is None else torch.cat([p[i] for p in parts], dim=-1)
            for i in range(size)]


def split_time(data: torch.Tensor, devices: Sequence[torch.device]
               ) -> List[torch.Tensor]:
    """``data [..., N]`` cut into len(devices) equal time chunks, chunk i
    on ``devices[i]`` (N must divide evenly)."""
    sp = len(devices)
    if data.shape[-1] % sp:
        raise ValueError(f"time length {data.shape[-1]} not divisible by "
                         f"sp={sp}")
    return [to_device(c, d)
            for c, d in zip(torch.chunk(data, sp, dim=-1), devices)]


def gather_time(parts: Sequence[torch.Tensor],
                device: torch.device) -> torch.Tensor:
    """The shards' time chunks concatenated on ``device``."""
    return torch.cat([to_device(p, device) for p in parts], dim=-1)


def sharded_resample(mesh: Mesh, data, in_rate: int, out_rate: int,
                     sp_axis: str = "sp", batch_axes: tuple = ()):
    """Resample ``[..., C, N]`` with the time axis sharded over ``sp_axis``;
    returns the whole output on the mesh's first device.

    N must be divisible by (M * group * sp) where L/M is the reduced ratio;
    pad to ``sharded_time_quantum`` first. Leading batch axes shard over
    ``batch_axes`` (dp). Exactness: local groups start at multiples of M,
    so the concatenated local outputs equal the single-device polyphase
    output; each shard's window runs ``resample.apply_filter_bank`` (the
    polyphase kernel on a card)."""
    data = torch.as_tensor(data)
    L, M = resample_ops._rational(in_rate, out_rate)
    sp = mesh.shape[sp_axis]
    N = data.shape[-1]
    quant = M * resample_ops.group_factor(L, M) * sp
    if N % quant != 0:
        raise ValueError(
            f"time length {N} not divisible by M*group*sp={quant}"
        )
    _, left_halo, W = resample_ops.bank_spec(in_rate, out_rate)
    # The last local group reads [g*M, g*M + W): W - M past the shard end.
    right_halo = W - M
    home = mesh.devices.flat[0]
    lead = data.shape[:-2]
    dp = int(np.prod([mesh.shape[a] for a in batch_axes])) if batch_axes else 1
    if dp > 1 and (len(lead) == 0 or lead[0] % dp):
        raise ValueError(f"batch {tuple(lead)} not divisible over "
                         f"{batch_axes} ({dp} shards)")
    rows = []
    for d, part in enumerate(torch.chunk(data, dp, dim=0) if dp > 1
                             else [data]):
        at = dict(zip(batch_axes, np.unravel_index(
            d, [mesh.shape[a] for a in batch_axes]))) if batch_axes else {}
        devices = mesh.axis_devices(sp_axis, **{k: int(v)
                                               for k, v in at.items()})
        x3 = part.reshape((-1,) + part.shape[-2:])
        exts = halo_exchange_nd(split_time(x3, devices), left_halo,
                                right_halo)
        outs = []
        for ext, dev in zip(exts, devices):
            bank, support = resample_ops._device_bank(in_rate, out_rate, dev)
            Gl = (ext.shape[-1] - left_halo - right_halo) // M
            outs.append(resample_ops.apply_filter_bank(
                ext.contiguous(), Gl, M, W, bank, support))
        y = gather_time(outs, home)
        rows.append(y.reshape(part.shape[:-1] + y.shape[-1:]))
    return torch.cat(rows, dim=0) if dp > 1 else rows[0]


def sharded_time_quantum(mesh: Mesh, in_rate: int, out_rate: int,
                         sp_axis: str = "sp") -> int:
    """Pad quantum that makes a time length valid for sharded_resample:
    shard boundaries also respect the grouped GEMM's cycle-group phase
    (``resample.group_factor``)."""
    L, M = resample_ops._rational(in_rate, out_rate)
    return M * resample_ops.group_factor(L, M) * mesh.shape[sp_axis]


def shard_batch(mesh: Mesh, array, dp_axis: str = "dp"
                ) -> List[torch.Tensor]:
    """A [B, ...] array cut into the dp shards' equal batch slices, slice d
    on the device at dp index d."""
    array = torch.as_tensor(array)
    devices = mesh.axis_devices(dp_axis)
    if array.shape[0] % len(devices):
        raise ValueError(f"batch {array.shape[0]} not divisible by "
                         f"{dp_axis}={len(devices)}")
    return [to_device(c, d)
            for c, d in zip(torch.chunk(array, len(devices), dim=0), devices)]
