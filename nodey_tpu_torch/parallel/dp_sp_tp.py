"""dp x sp x tp composed (port of nodey_tpu.parallel.dp_sp_tp).

Each axis is proven alone elsewhere: dp and sp by ``parallel/sharded.py``
(a batch of clips x time shards with halos), tp by ``parallel/tp.py`` (the
reverb convolution's bin and sample columns). This module composes all
three over one 3-axis mesh:

1. **Stage 1 (dp x sp)**: the user's graph (the 5-node graph: input ->
   gain -> amix with the 44.1 -> 48 kHz resampler -> spectrum -> output)
   under ``compile_graph_sharded``: the clips shard over ``dp``, the sample
   axis over ``sp`` with halos, on the devices at tp index 0.
2. **Between the stages**: each dp shard's master pieces are gathered over
   sp (``gather_time``) onto its first tp device, and each clip's master
   is zeroed past its valid length, so the reverb tail sees the zeros a
   single render feeds it.
3. **Stage 2 (dp x tp)**: a convolution-reverb master-bus tail (the node
   math of ``audio_reverb``) per dp shard, its DFT bin and output sample
   columns sharded over ``tp`` by ``tp._conv_local``; the clip axis runs
   the DFT GEMMs clip by clip on one clip's shapes (``clips=True``).

A shard's devices come from ``Mesh.axis_devices`` with the other axes
fixed: dp shard d runs stage 1 on devices (d, s, 0) and stage 2 on (d, 0,
t), so its sp windows and its first tp columns share a device.

Against the single-device composition (``reference_pipeline``: the single
render -> the masked master -> ``ops.reverb.partitioned_conv``): stage 1 is
bitwise the single render; stage 2 equals the unsharded convolution to
float32 rounding (tp.py), so the composition sits at >= 130 dB and
max-abs <= 1e-6 of the peak (tests/test_torch_dp_sp_tp.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nodey_tpu_torch.core import compiler
from nodey_tpu_torch.core.graph import Graph
from nodey_tpu_torch.ops import reverb as reverb_ops
from nodey_tpu_torch.ops.scans import f32 as _f32, mask_tail
from nodey_tpu_torch.parallel import sharded, tp as tp_mod
from nodey_tpu_torch.parallel.mesh import Mesh
from nodey_tpu_torch.parallel.ops import gather_time, to_device


@dataclasses.dataclass
class DpSpTpCompiled:
    """The composed program and the geometry to feed and check it."""

    stage1: sharded.ShardedCompiledGraph
    mesh: Mesh
    cap_master: int               # stage-1 master capacity (per clip)
    cap_out: int                  # reverb output capacity (per clip)
    out_rate: int
    ir_len: int
    hr: np.ndarray                # partition spectra [C, K, BINS]
    hi: np.ndarray
    wet: float
    dry: float
    dp_axis: str
    tp_axis: str

    def run(self, arrays: Dict[str, Any], lengths: Dict[str, Any]
            ) -> Tuple[torch.Tensor, Tuple[int, ...]]:
        """``arrays[key]`` [B, C, capacity] (numpy, or tensors on the
        mesh's first device), ``lengths[key]`` B host ints. Returns (out
        [B, C, cap_out] on the mesh's first device, the B valid lengths)."""
        p_sz = reverb_ops.PARTITION
        t = -(-self.cap_out // p_sz)
        rows, row_lens = self.stage1.run_rows(arrays, lengths)
        home = self.mesh.devices.flat[0]
        outs, glens = [], ()
        for d, (pieces, lens) in enumerate(zip(rows, row_lens)):
            devices = self.mesh.axis_devices(self.tp_axis,
                                             **{self.dp_axis: d})
            # The gather over sp, onto this dp shard's first tp device;
            # each clip's master zeroed past its valid length.
            glen = lens["master"]
            master = mask_tail(gather_time(pieces["master"], devices[0]),
                               glen)
            x = F.pad(master, (0, t * p_sz - self.cap_master))
            seg = reverb_ops._segments(x)             # [b, C, T, F]
            y = tp_mod._conv_local(
                [to_device(seg, dev) for dev in devices],
                tp_mod._tp_operands(self.hr, self.hi, devices), clips=True)
            wetp = y[..., p_sz:].reshape(*x.shape[:-1], t * p_sz)
            dryp = F.pad(master, (0, self.cap_out - self.cap_master))
            out = (_f32(self.dry) * dryp
                   + _f32(self.wet) * wetp[..., :self.cap_out])
            outs.append(to_device(out, home))
            glens += tuple(n + self.ir_len - 1 for n in glen)
        return torch.cat(outs, dim=0), glens


def compile_flagship_reverb_dpsptp(
    graph: Graph,
    sources: Dict[Tuple[int, str], compiler.SourceSpec],
    mesh: Mesh,
    *,
    decay_s: float = 0.25,
    pre_delay_ms: float = 4.0,
    damping: float = 0.3,
    wet: float = 0.35,
    dry: float = 0.8,
    dp_axis: str = "dp",
    sp_axis: str = "sp",
    tp_axis: str = "tp",
    halo_seconds: float = 0.25,
) -> DpSpTpCompiled:
    """Compile ``graph`` for dp x sp execution with a tp-sharded reverb
    master-bus tail appended."""
    for axis in (dp_axis, sp_axis, tp_axis):
        if axis not in mesh.shape:
            raise ValueError(f"mesh must carry a '{axis}' axis")
    tp_mod._check_tp(mesh.shape[tp_axis])
    prog = sharded.compile_graph_sharded(
        graph, sources, mesh, mode="export", sp_axis=sp_axis,
        dp_axis=dp_axis, halo_seconds=halo_seconds)
    meta = prog.output_metadata()["master"]
    out_rate = int(meta["rate"])
    channels = int(meta.get("channels", 2))
    plan = prog.plan
    cap_master = plan.sp * plan.chunk * out_rate // plan.in_rate
    hr, hi, _ln = reverb_ops.ir_partitions(
        out_rate, channels, float(decay_s), float(pre_delay_ms),
        float(damping))
    ir_len = reverb_ops.ir_length(out_rate, decay_s, pre_delay_ms)
    p_sz = reverb_ops.PARTITION
    cap_out = cap_master + -(-ir_len // p_sz) * p_sz
    return DpSpTpCompiled(
        stage1=prog, mesh=mesh, cap_master=cap_master, cap_out=cap_out,
        out_rate=out_rate, ir_len=ir_len, hr=hr, hi=hi,
        wet=float(wet), dry=float(dry), dp_axis=dp_axis, tp_axis=tp_axis)


def reference_pipeline(
    graph: Graph,
    sources: Dict[Tuple[int, str], compiler.SourceSpec],
    arrays: Dict[str, Any],
    lengths: Dict[str, int],
    cap_master: int,
    cap_out: int,
    out_rate: int,
    *,
    decay_s: float = 0.25,
    pre_delay_ms: float = 4.0,
    damping: float = 0.3,
    wet: float = 0.35,
    dry: float = 0.8,
    device: torch.device | str = "cuda",
) -> Tuple[torch.Tensor, int]:
    """The same pipeline for ONE clip on one device: the single render ->
    the master zeroed past its length -> ``ops.reverb.partitioned_conv`` ->
    the same wet/dry law. Returns (out [C, cap_out] on ``device``, the
    valid length)."""
    channels = next(iter(sources.values())).channels
    caps = {
        k: dataclasses.replace(spec, capacity=arrays[
            compiler.external_key(*k)].shape[-1])
        for k, spec in sources.items()
    }
    inner = compiler.compile_graph(graph, caps, mode="export", device=device)
    args = {key: (to_device(torch.as_tensor(arrays[key]), inner.device),
                  int(lengths[key]))
            for key in inner.input_keys}
    out, _meta = inner(args)
    master, glen = out["master"]
    master = mask_tail(master[:, :cap_master], glen)
    hr, hi = reverb_ops.partitions(out_rate, channels, decay_s, pre_delay_ms,
                                   damping, inner.device)
    ir_len = reverb_ops.ir_length(out_rate, decay_s, pre_delay_ms)
    wetp = reverb_ops.partitioned_conv(master, hr, hi, cap_out)
    dryp = F.pad(master, (0, cap_out - cap_master))
    return _f32(dry) * dryp + _f32(wet) * wetp, glen + ir_len - 1
