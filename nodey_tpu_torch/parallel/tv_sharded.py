"""Sequence-parallel (sp) execution of TIME-VARIANT processing chains (port
of nodey_tpu.parallel.tv_sharded).

WSOLA's serial splice chain makes the sample axis unshardable, so graphs
with WSOLA tempo stages ride the mesh only as whole clips
(``sharded.compile_graph_dp``). The phase vocoder (``algorithm="pv"`` on
the velocity and pitch nodes) has no such chain: its one cross-frame
coupling is an associative phasor prefix (``pv_sharded``). This module
composes it with the other stages' local steps, so a whole linear chain
input -> ... -> output runs time-sharded. Each stage maps (the shards'
chunks [C, c_in], the global length) -> (the shards' chunks [C, c_out],
the global length), with collectives between the shards:

* **gain**: elementwise;
* **resample** (audio_resample, a transposition): ``halo_exchange_nd``
  fetches the polyphase receptive field (left = the bank's left pad,
  right = W - M) and each shard's window runs ``resample.apply_filter_bank``
  (the polyphase kernel on a card) at its global phase: per-shard chunks
  are aligned to M * group_factor;
* **pv tempo**: ``pv_sharded.pv_sharded_local_step`` (frames split evenly,
  the cross-shard phasor prefix, the OLA tail handoff; the lock kernel on
  each shard);
* **limiter, compressor, gate, de-esser** (ops/dynamics.py): the detectors'
  carries as exclusive cross-shard prefixes (max-plus, affine), one scalar
  a shard a step;
* **EQ / filter** (ops/biquad.py): exact AR(1) state prefixes;
* **tremolo, chorus, phaser, fade** (ops/modfx.py, ops/phaser.py,
  ops/fadepan.py): analytic time variance, each shard's LFO or ramp from
  its global offset; the chorus adds a finite halo and the phaser an
  affine doubling of each stage's state;
* **pan, width**: memoryless channel maps.

Alignment planning runs BACKWARD through the chain: a resample stage needs
its input chunk divisible by M * lcm(R, req/gcd(L, req)), ``req`` being
everything downstream's need; a PV stage absorbs the downstream need into
its K_per (``plan_pv_sharded(k_per_align=...)``) and resets it to 1. The
forward pass then fixes the chunks and the input capacity (``sp * c0``).

Against the single render (core/compiler.compile_graph of the same
nodes): LTI stages compute the same sums at the same global phases; a PV
stage agrees up to float32 re-association of the phasor products, and a
chain of two PV stages less (the second stage's instantaneous frequency
amplifies the first's last-ulp differences; the JAX package's tests
document the same floor). WSOLA nodes, non-linear graphs and several
sources are refused.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from nodey_tpu_torch.core import compiler
from nodey_tpu_torch.core.errors import ProcessorRuntimeError
from nodey_tpu_torch.core.graph import Graph
from nodey_tpu_torch.ops import pv as pv_ops
from nodey_tpu_torch.ops import resample as resample_ops
from nodey_tpu_torch.ops.scans import mask_tail
from nodey_tpu_torch.parallel.mesh import Mesh
from nodey_tpu_torch.parallel.ops import (gather_time, halo_exchange_nd,
                                          split_time)
from nodey_tpu_torch.parallel.pv_sharded import (PvShardPlan,
                                                 plan_pv_sharded,
                                                 pv_sharded_local_step)


# -- stage descriptors ------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _GainStage:
    volume: float


@dataclasses.dataclass
class _ResampleStage:
    """One polyphase stage: an audio_resample node (the Stream length law,
    the rate changes) or a transposition (the nominal rate unchanged,
    ``transpose_rate``'s ceil law on the UNREDUCED num/den pair)."""

    L: int
    M: int
    W: int
    left: int
    R: int
    bank: np.ndarray
    law_num: int          # length law: ceil(length * law_den / law_num)
    law_den: int
    rate_out: int         # nominal rate after this stage


@dataclasses.dataclass(frozen=True)
class _LimiterStage:
    """audio_limiter: the cross-shard max-plus prefix
    (dynamics.limiter_sharded_local)."""

    threshold: float
    c: float


@dataclasses.dataclass(frozen=True)
class _CompressorStage:
    """audio_compressor: max-plus release and affine attack prefixes
    (dynamics.compressor_sharded_local)."""

    params: Any


@dataclasses.dataclass(frozen=True)
class _DeesserStage:
    """audio_deesser: the sharded band (biquad.cascade_sharded_local) into
    the sharded detector (dynamics.deesser_sharded_local)."""

    sections: Tuple[Any, ...]
    params: Any


@dataclasses.dataclass(frozen=True)
class _TremoloStage:
    """audio_tremolo: the LFO gain from each shard's global offset, no
    communication (modfx.tremolo_sharded_local)."""

    rate_hz: float
    depth: float
    sample_rate: int


@dataclasses.dataclass(frozen=True)
class _ChorusStage:
    """audio_chorus: a finite receptive field by halo exchange plus the
    shard-offset phase (modfx.chorus_sharded_local)."""

    rate_hz: float
    base_ms: float
    depth_ms: float
    voices: int
    wet: float
    dry: float
    sample_rate: int


@dataclasses.dataclass(frozen=True)
class _PhaserStage:
    """audio_phaser: each allpass stage's state across shards by an affine
    doubling, plus a one-sample left halo a stage
    (phaser.phaser_sharded_local)."""

    rate_hz: float
    f_min_hz: float
    f_max_hz: float
    stages: int
    wet: float
    dry: float
    sample_rate: int


@dataclasses.dataclass(frozen=True)
class _PanStage:
    """audio_pan: memoryless per-channel gain (may widen mono to stereo)."""

    pan: float


@dataclasses.dataclass(frozen=True)
class _WidthStage:
    """audio_width: memoryless mid/side channel matrix."""

    width: float


@dataclasses.dataclass(frozen=True)
class _FadeStage:
    """audio_fade: the envelope gain from each shard's global offset
    (fadepan.fade_sharded_local)."""

    spec: Any


@dataclasses.dataclass(frozen=True)
class _GateStage:
    """audio_gate: the compressor's sharded detector with the gate's curve
    (dynamics.gate_sharded_local)."""

    params: Any


@dataclasses.dataclass(frozen=True)
class _BiquadStage:
    """audio_eq / audio_filter: exact cross-shard AR(1) state prefixes
    (biquad.cascade_sharded_local)."""

    sections: Tuple[Any, ...]


@dataclasses.dataclass
class _PvStage:
    tempo: float
    rate: int
    transient: bool = False              # onset phase reset (ops/pv.py)
    formant_ratio: float = 1.0           # envelope pre-warp (ops/pv.py)
    plan: Optional[PvShardPlan] = None   # filled by the forward pass


_EPS = 1e-9


# -- chain extraction -------------------------------------------------------


def _linear_chain(graph: Graph) -> List[int]:
    """Node ids of a single linear chain input -> ... -> output, in order;
    raises for any other shape."""
    from nodey_tpu_torch.processors.audio_input import AudioInput
    from nodey_tpu_torch.processors.audio_output import AudioOutput

    starts = [nid for nid, n in graph.nodes.items()
              if isinstance(n.processor, AudioInput)]
    if len(starts) != 1:
        raise ProcessorRuntimeError(
            "Chain sharding needs exactly one input node",
            "compile_chain_sp_tv shards linear chains; multi-input graphs "
            "run via compile_graph_sharded (LTI) or compile_graph_dp.",
            f"found {len(starts)} audio_input nodes",
        )
    succ: Dict[int, List[int]] = {}
    for link in graph.links.values():
        a = graph.pins[link.from_pin].parent
        b = graph.pins[link.to_pin].parent
        succ.setdefault(a, []).append(b)

    order = [starts[0]]
    seen = {starts[0]}
    while True:
        nxt = succ.get(order[-1], [])
        if not nxt:
            break
        if len(nxt) != 1 or nxt[0] in seen:
            raise ProcessorRuntimeError(
                "Graph is not a linear chain",
                "compile_chain_sp_tv shards single-path chains only; "
                "fan-out/fan-in graphs run via compile_graph_sharded or "
                "compile_graph_dp.",
                f"node {order[-1]} has successors {sorted(nxt)}",
            )
        order.append(nxt[0])
        seen.add(nxt[0])
    if not isinstance(graph.nodes[order[-1]].processor, AudioOutput):
        raise ProcessorRuntimeError(
            "Chain does not terminate in an audio output",
            "The last node of the chain must be audio_output.",
            f"terminal node {order[-1]}",
        )
    return order


def _resample_stage(in_rate: int, out_rate: int, law_num: int,
                    law_den: int, nominal_rate: int) -> _ResampleStage:
    L, M = resample_ops._rational(in_rate, out_rate)
    bank_np, left, W = resample_ops.bank_spec(in_rate, out_rate)
    return _ResampleStage(
        L=L, M=M, W=W, left=left, R=resample_ops.group_factor(L, M),
        bank=bank_np, law_num=law_num, law_den=law_den,
        rate_out=nominal_rate,
    )


def _extract_stages(graph: Graph, rate: int) -> Tuple[List[Any], int]:
    """Map the chain's nodes to stage descriptors; returns (stages,
    out_rate)."""
    from nodey_tpu_torch.ops import dynamics as dynamics_ops
    from nodey_tpu_torch.ops.stretch import _rational_factor
    from nodey_tpu_torch.processors.audio_vol import AudioVol
    from nodey_tpu_torch.processors.compressor import AudioCompressor
    from nodey_tpu_torch.processors.deesser import AudioDeesser
    from nodey_tpu_torch.processors.equalizer import AudioEq, AudioFilter
    from nodey_tpu_torch.processors.fade import AudioFade
    from nodey_tpu_torch.processors.gate import AudioGate
    from nodey_tpu_torch.processors.limiter import AudioLimiter
    from nodey_tpu_torch.processors.modulation import (AudioChorus,
                                                       AudioPhaser,
                                                       AudioTremolo)
    from nodey_tpu_torch.processors.pan import AudioPan, AudioWidth
    from nodey_tpu_torch.processors.resample_node import AudioResample
    from nodey_tpu_torch.processors.velocity import (PitchModifier,
                                                     VelocityModifier)

    order = _linear_chain(graph)
    stages: List[Any] = []
    for nid in order[1:-1]:
        proc = graph.nodes[nid].processor
        if isinstance(proc, AudioVol):
            stages.append(_GainStage(volume=float(proc.volume)))
        elif isinstance(proc, AudioLimiter):
            threshold, c = dynamics_ops.limiter_params(
                float(proc.threshold_db), float(proc.release_ms), rate)
            stages.append(_LimiterStage(threshold=threshold, c=c))
        elif isinstance(proc, AudioCompressor):
            stages.append(_CompressorStage(
                params=dynamics_ops.compressor_params(
                    proc.threshold_db, proc.ratio, proc.knee_db,
                    proc.attack_ms, proc.release_ms, proc.makeup_db, rate)))
        elif isinstance(proc, AudioDeesser):
            sections, params = proc._pieces(rate)
            stages.append(_DeesserStage(sections=tuple(sections),
                                        params=params))
        elif isinstance(proc, AudioTremolo):
            if proc.depth > 0.0:               # depth 0 = passthrough
                stages.append(_TremoloStage(
                    rate_hz=float(proc.rate_hz), depth=float(proc.depth),
                    sample_rate=rate))
        elif isinstance(proc, AudioChorus):
            if not (proc.wet == 0.0 and proc.dry == 1.0):
                stages.append(_ChorusStage(
                    rate_hz=float(proc.rate_hz), base_ms=float(proc.base_ms),
                    depth_ms=float(proc.depth_ms), voices=int(proc.voices),
                    wet=float(proc.wet), dry=float(proc.dry),
                    sample_rate=rate))
        elif isinstance(proc, AudioPhaser):
            if not proc._is_noop:
                stages.append(_PhaserStage(
                    rate_hz=float(proc.rate_hz),
                    f_min_hz=float(proc.f_min_hz),
                    f_max_hz=float(proc.f_max_hz), stages=int(proc.stages),
                    wet=float(proc.wet), dry=float(proc.dry),
                    sample_rate=rate))
        elif isinstance(proc, AudioPan):
            stages.append(_PanStage(pan=float(proc.pan)))
        elif isinstance(proc, AudioWidth):
            if float(proc.width) != 1.0:       # width 1 = passthrough
                stages.append(_WidthStage(width=float(proc.width)))
        elif isinstance(proc, AudioFade):
            fspec = proc._spec(rate)
            if not fspec.is_noop:
                stages.append(_FadeStage(spec=fspec))
        elif isinstance(proc, AudioGate):
            stages.append(_GateStage(
                params=dynamics_ops.gate_params(
                    proc.threshold_db, proc.ratio, proc.range_db,
                    proc.attack_ms, proc.release_ms, rate)))
        elif isinstance(proc, (AudioEq, AudioFilter)):
            sections = proc._sections(rate)
            if sections:                    # an all-flat EQ = passthrough
                stages.append(_BiquadStage(sections=tuple(sections)))
        elif isinstance(proc, AudioResample):
            target = int(proc.target_rate)
            if target == rate:
                continue
            L, M = resample_ops._rational(rate, target)
            # The Stream law: ceil(length * L / M).
            stages.append(_resample_stage(rate, target, M, L, target))
            rate = target
        elif isinstance(proc, (VelocityModifier, PitchModifier)):
            if isinstance(proc, VelocityModifier):
                st_rate = float(proc.velocity)
                st_pitch = (1.0 / st_rate) if proc.keep_pitch else 1.0
            else:
                st_rate = 1.0
                st_pitch = 2.0 ** (float(proc.pitch) / 12.0)
            eff_tempo = 1.0 / st_pitch
            eff_rate = st_rate * st_pitch
            if abs(eff_tempo - 1.0) > _EPS:
                if getattr(proc, "algorithm", "wsola") != "pv":
                    raise ProcessorRuntimeError(
                        "WSOLA tempo stages cannot shard the sample axis",
                        "The WSOLA splice chain is serial by construction "
                        "(ROUND4.md config-4 proof); set the node's "
                        "algorithm to 'pv' for sequence-parallel "
                        "execution, or run the graph via compile_graph_dp.",
                        f"node {nid}",
                    )
                stages.append(_PvStage(
                    tempo=eff_tempo, rate=rate,
                    transient=bool(getattr(proc, "pv_transient", False)),
                    formant_ratio=(
                        eff_rate
                        if getattr(proc, "preserve_formants", False)
                        else 1.0
                    ),
                ))
            if abs(eff_rate - 1.0) > _EPS:
                num, den = _rational_factor(eff_rate)
                # transpose_rate's law: ceil(length * den / num) on the
                # UNREDUCED pair; the nominal rate does not change.
                stages.append(_resample_stage(num, den, num, den, rate))
        else:
            raise ProcessorRuntimeError(
                "Unsupported node in sharded chain",
                "compile_chain_sp_tv supports audio_vol, audio_limiter, "
                "audio_compressor, audio_deesser, audio_gate, "
                "audio_tremolo, "
                "audio_chorus, audio_phaser, audio_pan, audio_width, "
                "audio_fade, audio_eq, audio_filter, audio_resample and "
                "velocity/pitch (algorithm='pv') between input and "
                "output.",
                f"node {nid}: {type(proc).__name__}",
            )
    return stages, rate


# -- planning ---------------------------------------------------------------


@dataclasses.dataclass
class ChainPlan:
    stages: List[Any]
    sp: int
    in_rate: int
    out_rate: int
    capacity: int         # global input capacity (sp * chunk_in)
    chunk_in: int
    chunk_out: int

    @property
    def out_capacity(self) -> int:
        return self.sp * self.chunk_out


def plan_chain(graph: Graph, rate: int, max_length: int, mesh: Mesh,
               sp_axis: str = "sp") -> ChainPlan:
    """Backward alignment pass + forward size pass over the chain."""
    sp = int(mesh.shape[sp_axis])
    stages, out_rate = _extract_stages(graph, rate)

    # Backward: the divisor each stage's INPUT chunk needs. PV stages
    # absorb the downstream need into k_per and reset it.
    req = 1
    pv_aligns: Dict[int, int] = {}
    for i in range(len(stages) - 1, -1, -1):
        st = stages[i]
        if isinstance(st, _ResampleStage):
            t_req = req // math.gcd(st.L, req)
            req = st.M * (st.R * t_req // math.gcd(st.R, t_req))
        elif isinstance(st, _PvStage):
            _, hop = pv_ops.pv_params(st.rate)
            pv_aligns[i] = req // math.gcd(hop, req)
            req = 1

    chunk_in = -(-max(max_length, 1) // sp)
    chunk_in = -(-chunk_in // req) * req
    capacity = sp * chunk_in

    # Forward: fix the chunk sizes and the PV plans.
    c = chunk_in
    for i, st in enumerate(stages):
        if isinstance(st, _ResampleStage):
            assert c % st.M == 0, (c, st.M)
            c = c * st.L // st.M
        elif isinstance(st, _PvStage):
            st.plan = plan_pv_sharded(
                st.tempo, st.rate, sp * c, sp,
                k_per_align=max(pv_aligns.get(i, 1), 1),
            )
            c = st.plan.out_chunk
    return ChainPlan(
        stages=stages, sp=sp, in_rate=rate, out_rate=out_rate,
        capacity=capacity, chunk_in=chunk_in, chunk_out=c,
    )


# -- local steps ------------------------------------------------------------


def _resample_local(st: _ResampleStage, xs, length: int):
    """The shards' output groups of the global polyphase program."""
    c = xs[0].shape[-1]
    gl = c // st.M
    out_len = (length // st.law_num) * st.law_den + (
        (length % st.law_num) * st.law_den + st.law_num - 1
    ) // st.law_num
    out = []
    for i, ext in enumerate(halo_exchange_nd(xs, st.left, st.W - st.M)):
        # The bank of L/M (any pair that reduces to it designs the same).
        bank, support = resample_ops._device_bank(st.M, st.L, ext.device)
        y = resample_ops.apply_filter_bank(ext.contiguous(), gl, st.M, st.W,
                                           bank, support)   # [C, gl * L]
        out.append(mask_tail(y, out_len - i * gl * st.L))
    return out, out_len


def _masked(xs, length: int):
    """The shards with every sample at or past the global ``length`` set
    to zero (an IIR tail rings into the padding)."""
    chunk = xs[0].shape[-1]
    return [mask_tail(x, length - i * chunk) for i, x in enumerate(xs)]


def _local_step(plan: ChainPlan, xs, length: int, lock: bool):
    """Every stage of the chain over the shards ``xs`` of the sp axis."""
    from nodey_tpu_torch.ops import biquad as biquad_ops
    from nodey_tpu_torch.ops import dynamics as dynamics_ops
    from nodey_tpu_torch.ops import fadepan as fadepan_ops
    from nodey_tpu_torch.ops import modfx as modfx_ops
    from nodey_tpu_torch.ops import phaser as phaser_ops
    from nodey_tpu_torch.ops.scans import f32

    ln = length
    for st in plan.stages:
        if isinstance(st, _GainStage):
            xs = [x * f32(st.volume) for x in xs]
        elif isinstance(st, _LimiterStage):
            xs = dynamics_ops.limiter_sharded_local(xs, st.threshold, st.c)
        elif isinstance(st, _CompressorStage):
            xs = dynamics_ops.compressor_sharded_local(xs, st.params)
        elif isinstance(st, _DeesserStage):
            xs = _masked(dynamics_ops.deesser_sharded_local(
                xs, list(st.sections), st.params), ln)
        elif isinstance(st, _TremoloStage):
            xs = modfx_ops.tremolo_sharded_local(xs, st.rate_hz, st.depth,
                                                 st.sample_rate)
        elif isinstance(st, _ChorusStage):
            xs = modfx_ops.chorus_sharded_local(
                xs, ln, st.rate_hz, st.base_ms, st.depth_ms, st.voices,
                st.wet, st.dry, st.sample_rate)
        elif isinstance(st, _PhaserStage):
            xs = phaser_ops.phaser_sharded_local(
                xs, ln, st.rate_hz, st.f_min_hz, st.f_max_hz, st.stages,
                st.wet, st.dry, st.sample_rate)
        elif isinstance(st, _PanStage):
            xs = fadepan_ops.pan_sharded_local(xs, st.pan)
        elif isinstance(st, _WidthStage):
            if xs[0].shape[0] == 2:            # mono has no side signal
                xs = [fadepan_ops.width_array(x, st.width) for x in xs]
        elif isinstance(st, _FadeStage):
            xs = fadepan_ops.fade_sharded_local(xs, st.spec, length=ln)
        elif isinstance(st, _GateStage):
            xs = dynamics_ops.gate_sharded_local(xs, st.params)
        elif isinstance(st, _BiquadStage):
            xs = _masked(biquad_ops.cascade_sharded_local(
                xs, list(st.sections)), ln)
        elif isinstance(st, _ResampleStage):
            xs, ln = _resample_local(st, xs, ln)
        else:
            xs, ln = pv_sharded_local_step(
                st.plan, xs, ln, lock=lock, transient=st.transient,
                formant_ratio=st.formant_ratio)
    return xs, ln


class TvShardedChain:
    """A time-variant chain compiled for sp execution on a mesh."""

    def __init__(self, mesh: Mesh, plan: ChainPlan, input_key: str,
                 sp_axis: str, lock: bool):
        self.mesh = mesh
        self.plan = plan
        self.input_key = input_key
        self.sp_axis = sp_axis
        self.lock = lock

    def run(self, data, length: int):
        """Execute [C, n] (numpy, or a tensor on the mesh's first device;
        zero-padded here to the plan's capacity); returns (out [C,
        out_capacity] on the mesh's first device, out_length)."""
        home = self.mesh.devices.flat[0]
        cap = self.plan.capacity
        if torch.is_tensor(data):
            if data.device != home:
                raise ProcessorRuntimeError(
                    "Input on another device",
                    "Pass the clip as a numpy array or as a tensor on the "
                    "mesh's first device.",
                    f"{data.device} != {home}",
                )
        else:
            data = torch.from_numpy(np.ascontiguousarray(data))
        if data.shape[-1] > cap:
            raise ProcessorRuntimeError(
                "Clip exceeds planned capacity",
                "Re-plan the chain with a larger max_length.",
                f"{data.shape[-1]} > {cap}",
            )
        if data.shape[-1] < cap:
            data = torch.nn.functional.pad(data, (0, cap - data.shape[-1]))
        xs = split_time(data, self.mesh.axis_devices(self.sp_axis))
        outs, out_len = _local_step(self.plan, xs, int(length), self.lock)
        return gather_time(outs, home), out_len


def compile_chain_sp_tv(
    graph: Graph,
    sources: Dict[Tuple[int, str], compiler.SourceSpec],
    mesh: Mesh,
    max_length: Optional[int] = None,
    sp_axis: str = "sp",
    lock: bool = True,
) -> TvShardedChain:
    """Compile a linear time-variant chain for sp execution over ``mesh``.

    ``sources`` must hold exactly one flt source; ``max_length`` defaults
    to its capacity. ``run`` pads the clip to the planned capacity."""
    if len(sources) != 1:
        raise ProcessorRuntimeError(
            "Chain sharding needs exactly one source",
            "Multi-source graphs run via compile_graph_sharded (LTI) or "
            "compile_graph_dp.",
            f"{len(sources)} sources",
        )
    (nid, pin), spec = next(iter(sources.items()))
    if spec.fmt != "flt":
        raise ProcessorRuntimeError(
            "Chain sharding requires flt sources",
            "Convert the source to float32 before sharding.",
            f"fmt={spec.fmt}",
        )
    plan = plan_chain(graph, spec.rate, max_length or spec.capacity, mesh,
                      sp_axis)
    return TvShardedChain(mesh=mesh, plan=plan,
                          input_key=compiler.external_key(nid, pin),
                          sp_axis=sp_axis, lock=lock)
