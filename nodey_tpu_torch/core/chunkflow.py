"""Chunk-flow compilation: the graph as a streaming step (port of
nodey_tpu.core.chunkflow).

The offline compiler (core/compiler.py) renders whole clips. This module
compiles the same validated DAG into an incremental form, the counterpart
of the reference's fiber-per-node streaming runtime (src/infra/runner.cpp,
frames flowing through bounded channels, audio-stream.hpp:46-83):

    step(states, chunk_args) -> (states', chunk_outputs)

* Every edge carries a fixed-width chunk (``ChunkStream``): a [C, width]
  float32 tensor on the device, its valid count and its done flag, both
  host values (the counts never depend on the audio, see ops/chunkops.py).
* Every stateful node owns a device carry (FIFOs, resampler tap history,
  WSOLA tails) handed from step to step, so host and device memory stay
  bounded by the chunk size for any clip length.
* ``step`` is a plain Python loop over the topological order, eager like
  the offline compiler; there is no jit.

Nodes implement ``plan_stream`` (static chunk widths and initial state)
and ``lower_stream`` (one chunk) beside their offline ``lower``. The JAX
package's ``batch_steps`` (several chunks per device dispatch) is not
ported: it exists to cut round trips through a remote relay and buys
nothing on a local card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from nodey_tpu_torch.core.compiler import (SourceSpec, attributed_to,
                                           external_key, resolve_device,
                                           topo_order)
from nodey_tpu_torch.core.errors import LogicError, UnstreamableGraphError
from nodey_tpu_torch.core.graph import Graph
from nodey_tpu_torch.ops import chunkops
from nodey_tpu_torch.ops.resample import SQRT1_2


@dataclasses.dataclass(frozen=True)
class ChunkSpec:
    """Static description of one edge's chunk format.

    ``cadence`` is the nominal number of valid samples delivered per step
    (sources deliver their chunk width, resamplers scale it by the rate
    ratio, WSOLA by 1/tempo). Lockstep merges require equal cadences on
    every input: a faster branch would grow its alignment FIFO without
    bound. -1 marks "unknown" for internal stage specs that reach no
    merge."""

    rate: int
    channels: int
    fmt: str
    width: int          # chunk buffer width (valid n <= width)
    t0_us: float = 0.0
    cadence: float = -1.0

    def replace(self, **kw) -> "ChunkSpec":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class ChunkStream:
    """One chunk on an edge: data [C, width] on the device, valid count and
    EOF flag on the host."""

    data: torch.Tensor
    n: int
    done: bool
    spec: ChunkSpec

    def with_data(self, data: torch.Tensor, **spec_overrides) -> "ChunkStream":
        spec = self.spec.replace(
            channels=data.shape[0], width=data.shape[1], **spec_overrides
        )
        return ChunkStream(data=data, n=self.n, done=self.done, spec=spec)

    # Delegates so shared validators (the velocity nodes' sample-rate guard)
    # read offline Streams and ChunkStreams alike.
    @property
    def rate(self) -> int:
        return self.spec.rate

    @property
    def channels(self) -> int:
        return self.spec.channels

    @property
    def fmt(self) -> str:
        return self.spec.fmt


class StreamPlanCtx:
    """Static planning context: the run mode, the bound sources and the
    device the carries live on."""

    def __init__(self, mode: str, sources: Dict[Tuple[int, str], SourceSpec],
                 device: torch.device):
        self.mode = mode
        self.node_id: Optional[int] = None
        self.device = device
        self._sources = sources
        self.output_specs: Dict[str, Any] = {}

    def external_spec(self, node_id: int, pin: str) -> ChunkSpec:
        spec = self._sources.get((node_id, pin))
        if spec is None:
            raise LogicError(f"No source bound for node {node_id} pin {pin}")
        return ChunkSpec(
            rate=spec.rate, channels=spec.channels, fmt=spec.fmt,
            width=spec.capacity, t0_us=spec.t0_us,
            cadence=float(spec.capacity),
        )

    def emit_spec(self, key: str, meta: Dict[str, Any]) -> None:
        if key in self.output_specs:
            raise LogicError(f"Duplicate emitted output '{key}'")
        self.output_specs[key] = meta


class StreamLowerCtx:
    """Context of one chunk step: the step's external chunks and the
    emitted outputs."""

    def __init__(self, mode: str, sources: Dict[Tuple[int, str], SourceSpec],
                 args: Dict[str, Tuple[torch.Tensor, int, bool]]):
        self.mode = mode
        self.node_id: Optional[int] = None
        self._sources = sources
        self._args = args
        self.outputs: Dict[str, Any] = {}

    def external(self, node_id: int, pin: str) -> ChunkStream:
        spec = self._sources.get((node_id, pin))
        if spec is None:
            raise LogicError(f"No source bound for node {node_id} pin {pin}")
        data, n, done = self._args[external_key(node_id, pin)]
        if data.dtype == torch.int16:
            # s16 wire: dequantize s/32768 on the device, exactly FFmpeg's
            # s16->flt conversion.
            data = data.float() * (1.0 / 32768.0)
        return ChunkStream(
            data=data, n=n, done=done,
            spec=ChunkSpec(rate=spec.rate, channels=spec.channels,
                           fmt=spec.fmt, width=spec.capacity,
                           t0_us=spec.t0_us),
        )

    def emit(self, key: str, value: Any) -> None:
        """Emit a ChunkStream as ``(data, n, done)``, or any other value."""
        if key in self.outputs:
            raise LogicError(f"Duplicate emitted output '{key}'")
        if isinstance(value, ChunkStream):
            value = (value.data, value.n, value.done)
        self.outputs[key] = value


GAUGES_KEY = "__gauges__"


@dataclasses.dataclass
class StreamCompiled:
    """A compiled streaming graph."""

    step: Callable                  # (states, args) -> (states, outputs)
    init_states: Dict[str, Any]
    input_keys: List[str]
    output_meta: Dict[str, Any]     # key -> {"kind", "rate", ...}
    chunk_in: Dict[str, int]        # input key -> chunk width
    # One label per FifoState in the state tree, "<node id>/<path>": each
    # step's outputs carry their fill ratios under GAUGES_KEY.
    gauge_keys: Tuple[str, ...] = ()


def _find_fifos(states: Dict[str, Any]):
    """``(label, FifoState)`` pairs in a fixed order, labelled
    '<node id>/<path>' with the JAX package's path spelling ("['rs'][0]")."""
    found = []

    def walk(value, path):
        if isinstance(value, chunkops.FifoState):
            found.append((path, value))
        elif isinstance(value, dict):
            for key in sorted(value):
                walk(value[key], f"{path}[{key!r}]")
        elif isinstance(value, (list, tuple)):
            for i, item in enumerate(value):
                walk(item, f"{path}[{i}]")

    for nid in sorted(states, key=int):
        walk(states[nid], f"{nid}/")
    return found


def compile_stream_graph(
    graph: Graph,
    sources: Dict[Tuple[int, str], SourceSpec],
    mode: str = "export",
    device: torch.device | str = "cuda",
) -> StreamCompiled:
    """Validate and plan the graph; return its chunk step on ``device``
    (the card unless the caller asks for the CPU).

    ``sources`` binds each (audio_input node, output pin) to a SourceSpec
    whose ``capacity`` is the per-chunk input width of that stream. The
    plan pass allocates every carry on the device and raises the
    structured errors (UnstreamableGraphError for a graph that cannot run
    in lockstep), attributed to their node."""
    graph.check_graph()
    device = resolve_device(device)
    order = topo_order(graph)
    input_keys = sorted(external_key(nid, pin) for (nid, pin) in sources)

    wiring: Dict[int, List[Tuple[str, int]]] = {nid: [] for nid in order}
    for link in graph.links.values():
        to_pin = graph.pins[link.to_pin]
        wiring[to_pin.parent].append(
            (to_pin.attribute.identifier, link.from_pin))

    # -- plan pass: chunk specs and initial states -----------------------------
    plan_ctx = StreamPlanCtx(mode, sources, device)
    pin_specs: Dict[int, ChunkSpec] = {}
    init_states: Dict[str, Any] = {}
    for nid in order:
        node = graph.nodes[nid]
        in_specs = {name: pin_specs[from_pin]
                    for name, from_pin in wiring[nid] if from_pin in pin_specs}
        plan_ctx.node_id = nid
        with attributed_to(nid, node):
            out_specs, state = node.processor.plan_stream(plan_ctx, in_specs)
        init_states[str(nid)] = state
        for pin_name, spec in out_specs.items():
            pin_id = node.pin_name_map.get(pin_name)
            if pin_id is None:
                raise LogicError(f"Node {nid} planned unknown pin '{pin_name}'")
            pin_specs[pin_id] = spec
    output_meta = dict(plan_ctx.output_specs)
    gauge_keys = tuple(label for label, _ in _find_fifos(init_states))
    if gauge_keys:
        output_meta[GAUGES_KEY] = {"kind": "gauges", "keys": gauge_keys}

    # -- the step --------------------------------------------------------------
    def step(states: Dict[str, Any], args: Dict[str, Any]):
        ctx = StreamLowerCtx(mode, sources, args)
        pin_values: Dict[int, ChunkStream] = {}
        new_states: Dict[str, Any] = {}
        for nid in order:
            node = graph.nodes[nid]
            inputs = {name: pin_values[from_pin]
                      for name, from_pin in wiring[nid]
                      if from_pin in pin_values}
            ctx.node_id = nid
            with attributed_to(nid, node):
                outs, new_state = node.processor.lower_stream(
                    ctx, inputs, states[str(nid)])
            new_states[str(nid)] = new_state
            for pin_name, value in outs.items():
                pin_id = node.pin_name_map.get(pin_name)
                if pin_id is None:
                    raise LogicError(
                        f"Node {nid} lowered unknown pin '{pin_name}'")
                pin_values[pin_id] = value
        if gauge_keys:
            ctx.outputs[GAUGES_KEY] = tuple(
                fifo.level / fifo.buf.shape[1]
                for _, fifo in _find_fifos(new_states))
        return new_states, ctx.outputs

    return StreamCompiled(
        step=step,
        init_states=init_states,
        input_keys=input_keys,
        output_meta=output_meta,
        chunk_in={external_key(nid, pin): spec.capacity
                  for (nid, pin), spec in sources.items()},
        gauge_keys=gauge_keys,
    )


# -- shared building blocks for node lower_stream implementations -------------


def to_stereo_chunk(chunk: ChunkStream) -> ChunkStream:
    """Stateless -3 dB mono upmix (ops/resample.to_stereo semantics)."""
    if chunk.spec.channels == 2:
        return chunk
    data = torch.cat([chunk.data, chunk.data], dim=0) * SQRT1_2
    return chunk.with_data(data, fmt="flt")


def plan_resample_stage(spec: ChunkSpec, out_rate: int, device):
    """``(ChunkSpec, state, plan)`` of a streaming resampler after
    ``spec``; plan is None when the rate does not change."""
    if spec.rate == out_rate:
        return spec, None, None
    plan = chunkops.resample_plan(spec.rate, out_rate, spec.width, device)
    state = chunkops.resample_stream_init(plan, spec.channels, device)
    cadence = spec.cadence * out_rate / spec.rate if spec.cadence > 0 else -1.0
    out_spec = spec.replace(rate=out_rate, width=plan.out_cap, fmt="flt",
                            cadence=cadence)
    return out_spec, state, plan


def run_resample_stage(plan, state, chunk: ChunkStream, out_rate: int):
    """Apply a planned streaming resampler stage to one chunk."""
    if plan is None:
        return state, chunk
    state, out, out_n, out_done = chunkops.resample_stream_step(
        plan, state, chunk.data, chunk.n, chunk.done)
    spec = chunk.spec.replace(rate=out_rate, width=plan.out_cap, fmt="flt")
    return state, ChunkStream(data=out, n=out_n, done=out_done, spec=spec)


def plan_aligned_merge(specs: List[ChunkSpec], prefills: List[int], device):
    """Per-input FIFOs for sample-aligned merging; ``prefills`` are leading
    silence counts (0 for amix). Returns ``(merge plan, fifo states)``.

    Raises UnstreamableGraphError when the inputs arrive at different
    cadences: a faster branch would outrun the aligned take (the minimum
    over live inputs) and overflow its FIFO."""
    known = [s.cadence for s in specs if s.cadence > 0]
    if known and max(known) > min(known) * (1 + 1e-6):
        raise UnstreamableGraphError(
            "Mixer inputs arrive at different rates",
            "Streaming a mixer whose branches produce different "
            "audio-seconds per step (e.g. one side through a velocity/"
            "pitch change) is not supported by lockstep chunk execution; "
            "use the offline render/export path for this graph.",
            f"per-step arrivals at 48 kHz: {[round(c, 2) for c in known]}",
        )
    take_cap = max(s.width for s in specs)
    states = [chunkops.fifo_prefill(s.channels, pre + 2 * s.width + take_cap
                                    + 4, pre, device)
              for s, pre in zip(specs, prefills)]
    return {"take_cap": take_cap}, states


def run_aligned_merge(merge_plan, fifo_states, chunks: List[ChunkStream]):
    """Push chunks into their FIFOs and pop one aligned window per input.

    Returns ``(fifo states, windows [C, take_cap] (fresh tensors), take,
    drained)``. An input whose stream is done reads zeros past its level
    (the reference's drained-resampler silence, audio-amix.cpp:279-291);
    the output runs until the longest input is exhausted."""
    take_cap = merge_plan["take_cap"]
    fifos = [chunkops.fifo_push(st, c.data, c.n)
             for st, c in zip(fifo_states, chunks)]
    live = [f.level for f, c in zip(fifos, chunks) if not c.done]
    take = min(live) if live else max(f.level for f in fifos)
    take = min(max(take, 0), take_cap)
    windows = []
    for fifo in fifos:
        window = torch.zeros((fifo.buf.shape[0], take_cap),
                             dtype=torch.float32, device=fifo.buf.device)
        window[:, :take] = fifo.buf[:, :take]
        windows.append(window)
    fifos = [chunkops.fifo_advance(f, take) for f in fifos]
    drained = not live and all(f.level <= 0 for f in fifos)
    return fifos, windows, take, drained
