"""The graph compiler (port of nodey_tpu.core.compiler), eager.

The validated DAG is ordered host-side and every node's ``lower()`` runs
PyTorch ops on the tensors of its inputs; edges are tensors, fan-out is
reuse. There is no jit: ``compile_graph`` returns a callable bound to one
device that runs the nodes in order each time it is called.
"""

from __future__ import annotations

import contextlib
import dataclasses
import heapq
from typing import Any, Dict, List, Optional, Tuple

import torch

from nodey_tpu_torch.core.errors import LogicError, ProcessorRuntimeError
from nodey_tpu_torch.core.graph import Graph
from nodey_tpu_torch.core.stream import Stream


@dataclasses.dataclass(frozen=True)
class SourceSpec:
    """Static description of one external (decoded) input stream."""

    rate: int
    channels: int
    fmt: str
    capacity: int  # padded buffer length
    t0_us: float = 0.0


def external_key(node_id: int, pin: str) -> str:
    return f"n{node_id}:{pin}"


class LowerCtx:
    """Per-run context handed to every node's ``lower()``: the run mode,
    the bound external inputs, and the emitted outputs."""

    def __init__(self, mode: str, sources: Dict[Tuple[int, str], SourceSpec],
                 args: Dict[str, Tuple[torch.Tensor, int]]):
        self.mode = mode  # "export" | "preview"
        self.node_id: Optional[int] = None  # set per node by the compiler
        self._sources = sources
        self._args = args
        self.outputs: Dict[str, Any] = {}
        self.output_meta: Dict[str, Any] = {}

    def external(self, node_id: int, pin: str) -> Stream:
        spec = self._sources.get((node_id, pin))
        if spec is None:
            raise LogicError(f"No source bound for node {node_id} pin {pin}")
        data, length = self._args[external_key(node_id, pin)]
        if data.dtype == torch.int16:
            # s16 ingest wire: dequantize s/32768, exactly FFmpeg's s16->flt.
            data = data.float() * (1.0 / 32768.0)
        return Stream(
            data=data,
            length=length,
            rate=spec.rate,
            channels=spec.channels,
            fmt=spec.fmt,
            t0_us=spec.t0_us,
        )

    def emit(self, key: str, value: Any, meta: Optional[Dict] = None) -> None:
        if key in self.outputs:
            raise LogicError(f"Duplicate emitted output '{key}'")
        if isinstance(value, Stream):
            self.outputs[key] = (value.data, value.length)
            self.output_meta[key] = {
                "kind": "stream",
                "rate": value.rate,
                "channels": value.channels,
                "fmt": value.fmt,
                "t0_us": value.t0_us,
            }
        else:
            self.outputs[key] = value
            self.output_meta[key] = {"kind": "array", **(meta or {})}


@contextlib.contextmanager
def attributed_to(nid: int, node):
    """Name the node in the detail of a ProcessorRuntimeError raised inside
    the block, as the reference attributes a failure to its node
    (runner.cpp:87-136). The type is kept, so callers can dispatch on
    UnstreamableGraphError."""
    try:
        yield
    except ProcessorRuntimeError as exc:
        if f"[node {nid}" in exc.detail:
            raise
        raise type(exc)(exc.message, exc.explanation,
                        f"{exc.detail} [node {nid}: "
                        f"{node.processor.info().identifier}]") from exc


def topo_order(graph: Graph) -> List[int]:
    """Kahn topological order over nodes, smallest ID first."""
    downstream: Dict[int, List[int]] = {nid: [] for nid in graph.nodes}
    incoming = {nid: 0 for nid in graph.nodes}
    for link in graph.links.values():
        src = graph.pins[link.from_pin].parent
        dst = graph.pins[link.to_pin].parent
        downstream[src].append(dst)
        incoming[dst] += 1

    ready = [nid for nid, cnt in incoming.items() if cnt == 0]
    heapq.heapify(ready)
    order: List[int] = []
    while ready:
        nid = heapq.heappop(ready)
        order.append(nid)
        for dst in downstream[nid]:
            incoming[dst] -= 1
            if incoming[dst] == 0:
                heapq.heappush(ready, dst)
    if len(order) != len(graph.nodes):
        raise LogicError("topo_order called on a cyclic graph")
    return order


class CompiledGraph:
    """An ordered graph bound to one device.

    Calling it with ``{external_key: (tensor on device, valid length)}``
    runs every node and returns ``(outputs, output_meta)``: stream outputs
    as ``(tensor, length)``, array outputs as tensors, all on the device."""

    def __init__(self, graph: Graph, sources: Dict[Tuple[int, str], SourceSpec],
                 mode: str, device: torch.device):
        self.graph = graph
        self.sources = sources
        self.mode = mode
        self.device = device
        self.order = topo_order(graph)
        self.input_keys = sorted(external_key(nid, pin) for nid, pin in sources)
        # node -> [(input pin name, upstream output pin id)]
        self._wiring: Dict[int, List[Tuple[str, int]]] = {
            nid: [] for nid in self.order
        }
        for link in graph.links.values():
            to_pin = graph.pins[link.to_pin]
            self._wiring[to_pin.parent].append(
                (to_pin.attribute.identifier, link.from_pin)
            )

    def __call__(self, args: Dict[str, Tuple[torch.Tensor, int]]):
        for key in self.input_keys:
            if args[key][0].device != self.device:
                raise LogicError(
                    f"input {key} is on {args[key][0].device}, the graph "
                    f"is bound to {self.device}"
                )
        ctx = LowerCtx(self.mode, self.sources, args)
        pin_values: Dict[int, Stream] = {}  # output pin id -> Stream
        for nid in self.order:
            node = self.graph.nodes[nid]
            node_inputs = {
                name: pin_values[from_pin]
                for name, from_pin in self._wiring[nid]
                if from_pin in pin_values
            }
            ctx.node_id = nid
            with attributed_to(nid, node):
                outs = node.processor.lower(ctx, node_inputs)
            for pin_name, value in outs.items():
                pin_id = node.pin_name_map.get(pin_name)
                if pin_id is None:
                    raise LogicError(
                        f"Node {nid} lowered unknown pin '{pin_name}'"
                    )
                pin_values[pin_id] = value
        return ctx.outputs, ctx.output_meta


def resolve_device(device: torch.device | str) -> torch.device:
    """The concrete device for ``device``; a CUDA device without a card
    raises instead of running anywhere else."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise ProcessorRuntimeError(
                "No CUDA device available",
                "The graph was asked to run on a CUDA card and none is "
                "visible; pass device 'cpu' to run on the CPU instead.",
                f"device={device}",
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ProcessorRuntimeError(
            "Unsupported device",
            "The graph runs on a CUDA card or on the CPU.",
            f"device={device}",
        )
    return device


def compile_graph(graph: Graph, sources: Dict[Tuple[int, str], SourceSpec],
                  mode: str = "export",
                  device: torch.device | str = "cuda") -> CompiledGraph:
    """Validate and order the graph; bind it to ``device`` (the card
    unless the caller asks for the CPU, as every entry point does).

    Raises the graph error taxonomy from check_graph here, and the
    three-part ProcessorRuntimeError, attributed to its node, when the
    returned callable runs."""
    graph.check_graph()
    return CompiledGraph(graph, sources, mode, resolve_device(device))
