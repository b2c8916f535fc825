"""The graph compiler (port of nodey_tpu.core.compiler), eager.

The validated DAG is ordered host-side and every node's ``lower()`` runs
PyTorch ops on the tensors of its inputs; edges are tensors, fan-out is
reuse. There is no jit: ``compile_graph`` returns a callable bound to one
device that runs the nodes in order each time it is called.
``CompiledGraph.run_batch`` runs the same order once over a batch of clips
(``[B, C, capacity]`` inputs): each node's lowering carries the clip axis
itself (``Processor.batched``), and ``LowerCtx.batch`` tells a source with
no input tensor, the generator, how many clips to emit. Every registered
node type has a batched lowering. Before anything runs, ``run_batch``
refuses a graph with a node that has none, and a graph with no external
input, which gives no clip count (the JAX package's vmap refuses it too).
``run_batch(mesh=...)`` splits the batch over a mesh's dp axis, each share
one ``run_batch`` on its device (parallel/mesh.py).
"""

from __future__ import annotations

import contextlib
import dataclasses
import heapq
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
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
    the device the graph is bound to and the clip count of a batched run
    (``batch``, None for one clip): where a source with no input tensor,
    the signal generator, puts its stream and how many clips it emits; the
    bound external inputs, and the emitted outputs."""

    def __init__(self, mode: str, sources: Dict[Tuple[int, str], SourceSpec],
                 args: Dict[str, Tuple[torch.Tensor, Any]],
                 device: torch.device, batch: Optional[int] = None):
        self.mode = mode  # "export" | "preview"
        self.device = device
        self.batch = batch
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
            # s16 ingest wire: dequantize s/32768, exactly FFmpeg's s16->flt
            # (elementwise: one clip [C, N] or a batch [B, C, N] alike).
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
    as ``(tensor, length)``, array outputs as tensors, all on the device.
    ``on_node(node id)``, when given, is called after each node's lowering
    (the per-node profile marks the render there)."""

    def __init__(self, graph: Graph, sources: Dict[Tuple[int, str], SourceSpec],
                 mode: str, device: torch.device):
        self.graph = graph
        self.sources = sources
        self.mode = mode
        self.device = device
        self.order = topo_order(graph)
        self._bound: Dict[torch.device, "CompiledGraph"] = {}
        self._specs = {external_key(nid, pin): spec
                       for (nid, pin), spec in sources.items()}
        self.input_keys = sorted(self._specs)
        # node -> [(input pin name, upstream output pin id)]
        self._wiring: Dict[int, List[Tuple[str, int]]] = {
            nid: [] for nid in self.order
        }
        for link in graph.links.values():
            to_pin = graph.pins[link.to_pin]
            self._wiring[to_pin.parent].append(
                (to_pin.attribute.identifier, link.from_pin)
            )

    def __call__(self, args: Dict[str, Tuple[torch.Tensor, int]],
                 on_node: Optional[Callable[[int], None]] = None):
        for key in self.input_keys:
            if args[key][0].device != self.device:
                raise LogicError(
                    f"input {key} is on {args[key][0].device}, the graph "
                    f"is bound to {self.device}"
                )
        return self._run(args, on_node=on_node)

    def run_device(self, arrays: Dict[str, Any],
                   lengths: Dict[str, int]) -> Dict[str, Any]:
        """Run once and return the outputs, left on the graph's device (the
        JAX package's ``run_device``). ``arrays[key]`` is ``[C, capacity]``:
        a tensor on the graph's device, or a numpy array, which is copied
        there; ``lengths[key]`` is its valid length. The render is
        ``__call__``'s."""
        args = {}
        for key in self.input_keys:
            data = arrays[key]
            if not torch.is_tensor(data):
                data = torch.from_numpy(np.ascontiguousarray(data)).to(
                    self.device)
            args[key] = (data, int(lengths[key]))
        return self(args)[0]

    def run(self, arrays: Dict[str, Any],
            lengths: Dict[str, int]) -> Dict[str, Any]:
        """``run_device``'s outputs as host numpy: stream outputs as
        ``(data, length)``, array outputs as arrays."""
        return {key: (value[0].cpu().numpy(), value[1])
                if isinstance(value, tuple) else value.cpu().numpy()
                for key, value in self.run_device(arrays, lengths).items()}

    def unbatched_nodes(self) -> List[Tuple[int, str]]:
        """``(node id, identifier)`` of every node without a batched
        lowering, in node order."""
        return [(nid, self.graph.nodes[nid].processor.info().identifier)
                for nid in self.order
                if not self.graph.nodes[nid].processor.batched]

    def run_batch(self, arrays: Dict[str, Any], lengths: Dict[str, Any],
                  mesh=None, dp_axis: str = "dp"):
        """Run the graph once over a batch of B clips.

        ``arrays[key]`` is ``[B, C, capacity]``: a tensor on the graph's
        device, or a numpy array, which is copied there (a tensor on
        another device raises, as ``__call__`` does). ``lengths[key]`` is
        the B clips' valid lengths on the host (ints, a numpy array or a
        CPU tensor). Returns ``(outputs, output_meta)`` as ``__call__``
        does, each stream output as ``(data [B, C, N] on the device, the B
        lengths as a tuple of host ints)`` and each array output
        ``[B, ...]``, all left on the device. Clip b of every output is
        clip b's own single render.

        Before anything runs, every node must have a batched lowering,
        else a ProcessorRuntimeError names the nodes, and the graph must
        have an external input, else one says so: the batch's clip count
        comes from its inputs. No loop over clips stands in for a batched
        lowering: inside a lowering only the GEMMs, whose bits follow their
        shape, go clip by clip.

        With ``mesh`` (``parallel.mesh.Mesh``) the batch splits over
        ``mesh.shape[dp_axis]`` equal shares, B divisible by it: share d
        is copied to the device at dp index d and runs there as one
        ``run_batch`` of this graph bound to that device, and the clips
        come back in order on this graph's device. A device may hold
        several shares (a virtual mesh of one card)."""
        unbatched = self.unbatched_nodes()
        if unbatched:
            names = ", ".join(f"node {nid} ({ident})"
                              for nid, ident in unbatched)
            raise ProcessorRuntimeError(
                "Graph cannot run as a batch",
                "Every node of a batched run needs a batched lowering, and "
                "these processors do not declare one. Render the clips one "
                "at a time instead.",
                f"unbatched: {names}",
            )
        if not self.input_keys:
            raise ProcessorRuntimeError(
                "Graph cannot run as a batch",
                "A batch takes its clip count from the graph's external "
                "inputs, and this graph has none (its streams all come from "
                "generators, which render the same clip every time). Render "
                "it once instead.",
                "no external input",
            )
        batch = None
        args: Dict[str, Tuple[torch.Tensor, Tuple[int, ...]]] = {}
        for key in self.input_keys:
            data, lens = arrays[key], lengths[key]
            if torch.is_tensor(data):
                if data.device != self.device:
                    raise LogicError(
                        f"input {key} is on {data.device}, the graph is "
                        f"bound to {self.device}")
            else:
                data = torch.from_numpy(np.ascontiguousarray(data))
            if torch.is_tensor(lens) and lens.device.type != "cpu":
                raise LogicError(
                    f"lengths of {key} are on {lens.device}: a batch's "
                    f"lengths stay on the host")
            lens = tuple(int(n) for n in np.asarray(lens).reshape(-1))
            spec = self._specs[key]
            if (data.dim() != 3 or data.shape[1] != spec.channels
                    or data.shape[2] != spec.capacity):
                raise LogicError(
                    f"input {key}: want [B, {spec.channels}, {spec.capacity}]"
                    f", got {list(data.shape)}")
            if batch is None:
                batch = data.shape[0]
            if data.shape[0] != batch or len(lens) != batch:
                raise LogicError(
                    f"input {key}: {data.shape[0]} clips and {len(lens)} "
                    f"lengths, the batch has {batch}")
            if any(not 0 <= n <= spec.capacity for n in lens):
                raise LogicError(
                    f"input {key}: lengths {lens} outside 0..{spec.capacity}")
            args[key] = (data, lens)
        if mesh is None:
            args = {key: (data.to(self.device), lens)
                    for key, (data, lens) in args.items()}
            return self._run(args, batch)
        return self._run_on_mesh(args, batch, mesh, dp_axis)

    def on_device(self, device: torch.device) -> "CompiledGraph":
        """This graph bound to ``device`` (itself on its own device; one
        binding a device, kept)."""
        device = resolve_device(device)
        if device == self.device:
            return self
        bound = self._bound.get(device)
        if bound is None:
            bound = self._bound[device] = CompiledGraph(
                self.graph, self.sources, self.mode, device)
        return bound

    def _run_on_mesh(self, args, batch: int, mesh, dp_axis: str):
        """``run_batch``'s mesh form: each dp shard's share of the clips as
        one ``run_batch`` on its device, gathered on this graph's device."""
        devices = mesh.axis_devices(dp_axis)
        dp = len(devices)
        if batch % dp:
            raise LogicError(f"a batch of {batch} clips does not split over "
                             f"{dp_axis}={dp}")
        from nodey_tpu_torch.parallel.ops import to_device

        share = batch // dp
        outs = []
        for d, dev in enumerate(devices):
            sl = slice(d * share, (d + 1) * share)
            sub = {key: (to_device(data[sl], dev), lens[sl])
                   for key, (data, lens) in args.items()}
            outs.append(self.on_device(dev)._run(sub, share))
        outputs, meta = {}, outs[0][1]
        for key in outs[0][0]:
            parts = [o[0][key] for o in outs]
            if meta[key]["kind"] == "stream":
                outputs[key] = (
                    torch.cat([to_device(p[0], self.device) for p in parts]),
                    sum((tuple(p[1]) for p in parts), ()))
            else:
                outputs[key] = torch.cat([to_device(p, self.device)
                                          for p in parts])
        return outputs, meta

    def _run(self, args, batch: Optional[int] = None,
             on_node: Optional[Callable[[int], None]] = None):
        ctx = LowerCtx(self.mode, self.sources, args, self.device, batch)
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
            if on_node is not None:
                on_node(nid)
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
