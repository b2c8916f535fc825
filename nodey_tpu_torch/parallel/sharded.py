"""Sharded execution of compiled graphs over a dp x sp mesh (port of
nodey_tpu.parallel.sharded).

``compile_graph_sharded`` runs the user's validated DAG through the SAME
compiler as a single render (``core.compiler.compile_graph``), over
per-shard time windows:

* **sp (time)**: each shard owns a contiguous chunk of the sample axis plus
  left and right halos fetched from its neighbors
  (``parallel.ops.halo_exchange_nd``). Halos cover every kernel's
  receptive field (resampler taps, STFT windows, a reverb's IR, the t0
  spread) and chunk boundaries sit at multiples of the graph's chunk
  quantum (every resampler's input stride M times its group factor, every
  STFT hop), so the trimmed windows' outputs concatenate to the single
  render: the overlap-discard algebra of ``core.streaming.render_chunked``
  run across the mesh instead of in sequence.
* **dp (batch)**: clips shard over dp; each shard's clips are one
  ``run_batch`` of the window program on its device.

One ``compile_graph`` over window-sized sources is bound to each distinct
device of the mesh. The global valid length of a stream output is the sum
(``psum``) of each shard's clamped contribution, exact because validity is
a contiguous prefix. Lengths are host ints throughout.

The JAX package reads the window program's output metadata (rates, hops)
when it traces; the eager compiler knows it once the program has run, so
the trims are derived on the first ``run`` and ``dropped_outputs`` (array
outputs whose frames do not land on the shard grid) is filled then.

Time-variant graphs (velocity/pitch, the master-bus and modulation nodes)
cannot shard the sample axis by overlap-discard: ``compile_graph_dp`` runs
them as whole clips over dp, and ``parallel.tv_sharded`` shards linear
chains of them.
"""

from __future__ import annotations

import dataclasses
import math
from fractions import Fraction
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from nodey_tpu_torch.core import compiler
from nodey_tpu_torch.core.errors import LogicError, ProcessorRuntimeError
from nodey_tpu_torch.core.graph import Graph
from nodey_tpu_torch.parallel.mesh import Mesh
from nodey_tpu_torch.parallel.ops import (gather_time, halo_exchange_nd,
                                          ppermute, psum, to_device)


def _round_up(n: int, q: int) -> int:
    return -(-n // q) * q


def _time_lcm(a: Fraction, b: Fraction) -> Fraction:
    """The least common multiple of two durations (lcm of numerators over
    the gcd of denominators)."""
    return Fraction(math.lcm(a.numerator, b.numerator),
                    math.gcd(a.denominator, b.denominator))


@dataclasses.dataclass
class ShardPlan:
    """Static time-axis decomposition for one sharded compile.

    All sources share one TIME decomposition (chunk and halo times as exact
    rationals); each source's sample counts are that time scaled by its
    rate. The scalar ``in_rate/quantum/chunk/halo`` fields describe the
    FASTEST source."""

    in_rate: int
    quantum: int      # chunk/halo alignment quantum (input samples)
    sp: int           # number of time shards
    chunk: int        # input samples per shard (multiple of quantum)
    halo: int         # halo size on each side (multiple of quantum)
    rates_by_key: Dict[str, int] = dataclasses.field(default_factory=dict)
    chunks_by_key: Dict[str, int] = dataclasses.field(default_factory=dict)
    halos_by_key: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def window(self) -> int:
        return self.halo + self.chunk + self.halo

    @property
    def capacity(self) -> int:
        return self.sp * self.chunk

    def window_for(self, key: str) -> int:
        return self.chunks_by_key[key] + 2 * self.halos_by_key[key]


def plan_sharded(
    graph: Graph,
    sources: Dict[Tuple[int, str], compiler.SourceSpec],
    mesh: Mesh,
    sp_axis: str = "sp",
    halo_seconds: float = 0.25,
) -> ShardPlan:
    """Validate shardability and compute the time decomposition. The
    plan's ``capacity`` is what every input buffer must be padded to
    (``plan_capacity_for`` gives it from raw clip lengths)."""
    from nodey_tpu_torch.core.streaming import _chunk_quantum, supports_chunked

    if not supports_chunked(graph):
        raise ProcessorRuntimeError(
            "Graph not time-shardable",
            "Non-LTI or infinite-impulse-response nodes (velocity/pitch "
            "WSOLA, audio_limiter/compressor/gate, audio_eq/filter) cannot "
            "shard the sample axis via overlap-discard; run them via "
            "compile_graph_dp, the streaming carry path, or single-device "
            "rendering (PV tempo stages, dynamics and IIR nodes shard "
            "via compile_chain_sp_tv).",
            "plan_sharded",
        )
    sp = mesh.shape[sp_axis]
    rates = sorted({spec.rate for spec in sources.values()})
    # One TIME quantum every source shares: shard boundaries then sit at
    # the same instant in every source.
    t_q = Fraction(_chunk_quantum(graph, rates[0]), rates[0])
    for r in rates[1:]:
        t_q = _time_lcm(t_q, Fraction(_chunk_quantum(graph, r), r))

    times = {Fraction(spec.capacity, spec.rate) for spec in sources.values()}
    if len(times) != 1:
        raise ProcessorRuntimeError(
            "Input capacities not time-consistent",
            "All sharded inputs must be padded to the same DURATION "
            "(capacity proportional to rate); use plan_capacity_for per "
            "source rate.",
            f"durations: {sorted(str(t) for t in times)}",
        )
    total_time = times.pop()
    chunk_time = total_time / sp
    if (chunk_time / t_q).denominator != 1:
        raise ProcessorRuntimeError(
            "Capacity not shard-aligned",
            "Per-shard duration must be a multiple of the graph's shared "
            "time quantum; pad with plan_capacity_for first.",
            f"chunk_time={chunk_time}s quantum={t_q}s sp={sp}",
        )

    # Halo >= every receptive field: resampler taps, STFT windows (n_fft
    # samples at the node's rate), a reverb's or a delay's declared
    # ``receptive_seconds``; plus the t0 spread, which compounds with them
    # (a shifted stream's window needs spread + receptive context) and
    # keeps the summed lengths exact.
    max_n_fft = max(
        [getattr(n.processor, "n_fft", 0) for n in graph.nodes.values()]
        + [0]
    )
    max_receptive_s = max(
        [float(getattr(n.processor, "receptive_seconds", 0.0))
         for n in graph.nodes.values()]
        + [0.0]
    )
    min_rate = rates[0]
    t0s = [spec.t0_us for spec in sources.values()]
    t0_spread_s = (max(t0s) - min(t0s)) * 1e-6 if t0s else 0.0
    receptive = max(
        Fraction(halo_seconds).limit_denominator(10**6),
        Fraction(2 * max_n_fft, min_rate),
        Fraction(1024, min_rate),
        Fraction(max_receptive_s).limit_denominator(10**6),
    )
    halo_time_min = receptive + Fraction(t0_spread_s).limit_denominator(
        10**6
    )
    halo_time = t_q * (-(-halo_time_min // t_q))  # ceil to the time quantum

    rates_by_key, chunks_by_key, halos_by_key = {}, {}, {}
    for (nid, pin), spec in sources.items():
        key = compiler.external_key(nid, pin)
        rates_by_key[key] = spec.rate
        c = chunk_time * spec.rate
        h = halo_time * spec.rate
        assert c.denominator == 1 and h.denominator == 1, (c, h)
        chunks_by_key[key] = int(c)
        halos_by_key[key] = int(h)

    fastest = max(rates)
    return ShardPlan(
        in_rate=fastest, quantum=_chunk_quantum(graph, fastest), sp=sp,
        chunk=int(chunk_time * fastest), halo=int(halo_time * fastest),
        rates_by_key=rates_by_key, chunks_by_key=chunks_by_key,
        halos_by_key=halos_by_key,
    )


def plan_capacity_for(graph: Graph, in_rate: int, max_length: int,
                      mesh: Mesh, sp_axis: str = "sp") -> int:
    """Smallest shard-aligned capacity covering ``max_length`` samples."""
    from nodey_tpu_torch.core.streaming import _chunk_quantum

    quantum = _chunk_quantum(graph, in_rate)
    return _round_up(max(max_length, 1), quantum * mesh.shape[sp_axis])


def plan_capacities_for(graph: Graph,
                        rate_lengths: Dict[Any, Tuple[int, int]],
                        mesh: Mesh, sp_axis: str = "sp") -> Dict[Any, int]:
    """Per-source shard-aligned capacities for MIXED input rates: every
    source padded to one shared duration (a multiple of the graph's shared
    time quantum x sp) covering every clip. ``rate_lengths`` maps a caller
    key -> (rate, max_length_samples)."""
    from nodey_tpu_torch.core.streaming import _chunk_quantum

    sp = mesh.shape[sp_axis]
    t_q = None
    for rate, _ in rate_lengths.values():
        t = Fraction(_chunk_quantum(graph, rate), rate)
        t_q = t if t_q is None else _time_lcm(t_q, t)
    need_time = max(
        Fraction(max(length, 1), rate)
        for rate, length in rate_lengths.values()
    )
    step = t_q * sp
    total_time = step * (-(-need_time // step))
    out = {}
    for key, (rate, _length) in rate_lengths.items():
        cap = total_time * rate
        assert cap.denominator == 1
        out[key] = int(cap)
    return out


def _home_tensor(key: str, data, home: torch.device) -> torch.Tensor:
    """An input as a tensor: a numpy array as it is (each shard's slice is
    copied to its device), a tensor only on the mesh's first device."""
    if torch.is_tensor(data):
        if data.device != home:
            raise LogicError(f"input {key} is on {data.device}, the mesh's "
                             f"first device is {home}")
        return data
    return torch.from_numpy(np.ascontiguousarray(data))


def _host_lengths(key: str, lens) -> Tuple[int, ...]:
    if torch.is_tensor(lens) and lens.device.type != "cpu":
        raise LogicError(f"lengths of {key} are on {lens.device}: lengths "
                         f"stay on the host")
    return tuple(int(n) for n in np.asarray(lens).reshape(-1))


class ShardedCompiledGraph:
    """A graph compiled for dp x sp execution on a mesh."""

    def __init__(self, inner: Dict[torch.device, compiler.CompiledGraph],
                 mesh: Mesh, plan: ShardPlan, input_keys: List[str],
                 mode: str, batched: bool, dp_axis: Optional[str],
                 sp_axis: str):
        self.inner = inner               # the window program, per device
        self.mesh = mesh
        self.plan = plan
        self.input_keys = input_keys
        self.mode = mode
        self.batched = batched
        self.dp_axis = dp_axis
        self.sp_axis = sp_axis
        self.output_meta: Dict[str, Any] = {}
        self.dropped_outputs: List[str] = []
        self._trims: Optional[Dict[str, Dict[str, int]]] = None

    def _derive_trims(self, meta: Dict[str, Any]) -> None:
        """Static trim geometry per output from the window program's
        metadata: stream outputs must land on an integral grid; array
        outputs (STFT frames) also need hop-aligned shard boundaries, and
        those that do not align are dropped (recorded, never silent)."""
        halo_in, chunk_in, in_rate = (self.plan.halo, self.plan.chunk,
                                      self.plan.in_rate)
        trims, dropped = {}, []
        for key, m in meta.items():
            if m["kind"] == "stream":
                out_rate = m["rate"]
                if ((halo_in * out_rate) % in_rate
                        or (chunk_in * out_rate) % in_rate):
                    raise ProcessorRuntimeError(
                        "Shard alignment failure",
                        "The graph converts to a sample rate the shard "
                        "planner did not account for.",
                        f"in_rate={in_rate} out_rate={out_rate}",
                    )
                trims[key] = {"halo": halo_in * out_rate // in_rate,
                              "chunk": chunk_in * out_rate // in_rate}
                continue
            hop, node_rate = m.get("hop"), m.get("rate")
            if (not hop or not node_rate or (halo_in * node_rate) % in_rate
                    or (chunk_in * node_rate) % in_rate):
                dropped.append(key)
                continue
            halo_r = halo_in * node_rate // in_rate
            chunk_r = chunk_in * node_rate // in_rate
            if halo_r % hop or chunk_r % hop:
                dropped.append(key)
                continue
            trims[key] = {"frame0": halo_r // hop, "frames": chunk_r // hop}
        self._trims = trims
        self.dropped_outputs = dropped
        self.output_meta = {k: dict(m) for k, m in meta.items()
                            if k in trims}

    def output_metadata(self) -> Dict[str, Any]:
        """The outputs' metadata (rates, channels, hops): from the first
        run, or, before one, from one run of the window program on silence
        on the mesh's first device."""
        if self._trims is None:
            program = self.inner[self.mesh.devices.flat[0]]
            _, meta = program({
                compiler.external_key(*k): (
                    torch.zeros((s.channels, s.capacity),
                                device=program.device), s.capacity)
                for k, s in program.sources.items()})
            self._derive_trims(meta)
        return self.output_meta

    def _row(self, data: Dict[str, torch.Tensor],
             lens: Dict[str, Tuple[int, ...]],
             devices: List[Optional[torch.device]], permute=ppermute,
             psum=psum):
        """One dp row: every sp shard's window program on its device, each
        output trimmed to the shard's own span. Returns ({key: [per-shard
        piece]}, {key: summed lengths}) (lengths a tuple a clip when
        batched, else an int).

        On a mesh that spans processes (``parallel.dcn``) a shard another
        process holds has device ``None``: this process runs and returns
        only its own shards' pieces, the halos cross through ``permute``
        and the lengths sum through ``psum``."""
        sp = len(devices)
        windows = [{} for _ in range(sp)]
        for key in self.input_keys:
            h_k = self.plan.halos_by_key[key]
            c_k = self.plan.chunks_by_key[key]
            chunks = [None if dev is None else to_device(c, dev) for c, dev
                      in zip(torch.chunk(data[key], sp, dim=-1), devices)]
            for i, ext in enumerate(halo_exchange_nd(chunks, h_k, h_k,
                                                     permute)):
                if ext is None:
                    continue
                start = i * c_k - h_k
                local = tuple(min(max(n - start, 0), c_k + 2 * h_k)
                              for n in lens[key])
                windows[i][key] = (ext, local if self.batched else local[0])
        pieces: Dict[str, List[torch.Tensor]] = {}
        contribs: Dict[str, List[Any]] = {}
        for i, dev in enumerate(devices):
            if dev is None:
                continue
            program = self.inner[dev]
            if self.batched:
                out, meta = program.run_batch(
                    {k: v[0] for k, v in windows[i].items()},
                    {k: v[1] for k, v in windows[i].items()})
            else:
                out, meta = program(windows[i])
            if self._trims is None:
                self._derive_trims(meta)
            for key, t in self._trims.items():
                if "halo" in t:
                    data_w, len_w = out[key]
                    pieces.setdefault(key, []).append(
                        data_w[..., t["halo"]:t["halo"] + t["chunk"]])
                    contribs.setdefault(key, []).append(
                        tuple(min(max(n - t["halo"], 0), t["chunk"])
                              for n in (len_w if self.batched else (len_w,))))
                else:
                    pieces.setdefault(key, []).append(
                        out[key][..., t["frame0"]:t["frame0"] + t["frames"],
                                 :])
        lengths = {}
        for key, parts in contribs.items():
            total = tuple(psum(c) for c in zip(*parts))
            lengths[key] = total if self.batched else total[0]
        return pieces, lengths

    def run(self, arrays: Dict[str, Any], lengths: Dict[str, Any]
            ) -> Dict[str, Any]:
        """Execute on the mesh; outputs come back on the mesh's first
        device, stream outputs as ``(data, length)``.

        Unbatched: ``arrays[key]`` is [C, capacity], ``lengths[key]`` an
        int. Batched: [B, C, capacity] with B divisible by the dp size,
        ``lengths[key]`` B host ints. Inputs are numpy arrays or tensors on
        the mesh's first device."""
        rows, row_lens = self.run_rows(arrays, lengths)
        return self._gather(rows, row_lens, self.mesh.devices.flat[0])

    def run_rows(self, arrays: Dict[str, Any], lengths: Dict[str, Any]):
        """``run`` before its gathers: (per dp row {key: [the sp shards'
        pieces, each on its shard's device]}, per dp row {key: lengths}).
        One row when unbatched."""
        home = self.mesh.devices.flat[0]
        data = {k: _home_tensor(k, arrays[k], home) for k in self.input_keys}
        lens = {k: _host_lengths(k, lengths[k]) for k in self.input_keys}
        for key in self.input_keys:
            cap = self.plan.sp * self.plan.chunks_by_key[key]
            want = 3 if self.batched else 2
            if data[key].dim() != want or data[key].shape[-1] != cap:
                raise LogicError(f"input {key}: want {want} dims with "
                                 f"{cap} samples, got {list(data[key].shape)}")
        if not self.batched:
            pieces, out_lens = self._row(
                data, lens, self.mesh.axis_devices(self.sp_axis))
            return [pieces], [out_lens]
        dp = self.mesh.shape[self.dp_axis]
        B = data[self.input_keys[0]].shape[0]
        if B % dp or any(data[k].shape[0] != B or len(lens[k]) != B
                         for k in self.input_keys):
            raise LogicError(f"a batch of {B} clips over {self.dp_axis}={dp}"
                             f" (every input {B} clips and {B} lengths)")
        share = B // dp
        rows, row_lens = [], []
        for d in range(dp):
            sl = slice(d * share, (d + 1) * share)
            pieces, out_lens = self._row(
                {k: v[sl] for k, v in data.items()},
                {k: v[sl] for k, v in lens.items()},
                self.mesh.axis_devices(self.sp_axis, **{self.dp_axis: d}))
            rows.append(pieces)
            row_lens.append(out_lens)
        return rows, row_lens

    def _gather(self, rows, row_lens, home: torch.device) -> Dict[str, Any]:
        result = {}
        for key, t in self._trims.items():
            if "halo" in t:
                parts = [gather_time(r[key], home) for r in rows]
                data = torch.cat(parts, dim=0) if self.batched else parts[0]
                length = (sum((rl[key] for rl in row_lens), ())
                          if self.batched else row_lens[0][key])
                result[key] = (data, length)
            else:
                parts = [torch.cat([to_device(p, home) for p in r[key]],
                                   dim=-2) for r in rows]
                result[key] = (torch.cat(parts, dim=0) if self.batched
                               else parts[0])
        return result


def compile_graph_sharded(
    graph: Graph,
    sources: Dict[Tuple[int, str], compiler.SourceSpec],
    mesh: Mesh,
    mode: str = "export",
    sp_axis: str = "sp",
    dp_axis: Optional[str] = None,
    halo_seconds: float = 0.25,
) -> ShardedCompiledGraph:
    """Compile the graph for sharded execution over ``mesh``.

    The window program is the SAME compile as a single render's
    (``compiler.compile_graph`` over window-sized sources, one per distinct
    device of the mesh), so every output sample is the same computation
    over the same input values: the kernels' sums are row by row, and the
    master comes out bitwise the single render's. With ``dp_axis`` the
    inputs are [B, C, capacity] batches, each dp shard's clips one
    ``run_batch`` on every sp shard's device."""
    plan = plan_sharded(graph, sources, mesh, sp_axis, halo_seconds)
    window_sources = {
        k: dataclasses.replace(
            spec, capacity=plan.window_for(compiler.external_key(*k)))
        for k, spec in sources.items()
    }
    inner = {dev: compiler.compile_graph(graph, window_sources, mode=mode,
                                         device=dev)
             for dev in mesh.distinct_devices()}
    return ShardedCompiledGraph(
        inner=inner, mesh=mesh, plan=plan,
        input_keys=sorted(compiler.external_key(*k) for k in sources),
        mode=mode, batched=dp_axis is not None, dp_axis=dp_axis,
        sp_axis=sp_axis)


class DpCompiledGraph:
    """A graph compiled for pure data-parallel (dp) execution: the single
    render's program, run by ``CompiledGraph.run_batch(mesh=)``."""

    def __init__(self, compiled: compiler.CompiledGraph, mesh: Mesh,
                 dp_axis: str):
        self.compiled = compiled
        self.mesh = mesh
        self.dp_axis = dp_axis
        self.input_keys = compiled.input_keys
        self.mode = compiled.mode
        self.output_meta: Dict[str, Any] = {}

    def run(self, arrays: Dict[str, Any], lengths: Dict[str, Any]
            ) -> Dict[str, Any]:
        """Execute a [B, C, capacity] batch sharded over dp; outputs come
        back in clip order on the mesh's first device (``[B, ...]`` each,
        stream lengths a tuple of B host ints)."""
        out, meta = self.compiled.run_batch(arrays, lengths, mesh=self.mesh,
                                            dp_axis=self.dp_axis)
        self.output_meta = {k: dict(m) for k, m in meta.items()}
        return out


def compile_graph_dp(
    graph: Graph,
    sources: Dict[Tuple[int, str], compiler.SourceSpec],
    mesh: Mesh,
    mode: str = "export",
    dp_axis: str = "dp",
) -> DpCompiledGraph:
    """Compile ANY graph, the time-variant velocity/pitch chains that the
    sp planner refuses included, for data-parallel execution: each dp
    shard renders its share of an independent-clip batch with the full
    single-device program, as one ``run_batch`` on its device, so each
    clip is bitwise its single render (``run_batch``'s contract) and no
    halo algebra is needed (WSOLA's serial frame chain stays whole within
    each clip)."""
    home = mesh.axis_devices(dp_axis)[0]
    return DpCompiledGraph(
        compiler.compile_graph(graph, sources, mode=mode, device=home),
        mesh, dp_axis)
