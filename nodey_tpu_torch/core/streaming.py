"""Real-time preview and chunked long-clip rendering (port of
nodey_tpu.core.streaming).

1. **Preview streaming** (``StreamingSession``). By default the graph runs
   chunk by chunk through the streaming executor in preview mode (half-second
   chunks, so device memory stays flat for any clip length), and the
   executor's sink hands each host block to a bounded queue (capacity 16,
   the reference's channel depth) that the consumer drains, paced at 1.0x
   for a live preview. ``start(streamed=False)`` renders the whole preview
   mix on the device first and a producer thread copies it to the host
   block by block. A graph that cannot stream in lockstep (a mixer whose
   branches run at different tempos) is previewed whole-clip on the same
   device, as in the JAX package.

2. **Chunked rendering** (``render_chunked``): an export render of a
   time-invariant graph per time chunk, each chunk with a left and a right
   halo (``halo_seconds``, or the largest ``receptive_seconds`` a node
   declares, rounded up to the quantum), the halos' output discarded
   (overlap-discard), and chunks enough to cover the tail a reverb or a
   delay adds past the input. Chunk lengths are multiples of every
   resampler's input stride (times its group factor), of the spectrum hop
   and of the reverb's partition, so the chunks' outputs concatenate
   exactly. Valid for the time-invariant node set; the velocity, pitch,
   modulation, fade and master-bus nodes carry state from one chunk to the
   next and are refused (the streamed export runs them).

Both run on the device they are given (``cuda`` unless the caller asks for
the CPU); a CUDA device without a card raises. Producer threads bind the
caller's CUDA device and stream, so what they copy is ordered after the
work that computed it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from nodey_tpu_torch import config as cfg
from nodey_tpu_torch.core import compiler
from nodey_tpu_torch.core.errors import (ProcessorRuntimeError,
                                         UnstreamableGraphError)
from nodey_tpu_torch.core.graph import Graph
from nodey_tpu_torch.core.registry import Processor
from nodey_tpu_torch.core.runner import Runner
from nodey_tpu_torch.host.streamio import BoundedBlockQueue, RealtimePacer

# Nodes whose offline lowering is time-invariant and stride-aligned, so
# overlap-discard chunking is exact: the JAX package's set.
_LTI_NODES = {
    "audio_input", "audio_output", "audio_volume_adjust", "audio_amix",
    "audio_resample", "audio_spectrum", "audio_split", "audio_bimix",
    "audio_bimix_v2", "audio_reverb", "audio_delay", "audio_pan",
    "audio_width",
}


@dataclasses.dataclass
class StreamStats:
    blocks: int = 0
    underruns: int = 0
    fill_ratio: float = 0.0
    rtf_compute: float = 0.0
    # Host seconds from start() to the first block reaching the consumer.
    first_block_seconds: float = 0.0


def _current_stream(device: torch.device):
    return torch.cuda.current_stream(device) if device.type == "cuda" else None


@contextlib.contextmanager
def _bound(device: torch.device, stream):
    """The calling thread's CUDA device and stream (nothing on the CPU)."""
    if device.type != "cuda":
        yield
        return
    with torch.cuda.device(device), torch.cuda.stream(stream):
        yield


def start_block_egress(
    master: torch.Tensor,
    length: int,
    block_samples: int,
    queue: BoundedBlockQueue,
    stop: threading.Event,
    errors: list,
) -> threading.Thread:
    """Start a producer thread that copies a device master [C, >= length]
    to the host in [C, <= block_samples] blocks and pushes them into a
    bounded queue (backpressure, EOF, error capture): the copies run on the
    stream current at this call, after the work that computed the master.
    Exceptions of the producer land in ``errors`` for the consumer to
    re-raise; the queue reaches EOF either way."""
    stream = _current_stream(master.device)
    n_blocks = max(1, -(-length // block_samples))

    def produce() -> None:
        try:
            with _bound(master.device, stream):
                for b in range(n_blocks):
                    if stop.is_set():
                        break
                    lo = b * block_samples
                    hi = min(length, lo + block_samples)
                    block = master[:, lo:hi].to("cpu", copy=True).numpy()
                    if not queue.push(block, stop=stop):
                        break
        except BaseException as exc:
            errors.append(exc)
        finally:
            queue.set_eof()

    thread = threading.Thread(target=produce, daemon=True)
    thread.start()
    return thread


class StreamingSession:
    """Real-time preview of a graph on one device: a producer (the chunked
    preview, or the whole-clip render and its egress) and a bounded block
    queue that ``blocks()`` drains."""

    def __init__(
        self,
        graph: Graph,
        block_samples: int = cfg.BUFFER_SIZE * 8,
        queue_capacity: int = cfg.AUDIO_STREAM_BUFFER_SIZE,
        device: torch.device | str = "cuda",
    ):
        self.runner = Runner(graph, device=device)
        self.device = self.runner.device
        self.block_samples = block_samples
        self.queue = BoundedBlockQueue(queue_capacity)
        self._stop = threading.Event()
        self._producer: Optional[threading.Thread] = None
        self._producer_errors: list = []
        self._master: Optional[torch.Tensor] = None  # whole-clip [2, N]
        self._length = 0
        self._executor = None
        self._started = 0.0
        self.stats = StreamStats()

    def start(self, streamed: bool = True) -> "StreamingSession":
        """Start the preview pipeline.

        ``streamed=True`` (default): chunk-by-chunk execution through the
        streaming executor, with device memory flat for any clip length.
        ``False``: the whole clip rendered on the device first (the lowest
        first-block latency for short clips)."""
        self._started = time.perf_counter()
        if streamed:
            return self._start_streamed()
        return self._start_whole_clip()

    def _start_streamed(self) -> "StreamingSession":
        from nodey_tpu_torch.core.stream_executor import StreamExecutor

        # Half-second chunks keep the first block early. Spectrum frames are
        # not kept: nothing reads them here, and keeping them on the device
        # would grow its memory with the clip.
        self._executor = StreamExecutor(
            self.runner.graph, mode="preview", chunk_seconds=0.5,
            collect_frames=False, device=self.device,
        )
        stream = _current_stream(self.device)

        def produce() -> None:
            try:
                with _bound(self.device, stream):
                    metrics = self._executor.run(
                        sink=lambda block: self.queue.push(block,
                                                           stop=self._stop))
                self._length = round(metrics.audio_seconds * cfg.SAMPLE_RATE)
                self.stats.rtf_compute = metrics.rtf
            except UnstreamableGraphError:
                # Lockstep streaming refuses a mixer whose branches run at
                # different tempos before any block exists; the whole-clip
                # path previews such a graph exactly, into the same queue.
                try:
                    with _bound(self.device, stream):
                        self._start_whole_clip()
                    self._producer.join()
                    return  # its egress set the queue's EOF
                except BaseException as exc:
                    self._producer_errors.append(exc)
            except BaseException as exc:
                self._producer_errors.append(exc)
            finally:
                self.queue.set_eof()

        self._producer = threading.Thread(target=produce, daemon=True)
        self._producer.start()
        return self

    def _start_whole_clip(self) -> "StreamingSession":
        """Render the preview mix on the device and start its egress."""
        runner = self.runner
        arrays, lengths, sources = runner.decode()
        compiled = runner.compile(sources, "preview")
        args = runner.ingest(arrays, lengths)
        t0 = time.perf_counter()
        outputs, _meta = compiled(args)
        if "preview" not in outputs:
            raise ProcessorRuntimeError(
                "Preview produced no audio",
                "The graph has no audio_output node receiving a stream.",
                "preview output missing",
            )
        master, self._length = outputs["preview"]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        compute_s = time.perf_counter() - t0
        audio_s = self._length / cfg.SAMPLE_RATE
        self.stats.rtf_compute = audio_s / compute_s if compute_s else 0.0
        self._master = master
        self._producer = start_block_egress(
            master, self._length, self.block_samples, self.queue,
            self._stop, self._producer_errors,
        )
        return self

    def blocks(self, realtime: bool = False) -> Iterator[np.ndarray]:
        """The preview's host blocks [C, n] in order; paced at 1.0x when
        ``realtime`` (the last block's time is waited out too)."""
        pacer = RealtimePacer() if realtime else None
        while True:
            block = self.queue.pop(stop=self._stop)
            if block is None:
                break
            if self.stats.blocks == 0:
                self.stats.first_block_seconds = (time.perf_counter()
                                                  - self._started)
            if pacer is not None:
                pacer.wait(block.shape[1])
            self.stats.blocks += 1
            self.stats.fill_ratio = self.queue.stats.fill_ratio
            yield block
        if pacer is not None and not self._stop.is_set():
            pacer.wait(0)
        self.stats.underruns = self.queue.stats.consumer_waits
        if self._producer_errors:
            raise self._producer_errors[0]

    def stop(self) -> None:
        """Cooperative cancellation (the reference's stop_source,
        include/infra/runner.hpp:47, runner.cpp:53-63)."""
        self._stop.set()
        if self._executor is not None:
            self._executor.stop()
        self.queue.set_eof()
        if self._producer is not None:
            self._producer.join(timeout=5.0)

    @property
    def duration_seconds(self) -> float:
        return self._length / cfg.SAMPLE_RATE


def _chunk_quantum(graph: Graph, in_rate: int) -> int:
    """Chunk-length quantum in input samples: every rate conversion the
    graph can make sees chunk boundaries at multiples of its input stride
    M times its group factor (so a chunk's first group sits at cycle phase
    0, as offline), and the input -> output coordinate map is integral, so
    chunk outputs concatenate exactly. The lcm over every ordered pair of
    reachable rates (an audio_resample node may convert either way), and
    every STFT hop."""
    from nodey_tpu_torch.ops.resample import _rational, group_factor

    q = 1
    rates = {in_rate, cfg.AMIX_STD_SAMPLE_RATE}
    for node in graph.nodes.values():
        target = getattr(node.processor, "target_rate", None)
        if target:
            rates.add(int(target))
        hop = getattr(node.processor, "hop", None)
        if hop:
            q = math.lcm(q, int(hop))
    for a in rates:
        for b in rates:
            if a != b:
                L, M = _rational(a, b)
                q = math.lcm(q, M * group_factor(L, M))
    return q


def supports_chunked(graph: Graph) -> bool:
    """True when every node is time-invariant (overlap-discard is exact)."""
    return all(
        node.processor.info().identifier in _LTI_NODES
        for node in graph.nodes.values()
    )


def stream_supported(graph: Graph) -> bool:
    """True when every node implements chunk streaming (core/chunkflow.py),
    the time-variant velocity and pitch nodes included."""
    return all(
        type(node.processor).plan_stream is not Processor.plan_stream
        for node in graph.nodes.values()
    )


def render_chunked(
    graph: Graph,
    chunk_seconds: float = 30.0,
    halo_seconds: float = 0.25,
    progress: Optional[Callable[[float], None]] = None,
    device: torch.device | str = "cuda",
):
    """Overlap-discard chunked export render of a time-invariant graph on
    ``device``: device memory holds one window (halo + chunk + halo) of
    every edge, whatever the clip's length.

    Returns ``(master [C, n] on the host, rate, fmt, spectra)``; a spectrum
    keeps the frames whose hop-aligned starts fall in each chunk's own
    region (a spectrum whose hop does not divide the chunk grid is
    dropped)."""
    if not supports_chunked(graph):
        raise ProcessorRuntimeError(
            "Graph not chunkable",
            "Time-variant nodes (velocity/pitch) require whole-clip "
            "rendering; use Runner.render instead.",
            "render_chunked",
        )
    runner = Runner(graph, device=device)
    arrays, lengths, sources = runner.decode()
    if not sources:
        raise ProcessorRuntimeError(
            "Graph has no inputs",
            "Chunked rendering requires at least one audio_input slot.",
            "render_chunked",
        )
    rates = {spec.rate for spec in sources.values()}
    if len(rates) != 1:
        raise ProcessorRuntimeError(
            "Mixed input rates not chunkable",
            "Chunked rendering currently requires equal input rates.",
            f"rates: {sorted(rates)}",
        )
    in_rate = rates.pop()
    if any(spec.t0_us for spec in sources.values()):
        raise ProcessorRuntimeError(
            "Stream start offsets not chunkable",
            "Inputs with pts start offsets (t0_us != 0) require whole-clip "
            "or chunk-flow streaming execution.",
            "render_chunked",
        )

    quantum = _chunk_quantum(graph, in_rate)
    chunk = max(1, int(chunk_seconds * in_rate) // quantum) * quantum
    # The halo covers every node's receptive field: the nodes whose output
    # reaches further back than a resampler's taps (reverb, delay) declare
    # theirs as ``receptive_seconds``.
    max_receptive_s = max(
        [float(getattr(n.processor, "receptive_seconds", 0.0))
         for n in graph.nodes.values()] + [0.0])
    halo = -(-int(max(halo_seconds, max_receptive_s) * in_rate)
             // quantum) * quantum
    total = max(lengths.values())
    # Tail-growing nodes emit past the input's end: enough chunks to cover
    # the grown output.
    tail_in = int(max_receptive_s * in_rate)
    n_chunks = max(1, -(-(total + tail_in) // chunk))

    # Window = left halo + chunk + right halo, both halos discarded (the
    # right one covers the resampler taps reading past the chunk's end).
    window = halo + chunk + halo
    compiled = compiler.compile_graph(
        graph, {key: dataclasses.replace(spec, capacity=window)
                for key, spec in sources.items()},
        mode="export", device=runner.device)

    pieces = []
    spectra_pieces: Dict[str, list] = {}
    spectra_dropped = set()
    master_meta = None
    out_len_total = 0
    for c in range(n_chunks):
        start = c * chunk - halo
        cargs = {}
        for key in compiled.input_keys:
            src = arrays[key]
            buf = np.zeros((src.shape[0], window), dtype=src.dtype)
            lo, hi = max(0, start), min(src.shape[1], start + window)
            if hi > lo:
                buf[:, lo - start : hi - start] = src[:, lo:hi]
            cargs[key] = (torch.from_numpy(buf).to(runner.device),
                          max(0, min(lengths[key] - start, window)))
        outputs, meta = compiled(cargs)
        if "master" not in outputs:
            raise ProcessorRuntimeError(
                "Export produced no audio",
                "The graph has no audio_output node receiving a stream.",
                "master output missing",
            )
        data, length = outputs["master"]
        master_meta = meta["master"]
        out_rate = master_meta["rate"]
        # The quantum makes the halo and chunk integral at the output rate;
        # a processor converting to a rate the planner did not see fails.
        if (halo * out_rate) % in_rate or (chunk * out_rate) % in_rate:
            raise ProcessorRuntimeError(
                "Chunk alignment failure",
                "The graph converts to a sample rate the chunk planner did "
                "not account for; use whole-clip rendering.",
                f"in_rate={in_rate} out_rate={out_rate} chunk={chunk} "
                f"halo={halo}",
            )
        halo_out = halo * out_rate // in_rate
        chunk_out = chunk * out_rate // in_rate
        pieces.append(data[:, halo_out : halo_out + chunk_out].cpu().numpy())
        out_len_total += max(0, min(length - halo_out, chunk_out))
        for key, m in meta.items():
            if m["kind"] != "array" or key in spectra_dropped:
                continue
            hop, node_rate = m.get("hop"), m.get("rate")
            aligned = (hop and node_rate and not (halo * node_rate) % in_rate
                       and not (chunk * node_rate) % in_rate
                       and not (halo * node_rate // in_rate) % hop
                       and not (chunk * node_rate // in_rate) % hop)
            if not aligned:
                spectra_dropped.add(key)
                spectra_pieces.pop(key, None)
                continue
            f0 = halo * node_rate // in_rate // hop
            frames = chunk * node_rate // in_rate // hop
            spectra_pieces.setdefault(key, []).append(
                outputs[key][:, f0 : f0 + frames, :].cpu().numpy())
        if progress is not None:
            progress(min(total, (c + 1) * chunk) / in_rate)

    master = np.concatenate(pieces, axis=1)[:, :out_len_total]
    spectra = {}
    for key, parts in spectra_pieces.items():
        m = meta[key]
        # Offline framing stops at the last window wholly inside the clip.
        total_r = total * m["rate"] // in_rate
        frames_valid = max(0, (total_r - m["n_fft"]) // m["hop"] + 1)
        spectra[key] = np.concatenate(parts, axis=1)[:, :frames_valid, :]
    return master, master_meta["rate"], master_meta["fmt"], spectra
