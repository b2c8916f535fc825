"""The streaming executor: decode ∥ h2d ∥ chunk step ∥ d2h ∥ sink (port of
nodey_tpu.core.stream_executor).

It runs chunk-flow programs (core/chunkflow.py): the graph computes
while its inputs decode, like the reference's decode fiber -> channel ->
DSP fiber -> sink pipeline (src/processor/audio-io.cpp:86-226, sink
backpressure at :620-636). Stages:

  [decode threads]  one per input stream (the native StreamDecoder where
                    the codec runtime loads; else a WAV read block by block
                    by the Python reader), pushing blocks into bounded
                    queues.
  [pump]            the caller's thread: fills a pinned host block per input
                    and copies it to the card with ``non_blocking=True``,
                    runs the chunk step (kernels queue on the compute
                    stream; every count is a host int, so nothing waits on
                    the card), and starts the master's copy to pinned host
                    memory on a side stream after an event from the compute
                    stream. It never synchronizes.
  [egress thread]   waits on each copy's event, not on the whole card, so
                    the next steps compute while this one drains.
  [sink thread]     the caller's sink (WAV write, MP3 encode).

Memory is bounded by the queue depths times the chunk size on the host and
by the carry FIFOs on the card, for any clip length. On the CPU
(``device="cpu"``) the same pipeline runs with plain host tensors. The JAX
package's concurrent d2h fetch pool (``NODEY_D2H_WORKERS``) overlapped
round trips through a remote relay and is not ported.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from nodey_tpu_torch import config as cfg
from nodey_tpu_torch.core import chunkflow, compiler
from nodey_tpu_torch.core.errors import LogicError, ProcessorRuntimeError
from nodey_tpu_torch.core.graph import Graph
from nodey_tpu_torch.core.stream import FMT_S16
from nodey_tpu_torch.host import decode as host_decode
from nodey_tpu_torch.host.streamio import BoundedBlockQueue

_log = logging.getLogger("nodey_tpu_torch.stream")


@dataclasses.dataclass
class StreamMetrics:
    audio_seconds: float = 0.0
    wall_seconds: float = 0.0
    compile_seconds: float = 0.0       # the plan pass (carries allocated)
    steps: int = 0
    decode_wait_seconds: float = 0.0   # pump stalls waiting on decode
    egress_wait_seconds: float = 0.0   # pump stalls on egress backpressure
    d2h_busy_seconds: float = 0.0      # egress thread waiting on d2h copies
    sink_busy_seconds: float = 0.0     # sink thread inside sink()
    rss_peak_bytes: int = 0            # host RSS high-water mark this run

    @property
    def rtf(self) -> float:
        return self.audio_seconds / self.wall_seconds if self.wall_seconds else 0.0


def _rss_bytes() -> int:
    """Process RSS from /proc/self/status (reference: src/utility/
    system.cpp:12-44); 0 where /proc is absent."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


class _RssGuard:
    """Host-memory watchdog for long exports: samples RSS at most every
    ``interval_s`` on the pump thread, keeps the high-water mark, and
    enforces NODEY_RSS_SOFT_MB (default 4096: one warning and a
    gc.collect() per run) and NODEY_RSS_HARD_MB (default 16384, 0
    disables: a structured error, failing the run before the OOM killer
    does)."""

    def __init__(self, metrics: StreamMetrics, interval_s: float = 2.0):
        self.metrics = metrics
        self.interval_s = interval_s
        self.soft = float(os.environ.get("NODEY_RSS_SOFT_MB", "4096")) * 2**20
        self.hard = float(os.environ.get("NODEY_RSS_HARD_MB", "16384")) * 2**20
        self._warned = False
        self._next = 0.0
        self.check(force=True)

    def check(self, force: bool = False) -> None:
        now = time.monotonic()
        if not force and now < self._next:
            return
        self._next = now + self.interval_s
        rss = _rss_bytes()
        self.metrics.rss_peak_bytes = max(self.metrics.rss_peak_bytes, rss)
        if self.soft and rss > self.soft and not self._warned:
            self._warned = True
            import gc

            gc.collect()
            _log.warning(
                "stream RSS %.0f MB crossed the soft ceiling %.0f MB "
                "(NODEY_RSS_SOFT_MB); collected garbage", rss / 2**20,
                self.soft / 2**20)
        if self.hard and rss > self.hard:
            raise ProcessorRuntimeError(
                "Streaming run exceeded the host memory ceiling",
                f"Process RSS reached {rss / 2**20:.0f} MB, over the "
                f"enforced NODEY_RSS_HARD_MB={self.hard / 2**20:.0f} "
                "ceiling. Raise the ceiling for very long exports, or "
                "split the export.",
                f"rss_bytes={rss} steps={self.metrics.steps}",
            )


class _SourceFeed:
    """Decode-ahead thread for one input stream.

    ``pop`` yields ``(block [C, n], n, is_last)``. Decodes with the native
    StreamDecoder where the codec runtime loads; else a WAV goes through
    the Python reader one chunk at a time (``host_decode.WavBlockReader``;
    the JAX package decodes the whole clip there), so host memory stays
    bounded either way. Another file without the runtime is decoded whole
    (``decode_file``, which raises for it). s16 sources ride as int16
    (round(x*32768) inverts the decoder's s/32768 exactly) and are
    dequantized on the device (chunkflow.StreamLowerCtx.external)."""

    def __init__(self, path: str, chunk_seconds: float, queue_depth: int = 4):
        self.path = path
        self.queue = BoundedBlockQueue(queue_depth)
        self.errors: List[BaseException] = []
        self._stop = threading.Event()
        self._decoder = None
        self._whole = None
        # Probe the format up front: a bad file raises the structured error
        # before any compute (the reference's pre-start check,
        # audio-io.cpp:234-240).
        try:
            self._decoder = host_decode.StreamDecoder(path)
        except ProcessorRuntimeError:
            if (host_decode.load_native() is None
                    and path.lower().endswith(".wav")):
                self._decoder = host_decode.WavBlockReader(path)
            else:
                self._whole = host_decode.decode_file(path)
        src = self._decoder if self._decoder is not None else self._whole
        self.t0_us = src.pts0_us
        self.rate, self.channels, self.fmt = src.rate, src.channels, src.fmt
        self.chunk = max(1, int(chunk_seconds * self.rate))
        self.wire_dtype = np.int16 if self.fmt == FMT_S16 else np.float32
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> None:
        self._thread.start()

    def _blocks(self) -> Iterator[np.ndarray]:
        if self._decoder is not None:
            with self._decoder as dec:
                yield from dec.blocks(self.chunk)
        else:
            whole = self._whole.data
            for start in range(0, whole.shape[1], self.chunk):
                yield whole[:, start : start + self.chunk]

    def _quantize(self, block: np.ndarray) -> np.ndarray:
        if self.wire_dtype is np.float32:
            return block
        return np.clip(np.round(block * 32768.0), -32768, 32767).astype(np.int16)

    def _run(self) -> None:
        try:
            pending: Optional[np.ndarray] = None
            for block in self._blocks():
                block = self._quantize(block)
                if self._stop.is_set():
                    return
                if pending is not None:
                    if not self.queue.push((pending, False), stop=self._stop):
                        return
                pending = block
            # The last block carries the EOF mark (one block of lookahead,
            # so the last chunk is flagged in the step that delivers it).
            if pending is not None:
                self.queue.push((pending, True), stop=self._stop)
        except BaseException as exc:  # surfaced by the pump
            self.errors.append(exc)
        finally:
            self.queue.set_eof()

    def pop(self, stop) -> Tuple[Optional[np.ndarray], int, bool]:
        item = self.queue.pop(stop=stop)
        if item is None:
            if self.errors:
                raise self.errors[0]
            return None, 0, True
        block, last = item
        return block, block.shape[1], last

    def stop(self) -> None:
        """Stop the thread; a feed whose thread never ran closes its
        decoder here (a running thread closes it on its way out)."""
        self._stop.set()
        if self._decoder is not None and not self._thread.is_alive():
            self._decoder.close()


class _Uploader:
    """h2d of one input's chunks: each chunk fills one of two pinned host
    blocks, which is copied to the card with ``non_blocking=True``; a block
    is refilled only after the event recorded behind its last copy has
    completed. On the CPU, a fresh host tensor per chunk."""

    def __init__(self, channels: int, width: int, dtype, device: torch.device):
        self.device = device
        self.shape = (channels, width)
        self.dtype = torch.int16 if dtype is np.int16 else torch.float32
        self._blocks: List[torch.Tensor] = []
        self._events: List[Optional[torch.cuda.Event]] = []
        if device.type == "cuda":
            self._blocks = [torch.empty(self.shape, dtype=self.dtype,
                                        pin_memory=True) for _ in range(2)]
            self._events = [None, None]
        self._next = 0

    def __call__(self, raw: Optional[np.ndarray], n: int) -> torch.Tensor:
        if self.device.type != "cuda":
            block = torch.zeros(self.shape, dtype=self.dtype)
            if n:
                block[:, :n] = torch.from_numpy(raw)
            return block
        i = self._next
        self._next = 1 - i
        if self._events[i] is not None:
            self._events[i].synchronize()
        host = self._blocks[i].numpy()
        if n:
            host[:, :n] = raw
        host[:, n:] = 0
        out = self._blocks[i].to(self.device, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self._events[i] = event
        return out


class StreamExecutor:
    """Runs a graph incrementally on one device; hands host master blocks
    to a sink in order."""

    def __init__(
        self,
        graph: Graph,
        mode: str = "export",
        chunk_seconds: float = 2.0,
        egress_depth: int = cfg.AUDIO_STREAM_BUFFER_SIZE,
        master_wire: str = "f32",
        collect_frames: bool = True,
        device: torch.device | str = "cuda",
    ):
        self.graph = graph
        self.mode = mode
        self.chunk_seconds = chunk_seconds
        self.egress_depth = egress_depth
        self.device = compiler.resolve_device(device)
        # master_wire="s16": an s16 master is quantized on the device (the
        # encoders' clip(trunc(x*32768))) and crosses to the host as int16.
        if master_wire not in ("f32", "s16"):
            raise LogicError(f"Unknown master_wire '{master_wire}'")
        self.master_wire = master_wire
        # collect_frames=False drops spectrum frames instead of keeping them
        # on the device: export sinks do not read them, and keeping them
        # would make device memory grow with the clip.
        self.collect_frames = collect_frames
        self.metrics = StreamMetrics()
        self._stop = threading.Event()
        self.spectra: Dict[str, np.ndarray] = {}
        # {rate, channels, fmt[, wire]} of the master, set after the plan
        # pass and before the first sink call (lazy sinks read it).
        self.master_meta: Optional[Dict[str, Any]] = None
        self._feeds: Dict[str, _SourceFeed] = {}
        self._stage_queues: Dict[str, BoundedBlockQueue] = {}
        self._latest_gauges: Optional[Tuple[float, ...]] = None
        self._gauge_keys: Tuple[str, ...] = ()

    def _open_feeds(self):
        """Open a decode feed per audio_input slot; returns ``(feeds,
        sources, plan hints)``. A signal generator is a source with no host
        feed: it only needs a chunk width on the same time quantum as the
        feeds, passed to the plan as its ``chunk_width`` hint."""
        feeds: Dict[str, _SourceFeed] = {}
        pins: Dict[str, Tuple[int, str]] = {}
        generators: Dict[int, int] = {}   # node id -> sample rate
        for nid, node in self.graph.nodes.items():
            proc = node.processor
            ident = proc.info().identifier
            if ident == "audio_generator":
                generators[nid] = int(proc.rate)
                continue
            if ident != cfg.AUDIO_INPUT_NODE_NAME:
                continue
            for i, path in enumerate(proc.file_paths):
                key = compiler.external_key(nid, f"output_{i}")
                try:
                    feeds[key] = _SourceFeed(path, self.chunk_seconds)
                except BaseException:
                    for feed in feeds.values():
                        feed.stop()
                    raise
                pins[key] = (nid, f"output_{i}")
        if not feeds and not generators:
            raise ProcessorRuntimeError(
                "Graph has no inputs",
                "Streaming execution requires at least one audio_input "
                "slot or a signal-generator node.",
                "StreamExecutor",
            )
        # Snap every source's chunk, decode feeds and generators alike, to a
        # shared time quantum (1/gcd of the rates), so all deliver exactly
        # the same audio-seconds per step: lockstep merges need exactly
        # proportional cadences.
        g = 0
        for rate in [feed.rate for feed in feeds.values()] + list(
                generators.values()):
            g = math.gcd(g, rate)
        m = max(1, round(self.chunk_seconds * g))
        sources: Dict[Tuple[int, str], compiler.SourceSpec] = {}
        for key, feed in feeds.items():
            feed.chunk = m * feed.rate // g
            sources[pins[key]] = compiler.SourceSpec(
                rate=feed.rate, channels=feed.channels, fmt=feed.fmt,
                capacity=feed.chunk, t0_us=float(feed.t0_us),
            )
        hints = {nid: {"chunk_width": m * rate // g}
                 for nid, rate in generators.items()}
        return feeds, sources, hints

    def run(
        self,
        sink: Callable[[np.ndarray], None],
        progress: Optional[Callable[[float], None]] = None,
        max_flush_steps: int = 10_000,
    ) -> StreamMetrics:
        """Pump the whole pipeline; calls ``sink(block)`` on the sink
        thread for every host master block ([C, n] float32, or int16 on the
        s16 wire), in order."""
        wall0 = time.perf_counter()
        feeds, sources, plan_hints = self._open_feeds()
        master_key = "master" if self.mode == "export" else "preview"
        try:
            t0 = time.perf_counter()
            compiled = chunkflow.compile_stream_graph(
                self.graph, sources, mode=self.mode, device=self.device,
                plan_hints=plan_hints)
            self.metrics.compile_seconds = time.perf_counter() - t0
            if master_key not in compiled.output_meta:
                raise ProcessorRuntimeError(
                    f"{self.mode.capitalize()} produced no audio",
                    "The graph has no audio_output node receiving a stream.",
                    f"{master_key} output missing",
                )
        except BaseException:
            for feed in feeds.values():
                feed.stop()
            raise
        self._gauge_keys = compiled.gauge_keys
        self.master_meta = dict(compiled.output_meta[master_key])
        out_rate = self.master_meta["rate"]
        quantize = (self.master_wire == "s16"
                    and self.master_meta.get("fmt") == FMT_S16)
        if quantize:
            self.master_meta["wire"] = "s16"
        frames_keys = [k for k, m in compiled.output_meta.items()
                       if m["kind"] == "frames"] if self.collect_frames else []

        on_card = self.device.type == "cuda"
        d2h_stream = torch.cuda.Stream(self.device) if on_card else None
        uploads = {key: _Uploader(feeds[key].channels, compiled.chunk_in[key],
                                  feeds[key].wire_dtype, self.device)
                   for key in compiled.input_keys}
        for feed in feeds.values():
            feed.start()

        egress_q = BoundedBlockQueue(self.egress_depth)
        host_q = BoundedBlockQueue(self.egress_depth)
        errors: List[BaseException] = []
        sink_done = threading.Event()
        written = [0]
        self._feeds = feeds
        self._stage_queues = {"egress": egress_q, "host": host_q}

        def egress():
            # Waits on each block's own copy event: the pump and the card's
            # later steps go on meanwhile.
            try:
                while True:
                    item = egress_q.pop(stop=self._stop)
                    if item is None:
                        break
                    host, copied = item
                    t0 = time.perf_counter()
                    if copied is not None:
                        copied.synchronize()
                    self.metrics.d2h_busy_seconds += time.perf_counter() - t0
                    if not host_q.push(host.numpy(), stop=self._stop):
                        break
            except BaseException as exc:
                errors.append(exc)
                self._stop.set()
            finally:
                host_q.set_eof()

        def consume():
            try:
                while True:
                    block = host_q.pop(stop=self._stop)
                    if block is None:
                        break
                    t0 = time.perf_counter()
                    sink(block)
                    self.metrics.sink_busy_seconds += time.perf_counter() - t0
                    written[0] += block.shape[1]
                    if progress is not None:
                        progress(written[0] / out_rate)
            except BaseException as exc:
                errors.append(exc)
                self._stop.set()
            finally:
                sink_done.set()

        def hand_off(data: torch.Tensor, n: int):
            """(host tensor, copy event or None) of the master's first n
            samples. The block is first copied on the compute stream (or
            quantized), so it never aliases a buffer a later step writes."""
            if quantize:
                block = torch.clamp(torch.trunc(data[:, :n] * 32768.0),
                                    -32768, 32767).to(torch.int16)
            else:
                block = data[:, :n].clone()
            if not on_card:
                return block, None
            computed = torch.cuda.Event()
            computed.record()
            with torch.cuda.stream(d2h_stream):
                d2h_stream.wait_event(computed)
                host = torch.empty(block.shape, dtype=block.dtype,
                                   pin_memory=True)
                host.copy_(block, non_blocking=True)
                block.record_stream(d2h_stream)
                copied = torch.cuda.Event()
                copied.record(d2h_stream)
            return host, copied

        egress_thread = threading.Thread(target=egress, daemon=True)
        egress_thread.start()
        sink_thread = threading.Thread(target=consume, daemon=True)
        sink_thread.start()

        states = compiled.init_states
        source_done = {key: False for key in compiled.input_keys}
        frame_parts: Dict[str, List[torch.Tensor]] = {k: [] for k in frames_keys}
        rss_guard = _RssGuard(self.metrics)
        drained = False
        try:
            flush_steps = 0
            while not self._stop.is_set():
                rss_guard.check()
                args = {}
                for key in compiled.input_keys:
                    raw, n, last = None, 0, True
                    if not source_done[key]:
                        t0 = time.perf_counter()
                        raw, n, last = feeds[key].pop(self._stop)
                        self.metrics.decode_wait_seconds += (
                            time.perf_counter() - t0)
                        source_done[key] = last
                    args[key] = (uploads[key](raw, n), n, last)
                states, outs = compiled.step(states, args)
                self.metrics.steps += 1
                if compiled.gauge_keys:
                    self._latest_gauges = outs[chunkflow.GAUGES_KEY]
                data, n, finished = outs[master_key]
                if n:
                    t0 = time.perf_counter()
                    pushed = egress_q.push(hand_off(data, n), stop=self._stop)
                    self.metrics.egress_wait_seconds += (
                        time.perf_counter() - t0)
                    if not pushed:
                        break
                for k in frames_keys:
                    frames, count, _done = outs[k]
                    if count:
                        frame_parts[k].append(frames[:, :count])
                # With no decode feed (generators only) every step counts
                # toward max_flush_steps, as in the JAX package's loop.
                if all(source_done.values()):
                    if finished:
                        break
                    flush_steps += 1
                    if flush_steps > max_flush_steps:
                        raise ProcessorRuntimeError(
                            "Streaming execution stalled",
                            "The graph did not signal completion while "
                            "flushing node state after EOF.",
                            f"steps={self.metrics.steps}",
                        )
        finally:
            egress_q.set_eof()
            # Both threads set their downstream EOF in `finally`, so the
            # drain ends on errors too.
            drained = sink_done.wait(timeout=600.0)
            self._stop.set()
            for feed in feeds.values():
                feed.stop()
        if errors:
            raise errors[0]
        if not drained:
            # A silent timeout would truncate the output while reporting
            # success.
            raise ProcessorRuntimeError(
                "Streaming sink drain timed out",
                "The egress/sink pipeline did not finish within 600 s "
                "of the last chunk; output may be incomplete.",
                f"steps={self.metrics.steps}",
            )
        for feed in feeds.values():
            if feed.errors:
                raise feed.errors[0]
        for k, parts in frame_parts.items():
            if parts:
                self.spectra[k] = torch.cat(parts, dim=1).cpu().numpy()

        self.metrics.wall_seconds = time.perf_counter() - wall0
        self.metrics.audio_seconds = written[0] / out_rate
        return self.metrics

    def stop(self) -> None:
        """Cooperative cancellation (the reference's stop_source,
        include/infra/runner.hpp:47): the run drains what it has and
        returns early."""
        self._stop.set()

    def live_stats(self) -> Dict[str, Any]:
        """Stage occupancy for a polling UI, from any thread: per-source
        decode-ahead, the egress and sink queues, and each carry FIFO's fill
        after the latest step (the reference overlay's per-link gauges,
        app.cpp:1574-1595)."""
        stats: Dict[str, Any] = {
            "steps": self.metrics.steps,
            "sink_busy_seconds": round(self.metrics.sink_busy_seconds, 3),
            "d2h_busy_seconds": round(self.metrics.d2h_busy_seconds, 3),
            "rss_peak_bytes": self.metrics.rss_peak_bytes,
        }
        if self._feeds:
            stats["decode_fill"] = min(
                f.queue.stats.fill_ratio for f in self._feeds.values())
            stats["sources"] = {
                key: {"fill": feed.queue.stats.fill_ratio,
                      "done": feed.queue.eof}
                for key, feed in self._feeds.items()
            }
        for name, q in self._stage_queues.items():
            stats[f"{name}_fill"] = q.stats.fill_ratio
        gauges = self._latest_gauges
        if gauges is not None:
            stats["edges"] = {key: round(v, 4)
                              for key, v in zip(self._gauge_keys, gauges)}
        return stats
