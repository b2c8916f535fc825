"""The Runner: decode -> ingest -> render -> sink (port of
nodey_tpu.core.runner: the offline paths and the streamed export).

``Runner(graph, device=...)`` binds the graph to one device. A CUDA device
without a card raises; nothing falls back to the CPU. On the card the
render is timed with CUDA events; on the CPU with the host clock, and the
metrics say which (``render_clock``). ``export`` copies the master to the
host block by block while the sink encodes, and reports each block to
``progress``. ``export_streamed`` runs the graph chunk by chunk through the
streaming executor on the same device, and falls back to ``export`` for a
graph that cannot stream. ``stop()`` cancels any of them: the call raises
``RunCancelled``, leaves no partial file, and the runner is READY again
(``state``, as the JAX package's ``RunnerState``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from nodey_tpu_torch import config as cfg
from nodey_tpu_torch.core.errors import (ProcessorRuntimeError, RunCancelled,
                                         UnstreamableGraphError)
from nodey_tpu_torch.core.graph import Graph
from nodey_tpu_torch.core import compiler
from nodey_tpu_torch.core.stream import FMT_S16
from nodey_tpu_torch.host import decode as host_decode
from nodey_tpu_torch.host import encode as host_encode


class RunnerState(enum.Enum):
    """reference: include/infra/runner.hpp:25-31."""

    READY = "ready"
    RUNNING = "running"
    FINISHED = "finished"
    ERROR = "error"


@dataclasses.dataclass
class RunMetrics:
    audio_seconds: float = 0.0
    wall_seconds: float = 0.0
    decode_seconds: float = 0.0
    ingest_seconds: float = 0.0
    render_seconds: float = 0.0
    # "cuda_events" on the card, "host" on the CPU.
    render_clock: str = "host"
    encode_seconds: float = 0.0
    # "offline", or "streamed" for export_streamed (whose full stage
    # metrics are Runner.last_stream_metrics).
    mode: str = "offline"
    compile_seconds: float = 0.0
    rss_peak_bytes: int = 0

    @property
    def rtf(self) -> float:
        return self.audio_seconds / self.wall_seconds if self.wall_seconds else 0.0


@dataclasses.dataclass
class RunResult:
    master: Optional[np.ndarray]  # [channels, n] float32, valid length only
    rate: int
    fmt: str
    spectra: Dict[str, np.ndarray]
    metrics: RunMetrics
    # The master left on the device (render with fetch=False), for the
    # export's block egress, and its valid length.
    device_master: Optional[torch.Tensor] = None
    master_length: int = 0


def _bucket(n: int, quantum: int) -> int:
    """Round a clip length up to the padding quantum (the JAX package's
    recompile bucketing; kept so capacities, and the spectrum's frame
    count, match it)."""
    return max(quantum, -(-n // quantum) * quantum)


class Runner:
    """Runs a validated graph in export or preview mode on one device."""

    def __init__(self, graph: Graph, device: torch.device | str = "cuda"):
        self.graph = graph
        self.device = compiler.resolve_device(device)
        self.state = RunnerState.READY
        self.error: Optional[BaseException] = None
        # Cooperative cancellation of every run path: checked between the
        # offline stages (decode, compile, render), per block in export()'s
        # encode loop, and in the streaming executor's loops.
        self._stop_event = threading.Event()
        # Set while export_streamed falls back to export(), so a stop()
        # issued before the fallback stays visible to it.
        self._nested_export = False
        self._active_executor = None
        self.last_stream_metrics = None

    def _check_cancel(self, where: str) -> None:
        if self._stop_event.is_set():
            raise RunCancelled(where)

    @staticmethod
    def _remove_partial(path: str) -> None:
        """Delete the truncated output of a cancelled export."""
        with contextlib.suppress(OSError):
            os.remove(path)

    def decode(self):
        """Decode every audio_input slot on the host, files in parallel.
        s16 sources are kept as int16 (round(x*32768) inverts the decoder's
        s/32768 exactly) and dequantized on the device; returns
        ``(arrays, lengths, sources)`` padded to the bucketed capacity."""
        arrays: Dict[str, np.ndarray] = {}
        lengths: Dict[str, int] = {}
        sources: Dict[Tuple[int, str], compiler.SourceSpec] = {}
        slots = [
            (nid, i, path)
            for nid, node in self.graph.nodes.items()
            if node.processor.info().identifier == cfg.AUDIO_INPUT_NODE_NAME
            for i, path in enumerate(node.processor.file_paths)
        ]
        if not slots:
            return arrays, lengths, sources
        with ThreadPoolExecutor(max_workers=min(8, len(slots))) as pool:
            decoded_all = list(
                pool.map(lambda s: host_decode.decode_file(s[2]), slots)
            )
        for (nid, i, _), decoded in zip(slots, decoded_all):
            n = decoded.num_samples
            capacity = _bucket(n, cfg.DEFAULT_EXEC.pad_quantum)
            if decoded.fmt == FMT_S16:
                padded = np.zeros((decoded.channels, capacity), dtype=np.int16)
                padded[:, :n] = np.clip(
                    np.round(decoded.data * 32768.0), -32768, 32767
                ).astype(np.int16)
            else:
                padded = np.zeros((decoded.channels, capacity), dtype=np.float32)
                padded[:, :n] = decoded.data
            key = compiler.external_key(nid, f"output_{i}")
            arrays[key] = padded
            lengths[key] = n
            sources[(nid, f"output_{i}")] = compiler.SourceSpec(
                rate=decoded.rate,
                channels=decoded.channels,
                fmt=decoded.fmt,
                capacity=capacity,
                t0_us=float(decoded.pts0_us),
            )
        return arrays, lengths, sources

    def ingest(self, arrays: Dict[str, np.ndarray],
               lengths: Dict[str, int]) -> Dict[str, Tuple[torch.Tensor, int]]:
        """Copy the decoded inputs to the device."""
        return {
            key: (torch.from_numpy(arrays[key]).to(self.device), lengths[key])
            for key in arrays
        }

    def compile(self, sources, mode: str) -> compiler.CompiledGraph:
        return compiler.compile_graph(self.graph, sources, mode, self.device)

    def render(self, mode: str = "export", fetch: bool = True,
               _nested: bool = False) -> RunResult:
        """Run the graph once; returns the master (native rate for export,
        clamped 48 kHz stereo for preview) and the spectra, on the host.
        ``fetch=False`` leaves the master on the device
        (``RunResult.device_master``) for the caller to copy out.

        ``stop()`` is honoured between the stages: after decode, after
        compile and after the device render. ``_nested`` keeps a stop set
        during an enclosing export visible to this call."""
        if not _nested:
            self._stop_event.clear()
        self.state = RunnerState.RUNNING
        self.error = None
        try:
            result = self._render(mode, fetch)
        except RunCancelled:
            # Not an error: the reference tears the run down and returns to
            # editing (app.cpp:1949-1957).
            self.state = RunnerState.READY
            raise
        except BaseException as exc:
            self.state = RunnerState.ERROR
            self.error = exc
            raise
        self.state = RunnerState.FINISHED
        return result

    def _render(self, mode: str, fetch: bool) -> RunResult:
        metrics = RunMetrics()
        wall0 = time.perf_counter()
        t0 = wall0
        arrays, lengths, sources = self.decode()
        metrics.decode_seconds = time.perf_counter() - t0
        self._check_cancel("after decode")

        compiled = self.compile(sources, mode)
        self._check_cancel("after compile")
        t0 = time.perf_counter()
        args = self.ingest(arrays, lengths)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        metrics.ingest_seconds = time.perf_counter() - t0

        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            outputs, meta = compiled(args)
            end.record()
            end.synchronize()
            metrics.render_seconds = start.elapsed_time(end) / 1e3
            metrics.render_clock = "cuda_events"
        else:
            t0 = time.perf_counter()
            outputs, meta = compiled(args)
            metrics.render_seconds = time.perf_counter() - t0
        self._check_cancel("after device dispatch")

        master_key = "master" if mode == "export" else "preview"
        master = device_master = None
        length = 0
        rate = cfg.SAMPLE_RATE
        fmt = "flt"
        if master_key in outputs:
            data, length = outputs[master_key]
            if fetch:
                master = data[:, :length].cpu().numpy()
            else:
                device_master = data
            rate = meta[master_key]["rate"]
            fmt = meta[master_key]["fmt"]
            metrics.audio_seconds = length / rate
        spectra = {
            key: outputs[key].cpu().numpy()
            for key, m in meta.items() if m["kind"] == "array"
        }
        metrics.wall_seconds = time.perf_counter() - wall0
        return RunResult(master=master, rate=rate, fmt=fmt, spectra=spectra,
                         metrics=metrics, device_master=device_master,
                         master_length=length)

    def export(self, path: str, kbps: int = 320,
               progress: Optional[Callable[[float], None]] = None,
               block_seconds: float = 4.0) -> RunResult:
        """Render and encode: ``.wav`` to the lossless WavWriter, else MP3
        (reference: do_export, audio-io.cpp:640-844).

        The master stays on the device; a producer thread copies it to the
        host in blocks of ``block_seconds`` through a bounded queue while
        the sink encodes (``streaming.start_block_egress``). After each
        block ``progress`` gets the audio seconds written so far. A
        ``stop()`` is checked before each block: the call raises
        ``RunCancelled`` and removes the partial file. The returned result
        holds no host master (its blocks went to the sink)."""
        from nodey_tpu_torch.core.streaming import start_block_egress
        from nodey_tpu_torch.host.streamio import BoundedBlockQueue

        if not self._nested_export:
            self._stop_event.clear()
        result = self.render(mode="export", fetch=False, _nested=True)
        if result.device_master is None:
            raise ProcessorRuntimeError(
                "Export produced no audio",
                "The graph has no audio_output node receiving a stream.",
                "master output missing",
            )
        t0 = time.perf_counter()
        channels = result.device_master.shape[0]
        queue = BoundedBlockQueue()
        stop = threading.Event()
        producer_errors: list = []
        thread = start_block_egress(
            result.device_master, result.master_length,
            max(1, int(block_seconds * result.rate)), queue, stop,
            producer_errors)
        result.device_master = None
        self.state = RunnerState.RUNNING
        try:
            written = 0
            with host_encode.open_sink(path, result.rate, channels, kbps,
                                       result.fmt) as enc:
                while True:
                    # The encode loop is an offline export's long pole: the
                    # reference checks its stop token there too
                    # (audio-io.cpp:173).
                    self._check_cancel("export encode loop")
                    block = queue.pop(stop=stop)
                    if block is None:
                        break
                    enc.write(block)
                    written += block.shape[1]
                    if progress is not None:
                        progress(written / result.rate)
            if producer_errors:
                raise producer_errors[0]
        except RunCancelled:
            stop.set()
            self.state = RunnerState.READY
            self._remove_partial(path)
            raise
        except BaseException as exc:
            stop.set()
            self.state = RunnerState.ERROR
            self.error = exc
            raise
        finally:
            stop.set()
            thread.join(timeout=10.0)
        self.state = RunnerState.FINISHED
        result.metrics.encode_seconds = time.perf_counter() - t0
        result.metrics.wall_seconds += result.metrics.encode_seconds
        return result

    def preview(self) -> RunResult:
        """Offline preview render: clamped 48 kHz stereo master."""
        return self.render(mode="preview")

    def stop(self) -> None:
        """Cancel the run in flight: an offline render (between stages),
        an export (per block) or a streamed export (per chunk), as the
        reference's stop tokens (src/infra/runner.cpp:53-63). The call
        raises :class:`RunCancelled`, leaves no partial file, and the
        runner returns to READY."""
        self._stop_event.set()
        executor = self._active_executor
        if executor is not None:
            executor.stop()

    def export_streamed(
        self,
        path: str,
        kbps: int = 320,
        progress: Optional[Callable[[float], None]] = None,
        chunk_seconds: float = 16.0,
    ) -> RunMetrics:
        """Pipelined export, decode ∥ chunk step ∥ d2h ∥ encode, with
        bounded host and device memory (the reference's streaming export,
        audio-io.cpp:86-226 and 640-844), through the streaming executor on
        this runner's device. 16 s chunks, as the JAX package exports.

        A graph that cannot stream in lockstep (mixer branches at different
        tempos) falls back to the offline export on the same device, as in
        the JAX package: the reference's behaviour for such a graph."""
        from nodey_tpu_torch.core.stream_executor import StreamExecutor

        self._stop_event.clear()
        self.state = RunnerState.RUNNING
        self.error = None
        executor = StreamExecutor(
            self.graph, mode="export", chunk_seconds=chunk_seconds,
            master_wire="s16", collect_frames=False, device=self.device,
        )
        self._active_executor = executor
        sinks = []

        def sink(block: np.ndarray) -> None:
            if not sinks:
                # Opened on the first block: the executor publishes the
                # master's format after its plan pass.
                meta = executor.master_meta
                sinks.append(host_encode.open_sink(
                    path, meta["rate"], meta["channels"], kbps, meta["fmt"]))
            sinks[0].write(block)

        try:
            try:
                sm = executor.run(sink, progress=progress)
                # A stop() mid-run drains early with a truncated output.
                self._check_cancel("streamed export")
            finally:
                self._active_executor = None
                if sinks:
                    sinks[0].close()
        except UnstreamableGraphError:
            # Raised by the plan pass, before any output exists. The
            # offline export reports progress and honours a stop() issued
            # before it (_nested_export).
            self.last_stream_metrics = None
            self._nested_export = True
            try:
                return self.export(path, kbps=kbps, progress=progress).metrics
            finally:
                self._nested_export = False
        except RunCancelled:
            self.state = RunnerState.READY
            self._remove_partial(path)
            raise
        except BaseException as exc:
            self.state = RunnerState.ERROR
            self.error = exc
            raise
        self.state = RunnerState.FINISHED
        self.last_stream_metrics = sm
        return RunMetrics(
            audio_seconds=sm.audio_seconds, wall_seconds=sm.wall_seconds,
            mode="streamed", compile_seconds=sm.compile_seconds,
            rss_peak_bytes=sm.rss_peak_bytes,
        )
