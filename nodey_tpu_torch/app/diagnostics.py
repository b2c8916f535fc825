"""Diagnostics: the engine-side data feed of the reference's overlay (port of
nodey_tpu.app.diagnostics).

reference: src/frontend/app.cpp:1493-1600 (FPS/RSS/graph counts/processor
states/per-edge channel fill), re-targeted at what matters on the card
(SURVEY.md §5.1/§5.5): per-run stage timings, RTF, memory, queue occupancy,
per-node device time and torch.profiler traces.

``get_working_set_bytes`` (nodey_tpu/app/diagnostics.py:18), ``graph_counts``
(:31) and ``run_report`` (:41-71) keep the JAX package's keys and rounding;
the report's ``device_s`` is the port's render time (CUDA events on the
card). ``profile_node_times`` (:73-166) times each node's lowering directly:
the port renders eagerly, so one render after a warm-up brackets every node
with CUDA events on the card (the host clock on the CPU), where the JAX
package compiles a prefix program per node. ``maybe_trace`` (:168) is a
torch.profiler context (CUDA activity on the card) that writes a Chrome
trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, Optional

import torch

from nodey_tpu_torch.core.graph import Graph
from nodey_tpu_torch.core.runner import RunMetrics


def get_working_set_bytes() -> int:
    """Process RSS (reference: src/utility/system.cpp:12-44 reads
    /proc/self/status VmRSS the same way)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


def graph_counts(graph: Graph) -> Dict[str, int]:
    """Node/pin/link tallies (reference overlay: app.cpp:1535-1542)."""
    return {
        "nodes": len(graph.nodes),
        "pins": len(graph.pins),
        "links": len(graph.links),
        "singletons": len(graph.singleton_node_map),
    }


def run_report(
    graph: Graph,
    metrics: RunMetrics,
    queue_stats: Optional[Any] = None,
) -> Dict[str, Any]:
    """One run's diagnostics dict — the metrics set SURVEY.md §5.5 calls
    for: audio-seconds, wall, RTF, per-stage split, memory, occupancy."""
    report: Dict[str, Any] = {
        "graph": graph_counts(graph),
        "audio_seconds": round(metrics.audio_seconds, 3),
        "wall_seconds": round(metrics.wall_seconds, 4),
        "rtf": round(metrics.rtf, 1),
        "stages": {
            "decode_s": round(metrics.decode_seconds, 4),
            "compile_s": round(metrics.compile_seconds, 4),
            "device_s": round(metrics.render_seconds, 4),
            "encode_s": round(metrics.encode_seconds, 4),
        },
        "rss_bytes": get_working_set_bytes(),
    }
    if queue_stats is not None:
        report["egress_queue"] = {
            "capacity": queue_stats.capacity,
            "fill_ratio": round(queue_stats.fill_ratio, 3),
            "pushed": queue_stats.pushed,
            "popped": queue_stats.popped,
            "producer_waits": queue_stats.producer_waits,
            "consumer_waits": queue_stats.consumer_waits,
        }
    return report


def profile_node_times(
    runner, mode: str = "export", iters: int = 3
) -> Dict[int, Dict[str, Any]]:
    """Per-NODE device time of one render on the runner's device (SURVEY.md
    §5.5 'per-node kernel time'; the overlay's per-processor tallies,
    reference app.cpp:1556-1568, re-targeted at kernel cost).

    The graph is decoded, compiled and ingested once, rendered once to warm
    up, then ``iters`` times with a mark after every node's lowering: a
    CUDA event on the card (read after the render, so the marks add no
    sync), the host clock on the CPU (eager CPU ops finish before they
    return). Node k's time is the span between its mark and the previous
    one, the least over the renders. Opt-in diagnosis (`cli run
    --profile-nodes`), not a hot path. Returns ``{node id: {identifier,
    device_s, cumulative_s}}`` in topological order, as the JAX package's
    prefix-program profile does."""
    graph = runner.graph
    device = runner.device
    graph.check_graph()
    arrays, lengths, sources = runner.decode()
    compiled = runner.compile(sources, mode)
    args = runner.ingest(arrays, lengths)
    order = compiled.order
    on_card = device.type == "cuda"

    def mark():
        if not on_card:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def render():
        marks = [mark()]
        compiled(args, on_node=lambda nid: marks.append(mark()))
        if not on_card:
            return [b - a for a, b in zip(marks, marks[1:])]
        marks[-1].synchronize()
        return [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])]

    context = torch.cuda.device(device) if on_card else contextlib.nullcontext()
    with context:
        render()
        spans = [render() for _ in range(max(1, iters))]
    report: Dict[int, Dict[str, Any]] = {}
    cumulative = 0.0
    for k, nid in enumerate(order):
        own = min(times[k] for times in spans)
        cumulative += own
        report[nid] = {
            "identifier": graph.nodes[nid].processor.info().identifier,
            "device_s": round(own, 6),
            "cumulative_s": round(cumulative, 6),
        }
    return report


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str], device: torch.device | str = "cuda"):
    """A torch.profiler trace of the block when a directory is given, with
    CUDA activity when ``device`` is a card; the Chrome trace is written to
    ``<trace_dir>/trace-<time>-<pid>.json`` when the block ends. Nothing
    without a directory."""
    if not trace_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda" and torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        trace_dir,
        f"trace-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}.json"))
