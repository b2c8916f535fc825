"""Command line of the port (a subset of nodey_tpu.app.cli).

Usage:
    python -m nodey_tpu_torch validate project.json
    python -m nodey_tpu_torch run project.json --export out.wav|out.mp3 \
        [--stream] [--preview preview.wav] [--kbps 320] [--device cuda|cpu]
    python -m nodey_tpu_torch run project.json --realtime \
        [--preview preview.wav] [--device cuda|cpu]

``run`` without ``--export`` renders the preview to ``preview.wav``.
``--stream`` exports chunk by chunk through the streaming executor, with
bounded memory. ``--realtime`` (without ``--export``) streams the preview
chunk by chunk at 1.0x: through the SDL audio device where there is one,
else paced by the wall clock, and writes the blocks to the preview WAV.
The default device is ``cuda``; with no card it fails rather than run on
the CPU (pass ``--device cpu`` for that).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from nodey_tpu_torch import __version__
from nodey_tpu_torch.core.errors import NodeyError, ProcessorRuntimeError
from nodey_tpu_torch.core.graph import Graph
from nodey_tpu_torch.core.runner import RunResult, Runner
from nodey_tpu_torch.host import decode as host_decode


def _load_graph(path: str) -> Graph:
    with open(path) as f:
        return Graph.deserialize(json.load(f))


def _report(what: str, result: RunResult) -> None:
    m = result.metrics
    print(
        f"{what}: {m.audio_seconds:.2f} audio-s in {m.wall_seconds:.2f} s "
        f"wall (decode {m.decode_seconds:.2f}s, ingest {m.ingest_seconds:.3f}s, "
        f"render {m.render_seconds:.4f}s by {m.render_clock}, "
        f"encode {m.encode_seconds:.2f}s)"
    )
    for key, spec in result.spectra.items():
        print(f"  spectrum '{key}': shape {list(spec.shape)}")


def cmd_validate(args) -> int:
    graph = _load_graph(args.project)
    graph.check_graph()
    print(
        f"OK: {len(graph.nodes)} nodes, {len(graph.links)} links, "
        f"singletons: {sorted(graph.singleton_node_map)}"
    )
    return 0


def _report_streamed(path: str, runner: Runner, metrics) -> None:
    print(
        f"exported {path} ({metrics.mode}): {metrics.audio_seconds:.2f} "
        f"audio-s in {metrics.wall_seconds:.2f} s wall (RTF "
        f"{metrics.rtf:.1f}x; compile {metrics.compile_seconds:.2f}s)"
    )
    sm = runner.last_stream_metrics
    if sm is not None:
        print(
            f"  stages: {sm.steps} steps, decode wait "
            f"{sm.decode_wait_seconds:.3f}s, egress wait "
            f"{sm.egress_wait_seconds:.3f}s, d2h busy "
            f"{sm.d2h_busy_seconds:.3f}s, sink busy "
            f"{sm.sink_busy_seconds:.3f}s, host RSS peak "
            f"{sm.rss_peak_bytes / 2**20:.0f} MiB"
        )


def _run_realtime(args, graph: Graph) -> int:
    """The streaming preview paced at 1.0x: the blocks go to the SDL audio
    device where one opens (its queue paces them), else the pacer does;
    either way they are written to the preview WAV."""
    import numpy as np

    from nodey_tpu_torch import config as cfg
    from nodey_tpu_torch.core.streaming import StreamingSession
    from nodey_tpu_torch.host import playback

    device = None
    if playback.device_available():
        try:
            device = playback.SdlPlaybackSink()
            print("playing through SDL audio device", file=sys.stderr)
        except NodeyError:
            device = None

    session = StreamingSession(graph, device=args.device).start()
    received = []
    t0 = time.perf_counter()
    try:
        for block in session.blocks(realtime=device is None):
            if device is not None:
                device.write(block)
            received.append(block)
            if len(received) % 32 == 0:
                print(f"  queue fill {session.queue.stats.fill_ratio:5.0%} "
                      f"underruns {session.queue.stats.consumer_waits}",
                      file=sys.stderr)
    finally:
        session.stop()
        if device is not None:
            device.drain()
            device.close()
    wall = time.perf_counter() - t0
    out = args.preview or "preview.wav"
    host_decode.write_wav(out, np.concatenate(received, axis=1),
                          cfg.SAMPLE_RATE)
    stats = session.stats
    print(
        f"streamed {session.duration_seconds:.2f} audio-s in {wall:.2f} s "
        f"wall (compute RTF {stats.rtf_compute:.1f}x, {stats.blocks} "
        f"blocks, {stats.underruns} underruns, first block after "
        f"{stats.first_block_seconds:.3f} s) -> {out}"
    )
    return 0


def _encode_progress():
    """An export's progress callback: ``  encoded N s`` on stderr, at most
    once per second of audio written (the JAX CLI's lines)."""
    last = [0.0]

    def progress(seconds: float) -> None:
        if seconds - last[0] >= 1.0:
            last[0] = seconds
            print(f"  encoded {seconds:8.1f} s", file=sys.stderr)

    return progress


def cmd_run(args) -> int:
    graph = _load_graph(args.project)
    if args.realtime and not args.export:
        return _run_realtime(args, graph)
    runner = Runner(graph, device=args.device)
    if args.export and args.stream:
        _report_streamed(args.export, runner, runner.export_streamed(
            args.export, kbps=args.kbps, progress=_encode_progress()))
    elif args.export:
        _report(f"exported {args.export}",
                runner.export(args.export, kbps=args.kbps,
                              progress=_encode_progress()))
    if args.preview or not args.export:
        result = runner.preview()
        if result.master is None:
            raise ProcessorRuntimeError(
                "Preview produced no audio",
                "The graph has no audio_output node receiving a stream.",
                "preview output missing",
            )
        out = args.preview or "preview.wav"
        host_decode.write_wav(out, result.master, result.rate)
        _report(f"previewed -> {out}", result)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="nodey_tpu_torch")
    parser.add_argument(
        "--version", action="version", version=f"nodey_tpu_torch {__version__}"
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p_run = sub.add_parser("run", help="execute a project graph")
    p_run.add_argument("project")
    p_run.add_argument(
        "--export", help="output path: .wav (lossless) or .mp3 (LAME CBR)"
    )
    p_run.add_argument("--stream", action="store_true",
                       help="pipelined streaming export (bounded memory)")
    p_run.add_argument("--preview", help="preview WAV output path")
    p_run.add_argument("--realtime", action="store_true",
                       help="stream the preview at 1x wall-clock")
    p_run.add_argument("--kbps", type=int, default=320,
                       help="MP3 bitrate (default 320)")
    p_run.add_argument("--device", default="cuda",
                       help="torch device to render on (default cuda)")
    p_run.set_defaults(fn=cmd_run)

    p_val = sub.add_parser("validate", help="validate a project file")
    p_val.add_argument("project")
    p_val.set_defaults(fn=cmd_validate)

    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except ProcessorRuntimeError as exc:
        print(f"error: {exc.message}", file=sys.stderr)
        print(f"  explanation: {exc.explanation}", file=sys.stderr)
        if exc.detail:
            print(f"  detail: {exc.detail}", file=sys.stderr)
        return 1
    except NodeyError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
