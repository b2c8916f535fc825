"""Command line of the port (port of nodey_tpu.app.cli).

Usage:
    python -m nodey_tpu_torch validate project.json
    python -m nodey_tpu_torch run project.json --export out.wav|out.mp3 \
        [--stream] [--preview preview.wav] [--kbps 320] [--device cuda|cpu] \
        [--diagnostics] [--profile-nodes] [--trace DIR] [--swr-compat]
    python -m nodey_tpu_torch run project.json --realtime \
        [--preview preview.wav] [--device cuda|cpu] [--diagnostics]
    python -m nodey_tpu_torch serve [project.json] [--host 127.0.0.1] \
        [--port 8787] [--fs-root DIR] [--device cuda|cpu]
    python -m nodey_tpu_torch edit project.json \
        add-node|remove-node|link|unlink|set|show ...
    python -m nodey_tpu_torch new project.json
    python -m nodey_tpu_torch help [identifier]
    python -m nodey_tpu_torch browse [path]
    python -m nodey_tpu_torch doctor [--device cuda|cpu]

``run`` without ``--export`` renders the preview to ``preview.wav``.
``--stream`` exports chunk by chunk through the streaming executor, with
bounded memory. ``--realtime`` (without ``--export``) streams the preview
chunk by chunk at 1.0x: through the SDL audio device where there is one,
else paced by the wall clock, and writes the blocks to the preview WAV.
``--diagnostics`` prints the run's report (JSON), ``--profile-nodes`` each
node's device time in one more render, ``--trace DIR`` a torch.profiler
Chrome trace of the run. ``--swr-compat`` resamples with the measured
libswresample banks (``NODEY_RESAMPLE_COMPAT=swr``); it needs the codec
runtime and fails where that does not load. ``serve`` starts the web editor (the page, its
JSON API and the live preview; every request carries the printed token).
The default device is ``cuda``; with no card ``run``, ``serve`` and
``doctor`` fail rather than run on the CPU (pass ``--device cpu`` for that).

The commands are the JAX package's (nodey_tpu/app/cli.py: ``browse`` :34,
``doctor`` :88, ``help`` :218, ``serve`` :258, ``edit`` :513-585 with its
helpers :462-512, ``new`` :586, ``run``'s diagnostics :375-379 and
:428-440). ``doctor`` reports the host, the codec runtime, the kernels'
build and one timed launch of a hand-written kernel held against its plain
version on the card; the JAX package's compile cache, relay and wedge checks
have nothing to check here.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from nodey_tpu_torch import __version__
from nodey_tpu_torch.core import registry
from nodey_tpu_torch.core.errors import NodeyError, ProcessorRuntimeError
from nodey_tpu_torch.core.graph import Graph
from nodey_tpu_torch.core.runner import RunMetrics, RunResult, Runner
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


def cmd_browse(args) -> int:
    """Interactive terminal file picker (the CLI face of the reference's
    native dialogs, dialog-utility.cpp:15-92; the web editor has the
    richer server-backed one). Navigates with numbered choices and prints
    the selected path on stdout (pipe into other commands or shells)."""
    path = os.path.abspath(args.path or os.getcwd())
    while True:
        entries = [
            e for e in sorted(os.listdir(path)) if not e.startswith(".")
        ]
        print(f"\n{path}", file=sys.stderr)
        print("  0) ..", file=sys.stderr)
        for i, name in enumerate(entries, start=1):
            full = os.path.join(path, name)
            tag = "/" if os.path.isdir(full) else ""
            print(f"  {i}) {name}{tag}", file=sys.stderr)
        try:
            print("select (number, or q): ", end="", file=sys.stderr,
                  flush=True)
            choice = input().strip()
        except EOFError:
            return 1
        if choice in ("q", "Q", ""):
            return 1
        try:
            idx = int(choice)
        except ValueError:
            continue
        if idx == 0:
            path = os.path.dirname(path) or path
            continue
        if not 1 <= idx <= len(entries):
            continue
        full = os.path.join(path, entries[idx - 1])
        if os.path.isdir(full):
            path = full
        else:
            print(full)
            return 0


def cmd_validate(args) -> int:
    graph = _load_graph(args.project)
    graph.check_graph()
    print(
        f"OK: {len(graph.nodes)} nodes, {len(graph.links)} links, "
        f"singletons: {sorted(graph.singleton_node_map)}"
    )
    return 0


def _kernel_probe(device) -> dict:
    """Build the polyphase resampler's library and launch it once on a
    small stereo clip (44.1 -> 48 kHz) on ``device``, against its plain
    version on the same operands; times by CUDA events."""
    import numpy as np
    import torch

    from nodey_tpu_torch.ops import _build, cuda_resample
    from nodey_tpu_torch.ops import resample as tr

    t0 = time.perf_counter()
    _build.load_library("polyphase_resample")
    built_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    data = torch.from_numpy(
        (0.5 * rng.standard_normal((2, 44_100))).astype(np.float32)).to(device)
    x, G, M, W, bank, support = tr.bank_operands(data, 44_100, 48_000)
    cuda_resample.apply_filter_bank_cuda(x, G, M, W, support)  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    got = cuda_resample.apply_filter_bank_cuda(x, G, M, W, support)
    end.record()
    end.synchronize()
    want = tr.apply_filter_bank_plain(x, G, M, W, bank)
    return {"built_s": built_s, "ms": start.elapsed_time(end),
            "shape": list(got.shape),
            "err": (got - want).abs().max().item()}


def cmd_doctor(args) -> int:
    """Environment/health report: the host, the native codec runtime, the
    kernels' build and the device. On a card it builds one hand-written
    kernel, launches it on a small clip against its plain version, and
    reads the card's name and power limit. Exit code 0 when healthy, 3
    when the device is unavailable or its probe fails."""
    import ctypes.util
    import platform
    import subprocess

    import numpy
    import torch

    from nodey_tpu_torch.core.compiler import resolve_device
    from nodey_tpu_torch.host import native_lib
    from nodey_tpu_torch.ops import _build

    def row(k: str, v) -> None:
        print(f"  {k:<22} {v}")

    print("nodey_tpu_torch doctor")
    print("host:")
    row("python", platform.python_version())
    row("torch", f"{torch.__version__} (CUDA build "
        f"{torch.version.cuda or 'none'})")
    row("numpy", numpy.__version__)
    try:
        cpus = len(os.sched_getaffinity(0))
    except AttributeError:
        cpus = os.cpu_count() or 1
    row("cpus", cpus)

    print("native host runtime:")
    try:
        lib = native_lib.load()
        failed = native_lib._build_failed
    except OSError as exc:
        lib, failed = None, str(exc)
    row("libnodey_host", "ok" if lib is not None else
        f"UNAVAILABLE ({failed})")
    for name in ("mp3lame", "SDL2"):
        row(f"lib{name}", ctypes.util.find_library(name) or "not found")

    print("kernels:")
    names = _build.kernel_names()
    row("build dir", _build.library_path(names[0]).parent)
    for name in names:
        row(name, "built" if _build.library_path(name).exists()
            else "not built (builds at first use)")

    print("device:")
    try:
        device = resolve_device(args.device)
    except ProcessorRuntimeError as exc:
        row("device", f"UNAVAILABLE ({exc.message}: {exc.explanation})")
        return 3
    if device.type != "cuda":
        row("device", f"{device} (the kernel wrappers run their plain "
            "versions)")
        return 0
    row("device", f"{device}: {torch.cuda.get_device_name(device)}")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        card = (smi.stdout.strip().splitlines() or ["?"])[device.index or 0]
    except (OSError, subprocess.SubprocessError) as exc:
        card = f"not read ({exc})"
    row("name, power limit", card)
    try:
        probe = _kernel_probe(device)
    except Exception as exc:
        row("kernel probe", f"FAILED ({type(exc).__name__}: "
            f"{str(exc)[:200]})")
        return 3
    row("polyphase_resample", f"{probe['shape']} in {probe['ms']:.4f} ms "
        f"(library ready in {probe['built_s']:.2f} s); max|kernel - plain| "
        f"{probe['err']:.3e} (tol 2e-06)")
    if not probe["err"] <= 2e-6:
        row("health", "KERNEL DISAGREES with its plain version")
        return 3
    row("health", "ok")
    return 0


def cmd_help(args) -> int:
    """Help/About surface (reference: src/frontend/help.cpp:5-132 —
    markdown node manual + about box), headless: prints the registered
    nodes' markdown descriptions, or one node's full manual."""
    registry.register_all_processors()
    processor_map = registry.processor_map

    if args.identifier:
        info = processor_map.get(args.identifier)
        if info is None:
            print(f"unknown node '{args.identifier}'; known: "
                  f"{', '.join(sorted(processor_map))}", file=sys.stderr)
            return 1
        print(f"# {info.display_name} ({info.identifier})")
        if info.singleton:
            print("*singleton — at most one per project*")
        print()
        print(info.description.strip())
        proc = info.generate()
        pins = proc.pin_attributes()
        print("\n## Pins")
        for p in pins:
            kind = "in " if p.is_input else "out"
            print(f"- [{kind}] {p.identifier} ({p.display_name})")
        return 0

    print(f"nodey_tpu_torch {__version__} — node-graph audio engine on "
          "PyTorch, hand-written CUDA kernels on the H100")
    print("project files are JSON graphs compatible with the reference "
          "editor's format.\n")
    print("## Nodes")
    for ident in sorted(processor_map):
        info = processor_map[ident]
        first_line = info.description.strip().splitlines()[0]
        tag = " (singleton)" if info.singleton else ""
        print(f"- {ident}: {first_line}{tag}")
    print("\nUse `help <identifier>` for a node's full manual.")
    return 0


def cmd_serve(args) -> int:
    """Interactive web editor (reference editor's engine-honest slice:
    imnodes canvas + mutations + diagnostics overlay, app.cpp:1493-1901),
    rendering on ``--device``."""
    from nodey_tpu_torch.app import server as web_server

    if args.project:
        graph = _load_graph(args.project)
        title = args.project
    else:
        # No project: start on an empty canvas (the reference opens with
        # a new project too; save takes a path via /api/save).
        registry.register_all_processors()
        graph = Graph()
        title = "(new project)"
    srv = web_server.serve(
        graph, title, args.host, args.port,
        project_path=args.project or None,
        fs_root=args.fs_root, device=args.device,
    )
    token = srv.viewer.auth_token
    port = srv.server_address[1]
    print(f"serving {title} on {srv.viewer.device} at "
          f"http://{args.host}:{port}/?token={token}")
    print(f"  API auth: X-Nodey-Token: {token}", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.viewer.stop_preview()
        srv.server_close()
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
    from nodey_tpu_torch.app import diagnostics
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
    if args.diagnostics:
        metrics = RunMetrics(audio_seconds=session.duration_seconds,
                             wall_seconds=wall)
        print(json.dumps(diagnostics.run_report(
            graph, metrics, queue_stats=session.queue.stats), indent=1))
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
    from nodey_tpu_torch.app import diagnostics

    if args.swr_compat:
        # Read wherever a resampler's bank is chosen (resample.
        # resolve_compat), so setting it before any render covers all.
        os.environ["NODEY_RESAMPLE_COMPAT"] = "swr"
    graph = _load_graph(args.project)
    with diagnostics.maybe_trace(args.trace, args.device):
        if args.realtime and not args.export:
            return _run_realtime(args, graph)
        return _run_inner(args, graph, diagnostics)


def _run_inner(args, graph: Graph, diagnostics) -> int:
    runner = Runner(graph, device=args.device)
    if args.export:
        if args.stream:
            metrics = runner.export_streamed(
                args.export, kbps=args.kbps, progress=_encode_progress())
            _report_streamed(args.export, runner, metrics)
        else:
            result = runner.export(args.export, kbps=args.kbps,
                                   progress=_encode_progress())
            metrics = result.metrics
            _report(f"exported {args.export}", result)
        if args.diagnostics:
            print(json.dumps(diagnostics.run_report(graph, metrics),
                             indent=1))
        if args.profile_nodes:
            print(json.dumps(diagnostics.profile_node_times(runner),
                             indent=1))
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


def _parse_param_value(value: str):
    """JSON value when parseable, else the raw string (so
    ``--param file_path='["a.wav"]'`` and ``--param export_path=/x`` both
    work)."""
    try:
        return json.loads(value)
    except json.JSONDecodeError:
        return value


def _apply_params(proc, params) -> dict:
    """Apply key=value params to a processor through the session's
    ``apply_params`` (a ``set_<key>`` setter wins; other keys merge through
    the serde). Raises NodeyError for keys neither settable nor
    serializable."""
    from nodey_tpu_torch.app.session import apply_params

    parsed = {}
    for kv in params:
        key, _, value = kv.partition("=")
        parsed[key] = _parse_param_value(value)
    return apply_params(proc, parsed)


def _save_graph(graph: Graph, path: str) -> None:
    with open(path, "w") as f:
        json.dump(graph.serialize(), f, indent=1)


def _resolve_pin(graph: Graph, spec: str):
    """'<node_id>.<pin_name>' -> pin id."""
    node_str, _, pin_name = spec.partition(".")
    try:
        node_id = int(node_str)
    except ValueError:
        raise NodeyError(f"bad pin spec '{spec}' (want <node>.<pin>)") from None
    node = graph.nodes.get(node_id)
    if node is None:
        raise NodeyError(f"no node {node_id}")
    pin = node.pin_name_map.get(pin_name)
    if pin is None:
        raise NodeyError(
            f"node {node_id} has no pin '{pin_name}' "
            f"(has: {sorted(node.pin_name_map)})"
        )
    return pin


def cmd_edit(args) -> int:
    """Headless graph editing — the engine-level equivalents of the
    reference editor's mutations (add node from registry, validated link
    creation with rollback, app.cpp:1700-1839)."""
    graph = _load_graph(args.project)

    if args.edit_command == "add-node":
        info = registry.processor_map.get(args.identifier)
        if info is None:
            print(
                f"error: unknown identifier '{args.identifier}' "
                f"(have: {sorted(registry.processor_map)})",
                file=sys.stderr,
            )
            return 1
        proc = info.generate()
        if args.param:
            _apply_params(proc, args.param)
        nid = graph.add_node(proc)
        if args.pos:
            x, _, y = args.pos.partition(",")
            graph.nodes[nid].position = (float(x), float(y))
        print(f"added node {nid} ({args.identifier})")
    elif args.edit_command == "remove-node":
        if args.node_id not in graph.nodes:
            print(f"error: no node {args.node_id}", file=sys.stderr)
            return 1
        graph.remove_node(args.node_id)
        print(f"removed node {args.node_id}")
    elif args.edit_command == "link":
        from_pin = _resolve_pin(graph, args.from_pin)
        to_pin = _resolve_pin(graph, args.to_pin)
        link_id = graph.add_link(from_pin, to_pin)
        try:
            # Validate-and-rollback, exactly the app's link flow
            # (app.cpp:1826-1839).
            graph.check_graph()
        except NodeyError as exc:
            graph.remove_link(link_id)
            print(f"error: link rejected: {exc}", file=sys.stderr)
            return 1
        print(f"linked {args.from_pin} -> {args.to_pin}")
    elif args.edit_command == "unlink":
        from_pin = _resolve_pin(graph, args.from_pin)
        to_pin = _resolve_pin(graph, args.to_pin)
        graph.remove_link_between(from_pin, to_pin)
        print(f"unlinked {args.from_pin} -> {args.to_pin}")
    elif args.edit_command == "set":
        node = graph.nodes.get(args.node_id)
        if node is None:
            print(f"error: no node {args.node_id}", file=sys.stderr)
            return 1
        applied = _apply_params(node.processor, args.param)
        graph.update_node_pin(args.node_id)  # arity may have changed
        print(f"updated node {args.node_id}: {applied}")
    elif args.edit_command == "show":
        for nid, node in sorted(graph.nodes.items()):
            info = node.processor.info()
            print(f"node {nid}: {info.identifier} "
                  f"pins={sorted(node.pin_name_map)} "
                  f"info={node.processor.serialize()}")
        for lid, link in sorted(graph.links.items()):
            fp, tp = graph.pins[link.from_pin], graph.pins[link.to_pin]
            print(
                f"link {lid}: {fp.parent}.{fp.attribute.identifier} -> "
                f"{tp.parent}.{tp.attribute.identifier}"
            )
        return 0

    _save_graph(graph, args.project)
    return 0


def cmd_new(args) -> int:
    registry.register_all_processors()
    _save_graph(Graph(), args.project)
    print(f"created empty project {args.project}")
    return 0


def _add_device_arg(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda; no card "
                        "is an error, not a fallback to the CPU)")


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
    p_run.add_argument("--diagnostics", action="store_true",
                       help="print the run diagnostics report (JSON)")
    p_run.add_argument("--trace",
                       help="write a torch.profiler Chrome trace here")
    p_run.add_argument("--profile-nodes", action="store_true",
                       help="report each node's device time (one more "
                            "render, a CUDA event after every node)")
    p_run.add_argument("--swr-compat", action="store_true",
                       help="resample with measured libswresample-"
                            "equivalent filter banks (needs the codec "
                            "runtime); NODEY_RESAMPLE_COMPAT=swr")
    _add_device_arg(p_run)
    p_run.set_defaults(fn=cmd_run)

    p_help = sub.add_parser(
        "help", help="node manual / about (markdown descriptions)"
    )
    p_help.add_argument("identifier", nargs="?", default=None)
    p_help.set_defaults(fn=cmd_help)

    p_srv = sub.add_parser(
        "serve", help="web editor: graph canvas, live run state, preview, "
                      "export"
    )
    p_srv.add_argument(
        "project", nargs="?", default=None,
        help="project file; omit to start on an empty canvas",
    )
    p_srv.add_argument("--host", default="127.0.0.1")
    p_srv.add_argument("--port", type=int, default=8787,
                       help="TCP port (default 8787; 0 picks a free one)")
    p_srv.add_argument(
        "--fs-root", default=None, dest="fs_root",
        help="confine the in-editor file browser to this directory",
    )
    _add_device_arg(p_srv)
    p_srv.set_defaults(fn=cmd_serve)

    p_browse = sub.add_parser(
        "browse", help="interactive file picker; prints the chosen path"
    )
    p_browse.add_argument("path", nargs="?", default=None)
    p_browse.set_defaults(fn=cmd_browse)

    p_doc = sub.add_parser(
        "doctor", help="environment, kernel and device health report"
    )
    _add_device_arg(p_doc)
    p_doc.set_defaults(fn=cmd_doctor)

    p_val = sub.add_parser("validate", help="validate a project file")
    p_val.add_argument("project")
    p_val.set_defaults(fn=cmd_validate)

    p_new = sub.add_parser("new", help="create an empty project")
    p_new.add_argument("project")
    p_new.set_defaults(fn=cmd_new)

    p_edit = sub.add_parser("edit", help="edit a project graph")
    p_edit.add_argument("project")
    esub = p_edit.add_subparsers(dest="edit_command", required=True)
    e_add = esub.add_parser("add-node")
    e_add.add_argument("identifier")
    e_add.add_argument("--pos", help="x,y editor position")
    e_add.add_argument("--param", action="append", default=[],
                       help="key=json_value (repeatable)")
    e_rm = esub.add_parser("remove-node")
    e_rm.add_argument("node_id", type=int)
    e_link = esub.add_parser("link")
    e_link.add_argument("from_pin", help="<node>.<pin>")
    e_link.add_argument("to_pin", help="<node>.<pin>")
    e_unlink = esub.add_parser("unlink")
    e_unlink.add_argument("from_pin")
    e_unlink.add_argument("to_pin")
    e_set = esub.add_parser("set")
    e_set.add_argument("node_id", type=int)
    e_set.add_argument("param", nargs="+", help="key=json_value")
    esub.add_parser("show")
    p_edit.set_defaults(fn=cmd_edit)

    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except ProcessorRuntimeError as exc:
        # The reference surfaces the three-part error in a popup
        # (app.cpp:2097-2122); the CLI prints the same structure.
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
