"""The port's app layer (``nodey_tpu_torch.app``: settings, notifications,
session, diagnostics, the web editor's server and the CLI) against the JAX
package's, on the CPU.

Four items, each a loop over its cases:

1. Settings, notifications and session: one scripted sequence (add, link,
   a clamped parameter, copy/paste/duplicate, undo/redo past the undo
   stack's compression, save/open, autosave) runs on both packages; the
   serialized graphs and the saved files are byte-equal, the settings JSON
   and the notification drains equal (timestamps aside: each is its own
   push's clock).
2. The HTTP API: both servers in-process on 127.0.0.1:0 with the same
   project, token and title; one request script (every GET and every edit
   route, a rejected link and its rollback, the /api/fs root, a missing
   token, a foreign Host and a cross-origin POST) gives equal status codes
   and JSON bodies, apart from the page's title and the about text, which
   name each package.
3. The jobs, on ``device="cpu"``: a served WAV export polled to
   "finished", within 2e-6 of the JAX server's (the two-track mix's bar);
   the live preview WAV read to EOF, bitwise the port's own
   ``StreamingSession`` blocks as s16, and within one s16 step of the JAX
   server's stream (the 2e-6 bar on the floats moves a truncated s16 value
   by at most one step); a stop mid-export leaves no file and the state
   "stopped"; an edit while the job's thread runs is refused; a stop that
   lands before the runner has started still cancels the export, and a
   preview session stopped before it starts produces nothing.
4. The CLI: ``new``, every ``edit`` subcommand, ``help`` with and without
   an identifier, ``browse`` and ``validate`` give the JAX CLI's stdout
   (``help``'s first line names each package) and the same project bytes;
   ``run --diagnostics --profile-nodes --trace`` prints the JAX report's
   keys and the JAX profile's node keys and writes a Chrome trace; ``doctor
   --device cpu`` exits 0 with no relay row, and without a card ``serve``
   and ``doctor`` fail instead of running on the CPU.

Tracks are 1 s at 44.1 kHz, made with numpy from a seed; exports are WAV
only. The JAX package decodes them with its own pure-Python WAV reader: its
native decoder would build its codec runtime without a lock, which test
workers started together can race on.
"""

import contextlib
import http.client
import io
import json
import os
import pathlib
import threading
import time

import numpy as np
import pytest
import torch

from nodey_tpu.app import cli as jcli
from nodey_tpu.app import diagnostics as jdiagnostics
from nodey_tpu.app import notifications as jnotifications
from nodey_tpu.app import server as jserver
from nodey_tpu.app import session as jsession
from nodey_tpu.app import settings as jsettings
from nodey_tpu.core import errors as jerrors
from nodey_tpu.core import runner as jrunner
from nodey_tpu.core.graph import Graph as JGraph
from nodey_tpu.host import decode as jhost_decode
from nodey_tpu_torch.app import cli, diagnostics, notifications, server
from nodey_tpu_torch.app import session, settings
from nodey_tpu_torch.core import errors
from nodey_tpu_torch.core.graph import Graph
from nodey_tpu_torch.core.runner import Runner
from nodey_tpu_torch.core.streaming import StreamingSession
from nodey_tpu_torch.host import decode as host_decode
from nodey_tpu_torch.host import encode as host_encode

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOKEN = "test-token"
TITLE = "two-track mix"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run the port's eager CPU ops on one thread (see
    tests/test_torch_effects.py's fixture of the same name)."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


@pytest.fixture
def jax_decodes_wav_in_python(monkeypatch):
    def no_stream_decoder(path):
        raise jerrors.ProcessorRuntimeError("unavailable", "in tests", path)

    monkeypatch.setattr(jhost_decode, "StreamDecoder", no_stream_decoder)
    monkeypatch.setattr(jhost_decode, "decode_file",
                        jhost_decode._decode_wav_python)


def _project(directory, seconds=1.0):
    """The 5-node two-track mix on two seeded 44.1 kHz stereo tracks."""
    rng = np.random.default_rng(19)
    n = int(44_100 * seconds)
    t = np.arange(n) / 44_100.0
    paths = []
    for i in range(2):
        data = np.stack([0.4 * np.sin(2 * np.pi * 220.0 * (i + 1) * t),
                         0.3 * np.sin(2 * np.pi * 331.0 * t + i)])
        data = data + 0.05 * rng.standard_normal((2, n))
        path = str(directory / f"track_{i + 1}.wav")
        host_decode.write_wav_s16(path, data.astype(np.float32), 44_100)
        paths.append(path)
    blob = json.loads((ROOT / "examples/projects/two_track_mix.json").read_text())
    blob["nodes"]["0"]["info"]["file_path"] = paths
    path = directory / "project.json"
    path.write_text(json.dumps(blob, indent=1))
    return str(path), blob


# -- 1. settings, notifications, session ---------------------------------------

def _session_script(sess_mod, settings_mod, notes_mod, errors_mod, directory):
    """One editing session through a package's app modules; returns the
    transcript: every serialized graph, file and result along the way."""
    out = []

    def snap(what):
        out.append((what, json.dumps(sess.graph.serialize(), indent=1)))

    app_settings = settings_mod.AppSettings()
    app_settings.editor.auto_save_interval = 0
    sess = sess_mod.SessionService(app_settings)
    pmap = sess_mod.registry.processor_map
    sess.save_undo_state()
    src = sess.graph.add_node(pmap["audio_input"].generate())
    sess_mod.apply_params(sess.graph.nodes[src].processor,
                          {"file_path": ["a.wav", "b.wav"]})
    sess.graph.update_node_pin(src)
    nodes = [src]
    for ident, x in (("audio_volume_adjust", 120.0), ("audio_amix", 240.0),
                     ("audio_spectrum", 360.0), ("audio_output", 480.0)):
        sess.save_undo_state()
        nid = sess.graph.add_node(pmap[ident].generate())
        sess.graph.nodes[nid].position = (x, 40.0)
        nodes.append(nid)
    src, vol, amix, spec, outn = nodes
    g = sess.graph

    def pin(n, p):
        return sess.graph.nodes[n].pin_name_map[p]

    for a, b in ((pin(src, "output_0"), pin(vol, "input")),
                 (pin(vol, "output"), pin(amix, "input_1")),
                 (pin(src, "output_1"), pin(amix, "input_2")),
                 (pin(amix, "output"), pin(spec, "input")),
                 (pin(spec, "output"), pin(outn, "input"))):
        sess.save_undo_state()
        g.add_link(a, b)
    g.check_graph()
    snap("built")
    sess.save_undo_state()
    out.append(("clamped", sess_mod.apply_params(
        g.nodes[vol].processor, {"volume": 99.0}),
        g.nodes[vol].processor.snapshot_params()))
    try:
        sess_mod.apply_params(g.nodes[spec].processor, {"no_such_key": 1})
    except errors_mod.InvalidFileError as exc:
        out.append(("refused", str(exc)))
    out.append(("copied", sess.copy_nodes([vol, amix, outn])))
    out.append(("pasted", sess.paste_nodes()))
    out.append(("pasted at", sess.paste_nodes(at=(10.0, 20.0))))
    snap("pasted")
    saved = sess.clipboard_json
    out.append(("duplicated", sess.copy_nodes([spec]), sess.paste_nodes()))
    sess.clipboard_json = saved
    for k in range(24):  # past the compression at 20 and at 30 states
        sess.save_undo_state()
        g.nodes[vol].processor.restore_params({"volume": 0.01 * k})
    out.append(("stack", len(sess.undo_stack)))
    for k in range(6):
        out.append(("undo", sess.undo(), len(sess.undo_stack)))
        snap(f"undo {k}")
    for k in range(3):
        out.append(("redo", sess.redo(), len(sess.redo_stack)))
        snap(f"redo {k}")
    path = str(directory / "session.json")
    out.append(("saved", os.path.basename(sess.save_project(path)),
                pathlib.Path(path).read_bytes()))
    sess.graph.nodes[spec].position = (1.0, 2.0)
    sess.graph.modified = True
    autosaved = sess.maybe_autosave()
    out.append(("autosave", os.path.basename(autosaved),
                pathlib.Path(autosaved).read_bytes()))
    sess.open_project(path)
    snap("opened")
    out.append(("undo after open", sess.undo()))
    snap("undone open")
    sess.new_project()
    out.append(("new", len(sess.graph.nodes), len(sess.undo_stack)))

    # Settings: set, a blob with bad values, reset; the saved file.
    s = settings_mod.AppSettings()
    s.deserialize({"ui": {"grid_size": "12.5", "side_panel_width": "wide",
                          "show_grid": 0},
                   "editor": {"max_undo_levels": 7.9},
                   "render": {"default_output_directory": "/out"},
                   "unknown": 1})
    out.append(("settings", json.dumps(s.serialize())))
    settings_path = str(directory / "settings.json")
    s.save_to_file(settings_path)
    out.append(("settings file", pathlib.Path(settings_path).read_bytes()))
    loaded = settings_mod.AppSettings()
    loaded.load_from_file(settings_path)
    loaded.load_from_file(str(directory / "missing.json"))
    out.append(("settings loaded", loaded.serialize()))
    loaded.reset_to_defaults()
    out.append(("settings reset", loaded.serialize()))

    # Notifications: order, the three-part unwrap, capacity, listeners.
    center = notes_mod.NotificationCenter(capacity=3)
    heard = []
    center.add_listener(lambda n: heard.append(n.message))
    center.push("info", "one")
    center.push("warning", "two", "why", "detail")
    center.push_error(errors_mod.ProcessorRuntimeError("m", "e", "d"))
    center.push_error(ValueError("plain"))
    try:
        center.push("loud", "bad")
    except ValueError as exc:
        out.append(("severity", str(exc)))

    def fields(items):
        return [{k: v for k, v in n.as_dict().items() if k != "timestamp"}
                for n in items]

    out.append(("peek", fields(center.peek(since_seq=2)), len(center)))
    out.append(("drain", fields(center.drain()), center.dropped, len(center),
                heard))
    out.append(("default", notes_mod.get_default() is notes_mod.get_default()))
    return out


def test_session_settings_and_notifications_equal_the_jax_package(tmp_path):
    got = {}
    for name, mods in (
            ("jax", (jsession, jsettings, jnotifications, jerrors)),
            ("port", (session, settings, notifications, errors))):
        directory = tmp_path / name
        directory.mkdir()
        got[name] = _session_script(*mods, directory)
    assert len(got["port"]) == len(got["jax"])
    for want, have in zip(got["jax"], got["port"]):
        assert have == want, f"step {want[0]!r}"
    steps = dict((step[0], step) for step in got["port"])
    assert steps["stack"][1] < 30  # the stack was compressed
    assert steps["clamped"][2] == {"volume": 10.0}


# -- 2. the HTTP API -------------------------------------------------------------

def _start(module, graph, fs_root, **kwargs):
    srv = module.serve(graph, TITLE, "127.0.0.1", 0, auth_token=TOKEN,
                       fs_root=fs_root, **kwargs)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return srv


def _stop(srv):
    srv.viewer.stop_preview()
    srv.shutdown()
    srv.server_close()


def _request(port, method, path, body=None, token=TOKEN, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    sent = {"Host": f"127.0.0.1:{port}"}
    if token:
        sent["X-Nodey-Token"] = token
    sent.update(headers or {})
    data = None if body is None else json.dumps(body).encode()
    if data is not None:
        sent["Content-Type"] = "application/json"
    conn.request(method, path, body=data, headers=sent)
    resp = conn.getresponse()
    payload = resp.read()
    conn.close()
    return resp.status, payload


def _api_script(port, project, fs_root, save_path):
    """Every route once or more; returns [(request, status, body)]."""
    get = [("GET", p) for p in (
        "/", "/api/graph", "/api/registry", "/api/state", "/api/settings",
        "/api/help", f"/api/fs?path={fs_root}", f"/api/fs?path={fs_root}/sub",
        "/api/fs?path=/", "/api/fs?path=/no/such/dir", "/api/notifications",
        "/api/notifications?since=x", "/api/nothing")]
    post = [
        ("POST", "/api/edit/add-node", {"identifier": "audio_volume_adjust",
                                        "x": 300, "y": 200}),
        ("POST", "/api/edit/add-node", {"identifier": "audio_output"}),
        ("POST", "/api/edit/add-node", {"identifier": "no_such_node"}),
        ("POST", "/api/edit/move", {"node_id": 6, "x": 310.5, "y": 190}),
        ("POST", "/api/edit/set", {"node_id": 6, "params": {"volume": 50}}),
        ("POST", "/api/edit/set", {"node_id": 3,
                                   "params": {"volumes0": 0.6,
                                              "volumes1": 0.4}}),
        ("POST", "/api/edit/set", {"node_id": 4, "params": {"bogus": 1}}),
        ("GET", "/api/graph"),
        # A second link into the spectrum's occupied input (pin 10): the
        # new volume node's output (pin 12) is rejected and rolled back.
        ("POST", "/api/edit/link", {"from_pin": 12, "to_pin": 10}),
        ("GET", "/api/graph"),
        ("POST", "/api/edit/link", {"from_pin": 0, "to_pin": 13}),
        ("POST", "/api/edit/unlink", {"from_pin": 6, "to_pin": 10}),
        ("POST", "/api/edit/link", {"from_pin": 6, "to_pin": 10}),
        ("POST", "/api/copy", {"node_ids": [1, 2]}),
        ("POST", "/api/paste", {}),
        ("POST", "/api/paste", {"x": 50, "y": 60}),
        ("POST", "/api/duplicate", {"node_ids": [6]}),
        ("GET", "/api/graph"),
        ("POST", "/api/edit/remove-node", {"node_id": 6}),
        ("POST", "/api/edit/remove-node", {"node_id": 99}),
        ("POST", "/api/edit/remove-nodes", {"node_ids": [7, 8, 7]}),
        ("POST", "/api/edit/remove-nodes", {"node_ids": [98]}),
        ("POST", "/api/edit/unknown-op", {}),
        ("POST", "/api/undo"), ("POST", "/api/undo"), ("POST", "/api/redo"),
        ("GET", "/api/graph"),
        ("POST", "/api/settings", {"ui": {"grid_size": 32},
                                   "editor": {"max_undo_levels": 12}}),
        ("GET", "/api/settings"),
        ("POST", "/api/save", {"path": save_path}),
        ("GET", "/api/graph"),
        ("POST", "/api/new"),
        ("GET", "/api/graph"),
        ("POST", "/api/open", {}),
        ("POST", "/api/open", {"path": project}),
        ("GET", "/api/graph"),
        ("POST", "/api/nothing", {}),
        ("GET", "/api/state"),
    ]
    out = []
    for method, path, *body in get + post:
        status, payload = _request(port, method, path, *(body or [None]))
        out.append(((method, path, *body), status, payload))
    # A missing token, a foreign Host and a cross-origin POST.
    for method, path, kwargs in (
            ("GET", "/api/graph", {"token": ""}),
            ("GET", "/", {"token": ""}),
            ("POST", "/api/undo", {"token": ""}),
            ("GET", "/api/graph", {"headers": {"Host": "evil.example:80"}}),
            ("POST", "/api/save", {"headers": {"Origin": "http://evil.example"},
                                   "body": {"path": save_path + ".x"}}),
            ("POST", "/api/undo", {"headers": {"Origin": "null"}}),
            ("GET", f"/api/graph?token={TOKEN}", {"token": ""})):
        status, payload = _request(port, method, path, **kwargs)
        out.append(((method, path, json.dumps(kwargs)), status, payload))
    return out


# The one clause of the node manual that describes the TPU's execution:
# the port's resampler node leaves it out.
_TPU_CLAUSE = ", executed as one MXU matmul per block"


def _comparable(request, payload):
    """The body as compared: JSON parsed; the page with its title's package
    name dropped; the about text dropped from /api/help, and the manual's
    TPU clause."""
    if b"Authentication required" in payload:
        return None  # the 403 page names each package's serve command
    if request[1] == "/":
        return payload.replace(b"<title>nodey_tpu_torch \xe2\x80\x94",
                               b"<title>nodey_tpu \xe2\x80\x94")
    body = json.loads(payload)
    if request[1] == "/api/help":
        body.pop("about")
        for node in body["nodes"]:
            node["description"] = node["description"].replace(_TPU_CLAUSE, "")
    return body


def test_http_api_equals_the_jax_server(tmp_path):
    project, blob = _project(tmp_path)
    fs_root = tmp_path / "fs"
    (fs_root / "sub").mkdir(parents=True)
    (fs_root / "a.json").write_text("{}")
    (fs_root / "sub" / "b.wav").write_bytes(b"RIFF")
    (fs_root / ".hidden").write_text("")
    got = {}
    for name, module, graph_cls, kwargs in (
            ("jax", jserver, JGraph, {}),
            ("port", server, Graph, {"device": "cpu"})):
        srv = _start(module, graph_cls.deserialize(blob), str(fs_root),
                     **kwargs)
        try:
            got[name] = _api_script(srv.server_address[1], project,
                                    str(fs_root), str(tmp_path / "saved.json"))
            got[name + " file"] = (tmp_path / "saved.json").read_bytes()
        finally:
            _stop(srv)
    assert got["port file"] == got["jax file"]
    assert len(got["port"]) == len(got["jax"])
    for (request, jstatus, jbody), (_, status, body) in zip(got["jax"],
                                                          got["port"]):
        assert status == jstatus, request
        assert _comparable(request, body) == _comparable(request, jbody), \
            request
    by_request = {str(request): (status, body)
                  for request, status, body in got["port"]}
    help_body = json.loads(by_request[str(("GET", "/api/help"))][1])
    assert help_body["about"]["name"] == "nodey_tpu_torch"
    assert "TPU-native" not in help_body["about"]["description"]
    link = ("POST", "/api/edit/link", {"from_pin": 12, "to_pin": 10})
    status, body = by_request[str(link)]
    assert status == 400 and b"Multiple Inputs in Input Pin: 10" in body
    requests = [request for request, _, _ in got["port"]]
    before = json.loads(got["port"][requests.index(link) - 1][2])
    after = json.loads(got["port"][requests.index(link) + 1][2])
    assert before["links"] == after["links"]  # rolled back
    assert by_request[str(("GET", "/api/fs?path=/"))][0] == 400
    codes = [status for request, status, _ in got["port"][-7:]]
    assert codes == [403, 403, 403, 403, 403, 403, 200]


# -- 3. the jobs ------------------------------------------------------------------

def _wait_state(port, states=("finished", "stopped", "error"), timeout=120):
    deadline = time.time() + timeout
    polls = []
    while time.time() < deadline:
        state = json.loads(_request(port, "GET", "/api/state")[1])
        polls.append(state)
        if state["state"] in states:
            return state, polls
        time.sleep(0.01)
    raise AssertionError(f"no {states} within {timeout} s: {polls[-1]}")


def _session_pcm(graph):
    """The port's own StreamingSession blocks, as the server sends them."""
    sess = StreamingSession(graph, device="cpu").start(streamed=True)
    blocks = list(sess.blocks())
    sess.stop()
    return b"".join(
        np.clip(block.T * np.float32(32767.0), -32768, 32767)
        .astype(np.int16).tobytes() for block in blocks)


def test_served_jobs_on_the_cpu(tmp_path, monkeypatch, jax_decodes_wav_in_python):
    project, blob = _project(tmp_path)
    got = {}
    for name, module, graph_cls, kwargs in (
            ("jax", jserver, JGraph, {}),
            ("port", server, Graph, {"device": "cpu"})):
        srv = _start(module, graph_cls.deserialize(blob), None, **kwargs)
        port = srv.server_address[1]
        try:
            out = str(tmp_path / f"{name}.wav")
            status, body = _request(port, "POST", "/api/export",
                                    {"path": out, "kbps": 320})
            assert status == 200, body
            state, polls = _wait_state(port)
            assert state["state"] == "finished", (name, state)
            got[name] = host_decode.decode_file(out).data
            got[name + " stages"] = [p["stages"] for p in polls
                                     if p["stages"] is not None]
            status, pcm = _request(port, "GET", "/api/preview.wav?start=1")
            assert status == 200
            assert pcm[:44] == server._wav_stream_header()
            got[name + " preview"] = pcm[44:]
            state, _ = _wait_state(port)
            assert state["state"] == "finished", (name, state)
        finally:
            _stop(srv)
    # The export: the two-track mix's bar against the JAX server's.
    assert got["port"].shape == got["jax"].shape == (2, 48_000)
    np.testing.assert_allclose(got["port"], got["jax"], rtol=0, atol=2e-6)
    assert all({"steps", "d2h_busy_seconds"} <= set(s)
               for s in got["port stages"])
    # The preview: bitwise the port's session; within one s16 step of the
    # JAX server's stream.
    assert got["port preview"] == _session_pcm(Graph.deserialize(blob))
    ours = np.frombuffer(got["port preview"], np.int16).astype(np.int32)
    theirs = np.frombuffer(got["jax preview"], np.int16).astype(np.int32)
    assert ours.shape == theirs.shape == (2 * 48_000,)
    assert np.abs(ours - theirs).max() <= 1

    # A stop mid-export: the sink holds its first block until the stop.
    entered, release = threading.Event(), threading.Event()
    open_sink = host_encode.open_sink

    def held_sink(*args, **kwargs):
        sink = open_sink(*args, **kwargs)
        write = sink.write

        def held_write(block):
            entered.set()
            assert release.wait(30)
            write(block)

        sink.write = held_write
        return sink

    monkeypatch.setattr(host_encode, "open_sink", held_sink)
    srv = _start(server, Graph.deserialize(blob), None, device="cpu")
    port = srv.server_address[1]
    try:
        out = tmp_path / "stopped.wav"
        assert _request(port, "POST", "/api/export", {"path": str(out)})[0] == 200
        assert entered.wait(60) and out.exists()
        status, body = _request(port, "POST", "/api/edit/move",
                                {"node_id": 1, "x": 1, "y": 1})
        assert status == 400 and b"Stop the running" in body
        assert _request(port, "POST", "/api/stop")[0] == 200
        release.set()
        srv.viewer._job_thread.join(30)
        state, _ = _wait_state(port)
        assert state["state"] == "stopped" and state["error"] is None
        assert not out.exists()
        notes = json.loads(_request(port, "GET", "/api/notifications")[1])
        assert notes[-1]["message"] == "Export cancelled"
        assert _request(port, "POST", "/api/edit/move",
                        {"node_id": 1, "x": 1, "y": 1})[0] == 200

        # A stop that lands before the export has started: the runner
        # keeps it, and the export is cancelled before its first chunk.
        monkeypatch.setattr(host_encode, "open_sink", open_sink)
        started = threading.Event()
        held = threading.Event()

        class HeldRunner(Runner):
            def export_streamed(self, *args, **kwargs):
                started.set()
                assert held.wait(30)
                return super().export_streamed(*args, **kwargs)

        monkeypatch.setattr(server, "Runner", HeldRunner)
        early = tmp_path / "early.wav"
        assert _request(port, "POST", "/api/export",
                        {"path": str(early)})[0] == 200
        assert started.wait(30)
        assert _request(port, "POST", "/api/stop")[0] == 200
        held.set()
        srv.viewer._job_thread.join(30)
        state, _ = _wait_state(port)
        assert state["state"] == "stopped" and not early.exists()
    finally:
        release.set()
        _stop(srv)
    # A preview session stopped before it starts yields nothing, and its
    # executor ends at once instead of rendering the clip unheard.
    sess = StreamingSession(Graph.deserialize(blob), device="cpu")
    sess.stop()
    assert list(sess.start(streamed=True).blocks()) == []
    sess._producer.join(30)
    assert not sess._producer.is_alive() and sess._executor._stop.is_set()


# -- 4. the CLI --------------------------------------------------------------------

def _cli(main, argv, stdin=""):
    stdout, stderr = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(stderr):
        old_stdin = os.sys.stdin
        os.sys.stdin = io.StringIO(stdin)
        try:
            rc = main(argv)
        finally:
            os.sys.stdin = old_stdin
    return rc, stdout.getvalue(), stderr.getvalue()


def test_cli_equals_the_jax_cli(tmp_path, monkeypatch):
    project, _blob = _project(tmp_path)
    browse_root = tmp_path / "browse"
    (browse_root / "sub").mkdir(parents=True)
    (browse_root / "inner").mkdir()
    (browse_root / "inner" / "a.txt").write_text("")
    (browse_root / "sub" / "pick.json").write_text("{}")
    (browse_root / "z.txt").write_text("")
    edits = [
        ["new", "{p}"],
        ["edit", "{p}", "add-node", "audio_input", "--pos", "10,20",
         "--param", f'file_path={json.dumps(json.loads(pathlib.Path(project).read_text())["nodes"]["0"]["info"]["file_path"])}'],
        ["edit", "{p}", "add-node", "audio_volume_adjust",
         "--param", "volume=42"],
        ["edit", "{p}", "add-node", "audio_amix", "--param", "input_num=2"],
        ["edit", "{p}", "add-node", "audio_output"],
        ["edit", "{p}", "add-node", "no_such_node"],
        ["edit", "{p}", "link", "0.output_0", "1.input"],
        ["edit", "{p}", "link", "1.output", "2.input_1"],
        ["edit", "{p}", "link", "0.output_1", "2.input_2"],
        ["edit", "{p}", "link", "2.output", "3.input"],
        ["edit", "{p}", "link", "0.output_0", "3.input"],
        ["edit", "{p}", "link", "9.output", "3.input"],
        ["edit", "{p}", "set", "2", "volumes0=0.25", "locks1=true"],
        ["edit", "{p}", "set", "1", "nonsense=1"],
        ["edit", "{p}", "set", "7", "volume=1"],
        ["edit", "{p}", "unlink", "2.output", "3.input"],
        ["edit", "{p}", "link", "2.output", "3.input"],
        ["edit", "{p}", "add-node", "audio_spectrum"],
        ["edit", "{p}", "remove-node", "4"],
        ["edit", "{p}", "remove-node", "4"],
        ["edit", "{p}", "show"],
        ["validate", "{p}"],
        ["help"],
        ["help", "audio_amix"],
        ["help", "audio_input"],
        ["help", "no_such_node"],
        ["browse", str(browse_root / "inner")],
    ]
    # Not a number, out of range, up, into sub/, pick.json.
    stdin = {"browse": "x\n9\n0\n2\n1\n"}
    got = {}
    for name, main in (("jax", jcli.main), ("port", cli.main)):
        path = str(tmp_path / f"{name}.json")
        runs = []
        for argv in edits:
            argv = [a.replace("{p}", path) for a in argv]
            rc, out, err = _cli(main, argv, stdin.get(argv[0], ""))
            out = out.replace(path, "{p}")
            if argv[0] == "help" and len(argv) == 1:
                out = out.split("\n", 1)[1]  # the line naming the package
            runs.append((argv[0], rc, out, err.replace(path, "{p}"),
                         pathlib.Path(path).read_bytes()))
        got[name] = runs
    for want, have in zip(got["jax"], got["port"]):
        assert have == want, f"{want[0]}: {want[1:4]}"
    # Refused: an unknown node type, a second link into 3.input, a link
    # from a missing node, an unknown parameter, a missing node to set and
    # to remove, and help on an unknown node.
    assert [k for k, r in enumerate(got["port"]) if r[1] == 1] == [
        5, 10, 11, 13, 14, 19, 25]
    assert got["port"][-1][2].strip().endswith("pick.json")

    # run: the JAX report's keys, the JAX profile's node keys, a trace.
    trace = tmp_path / "trace"
    rc, out, err = _cli(cli.main, [
        "run", project, "--export", str(tmp_path / "out.wav"), "--device",
        "cpu", "--diagnostics", "--profile-nodes", "--trace", str(trace)])
    assert rc == 0, err
    decoder = json.JSONDecoder()
    start = out.index("{")
    report, end = decoder.raw_decode(out, start)
    profile, _ = decoder.raw_decode(out, out.index("{", end))
    jgraph = JGraph.deserialize(json.loads(pathlib.Path(project).read_text()))
    want = jdiagnostics.run_report(jgraph, jrunner.RunMetrics())
    assert report.keys() == want.keys()
    assert report["stages"].keys() == want["stages"].keys()
    assert report["graph"] == want["graph"]
    assert report["audio_seconds"] == 1.0
    graph = Graph.deserialize(json.loads(pathlib.Path(project).read_text()))
    assert set(profile) == {str(nid) for nid in graph.nodes} == {
        str(nid) for nid in jgraph.nodes}
    for nid, entry in profile.items():
        assert entry.keys() == {"identifier", "device_s", "cumulative_s"}
        assert entry["identifier"] == \
            graph.nodes[int(nid)].processor.info().identifier
        assert entry["device_s"] >= 0.0
    assert profile["5"]["cumulative_s"] == pytest.approx(
        sum(e["device_s"] for e in profile.values()), abs=1e-5)
    [trace_file] = trace.glob("*.json")
    assert "traceEvents" in json.loads(trace_file.read_text())
    with diagnostics.maybe_trace(None) as nothing:
        assert nothing is None

    rc, out, err = _cli(cli.main, ["doctor", "--device", "cpu"])
    assert rc == 0, out + err
    for word in ("relay", "claim", "probe rtt", "compile cache", "DEGRADED"):
        assert word not in out
    for row in ("torch", "libnodey_host", "build dir", "polyphase_resample",
                "device"):
        assert row in out
    if not torch.cuda.is_available():
        # No card: the default device is an error, never the CPU.
        rc, out, err = _cli(cli.main, ["doctor"])
        assert rc == 3 and "UNAVAILABLE" in out
        rc, out, err = _cli(cli.main, ["serve", project, "--port", "0"])
        assert rc == 1 and "No CUDA device available" in err
        with pytest.raises(errors.ProcessorRuntimeError):
            server.ViewerState(Graph(), "t")
