"""The port runs with ``import jax`` and ``import nodey_tpu`` blocked.

A fresh interpreter whose ``sys.meta_path`` refuses jax and the JAX
package imports every module of ``nodey_tpu_torch`` and renders a tiny
WAV graph through ``python -m nodey_tpu_torch run ... --device cpu``, once
offline (then ``doctor --device cpu`` and ``edit ... show`` in the same
interpreter), once streamed (``--stream``) and once as the realtime preview
(``--realtime``); ``serve --device cpu`` answers one ``GET /api/graph``
with its token and shuts down on SIGINT; afterwards ``sys.modules`` holds
neither. ``chip_smoke.py`` and the A/B tool (``python -m
nodey_tpu_torch.tools.ab_wsola_fps``) are held to the same, and no source
file of the port (``tools/`` included) names either in an import.
tests/test_torch_dcn.py runs the processes of the gloo dry run
(``parallel/dcn.py``) under this blocker too.
"""

import ast
import json
import os
import pathlib
import re
import signal
import subprocess
import sys
import urllib.request

import numpy as np
import pytest

from nodey_tpu_torch.host.decode import write_wav_s16

ROOT = pathlib.Path(__file__).resolve().parents[1]

_BLOCKER = r"""
import sys

_BLOCKED = ("jax", "jaxlib", "nodey_tpu")

def _blocked(name):
    return name.split(".")[0] in _BLOCKED

class _Block:
    def find_spec(self, name, path=None, target=None):
        if _blocked(name):
            raise ImportError(f"import of {name} is blocked")
        return None

sys.meta_path.insert(0, _Block())

def report():
    leaked = sorted(m for m in sys.modules if _blocked(m))
    print("BLOCKED_MODULES", leaked, flush=True)
"""

# Runs ``python -m nodey_tpu_torch`` once per command; commands are
# separated by "--then", and the script exits with the first non-zero code.
_CLI_DRIVER = _BLOCKER + r"""
import importlib, pkgutil, runpy
import nodey_tpu_torch
for mod in pkgutil.walk_packages(nodey_tpu_torch.__path__, "nodey_tpu_torch."):
    if mod.name != "nodey_tpu_torch.__main__":
        importlib.import_module(mod.name)
commands = [[]]
for arg in sys.argv[1:]:
    if arg == "--then":
        commands.append([])
    else:
        commands[-1].append(arg)
try:
    for argv in commands:
        sys.argv = ["nodey_tpu_torch"] + argv
        try:
            runpy.run_module("nodey_tpu_torch", run_name="__main__")
        except SystemExit as exc:
            if exc.code:
                raise
finally:
    report()
"""

_SMOKE_DRIVER = _BLOCKER + r"""
import runpy
try:
    runpy.run_path(sys.argv[1], run_name="__main__")
finally:
    report()
"""


def _run(code, *args, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run(
        [sys.executable, "-c", code, *args], capture_output=True, text=True,
        env=env, cwd=str(cwd), timeout=300,
    )


def _project(tmp_path):
    rng = np.random.default_rng(3)
    paths = []
    for i in range(2):
        path = str(tmp_path / f"t{i}.wav")
        write_wav_s16(path, (0.3 * rng.standard_normal((2, 4410))).astype(
            np.float32), 44_100)
        paths.append(path)
    project = json.loads((ROOT / "examples/projects/two_track_mix.json").read_text())
    project["nodes"]["0"]["info"]["file_path"] = paths
    proj = tmp_path / "p.json"
    proj.write_text(json.dumps(project))
    return proj


@pytest.mark.parametrize("stream", [False, True])
def test_cli_runs_with_jax_blocked(tmp_path, stream):
    proj = _project(tmp_path)
    out = tmp_path / "out.wav"

    more = [] if stream else ["--then", "doctor", "--device", "cpu",
                              "--then", "edit", str(proj), "show"]
    proc = _run(_CLI_DRIVER, "run", str(proj), "--export", str(out),
                "--device", "cpu", *(["--stream"] if stream else []), *more,
                cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "BLOCKED_MODULES []" in proc.stdout, proc.stdout
    if stream:
        assert "(streamed)" in proc.stdout and "stages:" in proc.stdout
    else:
        assert "spectrum 'spectrum_4'" in proc.stdout
        assert "nodey_tpu_torch doctor" in proc.stdout
        assert "device                 cpu" in proc.stdout
        assert "node 3: audio_amix pins=" in proc.stdout
        assert "link 5: 4.output -> 5.input" in proc.stdout
    assert out.stat().st_size > 44 + 2 * 4 * 4410


def test_realtime_preview_runs_with_jax_blocked(tmp_path):
    out = tmp_path / "preview.wav"
    proj = _project(tmp_path)
    proc = _run(_CLI_DRIVER, "run", str(proj), "--realtime",
                "--preview", str(out), "--device", "cpu", cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "BLOCKED_MODULES []" in proc.stdout, proc.stdout
    assert "streamed 0.10 audio-s" in proc.stdout, proc.stdout
    assert out.stat().st_size == 44 + 2 * 4 * 4800

    # serve: the printed URL's token answers one GET; SIGINT shuts it down.
    serve = subprocess.Popen(
        [sys.executable, "-c", _CLI_DRIVER, "serve", str(proj), "--port", "0",
         "--device", "cpu"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        cwd=str(tmp_path))
    try:
        first = serve.stdout.readline()
        match = re.search(r"http://127\.0\.0\.1:(\d+)/\?token=(\S+)", first)
        assert match, first + serve.stderr.read()
        port, token = match.groups()
        request = urllib.request.Request(
            f"http://127.0.0.1:{port}/api/graph",
            headers={"X-Nodey-Token": token})
        with urllib.request.urlopen(request, timeout=60) as response:
            graph = json.loads(response.read())
        assert [n["identifier"] for n in graph["nodes"]][:2] == [
            "audio_input", "audio_volume_adjust"]
        serve.send_signal(signal.SIGINT)
        rest, err = serve.communicate(timeout=60)
    finally:
        if serve.poll() is None:
            serve.kill()
            serve.communicate()
    assert serve.returncode == 0, rest + err
    assert "BLOCKED_MODULES []" in rest, rest


def test_chip_smoke_loads_nothing_of_jax_and_fails_without_a_card(tmp_path):
    """Without a card chip_smoke.py exits non-zero and prints no result,
    having imported the port but neither jax nor nodey_tpu."""
    proc = _run(_SMOKE_DRIVER, str(ROOT / "chip_smoke.py"), cwd=tmp_path)
    assert proc.returncode != 0
    assert "BLOCKED_MODULES []" in proc.stdout, proc.stdout + proc.stderr
    assert "nodey_tpu_torch" in proc.stderr or "cuda" in proc.stderr.lower()
    assert '"ok": true' not in proc.stdout


_TOOL_SCRIPT = _BLOCKER + r"""
import runpy
sys.argv = ["ab_wsola_fps", "1", "1"]
try:
    runpy.run_module("nodey_tpu_torch.tools.ab_wsola_fps", run_name="__main__")
finally:
    report()
"""


def test_ab_tool_loads_nothing_of_jax_and_fails_without_a_card(tmp_path):
    """The A/B tool measures on the card only: without one it says so and
    exits non-zero, having imported neither jax nor nodey_tpu."""
    proc = _run(_TOOL_SCRIPT, cwd=tmp_path)
    assert proc.returncode != 0
    assert "BLOCKED_MODULES []" in proc.stdout, proc.stdout + proc.stderr
    assert "no CUDA card" in proc.stderr, proc.stderr
    assert "K=" not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=str(tmp_path),
                          capture_output=True, text=True, timeout=300,
                          env={k: v for k, v in os.environ.items()
                               if k != "PYTHONPATH"})
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_port_source_imports_jax_or_nodey_tpu():
    files = sorted((ROOT / "nodey_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    assert len(files) > 30
    for path in files:
        bad = _imported_roots(path) & {"jax", "jaxlib", "nodey_tpu"}
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"
