"""The port runs with ``import jax`` blocked: a fresh interpreter whose
``sys.meta_path`` refuses jax renders a tiny WAV graph through
``python -m nodey_tpu_torch run ... --device cpu``."""

import json
import os
import subprocess
import sys

import numpy as np

from nodey_tpu_torch.host.decode import write_wav_s16

_DRIVER = r"""
import runpy, sys

class _BlockJax:
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith(("jax.", "jaxlib")):
            raise ImportError(f"import of {name} is blocked")
        return None

sys.meta_path.insert(0, _BlockJax())
sys.argv = ["nodey_tpu_torch"] + sys.argv[1:]
try:
    runpy.run_module("nodey_tpu_torch", run_name="__main__")
finally:
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))
    print("JAX_MODULES", leaked)
"""


def test_cli_runs_with_jax_blocked(tmp_path):
    rng = np.random.default_rng(3)
    paths = []
    for i in range(2):
        path = str(tmp_path / f"t{i}.wav")
        write_wav_s16(path, (0.3 * rng.standard_normal((2, 4410))).astype(
            np.float32), 44_100)
        paths.append(path)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "examples/projects/two_track_mix.json")) as f:
        project = json.load(f)
    project["nodes"]["0"]["info"]["file_path"] = paths
    proj = tmp_path / "p.json"
    proj.write_text(json.dumps(project))
    out = tmp_path / "out.wav"

    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run(
        [sys.executable, "-c", _DRIVER, "run", str(proj), "--export",
         str(out), "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "JAX_MODULES []" in proc.stdout, proc.stdout
    assert "spectrum 'spectrum_4'" in proc.stdout
    assert out.stat().st_size > 44 + 2 * 4 * 4410
