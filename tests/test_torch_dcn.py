"""A mesh across a process boundary (nodey_tpu_torch/parallel/dcn.py), on
the CPU.

Two processes join one gloo group and own two shards each of one global sp
mesh of four; the JAX dry run's 5-node LTI graph renders with its sample
axis sharded across the process boundary, so the resampler's halo pairs
between shards 1 and 2 cross processes (isend / irecv of host tensors).
Each process runs with ``jax`` and ``nodey_tpu`` blocked
(tests/test_torch_no_jax.py's blocker, prepended to its ``python -c``
program; a blocked module left in ``sys.modules`` fails it) and checks its
own shards. On the CPU every shard is BITWISE the single render and the
one-process sp render of the same windows (the bar tests/test_dcn.py sets
for the JAX package); the test asserts that, not the 3e-7 allowance of
tests/test_torch_parallel.py.

The launcher raises with a failing process's exit code and the tail of
its output, and passes each process its identity in the spec variable.
"""

import json
import subprocess
import sys

import pytest

from nodey_tpu_torch.ops import launch_counts
from nodey_tpu_torch.parallel import dcn
from test_torch_no_jax import _BLOCKER

_CHILD_CHECK = """
leaked = sorted(m for m in sys.modules if _blocked(m))
if leaked:
    print("BLOCKED_MODULES", leaked, flush=True)
    sys.exit(9)
"""


def test_two_processes_render_one_mesh_bitwise(monkeypatch):
    real_popen = subprocess.Popen

    def blocked_popen(cmd, **kw):
        assert cmd[1] == "-c", cmd
        return real_popen([cmd[0], "-c", _BLOCKER + cmd[2] + "\n"
                           + _CHILD_CHECK], **kw)

    monkeypatch.setattr(subprocess, "Popen", blocked_popen)
    reports = dcn.launch_dcn_dryrun(
        num_processes=2, local_devices=2, timeout=120.0, device="cpu",
        extra_env={"OMP_NUM_THREADS": "1"})
    assert [r["rank"] for r in reports] == [0, 1]
    assert [r["shards"] for r in reports] == [[0, 1], [2, 3]]
    for r in reports:
        assert r["device"] == "cpu" and r["length"] == 24_000
        assert r["bitwise_single"] and r["bitwise_sp"], r
        assert r["max_abs_single"] == r["max_abs_sp"] == 0.0
        # Each process sends its edge shard's halos of both inputs across
        # the boundary, the same bytes both ways.
        assert r["bytes_sent"] == reports[0]["bytes_sent"] > 0
        assert set(r["launches"]) == set(launch_counts())
        assert not any(r["launches"].values())      # the CPU: no kernel


def test_launcher_surfaces_failures_and_passes_the_spec(monkeypatch):
    real_popen = subprocess.Popen

    def failing_popen(cmd, **kw):
        return real_popen(
            [sys.executable, "-c", "import sys; print('boom'); sys.exit(3)"],
            **{k: v for k, v in kw.items() if k != "cwd"})

    monkeypatch.setattr(subprocess, "Popen", failing_popen)
    with pytest.raises(RuntimeError) as err:
        dcn.launch_dcn_dryrun(num_processes=2, local_devices=1, timeout=60.0,
                              device="cpu")
    assert "rc=3" in str(err.value) and "boom" in str(err.value)

    def hanging_popen(cmd, **kw):
        return real_popen([sys.executable, "-c",
                           "import time; print('slow', flush=True); "
                           "time.sleep(60)"],
                          **{k: v for k, v in kw.items() if k != "cwd"})

    monkeypatch.setattr(subprocess, "Popen", hanging_popen)
    with pytest.raises(RuntimeError) as err:
        dcn.launch_dcn_dryrun(num_processes=1, local_devices=1, timeout=2.0,
                              device="cpu")
    assert "(timeout)" in str(err.value) and "slow" in str(err.value)

    captured = {}

    class FakeProc:
        returncode = 0

        def __init__(self, env):
            spec = json.loads(env[dcn._ENV_SPEC])
            captured[spec["process_id"]] = env
            self.out = ("DCN_REPORT " + json.dumps(
                {"rank": spec["process_id"]})).encode()

        def communicate(self, timeout=None):
            return self.out, None

    monkeypatch.setattr(subprocess, "Popen",
                        lambda cmd, cwd=None, env=None, **kw: FakeProc(env))
    reports = dcn.launch_dcn_dryrun(num_processes=3, local_devices=2,
                                    timeout=5.0, device="cuda")
    assert [r["rank"] for r in reports] == [0, 1, 2]
    assert set(captured) == {0, 1, 2}
    for pid, env in captured.items():
        spec = json.loads(env[dcn._ENV_SPEC])
        assert spec["num_processes"] == 3 and spec["local_devices"] == 2
        assert spec["process_id"] == pid and spec["device"] == "cuda"
        assert spec["coordinator"].startswith("127.0.0.1:")
        assert spec["timeout"] == 5.0
