"""The served streamed export against the CLI's, in one fresh process.

    python -m nodey_tpu_torch.tools.serve_probe [--seconds 300] [--pairs 10]
        [--poll 0.005] [--device cuda]

Writes the two-track mix's inputs (``examples/projects/two_track_mix.json``:
two seeded 44.1 kHz stereo tracks of ``--seconds``, tones plus noise, as
s16 WAVs), builds the kernels, and serves the project in process on
127.0.0.1:0 (``app.server.serve``). Then it times, from the wall clock:

- the first served export of the process (``POST /api/export`` to WAV, then
  ``/api/state`` polled every ``--poll`` s until it leaves "running"): what
  the first job of a fresh ``serve`` pays;
- ``--pairs`` pairs of a served export and the CLI's ``run --export
  --stream`` of the same project in the same process, in the order A B B A
  (served first in even pairs, the CLI first in odd ones), so that neither
  side always runs first.

It prints each export's wall time and wall RTF, then per side the median,
minimum and maximum, and the ratio served / CLI within each pair (median,
minimum, maximum). Beside each figure stands the card's name and power
limit as ``nvidia-smi`` gives them. Compare the two sides only within one
run of the tool. Without a card it exits 1 unless ``--device cpu`` is
given (a small smoke run on the CPU).
"""

from __future__ import annotations

import argparse
import contextlib
import http.client
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

RATE = 44_100
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def card_name() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out or "nvidia-smi unavailable"


def write_project(directory: str, seconds: int) -> str:
    """The two-track mix on two seeded stereo tracks; returns its path."""
    from nodey_tpu_torch.host.decode import write_wav_s16

    rng = np.random.default_rng(0)
    n = RATE * seconds
    t = np.arange(n, dtype=np.float64) / RATE
    paths = []
    for i in range(2):
        data = np.stack([
            0.35 * np.sin(2 * np.pi * 220.0 * (i + 1) * t)
            + 0.1 * rng.standard_normal(n),
            0.3 * rng.standard_normal(n),
        ]).astype(np.float32)
        path = os.path.join(directory, f"track_{i + 1}.wav")
        write_wav_s16(path, data, RATE)
        paths.append(path)
    with open(os.path.join(ROOT, "examples/projects/two_track_mix.json")) as f:
        project = json.load(f)
    project["nodes"]["0"]["info"]["file_path"] = paths
    path = os.path.join(directory, "two_track_mix.json")
    with open(path, "w") as f:
        json.dump(project, f)
    return path


class Client:
    """JSON requests to the served editor with its token."""

    def __init__(self, srv):
        self.port = srv.server_address[1]
        self.token = srv.viewer.auth_token

    def json(self, method: str, path: str, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=600)
        data = None if body is None else json.dumps(body).encode()
        conn.request(method, path, body=data,
                     headers={"X-Nodey-Token": self.token})
        resp = conn.getresponse()
        payload = resp.read()
        conn.close()
        if resp.status != 200:
            raise RuntimeError(f"{method} {path}: {resp.status} {payload!r}")
        return json.loads(payload)


def served_export(client: Client, out: str, poll: float):
    """One served export; returns (wall seconds, polls)."""
    t0 = time.perf_counter()
    client.json("POST", "/api/export", {"path": out})
    polls = 0
    while True:
        state = client.json("GET", "/api/state")
        polls += 1
        if state["state"] != "running":
            break
        time.sleep(poll)
    wall = time.perf_counter() - t0
    if state["state"] != "finished":
        raise RuntimeError(f"the served export ended {state}")
    return wall, polls


def cli_export(project: str, out: str, device: str) -> float:
    """The CLI's streamed export in this process; returns its wall seconds."""
    from nodey_tpu_torch.app import cli

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(["run", project, "--stream", "--export", out,
                       "--device", device])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"run --stream exited {rc}")
    return wall


def spread(values) -> str:
    return (f"{statistics.median(values):.4f} ({min(values):.4f}-"
            f"{max(values):.4f})")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seconds", type=int, default=300)
    parser.add_argument("--pairs", type=int, default=10)
    parser.add_argument("--poll", type=float, default=0.005)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        print("serve_probe: no CUDA card (pass --device cpu for a smoke run)",
              file=sys.stderr)
        return 1
    from nodey_tpu_torch.app import cli, server

    card = card_name() if args.device != "cpu" else "cpu"
    print(f"serve_probe: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; {args.seconds} s project, {args.pairs} "
          f"pairs, polls every {args.poll * 1e3:g} ms", flush=True)
    if args.device != "cpu":
        from nodey_tpu_torch.ops import _build

        _build.build_all()
    with tempfile.TemporaryDirectory() as tmp:
        project = write_project(tmp, args.seconds)
        out = os.path.join(tmp, "out.wav")
        srv = server.serve(cli._load_graph(project), "serve_probe",
                           "127.0.0.1", 0, device=args.device)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        try:
            client = Client(srv)
            wall, polls = served_export(client, out, args.poll)
            print(f"first served export of the process: {wall:.4f} s (wall "
                  f"RTF {args.seconds / wall:.1f}; {polls} polls) ({card})",
                  flush=True)
            walls = {"served": [], "cli": []}
            for k in range(args.pairs):
                order = ("served", "cli") if k % 2 == 0 else ("cli", "served")
                for side in order:
                    if side == "served":
                        wall, polls = served_export(client, out, args.poll)
                        note = f"; {polls} polls"
                    else:
                        wall, note = cli_export(project, out, args.device), ""
                    walls[side].append(wall)
                    print(f"pair {k} {side}: {wall:.4f} s (wall RTF "
                          f"{args.seconds / wall:.1f}{note}) ({card})",
                          flush=True)
        finally:
            srv.shutdown()
            srv.server_close()
            thread.join(10)
    ratios = [s / c for s, c in zip(walls["served"], walls["cli"])]
    rtf = {side: [args.seconds / w for w in ws] for side, ws in walls.items()}
    print(f"served: wall s {spread(walls['served'])}, wall RTF "
          f"{spread(rtf['served'])}; cli: wall s {spread(walls['cli'])}, "
          f"wall RTF {spread(rtf['cli'])}; served / cli wall within a pair "
          f"{spread(ratios)}, served slower in {sum(r > 1 for r in ratios)} "
          f"of {len(ratios)} pairs ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
