"""A mesh across a process boundary (port of nodey_tpu.parallel.dcn).

The sharded programs of parallel/sharded.py run every shard of a mesh from
one process. This module runs one mesh from several: N processes join one
``torch.distributed`` group over gloo, each owns K shards (virtual: K
shards of its one device), and together they form ONE global sp mesh of
N * K shards, shard s in process s // K. The dry run renders the JAX
package's 5-node LTI graph (two inputs, gain 1.5, amix 0.6 / 0.4 with the
44.1 -> 48 kHz resampler) with the sample axis sharded across the process
boundary, so the resampler's halo exchange crosses processes.

The collectives between processes (``DistPermute``, ``dist_psum``):

* a halo pair inside a process stays the local ``ppermute`` (a device
  copy, none on a virtual mesh);
* a pair that crosses processes moves by ``dist.isend`` / ``dist.irecv`` of
  a contiguous host tensor: gloo sends and receives CPU tensors only, so a
  halo on a card is staged through host memory (NCCL would move card
  memory, but it refuses two processes on one card);
* a global length is ``dist.all_reduce`` of a host int64;
* the processes meet at a ``dist.barrier()`` before they exit, so a
  process that fails late is not lost.

Each process checks its own shards: against the single render of the same
graph, and against the one-process sp render over the same N * K windows.
``launch_dcn_dryrun`` starts the processes and raises with each failing
one's exit code and the tail of its output. Nothing falls back to one
process when the group does not form.
"""

from __future__ import annotations

import datetime
import json
import os
import socket
import subprocess
import sys
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

# The launcher hands each process its identity in this environment
# variable, so the child stays a bare ``python -c`` with no arguments.
_ENV_SPEC = "NODEY_DCN_SPEC"


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def child_main() -> None:
    """Entry point executed inside each spawned process."""
    import torch.distributed as dist

    spec = json.loads(os.environ[_ENV_SPEC])
    dist.init_process_group(
        "gloo", init_method=f"tcp://{spec['coordinator']}",
        world_size=spec["num_processes"], rank=spec["process_id"],
        timeout=datetime.timedelta(seconds=spec["timeout"]))
    try:
        report = _run_dcn_step(num_processes=spec["num_processes"],
                               local_devices=spec["local_devices"],
                               device=spec["device"])
        print("DCN_REPORT " + json.dumps(report), flush=True)
    finally:
        dist.destroy_process_group()


class DistPermute:
    """``ppermute`` over a mesh of ``world * local`` shards spread over the
    processes of the default group, process r holding shards [r * local,
    (r + 1) * local): called with the global list of segments (``None``
    where another process holds the shard), it returns this process's
    received segments (``None`` elsewhere). Counts the bytes it sends."""

    def __init__(self, rank: int, local: int):
        self.rank = rank
        self.local = local
        self.bytes_sent = 0
        self._tag = 0

    def _mine(self, shard: int) -> bool:
        return shard // self.local == self.rank

    def __call__(self, xs: Sequence[Optional[torch.Tensor]],
                 perm: Sequence[Tuple[int, int]]
                 ) -> List[Optional[torch.Tensor]]:
        import torch.distributed as dist

        from nodey_tpu_torch.parallel.ops import to_device

        out: List[Optional[torch.Tensor]] = [
            None if x is None else torch.zeros_like(x) for x in xs]
        work, received = [], []
        for src, dst in perm:
            tag = self._tag
            self._tag += 1
            if self._mine(src) and self._mine(dst):
                out[dst] = to_device(xs[src], xs[dst].device)
            elif self._mine(src):
                host = xs[src].detach().to("cpu").contiguous()
                work.append((dist.isend(host, dst // self.local, tag=tag),
                             host))
                self.bytes_sent += host.numel() * host.element_size()
            elif self._mine(dst):
                host = torch.empty(xs[dst].shape, dtype=xs[dst].dtype)
                work.append((dist.irecv(host, src // self.local, tag=tag),
                             host))
                received.append((dst, host))
        for request, _buffer in work:
            request.wait()
        for dst, host in received:
            out[dst] = to_device(host, xs[dst].device)
        return out


def dist_psum(values: Sequence[int]) -> int:
    """The sum over every process of its shards' host ints."""
    import torch.distributed as dist

    total = torch.tensor([sum(int(v) for v in values)], dtype=torch.int64)
    dist.all_reduce(total)
    return int(total.item())


def _dryrun_graph():
    """The JAX dry run's 5-node LTI graph (input x2 -> gain 1.5 -> amix
    0.6 / 0.4 at 48 kHz -> output): the amix path's 44.1 -> 48 kHz
    resampler needs halo samples from the neighbouring sp shard. Returns
    (graph, the input node's id)."""
    from nodey_tpu_torch.core import registry
    from nodey_tpu_torch.core.graph import Graph
    from nodey_tpu_torch.processors.amix import AudioAmix
    from nodey_tpu_torch.processors.audio_input import AudioInput
    from nodey_tpu_torch.processors.audio_output import AudioOutput
    from nodey_tpu_torch.processors.audio_vol import AudioVol

    registry.register_all_processors()
    g = Graph()
    src = g.add_node(AudioInput())
    g.nodes[src].processor.file_paths = ["a.wav", "b.wav"]
    g.update_node_pin(src)
    vol = g.add_node(AudioVol())
    g.nodes[vol].processor.set_volume(1.5)
    amix = g.add_node(AudioAmix())
    g.nodes[amix].processor.set_input_num(2)
    g.nodes[amix].processor.volumes = [0.6, 0.4]
    out = g.add_node(AudioOutput())

    def pin(n, p):
        return g.nodes[n].pin_name_map[p]

    g.add_link(pin(src, "output_0"), pin(vol, "input"))
    g.add_link(pin(vol, "output"), pin(amix, "input_1"))
    g.add_link(pin(src, "output_1"), pin(amix, "input_2"))
    g.add_link(pin(amix, "output"), pin(out, "input"))
    return g, src


def _dryrun_inputs(graph, src: int, mesh, seconds: float = 0.5):
    """(sources, arrays, lengths): the dry run's two inputs, 0.3 x standard
    normal from seed 7 (the same in every process), padded to the mesh's
    shard-aligned capacity."""
    from nodey_tpu_torch.core import compiler
    from nodey_tpu_torch.parallel import sharded

    rate, channels = 44_100, 2
    n = int(rate * seconds)
    capacity = sharded.plan_capacity_for(graph, rate, n, mesh)
    sources = {(src, f"output_{i}"): compiler.SourceSpec(
        rate, channels, "flt", capacity) for i in range(2)}
    rng = np.random.default_rng(7)
    arrays, lengths = {}, {}
    for key in sorted(compiler.external_key(*k) for k in sources):
        x = np.zeros((channels, capacity), dtype=np.float32)
        x[:, :n] = 0.3 * rng.standard_normal((channels, n))
        arrays[key] = x
        lengths[key] = n
    return sources, arrays, lengths


def _run_dcn_step(num_processes: int, local_devices: int,
                  device: str = "cuda") -> dict:
    """One sharded step over the global (cross-process) mesh; this
    process's shards checked against the single render and against the
    one-process sp render of the same windows. Returns this process's
    report: its shards, their agreement, the bytes it sent, the wall
    seconds of the first step and of a second (warm) one, and every kernel
    wrapper's launches in the first step (``ops.launch_counts``' names)."""
    import torch.distributed as dist

    from nodey_tpu_torch.core import compiler
    from nodey_tpu_torch.ops import launch_counts
    from nodey_tpu_torch.parallel import sharded
    from nodey_tpu_torch.parallel.mesh import make_mesh

    rank = dist.get_rank()
    if dist.get_world_size() != num_processes:
        raise RuntimeError(f"the group has {dist.get_world_size()} "
                           f"processes, the spec {num_processes}")
    n_global = num_processes * local_devices
    dev = compiler.resolve_device(device)
    mesh = make_mesh({"sp": n_global}, [dev] * n_global)
    g, src = _dryrun_graph()
    sources, arrays, lengths = _dryrun_inputs(g, src, mesh)
    sc = sharded.compile_graph_sharded(g, sources, mesh, mode="export")
    data = {k: torch.from_numpy(v) for k, v in arrays.items()}
    lens = {k: (v,) for k, v in lengths.items()}
    mine = range(rank * local_devices, (rank + 1) * local_devices)
    devices = [dev if s in mine else None for s in range(n_global)]
    permute = DistPermute(rank, local_devices)

    def step():
        dist.barrier()
        t0 = time.perf_counter()
        out = sc._row(data, lens, devices, permute=permute, psum=dist_psum)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t0

    # The first step (cold: the window program's first run) is the one
    # checked and counted; a second, warm one is timed and must repeat it.
    before = launch_counts()
    (pieces, out_lens), seconds = step()
    launches = {name: count - before[name]
                for name, count in launch_counts().items()}
    bytes_sent = permute.bytes_sent
    (again, _), warm_seconds = step()
    master = pieces["master"]
    out_len = out_lens["master"]
    if not all(torch.equal(a, b) for a, b in zip(master, again["master"])):
        raise AssertionError(f"process {rank}: a second step differs")

    # The single render, and the one-process sp render of the same windows.
    single = compiler.compile_graph(g, sources, mode="export", device=dev)
    ref, _ = single({k: (v.to(dev), lengths[k]) for k, v in data.items()})
    ref_master, ref_len = ref["master"]
    local_sp, _ = sc.run_rows(arrays, lengths)
    if out_len != ref_len:
        raise AssertionError(f"process {rank}: length {out_len}, the single "
                             f"render's {ref_len}")
    chunk = ref_master.shape[-1] // n_global
    worst_single = worst_sp = 0.0
    bitwise_single = bitwise_sp = True
    for s, got in zip(mine, master):
        if not torch.isfinite(got).all():
            raise AssertionError(f"process {rank}: shard {s} not finite")
        t0_s = s * chunk
        valid = max(0, min(got.shape[-1], out_len - t0_s))
        want = ref_master[..., t0_s:t0_s + valid]
        sp_want = local_sp[0]["master"][s][..., :valid]
        bitwise_single &= bool(torch.equal(got[..., :valid], want))
        bitwise_sp &= bool(torch.equal(got[..., :valid], sp_want))
        worst_single = max(worst_single,
                           (got[..., :valid] - want).abs().max().item()
                           if valid else 0.0)
        worst_sp = max(worst_sp, (got[..., :valid] - sp_want).abs().max()
                       .item() if valid else 0.0)
    # Every process agrees before exiting (a process that fails after the
    # others exit would otherwise be lost).
    dist.barrier()
    return {"rank": rank, "shards": list(mine), "device": str(dev),
            "length": out_len, "bitwise_single": bitwise_single,
            "max_abs_single": worst_single, "bitwise_sp": bitwise_sp,
            "max_abs_sp": worst_sp, "bytes_sent": bytes_sent,
            "seconds": seconds, "warm_seconds": warm_seconds,
            "launches": launches}


def launch_dcn_dryrun(
    num_processes: int = 2,
    local_devices: int = 2,
    timeout: float = 300.0,
    extra_env: Optional[dict] = None,
    device: str = "cuda",
) -> List[dict]:
    """Spawn the N-process dry run on ``device`` (each process's K shards
    on it) and raise if any process fails or runs into ``timeout``.
    Returns each process's report (``_run_dcn_step``), in rank order."""
    port = _free_port()
    procs: List[subprocess.Popen] = []
    repo_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    for pid in range(num_processes):
        env = dict(os.environ)
        env.update(extra_env or {})
        env[_ENV_SPEC] = json.dumps({
            "coordinator": f"127.0.0.1:{port}",
            "num_processes": num_processes,
            "process_id": pid,
            "local_devices": local_devices,
            "device": device,
            "timeout": timeout,
        })
        procs.append(subprocess.Popen(
            [sys.executable, "-c",
             "from nodey_tpu_torch.parallel.dcn import child_main; "
             "child_main()"],
            cwd=repo_root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    failures, reports = [], []
    for pid, proc in enumerate(procs):
        try:
            out, _ = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            failures.append((pid, "timeout", out))
            continue
        if proc.returncode != 0:
            failures.append((pid, f"rc={proc.returncode}", out))
            continue
        text = (out or b"").decode(errors="replace")
        lines = [line for line in text.splitlines()
                 if line.startswith("DCN_REPORT ")]
        if not lines:
            failures.append((pid, "no report", out))
            continue
        reports.append(json.loads(lines[-1][len("DCN_REPORT "):]))
    if failures:
        msgs = "\n".join(
            f"-- process {pid} ({why}):\n"
            f"{(out or b'').decode(errors='replace')[-2000:]}"
            for pid, why, out in failures)
        raise RuntimeError(f"DCN dryrun failed:\n{msgs}")
    return reports
