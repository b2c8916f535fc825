"""The port's dp x sp x tp composition (nodey_tpu_torch/parallel/
dp_sp_tp.py) against the JAX package's single-device pipeline, on the CPU.

On a mesh of dp 2 x sp 2 x tp 2 (``["cpu"] * 8``) with 2 clips a dp
shard, each clip of different scale and length: stage 1 (the 5-node graph
over dp x sp) is bitwise the single render, and stage 2 (the reverb over
tp) equals the unsharded convolution to float32 rounding, so each clip
must meet the JAX ``reference_pipeline`` at tests/test_dp_sp_tp.py's bar:
>= 130 dB, max-abs <= 1e-6 of the peak, and an equal valid length. The
port's own ``reference_pipeline`` meets the JAX one at the same bar.
"""

import dataclasses

import numpy as np

from conftest import snr_db
from nodey_tpu.parallel import dp_sp_tp as jdst
from nodey_tpu.parallel.mesh import make_mesh as jmake_mesh
from nodey_tpu_torch.convert import graph_from_jax
from nodey_tpu_torch.core import compiler
from nodey_tpu_torch.parallel import dp_sp_tp
from nodey_tpu_torch.parallel.mesh import make_mesh
from test_sharded_graph import _flagship, _sources_and_args
from test_torch_effects import one_torch_thread  # noqa: F401 (autouse)

SNR_DB = 130.0
PEAK_REL = 1e-6
AXES = {"dp": 2, "sp": 2, "tp": 2}


def _agrees(want, got) -> bool:
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return (snr_db(want, got) >= SNR_DB
            and np.abs(want - got).max()
            <= PEAK_REL * max(np.abs(want).max(), 1e-9))


def test_dp_sp_tp_meets_the_jax_single_device_pipeline():
    g, src = _flagship()
    arrays, lengths, jsources = _sources_and_args(g, src, jmake_mesh(AXES))
    sources = {k: compiler.SourceSpec(**dataclasses.asdict(v))
               for k, v in jsources.items()}
    pg = graph_from_jax(g)
    prog = dp_sp_tp.compile_flagship_reverb_dpsptp(
        pg, sources, make_mesh(AXES, ["cpu"] * 8))
    assert prog.cap_out > prog.cap_master
    batch = AXES["dp"] * 2

    clips, barrays, blengths = [], {}, {}
    for b in range(batch):
        clip, clip_lens = {}, {}
        for key in arrays:
            a = ((1.0 - 0.1 * b) * arrays[key]).astype(np.float32)
            n = max(1, lengths[key] - 1000 * b)
            a[:, n:] = 0.0
            clip[key], clip_lens[key] = a, n
            barrays.setdefault(key, []).append(a)
            blengths.setdefault(key, []).append(n)
        clips.append((clip, clip_lens))
    out, glen = prog.run({k: np.stack(v) for k, v in barrays.items()},
                         blengths)
    assert out.shape == (batch, 2, prog.cap_out)
    assert out.isfinite().all()

    for b, (clip, clip_lens) in enumerate(clips):
        want, want_len = jdst.reference_pipeline(
            g, jsources, clip, clip_lens, prog.cap_master, prog.cap_out,
            prog.out_rate)
        assert glen[b] == want_len, b
        assert _agrees(want, out[b].numpy()), b
        if b == 0:
            mine, mine_len = dp_sp_tp.reference_pipeline(
                pg, sources, clip, clip_lens, prog.cap_master, prog.cap_out,
                prog.out_rate, device="cpu")
            assert mine_len == want_len
            assert _agrees(want, mine.numpy())
