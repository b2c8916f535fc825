"""Sequence-parallel (sp) phase-vocoder time stretch over a mesh axis (port
of nodey_tpu.parallel.pv_sharded).

WSOLA's frame k scores against the tail chosen at frame k-1, so its sample
axis cannot shard. The phase vocoder's per-frame analysis and synthesis
are independent, and its one cross-frame coupling, the synthesis phasor,
is an associative prefix product, so it shards:

* **frames** split contiguously over sp: shard i owns frames
  [i*K_per, (i+1)*K_per) and emits exactly ``K_per * hop`` output samples;
* **input halo**: each shard's analysis windows read
  [pos(i*K_per - 1), pos((i+1)*K_per - 1) + n_fft); the worst overhang on
  either side is computed on the host from the exact 16.16 position law
  and fetched by ``halo_exchange_nd``;
* **phasor prefix across shards**: each shard reduces its local advances
  to one total rotation [C, bins], and a log2(sp)-step Hillis-Steele
  doubling over ``ppermute`` forms the exclusive cross-shard prefix
  (identity on shard 0), combined in the JAX package's order;
* **one extra left frame** per shard gives the previous analysis phase for
  the instantaneous frequency;
* **OLA tail handoff**: frames K_per-3..K_per-1 of shard i spill 3*hop
  samples into shard i+1's first rows: one ``ppermute`` and an add.

The phasor scan and its cross-shard prefix are plain torch (XLA in the
JAX package); the identity lock goes through ``pv.lock_phases``, so on a
card every shard launches the lock kernel. The output equals the offline
render up to float32 re-association of the phasor products (the offline
path folds the whole clip in one prefix, here one a shard and the
cross-shard combine).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from nodey_tpu_torch.ops import pv as pv_ops
from nodey_tpu_torch.ops.scans import mask_tail
from nodey_tpu_torch.ops.stretch import scale_length_by_num
from nodey_tpu_torch.parallel.mesh import Mesh
from nodey_tpu_torch.parallel.ops import (gather_time, halo_exchange_nd,
                                          ppermute, split_time)


@dataclasses.dataclass(frozen=True)
class PvShardPlan:
    """Static geometry for one sp-sharded PV stretch."""

    tempo: float
    rate: int
    n_fft: int
    hop: int
    num: int          # analysis-hop numerator (16.16), pv_hop_num
    num_t: int        # round(tempo * 65536): the output-length law
    sp: int
    capacity: int     # global input capacity (sp * chunk_in)
    chunk_in: int     # input samples per shard
    k_per: int        # frames owned per shard
    left: int         # input halo, samples
    right: int

    @property
    def out_chunk(self) -> int:
        return self.k_per * self.hop

    @property
    def out_capacity(self) -> int:
        return self.sp * self.out_chunk


def _pos(k, num: int):
    """The 16.16 analysis position of frame(s) k (host int64)."""
    return (np.asarray(k, dtype=np.int64) * num + 32768) >> 16


def plan_pv_sharded(tempo: float, rate: int, capacity: int,
                    sp: int, k_per_align: int = 1) -> PvShardPlan:
    """Frame/halo decomposition for stretching a [C, capacity] clip by
    ``tempo`` over ``sp`` time shards.

    ``capacity`` must be a multiple of ``sp`` (``pv_sharded_capacity``).
    K_per = ceil(K_offline / sp), so every shard runs the same program.
    The halos are the exact worst case of the 16.16 law over every shard
    boundary. ``k_per_align`` rounds K_per UP to a multiple (the chain
    planner makes the output chunk divisible by a later stage's quantum);
    frames past the offline count land at or beyond the masked length."""
    if capacity % sp:
        raise ValueError(f"capacity {capacity} not divisible by sp={sp}")
    n_fft, hop = pv_ops.pv_params(rate)
    num = pv_ops.pv_hop_num(hop, tempo)
    chunk_in = capacity // sp

    out_cap = int(math.ceil(capacity / tempo)) + hop
    k_off = max(2, -(-out_cap // hop) + 1)
    k_per = -(-k_off // sp)
    if k_per_align > 1:
        k_per = -(-max(k_per, 3) // k_per_align) * k_per_align
    if k_per < 3:
        # The OLA tail spans 3 rows; k_per >= 3 keeps its spill within one
        # neighbor. Tiny clips should use fewer shards.
        raise ValueError(
            f"clip too short for sp={sp}: {k_per} frames/shard < 3"
        )
    left = right = 0
    for i in range(sp):
        left = max(left, i * chunk_in - int(_pos(max(i * k_per - 1, 0), num)))
        right = max(right, int(_pos((i + 1) * k_per - 1, num)) + n_fft
                    - (i + 1) * chunk_in)
    return PvShardPlan(
        tempo=float(tempo), rate=int(rate), n_fft=n_fft, hop=hop, num=num,
        num_t=int(round(tempo * 65536)), sp=sp, capacity=capacity,
        chunk_in=chunk_in, k_per=k_per, left=left, right=max(right, 0),
    )


def pv_sharded_capacity(length: int, sp: int) -> int:
    """Smallest capacity >= length divisible by sp."""
    return -(-max(length, 1) // sp) * sp


def _cmul(a, b):
    return (a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0])


def _cross_shard_exclusive_phasor(tcs: Sequence[torch.Tensor],
                                  tss: Sequence[torch.Tensor], trs=None):
    """Exclusive prefix product of the shards' total rotations.

    Hillis-Steele doubling over ``ppermute``: after the inclusive pass,
    shard i holds prod_{m<=i} T_m (the received, earlier product the left
    operand); one final shift makes it exclusive (identity on shard 0).
    ``ppermute`` gives zeros to shards no pair addresses, which is not the
    identity rotation, so a shard combines at step d only if its index is
    >= d.

    With ``trs`` (each shard's "holds a transient reset" flags) the combine
    is segmented: a shard whose rotation is post-reset ABSOLUTE discards
    what it receives from the left, and the exclusive flags come back
    too."""
    sp = len(tcs)
    vc, vs = list(tcs), list(tss)
    vr = None if trs is None else list(trs)
    d = 1
    while d < sp:
        perm = [(m, m + d) for m in range(sp - d)]
        rc, rs = ppermute(vc, perm), ppermute(vs, perm)
        rr = None if vr is None else ppermute(vr, perm)
        for i in range(d, sp):
            nc, ns = _cmul((rc[i], rs[i]), (vc[i], vs[i]))
            if vr is not None:
                nc = torch.where(vr[i], vc[i], nc)
                ns = torch.where(vr[i], vs[i], ns)
                vr[i] = vr[i] | rr[i]
            vc[i], vs[i] = nc, ns
        d *= 2
    perm1 = [(m, m + 1) for m in range(sp - 1)]
    ec, es = ppermute(vc, perm1), ppermute(vs, perm1)
    ec[0] = torch.ones_like(ec[0])
    es[0] = torch.zeros_like(es[0])
    if trs is None:
        return ec, es
    er = ppermute(vr, perm1)
    er[0] = torch.zeros_like(er[0])
    return ec, es, er


def pv_sharded_local_step(plan: PvShardPlan, xs: Sequence[torch.Tensor],
                          length: int, lock: bool = True,
                          transient: bool = False,
                          formant_ratio: float = 1.0):
    """The sharded stretch's body over the shards of one mesh axis:
    ``xs[i]`` is shard i's input chunk [C, chunk_in] (zero past the global
    valid ``length``, a host int). Returns (the shards' outputs [C,
    k_per*hop] each, the global output length). Exposed beside
    :func:`pv_stretch_sharded` so the chain compiler can put it between
    other stages."""
    n_fft, hop, K = plan.n_fft, plan.hop, plan.k_per
    sp = len(xs)
    exts = halo_exchange_nd(xs, plan.left, plan.right)

    pc_all, ps_all, pr_all, keep = [], [], [], []
    for i, ext in enumerate(exts):
        device = ext.device
        w, cos_m, sin_m = pv_ops._bases(n_fft, device)[:3]
        omega_hop, _ = pv_ops._stream_tables(n_fft, device)
        # The K owned frames plus one before them (the instantaneous
        # frequency's context; shard 0's is masked by the seed).
        ks = i * K - 1 + np.arange(K + 1, dtype=np.int64)
        pos = _pos(np.maximum(ks, 0), plan.num)
        # ext index 0 is global sample i*chunk_in - left.
        rel = np.clip(pos - (i * plan.chunk_in - plan.left), 0,
                      ext.shape[-1] - n_fft)
        dpos = np.maximum(pos[1:] - pos[:-1], 1)
        rel_t, dpos_t, hop_over_dpos = pv_ops._frame_tables(
            rel, np.concatenate([[1], dpos]), hop, device)
        frames = ext.unfold(1, n_fft, 1)[:, rel_t] * w     # [C, K+1, n_fft]
        mag_all, ph_all = pv_ops._magnitude_phase(
            torch.matmul(frames, cos_m), torch.matmul(frames, sin_m))
        del frames
        # Contiguous: the lock kernel takes whole planes.
        mag, ph = mag_all[:, 1:].contiguous(), ph_all[:, 1:].contiguous()
        if formant_ratio != 1.0:
            # Detection reads the raw magnitudes; locking and synthesis
            # the pre-warped ones.
            mag = pv_ops._formant_correction(mag, n_fft, formant_ratio)
        adv = pv_ops._advance_on(ph_all[:, 1:] - ph_all[:, :-1], dpos_t[1:],
                                 hop_over_dpos[1:], omega_hop, n_fft)
        if i == 0:
            # Global frame 0 seeds the chain with its own analysis phase.
            adv[:, 0] = ph[:, 0]
        reset = None
        if transient:
            reset = pv_ops.transient_resets(mag_all[:, :-1], mag_all[:, 1:])
            if i == 0:
                reset[:, 0] = False
            reset = reset[..., None]
            adv = torch.where(reset, ph, adv)
        ca, sa = torch.cos(adv), torch.sin(adv)
        del adv
        if reset is None:
            pc, ps = pv_ops._prefix_product(ca, sa)
            pr = None
        else:
            pc, ps, pr = pv_ops._prefix_product(ca, sa, reset)
        pc_all.append(pc)
        ps_all.append(ps)
        pr_all.append(pr)
        keep.append((ph, mag))

    if transient:
        ec, es, _er = _cross_shard_exclusive_phasor(
            [p[:, -1, :] for p in pc_all], [p[:, -1, :] for p in ps_all],
            [p[:, -1, :] for p in pr_all])
    else:
        ec, es = _cross_shard_exclusive_phasor(
            [p[:, -1, :] for p in pc_all], [p[:, -1, :] for p in ps_all])

    out_total = scale_length_by_num(length, plan.num_t)
    accs = []
    for i in range(sp):
        pc, ps, pr = pc_all[i], ps_all[i], pr_all[i]
        pc_all[i] = ps_all[i] = None
        ph, mag = keep[i]
        keep[i] = None
        ecb, esb = ec[i][:, None, :], es[i][:, None, :]
        cos_phi = ecb * pc - esb * ps
        sin_phi = ecb * ps + esb * pc
        if pr is not None:
            cos_phi = torch.where(pr, pc, cos_phi)
            sin_phi = torch.where(pr, ps, sin_phi)
        del pc, ps, pr
        if lock:
            cos_phi, sin_phi = pv_ops.lock_phases(cos_phi, sin_phi, ph, mag)
        w, _, _, icos, isin = pv_ops._bases(n_fft, mag.device)
        y = (torch.matmul(mag * cos_phi, icos)
             + torch.matmul(mag * sin_phi, isin)) * w
        del cos_phi, sin_phi, ph, mag
        # Local OLA of K frames over K+3 rows; the 3-row tail spills into
        # the right neighbor.
        y4 = y.reshape(y.shape[0], K, 4, hop)
        acc = None
        for j in range(4):
            part = F.pad(y4[:, :, j, :], (0, 0, j, 3 - j))
            acc = part if acc is None else acc + part   # [C, K+3, hop]
        accs.append(acc.reshape(acc.shape[0], (K + 3) * hop))
        del y, y4
    recv = ppermute([a[:, K * hop:] for a in accs],
                    [(m, m + 1) for m in range(sp - 1)])
    outs = []
    for i, acc in enumerate(accs):
        out = acc[:, :K * hop].clone()
        out[:, :3 * hop] += recv[i]
        # Coverage: start partials only in global rows 0..2, every other
        # emitted row the full sum (the trimmed output never reaches the
        # end ramp).
        _, P1 = pv_ops._stream_tables(n_fft, out.device)
        rows = out.view(out.shape[0], K, hop)
        if i == 0:
            rows[:, :3] /= P1[:3]
            rows[:, 3:] /= P1[3]
        else:
            rows /= P1[3]
        outs.append(mask_tail(out, out_total - i * K * hop))
    del accs, recv
    return outs, out_total


def pv_stretch_sharded(mesh: Mesh, data, length: int, tempo: float,
                       rate: int, sp_axis: str = "sp", lock: bool = True,
                       transient: bool = False, formant_ratio: float = 1.0):
    """Stretch [C, capacity] by ``tempo`` with the time axis sharded over
    ``sp_axis``; returns (out [C, out_capacity] on the mesh's first
    device, out_len). ``data`` must be zero past ``length``, its capacity
    divisible by the sp size (``pv_sharded_capacity``)."""
    data = torch.as_tensor(data)
    sp = mesh.shape[sp_axis]
    plan = plan_pv_sharded(tempo, rate, int(data.shape[-1]), sp)
    outs, out_len = pv_sharded_local_step(
        plan, split_time(data, mesh.axis_devices(sp_axis)), int(length),
        lock=lock, transient=transient, formant_ratio=formant_ratio)
    return gather_time(outs, mesh.devices.flat[0]), out_len
