"""Chunk-streaming primitives: device FIFOs and stateful op steps (port of
nodey_tpu.ops.chunkops).

The reference streams audio as chains of small frames through bounded
per-edge channels (include/processor/audio-stream.hpp:46-83), so memory
stays bounded for any clip length. Here every stateful node owns a small
device FIFO, carried from one chunk step to the next.

A FIFO is ``FifoState(buf [C, cap] float32, level)`` with ``buf[:, level:]``
zero. Consuming reads a fixed-width window from the front (real lookahead
samples included) and advances; samples past ``level`` read as zeros, which
reproduces the reference's drained-resampler silence for inputs that end
early (src/processor/audio-amix.cpp:279-291).

**Counts are host ints.** Every count of these steps (a FIFO's ``level``,
``take``, ``out_n``, ``k_done``, the WSOLA frame bounds, ``consumed``,
``in_len``, ``first``, ``done``) depends only on how many samples have
arrived, never on the audio. The JAX package traces them as int32 because
its chunk step is one jitted program; here they are Python ints, so a chunk
step makes no device-to-host sync. The only value that depends on the
audio is the WSOLA splice, and through it the tail the next step starts
from: it stays on the device (the chain's ``tail_out``). FIFOs and the
chunks a step hands on keep their planned widths from step to step.

**FIFOs are updated in place** (``fifo_push`` and ``fifo_advance`` write
into ``buf``); every output a step hands on is a fresh tensor, never a view
of a FIFO.

The steps call the port's ops, so the same kernels run as offline: the
polyphase resampler through ``resample.apply_filter_bank``, the spectrum
through ``stft.magnitude_spectrogram``, the WSOLA chain through
``wsola.wsola_chunk_chain`` (the CUDA chain kernel's chunk entry on the
card). The plans' ``out_cap``, ``k_cap`` and ``quant`` equal the JAX
package's; the WSOLA FIFO drops the JAX plan's ``chunk_window_extra``
lane slack, which only the TPU kernel's 128-lane DMA windows read.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from nodey_tpu_torch.core.errors import LogicError
from nodey_tpu_torch.ops import resample as resample_ops
from nodey_tpu_torch.ops import stft as stft_ops
from nodey_tpu_torch.ops import stretch as stretch_ops
from nodey_tpu_torch.ops import wsola
from nodey_tpu_torch.ops.wsola import frame_pos


# -- FIFO ---------------------------------------------------------------------


class FifoState(NamedTuple):
    """Device FIFO carry: ``buf`` [C, cap] float32 (zero past ``level``)
    and the host int ``level``. A NamedTuple so the streaming compiler can
    find every FIFO in a node's state and report its fill."""

    buf: torch.Tensor
    level: int


def fifo_init(channels: int, cap: int, device) -> FifoState:
    """Empty FIFO. ``cap`` must bound level + any single push."""
    return FifoState(torch.zeros((channels, cap), dtype=torch.float32,
                                 device=device), 0)


def fifo_prefill(channels: int, cap: int, zeros: int, device) -> FifoState:
    """FIFO pre-loaded with ``zeros`` samples of silence (left context)."""
    return FifoState(torch.zeros((channels, cap), dtype=torch.float32,
                                 device=device), zeros)


def fifo_push(state: FifoState, data: torch.Tensor, n: int) -> FifoState:
    """Append ``data[:, :n]`` in place."""
    buf, level = state
    if level + n > buf.shape[1]:
        raise LogicError(
            f"FIFO overflow: level {level} + push {n} > capacity {buf.shape[1]}"
        )
    if n:
        buf[:, level : level + n] = data[:, :n]
    return FifoState(buf, level + n)


def fifo_window(state: FifoState, width: int) -> torch.Tensor:
    """The first ``width`` columns (zeros past level): a view of ``buf``."""
    return state.buf[:, :width]


def fifo_advance(state: FifoState, take: int) -> FifoState:
    """Drop ``take`` samples from the front in place, re-zeroing the tail."""
    buf, level = state
    new_level = max(level - take, 0)
    if new_level:
        buf[:, :new_level] = buf[:, take:level].clone()
    if level > new_level:
        buf[:, new_level:level] = 0.0
    return FifoState(buf, new_level)


def round_up(n: int, q: int) -> int:
    return -(-n // q) * q


# -- streaming polyphase resampler --------------------------------------------


class ResamplePlan(NamedTuple):
    """Static geometry of one streaming rational resampler, and its filter
    bank and the bank's tap support on the device (put there at plan time,
    so no step copies from the host)."""

    L: int
    M: int
    taps: int
    left_ctx: int      # taps//2 - 1 (the offline left zero-pad)
    right_ctx: int     # W - M lookahead past the consumed segment
    push_cap: int      # max input samples pushed per step
    take_cap: int      # max input samples consumed per step (multiple of quant)
    cap: int           # FIFO capacity
    out_cap: int       # take_cap * L // M
    quant: int         # consumption quantum M * group_factor (phase unit)
    W: int             # window width of one output group
    bank: torch.Tensor  # [L, W] float32 on the stage's device
    support: resample_ops.BankSupport  # what the CUDA kernel reads
    in_rate: int       # the original (unreduced) rate pair: a compat
    out_rate: int      # bank is measured per pair
    compat: Optional[str] = None   # resolved bank mode (None | 'swr')


def resample_plan(in_rate: int, out_rate: int, push_cap: int,
                  device, compat=None) -> ResamplePlan:
    L, M = resample_ops._rational(in_rate, out_rate)
    # Resolved here, at plan time, so no step can change banks mid-stream.
    compat = resample_ops.resolve_compat(compat)
    _bank, left_ctx, W = resample_ops.bank_spec(in_rate, out_rate, compat)
    taps = W - M + 1
    # Consume in multiples of M * group_factor, so every step's first group
    # sits at a global cycle phase of 0 mod R, as in the offline grouped
    # GEMM of the plain version (the kernel computes each output alone).
    quant = M * resample_ops.group_factor(L, M)
    take_cap = round_up(push_cap, quant) + quant
    right_ctx = W - M
    bank, support = resample_ops._device_bank(in_rate, out_rate, device,
                                              compat)
    return ResamplePlan(
        L=L, M=M, taps=taps, left_ctx=left_ctx, right_ctx=right_ctx,
        push_cap=push_cap, take_cap=take_cap,
        cap=left_ctx + right_ctx + quant + push_cap + take_cap,
        out_cap=take_cap * L // M, quant=quant, W=W, bank=bank,
        support=support, in_rate=in_rate, out_rate=out_rate, compat=compat,
    )


def resample_stream_init(plan: ResamplePlan, channels: int,
                         device) -> FifoState:
    """A FIFO prefilled with the offline left zero-pad."""
    return fifo_prefill(channels, plan.cap, plan.left_ctx, device)


def resample_stream_step(plan: ResamplePlan, state: FifoState,
                         data: torch.Tensor, n: int, done: bool):
    """Push ``data[:, :n]``, then consume as much M-aligned input as the
    lookahead allows (everything, zero-padded, once ``done``).

    Returns ``(state, out [C, out_cap], out_n, out_done)``. The output
    equals the offline ``resample_data`` of the concatenated input: the
    same windows through the same bank (on the card the same kernel, which
    sums each output alone; on the CPU the grouped GEMM, whose sums may
    associate otherwise at another batch geometry, within 3e-7)."""
    L, M, quant = plan.L, plan.M, plan.quant
    state = fifo_push(state, data, n)
    avail = state.level - plan.left_ctx  # unconsumed input samples
    if done:
        take = min(max(-(-avail // quant) * quant, 0), plan.take_cap)
        out_n = (avail // M) * L + ((avail % M) * L + M - 1) // M
        out_n = min(max(out_n, 0), plan.out_cap)
    else:
        take = min(max((avail - plan.right_ctx) // quant * quant, 0),
                   plan.take_cap)
        out_n = take * L // M
    window = fifo_window(state, plan.left_ctx + plan.take_cap + plan.W)
    out = resample_ops.apply_filter_bank(window.contiguous(),
                                         plan.take_cap // M, M, plan.W,
                                         plan.bank, plan.support)  # fresh
    out[:, out_n:] = 0.0
    state = fifo_advance(state, take)
    out_done = done and state.level - plan.left_ctx <= 0
    return state, out, out_n, out_done


# -- streaming STFT spectrum ---------------------------------------------------


class StftPlan(NamedTuple):
    n_fft: int
    hop: int
    push_cap: int
    frames_cap: int
    cap: int


def stft_plan(n_fft: int, hop: int, push_cap: int) -> StftPlan:
    frames_cap = push_cap // hop + 2
    return StftPlan(n_fft=n_fft, hop=hop, push_cap=push_cap,
                    frames_cap=frames_cap,
                    cap=n_fft + push_cap + frames_cap * hop)


def stft_stream_init(plan: StftPlan, channels: int, device) -> FifoState:
    """An empty FIFO; also puts the DFT basis (or the rfft window) on the
    device, so no step copies from the host."""
    stft_ops.device_constants(plan.n_fft, torch.device(device))
    return fifo_init(channels, plan.cap, device)


class _WindowStream:
    """What ``magnitude_spectrogram`` reads of a stream: its data."""

    def __init__(self, data: torch.Tensor):
        self.data = data


def stft_stream_step(plan: StftPlan, state: FifoState, data: torch.Tensor,
                     n: int, done: bool):
    """Emit the STFT frames whose windows have filled.

    Offline framing computes the frames whose whole n_fft window lies inside
    the clip; streaming emits a frame once n_fft samples from its
    hop-aligned start are buffered, never zero-padded tails, so the
    concatenated frames are the offline frame set. Returns ``(state, spec
    [C, frames_cap, bins], frames, out_done)``."""
    n_fft, hop = plan.n_fft, plan.hop
    state = fifo_push(state, data, n)
    frames = min(max((state.level - n_fft) // hop + 1, 0), plan.frames_cap)
    window = fifo_window(state, plan.frames_cap * hop + n_fft)
    spec = stft_ops.magnitude_spectrogram(
        _WindowStream(window), n_fft=n_fft, hop=hop)[:, : plan.frames_cap, :]
    spec[:, frames:, :] = 0.0
    state = fifo_advance(state, frames * hop)
    out_done = done and (state.level - n_fft) // hop + 1 <= 0
    return state, spec, frames, out_done


# -- streaming WSOLA -----------------------------------------------------------


class WsolaPlan(NamedTuple):
    seq: int
    seek: int
    overlap: int
    stride_out: int
    num: int           # input step numerator: pos(k) = (k*num + den//2)//den
    num_t: int         # round(tempo * 65536), the output-length scale
    den: int
    push_cap: int
    k_cap: int         # frames processed per step at most
    window: int        # input window needed by k_cap frames
    cap: int
    out_cap: int       # overlap + k_cap * stride_out


def wsola_plan(tempo: float, rate: int, push_cap: int) -> WsolaPlan:
    seq, seek, overlap = stretch_ops._params(rate)
    stride_out = seq - overlap
    num = int(round(stride_out * tempo * 65536))
    den = 65536
    # Enough frames per step to keep up with the push rate, with slack so a
    # drained FIFO catches up after EOF.
    k_cap = max(1, int(math.ceil(push_cap * den / num)) + 2)
    window = (k_cap - 1) * num // den + seek + seq + 2
    return WsolaPlan(
        seq=seq, seek=seek, overlap=overlap, stride_out=stride_out,
        num=num, num_t=int(round(tempo * 65536)), den=den,
        push_cap=push_cap, k_cap=k_cap, window=window,
        cap=window + push_cap + num // den + 2,
        out_cap=overlap + k_cap * stride_out,
    )


class WsolaState(NamedTuple):
    fifo: FifoState
    tail: torch.Tensor   # [C, overlap] realized tail on the device
    k: int               # next output frame
    consumed: int        # input samples dropped from the FIFO's front
    in_len: int          # valid input samples pushed so far
    first: bool          # nothing emitted yet (the raw head leads)


def wsola_stream_init(plan: WsolaPlan, channels: int, device) -> WsolaState:
    return WsolaState(
        fifo=fifo_init(channels, plan.cap, device),
        tail=torch.zeros((channels, plan.overlap), dtype=torch.float32,
                         device=device),
        k=0, consumed=0, in_len=0, first=True,
    )


def wsola_stream_step(plan: WsolaPlan, state: WsolaState, data: torch.Tensor,
                      n: int, done: bool):
    """Push a chunk and run every WSOLA frame that is ready.

    Frame k reads the input window at pos(k) = frame_pos(k). While live, a
    frame runs once (a) its window is buffered and (b) its whole output
    stride lies inside the output-length bound of the input received so
    far (floor(in_len * 65536 / num_t)), so a live emission is never taken
    back. Once ``done``, the remaining frames run against the FIFO's zero
    tail, like the offline right pad, and the last chunk is clamped to the
    exact stretched length. The ready frames are a prefix of k .. k+k_cap-1
    counted on the host; the chain runs exactly those (none: no launch),
    from the carried tail, and hands back the next tail on the device.
    Splice decisions and samples equal the offline ``stretch._wsola_impl``.

    Returns ``(state, out [C, out_cap], out_n, out_done)``; the raw first
    ``overlap`` input samples that the offline path prepends lead the first
    emitted chunk."""
    fifo, tail, k0, consumed, in_len, first = state
    ov, stride = plan.overlap, plan.stride_out
    fifo = fifo_push(fifo, data, n)
    in_len += n
    level = fifo.level

    out_total = stretch_ops.scale_length_by_num(in_len, plan.num_t)
    k_fin = -(-(out_total - ov) // stride) if out_total > ov else 0
    k_bound = k_fin if done else max((out_total - ov) // stride, 0)
    # Gated until the raw head (offline prepends x[:, :overlap]) can be
    # emitted and the tail seeded from real samples.
    can_start = done or (level >= ov and out_total >= ov)
    emit_head = first and can_start
    k_done = 0
    if can_start or not first:
        buffered = consumed + level
        while (k_done < plan.k_cap and k0 + k_done < k_bound
               and (done or frame_pos(k0 + k_done, plan.num, plan.den)
                    + plan.seek + plan.seq <= buffered)):
            k_done += 1

    C = fifo.buf.shape[0]
    out = torch.zeros((C, plan.out_cap), dtype=torch.float32,
                      device=fifo.buf.device)
    lead = 0
    if emit_head:
        head = fifo_window(fifo, ov)
        out[:, :ov] = head
        tail = head.clone()
        lead = ov
    x = fifo_window(fifo, plan.window + plan.push_cap)
    _bs, body, tail = wsola.wsola_chunk_chain(
        x, tail, k0, consumed, k_done, plan.num, plan.den, plan.seq,
        plan.seek, ov)
    out[:, lead : lead + k_done * stride] = body

    # Clamp to the exact stretched length (bites only once done: live frames
    # lie inside the bound by construction).
    emitted = 0 if first else ov + k0 * stride
    out_n = min(max(min(lead + k_done * stride, out_total - emitted), 0),
                plan.out_cap)
    out[:, out_n:] = 0.0

    k_next = k0 + k_done
    # Keep everything from pos(k_next) on.
    advance = max(frame_pos(k_next, plan.num, plan.den) - consumed, 0)
    fifo = fifo_advance(fifo, advance)
    state = WsolaState(fifo=fifo, tail=tail, k=k_next,
                       consumed=consumed + advance, in_len=in_len,
                       first=first and not can_start)
    return state, out, out_n, done and k_next >= k_fin
