"""WSOLA time-stretch + pitch transposition (port of nodey_tpu.ops.stretch,
offline whole-clip paths).

The reference drives SoundTouch with setRate(r) + setPitch(p)
(src/processor/audio-velocity.cpp:384-385); SoundTouch factors that into
a resampling rate ``r*p`` and a WSOLA tempo ``1/p``, which run here as two
stages:

1. ``wsola_stretch_at_rate``: the greedy WSOLA splice chain
   (:mod:`nodey_tpu_torch.ops.wsola`; the CUDA kernel on the card);
2. ``transpose_rate``: the polyphase resampler at a rational
   approximation of the factor, relabeled to the original nominal rate.

Window parameters are SoundTouch's classic defaults (sequence 40 ms, seek
15 ms, overlap 8 ms) with linear crossfades, as in the JAX package.
Lengths are host ints. Not ported yet: the phase vocoder (``algorithm=
"pv"``) and the streaming step (``wsola_stream_plan``/``_step``).
"""

from __future__ import annotations

import fractions
import math

import torch
import torch.nn.functional as F

from nodey_tpu_torch.core.errors import ProcessorRuntimeError
from nodey_tpu_torch.core.stream import FMT_FLT, Stream
from nodey_tpu_torch.ops import resample as resample_ops
from nodey_tpu_torch.ops import wsola
from nodey_tpu_torch.ops.wsola import frame_pos

SEQUENCE_MS = 40.0
SEEK_MS = 15.0
OVERLAP_MS = 8.0


def _params(rate: int):
    seq = max(2, int(rate * SEQUENCE_MS / 1000.0)) & ~1
    seek = max(2, int(rate * SEEK_MS / 1000.0)) & ~1
    overlap = max(2, int(rate * OVERLAP_MS / 1000.0)) & ~1
    return seq, seek, overlap


def _out_chunks(capacity_in: int, tempo: float, seq: int, overlap: int) -> int:
    """Number of output frames needed to cover the stretched buffer."""
    stride_out = seq - overlap
    cap_out = int(math.ceil(capacity_in / tempo)) + stride_out
    return max(1, -(-(cap_out - overlap) // stride_out))


def scale_length_by_num(length: int, num: int) -> int:
    """floor(length * 65536 / num), exact (the JAX package computes the
    same value in carry-decomposed int32 arithmetic)."""
    return length * 65536 // num


def _scale_length_exact(length: int, tempo: float) -> int:
    return scale_length_by_num(length, int(round(tempo * 65536)))


def wsola_stretch_at_rate(data: torch.Tensor, length: int, tempo: float,
                          rate: int):
    """Stretch [C, N] float32 by ``tempo`` (>1 = faster/shorter).

    Returns ``(out [C, overlap + K*stride], out_length)`` with out_length =
    min(floor(length / tempo), width) and zeros past it. Identity when
    tempo == 1."""
    if tempo == 1.0:
        return data, length
    return _wsola_impl(data, length, float(tempo), int(rate))


def wsola_geometry(width: int, tempo: float, rate: int) -> dict:
    """The chain's static geometry for a [C, width] buffer: window
    parameters, frame count K, the 16.16 position step ``num``/``den``
    and the width ``pad_to`` the input is zero-padded to."""
    seq, seek, overlap = _params(rate)
    K = _out_chunks(width, tempo, seq, overlap)
    # Integer stepping for input positions: pos_k = round(k*stride_out*tempo).
    num = int(round((seq - overlap) * tempo * 65536))
    den = 65536
    # Pad so every window read is in bounds: the last frame reads
    # [pos(K-1), pos(K-1) + seek + seq).
    pad_to = frame_pos(K - 1, num, den) + seek + seq + 2
    return dict(K=K, num=num, den=den, seq=seq, seek=seek, overlap=overlap,
                pad_to=pad_to)


def _wsola_impl(data: torch.Tensor, length: int, tempo: float, rate: int):
    geo = wsola_geometry(data.shape[1], tempo, rate)
    K, num, den = geo["K"], geo["num"], geo["den"]
    seq, seek, overlap = geo["seq"], geo["seek"], geo["overlap"]
    x = F.pad(data, (0, max(0, geo["pad_to"] - data.shape[1])))
    head = x[:, :overlap]
    _bs, body = wsola.wsola_chain(x, head, K, num, den, seq, seek, overlap)
    out = torch.cat([head, body], dim=1)
    out_length = min(_scale_length_exact(length, tempo), out.shape[1])
    out[:, out_length:] = 0.0  # ``out`` is a fresh tensor: zero in place
    return out, out_length


def _rational_factor(factor: float, max_den: int = 600):
    """``factor`` as L/M with sub-cent error (SoundTouch's transposer
    interpolates continuously; a <=1e-5 relative rational approximation is
    far below audibility and keeps the polyphase bank small)."""
    frac = fractions.Fraction(factor).limit_denominator(max_den)
    return frac.numerator, frac.denominator


def transpose_rate(data: torch.Tensor, length: int, factor: float):
    """Resample [C, N] by ``factor`` (>1 = fewer samples, higher pitch when
    relabeled at the same nominal rate); zeros past the new length."""
    if factor == 1.0:
        return data, length
    num, den = _rational_factor(factor)
    if num == den:
        return data, length
    # Consume `num` input samples per `den` output samples: in_rate=num,
    # out_rate=den in resampler terms.
    out = resample_ops.resample_data(data, num, den)
    out_length = (length // num) * den + ((length % num) * den + num - 1) // num
    out[:, out_length:] = 0.0  # a fresh tensor from the resampler
    return out, out_length


def soundtouch_like(ctx, stream: Stream, rate: float, pitch: float,
                    algorithm: str = "wsola",
                    pv_transient: bool = False,
                    preserve_formants: bool = False) -> Stream:
    """Apply the SoundTouch (rate, pitch) pair to a stream: WSOLA at tempo
    ``1/pitch``, then transposition by ``rate*pitch``.

    ``algorithm="pv"`` (the phase vocoder) is not ported yet and raises;
    it never falls back to WSOLA."""
    eff_rate = rate * pitch
    eff_tempo = 1.0 / pitch

    data, length = stream.data, stream.length
    if abs(eff_tempo - 1.0) > 1e-9:
        if algorithm == "pv":
            raise ProcessorRuntimeError(
                "Phase vocoder not available",
                "The phase-vocoder tempo algorithm is not ported to the "
                "PyTorch engine yet; set the node's algorithm to 'wsola' "
                "or render the project with the JAX package.",
                f"algorithm={algorithm!r}, tempo={eff_tempo:.6g}",
            )
        data, length = wsola_stretch_at_rate(data, length, eff_tempo,
                                             stream.rate)
    if abs(eff_rate - 1.0) > 1e-9:
        data, length = transpose_rate(data, length, eff_rate)
    return Stream(
        data=data,
        length=length,
        rate=stream.rate,
        channels=stream.channels,
        fmt=FMT_FLT,
        t0_us=stream.t0_us,
    )
