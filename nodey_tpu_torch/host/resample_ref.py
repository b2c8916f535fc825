"""The libswresample oracle, and the measured ``compat="swr"`` banks (port
of nodey_tpu.host.resample_ref).

Wraps the port's copy of ``host/native/swr_shim.cpp``: a real SwrContext
doing the conversion the reference's Audio_resampler performs
(reference: include/utility/sw-resample.hpp:14-71). Where the codec
runtime does not build or load, both functions raise the three-part
``ProcessorRuntimeError``; nothing renders another bank in its place.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from nodey_tpu_torch.core.errors import ProcessorRuntimeError
from nodey_tpu_torch.host.decode import load_native


def swr_convert(
    data: np.ndarray, in_rate: int, out_rate: int, out_channels: int = None
) -> np.ndarray:
    """Convert planar float32 [C, N] through libswresample (full drain)."""
    lib = load_native()
    if lib is None:
        raise ProcessorRuntimeError(
            "libswresample oracle unavailable",
            "The native host runtime (libnodey_host) could not be loaded.",
            "na_swr_convert_full",
        )
    in_channels, n = data.shape
    if out_channels is None:
        out_channels = in_channels
    interleaved = np.ascontiguousarray(data.T, dtype=np.float32).reshape(-1)
    out_ptr = ctypes.POINTER(ctypes.c_float)()
    errbuf = ctypes.create_string_buffer(256)
    count = lib.na_swr_convert_full(
        interleaved.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, in_rate, in_channels, out_rate, out_channels,
        ctypes.byref(out_ptr), errbuf, len(errbuf),
    )
    if count < 0:
        raise ProcessorRuntimeError(
            "Software resampler failed",
            "Cannot convert audio sample rate or format.",
            errbuf.value.decode(),
        )
    flat = np.ctypeslib.as_array(out_ptr, shape=(count * out_channels,)).copy()
    lib.na_free_buffer(out_ptr)
    return flat.reshape(count, out_channels).T


@functools.lru_cache(maxsize=32)
def measure_swr_bank(in_rate: int, out_rate: int):
    """System-identify libswresample's effective polyphase operator.

    swr's steady-state conversion is an exactly L-periodic linear map, so M
    delta probes, one per input residue, recover every tap of every phase:
    the response to a delta at input position k contributes, at output
    j = g*L + p, the tap ``bank[p, k - g*M + left]``. This is the
    ``compat="swr"`` filter design (ops/resample.py), the same numbers as
    the JAX package's.

    Returns (bank [L, W] float32 ndarray, left, W): the window of output
    group g reads input [g*M - left, g*M - left + W)."""
    from nodey_tpu_torch.ops import resample as resample_ops

    L, M = resample_ops._rational(in_rate, out_rate)
    taps = resample_ops._effective_taps(L, M, resample_ops.DEFAULT_TAPS)
    w_max = M + 4 * taps + 64        # generous support bound, trimmed below
    left_guess = 2 * taps
    n = 8192 + 2 * (w_max + M)
    k0 = n // 2
    bank = np.zeros((L, w_max), np.float64)
    seen = np.zeros((L, w_max), bool)
    for s in range(M):
        x = np.zeros((1, n), np.float32)
        x[0, k0 + s] = 1.0
        y = swr_convert(x, in_rate, out_rate)[0]
        for j in np.nonzero(np.abs(y) > 0)[0]:
            g, p = divmod(int(j), L)
            w = k0 + s - g * M + left_guess
            if 0 <= w < w_max:
                bank[p, w] = y[j]
                seen[p, w] = True
    cols = np.nonzero(seen.any(axis=0))[0]
    if len(cols) == 0:
        raise ProcessorRuntimeError(
            "swr bank measurement failed",
            "libswresample produced no response to delta probes.",
            f"measure_swr_bank({in_rate}, {out_rate})",
        )
    w_lo, w_hi = int(cols[0]), int(cols[-1])
    trimmed = np.ascontiguousarray(bank[:, w_lo : w_hi + 1], np.float32)
    return trimmed, left_guess - w_lo, trimmed.shape[1]
