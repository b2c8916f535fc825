"""The lock kernel's peak choice, mirrored in numpy, against the plain
lock's on the CPU.

``csrc/pv_lock.cu`` (and the phase path's locked apply pass) finds each
bin's nearest peaks by words: lane l of step j tests bin 32 j + l and
``__ballot_sync`` makes word j of the row's peak flags; ``scan_words``
gives each word the last peak in the words up to it and the first in the
words from it (each lane scans a chunk of words, then the lanes' totals
are scanned with shuffles); ``nearest_peaks`` takes a bin's left and right
peak from its own word with a masked ``__clz`` / ``__ffs``, or from the
neighbouring words' scan. The kernel is compiled with the smallest word
count of 9, 17, 33, 65 and 129 that holds the row; the words past it are
0. The mirror below follows those steps word by word and lane by lane, and
must choose exactly the peaks of the plain lock (``pv._peak_flags`` and
``pv._hs_last_valid``'s previous and next indices): rows of 3 to 4,097
bins, with noise, no peak (NaN), ties (silence, equal magnitudes), a
peak only in the top bin, peaks exactly one word apart and far apart.
"""

import numpy as np
import pytest
import torch

from nodey_tpu_torch.ops import pv

WORDS = (9, 17, 33, 65, 129)
INT_MAX = 2**31 - 1


def _high_bit(x):
    """Index of the highest set bit of each nonzero uint32 (31 - __clz)."""
    return np.frexp(x.astype(np.float64))[1] - 1


def _low_bit(x):
    """Index of the lowest set bit of each nonzero uint32 (__ffs - 1)."""
    return _high_bit(x & (~x + np.uint32(1)))


def _scan_words(words):
    """scan_words for every row of words [R, kWords]: (last, first)."""
    R, k_words = words.shape
    k_chunk = -(-k_words // 32)
    lo = np.empty((R, 32, k_chunk), np.int64)
    hi = np.empty((R, 32, k_chunk), np.int64)
    for lane in range(32):
        acc = np.full(R, -1, np.int64)
        for i in range(k_chunk):
            w = lane * k_chunk + i
            if w < k_words and words[:, w].any():
                m = words[:, w]
                acc = np.where(m != 0, 32 * w + _high_bit(m), acc)
            lo[:, lane, i] = acc
        acc = np.full(R, INT_MAX, np.int64)
        for i in reversed(range(k_chunk)):
            w = lane * k_chunk + i
            if w < k_words and words[:, w].any():
                m = words[:, w]
                acc = np.where(m != 0, 32 * w + _low_bit(m), acc)
            hi[:, lane, i] = acc
    up, down = lo[:, :, -1].copy(), hi[:, :, 0].copy()
    off = 1
    while off < 32:
        up[:, off:] = np.maximum(up[:, off:], up[:, :-off].copy())
        down[:, :-off] = np.minimum(down[:, :-off], down[:, off:].copy())
        off *= 2
    before = np.concatenate([np.full((R, 1), -1), up[:, :-1]], axis=1)
    after = np.concatenate([down[:, 1:], np.full((R, 1), INT_MAX)], axis=1)
    last = np.maximum(before[:, :, None], lo).reshape(R, -1)[:, :k_words]
    first = np.minimum(after[:, :, None], hi).reshape(R, -1)[:, :k_words]
    return last, first


def _word_lock(mag):
    """(flags, left, right) of rows mag [R, B] float32, as the kernel finds
    them: left the last peak at or before each bin (or -1), right the first
    at or after it (or INT_MAX)."""
    R, B = mag.shape
    k_words = next(w for w in WORDS if 32 * w >= B)
    span = 32 * k_words
    guarded = np.full((R, span + 4), -1.0, np.float32)
    guarded[:, 2 : B + 2] = mag
    b = np.arange(span)
    at = [guarded[:, b + 2 + o] for o in (-2, -1, 0, 1, 2)]
    flags = ((b < B) & (at[2] > at[1]) & (at[2] >= at[3]) & (at[2] > at[0])
             & (at[2] >= at[4]))
    lanes = np.uint32(1) << np.arange(32, dtype=np.uint32)
    words = (flags.reshape(R, k_words, 32) * lanes).sum(
        -1, dtype=np.uint64).astype(np.uint32)
    last, first = _scan_words(words)
    b = np.arange(B)
    w, bit = b >> 5, (b & 31).astype(np.uint32)
    m = words[:, w]
    below = m & (np.uint32(0xFFFFFFFF) >> (np.uint32(31) - bit))
    above = m & (np.uint32(0xFFFFFFFF) << bit)
    before = last[:, np.maximum(w - 1, 0)]
    after = first[:, np.minimum(w + 1, k_words - 1)]
    left = np.where(below != 0, 32 * w + _high_bit(np.maximum(below, 1)),
                    np.where(w > 0, before, -1))
    right = np.where(above != 0, 32 * w + _low_bit(np.maximum(above, 1)),
                     np.where(w + 1 < k_words, after, INT_MAX))
    return flags[:, :B], left, right


def _rows(B, rng):
    """[R, B] float32 magnitudes: the row kinds of the module docstring."""
    b = np.arange(B)
    rows = [
        np.abs(np.cumsum(rng.standard_normal(B))),       # noise
        rng.random(B),                                    # dense peaks
        np.full(B, np.nan),                               # no peak
        np.where(rng.random(B) < 0.3, np.nan, rng.random(B)),
        np.zeros(B),                                      # silence
        np.full(B, 0.25),                                 # equal magnitudes
        (b + 1.0) / B,                                    # top bin only
        np.where(b % 32 == 5, 1.0, 0.5),                  # one word apart
        np.where(b % 32 == 31, 1.0, 0.5),                 # at word ends
        np.where(b % 64 == 0, 1.0, 0.5),                  # two words apart
        np.where((b == 1) | (b == B - 2), 1.0, 0.0),      # far apart
        np.where(b % 10 == 0, 1.0, 0.5),                  # a comb (ties)
    ]
    return np.stack(rows).astype(np.float32)


@pytest.mark.parametrize("B", [3, 31, 32, 33, 257, 1025, 4097])
def test_word_lock_chooses_the_plain_locks_peaks(B):
    mag = _rows(B, np.random.default_rng(B))
    flags, left, right = _word_lock(mag)

    t = torch.from_numpy(mag)
    peaks = pv._peak_flags(t)
    idx = torch.where(peaks, torch.arange(B, dtype=torch.int32), -1)
    prev = pv._hs_last_valid((idx,))[0].numpy()
    nxt = pv._hs_last_valid((idx.flip(-1),))[0].flip(-1).numpy()

    np.testing.assert_array_equal(flags, peaks.numpy())
    np.testing.assert_array_equal(left, prev)
    np.testing.assert_array_equal(np.where(right == INT_MAX, -1, right), nxt)
    # The cases reach what they are for: rows without a peak, a lone top
    # peak, and (where a row has two words) peaks in different words.
    assert not flags[2].any() and flags[6].sum() == 1 and flags[6, -1]
    if B > 64:
        assert (np.diff(np.flatnonzero(flags[7])[1:]) == 32).all()
