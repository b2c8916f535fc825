"""Bounded staging queues with occupancy metrics, and the realtime pacer
(port of nodey_tpu.host.streamio).

The host-side form of the reference's per-edge channel semantics
(reference: include/processor/audio-stream.hpp:46-83): bounded capacity 16,
blocking waits with backpressure, an EOF flag, and
the buffered-frames gauge the diagnostics overlay renders as a fill-ratio
bar (reference: src/frontend/app.cpp:1574-1595). The streaming executor's
stages hand blocks to each other through these queues: decode -> pump,
pump -> egress, egress -> sink; the preview session's producer hands its
blocks to the consumer through one, which ``RealtimePacer`` paces at 1.0x.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Optional

from nodey_tpu_torch import config


@dataclasses.dataclass
class QueueStats:
    """Occupancy metrics (the diagnostics-overlay feed)."""

    capacity: int
    buffered: int = 0
    pushed: int = 0
    popped: int = 0
    producer_waits: int = 0  # backpressure events (queue full)
    consumer_waits: int = 0  # underrun events (queue empty)

    @property
    def fill_ratio(self) -> float:
        return self.buffered / self.capacity if self.capacity else 0.0


class BoundedBlockQueue:
    """SPSC bounded queue of audio blocks.

    Mirrors Audio_stream: try_push/try_pop non-blocking variants, blocking
    push/pop with backpressure and a stop event standing in for the
    reference's cooperative yield loops (audio-stream.cpp:60-80), and
    set_eof/eof.
    """

    def __init__(self, capacity: int = config.AUDIO_STREAM_BUFFER_SIZE):
        self._deque = collections.deque()
        self._capacity = capacity
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._not_empty = threading.Condition(self._lock)
        self._eof = False
        self.stats = QueueStats(capacity=capacity)

    def try_push(self, item: Any) -> bool:
        """Non-blocking push; False if the queue is full."""
        with self._lock:
            if len(self._deque) >= self._capacity:
                return False
            self._deque.append(item)
            self.stats.pushed += 1
            self.stats.buffered = len(self._deque)
            self._not_empty.notify()
            return True

    def push(self, item: Any, stop: Optional[threading.Event] = None,
             timeout: float = 0.1) -> bool:
        """Blocking push; False if ``stop`` is set while the queue is full."""
        while True:
            with self._not_full:
                if len(self._deque) < self._capacity:
                    self._deque.append(item)
                    self.stats.pushed += 1
                    self.stats.buffered = len(self._deque)
                    self._not_empty.notify()
                    return True
                self.stats.producer_waits += 1
                self._not_full.wait(timeout)
            if stop is not None and stop.is_set():
                return False

    def try_pop(self) -> Optional[Any]:
        """Non-blocking pop; None if the queue is empty."""
        with self._lock:
            if not self._deque:
                return None
            item = self._deque.popleft()
            self.stats.popped += 1
            self.stats.buffered = len(self._deque)
            self._not_full.notify()
            return item

    def pop(self, stop: Optional[threading.Event] = None,
            timeout: float = 0.1) -> Optional[Any]:
        """Blocking pop; returns None at EOF-and-drained or on stop."""
        while True:
            with self._not_empty:
                if self._deque:
                    item = self._deque.popleft()
                    self.stats.popped += 1
                    self.stats.buffered = len(self._deque)
                    self._not_full.notify()
                    return item
                if self._eof:
                    return None
                self.stats.consumer_waits += 1
                self._not_empty.wait(timeout)
            if stop is not None and stop.is_set():
                return None

    def set_eof(self) -> None:
        with self._lock:
            self._eof = True
            self._not_empty.notify_all()

    @property
    def eof(self) -> bool:
        with self._lock:
            return self._eof and not self._deque

    def buffered_count(self) -> int:
        with self._lock:
            return len(self._deque)


class RealtimePacer:
    """Paces a consumer at 1.0x wall-clock against the audio timeline, the
    role SDL's queued-audio backpressure plays in the reference preview
    (src/processor/audio-io.cpp:620-624): ``wait(n)`` returns once the
    blocks before this one have had their time; ``wait(0)`` after the last
    block waits out its time too, as a device drains its queue."""

    def __init__(self, rate: int = config.SAMPLE_RATE):
        self.rate = rate
        self._start: Optional[float] = None
        self._samples = 0

    def wait(self, block_samples: int) -> None:
        if self._start is None:
            self._start = time.perf_counter()
        target = self._samples / self.rate
        while time.perf_counter() - self._start < target:
            time.sleep(0.001)
        self._samples += block_samples
