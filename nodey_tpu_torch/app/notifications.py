"""Notification center: the engine-honest Popup_manager (the port's copy
of nodey_tpu.app.notifications: ``Notification`` :29, ``NotificationCenter``
:43-121, ``get_default`` :127; errors unwrap the port's
``ProcessorRuntimeError``).

The reference routes every user-facing event through a mutex-guarded modal
window queue — any thread enqueues, the UI drains newest-on-top
(reference: include/frontend/popup.hpp:11-53, src/frontend/popup.cpp:16-75),
and runner errors arrive as typed payloads unwrapped into the three-part
{message, explanation, detail} shape (src/frontend/app.cpp:2097-2149).

Headless engines still need that contract: a thread-safe, ordered,
drainable queue of structured notifications an editor (or the web viewer,
or the CLI) can consume programmatically — without the engine depending on
any UI. Errors keep the three-part shape; informational events carry a
severity tag.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from nodey_tpu_torch.core.errors import ProcessorRuntimeError

SEVERITIES = ("info", "warning", "error")


@dataclasses.dataclass
class Notification:
    """One queued event (the popup-window analog)."""

    severity: str
    message: str
    explanation: str = ""
    detail: str = ""
    timestamp: float = 0.0
    seq: int = 0

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class NotificationCenter:
    """Thread-safe ordered notification queue.

    * ``push``/``push_error`` from any thread (the reference's
      popup_manager.open_window is likewise called cross-thread,
      popup.cpp:59-64).
    * ``drain`` pops everything in arrival order; ``peek`` copies without
      consuming (for pollers like the web viewer's /api/state).
    * Optional listeners fire synchronously on push — the hook an
      interactive editor uses to surface modals immediately.
    """

    def __init__(self, capacity: int = 256):
        self._lock = threading.Lock()
        self._items: List[Notification] = []
        self._capacity = capacity
        self._seq = 0
        self._dropped = 0
        self._listeners: List[Callable[[Notification], None]] = []

    def push(
        self,
        severity: str,
        message: str,
        explanation: str = "",
        detail: str = "",
    ) -> Notification:
        if severity not in SEVERITIES:
            raise ValueError(f"severity must be one of {SEVERITIES}")
        with self._lock:
            self._seq += 1
            note = Notification(
                severity=severity, message=message, explanation=explanation,
                detail=detail, timestamp=time.time(), seq=self._seq,
            )
            self._items.append(note)
            if len(self._items) > self._capacity:
                self._items.pop(0)
                self._dropped += 1
            listeners = list(self._listeners)
        for fn in listeners:
            fn(note)
        return note

    def push_error(self, exc: BaseException) -> Notification:
        """Route an exception with the reference's three-part unwrap
        (app.cpp:2097-2122: typed payloads first, generic fallback last)."""
        if isinstance(exc, ProcessorRuntimeError):
            return self.push(
                "error", exc.message, exc.explanation, exc.detail
            )
        return self.push(
            "error", "Unexpected error", str(exc), type(exc).__name__
        )

    def drain(self) -> List[Notification]:
        with self._lock:
            items, self._items = self._items, []
            return items

    def peek(self, since_seq: int = 0) -> List[Notification]:
        with self._lock:
            return [n for n in self._items if n.seq > since_seq]

    def add_listener(self, fn: Callable[[Notification], None]) -> None:
        with self._lock:
            self._listeners.append(fn)

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)


# Process-wide default center (the single popup_manager instance the
# reference hangs off App); embedders may create their own.
default_center: Optional[NotificationCenter] = None
_default_lock = threading.Lock()


def get_default() -> NotificationCenter:
    global default_center
    with _default_lock:
        if default_center is None:
            default_center = NotificationCenter()
        return default_center
