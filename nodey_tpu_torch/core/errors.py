"""Error taxonomy (the port's copy of nodey_tpu.core.errors: same class
names, same messages).

Mirrors the reference's user-facing error shapes:

* graph structure errors (reference: include/infra/graph.hpp:89-134)
* the three-part processor runtime error {message, explanation, detail}
  (reference: include/infra/processor.hpp:64-77)
* logic errors with source location (reference:
  include/utility/logic-error-utility.hpp:2-12) — Python tracebacks already
  carry the location, so a plain subclass suffices.
"""

from __future__ import annotations


class NodeyError(Exception):
    """Base class for all framework errors."""


class LogicError(NodeyError):
    """Internal invariant violation (reference: THROW_LOGIC_ERROR)."""


class MismatchedPinError(NodeyError):
    """Link endpoints carry different product types
    (reference: include/infra/graph.hpp:92-103)."""

    def __init__(self, from_pin: int, to_pin: int):
        super().__init__(f"Mismatch Pin: {from_pin}, {to_pin}")
        self.from_pin = from_pin
        self.to_pin = to_pin


class LoopDetectedError(NodeyError):
    """The graph contains a cycle (reference: include/infra/graph.hpp:106-112)."""

    def __init__(self) -> None:
        super().__init__("Loop Detected")


class MultipleInputError(NodeyError):
    """An input pin has more than one incoming link
    (reference: include/infra/graph.hpp:116-124)."""

    def __init__(self, pin: int):
        super().__init__(f"Multiple Inputs in Input Pin: {pin}")
        self.pin = pin


class InvalidFileError(NodeyError):
    """Project file invalid (reference: include/infra/graph.hpp:128-134)."""

    def __init__(self, message: str):
        super().__init__(f"Invalid File: {message}")
        self.message = message


class ProcessorRuntimeError(NodeyError):
    """Three-part user-facing processor error
    (reference: include/infra/processor.hpp:64-77).

    ``message`` is a one-line summary, ``explanation`` tells the user what to
    do about it, ``detail`` carries debugging specifics.
    """

    def __init__(self, message: str, explanation: str, detail: str = ""):
        super().__init__(
            f"{message} (Detail: {detail}) (Explanation: {explanation})"
        )
        self.message = message
        self.explanation = explanation
        self.detail = detail


class UnstreamableGraphError(ProcessorRuntimeError):
    """The graph is valid but cannot execute under LOCKSTEP chunk
    streaming (e.g. mixer branches with different per-step audio-second
    cadences, chunkflow.plan_aligned_merge). Raised before any output is
    produced, so callers may fall back to the offline whole-clip paths,
    which handle these graphs exactly."""


class RunCancelled(NodeyError):
    """A run was cooperatively cancelled via ``Runner.stop()``.

    Not an error state: mirrors the reference's stop_source teardown
    (src/infra/runner.cpp:53-63 sets every node's stop token and joins),
    after which the app returns to Editing with no error popup
    (src/frontend/app.cpp:1949-1957). The runner lands back in READY."""

    def __init__(self, detail: str = ""):
        super().__init__(f"Run cancelled{': ' + detail if detail else ''}")
        self.detail = detail
