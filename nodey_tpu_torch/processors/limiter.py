"""Peak limiter node (port of nodey_tpu.processors.limiter).

The reference ships no dynamics processing; a master bus without a
limiter is the first thing a production pipeline adds. The envelope
recurrence (instant attack, exponential release) runs as a max-plus scan
(ops/dynamics.py); stereo-linked; below threshold the node is a bitwise
passthrough.
"""

from __future__ import annotations

from typing import Any, Dict, List

from nodey_tpu_torch.core.errors import ProcessorRuntimeError
from nodey_tpu_torch.core.registry import PinAttribute, Processor, ProcessorInfo
from nodey_tpu_torch.core.stream import AudioStreamType
from nodey_tpu_torch.ops import dynamics

_DESCRIPTION = """Peak Limiter

## Functionality
- Caps the output peak level at a threshold (instant attack)
- Exponential release; stereo-linked envelope (no image skew)
- Transparent (bitwise passthrough) while the signal stays below
  the threshold

## Usage
- Connect an audio stream to 'Input'
- Set the ceiling with 'Threshold' (dBFS) and the recovery speed
  with 'Release'
"""


class AudioLimiter(Processor):
    batched = True  # each clip's envelope on its own channels

    def __init__(self) -> None:
        self.threshold_db: float = -1.0
        self.release_ms: float = 50.0

    def info(self) -> ProcessorInfo:
        return ProcessorInfo(
            identifier="audio_limiter",
            display_name="Limiter",
            singleton=False,
            generate=AudioLimiter,
            description=_DESCRIPTION,
        )

    def pin_attributes(self) -> List[PinAttribute]:
        return [
            PinAttribute("output", "Output", AudioStreamType, is_input=False),
            PinAttribute("input", "Input", AudioStreamType, is_input=True),
        ]

    def set_threshold_db(self, value: float) -> None:
        self.threshold_db = min(max(float(value), -60.0), 0.0)

    def set_release_ms(self, value: float) -> None:
        self.release_ms = min(max(float(value), 1.0), 1000.0)

    def param_spec(self) -> List[Dict[str, Any]]:
        return [
            {"key": "threshold_db", "label": "Threshold (dB)",
             "kind": "float", "min": -60.0, "max": 0.0, "step": 0.1,
             "value": self.threshold_db},
            {"key": "release_ms", "label": "Release (ms)", "kind": "float",
             "min": 1.0, "max": 1000.0, "step": 1.0, "log": True,
             "value": self.release_ms},
        ]

    def serialize(self) -> Any:
        return {"threshold_db": self.threshold_db,
                "release_ms": self.release_ms}

    def deserialize(self, value: Any) -> None:
        if isinstance(value, dict):
            t = value.get("threshold_db")
            if isinstance(t, (int, float)) and not isinstance(t, bool):
                self.set_threshold_db(float(t))
            r = value.get("release_ms")
            if isinstance(r, (int, float)) and not isinstance(r, bool):
                self.set_release_ms(float(r))

    def _require(self, inputs):
        value = inputs.get("input")
        if value is None:
            raise ProcessorRuntimeError(
                "Limiter has no input",
                "The limiter requires an audio stream input.",
                "Input item 'input' not found",
            )
        return value

    def lower(self, ctx, inputs: Dict[str, Any]) -> Dict[str, Any]:
        stream = self._require(inputs)
        return {"output": dynamics.limit_stream(
            stream, self.threshold_db, self.release_ms
        )}

    # -- chunk-streaming: one scalar carry (the log envelope) ----------------

    def plan_stream(self, ctx, in_specs):
        spec = self._require(in_specs)
        self._limit_params = dynamics.limiter_params(
            self.threshold_db, self.release_ms, spec.rate
        )
        state = {"env": dynamics.limiter_stream_init(spec.channels,
                                                     ctx.device)}
        return {"output": spec.replace(fmt="flt")}, state

    def lower_stream(self, ctx, inputs, state):
        chunk = self._require(inputs)
        threshold, c = self._limit_params
        new_env, out = dynamics.limiter_stream_step(
            threshold, c, state["env"], chunk.data, chunk.n
        )
        return (
            {"output": chunk.with_data(out, fmt="flt")},
            {"env": new_env},
        )
