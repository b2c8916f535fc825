"""Noise gate node (port of nodey_tpu.processors.gate).

Downward expansion below a threshold (cut hiss and bleed between
phrases): the compressor's two-scan detector (ops/dynamics.py) feeding the
gate's static curve — exactly 0 dB of gain at or above threshold (bitwise
passthrough on loud material), (ratio - 1) dB/dB expansion below it,
floored at -range_db. Stereo-linked.
"""

from __future__ import annotations

from typing import Any, Dict, List

from nodey_tpu_torch.core.errors import ProcessorRuntimeError
from nodey_tpu_torch.core.registry import PinAttribute, Processor, ProcessorInfo
from nodey_tpu_torch.core.stream import AudioStreamType
from nodey_tpu_torch.ops import dynamics

_DESCRIPTION = """Noise Gate

## Functionality
- Attenuates the signal while it sits below a threshold
- Expansion ratio and maximum attenuation (range)
- Attack / release detector; stereo-linked (no image skew)
- Transparent (bitwise passthrough) at or above the threshold

## Usage
- Connect an audio stream to 'Input'
- Raise 'Threshold' until the noise floor closes the gate
- Shape the response with 'Attack', 'Release' and 'Range'
"""


class AudioGate(Processor):
    batched = True  # each clip's detector on its own channels

    def __init__(self) -> None:
        self.threshold_db: float = -50.0
        self.ratio: float = 4.0
        self.range_db: float = 60.0
        self.attack_ms: float = 1.0
        self.release_ms: float = 200.0

    def info(self) -> ProcessorInfo:
        return ProcessorInfo(
            identifier="audio_gate",
            display_name="Noise Gate",
            singleton=False,
            generate=AudioGate,
            description=_DESCRIPTION,
        )

    def pin_attributes(self) -> List[PinAttribute]:
        return [
            PinAttribute("output", "Output", AudioStreamType, is_input=False),
            PinAttribute("input", "Input", AudioStreamType, is_input=True),
        ]

    # -- parameter clamps (hand-edited project files included) ---------------

    def set_threshold_db(self, value: float) -> None:
        self.threshold_db = min(max(float(value), -90.0), 0.0)

    def set_ratio(self, value: float) -> None:
        self.ratio = min(max(float(value), 1.0), 20.0)

    def set_range_db(self, value: float) -> None:
        self.range_db = min(max(float(value), 0.0), 90.0)

    def set_attack_ms(self, value: float) -> None:
        self.attack_ms = min(max(float(value), 0.1), 100.0)

    def set_release_ms(self, value: float) -> None:
        self.release_ms = min(max(float(value), 1.0), 1000.0)

    def param_spec(self) -> List[Dict[str, Any]]:
        return [
            {"key": "threshold_db", "label": "Threshold (dB)",
             "kind": "float", "min": -90.0, "max": 0.0, "step": 0.1,
             "value": self.threshold_db},
            {"key": "ratio", "label": "Ratio", "kind": "float",
             "min": 1.0, "max": 20.0, "step": 0.1, "log": True,
             "value": self.ratio},
            {"key": "range_db", "label": "Range (dB)", "kind": "float",
             "min": 0.0, "max": 90.0, "step": 0.5, "value": self.range_db},
            {"key": "attack_ms", "label": "Attack (ms)", "kind": "float",
             "min": 0.1, "max": 100.0, "step": 0.1, "log": True,
             "value": self.attack_ms},
            {"key": "release_ms", "label": "Release (ms)", "kind": "float",
             "min": 1.0, "max": 1000.0, "step": 1.0, "log": True,
             "value": self.release_ms},
        ]

    _FIELDS = (
        ("threshold_db", "set_threshold_db"),
        ("ratio", "set_ratio"),
        ("range_db", "set_range_db"),
        ("attack_ms", "set_attack_ms"),
        ("release_ms", "set_release_ms"),
    )

    def serialize(self) -> Any:
        return {key: getattr(self, key) for key, _ in self._FIELDS}

    def deserialize(self, value: Any) -> None:
        if isinstance(value, dict):
            for key, setter in self._FIELDS:
                v = value.get(key)
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    getattr(self, setter)(float(v))

    def _require(self, inputs):
        value = inputs.get("input")
        if value is None:
            raise ProcessorRuntimeError(
                "Noise gate has no input",
                "The gate requires an audio stream input.",
                "Input item 'input' not found",
            )
        return value

    def _params(self, rate: int):
        return dynamics.gate_params(
            self.threshold_db, self.ratio, self.range_db,
            self.attack_ms, self.release_ms, rate,
        )

    def lower(self, ctx, inputs: Dict[str, Any]) -> Dict[str, Any]:
        stream = self._require(inputs)
        return {"output": dynamics.gate_stream(
            stream, self.threshold_db, self.ratio, self.range_db,
            self.attack_ms, self.release_ms,
        )}

    # -- chunk-streaming: two scalar carries (release env, attack smoother) --

    def plan_stream(self, ctx, in_specs):
        spec = self._require(in_specs)
        self._gate_params = self._params(spec.rate)
        dynamics.gate_stream_prepare(self._gate_params, spec.width,
                                     ctx.device)
        state = {"det": dynamics.gate_stream_init(spec.channels,
                                                  ctx.device)}
        return {"output": spec.replace(fmt="flt")}, state

    def lower_stream(self, ctx, inputs, state):
        chunk = self._require(inputs)
        new_det, out = dynamics.gate_stream_step(
            self._gate_params, state["det"], chunk.data, chunk.n
        )
        return (
            {"output": chunk.with_data(out, fmt="flt")},
            {"det": new_det},
        )
