"""Compressor node (port of nodey_tpu.processors.compressor).

Downward compression with a soft knee, attack and release: the other half
of a production master bus beside the limiter. The decoupled detector is
two scans (ops/dynamics.py): the limiter's max-plus release envelope and a
one-pole attack smoother. Stereo-linked; with zero makeup the node is a
bitwise passthrough below the knee.
"""

from __future__ import annotations

from typing import Any, Dict, List

from nodey_tpu_torch.core.errors import ProcessorRuntimeError
from nodey_tpu_torch.core.registry import PinAttribute, Processor, ProcessorInfo
from nodey_tpu_torch.core.stream import AudioStreamType
from nodey_tpu_torch.ops import dynamics

_DESCRIPTION = """Compressor

## Functionality
- Downward compression above a threshold with an adjustable ratio
- Soft knee (set Knee to 0 dB for a hard knee)
- Attack / release detector; stereo-linked (no image skew)
- Makeup gain to restore loudness
- Transparent (bitwise passthrough) below the knee at 0 dB makeup

## Usage
- Connect an audio stream to 'Input'
- Set 'Threshold' and 'Ratio' for the amount of compression
- Shape the response with 'Attack', 'Release' and 'Knee'
"""


class AudioCompressor(Processor):
    batched = True  # each clip's detector on its own channels

    def __init__(self) -> None:
        self.threshold_db: float = -18.0
        self.ratio: float = 4.0
        self.knee_db: float = 6.0
        self.attack_ms: float = 5.0
        self.release_ms: float = 100.0
        self.makeup_db: float = 0.0

    def info(self) -> ProcessorInfo:
        return ProcessorInfo(
            identifier="audio_compressor",
            display_name="Compressor",
            singleton=False,
            generate=AudioCompressor,
            description=_DESCRIPTION,
        )

    def pin_attributes(self) -> List[PinAttribute]:
        return [
            PinAttribute("output", "Output", AudioStreamType, is_input=False),
            PinAttribute("input", "Input", AudioStreamType, is_input=True),
        ]

    # -- parameter clamps (hand-edited project files included) ---------------

    def set_threshold_db(self, value: float) -> None:
        self.threshold_db = min(max(float(value), -60.0), 0.0)

    def set_ratio(self, value: float) -> None:
        self.ratio = min(max(float(value), 1.0), 20.0)

    def set_knee_db(self, value: float) -> None:
        self.knee_db = min(max(float(value), 0.0), 24.0)

    def set_attack_ms(self, value: float) -> None:
        self.attack_ms = min(max(float(value), 0.1), 100.0)

    def set_release_ms(self, value: float) -> None:
        self.release_ms = min(max(float(value), 1.0), 1000.0)

    def set_makeup_db(self, value: float) -> None:
        self.makeup_db = min(max(float(value), -12.0), 24.0)

    def param_spec(self) -> List[Dict[str, Any]]:
        return [
            {"key": "threshold_db", "label": "Threshold (dB)",
             "kind": "float", "min": -60.0, "max": 0.0, "step": 0.1,
             "value": self.threshold_db},
            {"key": "ratio", "label": "Ratio", "kind": "float",
             "min": 1.0, "max": 20.0, "step": 0.1, "log": True,
             "value": self.ratio},
            {"key": "knee_db", "label": "Knee (dB)", "kind": "float",
             "min": 0.0, "max": 24.0, "step": 0.5, "value": self.knee_db},
            {"key": "attack_ms", "label": "Attack (ms)", "kind": "float",
             "min": 0.1, "max": 100.0, "step": 0.1, "log": True,
             "value": self.attack_ms},
            {"key": "release_ms", "label": "Release (ms)", "kind": "float",
             "min": 1.0, "max": 1000.0, "step": 1.0, "log": True,
             "value": self.release_ms},
            {"key": "makeup_db", "label": "Makeup (dB)", "kind": "float",
             "min": -12.0, "max": 24.0, "step": 0.1,
             "value": self.makeup_db},
        ]

    _FIELDS = (
        ("threshold_db", "set_threshold_db"),
        ("ratio", "set_ratio"),
        ("knee_db", "set_knee_db"),
        ("attack_ms", "set_attack_ms"),
        ("release_ms", "set_release_ms"),
        ("makeup_db", "set_makeup_db"),
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
                "Compressor has no input",
                "The compressor requires an audio stream input.",
                "Input item 'input' not found",
            )
        return value

    def _params(self, rate: int):
        return dynamics.compressor_params(
            self.threshold_db, self.ratio, self.knee_db, self.attack_ms,
            self.release_ms, self.makeup_db, rate,
        )

    def lower(self, ctx, inputs: Dict[str, Any]) -> Dict[str, Any]:
        stream = self._require(inputs)
        return {"output": dynamics.compress_stream(
            stream, self.threshold_db, self.ratio, self.knee_db,
            self.attack_ms, self.release_ms, self.makeup_db,
        )}

    # -- chunk-streaming: two scalar carries (release env, attack smoother) --

    def plan_stream(self, ctx, in_specs):
        spec = self._require(in_specs)
        self._comp_params = self._params(spec.rate)
        dynamics.compressor_stream_prepare(self._comp_params, spec.width,
                                           ctx.device)
        state = {"det": dynamics.compressor_stream_init(spec.channels,
                                                        ctx.device)}
        return {"output": spec.replace(fmt="flt")}, state

    def lower_stream(self, ctx, inputs, state):
        chunk = self._require(inputs)
        new_det, out = dynamics.compressor_stream_step(
            self._comp_params, state["det"], chunk.data, chunk.n
        )
        return (
            {"output": chunk.with_data(out, fmt="flt")},
            {"det": new_det},
        )
