"""Pan / balance and stereo width nodes (port of
nodey_tpu.processors.pan).

Both are memoryless and time-invariant (ops/fadepan.py): members of the
chunked renderer's overlap-discard set, and stateless when streamed.
Stereo input at pan 0 is a bitwise passthrough; mono input is placed
constant-power into a stereo output (the pan's output is always stereo).
Width 1.0 and mono inputs pass through the width node bitwise.
"""

from __future__ import annotations

from typing import Any, Dict, List

from nodey_tpu_torch.core.errors import ProcessorRuntimeError
from nodey_tpu_torch.core.registry import PinAttribute, Processor, ProcessorInfo
from nodey_tpu_torch.core.stream import AudioStreamType
from nodey_tpu_torch.ops import fadepan

_DESCRIPTION = """Pan / Balance

## Functionality
- Stereo input: balance law (center attenuates nothing — bitwise
  passthrough at 0; panning right attenuates the left channel and
  vice versa)
- Mono input: constant-power placement into a stereo output
- Output is always stereo

## Usage
- Connect an audio stream to 'Input'
- Drag 'Pan' between -1 (hard left) and +1 (hard right)
"""


class AudioPan(Processor):
    batched = True  # per-channel gains on axis -2 of any clip or batch
    _CLAMPS = {"pan": (-1.0, 1.0)}

    def __init__(self) -> None:
        self.pan: float = 0.0

    def info(self) -> ProcessorInfo:
        return ProcessorInfo(
            identifier="audio_pan",
            display_name="Pan / Balance",
            singleton=False,
            generate=AudioPan,
            description=_DESCRIPTION,
        )

    def pin_attributes(self) -> List[PinAttribute]:
        return [
            PinAttribute("output", "Output", AudioStreamType, is_input=False),
            PinAttribute("input", "Input", AudioStreamType, is_input=True),
        ]

    def set_param(self, key: str, value: float) -> None:
        lohi = self._CLAMPS.get(key)
        if lohi is not None:
            setattr(self, key, min(max(float(value), lohi[0]), lohi[1]))

    def param_spec(self) -> List[Dict[str, Any]]:
        return [{
            "key": "pan", "label": "Pan", "kind": "float",
            "min": -1.0, "max": 1.0, "step": 0.01, "value": self.pan,
        }]

    def serialize(self) -> Any:
        return {"pan": self.pan}

    def deserialize(self, value: Any) -> None:
        if isinstance(value, dict):
            v = value.get("pan")
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                self.set_param("pan", float(v))

    def _require(self, inputs):
        value = inputs.get("input")
        if value is None:
            raise ProcessorRuntimeError(
                "Pan has no input",
                "This node requires an audio stream input.",
                "Input item 'input' not found",
            )
        return value

    def lower(self, ctx, inputs: Dict[str, Any]) -> Dict[str, Any]:
        stream = self._require(inputs)
        return {"output": fadepan.pan_stream(stream, self.pan)}

    # -- chunk-streaming: stateless per-channel gain ---------------------------

    def plan_stream(self, ctx, in_specs):
        spec = self._require(in_specs)
        if spec.channels == 2 and self.pan == 0.0:
            self._stream_pan = None
            return {"output": spec}, None
        self._stream_pan = float(self.pan)
        return {"output": spec.replace(channels=2, fmt="flt")}, None

    def lower_stream(self, ctx, inputs, state):
        chunk = self._require(inputs)
        if self._stream_pan is None:
            return {"output": chunk}, state
        out = fadepan.pan_array(chunk.data, self._stream_pan)
        return {"output": chunk.with_data(out, fmt="flt")}, state


_WIDTH_DESCRIPTION = """Stereo Width

## Functionality
- Mid/side width control: 0 collapses to mono, 1 is untouched
  (bitwise passthrough), 2 doubles the side signal
- Mono inputs pass through unchanged (no side signal to scale)

## Usage
- Connect a stereo stream to 'Input'
- Lower 'Width' to tighten the image, raise it to widen
"""


class AudioWidth(Processor):
    """Mid/side stereo width (ops/fadepan.width_array): a constant 2x2
    channel matrix scaling the side signal — memoryless + time-
    invariant like the pan, so it joins the LTI overlap-discard set and
    streams statelessly. Width 1.0 and mono inputs are bitwise
    passthroughs."""

    batched = True  # the channel matrix on axis -2
    _CLAMPS = {"width": (0.0, 2.0)}

    def __init__(self) -> None:
        self.width: float = 1.0

    def info(self) -> ProcessorInfo:
        return ProcessorInfo(
            identifier="audio_width",
            display_name="Stereo Width",
            singleton=False,
            generate=AudioWidth,
            description=_WIDTH_DESCRIPTION,
        )

    def pin_attributes(self) -> List[PinAttribute]:
        return [
            PinAttribute("output", "Output", AudioStreamType, is_input=False),
            PinAttribute("input", "Input", AudioStreamType, is_input=True),
        ]

    def set_param(self, key: str, value: float) -> None:
        lohi = self._CLAMPS.get(key)
        if lohi is not None:
            setattr(self, key, min(max(float(value), lohi[0]), lohi[1]))

    def param_spec(self) -> List[Dict[str, Any]]:
        return [{
            "key": "width", "label": "Width", "kind": "float",
            "min": 0.0, "max": 2.0, "step": 0.01, "value": self.width,
        }]

    def serialize(self) -> Any:
        return {"width": self.width}

    def deserialize(self, value: Any) -> None:
        if isinstance(value, dict):
            v = value.get("width")
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                self.set_param("width", float(v))

    def _require(self, inputs):
        value = inputs.get("input")
        if value is None:
            raise ProcessorRuntimeError(
                "Stereo Width has no input",
                "This node requires an audio stream input.",
                "Input item 'input' not found",
            )
        return value

    def lower(self, ctx, inputs: Dict[str, Any]) -> Dict[str, Any]:
        stream = self._require(inputs)
        return {"output": fadepan.width_stream(stream, self.width)}

    # -- chunk-streaming: stateless channel matrix -----------------------------

    def plan_stream(self, ctx, in_specs):
        spec = self._require(in_specs)
        if self.width == 1.0 or spec.channels != 2:
            self._stream_width = None
            return {"output": spec}, None
        self._stream_width = float(self.width)
        return {"output": spec.replace(fmt="flt")}, None

    def lower_stream(self, ctx, inputs, state):
        chunk = self._require(inputs)
        if self._stream_width is None:
            return {"output": chunk}, state
        out = fadepan.width_array(chunk.data, self._stream_width)
        return {"output": chunk.with_data(out, fmt="flt")}, state
