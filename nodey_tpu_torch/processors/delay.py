"""Feedback delay (echo) node (port of nodey_tpu.processors.delay).

Runs on ops/delay.py: an exact K-echo truncated geometric comb (echoes
below -60 dB are cut, so the kernel is a finite FIR) evaluated by
square-and-multiply in ~2*log2(K) shifted multiply-adds. Wet 0 with dry 1
is a bitwise passthrough. The node is time-invariant with a finite
receptive field (K*D samples, declared as ``receptive_seconds``); the
output grows by the echo tail, which a stream flushes after its input
ends.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

from nodey_tpu_torch.core.errors import ProcessorRuntimeError
from nodey_tpu_torch.core.registry import PinAttribute, Processor, ProcessorInfo
from nodey_tpu_torch.core.stream import AudioStreamType
from nodey_tpu_torch.ops import delay as delay_ops
from nodey_tpu_torch.ops.scans import f32 as _f32

_DESCRIPTION = """Delay


## Functionality
- Feedback delay line (echo): delay time, feedback, wet/dry mix
- Echo train truncated at -60 dB (exact finite comb)
- Output extends past the input by the echo tail

## Usage
- Connect an audio stream to 'Input'
- Wet 0 is a bitwise passthrough (with Dry 1)
"""


class AudioDelay(Processor):
    batched = True  # a static tail: every clip's length grows by it
    _CLAMPS = {
        "delay_ms": (10.0, 1000.0),
        "feedback": (0.0, 0.9),
        "wet": (0.0, 1.0),
        "dry": (0.0, 1.0),
    }

    def __init__(self) -> None:
        self.delay_ms: float = 300.0
        self.feedback: float = 0.45
        self.wet: float = 0.35
        self.dry: float = 1.0

    @property
    def receptive_seconds(self) -> float:
        """Receptive field for halo sizing: the full K*D comb span. D
        rounds to samples, so K * delay_ms underestimates by at most
        K * 0.5/rate; the K/4000 margin covers that at any supported rate
        (>= 2 kHz)."""
        if self.wet == 0.0:
            return 0.0
        _d, k = delay_ops.delay_params(48_000, self.delay_ms, self.feedback)
        return k * (float(self.delay_ms) * 1e-3 + 1.0 / 4000.0)

    def info(self) -> ProcessorInfo:
        return ProcessorInfo(
            identifier="audio_delay",
            display_name="Delay",
            singleton=False,
            generate=AudioDelay,
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
        return [
            {"key": "delay_ms", "label": "Delay (ms)", "kind": "float",
             "min": 10.0, "max": 1000.0, "step": 1.0, "log": True,
             "value": self.delay_ms},
            {"key": "feedback", "label": "Feedback", "kind": "float",
             "min": 0.0, "max": 0.9, "step": 0.01, "value": self.feedback},
            {"key": "wet", "label": "Wet", "kind": "float", "min": 0.0,
             "max": 1.0, "step": 0.01, "value": self.wet},
            {"key": "dry", "label": "Dry", "kind": "float", "min": 0.0,
             "max": 1.0, "step": 0.01, "value": self.dry},
        ]

    def serialize(self) -> Any:
        return {k: getattr(self, k) for k in self._CLAMPS}

    def deserialize(self, value: Any) -> None:
        if isinstance(value, dict):
            for k, v in value.items():
                if (isinstance(v, (int, float))
                        and not isinstance(v, bool)):
                    self.set_param(k, float(v))

    def _require(self, inputs):
        value = inputs.get("input")
        if value is None:
            raise ProcessorRuntimeError(
                "Delay has no input",
                "This node requires an audio stream input.",
                "Input item 'input' not found",
            )
        return value

    def lower(self, ctx, inputs: Dict[str, Any]) -> Dict[str, Any]:
        stream = self._require(inputs)
        if self.wet == 0.0 and self.dry == 1.0:
            return {"output": stream}          # bitwise passthrough
        return {"output": delay_ops.delay_stream(
            stream, self.delay_ms, self.feedback, self.wet, self.dry,
        )}

    # -- chunk-streaming: input-history ring + flush-tail carry ----------------

    def plan_stream(self, ctx, in_specs):
        spec = self._require(in_specs)
        if self.wet == 0.0 and self.dry == 1.0:
            self._stream_params = None
            return {"output": spec}, {}
        if self.wet == 0.0:
            self._stream_params = ()
            return {"output": spec.replace(fmt="flt")}, {}
        d, k = delay_ops.delay_params(
            spec.rate, self.delay_ms, self.feedback
        )
        self._stream_params = (
            d, k, float(self.feedback), float(self.wet), float(self.dry)
        )
        state = {"dl": delay_ops.delay_stream_init(spec.channels, d, k,
                                                   ctx.device)}
        return {"output": spec.replace(fmt="flt")}, state

    def lower_stream(self, ctx, inputs, state):
        chunk = self._require(inputs)
        if self._stream_params is None:
            return {"output": chunk}, state
        if self._stream_params == ():
            return {"output": chunk.with_data(
                _f32(self.dry) * chunk.data, fmt="flt"
            )}, state
        new_dl, out, out_n, done = delay_ops.delay_stream_step(
            self._stream_params, state["dl"], chunk.data, chunk.n,
            chunk.done,
        )
        out_chunk = dataclasses.replace(
            chunk.with_data(out, fmt="flt"), n=out_n, done=done
        )
        return {"output": out_chunk}, {"dl": new_dl}
