"""Convolution reverb node (port of nodey_tpu.processors.reverb).

Runs on ops/reverb.py: a host-synthesized impulse response with a
frequency-dependent decay, convolved by uniform-partition overlap-save
real-DFT GEMMs. Wet 0 with dry 1 is a bitwise passthrough. The node is
time-invariant; its receptive field (the partitioned IR) is declared as
``receptive_seconds`` and its overlap-save hop as ``hop``, so the chunked
renderer sizes its halo and aligns its chunks (core/streaming.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

from nodey_tpu_torch.core.errors import ProcessorRuntimeError
from nodey_tpu_torch.core.registry import PinAttribute, Processor, ProcessorInfo
from nodey_tpu_torch.core.stream import AudioStreamType
from nodey_tpu_torch.ops import reverb as reverb_ops
from nodey_tpu_torch.ops.scans import f32 as _f32

_DESCRIPTION = """Reverb

## Functionality
- Convolution reverb with a synthesized room impulse response
- Decay time (RT60), pre-delay, high-frequency damping, wet/dry mix
- Output extends past the input by the reverb tail

## Usage
- Connect an audio stream to 'Input'
- Wet 0 is a bitwise passthrough (with Dry 1)
"""


class AudioReverb(Processor):
    batched = True  # the FDL on every clip, its GEMMs clip by clip

    _CLAMPS = {
        "decay_s": (0.1, 8.0),
        "pre_delay_ms": (0.0, 200.0),
        "damping": (0.0, 1.0),
        "wet": (0.0, 1.0),
        "dry": (0.0, 1.0),
    }

    def __init__(self) -> None:
        self.decay_s: float = 1.8
        self.pre_delay_ms: float = 20.0
        self.damping: float = 0.5
        self.wet: float = 0.35
        self.dry: float = 1.0

    # Overlap-save hop for the chunk quantum: chunk boundaries at multiples
    # of the partition keep the hop grid aligned with the whole clip's.
    @property
    def hop(self) -> int:
        return reverb_ops.PARTITION if self.wet > 0.0 else 0

    @property
    def receptive_seconds(self) -> float:
        """Receptive field for halo sizing: the whole PARTITIONED IR (K*P
        samples, not just L), so kept chunk outputs never reach a window's
        zero-context first hop. The 2P/4000 margin covers both the
        partition rounding and the 1024-sample IR floor at any supported
        rate (>= 4 kHz)."""
        if self.wet == 0.0:
            return 0.0
        return (
            float(self.decay_s)
            + float(self.pre_delay_ms) * 1e-3
            + 2.0 * reverb_ops.PARTITION / 4000.0
        )

    def info(self) -> ProcessorInfo:
        return ProcessorInfo(
            identifier="audio_reverb",
            display_name="Reverb",
            singleton=False,
            generate=AudioReverb,
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
            {"key": "decay_s", "label": "Decay RT60 (s)", "kind": "float",
             "min": 0.1, "max": 8.0, "step": 0.05, "log": True,
             "value": self.decay_s},
            {"key": "pre_delay_ms", "label": "Pre-delay (ms)",
             "kind": "float", "min": 0.0, "max": 200.0, "step": 1.0,
             "value": self.pre_delay_ms},
            {"key": "damping", "label": "HF Damping", "kind": "float",
             "min": 0.0, "max": 1.0, "step": 0.01, "value": self.damping},
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
                "Reverb has no input",
                "This node requires an audio stream input.",
                "Input item 'input' not found",
            )
        return value

    def lower(self, ctx, inputs: Dict[str, Any]) -> Dict[str, Any]:
        stream = self._require(inputs)
        if self.wet == 0.0 and self.dry == 1.0:
            return {"output": stream}          # bitwise passthrough
        return {"output": reverb_ops.reverb_stream(
            stream, self.decay_s, self.pre_delay_ms, self.damping,
            self.wet, self.dry,
        )}

    # -- chunk-streaming: output ring + flush-tail carry ----------------------

    def plan_stream(self, ctx, in_specs):
        spec = self._require(in_specs)
        if self.wet == 0.0 and self.dry == 1.0:
            self._stream_params = None
            return {"output": spec}, {}
        if self.wet == 0.0:
            self._stream_params = ()
            return {"output": spec.replace(fmt="flt")}, {}
        hr, hi = reverb_ops.reverb_stream_prepare(
            spec.rate, spec.channels, self.decay_s, self.pre_delay_ms,
            self.damping, ctx.device,
        )
        ir_len = reverb_ops.ir_length(
            spec.rate, self.decay_s, self.pre_delay_ms
        )
        self._stream_params = (hr, hi, ir_len, self.wet, self.dry)
        state = {"rv": reverb_ops.reverb_stream_init(
            spec.channels, spec.width, ir_len, self.wet, ctx.device
        )}
        return {"output": spec.replace(fmt="flt")}, state

    def lower_stream(self, ctx, inputs, state):
        chunk = self._require(inputs)
        if self._stream_params is None:
            return {"output": chunk}, state
        if self._stream_params == ():
            return {"output": chunk.with_data(
                _f32(self.dry) * chunk.data, fmt="flt"
            )}, state
        new_rv, out, out_n, done = reverb_ops.reverb_stream_step(
            self._stream_params, state["rv"], chunk.data, chunk.n,
            chunk.done,
        )
        out_chunk = dataclasses.replace(
            chunk.with_data(out, fmt="flt"), n=out_n, done=done
        )
        return {"output": out_chunk}, {"rv": new_rv}
