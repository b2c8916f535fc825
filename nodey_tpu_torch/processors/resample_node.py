"""Explicit resample node (port of nodey_tpu.processors.resample_node).

The reference resamples implicitly inside mixers and the output sink via
libswresample; BASELINE config 4 ("44.1k->48k polyphase") calls for an
explicit node. Output: float, original channel count. Streamed, the tap
history rides in a FIFO carry (ops/chunkops.py).
"""

from __future__ import annotations

from typing import Any, Dict, List

from nodey_tpu_torch.core import chunkflow
from nodey_tpu_torch.core.errors import ProcessorRuntimeError
from nodey_tpu_torch.core.registry import PinAttribute, Processor, ProcessorInfo
from nodey_tpu_torch.core.stream import AudioStreamType
from nodey_tpu_torch.ops import resample as resample_ops


class AudioResample(Processor):
    batched = True  # clips fold into the resampler's rows

    def __init__(self) -> None:
        self.target_rate: int = 48_000

    def info(self) -> ProcessorInfo:
        return ProcessorInfo(
            identifier="audio_resample",
            display_name="Resample",
            singleton=False,
            generate=AudioResample,
            description=(
                "Polyphase Resampler\n\n## Functionality\n"
                "- Converts a stream to a target sample rate\n"
                "- Kaiser windowed-sinc polyphase filter, libswresample-"
                "matched quality\n"
            ),
        )

    def pin_attributes(self) -> List[PinAttribute]:
        return [
            PinAttribute("output", "Output", AudioStreamType, is_input=False),
            PinAttribute("input", "Input", AudioStreamType, is_input=True),
        ]

    def set_target_rate(self, rate: int) -> None:
        if not 4_000 <= int(rate) <= 192_000:
            raise ProcessorRuntimeError(
                "Unsupported target sample rate",
                "Resample node supports 4000-192000 Hz.",
                f"Target rate: {rate}",
            )
        self.target_rate = int(rate)

    def param_spec(self) -> List[Dict[str, Any]]:
        rates = [8_000, 16_000, 22_050, 32_000, 44_100, 48_000,
                 88_200, 96_000, 176_400, 192_000]
        if self.target_rate not in rates:
            rates = sorted(rates + [self.target_rate])
        return [{"key": "target_rate", "label": "Target Rate (Hz)",
                 "kind": "enum", "choices": rates,
                 "value": self.target_rate}]

    def serialize(self) -> Any:
        return {"target_rate": self.target_rate}

    def deserialize(self, value: Any) -> None:
        if isinstance(value, dict):
            rate = value.get("target_rate")
            if isinstance(rate, (int, float)) and not isinstance(rate, bool):
                # Tolerant load clamps to the setter's supported range: a
                # hand-edited target_rate of 0 must not reach the rational
                # reduction or explode the phase bank.
                self.target_rate = min(max(int(rate), 4_000), 192_000)

    @staticmethod
    def _require(inputs):
        value = inputs.get("input")
        if value is None:
            raise ProcessorRuntimeError(
                "Resample processor has no input",
                "Resample requires an audio stream input to function properly.",
                "Input item 'input' not found",
            )
        return value

    def lower(self, ctx, inputs: Dict[str, Any]) -> Dict[str, Any]:
        return {"output": resample_ops.resample_stream(self._require(inputs),
                                                       self.target_rate)}

    def plan_stream(self, ctx, in_specs):
        # The plan is geometry and the bank; it lives on the instance, the
        # carry holds only the FIFO.
        out_spec, state, self._stream_plan = chunkflow.plan_resample_stage(
            self._require(in_specs), self.target_rate, ctx.device)
        return {"output": out_spec}, state

    def lower_stream(self, ctx, inputs, state):
        state, out = chunkflow.run_resample_stage(
            self._stream_plan, state, self._require(inputs), self.target_rate)
        return {"output": out}, state
