"""Channel split node (port of nodey_tpu.processors.split).

No reference counterpart ships: BASELINE config 2 ("Channel split ->
per-channel gain -> merge") needs one, the inverse of the bimix merge
nodes. A stereo stream splits into two mono streams; a mono input goes to
both outputs.
"""

from __future__ import annotations

from typing import Any, Dict, List

from nodey_tpu_torch.core.errors import ProcessorRuntimeError
from nodey_tpu_torch.core.registry import PinAttribute, Processor, ProcessorInfo
from nodey_tpu_torch.core.stream import AudioStreamType
from nodey_tpu_torch.ops import mix as mix_ops


class AudioSplit(Processor):
    batched = True  # channels sliced on the second axis from the end

    def info(self) -> ProcessorInfo:
        return ProcessorInfo(
            identifier="audio_split",
            display_name="Channel Split",
            singleton=False,
            generate=AudioSplit,
            description=(
                "Stereo Channel Splitter\n\n## Functionality\n"
                "- Splits a stereo stream into left/right mono streams\n"
                "- Mono input is duplicated to both outputs\n"
            ),
        )

    def pin_attributes(self) -> List[PinAttribute]:
        return [
            PinAttribute("output_l", "Left", AudioStreamType, is_input=False),
            PinAttribute("output_r", "Right", AudioStreamType, is_input=False),
            PinAttribute("input", "Input", AudioStreamType, is_input=True),
        ]

    @staticmethod
    def _require(inputs):
        value = inputs.get("input")
        if value is None:
            raise ProcessorRuntimeError(
                "Channel split processor has no input",
                "Channel split requires an audio stream input to function "
                "properly.",
                "Input item 'input' not found",
            )
        return value

    def lower(self, ctx, inputs: Dict[str, Any]) -> Dict[str, Any]:
        left, right = mix_ops.split_channels(self._require(inputs))
        return {"output_l": left, "output_r": right}

    # -- chunk streaming: stateless channel slicing ---------------------------

    def plan_stream(self, ctx, in_specs):
        spec = self._require(in_specs)
        mono = spec.replace(channels=1) if spec.channels == 2 else spec
        return {"output_l": mono, "output_r": mono}, None

    def lower_stream(self, ctx, inputs, state):
        chunk = self._require(inputs)
        if chunk.spec.channels == 1:
            return {"output_l": chunk, "output_r": chunk}, state
        return {"output_l": chunk.with_data(chunk.data[0:1]),
                "output_r": chunk.with_data(chunk.data[1:2])}, state
