"""Volume adjustment node (port of nodey_tpu.processors.audio_vol).

Reference: ``processor::Audio_vol`` (src/processor/audio-vol.cpp). Like
the reference, the project file persists nothing for this node
(audio-vol.hpp:57-58): a JSON round trip resets the volume to 1.0, while
``snapshot_params`` carries it (nodey_tpu_torch.convert uses that).
"""

from __future__ import annotations

from typing import Any, Dict, List

from nodey_tpu_torch import config
from nodey_tpu_torch.core.errors import ProcessorRuntimeError
from nodey_tpu_torch.core.registry import PinAttribute, Processor, ProcessorInfo
from nodey_tpu_torch.core.stream import AudioStreamType
from nodey_tpu_torch.ops import gain as gain_ops

_DESCRIPTION = """Audio Volume Adjuster

## Functionality
- Adjusts the volume of audio streams by a specified factor
- Supports mono and stereo audio formats

## Usage
- Connect audio input streams to the 'Input' pin
- Set the desired volume adjustment factor
"""


class AudioVol(Processor):
    def __init__(self) -> None:
        self.volume: float = 1.0

    def info(self) -> ProcessorInfo:
        return ProcessorInfo(
            identifier="audio_volume_adjust",
            display_name="Adjust Volume",
            singleton=False,
            generate=AudioVol,
            description=_DESCRIPTION,
        )

    def pin_attributes(self) -> List[PinAttribute]:
        return [
            PinAttribute("output", "Output", AudioStreamType, is_input=False),
            PinAttribute("input", "Input", AudioStreamType, is_input=True),
        ]

    def set_volume(self, volume: float) -> None:
        """Clamped setter (reference slider bounds: audio-vol.cpp:262-270)."""
        self.volume = min(max(float(volume), 0.0), config.AUDIO_VOLUME_MAX)

    def snapshot_params(self) -> Dict[str, Any]:
        return {"volume": self.volume}

    def restore_params(self, blob: Any) -> None:
        if isinstance(blob, dict) and "volume" in blob:
            self.set_volume(blob["volume"])

    def lower(self, ctx, inputs: Dict[str, Any]) -> Dict[str, Any]:
        return {"output": gain_ops.apply_gain(self._require(inputs),
                                              self.volume)}

    # -- chunk streaming: gain is stateless elementwise work ------------------

    def plan_stream(self, ctx, in_specs):
        return {"output": self._require(in_specs)}, None

    def lower_stream(self, ctx, inputs, state):
        chunk = self._require(inputs)
        data = gain_ops.gain_array(chunk.data, self.volume, chunk.spec.fmt)
        return {"output": chunk.with_data(data)}, state

    def _require(self, inputs):
        value = inputs.get("input")
        if value is None:
            raise ProcessorRuntimeError(
                "Volume adjust processor has no input",
                "Volume adjust processor requires an audio stream input to "
                "function properly.",
                "Input item 'input' not found",
            )
        return value
