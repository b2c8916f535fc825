"""Audio output node — the graph's sink (port of
nodey_tpu.processors.audio_output).

Reference: ``processor::Audio_output`` (src/processor/audio-io.cpp:429-868).
* export: emit the master at its native rate for the encoder;
* preview: 48 kHz stereo float, clamped to +/-1 (audio-io.cpp:532-618).
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from nodey_tpu_torch import config
from nodey_tpu_torch.core.errors import ProcessorRuntimeError
from nodey_tpu_torch.core.registry import PinAttribute, Processor, ProcessorInfo
from nodey_tpu_torch.core.stream import FMT_FLT, AudioStreamType
from nodey_tpu_torch.ops import resample as resample_ops

_DESCRIPTION = """Audio Output Processor

## Functionality
- Terminal sink of the graph: real-time preview or MP3 export
- Preview renders 48kHz 32-bit float stereo
- Export encodes MP3 CBR via LAME at the configured bitrate

## Usage
- Connect the processed stream to the 'Input' pin
"""


class AudioOutput(Processor):
    """Singleton sink node (reference: src/processor/audio-io.cpp:429-446)."""

    def info(self) -> ProcessorInfo:
        return ProcessorInfo(
            identifier="audio_output",
            display_name="Audio Output",
            singleton=True,
            generate=AudioOutput,
            description=_DESCRIPTION,
        )

    def pin_attributes(self) -> List[PinAttribute]:
        return [
            PinAttribute(
                identifier="input",
                display_name="Input",
                type=AudioStreamType,
                is_input=True,
            )
        ]

    def lower(self, ctx, inputs: Dict[str, Any]) -> Dict[str, Any]:
        stream = inputs.get("input")
        if stream is None:
            # Reference: audio-io.cpp:854-862.
            raise ProcessorRuntimeError(
                "Audio output processor has no input",
                "Audio output requires an audio stream input to function "
                "properly.",
                "Input item 'input' not found",
            )
        if ctx.mode == "export":
            ctx.emit("master", stream)
        else:
            out = resample_ops.to_rate_and_stereo(stream, config.SAMPLE_RATE)
            clamped = torch.clamp(out.data, -1.0, 1.0)
            ctx.emit("preview", out.with_data(clamped, fmt=FMT_FLT))
        return {}
