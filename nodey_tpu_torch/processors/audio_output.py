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
from nodey_tpu_torch.core import chunkflow
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

    @staticmethod
    def _require(inputs):
        value = inputs.get("input")
        if value is None:
            # Reference: audio-io.cpp:854-862.
            raise ProcessorRuntimeError(
                "Audio output processor has no input",
                "Audio output requires an audio stream input to function "
                "properly.",
                "Input item 'input' not found",
            )
        return value

    def lower(self, ctx, inputs: Dict[str, Any]) -> Dict[str, Any]:
        stream = self._require(inputs)
        if ctx.mode == "export":
            ctx.emit("master", stream)
        else:
            out = resample_ops.to_rate_and_stereo(stream, config.SAMPLE_RATE)
            clamped = torch.clamp(out.data, -1.0, 1.0)
            ctx.emit("preview", out.with_data(clamped, fmt=FMT_FLT))
        return {}

    # -- chunk streaming: export emits the master chunk as it is; preview
    #    resamples to 48 kHz stereo through a streaming stage and clamps ------

    def plan_stream(self, ctx, in_specs):
        spec = self._require(in_specs)
        if ctx.mode == "export":
            ctx.emit_spec("master", {"kind": "stream", "rate": spec.rate,
                                     "channels": spec.channels,
                                     "fmt": spec.fmt})
            return {}, None
        _spec, state, self._rs_plan = chunkflow.plan_resample_stage(
            spec.replace(channels=2, fmt="flt"), config.SAMPLE_RATE,
            ctx.device)
        ctx.emit_spec("preview", {"kind": "stream", "rate": config.SAMPLE_RATE,
                                  "channels": 2, "fmt": "flt"})
        return {}, state

    def lower_stream(self, ctx, inputs, state):
        chunk = self._require(inputs)
        if ctx.mode == "export":
            ctx.emit("master", chunk)
            return {}, state
        state, out = chunkflow.run_resample_stage(
            self._rs_plan, state, chunkflow.to_stereo_chunk(chunk),
            config.SAMPLE_RATE)
        ctx.emit("preview", out.with_data(torch.clamp(out.data, -1.0, 1.0),
                                          fmt=FMT_FLT))
        return {}, state
