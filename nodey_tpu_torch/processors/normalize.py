"""Normalize node — peak or integrated-loudness (BS.1770-4) gain (port
of nodey_tpu.processors.normalize; the reference's gain node is a static
slider, src/processor/audio-vol.cpp:75-100).

Whole-clip and two-pass by construction: the gain does not exist until
the measurement has seen every sample (the LUFS relative gate needs the
full block set; a peak needs the global max). So the node renders
offline, and ``plan_stream`` refuses chunk streaming with
``UnstreamableGraphError``: ``Runner.export_streamed`` then renders the
export offline on the same device.

Measurement and gain live in ops/loudness.py.
"""

from __future__ import annotations

from typing import Any, Dict, List

from nodey_tpu_torch.core.errors import (ProcessorRuntimeError,
                                         UnstreamableGraphError)
from nodey_tpu_torch.core.registry import PinAttribute, Processor, ProcessorInfo
from nodey_tpu_torch.core.stream import AudioStreamType
from nodey_tpu_torch.ops import loudness as ld

_DESCRIPTION = """Normalize

## Functionality
- Scales the whole clip to a target level
- 'lufs' mode: integrated loudness per ITU-R BS.1770-4 (K-weighting,
  -70 LKFS absolute + relative gating)
- 'peak' mode: sample peak to the target dBFS
- Whole-clip (two-pass): streamed exports fall back to offline

## Usage
- Connect an audio stream to 'Input'
- Pick a mode and target (-14 LUFS is the common streaming target;
  -1 dBFS a typical peak ceiling)
"""


class AudioNormalize(Processor):
    batched = True  # each clip measured on its own, a [B, 1, 1] gain

    _CLAMPS = {"target_db": (-60.0, 0.0)}
    _MODES = ("lufs", "peak")

    def __init__(self) -> None:
        self.mode: str = "lufs"
        self.target_db: float = -14.0

    def info(self) -> ProcessorInfo:
        return ProcessorInfo(
            identifier="audio_normalize",
            display_name="Normalize",
            singleton=False,
            generate=AudioNormalize,
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

    def set_mode(self, value: str) -> None:
        if value in self._MODES:
            self.mode = value

    def param_spec(self) -> List[Dict[str, Any]]:
        return [
            {"key": "mode", "label": "Mode", "kind": "enum",
             "choices": list(self._MODES), "value": self.mode},
            {"key": "target_db", "label": "Target (LUFS / dBFS)",
             "kind": "float", "min": -60.0, "max": 0.0, "step": 0.1,
             "value": self.target_db},
        ]

    def serialize(self) -> Any:
        return {"mode": self.mode, "target_db": self.target_db}

    def deserialize(self, value: Any) -> None:
        if isinstance(value, dict):
            v = value.get("target_db")
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                self.set_param("target_db", float(v))
            mode = value.get("mode")
            if isinstance(mode, str):
                self.set_mode(mode)

    def _require(self, inputs):
        value = inputs.get("input")
        if value is None:
            raise ProcessorRuntimeError(
                "Normalize has no input",
                "This node requires an audio stream input.",
                "Input item 'input' not found",
            )
        return value

    def lower(self, ctx, inputs: Dict[str, Any]) -> Dict[str, Any]:
        stream = self._require(inputs)
        if self.mode == "peak":
            gain = ld.normalize_gain_peak(
                stream.data, stream.length, self.target_db
            )
        else:
            gain = ld.normalize_gain_lufs(
                stream.data, stream.length, stream.rate, self.target_db,
                clips=stream.batch is not None,
            )
        return {"output": stream.with_data(
            stream.data * gain, fmt="flt"
        )}

    # -- chunk-streaming: refused (two-pass whole-clip measurement) -------------

    def plan_stream(self, ctx, in_specs):
        self._require(in_specs)
        raise UnstreamableGraphError(
            "Normalize cannot stream",
            "Loudness/peak normalization is a two-pass whole-clip "
            "operation (the gain needs the full measurement before the "
            "first output sample); the export falls back to the "
            "offline render path, which handles it exactly.",
            f"audio_normalize mode={self.mode}",
        )
