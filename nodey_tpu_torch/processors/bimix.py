"""Two-input channel combiner nodes, bimix v1 and v2 (port of
nodey_tpu.processors.bimix).

Reference: ``processor::Audio_bimix`` / ``Audio_bimix_v2``
(src/processor/audio-bimix.cpp).

v1 (audio-bimix.cpp:90-330): per side, resample to 48 kHz stereo and
average to mono; the left side's mono becomes the L channel scaled by
(1 - bias), the right side's the R channel scaled by (1 + bias). Samples
pair from the start of each stream; a side that ends early contributes
silence.

v2 (audio-bimix.cpp:455-875): the same per-side mono, placed on a shared
48 kHz grid at each side's own start timestamp, the other channel zero
where only one side has samples. No parameters (serialize is {},
audio-bimix.cpp:444-449).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from nodey_tpu_torch import config
from nodey_tpu_torch.core import chunkflow
from nodey_tpu_torch.core.errors import ProcessorRuntimeError
from nodey_tpu_torch.core.registry import PinAttribute, Processor, ProcessorInfo
from nodey_tpu_torch.core.stream import AudioStreamType
from nodey_tpu_torch.ops import mix as mix_ops


def _bimix_pins() -> List[PinAttribute]:
    # Reference: audio-bimix.cpp:51-80 / 411-442.
    return [
        PinAttribute("output", "Output", AudioStreamType, is_input=False),
        PinAttribute("input_l", "Left", AudioStreamType, is_input=True),
        PinAttribute("input_r", "Right", AudioStreamType, is_input=True),
    ]


def _require_inputs(inputs: Dict[str, Any]):
    left = inputs.get("input_l")
    right = inputs.get("input_r")
    if left is None or right is None:
        # Reference: audio-bimix.cpp:105-113 / 484-490.
        raise ProcessorRuntimeError(
            "Audio Channel mix processor has no input",
            "Audio channel mix processor requires an audio stream input to "
            "function properly.",
            "Input item 'input' not found",
        )
    return left, right


def _bad_bias() -> ProcessorRuntimeError:
    return ProcessorRuntimeError(
        "Failed to deserialize JSON file",
        "Audio_bimix failed to serialize the JSON input because of "
        "missing or invalid fields.",
        "Wrong field: bias",
    )


class _BimixStreamBase(Processor):
    """The chunk streaming of both variants: per side a streaming resample
    stage to the 48 kHz grid and the mono mean, then an aligned merge whose
    FIFOs v2 prefills with each side's placement offset in silence."""

    def _prefills(self, specs) -> list:
        self._t0_out = 0.0
        return [0, 0]

    def _combine(self, win_l: torch.Tensor, win_r: torch.Tensor):
        raise NotImplementedError

    def plan_stream(self, ctx, in_specs):
        _require_inputs(in_specs)
        self._rs_plans = []
        rs_states = []
        normed = []
        for name in ("input_l", "input_r"):
            spec = in_specs[name].replace(channels=2, fmt="flt")
            out_spec, st, plan = chunkflow.plan_resample_stage(
                spec, config.BIMIX_STD_SAMPLE_RATE, ctx.device)
            self._rs_plans.append(plan)
            rs_states.append(st)
            normed.append(out_spec.replace(channels=1))
        self._merge_plan, merge_fifos = chunkflow.plan_aligned_merge(
            normed, self._prefills(in_specs), ctx.device)
        out_spec = chunkflow.ChunkSpec(
            rate=config.BIMIX_STD_SAMPLE_RATE, channels=2, fmt="flt",
            width=self._merge_plan["take_cap"], t0_us=self._t0_out,
            cadence=normed[0].cadence,
        )
        return {"output": out_spec}, {"rs": rs_states, "merge": merge_fifos}

    def lower_stream(self, ctx, inputs, state):
        rs_states = []
        monos = []
        for chunk, plan, st in zip(_require_inputs(inputs), self._rs_plans,
                                   state["rs"]):
            st, out = chunkflow.run_resample_stage(
                plan, st, chunkflow.to_stereo_chunk(chunk),
                config.BIMIX_STD_SAMPLE_RATE)
            rs_states.append(st)
            monos.append(chunkflow.side_mono_chunk(out))
        merge, windows, take, done = chunkflow.run_aligned_merge(
            self._merge_plan, state["merge"], monos)
        data = self._combine(windows[0], windows[1])
        out = chunkflow.ChunkStream(
            data=data, n=take, done=done,
            spec=chunkflow.ChunkSpec(
                rate=config.BIMIX_STD_SAMPLE_RATE, channels=2, fmt="flt",
                width=data.shape[1], t0_us=self._t0_out,
            ),
        )
        return {"output": out}, {"rs": rs_states, "merge": merge}


class AudioBimix(_BimixStreamBase):
    batched = True  # per-side resample, channel axis -2, per-clip lengths

    def __init__(self) -> None:
        # Default: include/processor/audio-bimix.hpp:36.
        self.bias: float = 0.0

    def _combine(self, win_l, win_r):
        return torch.cat([win_l * float(np.float32(1.0 - self.bias)),
                          win_r * float(np.float32(1.0 + self.bias))], dim=0)

    def info(self) -> ProcessorInfo:
        return ProcessorInfo(
            identifier="audio_bimix",
            display_name="Audio Bimix",
            singleton=False,
            generate=AudioBimix,
            description=(
                "Stereo Channel Mixer\n\n## Functionality\n"
                "- Combine two streams into one stereo stream with bias\n"
                "- Output: 48kHz 32-bit float stereo\n"
            ),
        )

    def pin_attributes(self) -> List[PinAttribute]:
        return _bimix_pins()

    def set_bias(self, bias: float) -> None:
        """Clamped setter (reference: audio-bimix.cpp:348-349)."""
        self.bias = min(max(float(bias), -1.0), 1.0)

    def param_spec(self) -> List[Dict[str, Any]]:
        # The reference's DragFloat "Bias", step 0.005, -1..1, "%.3f"
        # (audio-bimix.cpp:348).
        return [{"key": "bias", "label": "Bias", "kind": "float",
                 "min": -1.0, "max": 1.0, "step": 0.005,
                 "value": self.bias}]

    # -- serde (reference: audio-bimix.cpp:358-383) ---------------------------

    def serialize(self) -> Any:
        return {"bias": self.bias}

    def deserialize(self, value: Any) -> None:
        if not isinstance(value, dict) or "bias" not in value:
            raise _bad_bias()
        bias = value["bias"]
        if isinstance(bias, bool) or not isinstance(bias, (int, float)):
            raise _bad_bias()
        self.set_bias(bias)

    def lower(self, ctx, inputs: Dict[str, Any]) -> Dict[str, Any]:
        left, right = _require_inputs(inputs)
        return {"output": mix_ops.bimix(left, right, self.bias)}


class AudioBimixV2(_BimixStreamBase):
    """Time-aligned variant; no parameters (audio-bimix.cpp:444-449)."""

    batched = True  # one placement for every clip, per-clip lengths

    def _prefills(self, specs) -> list:
        # Each side starts at its own timestamp on the shared grid (the
        # reference's alignment engine, audio-bimix.cpp:776-872; rounded as
        # at :817-824), as leading silence in its merge FIFO.
        rate = config.BIMIX_STD_SAMPLE_RATE
        t0_l = specs["input_l"].t0_us
        t0_r = specs["input_r"].t0_us
        self._t0_out = min(t0_l, t0_r)
        return [round((t0_l - self._t0_out) * 1e-6 * rate),
                round((t0_r - self._t0_out) * 1e-6 * rate)]

    def _combine(self, win_l, win_r):
        return torch.cat([win_l, win_r], dim=0)

    def info(self) -> ProcessorInfo:
        return ProcessorInfo(
            identifier="audio_bimix_v2",
            display_name="Audio Bimix V2",
            singleton=False,
            generate=AudioBimixV2,
            description=(
                "Advanced Stereo Channel Mixer (V2)\n\n## Functionality\n"
                "- Time-aligned combination of asynchronous L/R inputs\n"
                "- Output: 48kHz 32-bit float stereo\n"
            ),
        )

    def pin_attributes(self) -> List[PinAttribute]:
        return _bimix_pins()

    def lower(self, ctx, inputs: Dict[str, Any]) -> Dict[str, Any]:
        left, right = _require_inputs(inputs)
        return {"output": mix_ops.bimix_v2(left, right)}
