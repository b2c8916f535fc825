"""N-input weighted mixer node (port of nodey_tpu.processors.amix).

Reference: ``processor::Audio_amix`` (src/processor/audio-amix.cpp): each
input is normalized to 48 kHz stereo float, then summed with its volume;
streamed, through a resample stage per input and an aligned merge.
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

_DESCRIPTION = """Multi-Channel Audio Mixer

## Functionality
- Mix multiple audio input streams into a single stereo output
- Support 1-16 configurable input channels
- Volume lock mechanism for normalization

## Output Format
- Sample Rate: 48kHz, 32-bit Float, Stereo
"""


class AudioAmix(Processor):
    def __init__(self) -> None:
        self.input_num: int = 2
        self.volumes: List[float] = []
        self.locks: List[bool] = []

    def info(self) -> ProcessorInfo:
        return ProcessorInfo(
            identifier="audio_amix",
            display_name="Audio Amix",
            singleton=False,
            generate=AudioAmix,
            description=_DESCRIPTION,
        )

    def pin_attributes(self) -> List[PinAttribute]:
        # Output first, then input_1..input_N (audio-amix.cpp:51-84).
        pins = [
            PinAttribute("output", "Output", AudioStreamType, is_input=False)
        ]
        pins.extend(
            PinAttribute(
                f"input_{i + 1}", f"Input {i + 1}", AudioStreamType,
                is_input=True,
            )
            for i in range(self.input_num)
        )
        return pins

    def set_input_num(self, n: int) -> None:
        """Clamped arity setter (audio-amix.cpp:340-347); call
        graph.update_node_pin afterwards."""
        self.input_num = min(max(int(n), 1), 16)
        self._pad_params()

    def _pad_params(self) -> None:
        while len(self.volumes) < self.input_num:
            self.volumes.append(1.0)
        while len(self.locks) < self.input_num:
            self.locks.append(False)

    def set_volume(self, index: int, volume: float) -> None:
        """Set one volume and renormalize the unlocked ones so the total
        stays ~1 (audio-amix.cpp:349-393)."""
        self._pad_params()
        self.volumes[index] = min(max(float(volume), 0.001), 0.999)
        active = list(zip(self.volumes[: self.input_num], self.locks))
        lock_sum = sum(v for v, lock in active if lock)
        unlock_sum = sum(v for v, lock in active if not lock)
        if unlock_sum > 0.001:
            scale = (1.0 - lock_sum) / unlock_sum
            for i in range(self.input_num):
                if not self.locks[i]:
                    self.volumes[i] *= scale

    # serde: flat volumes{i}/locks{i} keys (audio-amix.cpp:395-423).

    def serialize(self) -> Any:
        self._pad_params()
        value: Dict[str, Any] = {"input_num": self.input_num}
        for i in range(self.input_num):
            value[f"volumes{i}"] = self.volumes[i]
            value[f"locks{i}"] = self.locks[i]
        return value

    def deserialize(self, value: Any) -> None:
        if not isinstance(value, dict) or "input_num" not in value:
            raise ProcessorRuntimeError(
                "Failed to deserialize JSON file",
                "Audio_bimix failed to serialize the JSON input because of "
                "missing or invalid fields.",
                "Wrong field: input_num",
            )
        # Tolerant load, as the JAX package: input_num clamps to [1, 16],
        # volumes only against absurd hand edits.
        self.input_num = min(max(int(value["input_num"]), 1), 16)
        self.volumes = []
        self.locks = []
        for i in range(self.input_num):
            vol = value.get(f"volumes{i}", 0.0)
            vol = float(vol) if isinstance(vol, (int, float)) else 0.0
            self.volumes.append(min(max(vol, -16.0), 16.0))
            self.locks.append(bool(value.get(f"locks{i}", False)))

    def _inputs(self, inputs: Dict[str, Any]) -> List[Any]:
        self._pad_params()
        values = []
        for i in range(self.input_num):
            value = inputs.get(f"input_{i + 1}")
            if value is None:
                # Reference: audio-amix.cpp:119-126.
                raise ProcessorRuntimeError(
                    "Audio Mixer processor has no input",
                    "Audio Mixer processor requires an audio stream input to "
                    "function properly.",
                    f"Input item 'input_{i + 1}' not found",
                )
            values.append(value)
        return values

    def lower(self, ctx, inputs: Dict[str, Any]) -> Dict[str, Any]:
        streams = self._inputs(inputs)
        return {"output": mix_ops.amix(streams, self.volumes[: self.input_num])}

    # -- chunk streaming: per-input 48 kHz stereo resample stage, then an
    #    aligned merge (core/chunkflow.py) --------------------------------------

    def plan_stream(self, ctx, in_specs):
        self._rs_plans = []
        rs_states = []
        normed = []
        for spec in self._inputs(in_specs):
            stereo = spec.replace(channels=2, fmt="flt")
            out_spec, st, plan = chunkflow.plan_resample_stage(
                stereo, config.AMIX_STD_SAMPLE_RATE, ctx.device)
            self._rs_plans.append(plan)
            rs_states.append(st)
            normed.append(out_spec)
        self._merge_plan, merge_fifos = chunkflow.plan_aligned_merge(
            normed, [0] * len(normed), ctx.device)
        out_spec = normed[0].replace(
            rate=config.AMIX_STD_SAMPLE_RATE, channels=2,
            width=self._merge_plan["take_cap"], fmt="flt", t0_us=0.0,
        )
        return {"output": out_spec}, {"rs": rs_states, "merge": merge_fifos}

    def lower_stream(self, ctx, inputs, state):
        rs_states = []
        normed = []
        for chunk, plan, st in zip(self._inputs(inputs), self._rs_plans,
                                   state["rs"]):
            st, out = chunkflow.run_resample_stage(
                plan, st, chunkflow.to_stereo_chunk(chunk),
                config.AMIX_STD_SAMPLE_RATE)
            rs_states.append(st)
            normed.append(out)
        merge, windows, take, done = chunkflow.run_aligned_merge(
            self._merge_plan, state["merge"], normed)
        acc = torch.zeros_like(windows[0])
        for window, vol in zip(windows, self.volumes[: self.input_num]):
            acc = acc + window * float(np.float32(vol))
        out = chunkflow.ChunkStream(
            data=acc, n=take, done=done,
            spec=chunkflow.ChunkSpec(
                rate=config.AMIX_STD_SAMPLE_RATE, channels=2, fmt="flt",
                width=acc.shape[1], t0_us=0.0,
            ),
        )
        return {"output": out}, {"rs": rs_states, "merge": merge}
