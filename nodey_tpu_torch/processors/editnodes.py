"""Timeline editing nodes, trim and reverse (port of
nodey_tpu.processors.editnodes).

Both are pure index selection (ops/editops.py), so their output is bitwise
across execution plans and bitwise the JAX package's. Trim streams with
one input-position carry (a host int); reverse is whole-clip by
construction (the first output sample is the last input sample) and
refuses the stream plan, so ``Runner.export_streamed`` and the preview
session take the offline path, as for audio_normalize.
"""

from __future__ import annotations

from typing import Any, Dict, List

from nodey_tpu_torch.core.chunkflow import ChunkStream
from nodey_tpu_torch.core.errors import (ProcessorRuntimeError,
                                         UnstreamableGraphError)
from nodey_tpu_torch.core.registry import PinAttribute, Processor, ProcessorInfo
from nodey_tpu_torch.core.stream import AudioStreamType
from nodey_tpu_torch.ops import editops

_TRIM_DESCRIPTION = """Trim

## Functionality
- Keeps only the [start, end) time range and closes the gap to t=0
- end = 0 means "to the end of the clip"
- Pure sample selection: kept samples are bitwise-unchanged

## Usage
- Connect an audio stream to 'Input'
- Set start/end in seconds; an empty selection produces silence
"""

_REVERSE_DESCRIPTION = """Reverse

## Functionality
- Plays the clip backwards (a pure sample permutation — bitwise)
- Whole-clip by construction: streamed exports fall back to the
  offline render path

## Usage
- Connect an audio stream to 'Input'
"""


class AudioTrim(Processor):
    batched = True  # one static slice, each clip's kept length
    _CLAMPS = {
        "start_s": (0.0, 86_400.0),
        "end_s": (0.0, 86_400.0),
    }

    def __init__(self) -> None:
        self.start_s: float = 0.0
        self.end_s: float = 0.0  # 0 = to the end

    def info(self) -> ProcessorInfo:
        return ProcessorInfo(
            identifier="audio_trim",
            display_name="Trim",
            singleton=False,
            generate=AudioTrim,
            description=_TRIM_DESCRIPTION,
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
            {"key": "start_s", "label": "Start (s)", "kind": "float",
             "min": 0.0, "max": 86_400.0, "step": 0.01,
             "value": self.start_s},
            {"key": "end_s", "label": "End (s, 0 = clip end)",
             "kind": "float", "min": 0.0, "max": 86_400.0, "step": 0.01,
             "value": self.end_s},
        ]

    def serialize(self) -> Any:
        return {"start_s": self.start_s, "end_s": self.end_s}

    def deserialize(self, value: Any) -> None:
        if isinstance(value, dict):
            for k, v in value.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    self.set_param(k, float(v))

    def _require(self, inputs):
        value = inputs.get("input")
        if value is None:
            raise ProcessorRuntimeError(
                "Trim has no input",
                "This node requires an audio stream input.",
                "Input item 'input' not found",
            )
        return value

    def lower(self, ctx, inputs: Dict[str, Any]) -> Dict[str, Any]:
        stream = self._require(inputs)
        return {"output": editops.trim_stream(
            stream, self.start_s, self.end_s
        )}

    # -- chunk streaming: one input-position carry (a host int) ---------------

    def plan_stream(self, ctx, in_specs):
        spec = self._require(in_specs)
        self._n0, self._n1 = editops.trim_spec(
            spec.rate, self.start_s, self.end_s
        )
        return {"output": spec}, {"trim": editops.trim_stream_init()}

    def lower_stream(self, ctx, inputs, state):
        chunk = self._require(inputs)
        new_state, out, n_out, done = editops.trim_stream_step(
            self._n0, self._n1, state["trim"],
            chunk.data, chunk.n, chunk.done,
        )
        return (
            {"output": ChunkStream(data=out, n=n_out, done=done,
                                   spec=chunk.spec)},
            {"trim": new_state},
        )


class AudioReverse(Processor):
    batched = True  # one gather, each clip over its own length

    def __init__(self) -> None:
        pass

    def info(self) -> ProcessorInfo:
        return ProcessorInfo(
            identifier="audio_reverse",
            display_name="Reverse",
            singleton=False,
            generate=AudioReverse,
            description=_REVERSE_DESCRIPTION,
        )

    def pin_attributes(self) -> List[PinAttribute]:
        return [
            PinAttribute("output", "Output", AudioStreamType, is_input=False),
            PinAttribute("input", "Input", AudioStreamType, is_input=True),
        ]

    def param_spec(self) -> List[Dict[str, Any]]:
        return []

    def serialize(self) -> Any:
        # No parameters (like the reference's bimix_v2,
        # src/processor/audio-bimix.cpp:444-449).
        return {}

    def deserialize(self, value: Any) -> None:
        pass

    def _require(self, inputs):
        value = inputs.get("input")
        if value is None:
            raise ProcessorRuntimeError(
                "Reverse has no input",
                "This node requires an audio stream input.",
                "Input item 'input' not found",
            )
        return value

    def lower(self, ctx, inputs: Dict[str, Any]) -> Dict[str, Any]:
        stream = self._require(inputs)
        return {"output": editops.reverse_stream(stream)}

    # -- chunk streaming: refused (whole-clip permutation) ----------------------

    def plan_stream(self, ctx, in_specs):
        self._require(in_specs)
        raise UnstreamableGraphError(
            "Reverse cannot stream",
            "Reversing needs the whole clip before the first output "
            "sample; the export falls back to the offline render path, "
            "which handles it exactly.",
            "audio_reverse",
        )
