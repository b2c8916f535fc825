"""Audio input node (port of nodey_tpu.processors.audio_input).

Decoding happens on the host before the graph runs (the Runner), or chunk
by chunk beside it (the streaming executor); each file slot is an external
input of the graph, bound by ``ctx.external``.
Reference: ``processor::Audio_input`` (src/processor/audio-io.cpp:27-426).
"""

from __future__ import annotations

from typing import Any, Dict, List

from nodey_tpu_torch.core.errors import ProcessorRuntimeError
from nodey_tpu_torch.core.registry import PinAttribute, Processor, ProcessorInfo
from nodey_tpu_torch.core.stream import AudioStreamType

_DESCRIPTION = """Audio Input Processor

## Functionality
- Reads audio files and outputs audio streams
- Supports multiple file inputs with configurable paths
- Decodes host-side, streams device-side

## Usage
- Add file paths to the input list
- Connect output pins to other audio processors or outputs
"""


def _bad_field(field: str) -> ProcessorRuntimeError:
    return ProcessorRuntimeError(
        "Failed to deserialize JSON file",
        "Audio_input failed to serialize the JSON input because of "
        "missing or invalid fields.",
        f"Wrong field: {field}",
    )


class AudioInput(Processor):
    """Singleton source node with one output pin per file slot."""

    batched = True  # each slot's external input is [B, C, capacity]

    def __init__(self) -> None:
        self.file_paths: List[str] = [""]

    def info(self) -> ProcessorInfo:
        return ProcessorInfo(
            identifier="audio_input",
            display_name="Audio Input",
            singleton=True,
            generate=AudioInput,
            description=_DESCRIPTION,
        )

    def pin_attributes(self) -> List[PinAttribute]:
        return [
            PinAttribute(
                identifier=f"output_{i}",
                display_name=f"Output {i + 1}",
                type=AudioStreamType,
                is_input=False,
            )
            for i in range(len(self.file_paths))
        ]

    def param_spec(self) -> List[Dict[str, Any]]:
        # The reference's per-slot "File Path" fields and add/remove-slot
        # controls (audio-io.cpp:345-426), as one "file_path" list applied
        # through the serde.
        return [{"key": "file_path", "label": "Input Files",
                 "kind": "files", "value": list(self.file_paths)}]

    def serialize(self) -> Any:
        return {"file_path": list(self.file_paths)}

    def deserialize(self, value: Any) -> None:
        if (
            not isinstance(value, dict)
            or not isinstance(value.get("file_path"), list)
        ):
            raise _bad_field("file_path")
        paths = []
        for path in value["file_path"]:
            if not isinstance(path, str):
                raise _bad_field("file_path.path")
            paths.append(path)
        # The reference keeps at least one slot (audio-io.cpp:334-337).
        self.file_paths = paths or [""]

    # -- slot editing (the engine-level equivalent of the reference's
    #    add/remove-slot UI, audio-io.cpp:345-426) ---------------------------

    def add_slot(self, path: str = "") -> None:
        self.file_paths.append(path)

    def remove_slot(self, index: int) -> None:
        if len(self.file_paths) <= 1:
            raise ProcessorRuntimeError(
                "Cannot remove the last input slot",
                "Audio input requires at least one file slot.",
                f"Slot index: {index}",
            )
        del self.file_paths[index]

    def lower(self, ctx, inputs: Dict[str, Any]) -> Dict[str, Any]:
        return {
            f"output_{i}": ctx.external(ctx.node_id, f"output_{i}")
            for i in range(len(self.file_paths))
        }

    # -- chunk streaming: each slot is a per-chunk external input ------------

    def plan_stream(self, ctx, in_specs):
        return {
            f"output_{i}": ctx.external_spec(ctx.node_id, f"output_{i}")
            for i in range(len(self.file_paths))
        }, None

    def lower_stream(self, ctx, inputs, state):
        return self.lower(ctx, inputs), state
