"""Fade node, fade-in and fade-out envelopes (port of
nodey_tpu.processors.fade).

Analytic time variance (ops/fadepan.py): the gain at sample t is a pure
function of the global index, so anchors are absolute (fade-in from sample
0, fade-out starting at ``out_start_s``) and the law is the same offline
and streamed. ``out_start_s`` 0 disables the fade-out; ``out_ms`` 0 with a
nonzero ``out_start_s`` is a hard cut to silence at that instant.

``anchor_end`` instead ends the fade-out exactly at the stream's length
(ignoring ``out_start_s``), which only an offline render knows: the
stream planner refuses it with UnstreamableGraphError, and
``Runner.export_streamed`` then exports offline.
"""

from __future__ import annotations

from typing import Any, Dict, List

from nodey_tpu_torch.core.errors import (ProcessorRuntimeError,
                                         UnstreamableGraphError)
from nodey_tpu_torch.core.registry import PinAttribute, Processor, ProcessorInfo
from nodey_tpu_torch.core.stream import AudioStreamType
from nodey_tpu_torch.ops import fadepan

_DESCRIPTION = """Fade In / Out

## Functionality
- Linear fade-in over the first 'Fade In' milliseconds
- Linear fade-out starting at 'Out Start' seconds, lasting 'Fade Out'
  milliseconds; output is silent afterwards
- 'Out Start' 0 disables the fade-out; regions outside the ramps pass
  through bitwise

## Usage
- Connect an audio stream to 'Input'
- Set 'Fade In' for the opening ramp; set 'Out Start' + 'Fade Out' to
  close the clip at a known time
"""


class AudioFade(Processor):
    batched = True  # one gain row; anchored at each clip's own end
    _CLAMPS = {
        "in_ms": (0.0, 60_000.0),
        "out_start_s": (0.0, 86_400.0),
        "out_ms": (0.0, 60_000.0),
    }

    def __init__(self) -> None:
        self.in_ms: float = 0.0
        self.out_start_s: float = 0.0
        self.out_ms: float = 0.0
        self.anchor_end: bool = False

    def info(self) -> ProcessorInfo:
        return ProcessorInfo(
            identifier="audio_fade",
            display_name="Fade",
            singleton=False,
            generate=AudioFade,
            description=_DESCRIPTION,
        )

    def pin_attributes(self) -> List[PinAttribute]:
        return [
            PinAttribute("output", "Output", AudioStreamType, is_input=False),
            PinAttribute("input", "Input", AudioStreamType, is_input=True),
        ]

    def set_param(self, key: str, value) -> None:
        if key == "anchor_end":
            self.anchor_end = bool(value)
            return
        lohi = self._CLAMPS.get(key)
        if lohi is not None:
            setattr(self, key, min(max(float(value), lohi[0]), lohi[1]))

    def param_spec(self) -> List[Dict[str, Any]]:
        return [
            {"key": "in_ms", "label": "Fade In (ms)", "kind": "float",
             "min": 0.0, "max": 60_000.0, "step": 10.0,
             "value": self.in_ms},
            {"key": "out_start_s", "label": "Out Start (s)",
             "kind": "float", "min": 0.0, "max": 86_400.0, "step": 0.1,
             "value": self.out_start_s},
            {"key": "out_ms", "label": "Fade Out (ms)", "kind": "float",
             "min": 0.0, "max": 60_000.0, "step": 10.0,
             "value": self.out_ms},
            {"key": "anchor_end", "label": "Anchor Out at Clip End",
             "kind": "bool", "value": self.anchor_end},
        ]

    def serialize(self) -> Any:
        # anchor_end is always present so an editor's parameter merge can
        # toggle it both ways (the JAX package's serde, byte for byte).
        out = {k: getattr(self, k) for k in self._CLAMPS}
        out["anchor_end"] = self.anchor_end
        return out

    def deserialize(self, value: Any) -> None:
        if isinstance(value, dict):
            for k, v in value.items():
                if (isinstance(v, (int, float))
                        and not isinstance(v, bool)):
                    self.set_param(k, float(v))
            ae = value.get("anchor_end")
            if isinstance(ae, bool):
                self.anchor_end = ae

    def _spec(self, rate: int):
        # int32 position arithmetic caps the fade-out anchor at 2^30
        # samples (ops/fadepan.py fade_spec); refusing loudly beats
        # silently relocating a cut hours earlier than requested.
        if (not self.anchor_end
                and round(self.out_start_s * rate) > (1 << 30)):
            limit_s = (1 << 30) / rate
            raise ProcessorRuntimeError(
                "Fade-out start is too late for this sample rate",
                f"'Out Start' of {self.out_start_s:.0f} s exceeds the "
                f"engine's position limit of {limit_s:.0f} s at "
                f"{rate} Hz; move the fade-out earlier or use "
                "'Anchor Out at Clip End'.",
                f"out_start_s={self.out_start_s} rate={rate} "
                f"exceeds 2^30 samples",
            )
        return fadepan.fade_spec(
            rate, self.in_ms, self.out_start_s, self.out_ms,
            self.anchor_end,
        )

    def _require(self, inputs):
        value = inputs.get("input")
        if value is None:
            raise ProcessorRuntimeError(
                "Fade has no input",
                "This node requires an audio stream input.",
                "Input item 'input' not found",
            )
        return value

    def lower(self, ctx, inputs: Dict[str, Any]) -> Dict[str, Any]:
        stream = self._require(inputs)
        return {"output": fadepan.fade_stream(
            stream, self._spec(stream.rate)
        )}

    # -- chunk-streaming: one global-position carry (a host int) --------------

    def plan_stream(self, ctx, in_specs):
        spec = self._require(in_specs)
        fspec = self._spec(spec.rate)
        if fspec.is_noop:
            self._stream_spec = None
            return {"output": spec}, {}
        if fspec.anchor_end and fspec.n_out > 0:
            raise UnstreamableGraphError(
                "End-anchored fade cannot stream",
                "A fade-out anchored at the clip end needs the total "
                "length, which a causal stream only learns at EOF; use "
                "the offline render/export path, or give the fade an "
                "absolute 'Out Start' time instead.",
                "audio_fade anchor_end",
            )
        self._stream_spec = fspec
        return ({"output": spec.replace(fmt="flt")},
                {"pos": fadepan.fade_stream_init()})

    def lower_stream(self, ctx, inputs, state):
        chunk = self._require(inputs)
        if self._stream_spec is None:
            return {"output": chunk}, state
        new_pos, out = fadepan.fade_stream_step(
            self._stream_spec, state["pos"], chunk.data, chunk.n
        )
        return (
            {"output": chunk.with_data(out, fmt="flt")},
            {"pos": new_pos},
        )
