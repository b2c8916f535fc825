"""Modulation-effect nodes: tremolo, chorus/flanger and phaser (port of
nodey_tpu.processors.modulation).

All run on exact modular-integer LFO phase residues of the global sample
position (rate quantized to 1/128 Hz, ops/modfx.py), so the offline and
the chunk-streamed renders evaluate the same modulation at the same
sample. They are time-variant, so they are not in the overlap-discard
set of the chunked renderer. The phaser, the recursive one, runs its
swept-allpass cascade as time-varying-pole scans (ops/phaser.py).

Tremolo at depth 0 is a bitwise passthrough; chorus and phaser at wet 0
with dry 1 likewise. Each stream plan puts its LFO tables for the chunk
width on the device, so a step copies nothing from the host.
"""

from __future__ import annotations

from typing import Any, Dict, List

from nodey_tpu_torch.core.errors import ProcessorRuntimeError
from nodey_tpu_torch.core.registry import PinAttribute, Processor, ProcessorInfo
from nodey_tpu_torch.core.stream import AudioStreamType
from nodey_tpu_torch.ops import modfx
from nodey_tpu_torch.ops import phaser as phaser_ops

_TREM_DESCRIPTION = """Tremolo

## Functionality
- Periodic volume modulation (sine LFO)
- Rate (Hz) and depth controls
- Depth 0 is a bitwise passthrough

## Usage
- Connect an audio stream to 'Input'
- Raise 'Depth' for a stronger pulse, 'Rate' for a faster one
"""

_CHORUS_DESCRIPTION = """Chorus

## Functionality
- LFO-modulated multi-voice delay (chorus; small Base with one voice
  is a flanger sweep)
- Rate, base delay, modulation depth, voices, wet/dry mix
- Wet 0 is a bitwise passthrough (with Dry 1)

## Usage
- Connect an audio stream to 'Input'
- Chorus: Base 15-30 ms, 2-3 voices; Flanger: Base 1-5 ms, 1 voice
"""


_PHASER_DESCRIPTION = """Phaser

## Functionality
- Cascaded swept allpass stages (sine LFO) — moving notch comb
- Rate, sweep band (min/max Hz), stage count, wet/dry mix
- Wet 0 is a bitwise passthrough (with Dry 1)

## Usage
- Connect an audio stream to 'Input'
- 4 stages / 200-4000 Hz is the classic sound; more stages = more
  notches; narrow the band for a subtler sweep
"""


class AudioPhaser(Processor):
    """Swept-allpass phaser (ops/phaser.py): K first-order allpass
    stages whose shared coefficient follows an exact integer-residue
    LFO; the per-stage recurrence runs as a time-varying-pole scan.
    Offline and streamed paths compute identical coefficients at
    identical global positions; the only cross-chunk state is per-stage
    (x_prev, y_prev) columns and the LFO residue."""

    batched = True  # one coefficient track, the scans over every clip
    _CLAMPS = {
        "rate_hz": (0.05, 10.0),
        "f_min_hz": (20.0, 2_000.0),
        "f_max_hz": (100.0, 12_000.0),
        "stages": (2, 8),
        "wet": (0.0, 1.0),
        "dry": (0.0, 1.0),
    }

    def __init__(self) -> None:
        self.rate_hz: float = 0.5
        self.f_min_hz: float = 200.0
        self.f_max_hz: float = 4_000.0
        self.stages: int = 4
        self.wet: float = 0.7
        self.dry: float = 1.0

    def info(self) -> ProcessorInfo:
        return ProcessorInfo(
            identifier="audio_phaser",
            display_name="Phaser",
            singleton=False,
            generate=AudioPhaser,
            description=_PHASER_DESCRIPTION,
        )

    def pin_attributes(self) -> List[PinAttribute]:
        return [
            PinAttribute("output", "Output", AudioStreamType, is_input=False),
            PinAttribute("input", "Input", AudioStreamType, is_input=True),
        ]

    def set_param(self, key: str, value: float) -> None:
        lohi = self._CLAMPS.get(key)
        if lohi is None:
            return
        v = min(max(float(value), lohi[0]), lohi[1])
        setattr(self, key, int(round(v)) if key == "stages" else v)

    def param_spec(self) -> List[Dict[str, Any]]:
        return [
            {"key": "rate_hz", "label": "Rate (Hz)", "kind": "float",
             "min": 0.05, "max": 10.0, "step": 0.05, "log": True,
             "value": self.rate_hz},
            {"key": "f_min_hz", "label": "Sweep Min (Hz)", "kind": "float",
             "min": 20.0, "max": 2_000.0, "step": 10.0, "log": True,
             "value": self.f_min_hz},
            {"key": "f_max_hz", "label": "Sweep Max (Hz)", "kind": "float",
             "min": 100.0, "max": 12_000.0, "step": 50.0, "log": True,
             "value": self.f_max_hz},
            {"key": "stages", "label": "Stages", "kind": "int",
             "min": 2, "max": 8, "step": 1, "value": self.stages},
            {"key": "wet", "label": "Wet", "kind": "float", "min": 0.0,
             "max": 1.0, "step": 0.01, "value": self.wet},
            {"key": "dry", "label": "Dry", "kind": "float", "min": 0.0,
             "max": 1.0, "step": 0.01, "value": self.dry},
        ]

    def serialize(self) -> Any:
        return {k: getattr(self, k) for k in self._CLAMPS}

    def deserialize(self, value: Any) -> None:
        if isinstance(value, dict):
            for k, v in value.items():
                if (isinstance(v, (int, float))
                        and not isinstance(v, bool)):
                    self.set_param(k, float(v))

    def _require(self, inputs):
        value = inputs.get("input")
        if value is None:
            raise ProcessorRuntimeError(
                "Phaser has no input",
                "This node requires an audio stream input.",
                "Input item 'input' not found",
            )
        return value

    @property
    def _is_noop(self) -> bool:
        return self.wet == 0.0 and self.dry == 1.0

    def lower(self, ctx, inputs: Dict[str, Any]) -> Dict[str, Any]:
        stream = self._require(inputs)
        if self._is_noop:
            return {"output": stream}          # bitwise passthrough
        return {"output": phaser_ops.phaser_stream(
            stream, self.rate_hz, self.f_min_hz, self.f_max_hz,
            int(self.stages), self.wet, self.dry,
        )}

    # -- chunk-streaming: per-stage scalar carries + phase residue --------------

    def plan_stream(self, ctx, in_specs):
        spec = self._require(in_specs)
        if self._is_noop:
            self._stream_params = None
            return {"output": spec}, {}
        num, m, k0, k1 = phaser_ops.phaser_spec(
            spec.rate, self.rate_hz, self.f_min_hz, self.f_max_hz
        )
        modfx.lfo_prepare(num, m, spec.width, ctx.device)
        self._stream_params = (
            num, m, k0, k1, spec.rate, int(self.stages),
            float(self.wet), float(self.dry),
        )
        return ({"output": spec.replace(fmt="flt")},
                {"ph": phaser_ops.phaser_stream_init(
                    spec.channels, int(self.stages), ctx.device
                )})

    def lower_stream(self, ctx, inputs, state):
        chunk = self._require(inputs)
        if self._stream_params is None:
            return {"output": chunk}, state
        new_ph, out = phaser_ops.phaser_stream_step(
            self._stream_params, state["ph"], chunk.data, chunk.n
        )
        return (
            {"output": chunk.with_data(out, fmt="flt")},
            {"ph": new_ph},
        )


class AudioTremolo(Processor):
    batched = True  # one LFO gain row for every clip
    _CLAMPS = {
        "rate_hz": (0.1, 20.0),
        "depth": (0.0, 1.0),
    }

    def __init__(self) -> None:
        self.rate_hz: float = 5.0
        self.depth: float = 0.5

    def info(self) -> ProcessorInfo:
        return ProcessorInfo(
            identifier="audio_tremolo",
            display_name="Tremolo",
            singleton=False,
            generate=AudioTremolo,
            description=_TREM_DESCRIPTION,
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
            {"key": "rate_hz", "label": "Rate (Hz)", "kind": "float",
             "min": 0.1, "max": 20.0, "step": 0.1, "log": True,
             "value": self.rate_hz},
            {"key": "depth", "label": "Depth", "kind": "float",
             "min": 0.0, "max": 1.0, "step": 0.01, "value": self.depth},
        ]

    def serialize(self) -> Any:
        return {k: getattr(self, k) for k in self._CLAMPS}

    def deserialize(self, value: Any) -> None:
        if isinstance(value, dict):
            for k, v in value.items():
                if (isinstance(v, (int, float))
                        and not isinstance(v, bool)):
                    self.set_param(k, float(v))

    def _require(self, inputs):
        value = inputs.get("input")
        if value is None:
            raise ProcessorRuntimeError(
                "Tremolo has no input",
                "This node requires an audio stream input.",
                "Input item 'input' not found",
            )
        return value

    def lower(self, ctx, inputs: Dict[str, Any]) -> Dict[str, Any]:
        stream = self._require(inputs)
        if self.depth == 0.0:
            return {"output": stream}          # bitwise passthrough
        return {"output": modfx.tremolo_stream(
            stream, self.rate_hz, self.depth
        )}

    # -- chunk-streaming: one int32 phase-residue carry ------------------------

    def plan_stream(self, ctx, in_specs):
        spec = self._require(in_specs)
        if self.depth == 0.0:
            self._stream_params = None
            return {"output": spec}, {}
        num, m = modfx.lfo_quantize(self.rate_hz, spec.rate)
        modfx.lfo_prepare(num, m, spec.width, ctx.device)
        self._stream_params = (num, m, float(self.depth))
        return ({"output": spec.replace(fmt="flt")},
                {"lfo": modfx.tremolo_stream_init()})

    def lower_stream(self, ctx, inputs, state):
        chunk = self._require(inputs)
        if self._stream_params is None:
            return {"output": chunk}, state
        new_lfo, out = modfx.tremolo_stream_step(
            self._stream_params, state["lfo"], chunk.data, chunk.n
        )
        return (
            {"output": chunk.with_data(out, fmt="flt")},
            {"lfo": new_lfo},
        )


class AudioChorus(Processor):
    batched = True  # one LFO, the gathers on the last axis
    _CLAMPS = {
        "rate_hz": (0.05, 10.0),
        "base_ms": (1.0, 40.0),
        "depth_ms": (0.0, 20.0),
        "voices": (1, 3),
        "wet": (0.0, 1.0),
        "dry": (0.0, 1.0),
    }

    def __init__(self) -> None:
        self.rate_hz: float = 0.8
        self.base_ms: float = 20.0
        self.depth_ms: float = 6.0
        self.voices: int = 2
        self.wet: float = 0.5
        self.dry: float = 1.0

    def info(self) -> ProcessorInfo:
        return ProcessorInfo(
            identifier="audio_chorus",
            display_name="Chorus",
            singleton=False,
            generate=AudioChorus,
            description=_CHORUS_DESCRIPTION,
        )

    def pin_attributes(self) -> List[PinAttribute]:
        return [
            PinAttribute("output", "Output", AudioStreamType, is_input=False),
            PinAttribute("input", "Input", AudioStreamType, is_input=True),
        ]

    def set_param(self, key: str, value: float) -> None:
        lohi = self._CLAMPS.get(key)
        if lohi is None:
            return
        v = min(max(float(value), lohi[0]), lohi[1])
        setattr(self, key, int(round(v)) if key == "voices" else v)

    def param_spec(self) -> List[Dict[str, Any]]:
        return [
            {"key": "rate_hz", "label": "Rate (Hz)", "kind": "float",
             "min": 0.05, "max": 10.0, "step": 0.05, "log": True,
             "value": self.rate_hz},
            {"key": "base_ms", "label": "Base Delay (ms)", "kind": "float",
             "min": 1.0, "max": 40.0, "step": 0.5, "value": self.base_ms},
            {"key": "depth_ms", "label": "Depth (ms)", "kind": "float",
             "min": 0.0, "max": 20.0, "step": 0.25,
             "value": self.depth_ms},
            {"key": "voices", "label": "Voices", "kind": "int",
             "min": 1, "max": 3, "step": 1, "value": self.voices},
            {"key": "wet", "label": "Wet", "kind": "float", "min": 0.0,
             "max": 1.0, "step": 0.01, "value": self.wet},
            {"key": "dry", "label": "Dry", "kind": "float", "min": 0.0,
             "max": 1.0, "step": 0.01, "value": self.dry},
        ]

    def serialize(self) -> Any:
        return {k: getattr(self, k) for k in self._CLAMPS}

    def deserialize(self, value: Any) -> None:
        if isinstance(value, dict):
            for k, v in value.items():
                if (isinstance(v, (int, float))
                        and not isinstance(v, bool)):
                    self.set_param(k, float(v))

    def _require(self, inputs):
        value = inputs.get("input")
        if value is None:
            raise ProcessorRuntimeError(
                "Chorus has no input",
                "This node requires an audio stream input.",
                "Input item 'input' not found",
            )
        return value

    def lower(self, ctx, inputs: Dict[str, Any]) -> Dict[str, Any]:
        stream = self._require(inputs)
        if self.wet == 0.0 and self.dry == 1.0:
            return {"output": stream}          # bitwise passthrough
        return {"output": modfx.chorus_stream(
            stream, self.rate_hz, self.base_ms, self.depth_ms,
            int(self.voices), self.wet, self.dry,
        )}

    # -- chunk-streaming: history ring + int32 phase-residue carry -------------

    def plan_stream(self, ctx, in_specs):
        spec = self._require(in_specs)
        if self.wet == 0.0 and self.dry == 1.0:
            self._stream_params = None
            return {"output": spec}, {}
        num, m = modfx.lfo_quantize(self.rate_hz, spec.rate)
        base, depth, hist = modfx.chorus_spec(
            spec.rate, self.base_ms, self.depth_ms, int(self.voices)
        )
        modfx.lfo_prepare(num, m, spec.width, ctx.device)
        self._stream_params = (
            num, m, base, depth, int(self.voices),
            float(self.wet), float(self.dry),
        )
        return ({"output": spec.replace(fmt="flt")},
                {"ch": modfx.chorus_stream_init(spec.channels, hist,
                                                ctx.device)})

    def lower_stream(self, ctx, inputs, state):
        chunk = self._require(inputs)
        if self._stream_params is None:
            return {"output": chunk}, state
        new_ch, out = modfx.chorus_stream_step(
            self._stream_params, state["ch"], chunk.data, chunk.n
        )
        return (
            {"output": chunk.with_data(out, fmt="flt")},
            {"ch": new_ch},
        )
