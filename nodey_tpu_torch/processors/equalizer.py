"""Parametric EQ and filter nodes (port of
nodey_tpu.processors.equalizer).

The reference ships no filtering or EQ; these two nodes complete the
master-bus trio (EQ -> compressor -> limiter). Both run on ops/biquad.py:
second-order sections as first-order scans, with small per-section
streaming carries.

``audio_eq`` is a 5-band parametric EQ (low shelf, three peaking bells,
high shelf). Bands at EXACTLY 0 dB gain are skipped at plan time, so the
default node is a bitwise passthrough.

``audio_filter`` is a single configurable section (lowpass / highpass /
bandpass / notch) with frequency and Q.
"""

from __future__ import annotations

from typing import Any, Dict, List

from nodey_tpu_torch.core.errors import ProcessorRuntimeError
from nodey_tpu_torch.core.registry import PinAttribute, Processor, ProcessorInfo
from nodey_tpu_torch.core.stream import AudioStreamType
from nodey_tpu_torch.ops import biquad

_EQ_DESCRIPTION = """Parametric EQ

## Functionality
- 5 bands: low shelf, three peaking bells, high shelf
- Each bell has frequency, gain and Q; shelves have frequency and gain
- Bands at 0 dB gain are transparent (bitwise passthrough)

## Usage
- Connect an audio stream to 'Input'
- Raise or cut each band's gain; bands at 0 dB cost nothing
"""

_FILTER_DESCRIPTION = """Filter

## Functionality
- One second-order filter section: lowpass, highpass, bandpass or notch
- Frequency and Q (resonance) controls

## Usage
- Connect an audio stream to 'Input'
- Pick the filter type and set the cutoff/center frequency
"""


class _BiquadNode(Processor):
    """Shared lowering: subclasses provide ``_design(rate) ->
    [BiquadCoef]``."""

    batched = True  # the scans on every clip, their GEMMs clip by clip

    def _design(self, rate: int):
        raise NotImplementedError

    def _sections(self, rate: int):
        return biquad.prepare_all(self._design(rate))

    def _require(self, inputs):
        value = inputs.get("input")
        if value is None:
            raise ProcessorRuntimeError(
                f"{self.info().display_name} has no input",
                "This node requires an audio stream input.",
                "Input item 'input' not found",
            )
        return value

    def pin_attributes(self) -> List[PinAttribute]:
        return [
            PinAttribute("output", "Output", AudioStreamType, is_input=False),
            PinAttribute("input", "Input", AudioStreamType, is_input=True),
        ]

    def lower(self, ctx, inputs: Dict[str, Any]) -> Dict[str, Any]:
        stream = self._require(inputs)
        return {"output": biquad.cascade_stream(
            stream, self._sections(stream.rate)
        )}

    # -- chunk-streaming: per-section scan carries ----------------------------

    def plan_stream(self, ctx, in_specs):
        spec = self._require(in_specs)
        self._stream_sections = self._sections(spec.rate)
        # The pole tables at the chunk width go to the device now: a step
        # copies nothing from the host.
        biquad.cascade_stream_prepare(self._stream_sections, spec.width,
                                      ctx.device)
        state = {"iir": biquad.cascade_stream_init(
            spec.channels, self._stream_sections, ctx.device
        )}
        return {"output": spec.replace(fmt="flt")}, state

    def lower_stream(self, ctx, inputs, state):
        chunk = self._require(inputs)
        if not self._stream_sections:
            return {"output": chunk}, state
        new_iir, out = biquad.cascade_stream_step(
            self._stream_sections, state["iir"], chunk.data, chunk.n
        )
        return (
            {"output": chunk.with_data(out, fmt="flt")},
            {"iir": new_iir},
        )


class AudioEq(_BiquadNode):
    _BANDS = (
        ("ls", "Low Shelf", 100.0, 20.0, 2000.0, None),
        ("p1", "Bell 1", 250.0, 20.0, 20000.0, 1.0),
        ("p2", "Bell 2", 1000.0, 20.0, 20000.0, 1.0),
        ("p3", "Bell 3", 4000.0, 20.0, 20000.0, 1.0),
        ("hs", "High Shelf", 8000.0, 200.0, 20000.0, None),
    )

    def __init__(self) -> None:
        for key, _label, freq, _lo, _hi, q in self._BANDS:
            setattr(self, f"{key}_freq", freq)
            setattr(self, f"{key}_gain_db", 0.0)
            if q is not None:
                setattr(self, f"{key}_q", q)

    def info(self) -> ProcessorInfo:
        return ProcessorInfo(
            identifier="audio_eq",
            display_name="Parametric EQ",
            singleton=False,
            generate=AudioEq,
            description=_EQ_DESCRIPTION,
        )

    def _clamp(self, key: str, value: float) -> float:
        for k, _label, _freq, lo, hi, _q in self._BANDS:
            if key == f"{k}_freq":
                return min(max(float(value), lo), hi)
        if key.endswith("_gain_db"):
            return min(max(float(value), -24.0), 24.0)
        return min(max(float(value), 0.1), 10.0)      # _q

    def set_param(self, key: str, value: float) -> None:
        if hasattr(self, key):
            setattr(self, key, self._clamp(key, value))

    def param_spec(self) -> List[Dict[str, Any]]:
        out = []
        for key, label, _freq, lo, hi, q in self._BANDS:
            out.append({
                "key": f"{key}_freq", "label": f"{label} Freq (Hz)",
                "kind": "float", "min": lo, "max": hi, "step": 1.0,
                "log": True, "value": getattr(self, f"{key}_freq"),
            })
            out.append({
                "key": f"{key}_gain_db", "label": f"{label} Gain (dB)",
                "kind": "float", "min": -24.0, "max": 24.0, "step": 0.1,
                "value": getattr(self, f"{key}_gain_db"),
            })
            if q is not None:
                out.append({
                    "key": f"{key}_q", "label": f"{label} Q",
                    "kind": "float", "min": 0.1, "max": 10.0,
                    "step": 0.05, "log": True,
                    "value": getattr(self, f"{key}_q"),
                })
        return out

    def serialize(self) -> Any:
        out = {}
        for spec in self.param_spec():
            out[spec["key"]] = getattr(self, spec["key"])
        return out

    def deserialize(self, value: Any) -> None:
        if isinstance(value, dict):
            for k, v in value.items():
                if (isinstance(v, (int, float))
                        and not isinstance(v, bool)):
                    self.set_param(k, float(v))

    def _design(self, rate: int):
        coeffs = []
        if self.ls_gain_db != 0.0:
            coeffs.append(biquad.low_shelf(
                self.ls_freq, self.ls_gain_db, rate
            ))
        for key in ("p1", "p2", "p3"):
            gain = getattr(self, f"{key}_gain_db")
            if gain != 0.0:
                coeffs.append(biquad.peaking(
                    getattr(self, f"{key}_freq"), gain,
                    getattr(self, f"{key}_q"), rate,
                ))
        if self.hs_gain_db != 0.0:
            coeffs.append(biquad.high_shelf(
                self.hs_freq, self.hs_gain_db, rate
            ))
        return coeffs

    def lower(self, ctx, inputs: Dict[str, Any]) -> Dict[str, Any]:
        stream = self._require(inputs)
        sections = self._sections(stream.rate)
        if not sections:
            return {"output": stream}          # bitwise passthrough
        return {"output": biquad.cascade_stream(stream, sections)}


class AudioFilter(_BiquadNode):
    _TYPES = ("lowpass", "highpass", "bandpass", "notch")

    def __init__(self) -> None:
        self.filter_type: str = "lowpass"
        self.freq: float = 1000.0
        self.q: float = 0.707

    def info(self) -> ProcessorInfo:
        return ProcessorInfo(
            identifier="audio_filter",
            display_name="Filter",
            singleton=False,
            generate=AudioFilter,
            description=_FILTER_DESCRIPTION,
        )

    def set_filter_type(self, value: str) -> None:
        if value in self._TYPES:
            self.filter_type = value

    def set_freq(self, value: float) -> None:
        self.freq = min(max(float(value), 20.0), 20000.0)

    def set_q(self, value: float) -> None:
        self.q = min(max(float(value), 0.1), 10.0)

    def param_spec(self) -> List[Dict[str, Any]]:
        return [
            {"key": "filter_type", "label": "Type", "kind": "enum",
             "choices": list(self._TYPES), "value": self.filter_type},
            {"key": "freq", "label": "Frequency (Hz)", "kind": "float",
             "min": 20.0, "max": 20000.0, "step": 1.0, "log": True,
             "value": self.freq},
            {"key": "q", "label": "Q", "kind": "float", "min": 0.1,
             "max": 10.0, "step": 0.05, "log": True, "value": self.q},
        ]

    def serialize(self) -> Any:
        return {"filter_type": self.filter_type, "freq": self.freq,
                "q": self.q}

    def deserialize(self, value: Any) -> None:
        if isinstance(value, dict):
            t = value.get("filter_type")
            if isinstance(t, str):
                self.set_filter_type(t)
            f = value.get("freq")
            if isinstance(f, (int, float)) and not isinstance(f, bool):
                self.set_freq(float(f))
            q = value.get("q")
            if isinstance(q, (int, float)) and not isinstance(q, bool):
                self.set_q(float(q))

    def _design(self, rate: int):
        design = {
            "lowpass": biquad.lowpass,
            "highpass": biquad.highpass,
            "bandpass": biquad.bandpass,
            "notch": biquad.notch,
        }[self.filter_type]
        return [design(self.freq, self.q, rate)]
