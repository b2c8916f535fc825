"""De-esser node — split-band sibilance compressor (port of
nodey_tpu.processors.deesser).

The detector runs on an RBJ bandpass of the input (center frequency in
the sibilance range) and the resulting compressor gain is applied as
BAND SUBTRACTION — out = x - (1 - g) * band — so only the sibilant band
ducks and the rest of the spectrum passes untouched. Below threshold
the gain is exactly 1 (passthrough up to the sign of zero).

Streaming carries the bandpass section state and the detector's two
scalars (ops/dynamics.py).
"""

from __future__ import annotations

from typing import Any, Dict, List

from nodey_tpu_torch.core.errors import ProcessorRuntimeError
from nodey_tpu_torch.core.registry import PinAttribute, Processor, ProcessorInfo
from nodey_tpu_torch.core.stream import AudioStreamType
from nodey_tpu_torch.ops import dynamics as dyn

_DESCRIPTION = """De-esser

## Functionality
- Ducks a sibilance band (bandpass-keyed compressor, band subtraction)
- Threshold / ratio / attack / release plus band center and width (Q)
- Below threshold the output is a passthrough

## Usage
- Connect an audio stream to 'Input'
- Start around 6.5 kHz, Q 1, ratio 4; lower the threshold until the
  esses duck without lisping
"""


class AudioDeesser(Processor):
    batched = True  # each clip's band and detector its own

    _CLAMPS = {
        "threshold_db": (-60.0, 0.0),
        "ratio": (1.0, 20.0),
        "freq": (2_000.0, 12_000.0),
        "q": (0.3, 5.0),
        "attack_ms": (0.1, 20.0),
        "release_ms": (5.0, 200.0),
    }

    def __init__(self) -> None:
        self.threshold_db: float = -28.0
        self.ratio: float = 4.0
        self.freq: float = 6_500.0
        self.q: float = 1.0
        self.attack_ms: float = 1.0
        self.release_ms: float = 60.0

    def info(self) -> ProcessorInfo:
        return ProcessorInfo(
            identifier="audio_deesser",
            display_name="De-esser",
            singleton=False,
            generate=AudioDeesser,
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

    def param_spec(self) -> List[Dict[str, Any]]:
        return [
            {"key": "threshold_db", "label": "Threshold (dB)",
             "kind": "float", "min": -60.0, "max": 0.0, "step": 0.5,
             "value": self.threshold_db},
            {"key": "ratio", "label": "Ratio", "kind": "float",
             "min": 1.0, "max": 20.0, "step": 0.1, "log": True,
             "value": self.ratio},
            {"key": "freq", "label": "Center (Hz)", "kind": "float",
             "min": 2_000.0, "max": 12_000.0, "step": 50.0, "log": True,
             "value": self.freq},
            {"key": "q", "label": "Q", "kind": "float", "min": 0.3,
             "max": 5.0, "step": 0.05, "log": True, "value": self.q},
            {"key": "attack_ms", "label": "Attack (ms)", "kind": "float",
             "min": 0.1, "max": 20.0, "step": 0.1, "log": True,
             "value": self.attack_ms},
            {"key": "release_ms", "label": "Release (ms)",
             "kind": "float", "min": 5.0, "max": 200.0, "step": 1.0,
             "log": True, "value": self.release_ms},
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
                "De-esser has no input",
                "This node requires an audio stream input.",
                "Input item 'input' not found",
            )
        return value

    def _pieces(self, rate: int):
        sections = dyn.deesser_sections(self.freq, self.q, rate)
        p = dyn.deesser_params(self.threshold_db, self.ratio,
                               self.attack_ms, self.release_ms, rate)
        return sections, p

    def lower(self, ctx, inputs: Dict[str, Any]) -> Dict[str, Any]:
        stream = self._require(inputs)
        return {"output": dyn.deess_stream(
            stream, self.threshold_db, self.ratio, self.freq, self.q,
            self.attack_ms, self.release_ms,
        )}

    # -- chunk-streaming: bandpass state + two detector scalars -----------------

    def plan_stream(self, ctx, in_specs):
        spec = self._require(in_specs)
        self._sections, self._p = self._pieces(spec.rate)
        dyn.deesser_stream_prepare(self._sections, self._p, spec.width,
                                   ctx.device)
        return ({"output": spec.replace(fmt="flt")},
                {"ds": dyn.deesser_stream_init(spec.channels,
                                               self._sections, ctx.device)})

    def lower_stream(self, ctx, inputs, state):
        chunk = self._require(inputs)
        new_ds, out = dyn.deesser_stream_step(
            self._sections, self._p, state["ds"], chunk.data, chunk.n
        )
        return (
            {"output": chunk.with_data(out, fmt="flt")},
            {"ds": new_ds},
        )
