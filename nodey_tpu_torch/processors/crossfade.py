"""Crossfade node, a timed A->B splice (port of
nodey_tpu.processors.crossfade).

Two-input analytic time variance (ops/crossfade.py): the blend gain at
sample i is a pure function of the global index, so the offline and the
chunk-streamed renders are bitwise equal outside the window (selection by
``torch.where`` on the index) and inside it on one device. Streaming goes
through the aligned merge every two-input node uses (core/chunkflow.py)
plus one position carry, a host int.

Both inputs must share rate, channel count and a zero start offset;
mismatches raise the JAX node's structured errors, pointing at
audio_resample / audio_pan / audio_bimix_v2, rather than converting one
side implicitly.
"""

from __future__ import annotations

from typing import Any, Dict, List

from nodey_tpu_torch.core import chunkflow
from nodey_tpu_torch.core.errors import ProcessorRuntimeError
from nodey_tpu_torch.core.registry import PinAttribute, Processor, ProcessorInfo
from nodey_tpu_torch.core.stream import AudioStreamType
from nodey_tpu_torch.ops import crossfade as cf
from nodey_tpu_torch.ops.scans import mask_tail

_DESCRIPTION = """Crossfade

## Functionality
- Blends input A into input B over a timed window (equal-power or
  linear law)
- Bitwise A before the window, bitwise B after it
- Inputs share one timeline; output runs until the longer input ends

## Usage
- Connect the outgoing clip to 'From (A)', the incoming one to
  'To (B)'
- Set 'At (s)' to the window start and 'Duration (ms)' to its length
- Equal-power keeps perceived loudness constant through the splice
"""


class AudioCrossfade(Processor):
    batched = True  # one gain row, each clip to its longer input
    _CLAMPS = {
        "at_s": (0.0, 86_400.0),
        "dur_ms": (1.0, 60_000.0),
    }
    _LAWS = ("equal_power", "linear")

    def __init__(self) -> None:
        self.at_s: float = 0.0
        self.dur_ms: float = 2_000.0
        self.law: str = "equal_power"

    def info(self) -> ProcessorInfo:
        return ProcessorInfo(
            identifier="audio_crossfade",
            display_name="Crossfade",
            singleton=False,
            generate=AudioCrossfade,
            description=_DESCRIPTION,
        )

    def pin_attributes(self) -> List[PinAttribute]:
        return [
            PinAttribute("output", "Output", AudioStreamType, is_input=False),
            PinAttribute("input_a", "From (A)", AudioStreamType,
                         is_input=True),
            PinAttribute("input_b", "To (B)", AudioStreamType,
                         is_input=True),
        ]

    def set_param(self, key: str, value: float) -> None:
        lohi = self._CLAMPS.get(key)
        if lohi is not None:
            setattr(self, key, min(max(float(value), lohi[0]), lohi[1]))

    def set_law(self, value: str) -> None:
        if value in self._LAWS:
            self.law = value

    def param_spec(self) -> List[Dict[str, Any]]:
        return [
            {"key": "at_s", "label": "At (s)", "kind": "float",
             "min": 0.0, "max": 86_400.0, "step": 0.1,
             "value": self.at_s},
            {"key": "dur_ms", "label": "Duration (ms)", "kind": "float",
             "min": 1.0, "max": 60_000.0, "step": 10.0, "log": True,
             "value": self.dur_ms},
            {"key": "law", "label": "Law", "kind": "enum",
             "choices": list(self._LAWS), "value": self.law},
        ]

    def serialize(self) -> Any:
        return {"at_s": self.at_s, "dur_ms": self.dur_ms,
                "law": self.law}

    def deserialize(self, value: Any) -> None:
        if isinstance(value, dict):
            for k in ("at_s", "dur_ms"):
                v = value.get(k)
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    self.set_param(k, float(v))
            law = value.get("law")
            if isinstance(law, str):
                self.set_law(law)

    def _require(self, inputs):
        a = inputs.get("input_a")
        b = inputs.get("input_b")
        if a is None or b is None:
            missing = "input_a" if a is None else "input_b"
            raise ProcessorRuntimeError(
                "Crossfade is missing an input",
                "This node requires audio streams on both 'From (A)' "
                "and 'To (B)'.",
                f"Input item '{missing}' not found",
            )
        return a, b

    def _validate(self, a_rate, b_rate, a_ch, b_ch, a_t0, b_t0):
        if a_rate != b_rate:
            raise ProcessorRuntimeError(
                "Crossfade inputs have different sample rates",
                "Both inputs must share one sample rate; insert an "
                "audio_resample node on one side.",
                f"{a_rate} Hz vs {b_rate} Hz",
            )
        if a_ch != b_ch:
            raise ProcessorRuntimeError(
                "Crossfade inputs have different channel counts",
                "Both inputs must share a channel layout; insert an "
                "audio_pan node to place the mono side in stereo.",
                f"{a_ch} ch vs {b_ch} ch",
            )
        if float(a_t0) != 0.0 or float(b_t0) != 0.0:
            raise ProcessorRuntimeError(
                "Crossfade inputs carry start offsets",
                "Both inputs must start at timeline zero; align offset "
                "streams with audio_bimix_v2 or re-export them first.",
                f"t0_us: {a_t0} vs {b_t0}",
            )

    def lower(self, ctx, inputs: Dict[str, Any]) -> Dict[str, Any]:
        a, b = self._require(inputs)
        self._validate(a.rate, b.rate, a.channels, b.channels,
                       a.t0_us, b.t0_us)
        return {"output": cf.crossfade_streams(
            a, b, self.at_s, self.dur_ms, self.law
        )}

    # -- chunk streaming: aligned-merge FIFOs and one position (a host int) --

    def plan_stream(self, ctx, in_specs):
        if "input_a" not in in_specs or "input_b" not in in_specs:
            self._require({})
        sa, sb = in_specs["input_a"], in_specs["input_b"]
        self._validate(sa.rate, sb.rate, sa.channels, sb.channels,
                       sa.t0_us, sb.t0_us)
        self._window = cf.crossfade_spec(sa.rate, self.at_s, self.dur_ms)
        specs = [sa.replace(fmt="flt"), sb.replace(fmt="flt")]
        self._merge_plan, merge_fifos = chunkflow.plan_aligned_merge(
            specs, [0, 0], ctx.device)
        out_spec = chunkflow.ChunkSpec(
            rate=sa.rate, channels=sa.channels, fmt="flt",
            width=self._merge_plan["take_cap"], t0_us=0.0,
            cadence=specs[0].cadence,
        )
        return {"output": out_spec}, {"merge": merge_fifos, "pos": 0}

    def lower_stream(self, ctx, inputs, state):
        a, b = self._require(inputs)
        merge, windows, take, done = chunkflow.run_aligned_merge(
            self._merge_plan, state["merge"], [a, b])
        n0, n_dur = self._window
        pos = state["pos"]
        data = mask_tail(cf.crossfade_blend(windows[0], windows[1], pos, n0,
                                            n_dur, self.law), take)
        out = chunkflow.ChunkStream(
            data=data, n=take, done=done,
            spec=chunkflow.ChunkSpec(
                rate=a.spec.rate, channels=data.shape[0], fmt="flt",
                width=data.shape[1], t0_us=0.0,
            ),
        )
        return {"output": out}, {"merge": merge, "pos": pos + take}
