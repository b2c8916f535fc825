"""Tempo (velocity) and pitch modifier nodes (port of
nodey_tpu.processors.velocity).

Reference: ``processor::Velocity_modifier`` / ``Pitch_modifier``
(src/processor/audio-velocity.cpp). The reference drives SoundTouch with
``setRate(r)`` + ``setPitch(p)``, which SoundTouch factors into a
resampling rate ``r * p`` and a WSOLA tempo ``1 / p``:

* Velocity, keep_pitch=False: rate=v, pitch=1  -> pure resample by v
* Velocity, keep_pitch=True:  rate=v, pitch=1/v -> pure WSOLA tempo v
  (audio-velocity.cpp:446-460)
* Pitch: rate=1, pitch=2^(semitones/12) -> WSOLA tempo 1/p + resample by
  p, preserving duration (audio-velocity.cpp:463-477)

Both stages are in :mod:`nodey_tpu_torch.ops.stretch`; the tempo stage is
WSOLA or, with ``algorithm="pv"``, the phase vocoder
(:mod:`nodey_tpu_torch.ops.pv`). Streamed, the same two stages run as a
streaming tempo stage (WSOLA, :mod:`nodey_tpu_torch.ops.chunkops`, or the
phase vocoder's chunk step, ``pv.pv_stream_step``) chained into a streaming
resampler.
"""

from __future__ import annotations

from typing import Any, Dict, List

from nodey_tpu_torch.core import chunkflow
from nodey_tpu_torch.core.errors import ProcessorRuntimeError
from nodey_tpu_torch.core.registry import PinAttribute, Processor, ProcessorInfo
from nodey_tpu_torch.core.stream import AudioStreamType
from nodey_tpu_torch.ops import chunkops
from nodey_tpu_torch.ops import pv as pv_ops
from nodey_tpu_torch.ops import stretch as stretch_ops

_ALGORITHMS = ("wsola", "pv")


def _audio_pins() -> List[PinAttribute]:
    return [
        PinAttribute("output", "Output", AudioStreamType, is_input=False),
        PinAttribute("input", "Input", AudioStreamType, is_input=True),
    ]


def _require_input(inputs: Dict[str, Any], processor_name: str):
    stream = inputs.get("input")
    if stream is None:
        # Reference: audio-velocity.cpp:278-283.
        raise ProcessorRuntimeError(
            f"{processor_name} has no input",
            f"{processor_name} requires an audio stream input to function "
            "properly.",
            "Input item 'input' not found",
        )
    if stream.rate < 8_000 or stream.rate > 48_000:
        # Reference sample-rate guard: audio-velocity.cpp:371-379.
        raise ProcessorRuntimeError(
            "Unsupported sample rate",
            f"{processor_name} requires a sample rate between 8000 and "
            "48000 Hz.",
            f"Sample rate: {stream.rate}",
        )
    return stream


class _SoundTouchBase(Processor):
    """What Velocity and Pitch share: the tempo-stage algorithm and its
    PV-only flags (extensions: the reference has no such switch, so serde
    writes them only when not default and project files stay
    byte-compatible)."""

    def __init__(self) -> None:
        self.algorithm: str = "wsola"
        self.pv_transient: bool = False
        self.preserve_formants: bool = False

    def _factors(self):
        raise NotImplementedError  # -> (rate, pitch)

    def set_algorithm(self, algorithm: str) -> None:
        """Setter for the tempo-stage family."""
        if algorithm not in _ALGORITHMS:
            raise ProcessorRuntimeError(
                "Unknown tempo algorithm",
                "Velocity/pitch nodes support 'wsola' or 'pv'.",
                f"Got: {algorithm!r}",
            )
        self.algorithm = algorithm

    def _algorithm_spec(self) -> List[Dict[str, Any]]:
        return [
            {"key": "algorithm", "label": "Algorithm", "kind": "enum",
             "choices": list(_ALGORITHMS), "value": self.algorithm},
            {"key": "pv_transient", "label": "PV Transients",
             "kind": "bool", "value": self.pv_transient,
             "show_if": {"key": "algorithm", "value": "pv"}},
            {"key": "preserve_formants", "label": "Keep Formants",
             "kind": "bool", "value": self.preserve_formants,
             "show_if": {"key": "algorithm", "value": "pv"}},
        ]

    def _serialize_algorithm(self, out: Dict[str, Any]) -> Dict[str, Any]:
        if self.algorithm != "wsola":
            out["algorithm"] = self.algorithm
        if self.pv_transient:
            out["pv_transient"] = True
        if self.preserve_formants:
            out["preserve_formants"] = True
        return out

    def _deserialize_algorithm(self, value: Dict[str, Any]) -> None:
        algo = value.get("algorithm")
        if algo in _ALGORITHMS:
            self.algorithm = algo
        tr = value.get("pv_transient")
        if isinstance(tr, bool):
            self.pv_transient = tr
        pf = value.get("preserve_formants")
        if isinstance(pf, bool):
            self.preserve_formants = pf

    def _lower(self, ctx, inputs: Dict[str, Any], name: str):
        stream = _require_input(inputs, name)
        rate, pitch = self._factors()
        out = stretch_ops.soundtouch_like(
            ctx, stream, rate=rate, pitch=pitch,
            algorithm=self.algorithm, pv_transient=self.pv_transient,
            preserve_formants=self.preserve_formants,
        )
        return {"output": out}

    # -- chunk streaming: the (rate, pitch) pair as a streaming tempo stage
    #    chained into a streaming transposition resampler ----------------------

    def plan_stream(self, ctx, in_specs):
        spec = _require_input(in_specs, type(self).__name__)
        rate_f, pitch_f = self._factors()
        eff_rate = rate_f * pitch_f
        eff_tempo = 1.0 / pitch_f

        states = {}
        width = spec.width
        self._wsola_plan = None
        self._pv_plan = None
        if abs(eff_tempo - 1.0) > 1e-9:
            if self.algorithm == "pv":
                # A chunk is a batch of frames; the carries are the FIFO,
                # the synthesis phasor, the last frame's phase and
                # magnitudes, and the overlap-add tail.
                plan = pv_ops.pv_stream_plan(
                    eff_tempo, spec.rate, width,
                    transient=self.pv_transient,
                    formant_ratio=(eff_rate if self.preserve_formants
                                   else 1.0),
                )
                self._pv_plan = plan
                states["w"] = pv_ops.pv_stream_init(plan, spec.channels,
                                                    ctx.device)
            else:
                plan = chunkops.wsola_plan(eff_tempo, spec.rate, width)
                self._wsola_plan = plan
                states["w"] = chunkops.wsola_stream_init(plan, spec.channels,
                                                         ctx.device)
            width = plan.out_cap

        self._rs_plan = None
        if abs(eff_rate - 1.0) > 1e-9:
            num, den = stretch_ops._rational_factor(eff_rate)
            # transpose_rate consumes `num` input samples per `den` outputs.
            mid = chunkflow.ChunkSpec(rate=num, channels=spec.channels,
                                      fmt="flt", width=width)
            _out, states["r"], self._rs_plan = chunkflow.plan_resample_stage(
                mid, den, ctx.device)
            width = self._rs_plan.out_cap

        # Output duration scales by 1/rate_f overall (tempo x transpose), so
        # the nominal arrival per step does too: a merge downstream must see
        # the true cadence to reject a mix it cannot stream.
        cadence = spec.cadence / rate_f if spec.cadence > 0 else -1.0
        return {"output": spec.replace(width=width, fmt="flt",
                                       cadence=cadence)}, states

    def lower_stream(self, ctx, inputs, state):
        chunk = _require_input(inputs, type(self).__name__)
        data, n, done = chunk.data, chunk.n, chunk.done
        new_state = dict(state)
        if self._wsola_plan is not None:
            new_state["w"], data, n, done = chunkops.wsola_stream_step(
                self._wsola_plan, state["w"], data, n, done)
        elif self._pv_plan is not None:
            new_state["w"], data, n, done = pv_ops.pv_stream_step(
                self._pv_plan, state["w"], data, n, done)
        if self._rs_plan is not None:
            new_state["r"], data, n, done = chunkops.resample_stream_step(
                self._rs_plan, state["r"], data, n, done)
        out = chunk.with_data(data, fmt="flt")
        out.n, out.done = n, done
        return {"output": out}, new_state


class VelocityModifier(_SoundTouchBase):
    def __init__(self) -> None:
        super().__init__()
        # Defaults: include/processor/audio-velocity.hpp:11-12.
        self.velocity: float = 1.0
        self.keep_pitch: bool = False

    def _factors(self):
        # reference: audio-velocity.cpp:446-460.
        return self.velocity, (1.0 / self.velocity) if self.keep_pitch else 1.0

    def info(self) -> ProcessorInfo:
        return ProcessorInfo(
            identifier="velocity_modifier",
            display_name="Velocity Modifier",
            singleton=False,
            generate=VelocityModifier,
            description=(
                "Audio Velocity Modifier\n\n## Functionality\n"
                "- Adjusts the velocity of audio streams\n"
                "- Supports pitch preservation with velocity adjustment\n"
            ),
        )

    def pin_attributes(self) -> List[PinAttribute]:
        return _audio_pins()

    def set_velocity(self, velocity: float) -> None:
        """Clamped setter (reference slider 0.5-3.0x, audio-velocity.cpp:115-124)."""
        self.velocity = min(max(float(velocity), 0.5), 3.0)

    def param_spec(self) -> List[Dict[str, Any]]:
        # reference widgets: DragFloat "Velocity" 0.5-3.0, 0.01 step,
        # logarithmic+clamped; Checkbox "Keep Pitch"
        # (audio-velocity.cpp:116-126).
        return [
            {"key": "velocity", "label": "Velocity", "kind": "float",
             "min": 0.5, "max": 3.0, "step": 0.01, "log": True,
             "value": self.velocity},
            {"key": "keep_pitch", "label": "Keep Pitch", "kind": "bool",
             "value": self.keep_pitch},
            *self._algorithm_spec(),
        ]

    # -- serde (reference: audio-velocity.cpp:479-493) -----------------------

    def serialize(self) -> Any:
        return self._serialize_algorithm(
            {"velocity": self.velocity, "keep_pitch": self.keep_pitch})

    def deserialize(self, value: Any) -> None:
        # Tolerant field-by-field restore, like the reference.
        if isinstance(value, dict):
            v = value.get("velocity")
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                # Clamp like the setter: a hand-edited project file may
                # carry anything.
                self.set_velocity(float(v))
            kp = value.get("keep_pitch")
            if isinstance(kp, bool):
                self.keep_pitch = kp
            self._deserialize_algorithm(value)

    def lower(self, ctx, inputs: Dict[str, Any]) -> Dict[str, Any]:
        return self._lower(ctx, inputs, "Velocity Modifier")


class PitchModifier(_SoundTouchBase):
    def __init__(self) -> None:
        super().__init__()
        # Default: include/processor/audio-velocity.hpp:44.
        self.pitch: float = 0.0

    def _factors(self):
        # reference: audio-velocity.cpp:463-477.
        return 1.0, 2.0 ** (self.pitch / 12.0)

    def info(self) -> ProcessorInfo:
        return ProcessorInfo(
            identifier="pitch_modifier",
            display_name="Pitch Modifier",
            singleton=False,
            generate=PitchModifier,
            description=(
                "Audio Pitch Modifier\n\n## Functionality\n"
                "- Adjusts the pitch of audio streams by a note value\n"
            ),
        )

    def pin_attributes(self) -> List[PinAttribute]:
        return _audio_pins()

    def param_spec(self) -> List[Dict[str, Any]]:
        # reference widget: InputFloat "Pitch (Note)" step 0.5, "%+.1f",
        # unclamped (audio-velocity.cpp:142).
        return [
            {"key": "pitch", "label": "Pitch (Note)", "kind": "float",
             "step": 0.5, "value": self.pitch},
            *self._algorithm_spec(),
        ]

    # -- serde (reference: audio-velocity.cpp:495-505) -----------------------

    def serialize(self) -> Any:
        return self._serialize_algorithm({"pitch": self.pitch})

    def deserialize(self, value: Any) -> None:
        if isinstance(value, dict):
            p = value.get("pitch")
            if isinstance(p, (int, float)) and not isinstance(p, bool):
                self.pitch = float(p)
            self._deserialize_algorithm(value)

    def lower(self, ctx, inputs: Dict[str, Any]) -> Dict[str, Any]:
        return self._lower(ctx, inputs, "Pitch Modifier")
