"""STFT spectrum tap node (port of nodey_tpu.processors.spectrum).

Audio passes through unchanged on ``output``; the magnitude spectrogram
is emitted as the side output ``spectrum_<node id>``. Streamed, a
hop-aligned frame FIFO emits each step's complete frames as
``(frames, count, done)``.
"""

from __future__ import annotations

from typing import Any, Dict, List

from nodey_tpu_torch.core.errors import ProcessorRuntimeError
from nodey_tpu_torch.core.registry import PinAttribute, Processor, ProcessorInfo
from nodey_tpu_torch.core.stream import AudioStreamType
from nodey_tpu_torch.ops import chunkops
from nodey_tpu_torch.ops import stft as stft_ops


class AudioSpectrum(Processor):
    def __init__(self) -> None:
        self.n_fft: int = 1024
        self.hop: int = 512

    def info(self) -> ProcessorInfo:
        return ProcessorInfo(
            identifier="audio_spectrum",
            display_name="Spectrum",
            singleton=False,
            generate=AudioSpectrum,
            description=(
                "STFT Spectrum Tap\n\n## Functionality\n"
                "- Passes audio through unchanged\n"
                "- Emits a Hann-windowed magnitude spectrogram side output\n"
            ),
        )

    def pin_attributes(self) -> List[PinAttribute]:
        return [
            PinAttribute("output", "Output", AudioStreamType, is_input=False),
            PinAttribute("input", "Input", AudioStreamType, is_input=True),
        ]

    def serialize(self) -> Any:
        return {"n_fft": self.n_fft, "hop": self.hop}

    def deserialize(self, value: Any) -> None:
        # Tolerant load clamps out-of-range values (hop=0 would divide by 0).
        if isinstance(value, dict):
            n_fft = value.get("n_fft")
            hop = value.get("hop")
            if isinstance(n_fft, int) and not isinstance(n_fft, bool):
                self.n_fft = max(2, n_fft)
            if isinstance(hop, int) and not isinstance(hop, bool):
                self.hop = max(1, hop)

    @staticmethod
    def _require(inputs):
        value = inputs.get("input")
        if value is None:
            raise ProcessorRuntimeError(
                "Spectrum processor has no input",
                "Spectrum requires an audio stream input to function properly.",
                "Input item 'input' not found",
            )
        return value

    def lower(self, ctx, inputs: Dict[str, Any]) -> Dict[str, Any]:
        stream = self._require(inputs)
        spectrum = stft_ops.magnitude_spectrogram(
            stream, n_fft=self.n_fft, hop=self.hop
        )
        ctx.emit(
            f"spectrum_{ctx.node_id}",
            spectrum,
            meta={"hop": self.hop, "n_fft": self.n_fft, "rate": stream.rate},
        )
        return {"output": stream}

    def plan_stream(self, ctx, in_specs):
        spec = self._require(in_specs)
        plan = chunkops.stft_plan(self.n_fft, self.hop, spec.width)
        self._stream_plan = plan
        ctx.emit_spec(f"spectrum_{ctx.node_id}", {
            "kind": "frames", "hop": self.hop, "n_fft": self.n_fft,
            "rate": spec.rate, "frames_cap": plan.frames_cap,
        })
        return {"output": spec}, chunkops.stft_stream_init(
            plan, spec.channels, ctx.device)

    def lower_stream(self, ctx, inputs, state):
        chunk = self._require(inputs)
        state, frames, count, done = chunkops.stft_stream_step(
            self._stream_plan, state, chunk.data, chunk.n, chunk.done)
        ctx.emit(f"spectrum_{ctx.node_id}", (frames, count, done))
        return {"output": chunk}, state
