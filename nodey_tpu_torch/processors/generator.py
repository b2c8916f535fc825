"""Signal-generator node, a test-signal source on the device (port of
nodey_tpu.processors.generator).

A source with no host feed: ``lower()`` synthesizes the whole stream on
the context's device (``ctx.device``), and the streamed path synthesizes
each chunk at a carried absolute position, bitwise the offline buffer
where ``sin`` evaluates alike (ops/oscillator.py). The streaming executor
gives it a chunk width on the decode feeds' time quantum through the plan
hints (``ctx.hints[node_id]["chunk_width"]``); without a hint it takes
max(256, 2 s of samples), as the JAX node.

The chunked renderer refuses it (it is not in ``_LTI_NODES``): a source
has no external buffer to window. For the same reason the sp planner
(``parallel.sharded.plan_sharded``) refuses a graph that holds it, through
``supports_chunked``, as the JAX planner does.
"""

from __future__ import annotations

from typing import Any, Dict, List

from nodey_tpu_torch.core.chunkflow import ChunkSpec, ChunkStream
from nodey_tpu_torch.core.registry import PinAttribute, Processor, ProcessorInfo
from nodey_tpu_torch.core.stream import AudioStreamType
from nodey_tpu_torch.ops import oscillator as osc
from nodey_tpu_torch.ops.oscillator import WAVEFORMS

_DESCRIPTION = """Signal Generator

## Functionality
- Generates a test signal on-device: sine, square, triangle, saw or
  white noise
- Exact by construction: integer phase residues (frequency quantized
  by less than a millihertz at 48 kHz) and counter-hash noise, so
  offline and streamed renders are bitwise identical
- Square/saw/triangle are sample-exact NAIVE shapes (not band-limited)
  — they alias by design; this is a test source, not an instrument

## Usage
- Connect 'Output' to any audio chain; no input file is needed
- Pick waveform, frequency, level, duration, sample rate and channels
- 'seed' decorrelates noise instances (channels already decorrelate)
"""

_STD_RATES = (8000, 11025, 16000, 22050, 24000, 32000,
              44100, 48000, 88200, 96000, 192000)


class AudioGenerator(Processor):
    batched = True  # the one clip, copied once per clip of the batch
    _CLAMPS = {
        "freq": (1.0, 20_000.0),
        "level_db": (-80.0, 0.0),
        "duration_s": (0.01, 3_600.0),
        "seed": (0, 2**31 - 1),
    }

    def __init__(self) -> None:
        self.waveform: str = "sine"
        self.freq: float = 440.0
        self.level_db: float = -12.0
        self.duration_s: float = 5.0
        self.rate: int = 48_000
        self.channels: int = 2
        self.seed: int = 0

    def info(self) -> ProcessorInfo:
        return ProcessorInfo(
            identifier="audio_generator",
            display_name="Signal Generator",
            singleton=False,
            generate=AudioGenerator,
            description=_DESCRIPTION,
        )

    def pin_attributes(self) -> List[PinAttribute]:
        return [
            PinAttribute("output", "Output", AudioStreamType, is_input=False),
        ]

    # -- params ----------------------------------------------------------------

    def set_param(self, key: str, value: Any) -> None:
        if key == "waveform":
            if value in WAVEFORMS:
                self.waveform = value
            return
        if key == "rate":
            if int(value) in _STD_RATES:
                self.rate = int(value)
            return
        if key == "channels":
            if int(value) in (1, 2):
                self.channels = int(value)
            return
        lohi = self._CLAMPS.get(key)
        if lohi is not None:
            v = min(max(float(value), lohi[0]), lohi[1])
            setattr(self, key, int(v) if key == "seed" else v)

    def param_spec(self) -> List[Dict[str, Any]]:
        return [
            {"key": "waveform", "label": "Waveform", "kind": "enum",
             "choices": list(WAVEFORMS), "value": self.waveform},
            {"key": "freq", "label": "Frequency (Hz)", "kind": "float",
             "min": 1.0, "max": 20_000.0, "step": 1.0, "log": True,
             "value": self.freq},
            {"key": "level_db", "label": "Level (dBFS)", "kind": "float",
             "min": -80.0, "max": 0.0, "step": 0.5, "value": self.level_db},
            {"key": "duration_s", "label": "Duration (s)", "kind": "float",
             "min": 0.01, "max": 3_600.0, "step": 0.1, "log": True,
             "value": self.duration_s},
            {"key": "rate", "label": "Sample rate", "kind": "enum",
             "choices": [str(r) for r in _STD_RATES],
             "value": str(self.rate)},
            {"key": "channels", "label": "Channels", "kind": "enum",
             "choices": ["1", "2"], "value": str(self.channels)},
            {"key": "seed", "label": "Noise seed", "kind": "int",
             "min": 0, "max": 2**31 - 1, "step": 1, "value": self.seed},
        ]

    def serialize(self) -> Any:
        return {
            "waveform": self.waveform, "freq": self.freq,
            "level_db": self.level_db, "duration_s": self.duration_s,
            "rate": self.rate, "channels": self.channels, "seed": self.seed,
        }

    def deserialize(self, value: Any) -> None:
        if not isinstance(value, dict):
            return
        for key in ("waveform", "freq", "level_db", "duration_s",
                    "rate", "channels", "seed"):
            if key in value:
                v = value[key]
                if key == "waveform":
                    if isinstance(v, str):
                        self.set_param(key, v)
                elif isinstance(v, (int, float)) and not isinstance(v, bool):
                    self.set_param(key, v)

    # -- derived geometry --------------------------------------------------------

    @property
    def total_samples(self) -> int:
        return max(1, round(self.duration_s * self.rate))

    def _gain(self) -> float:
        return float(10.0 ** (self.level_db / 20.0))

    # -- offline lowering: synthesize on the graph's device -----------------

    def lower(self, ctx, inputs: Dict[str, Any]) -> Dict[str, Any]:
        total = self.total_samples
        capacity = -(-total // 256) * 256  # the JAX node's static padding
        return {"output": osc.generator_stream(
            self.waveform, self.freq, self._gain(), self.seed,
            self.rate, self.channels, total, capacity, ctx.device,
            batch=ctx.batch,
        )}

    # -- chunk streaming: position and phase-residue carries (host ints) -----

    def _spec(self, width: int) -> ChunkSpec:
        return ChunkSpec(rate=self.rate, channels=self.channels, fmt="flt",
                         width=width, t0_us=0.0, cadence=float(width))

    def plan_stream(self, ctx, in_specs):
        hint = ctx.hints.get(ctx.node_id) or {}
        width = int(hint.get("chunk_width", 0)) or max(
            256, round(2.0 * self.rate)
        )
        self._num, self._m = osc.osc_quantize(self.freq, self.rate)
        self._stream_geom = (width, ctx.device)
        osc.generator_prepare(self.waveform, self._num, self._m, width,
                              ctx.device)
        return {"output": self._spec(width)}, {
            "gen": osc.generator_stream_init()}

    def lower_stream(self, ctx, inputs, state):
        width, device = self._stream_geom
        new_gen, data, n, done = osc.generator_stream_step(
            self.waveform, self._num, self._m, self._gain(), self.seed,
            self.channels, self.total_samples, state["gen"], width, device,
        )
        return (
            {"output": ChunkStream(data=data, n=n, done=done,
                                   spec=self._spec(width))},
            {"gen": new_gen},
        )
