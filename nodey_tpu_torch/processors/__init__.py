"""The ported nodes: the five of the 5-node stereo graph and the three of
BASELINE config 4 (resample, pitch, velocity).

Identifiers, pins and serde match the JAX package's processors, so project
files load in either package."""

from __future__ import annotations


def register_builtin_processors() -> None:
    from nodey_tpu_torch.core.registry import register_processor
    from nodey_tpu_torch.processors.amix import AudioAmix
    from nodey_tpu_torch.processors.audio_input import AudioInput
    from nodey_tpu_torch.processors.audio_output import AudioOutput
    from nodey_tpu_torch.processors.audio_vol import AudioVol
    from nodey_tpu_torch.processors.resample_node import AudioResample
    from nodey_tpu_torch.processors.spectrum import AudioSpectrum
    from nodey_tpu_torch.processors.velocity import (
        PitchModifier,
        VelocityModifier,
    )

    for cls in (AudioInput, AudioOutput, AudioVol, AudioAmix, AudioSpectrum,
                AudioResample, VelocityModifier, PitchModifier):
        register_processor(cls)
