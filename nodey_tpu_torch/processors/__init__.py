"""The ported nodes: the five of the 5-node stereo graph, the three of
BASELINE config 4 (resample, pitch, velocity), the three of configs 2
and 5 (channel split, bimix v1 and v2), the seven master-bus nodes
(EQ, filter, compressor, limiter, gate, de-esser, normalize), the
eight single-input effects (reverb, delay, tremolo, chorus, phaser, pan,
width, fade), and the nodes that make, join or cut streams (generator,
crossfade, trim, reverse): 30 node types, all of the JAX package's.

Identifiers, pins and serde match the JAX package's processors, so project
files load in either package."""

from __future__ import annotations


def register_builtin_processors() -> None:
    from nodey_tpu_torch.core.registry import register_processor
    from nodey_tpu_torch.processors.amix import AudioAmix
    from nodey_tpu_torch.processors.audio_input import AudioInput
    from nodey_tpu_torch.processors.audio_output import AudioOutput
    from nodey_tpu_torch.processors.audio_vol import AudioVol
    from nodey_tpu_torch.processors.bimix import AudioBimix, AudioBimixV2
    from nodey_tpu_torch.processors.compressor import AudioCompressor
    from nodey_tpu_torch.processors.crossfade import AudioCrossfade
    from nodey_tpu_torch.processors.deesser import AudioDeesser
    from nodey_tpu_torch.processors.delay import AudioDelay
    from nodey_tpu_torch.processors.editnodes import AudioReverse, AudioTrim
    from nodey_tpu_torch.processors.equalizer import AudioEq, AudioFilter
    from nodey_tpu_torch.processors.fade import AudioFade
    from nodey_tpu_torch.processors.gate import AudioGate
    from nodey_tpu_torch.processors.generator import AudioGenerator
    from nodey_tpu_torch.processors.limiter import AudioLimiter
    from nodey_tpu_torch.processors.modulation import (AudioChorus,
                                                       AudioPhaser,
                                                       AudioTremolo)
    from nodey_tpu_torch.processors.normalize import AudioNormalize
    from nodey_tpu_torch.processors.pan import AudioPan, AudioWidth
    from nodey_tpu_torch.processors.resample_node import AudioResample
    from nodey_tpu_torch.processors.reverb import AudioReverb
    from nodey_tpu_torch.processors.spectrum import AudioSpectrum
    from nodey_tpu_torch.processors.split import AudioSplit
    from nodey_tpu_torch.processors.velocity import (
        PitchModifier,
        VelocityModifier,
    )

    for cls in (AudioInput, AudioOutput, AudioVol, AudioAmix, AudioSpectrum,
                AudioResample, VelocityModifier, PitchModifier, AudioSplit,
                AudioBimix, AudioBimixV2, AudioEq, AudioFilter,
                AudioCompressor, AudioLimiter, AudioGate, AudioDeesser,
                AudioNormalize, AudioReverb, AudioDelay, AudioTremolo,
                AudioChorus, AudioPhaser, AudioPan, AudioWidth, AudioFade,
                AudioGenerator, AudioCrossfade, AudioTrim, AudioReverse):
        register_processor(cls)
