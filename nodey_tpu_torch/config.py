"""Static configuration constants the port reads.

The values of ``nodey_tpu.config`` (reference: include/config.hpp:13-77)
that the ported nodes, the runner, the encoders and the preview playback
use; a test pins them equal to the JAX package's. The TPU-only knobs (``block_size``,
``precision``, ``interpret``, platform selection, the XLA compile cache)
have no counterpart here.
"""

from __future__ import annotations

import dataclasses

SAMPLE_RATE = 48_000          # canonical output sample rate
BUFFER_SIZE = 2_048           # playback packet size (samples per packet)
MAX_BUFFER_ITEMS = 3          # max queued playback packets (~128 ms ceiling)

AUDIO_INPUT_NODE_NAME = "audio_input"

AUDIO_STREAM_BUFFER_SIZE = 16     # blocks per streaming stage queue

AUDIO_VOLUME_MAX = 10.0           # gain slider ceiling
AMIX_STD_SAMPLE_RATE = 48_000     # mixer output rate
BIMIX_STD_SAMPLE_RATE = 48_000    # bimix output rate


@dataclasses.dataclass(frozen=True)
class ExecConfig:
    """``pad_quantum`` buckets offline clip lengths (the JAX package's
    recompile bucketing, kept so buffer widths, and every length derived
    from them, match it)."""

    pad_quantum: int = 1 << 16


DEFAULT_EXEC = ExecConfig()
