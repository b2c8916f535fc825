"""nodey_tpu_torch — the node-graph audio engine on PyTorch and CUDA.

A port of :mod:`nodey_tpu` (JAX/XLA/Pallas on a TPU) to PyTorch on an
NVIDIA H100. The JAX package stays the reference; this package imports
``torch`` and numpy, never ``jax``, and nothing of ``nodey_tpu``: it keeps
its own copies of the jax-free modules it needs (``core.errors``,
``core.registry``, ``core.graph``, ``config``, ``host.native_lib`` and the
codec runtime's sources).

Layout mirrors the JAX package (``core/``, ``ops/``, ``processors/``,
``host/``, ``app/``). Every op takes its tensors on an explicit device;
there is no global default device. The TPU kernels on the ported paths
(the grouped polyphase resampler, the WSOLA serial splice chain) are
hand-written CUDA kernels under ``csrc/``, built with ``nvcc`` at first
use.
"""

import torch

__version__ = "0.1.0"

# Float32 products stay full float32 on the card. TF32 keeps ~10 mantissa
# bits and would bring the spectrum and resample GEMMs down to the ~55 dB
# a single bf16 pass gave on the TPU (PARITY.md); set both flags so no
# library default decides it.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
