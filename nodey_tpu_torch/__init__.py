"""nodey_tpu_torch — the node-graph audio engine on PyTorch and CUDA.

A port of :mod:`nodey_tpu` (JAX/XLA/Pallas on a TPU) to PyTorch on an
NVIDIA H100. The JAX package stays the reference; this package imports
``torch`` and numpy and never ``jax``. From ``nodey_tpu`` it reuses only
the modules that are free of jax: ``core.errors``, ``core.registry``'s
``PinAttribute``/``ProcessorInfo``/``Processor`` base, ``core.graph.Graph``,
``config`` and ``host.native_lib``.

Layout mirrors the JAX package (``core/``, ``ops/``, ``processors/``,
``host/``, ``app/``). Every op takes its tensors on an explicit device;
there is no global default device. The one TPU kernel on the ported path
(the grouped polyphase resampler) is a hand-written CUDA kernel under
``csrc/``, built with ``nvcc`` at first use.
"""

import torch

__version__ = "0.1.0"

# Float32 products stay full float32 on the card. TF32 keeps ~10 mantissa
# bits and would bring the spectrum and resample GEMMs down to the ~55 dB
# a single bf16 pass gave on the TPU (PARITY.md); set both flags so no
# library default decides it.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
