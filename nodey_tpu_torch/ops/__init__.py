"""Per-node DSP on torch tensors, plus the CUDA kernel wrappers."""
