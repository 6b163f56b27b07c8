"""Tensor ops: resampling, positional encodings, transformer blocks and the
hand-written CUDA kernels (``ops/kernels``)."""
