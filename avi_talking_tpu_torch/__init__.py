"""avi_talking_tpu_torch: the PyTorch / CUDA port of avi_talking_tpu.

It mirrors the JAX package's layout (``audio/``, ``core/``, ``models/``,
``ops/``, ``pipeline/``, ``text/``) and imports neither JAX nor the JAX
package. Entry points run on the CUDA card unless the caller passes
``device="cpu"``. The one hand-written kernel on the generate path is the
wav2vec2 key-bias attention (``ops/kernels/keybias_attention.py`` over
``csrc/keybias_attention.cu``), built with nvcc at first use into
``build/avi_talking_tpu_torch/``.
"""
