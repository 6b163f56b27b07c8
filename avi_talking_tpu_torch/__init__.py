"""avi_talking_tpu_torch: the PyTorch / CUDA port of avi_talking_tpu.

It mirrors the JAX package's layout (``audio/``, ``cli/``, ``core/``,
``data/``, ``models/``, ``ops/``, ``pipeline/``, ``text/``, ``train/``,
``viz/``) and imports neither JAX nor the JAX package. Entry points run on
the CUDA card unless the caller passes ``device="cpu"``. Three hand-written
kernels, built with nvcc at first use into ``build/avi_talking_tpu_torch/``:
the wav2vec2 key-bias attention (``ops/kernels/keybias_attention.py``) and
the FaceFormer decoder's biased attention (``ops/kernels/bias_attention.py``),
one strided kernel in ``csrc/bias_attention.cu``; and the rasterizer's
per-tile visibility (``ops/kernels/rasterize.py`` over
``csrc/rasterize_visibility.cu``).
"""
