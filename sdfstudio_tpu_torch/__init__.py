"""PyTorch + CUDA port of ``sdfstudio_tpu`` for one NVIDIA H100.

The JAX package ``sdfstudio_tpu`` is the reference; every module here names
its counterpart there by file and line. This package imports ``torch``,
``numpy`` and the standard library only -- never ``jax`` and nothing of
``sdfstudio_tpu`` -- so it runs on a machine that has neither.

Slice 1 covers the serving path of ``neus-facto-tpu-p8``: render an image
from a trained (or seeded) model, with the fully-fused MLP forward as a
hand-written CUDA kernel (``ops/fused_mlp.py`` + ``csrc/fused_mlp_fwd.cu``).
"""
