"""PyTorch + CUDA port of ``sdfstudio_tpu`` for one NVIDIA H100.

The JAX package ``sdfstudio_tpu`` is the reference; every module here names
its counterpart there by file and line. This package imports ``torch``,
``numpy`` and the standard library only -- never ``jax`` and nothing of
``sdfstudio_tpu`` -- so it runs on a machine that has neither.

Its entry points are JAX's: ``scripts/train.py`` (``sst-train``'s grammar
and run layout), ``scripts/eval.py`` and ``scripts/extract_mesh.py``, for
the registered methods of ``configs/methods.py``: rendering an image from a
trained (or seeded) model (``engine/final_eval.py``) and training it on an
SDFStudio-format scene, with the fully-fused MLP as
hand-written CUDA kernels, forward and backward (``ops/fused_mlp.py`` +
``csrc/fused_mlp_fwd.cu``, ``csrc/fused_mlp_bwd.cu``). The gather-probe
entry points (``scripts/benchmarking/``) run the row-gather kernels
(``ops/row_gather.py`` + ``csrc/row_gather.cu``).
"""

import torch as _torch

# PyTorch's CPU builds compute float32 sin, exp, sqrt, ... through MKL's VML,
# in chunks of >= 2048 elements spread over OpenMP threads, at VML's
# high-accuracy setting. VML sets up its dispatch at its first call in the
# process; when several threads make that first call at once, a thread may
# compute its chunk at the enhanced-performance setting instead (sin off by
# ~1.5e-4 instead of ~4e-8). One small call here, on one thread, sets VML
# up before any threaded call.
_torch.sin(_torch.zeros(16))
