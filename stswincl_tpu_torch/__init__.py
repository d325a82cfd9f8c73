"""PyTorch/CUDA port of stswincl_tpu for one NVIDIA H100.

The JAX package `stswincl_tpu` stays the reference. This package mirrors
its layout (`ops/`, `models/`, `pipelines/`, `ckpt/`); the hand-written
Hopper kernels live in `csrc/` and are built and loaded by `kernels/`.
It imports torch and never JAX.
"""
