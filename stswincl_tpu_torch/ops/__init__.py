"""Tensor ops of the port: plain PyTorch functions and the wrappers of the
CUDA kernels (K1 `block_attention`, K2 `add_ln_mlp`, K3 `patch_merge`,
K4 `upsample_argmax`), each beside its plain twin."""
