"""The port's hand-written Hopper kernels, each beside its plain PyTorch
version: ``lin_kernel`` (kernel A) and ``sqp_fused_kernel`` (kernel B, with
``condense_common`` and ``qp_kernel`` holding its plain algebra).  The CUDA
library is built from ``csrc/`` at the first launch on a CUDA tensor."""
