"""PyTorch / CUDA port of the repo's accelerator half, for one NVIDIA Hopper
card.  It serves every family of the repo and trains the dense one; its
TPU kernels become hand-written CUDA kernels under ``kernels/``.

The JAX package ``repro`` is the reference: this package imports nothing of
it, nor JAX.  Entry points run on CUDA unless the caller passes another
device; a tensor's device decides between a kernel and its plain version.
"""
