"""PyTorch/CUDA port of vit_ae_plus_plus_tpu for NVIDIA Hopper (H100).

The JAX package beside it is the reference. This package imports neither
JAX nor anything of `vit_ae_plus_plus_tpu`. Entry points run on `cuda`
unless the caller passes `device="cpu"`; the hand-written kernels under
`kernels/csrc/` are built with nvcc at first use.
"""

__version__ = "0.1.0"
