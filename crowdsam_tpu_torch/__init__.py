"""PyTorch/CUDA port of crowdsam-tpu.

Same pipeline as the JAX package (`crowdsam_tpu`), held against it on the
same weights and inputs.  Plain tensor code is PyTorch; every TPU kernel on
the ported path is a hand-written CUDA kernel for Hopper (`csrc/`), with a
plain PyTorch version beside it that CPU tensors take.

Layout matches the JAX package: NHWC at the public functions, the torch
reference's state-dict key names in every module.
"""

__version__ = "0.1.0"
