"""PyTorch/CUDA port of the SALO reproduction (the JAX package ``repro``
is the reference). Same subpackage layout as ``repro``; see README.md,
"PyTorch/CUDA port"."""
