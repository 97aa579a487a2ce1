"""stvd_torch: the stvd video captioner in PyTorch, with CUDA kernels for
NVIDIA Hopper.

A port of the JAX package ``stvd`` beside it, which stays the reference:
module paths and parameter names mirror it, and the tests hold each
ported function against its JAX counterpart.  The package imports torch
and never jax, and nothing of ``stvd``: what it needs of the JAX
package's framework-free modules (config, vocabulary, numpy feature-bank
packing, synthetic data) it keeps as its own copy.
"""
