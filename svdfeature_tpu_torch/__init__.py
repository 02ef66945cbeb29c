"""svdfeature_tpu_torch: the PyTorch / CUDA port of svdfeature_tpu.

The JAX package ``svdfeature_tpu`` is the reference this package is held
against; this one imports torch and numpy and never jax.  It mirrors the
JAX package's module paths.  Ported so far: the base solver on the
random-order format (basicMF, binaryClassification, neighborhoodModel)
and the SVD++ solver on the user-group format (implicitFeedback), from
config and buffers through training, checkpoints and RMSE eval, each
solver's training run a hand-written CUDA kernel for Hopper
(``ops/cuda_embed.py`` / ``csrc/fused_embed.cu``, ``ops/cuda_svdpp.py`` /
``csrc/fused_svdpp.cu``).  The numpy-only modules
(config, params, data, utils) are verbatim copies of the JAX package's.
"""

__version__ = "0.1.0"
