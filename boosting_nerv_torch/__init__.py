"""boosting_nerv_torch — the PyTorch + CUDA port of boosting_nerv_tpu.

The JAX package beside it stays the reference; this package mirrors its
module names (``config``, ``ops``, ``models``, ``runtime``) so each
counterpart is easy to find.  It imports nothing of the JAX package, so it
runs where only torch is installed.

What is ported so far is the HNeRV-Boost serving decode: the eager model
(``models.hnerv.HNeRVBoost``), the flax-checkpoint bridge (``bridge``) and
``runtime.fast_decode.build_serving_decode``, whose decoder tail runs on
hand-written Hopper kernels (``ops/csrc/stage_conv.cu``, bound in
``ops.kernels.planar``).  The package imports torch and never jax.
"""

__version__ = "0.1.0"
