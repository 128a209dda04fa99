"""boosting_nerv_torch — the PyTorch + CUDA port of boosting_nerv_tpu.

The JAX package beside it stays the reference; this package mirrors its
module names (``config``, ``ops``, ``models``, ``runtime``, ``data``,
``training``, ``compress``, ``utils``) so each counterpart is easy to
find.  It imports nothing of the JAX package, so it runs where only torch
is installed.

What is ported so far: the HNeRV-Boost serving decodes
(``runtime.fast_decode.build_serving_decode`` and the other builders),
whose decoder tails run on hand-written Hopper kernels (``ops/csrc``,
bound in ``ops.kernels``); the eager model (``models.hnerv.HNeRVBoost``);
the parameter bridge to and from the JAX package's flax layout
(``bridge``); and the regression trainer (``training.trainer``, with the
CLI ``python -m boosting_nerv_torch.train_nerv_all``).  The package
imports torch and never jax.
"""

__version__ = "0.1.0"
