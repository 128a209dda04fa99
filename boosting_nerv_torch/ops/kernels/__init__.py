"""Hand-written Hopper kernels and their Python wrappers.

``planar`` holds the decoder-tail stage kernels (the counterparts of
``boosting_nerv_tpu/ops/pallas/planar.py``) with their plain PyTorch
versions; ``_build`` compiles ``ops/csrc`` with nvcc and binds it."""
