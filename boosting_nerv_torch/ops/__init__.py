"""Tensor ops of the port: positional encoding, activations, PixelShuffle,
output squashing, and the hand-written kernels under ``kernels/``."""
