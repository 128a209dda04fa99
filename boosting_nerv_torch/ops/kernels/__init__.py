"""Hand-written Hopper kernels and their Python wrappers.

``planar`` holds the decoder-tail stage kernels (the counterparts of
``boosting_nerv_tpu/ops/pallas/planar.py``) and ``tile_conv`` the fine-grid
convolutions and ResBlockSFTs (those of ``.../pallas/tile_conv.py``), each
with its plain PyTorch version; ``_build`` compiles ``ops/csrc`` with nvcc
and binds it.

``LAUNCHES`` counts, per wrapper, the calls that launched a CUDA kernel;
every wrapper of both modules adds to it where it launches and nowhere
else."""

LAUNCHES = dict.fromkeys(
    ("fused_upconv_rsft", "fused_conv_rsft", "fused_upconv_rsft_i8",
     "fused_conv_rsft_i8", "conv_tile", "conv_tile_v3", "resblock_sft_tile",
     "resblock_sft_tile_v3"), 0)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
