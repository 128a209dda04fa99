"""Hand-written Hopper kernels and their Python wrappers.

``planar`` holds the decoder-tail stage kernels and the standalone planar
conv and ResBlockSFT (the counterparts of
``boosting_nerv_tpu/ops/pallas/planar.py``), ``tile_conv`` the fine-grid
convolutions and ResBlockSFTs (those of ``.../pallas/tile_conv.py``),
``conv_chw`` and ``fused_sft`` the v1 decode's convolutions and
ResBlockSFT (those of ``.../pallas/conv_chw.py`` and ``fused_sft.py``),
``probes`` the measurement probes of the conv kernels (those of the
repository's ``tools/``, and the Hopper kernel's phase knockouts), each
with its plain PyTorch version; ``_build`` compiles ``ops/csrc`` with nvcc
and binds it.

``LAUNCHES`` counts, per wrapper, the calls that launched a CUDA kernel;
every wrapper of these modules adds to it where it launches and nowhere
else."""

LAUNCHES = dict.fromkeys(
    ("fused_upconv_rsft", "fused_conv_rsft", "fused_upconv_rsft_i8",
     "fused_conv_rsft_i8", "conv_tile", "conv_tile_v3", "resblock_sft_tile",
     "resblock_sft_tile_v3", "conv3x3_act_chw", "head_conv_chw",
     "resblock_sft_chw", "conv_planar", "rsft_planar", "stage_conv_probe",
     "stage_conv_i8_probe", "gemm_probe", "stage_build_probe",
     "conv_sm90_probe"), 0)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
