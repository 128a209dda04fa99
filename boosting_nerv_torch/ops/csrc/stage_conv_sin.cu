// The sin instances of the bf16 stage-conv kernel (stage_conv.cuh), KS = 3
// with a bf16 store, compiled beside stage_conv.cu: the two launches of the
// ResBlockSFT whose block input is sin(x) (ops/kernels/fused_sft.py, the
// port of boosting_nerv_tpu/ops/pallas/fused_sft.py's input_sin).  conv0
// stages sin(x) * (scale0 + 1) + shift0 (SIN_INPUT); conv1 adds sin(x) as
// its residual (SIN_RESIDUAL), so neither launch writes sin(x) to device
// memory (a separate sin pass would write and read 211 MB more at
// 1080x1920x51).  The sine adds one reduced SFU sine per staged or residual
// element; what bounds the launches is as stage_conv.cu says.  Only
// bnt_stage_conv (stage_conv.cu) calls launch_sin, after checking the shape.

#include "stage_conv.cuh"

int bnt::launch_sin(int sin_mode, const Params& p, int smem,
                    cudaStream_t s) {
  return sin_mode == SIN_INPUT ? launch<3, false, SIN_INPUT>(p, smem, s)
                               : launch<3, false, SIN_RESIDUAL>(p, smem, s);
}
