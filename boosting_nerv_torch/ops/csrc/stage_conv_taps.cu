// The KS = 1 and KS = 5 instances of the bf16 stage-conv kernel
// (stage_conv.cuh), compiled beside stage_conv.cu's KS = 3 ones: the 1x1
// and 5x5 convolutions of the fine-grid tile wrappers
// (ops/kernels/tile_conv.py).  Only bnt_stage_conv (stage_conv.cu) calls
// launch_taps, after checking the shape.

#include "stage_conv.cuh"

int bnt::launch_taps(int ks, const Params& p, int smem, cudaStream_t s) {
  return ks == 1 ? launch<1, false>(p, smem, s) : launch<5, false>(p, smem, s);
}
