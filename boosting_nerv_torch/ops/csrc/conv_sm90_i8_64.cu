// The N 64 instances of the int8 form of the Hopper conv kernel, at
// ROWS_S8_64 output rows a warpgroup (see conv_sm90_i8.cu, which holds the
// entry points).

#include "conv_sm90.cuh"

int sm90::launch_s8_64(const ParamsS8& p, int smem, int f, cudaStream_t s) {
  return launch_s8<64, PHASE_ALL, ROWS_S8_64>(p, smem, f, s);
}
