// The N 80 instances of the int8 form of the Hopper conv kernel (see
// conv_sm90_i8.cu, which holds the entry points).

#include "conv_sm90.cuh"

int sm90::launch_s8_80(const ParamsS8& p, int smem, int f, cudaStream_t s) {
  return launch_s8<80>(p, smem, f, s);
}
