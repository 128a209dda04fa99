// The N 80 instances of the K5 probes of the Hopper conv kernel (see
// conv_sm90_probe.cu, which holds the entry point).

#include "conv_sm90.cuh"

int sm90::launch_probe_80(const Params& p, int smem, int phases,
                          cudaStream_t s) {
  return launch_masked<80>(phases, p, smem, s);
}
