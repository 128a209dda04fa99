// The N 80 codes-in instances of the K5 probes of the int8 form of the
// Hopper conv kernel (see conv_sm90_i8_probe.cu, which holds the entry
// point).

#include "conv_sm90.cuh"

int sm90::launch_probe_s8_80(const ParamsS8& p, int smem, int phases,
                             cudaStream_t s) {
  return launch_masked<80, FORM_S8>(phases, p, smem, s);
}
