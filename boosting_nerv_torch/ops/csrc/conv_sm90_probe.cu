// Phase-knockout probes of the Hopper conv kernel (K5): conv_sm90.cuh's
// conv_sm90_kernel<NS, P> with the phase mask P of a probe, one launch as
// bnt_conv_sm90 runs it.  The counterpart on conv_sm90.cu of the stage
// kernel's K1 knockouts (stage_conv_probe.cu), which port the TPU probe
// tools/r3_prologue_probe.py:194 (a stage's time split by removing a
// phase).  Each knockout's output is deterministic, so that it is checked
// as well as timed (boosting_nerv_torch/ops/kernels/probes.py holds the
// plain versions):
//   PHASE_ALL   the production kernel's code, bitwise its output;
//   no STAGE    no repack: the operand tile is zeroed once per block and
//               stays stale (the producer's row copies still run), so
//               the output is that of a zero input;
//   no GEMM     no wgmma (acc = 0; the weight ring still turns): the
//               output of zero weights;
//   no EPI      bf16 of the raw sums: a bias-free conv, no activation,
//               affine or residual;
//   no STORE    stores only under probe_store(): the output untouched.
// This unit holds the C entry point and the N 8 instances (the 51 -> 3
// head); conv_sm90_probe_56.cu, _64.cu and _80.cu hold the others, each
// its own nvcc process.

#include "conv_sm90.cuh"

int sm90::launch_probe_8(const Params& p, int smem, int phases,
                         cudaStream_t s) {
  return launch_masked<8>(phases, p, smem, s);
}

extern "C" {

// bnt_conv_sm90 with the phase mask `phases` (one of sm90::PROBE_MASKS).
int bnt_conv_sm90_probe(const void* x, const void* wpk, const void* bias,
                        const void* in_scale, const void* in_shift,
                        const void* out_scale, const void* out_shift,
                        const void* residual, const void* out_inv, void* out,
                        int n, int h, int w, int cin, int cout, int act,
                        int shuffle, int ks, int ns, int phases,
                        void* stream) {
  sm90::Params p{};
  const int smem = sm90::prepare(p, x, wpk, bias, in_scale, in_shift,
                                 out_scale, out_shift, residual, out_inv,
                                 out, n, h, w, cin, cout, act, shuffle, ks,
                                 ns);
  if (smem < 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ns) {
    case 8: return sm90::launch_probe_8(p, smem, phases, s);
    case 56: return sm90::launch_probe_56(p, smem, phases, s);
    case 64: return sm90::launch_probe_64(p, smem, phases, s);
    default: return sm90::launch_probe_80(p, smem, phases, s);
  }
}

}  // extern "C"
