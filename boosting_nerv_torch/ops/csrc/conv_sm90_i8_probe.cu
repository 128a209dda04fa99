// Phase-knockout probes (K5) of the int8 form of the Hopper conv kernel:
// conv_sm90.cuh's conv_sm90_kernel<NS, P, F, R> with F an int8 form and
// the phase mask P of a probe, one launch as bnt_conv_sm90_i8 runs it, at
// the instances that the W8A8 stages' chains launch.  The knockouts are
// K5's (conv_sm90_probe.cu): no STAGE (no repack: the operand tile is
// zeroed once, the output that of a zero input), no GEMM (acc = 0), no EPI
// (the raw int32 sums stored: no dequant, bias, activation, affine or
// residual), no STORE (stores only under probe_store()).  This unit holds
// the C entry point and the N 8 codes-in instances (the 51 -> 3 head);
// conv_sm90_i8_probe_64.cu (codes in), _64q.cu (bf16 in) and _80.cu
// (codes in: stage 6's upconv) hold the others, each its own nvcc
// process.

#include "conv_sm90.cuh"

int sm90::launch_probe_s8_8(const ParamsS8& p, int smem, int phases,
                            cudaStream_t s) {
  return launch_masked<8, FORM_S8>(phases, p, smem, s);
}

extern "C" {

// bnt_conv_sm90_i8 with the phase mask `phases` (one of
// sm90::PROBE_MASKS), at the instances above.
int bnt_conv_sm90_i8_probe(const void* x, const void* wpk,
                           const void* dq_scale, const void* dq_bias,
                           const void* in_inv, const void* in_scale,
                           const void* in_shift, const void* out_scale,
                           const void* out_shift, const void* residual,
                           const void* out_inv, void* out, int n, int h,
                           int w, int cin, int cout, int act, int shuffle,
                           int ks, int ns, int phases, void* stream) {
  sm90::ParamsS8 p{};
  const int form = in_inv ? sm90::FORM_S8Q : sm90::FORM_S8;
  const int smem = sm90::prepare(p, x, wpk, nullptr, in_scale, in_shift,
                                 out_scale, out_shift, residual, out_inv,
                                 out, n, h, w, cin, cout, act, shuffle, ks,
                                 ns, form);
  p.dq_scale = static_cast<const float*>(dq_scale);
  p.dq_bias = static_cast<const float*>(dq_bias);
  p.in_inv = static_cast<const float*>(in_inv);
  if (smem < 0 || !dq_scale || !dq_bias ||
      (form == sm90::FORM_S8 && (in_scale || in_shift)))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ns == 64)
    return form == sm90::FORM_S8
               ? sm90::launch_probe_s8_64(p, smem, phases, s)
               : sm90::launch_probe_s8_64q(p, smem, phases, s);
  if (form != sm90::FORM_S8) return cudaErrorInvalidValue;
  return ns == 8 ? sm90::launch_probe_s8_8(p, smem, phases, s)
                 : sm90::launch_probe_s8_80(p, smem, phases, s);
}

}  // extern "C"
