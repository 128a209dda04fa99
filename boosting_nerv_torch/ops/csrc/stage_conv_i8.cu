// W8A8 fused 3x3 convolution for the HNeRV-Boost decoder tail: int8 codes
// times int8 weights on the tensor cores (mma.sync m16n8k32 s8, int32
// accumulation), dequantised per output channel in the epilogue.
//
// Replaces the W8A8 forms of the two Pallas stage kernels of
// boosting_nerv_tpu/ops/pallas/planar.py: fused_upconv_rsft with
// prepare_upconv_rsft_i8 (:707) and fused_conv_rsft with
// prepare_conv_rsft_i8 (:673), run with i8 / i8_in / out_inv set.  A stage
// is the launch chain of stage_conv.cu with int8 operands:
//
//   upconv : y   = sin(PS2(dq(conv(q_x(x)))))            bf16 y (shuffle)
//   conv   : y   = sin(dq(conv(q_x(x))))                 bf16 y
//   rsft 0 : t   = q_t1(SFT1(gelu(dq(conv(q_t0(SFT0(y)))))))   int8 codes
//   rsft 1 : out = y + dq(conv(t))                       bf16, or int8 codes
//                                                        at the next bound
//   head   : rgb = outimg(dq(conv(q_h(out))))            bf16
//
// q_b(v) = clip(rint(v * inv_b), +-127) with inv_b = 127 / bound_b per
// input channel (0 for a dead channel), and dq(acc) = float(acc) * s_w[n] +
// b[n], where the weights were folded with bound_b / 127 and quantised per
// output channel (ops/kernels/quant.py).  The prologue either copies int8
// codes (the zero-convert chain: the producer already quantised) or reads
// bf16, applies the optional SFT0 affine on in-image taps only and
// quantises; padding is code 0 either way.  The epilogue stores bf16 or
// int8 codes at out_inv.  Every rounding step is the plain version's
// (ops/kernels/planar.py): products, sums and quantisation use _rn
// intrinsics so that nvcc does not contract them into an fma.
//
// What bounds it on an H100: int8 halves the staged and stored bytes of the
// bf16 kernel and the m16n8k32 MMA runs at twice the bf16 rate; by the
// roofline a launch is still bound by operations (~0.1 TOP per 1080p
// launch against ~40 MB of traffic).  In practice, as for the bf16 kernel,
// the per-element staging and epilogue work binds it: channel counts 51
// and 61 are odd, so staging is one byte per lane and channel.  Same tile
// and persistent schedule as stage_conv.cu but three blocks per SM, and
// the same predicated loads
// (a staged element or residual is a select, not a branch, so that all of
// a thread's loads are in flight at once); the shared-memory pitch
// cin_pad + 16 bytes keeps the eight rows of a fragment load in distinct
// banks for every cin_pad that is a multiple of 32.

#include "stage_conv_i8.cuh"

extern "C" {

// Shared memory of one W8A8 launch (bytes), or -1 for a shape the kernel
// does not take (more than MAX_CIN_PAD input channels, or more than the
// card's shared memory).
int bnt_stage_conv3x3_i8_smem(int cin, int cout) {
  const int cin_pad = (cin + 31) / 32 * 32;
  const int stride = cin_pad + 16;
  const int nw = chunk_width(cout);
  const int smem = (IN_PIX + 9 * nw) * stride + 5 * BN * (int)sizeof(float);
  return (cin_pad > MAX_CIN_PAD || smem > MAX_SMEM) ? -1 : smem;
}

// One W8A8 fused 3x3 convolution on the given stream: x is int8 codes
// (in_i8 = 1) or bf16 quantised at in_inv; out is int8 codes at out_inv
// (out_inv not null) or bf16.  Pointers may be null where the comment on
// ParamsI8 allows it.  Returns cudaGetLastError() after the launch (0 on
// success).
int bnt_stage_conv3x3_i8(const void* x, const void* w, const void* w_scale,
                         const void* bias, const void* in_inv,
                         const void* in_scale, const void* in_shift,
                         const void* out_scale, const void* out_shift,
                         const void* residual, const void* out_inv, void* out,
                         int n, int h, int w_, int cin, int cout, int act,
                         int shuffle, int in_i8, void* stream) {
  ParamsI8 p;
  p.x = x;
  p.wgt = static_cast<const int8_t*>(w);
  p.w_scale = static_cast<const float*>(w_scale);
  p.bias = static_cast<const float*>(bias);
  p.in_inv = static_cast<const float*>(in_inv);
  p.in_scale = static_cast<const float*>(in_scale);
  p.in_shift = static_cast<const float*>(in_shift);
  p.out_scale = static_cast<const float*>(out_scale);
  p.out_shift = static_cast<const float*>(out_shift);
  p.residual = static_cast<const __nv_bfloat16*>(residual);
  p.out_inv = static_cast<const float*>(out_inv);
  p.out = out;
  p.n = n;
  p.h = h;
  p.w = w_;
  p.cin = cin;
  p.cout = cout;
  p.act = act;
  p.shuffle = shuffle;
  p.nw = chunk_width(cout);
  p.cin_pad = (cin + 31) / 32 * 32;
  p.stride = p.cin_pad + 16;
  p.tiles_w = (w_ + TW - 1) / TW;
  p.tiles_h = (h + TH - 1) / TH;
  const int smem = bnt_stage_conv3x3_i8_smem(cin, cout);
  if (smem < 0 || (!in_i8 && in_inv == nullptr) ||
      (shuffle && cout % 4 != 0))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_i8) {
    return out_inv ? launch_i8<KIND_I8, KIND_I8>(p, smem, s)
                   : launch_i8<KIND_I8, KIND_BF16>(p, smem, s);
  }
  return out_inv ? launch_i8<KIND_BF16, KIND_I8>(p, smem, s)
                 : launch_i8<KIND_BF16, KIND_BF16>(p, smem, s);
}

}  // extern "C"
