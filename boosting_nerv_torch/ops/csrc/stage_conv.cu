// Fused 3x3 convolution (a KS x KS kernel built at KS = 3) for the
// HNeRV-Boost decoder tail, NHWC bf16 in and out, fp32 accumulation on the
// tensor cores (mma.sync m16n8k16).
//
// Replaces the two Pallas stage kernels of boosting_nerv_tpu/ops/pallas/
// planar.py: fused_upconv_rsft (stride-2 stage) and fused_conv_rsft
// (stride-1 stage, optional 3x3 RGB head).  A stage is a chain of launches
// of this one kernel, each with a fused prologue and epilogue:
//
//   upconv : y   = sin(PixelShuffle2(conv(x) + b))       shuffle=1, act=sin
//   conv   : y   = sin(conv(x) + b)                      act=sin
//   rsft 0 : t   = SFT1(gelu(conv(SFT0(y)) + b0))        in/out affine, gelu
//   rsft 1 : out = y + conv(t) + b1                      residual
//   head   : rgb = tanh(conv(out) + bh) * 0.5 + 0.5      act=outimg
//
// with SFTi(v) = v * (scale_i + 1) + shift_i per channel.  The input affine
// is applied only to taps inside the image: the reference pads after the
// affine (models/blocks.py ResBlockSFT), so zero padding stays exactly 0.
// With out_inv the launch stores int8 codes clip(rint(v * out_inv), +-127)
// instead of bf16: the zero-convert chain of the W8A8 decode, where a bf16
// stage hands its output to an int8 stage (planar.py:1297-1301).
//
// The tap count KS is a template parameter, built at KS = 3 only (the
// fine-grid tile wrappers that took KS = 1 and 5 launch conv_sm90.cu).
// Its instances replace the v1 decode's channels-major kernels
// (ops/pallas/conv_chw.py's conv3x3_act_chw and head_conv_chw,
// fused_sft.py's resblock_sft_chw, whose input_sin is the template
// parameter S: stage_conv_sin.cu) and the standalone planar conv_planar
// and rsft_planar (ops/kernels/conv_chw.py, fused_sft.py, planar.py); the
// stage and tile wrappers it served before moved to conv_sm90.cu, and
// their old chains stay callable through planar.launch_conv and
// planar.rsft_cuda for chip_smoke.py's same-call A/B and the K1 probes.
//
// What bounds it on an H100: the 1080p stage-7 tensors are
// 1080*1920*51*2 B = 211 MB each and the tail costs about 0.9 TFLOP of
// convolutions per frame, so by the roofline a launch is bound by the
// tensor cores (~0.1 ms of HBM traffic against ~100 GFLOP).  In practice
// the per-element work around the GEMM binds it: staging the input tile
// (channel counts such as 51 and 61 are odd, so loads are 2-byte), the
// activation, and the stores.  This version runs persistent blocks (two
// per SM at the 1080p-zone widths, so that one block's loads overlap the
// other's GEMM), each loading its slice of up to 64 output channels of the
// weights once and walking 4x32 output tiles; per tile it stages the halo'd
// input (prologue applied) in shared memory and runs the implicit GEMM
// (M = 32 pixels per warp, N <= 64, K = KS * KS * Cin) with mma.sync.
// Intermediates go through device memory in bf16; fusing a stage into one
// launch, TMA and wgmma are later work.

#include "stage_conv.cuh"

namespace {

// Shared memory of one launch at nw output channels per block.
int smem_bytes(int ks, int cin_pad, int nw) {
  const int pix = (TH + ks - 1) * (TW + ks - 1);
  return (pix + ks * ks * nw) * (cin_pad + 8) * (int)sizeof(__nv_bfloat16) +
         4 * BN * (int)sizeof(float);
}

// Output channels per block: chunk_width(cout), shrunk in whole chunks
// until the tile and the KS * KS * nw weight rows fit the card's shared
// memory; -1 where no multiple of 8 fits.  At KS = 3 every Cin <=
// MAX_CIN_PAD fits the first width, so the stage kernels keep their
// chunks.
int tap_chunk_width(int ks, int cin_pad, int cout) {
  for (int chunks = (cout + BN - 1) / BN;; ++chunks) {
    const int nw = ((cout + chunks - 1) / chunks + 7) / 8 * 8;
    if (smem_bytes(ks, cin_pad, nw) <= MAX_SMEM) return nw;
    if (nw == 8) return -1;
  }
}

}  // namespace

extern "C" {

// Shared memory of one launch (bytes), or -1 for a shape the kernel does
// not take: ks other than 3, more than MAX_CIN_PAD input channels, or no
// channel chunk that fits the card's shared memory.
int bnt_stage_conv_smem(int cin, int cout, int ks) {
  const int cin_pad = (cin + 15) / 16 * 16;
  if (ks != 3 || cin_pad > MAX_CIN_PAD) return -1;
  const int nw = tap_chunk_width(ks, cin_pad, cout);
  return nw < 0 ? -1 : smem_bytes(ks, cin_pad, nw);
}

// One fused ks x ks convolution on the given stream, ks = 3.  Pointers may
// be null where the comment on Params allows it; sin_mode (bnt::Sin: 1 the
// staged input, 2 the residual) only with a bf16 store.  Returns
// cudaGetLastError() after the launch (0 on success).
int bnt_stage_conv(const void* x, const void* w, const void* bias,
                   const void* in_scale, const void* in_shift,
                   const void* out_scale, const void* out_shift,
                   const void* residual, const void* out_inv, void* out,
                   int n, int h, int w_, int cin, int cout, int act,
                   int shuffle, int ks, int sin_mode, void* stream) {
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.wgt = static_cast<const __nv_bfloat16*>(w);
  p.bias = static_cast<const __nv_bfloat16*>(bias);
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
  p.cin_pad = (cin + 15) / 16 * 16;
  p.stride = p.cin_pad + 8;
  p.tiles_w = (w_ + TW - 1) / TW;
  p.tiles_h = (h + TH - 1) / TH;
  const int smem = bnt_stage_conv_smem(cin, cout, ks);
  if (smem < 0 || (shuffle && cout % 4 != 0) ||
      sin_mode < bnt::SIN_NONE || sin_mode > bnt::SIN_RESIDUAL ||
      (sin_mode != bnt::SIN_NONE && out_inv))
    return cudaErrorInvalidValue;
  p.nw = tap_chunk_width(ks, p.cin_pad, cout);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sin_mode != bnt::SIN_NONE)
    return bnt::launch_sin(sin_mode, p, smem, s);
  return out_inv ? launch<3, true>(p, smem, s) : launch<3, false>(p, smem, s);
}

const char* bnt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
