// The int8 form of the Hopper conv kernel (conv_sm90.cuh with F =
// FORM_S8 or FORM_S8Q): a same-padded KS x KS convolution of int8 codes
// with int8 OHWI weight codes on the tensor cores (wgmma m64nNk32 s8,
// int32 accumulation), dequantised per output channel, with the fused
// prologue and epilogue of the bf16 form (conv_sm90.cu):
//
//   prologue: the input's int8 codes copied (FORM_S8, the zero-convert
//             chain), or a bf16 input's x * (in_scale + 1) + in_shift
//             quantised at in_inv, clip(rint(v * in_inv), +-127)
//             (FORM_S8Q); padding and channels beyond Cin are code 0;
//   epilogue: float(sum) * dq_scale + dq_bias; act none / sin / gelu /
//             outimg; * (out_scale + 1) + out_shift; + residual; a bf16
//             store, or int8 codes at out_inv; PixelShuffle(2) folded into
//             the store addressing.
//
// Every rounding step is the plain version's (ops/kernels/planar.py,
// quant.py): products and sums of the quantisation, the dequantisation,
// the output affine and the residual are _rn intrinsics that nvcc does not
// contract into a fused multiply-add, and an int32 sum converts to the
// nearest float as the plain version's exact sum does, so that the int8
// codes match the plain version's except where an activation's last bit
// differs at a rounding tie.
//
// It replaces the W8A8 forms of the two Pallas stage kernels of
// boosting_nerv_tpu/ops/pallas/planar.py: fused_upconv_rsft (:1308) with
// prepare_upconv_rsft_i8 (:707) and fused_conv_rsft (:1541) with
// prepare_conv_rsft_i8 (:673), run with i8 / i8_in / out_inv; through the
// chains of ops/kernels/conv_sm90.py (conv_sm90.upconv_rsft / conv_rsft
// on StageWeightsI8): the stage conv (codes or bf16 in, sin, shuffle,
// bf16 y), the ResBlockSFT's conv0 (bf16 y in with SFT0, quantised; gelu,
// SFT1, int8 codes t out), conv1 (codes t in, + y, bf16 or int8 codes
// out) and the head (codes in, outimg).  The W8A8 stage kernel
// (stage_conv_i8.cu, mma.sync m16n8k32) stays built for the K2 probes and
// the same-call A/B, and serves no wrapper.
//
// What bounds it on an H100 SXM (1979 TOP/s int8, 3.35 TB/s): at the
// bench config's W8A8 stages (540x960x61, 61 -> 204 shuffled to
// 1080x1920x51, 1080x1920x51 + the head) the operations, 0.05-0.1 ms a
// launch.  int8 halves the bf16 form's operand bytes, its K steps (61 and
// 51 channels pad to 64, two k32 steps) and its staged bytes, and doubles
// its tensor-core rate; the design is the bf16 form's (conv_sm90.cu):
// TMA row copies by a producer warp into an mbarrier-ordered raw buffer,
// a repack into the [16-byte channel group][pixel][16] operand tile, whose
// core matrices and descriptors are the bf16 form's byte for byte, wgmma
// with both operands in shared memory, weight blocks resident where they
// fit (stage 6's 61 -> 204 upconv at N 80: 138 KB, resident where bf16's
// 276 KB streamed), and the staged, non-inlined epilogue with one more
// multiply an element.  What int8 frees is spent on taller tiles: the N 64
// launches (51 and 61 channels) take 3 output rows a warpgroup (6 x 64
// tiles), which cuts the halo's share of the repack from 3/2 to 4/3 of
// the rows; on an H100 they measured 5-9% faster than 2 rows, and as
// fast as 4 rows at stage 6 (4% slower at stage 5), whose 128
// accumulators a thread spilled at the 168 registers that a 288-thread
// block leaves.  Codes are repacked four a
// lane from two aligned 32-bit loads of the raw row and one 32-bit store.
//
// This unit holds the C entry points and the N 8 instances (the 51 -> 3
// head); conv_sm90_i8_64.cu (N 64, at 3 rows a warpgroup) and
// conv_sm90_i8_80.cu hold the others, each its own nvcc process.

#include "conv_sm90.cuh"

int sm90::launch_s8_8(const ParamsS8& p, int smem, int f, cudaStream_t s) {
  return launch_s8<8>(p, smem, f, s);
}

extern "C" {

// Shared memory of one int8 launch (bytes) of form `form` (1: int8 codes
// in, 2: bf16 in) with N slices of ns channels, or -1 for a shape the
// kernel does not take: ks not in {1, 3, 5}, more than MAX_CIN_PAD input
// channels, an ns without an instance, or no plan that fits the card's
// shared memory.
int bnt_conv_sm90_i8_smem(int cin, int cout, int ks, int ns, int form) {
  sm90::ParamsS8 p{};
  if ((form != sm90::FORM_S8 && form != sm90::FORM_S8Q) ||
      !sm90::shape(p, cin, cout, ks, ns, form))
    return -1;
  return sm90::fit(p, ns, form);
}

// One int8 ks x ks convolution on the given stream: x is int8 codes, or
// bf16 quantised at in_inv (in_inv not null); wpk the int8 weight codes
// packed for ns-channel slices (conv_sm90.py::pack_weight); dq_scale and
// dq_bias float32 [Cout]; out int8 codes at out_inv (not null) or bf16.
// Other pointers may be null where the comment on sm90::Params allows it
// (in_scale / in_shift only with a bf16 x).  Returns cudaGetLastError()
// after the launch (0 on success).
int bnt_conv_sm90_i8(const void* x, const void* wpk, const void* dq_scale,
                     const void* dq_bias, const void* in_inv,
                     const void* in_scale, const void* in_shift,
                     const void* out_scale, const void* out_shift,
                     const void* residual, const void* out_inv, void* out,
                     int n, int h, int w, int cin, int cout, int act,
                     int shuffle, int ks, int ns, void* stream) {
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
  switch (ns) {
    case 8: return sm90::launch_s8_8(p, smem, form, s);
    case 64: return sm90::launch_s8_64(p, smem, form, s);
    default: return sm90::launch_s8_80(p, smem, form, s);
  }
}

}  // extern "C"
