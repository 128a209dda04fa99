// The sin instances of the bf16 Hopper conv kernel (conv_sm90.cuh, modes
// MODE_SIN_INPUT and MODE_SIN_RESIDUAL at N 8, 56, 64 and 80), compiled
// beside conv_sm90.cu's, whose instances keep their code: the two launches
// of the ResBlockSFT whose block input is sin(x), the v1 decode's switch
// stage (ops/kernels/fused_sft.py::resblock_sft_chw with input_sin, the
// port of boosting_nerv_tpu/ops/pallas/fused_sft.py:138, which fuses the
// preceding sinusoidal activation into its prologue, :112-115).  conv0
// stages sin(x) * (scale0 + 1) + shift0 on in-image taps (zero padding
// after the affine, as the Pallas kernel's :117-120); conv1 adds sin(x) as
// its residual (:134).  So neither launch writes sin(x) to device memory:
// a separate sin pass would write and read 211 MB more at 1080x1920x51.
// The sine is the reduced SFU sine of the epilogue's ACT_SIN
// (stage_common.cuh::sin_reduced), within ~1e-6 of sin for |x| < 1e4.
//
// What bounds the pair, and the design, are conv_sm90.cu's: at 1080x1920x51
// (N 56, every weight block resident, two warpgroups) each launch's 9 x 51
// x 51 multiply-adds a pixel take 0.098 ms of the tensor cores at 989
// TFLOP/s, its 423 MB of HBM traffic 0.126 ms at 3.35 TB/s.  The sine adds
// one SFU sine and three FMAs per staged element (conv0's repack, 1.3 per
// output element with the halo) or per residual element (conv1's
// epilogue).  The modes take one slice group a launch (no SPLIT instance):
// the v1 calls are 1080-row grids, which fill the card (sm90::groups gives
// G 1 there too).

#include "conv_sm90.cuh"

namespace {

// The launch of p at N slice NS in mode m, or with `info` its plan alone.
template <int NS>
int run(const sm90::Params& p, int smem, int m, cudaStream_t s, int* info) {
  constexpr int A = PHASE_ALL, BF = sm90::FORM_BF16, R = sm90::ROWS_PER_WG;
  if (m == sm90::MODE_SIN_INPUT)
    return info ? sm90::mode_plan<NS, sm90::MODE_SIN_INPUT>(p, smem, info)
                : sm90::launch<NS, A, BF, R, false, sm90::MODE_SIN_INPUT>(
                      p, smem, s);
  return info ? sm90::mode_plan<NS, sm90::MODE_SIN_RESIDUAL>(p, smem, info)
              : sm90::launch<NS, A, BF, R, false, sm90::MODE_SIN_RESIDUAL>(
                    p, smem, s);
}

}  // namespace

extern "C" {

// One fused ks x ks convolution as bnt_conv_sm90 (conv_sm90.cu) computes
// it, bf16 out, no shuffle, in sin mode `sin`: 1 (MODE_SIN_INPUT) stages
// sin(x) before the input affine, 2 (MODE_SIN_RESIDUAL) adds
// sin(residual), which must not be null.  The shared-memory plan is
// bnt_conv_sm90_smem's (the modes' layout is the same).  With `info` not
// null nothing is launched: info = {tiles, N slices, SMs, blocks an SM}
// and the slice groups (1) are returned, -1 for a launch the kernel does
// not take.  Else returns cudaGetLastError() after the launch (0 on
// success).
int bnt_conv_sm90_sin(const void* x, const void* wpk, const void* bias,
                      const void* in_scale, const void* in_shift,
                      const void* out_scale, const void* out_shift,
                      const void* residual, void* out, int n, int h, int w,
                      int cin, int cout, int act, int ks, int ns, int sin,
                      int* info, void* stream) {
  sm90::Params p{};
  const int smem = sm90::prepare(
      p, x, wpk, bias, in_scale, in_shift, out_scale, out_shift, residual,
      nullptr, out, n, h, w, cin, cout, act, 0, ks, ns, sm90::FORM_BF16, 2,
      sin);
  if (smem < 0 ||
      (sin != sm90::MODE_SIN_INPUT && sin != sm90::MODE_SIN_RESIDUAL) ||
      (sin == sm90::MODE_SIN_RESIDUAL && !residual && !info))
    return info ? -1 : cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ns) {
    case 8: return run<8>(p, smem, sin, s, info);
    case 56: return run<56>(p, smem, sin, s, info);
    case 64: return run<64>(p, smem, sin, s, info);
    default: return run<80>(p, smem, sin, s, info);
  }
}

}  // extern "C"
