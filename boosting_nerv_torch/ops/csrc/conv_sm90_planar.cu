// The planar instances of the bf16 Hopper conv kernel (conv_sm90.cuh,
// modes MODE_PLANAR_IN, MODE_PLANAR_OUT and MODE_PLANAR_IO at N 8, 56, 64
// and 80), compiled beside conv_sm90.cu's, whose instances keep their
// code: the two launches of the planar ResBlockSFT
// (ops/kernels/planar.py::rsft_planar, the port of
// boosting_nerv_tpu/ops/pallas/planar.py:484) and the one launch of the
// planar conv (planar.py::conv_planar, the port of planar.py:398), whose
// inputs and outputs are planar tensors (4 Cp, Hc, Wd) holding a fine (C,
// 2 hc, 2 wc) one: planar[(2 r1 + r2) Cp + c, y, x] = fine[c, 2 y + r1,
// 2 x + r2].
//
// conv0 (MODE_PLANAR_IN) reads the planar input itself: per tile one TMA
// tensor copy of a 4-D box (planar columns x rows x channels x planes,
// PBX x planar_rows(nwg) x C x 4; 78 KB at C 51) through a tensor map
// whose extent is the real region hc x wc, so that the copy's zero fill is
// the conv's zero padding there; the consumers' repack reads
// [plane][c][y][x] and writes the operand tile's [8-channel group][pixel]
// [8] (conv_sm90.cuh::repack_planar), with the SFT0 affine on in-image
// taps.  Its output t, SFT1(gelu(conv0 + b0)), is fine NHWC.  conv1
// (MODE_PLANAR_OUT) stages t as every NHWC launch does, stages its sums
// transposed ([channel][pixel]) and adds the residual read from the planar
// input and stores into the planar output, a warp's lanes along the
// pixels of one channel (conv_sm90.cuh::epilogue_planar).  The planar
// output's pad channels, rows and columns are the caller's (a copy of the
// input).  Without these modes the wrapper cropped the real region to a
// contiguous NHWC copy and wrote the result back through a strided 5-D
// permute, ~2.6 ms of torch layout work at 540 x 960 planar, C 51, beside
// the two convs.
//
// The planar conv act(conv3x3(x) + b) (MODE_PLANAR_IO) is both in one
// launch: the input staged as conv0's (the tensor map of the input's cp
// planes, no input affine), the sums staged transposed and stored as
// conv1's into a planar output of cpo channels a plane, with the
// activation (none, sin, gelu, outimg: compile-time, one copy of the
// epilogue each) after the bias and no residual.  The wrapper fills the
// output with act(0) first (its pad channels, rows and columns, 0.5 for
// outimg); the launch writes the image's elements only.  It replaces the
// stage kernel (stage_conv.cu) between a torch crop and a planar write.
// Its bound at the planar phase's 51 -> 51 call (540 x 960 planar, Cp 64,
// Wd 1024): the real region read and the whole planar output written,
// 0.148 ms of HBM at 3.35 TB/s (9 x 51 x 51 multiply-adds a fine pixel
// take 0.098 ms of the tensor cores).
//
// What bounds the pair is conv_sm90.cu's 1080x1920x51 ResBlockSFT: the
// input's real region read and the planar output written once, 0.196 ms
// of HBM at 3.35 TB/s, and 2 x 9 x 51 x 51 multiply-adds a fine pixel,
// 0.196 ms of the tensor cores at 989 TFLOP/s.  The modes take one slice
// group a launch (no SPLIT instance).
//
// The tensor map is encoded per launch on the host by the driver's
// cuTensorMapEncodeTiled, reached through the runtime's driver entry
// point (no link against the driver library), and passed in the kernel's
// __grid_constant__ parameters.

#include "conv_sm90.cuh"

namespace {

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, or null where the driver has none.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// The tensor map of a MODE_PLANAR_IN launch: the planar input's real
// region, dims (x < w / 2, y < h / 2, channel < cin, plane < 4) over the
// strides of a (4 cp, hc, wd) bf16 tensor, boxes of PBX x
// planar_rows(nwg) x cin x 4, zero outside.
bool planar_map(sm90::ParamsPlanar& p) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[4] = {cuuint64_t(p.w / 2), cuuint64_t(p.h / 2),
                              cuuint64_t(p.cin), 4};
  const cuuint64_t row = cuuint64_t(p.wd) * 2;
  const cuuint64_t strides[3] = {row, row * p.hc, row * p.hc * p.cp};
  const cuuint32_t box[4] = {sm90::PBX, cuuint32_t(sm90::planar_rows(p.nwg)),
                             cuuint32_t(p.cin), 4};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(&p.tmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<__nv_bfloat16*>(p.x), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The launch of p at N slice NS in mode m, or with `info` its plan alone.
template <int NS>
int run(const sm90::ParamsPlanarIO& p, int smem, int m, cudaStream_t s,
        int* info) {
  constexpr int A = PHASE_ALL, BF = sm90::FORM_BF16, R = sm90::ROWS_PER_WG;
  constexpr int M_IN = sm90::MODE_PLANAR_IN, M_OUT = sm90::MODE_PLANAR_OUT,
                M_IO = sm90::MODE_PLANAR_IO;
  if (m == M_IN)
    return info ? sm90::mode_plan<NS, M_IN>(p, smem, info)
                : sm90::launch<NS, A, BF, R, false, M_IN>(p, smem, s);
  if (m == M_IO)
    return info ? sm90::mode_plan<NS, M_IO>(p, smem, info)
                : sm90::launch<NS, A, BF, R, false, M_IO>(p, smem, s);
  return info ? sm90::mode_plan<NS, M_OUT>(p, smem, info)
              : sm90::launch<NS, A, BF, R, false, M_OUT>(p, smem, s);
}

// Fills p for a planar launch in mode m (see bnt_conv_sm90_planar): the
// shared-memory bytes, or -1 for a launch the kernel does not take.
int prepare_planar(sm90::ParamsPlanarIO& p, const void* x, const void* wpk,
                   const void* bias, const void* in_scale,
                   const void* in_shift, const void* out_scale,
                   const void* out_shift, const void* residual, void* out,
                   int h, int w, int cin, int cout, int act, int ns, int m,
                   int cp, int cpo, int hc, int wd) {
  const int smem = sm90::prepare(p, x, wpk, bias, in_scale, in_shift,
                                 out_scale, out_shift, residual, nullptr,
                                 out, 1, h, w, cin, cout, act, 0, 3, ns,
                                 sm90::FORM_BF16, 2, m);
  p.cp = cp;
  p.hc = hc;
  p.wd = wd;
  p.cpo = cpo;
  const int planes = m == sm90::MODE_PLANAR_IN ? cin : cout;
  const int held = m == sm90::MODE_PLANAR_IO ? cpo : cp;
  if (smem < 0 || !sm90::planar_mode(m) || planes > held ||
      (m == sm90::MODE_PLANAR_IO && cin > cp) || h / 2 > hc || w / 2 > wd ||
      wd % 8 != 0 ||
      (sm90::planar_out(m) && (out_scale || out_shift)) ||
      (m == sm90::MODE_PLANAR_OUT && act != ACT_NONE) ||
      (m == sm90::MODE_PLANAR_IO && residual))
    return -1;
  return smem;
}

}  // namespace

extern "C" {

// Shared memory of one planar launch (bytes) in mode `mode` (3:
// MODE_PLANAR_IN, 4: MODE_PLANAR_OUT, 5: MODE_PLANAR_IO), 3 x 3, with N
// slices of ns channels, or -1 for a shape the kernel does not take (as
// bnt_conv_sm90_smem, and the planar box's raw buffer in MODE_PLANAR_IN,
// the transposed staging in MODE_PLANAR_OUT, both in MODE_PLANAR_IO).
int bnt_conv_sm90_planar_smem(int cin, int cout, int ns, int mode) {
  sm90::Params p{};
  if (!sm90::planar_mode(mode) || !sm90::shape(p, cin, cout, 3, ns))
    return -1;
  return sm90::fit(p, ns, sm90::FORM_BF16, 2, mode);
}

// One fused 3 x 3 convolution of a fine h x w image (h, w even) in planar
// mode `mode`:
//   3 (MODE_PLANAR_IN): x is a planar (4 cp, hc, wd) bf16 tensor whose
//     first h / 2 rows and w / 2 columns hold the image (cin channels a
//     plane); out is NHWC [1, h, w, cout] (residual, if not null, too);
//   4 (MODE_PLANAR_OUT): x is NHWC [1, h, w, cin]; residual (or null) and
//     out are planar (4 cp, hc, wd) tensors (cout channels a plane), out's
//     elements outside the image's are not written; bias and residual
//     only (act none, no output affine);
//   5 (MODE_PLANAR_IO): x is planar (4 cp, hc, wd) as in 3, out planar
//     (4 cpo, hc, wd) as in 4 (cout channels a plane, the elements outside
//     the image's not written); bias and act only (no residual, no output
//     affine).
// cpo is read in mode 5 only.  The epilogue is otherwise bnt_conv_sm90's
// (bias, act, output affine, residual), bf16 out.  With `info` not null
// nothing is launched: info = {tiles, N slices, SMs, blocks an SM} and the
// slice groups (1) are returned, -1 for a launch the kernel does not take.
// Else returns cudaGetLastError() after the launch (0 on success),
// cudaErrorInvalidValue for a launch it does not take or a tensor map the
// driver refuses.
int bnt_conv_sm90_planar(const void* x, const void* wpk, const void* bias,
                         const void* in_scale, const void* in_shift,
                         const void* out_scale, const void* out_shift,
                         const void* residual, void* out, int h, int w,
                         int cin, int cout, int act, int ns, int mode,
                         int cp, int cpo, int hc, int wd, int* info,
                         void* stream) {
  sm90::ParamsPlanarIO p{};
  const int smem =
      prepare_planar(p, x, wpk, bias, in_scale, in_shift, out_scale,
                     out_shift, residual, out, h, w, cin, cout, act, ns,
                     mode, cp, cpo, hc, wd);
  if (smem < 0) return info ? -1 : cudaErrorInvalidValue;
  if (!info && sm90::planar_in(mode) && !planar_map(p))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ns) {
    case 8: return run<8>(p, smem, mode, s, info);
    case 56: return run<56>(p, smem, mode, s, info);
    case 64: return run<64>(p, smem, mode, s, info);
    default: return run<80>(p, smem, mode, s, info);
  }
}

}  // extern "C"
