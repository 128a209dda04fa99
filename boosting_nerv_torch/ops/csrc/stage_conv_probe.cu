// Phase-knockout probes of the bf16 stage kernel (stage_conv.cuh's
// stage_conv_kernel<3, CK, false, SIN_NONE, P>): one 3x3 launch, as
// bnt_stage_conv runs it, with the phase mask P of a probe (Phase in
// stage_common.cuh, bnt::Staging in stage_conv.cuh).
//
// These are the Hopper counterparts of the Pallas measurement kernels in
// the repository's tools/ (r3_prologue_probe.py's nodots / noprolog,
// planar_diag.py's dots-only / +DMA / +K-buffer build, r3_v6_probe.py's
// conv without the K-buffer build, rsft_planar_bisect.py's variants):
// the TPU probes split a stage kernel's time by removing a phase, and so
// do these, on the kernel the port serves.  Mosaic's tactics (K-buffers,
// lane rolls, VMEM slots) have no counterpart here.  Each knockout's
// output is deterministic, so that it is checked as well as timed
// (boosting_nerv_torch/ops/kernels/probes.py holds the plain versions):
//   PHASE_ALL          the production kernel's code, bitwise its output;
//   no STAGE           s_in zeroed once: the output of a zero staged tile;
//   no GEMM            acc = 0: the output of zero weights;
//   no EPI             bf16 of the raw accumulator: a bias-free conv;
//   no STORE           stores only under probe_store(): output untouched;
//   STAGE_DIRECT       A fragments from device memory per tap, no s_in
//                      (launches without prologue): bitwise PHASE_ALL's;
//   STAGE_UNMASKED     the input affine on padding taps too.
// Only KS = 3, a bf16 store and no sine, at CK 2 and 3 (cin_pad 64 and
// 96: the 51/61 and 73/88-channel stages of the UVG-1080p decoder), are
// instantiated, to keep the build short.  What bounds the kernel is as
// stage_conv.cu says; the probes measure how much of it each phase takes.

#include "stage_conv.cuh"

namespace {

constexpr int kProbeMasks[] = {
    PHASE_ALL,
    PHASE_ALL & ~PHASE_STAGE,
    PHASE_ALL & ~PHASE_GEMM,
    PHASE_ALL & ~PHASE_EPI,
    PHASE_ALL & ~PHASE_STORE,
    PHASE_ALL | bnt::STAGE_DIRECT,
    PHASE_ALL | bnt::STAGE_UNMASKED,
};

template <int CK, int P>
int launch_ck(const Params& p, int smem, cudaStream_t s) {
  const int tiles = p.tiles_w * p.tiles_h * p.n;
  const int chunks = (p.cout + p.nw - 1) / p.nw;
  return launch_persistent(stage_conv_kernel<3, CK, false, bnt::SIN_NONE, P>,
                           p, tiles, chunks, smem, s);
}

template <int P>
int launch_probe(const Params& p, int smem, cudaStream_t s) {
  switch ((p.cin_pad + 31) / 32) {
    case 2: return launch_ck<2, P>(p, smem, s);
    case 3: return launch_ck<3, P>(p, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int I = 0>
int dispatch(int phases, const Params& p, int smem, cudaStream_t s) {
  constexpr int n = sizeof(kProbeMasks) / sizeof(kProbeMasks[0]);
  if constexpr (I == n) {
    return cudaErrorInvalidValue;
  } else {
    return phases == kProbeMasks[I] ? launch_probe<kProbeMasks[I]>(p, smem, s)
                                    : dispatch<I + 1>(phases, p, smem, s);
  }
}

}  // namespace

extern "C" {

// One 3x3 launch of the bf16 stage kernel with the phase mask `phases`
// (one of kProbeMasks), a bf16 store, on the given stream; the arguments
// are bnt_stage_conv's (no int8 store, no sine).  Returns
// cudaErrorInvalidValue for a mask or shape the probe does not take (Cin
// outside 33..96, DIRECT with an input affine), else cudaGetLastError()
// after the launch.
int bnt_stage_conv_probe(const void* x, const void* w, const void* bias,
                         const void* in_scale, const void* in_shift,
                         const void* out_scale, const void* out_shift,
                         const void* residual, void* out, int n, int h,
                         int w_, int cin, int cout, int act, int shuffle,
                         int phases, void* stream) {
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.wgt = static_cast<const __nv_bfloat16*>(w);
  p.bias = static_cast<const __nv_bfloat16*>(bias);
  p.in_scale = static_cast<const float*>(in_scale);
  p.in_shift = static_cast<const float*>(in_shift);
  p.out_scale = static_cast<const float*>(out_scale);
  p.out_shift = static_cast<const float*>(out_shift);
  p.residual = static_cast<const __nv_bfloat16*>(residual);
  p.out_inv = nullptr;
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
  p.nw = chunk_width(cout);
  const int smem = bnt_stage_conv_smem(cin, cout, 3);
  if (smem < 0 || (shuffle && cout % 4 != 0) ||
      ((phases & bnt::STAGE_DIRECT) && in_scale != nullptr))
    return cudaErrorInvalidValue;
  return dispatch(phases, p, smem, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
