// Phase-knockout and staging probes of the W8A8 stage kernel
// (stage_conv_i8.cuh's stage_conv3x3_i8_kernel<IK, OK, 2, P>): one 3x3
// launch, as bnt_stage_conv3x3_i8 runs it, with the phase mask P of a probe
// (Phase in stage_common.cuh, StagingI8 in stage_conv_i8.cuh).
//
// The Hopper counterparts of the int8 Pallas probes in the repository's
// tools/: no STAGE answers r4_int8_probe.py's b_head_i8_noprolog (the
// int8 dots without the K-buffer build), no GEMM r4_i8_build_probe.py's
// b_head_i8_nodots; STAGE_PACK (four codes per 32-bit shared-memory
// store) is the full-kernel rung of the packed-int8 ladder of
// r4_i8_build_probe.py and r5_pack_*.py, and STAGE_ASYNC (cp.async into
// shared memory, no thread store) asks r4_layout_probe.py's question:
// do operands written by the copy path feed mma.sync faster than operands
// written by thread stores?  The knockouts' outputs are those of
// stage_conv_probe.cu (no GEMM or STAGE: acc = 0; no EPI: the raw int32
// sum stored as bf16, or as codes at out_inv; no STORE: untouched); PACK
// and ASYNC store the production kernel's codes and bf16 bits exactly.
// Instantiated at CK 2 only (cin_pad 64: the 51- and 61-channel int8
// stages of the UVG-1080p decoder) and only for the input/output kinds of
// a codes-in stage chain: a codes-in conv, the bf16-in conv0 with codes
// out, the codes-in conv1 with codes out; ASYNC only for a codes-in conv
// with a bf16 output.

#include "stage_conv_i8.cuh"

namespace {

constexpr int kProbeMasks[] = {
    PHASE_ALL,
    PHASE_ALL & ~PHASE_STAGE,
    PHASE_ALL & ~PHASE_GEMM,
    PHASE_ALL & ~PHASE_EPI,
    PHASE_ALL & ~PHASE_STORE,
    PHASE_ALL | STAGE_PACK,
};

template <int IK, int OK, int P>
int launch_kinds(const ParamsI8& p, int smem, cudaStream_t s) {
  const int tiles = p.tiles_w * p.tiles_h * p.n;
  const int chunks = (p.cout + p.nw - 1) / p.nw;
  return launch_persistent(stage_conv3x3_i8_kernel<IK, OK, 2, P>, p, tiles,
                           chunks, smem, s);
}

template <int P>
int launch_probe(int in_i8, int out_i8, const ParamsI8& p, int smem,
                 cudaStream_t s) {
  if (in_i8 && !out_i8) return launch_kinds<KIND_I8, KIND_BF16, P>(p, smem, s);
  if (!in_i8 && out_i8) return launch_kinds<KIND_BF16, KIND_I8, P>(p, smem, s);
  if (in_i8 && out_i8) return launch_kinds<KIND_I8, KIND_I8, P>(p, smem, s);
  return cudaErrorInvalidValue;
}

template <int I = 0>
int dispatch(int phases, int in_i8, int out_i8, const ParamsI8& p, int smem,
             cudaStream_t s) {
  constexpr int n = sizeof(kProbeMasks) / sizeof(kProbeMasks[0]);
  if constexpr (I == n) {
    if (phases == (PHASE_ALL | STAGE_ASYNC) && in_i8 && !out_i8)
      return launch_kinds<KIND_I8, KIND_BF16, PHASE_ALL | STAGE_ASYNC>(
          p, smem, s);
    return cudaErrorInvalidValue;
  } else {
    return phases == kProbeMasks[I]
               ? launch_probe<kProbeMasks[I]>(in_i8, out_i8, p, smem, s)
               : dispatch<I + 1>(phases, in_i8, out_i8, p, smem, s);
  }
}

}  // namespace

extern "C" {

// Shared memory of one probe launch: the production launch's, and with
// STAGE_PACK of a bf16 input the per-channel affine and multipliers.
int bnt_stage_conv3x3_i8_probe_smem(int cin, int cout, int phases,
                                    int in_i8) {
  const int smem = bnt_stage_conv3x3_i8_smem(cin, cout);
  const bool aff = (phases & STAGE_PACK) && !in_i8;
  return smem < 0 ? -1
                  : smem + (aff ? 3 * MAX_CIN_PAD * (int)sizeof(float) : 0);
}

// One W8A8 3x3 launch with the phase mask `phases` (one of kProbeMasks, or
// PHASE_ALL | STAGE_ASYNC for an int8-code input with a bf16 output), on
// the given stream; the arguments are bnt_stage_conv3x3_i8's.  With
// STAGE_ASYNC, x's channel pitch is cin rounded up to 32 (zero beyond
// cin).  Returns cudaErrorInvalidValue for a mask, kind or shape the
// probe does not take (Cin outside 33..64), else cudaGetLastError() after
// the launch.
int bnt_stage_conv3x3_i8_probe(
    const void* x, const void* w, const void* w_scale, const void* bias,
    const void* in_inv, const void* in_scale, const void* in_shift,
    const void* out_scale, const void* out_shift, const void* residual,
    const void* out_inv, void* out, int n, int h, int w_, int cin, int cout,
    int act, int shuffle, int in_i8, int phases, void* stream) {
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
  const int smem = bnt_stage_conv3x3_i8_probe_smem(cin, cout, phases, in_i8);
  if (smem < 0 || smem > MAX_SMEM || p.cin_pad != 64 ||
      (!in_i8 && in_inv == nullptr) ||
      (shuffle && cout % 4 != 0))
    return cudaErrorInvalidValue;
  return dispatch(phases, in_i8, out_inv != nullptr, p, smem,
                  static_cast<cudaStream_t>(stream));
}

}  // extern "C"
