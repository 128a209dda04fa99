// What the two stage-conv kernels share: the tile shape, the epilogue's
// activations, the int8 code store, the PixelShuffle-2 store addressing and
// the persistent launch.  stage_conv.cu is the bf16 kernel (mma.sync
// m16n8k16, fp32 accumulation), stage_conv_i8.cu the W8A8 one (mma.sync
// m16n8k32 s8, int32 accumulation); both are one fused convolution over
// 4x32-pixel output tiles, one output row per warp (the bf16 kernel with
// KS x KS taps, the int8 one 3x3, whose halo tile IN_H x IN_W is below).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int TH = 4;                 // output rows per block, one per warp
constexpr int TW = 32;                // output columns per block: 2 m16 tiles
constexpr int BN = 64;                // max output channels per block
constexpr int NT = BN / 8;
constexpr int THREADS = TH * 32;
constexpr int IN_H = TH + 2;
constexpr int IN_W = TW + 2;
constexpr int IN_PIX = IN_H * IN_W;
constexpr int MAX_CIN_PAD = 128;      // four channels per lane
constexpr int MAX_SMEM = 232448;      // H100 opt-in shared memory per block

enum Act { ACT_NONE = 0, ACT_SIN = 1, ACT_GELU = 2, ACT_OUTIMG = 3 };

// The phases a stage-kernel launch runs (its template parameter P, a
// mask).  The production kernels are PHASE_ALL, which leaves their code
// as it was; the other masks are measurement probes (stage_conv_probe.cu,
// stage_conv_i8_probe.cu; boosting_nerv_torch/tools/probes.py), each
// knocking out one phase with a result that can still be checked:
//   STAGE off: s_in is zeroed once per block and never restaged (acc = 0);
//   GEMM off: acc = 0;
//   EPI off: the raw accumulator is stored (no bias, dequant, activation,
//     affine, residual loads);
//   STORE off: the output is stored only where probe_store() holds, a
//     runtime flag the compiler cannot fold (it never holds).
// Bits 16 and 32 select another staging; each kernel names its own.
enum Phase {
  PHASE_STAGE = 1,
  PHASE_GEMM = 2,
  PHASE_EPI = 4,
  PHASE_STORE = 8,
  PHASE_ALL = 15
};

// The STORE-off probes' flag: 0 and never written, read once per thread
// through a volatile load, so that the compiler keeps the epilogue whose
// stores it guards.  A device variable and not a field of the kernels'
// parameters, whose layout the production instances' code depends on.
__device__ int g_probe_store = 0;

__device__ __forceinline__ bool probe_store() {
  return *static_cast<volatile int*>(&g_probe_store) != 0;
}

// sin with its argument reduced to [-pi, pi] by a two-constant 2*pi
// (6.28125 is exact in 8 bits, so k * 6.28125 is exact for |k| < 2^16),
// then the SFU sine, whose error on [-pi, pi] is below 4e-7.  For
// |v| < 1e4 the result is within ~1e-6 of sin(v): far inside bf16.
__device__ __forceinline__ float sin_reduced(float v) {
  const float k = rintf(v * 0.159154943091895336f);
  float r = fmaf(-k, 6.28125f, v);
  r = fmaf(-k, 1.93530717958647692e-3f, r);
  return __sinf(r);
}

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case ACT_SIN:
      return sin_reduced(v);
    case ACT_GELU:
      return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
    case ACT_OUTIMG:
      return tanhf(v) * 0.5f + 0.5f;
    default:
      return v;
  }
}

// Symmetric int8 code of v at multiplier inv = 127 / bound:
// clip(round_half_even(v * inv), -127, 127); inv = 0 (a dead channel)
// gives code 0.
__device__ __forceinline__ int8_t quant(float v, float inv) {
  const float q = rintf(__fmul_rn(v, inv));
  return static_cast<int8_t>(fminf(fmaxf(q, -127.0f), 127.0f));
}

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Element offset of conv output (b, oy, ox, channel n) in the stored
// tensor: [N, H, W, Cout], or with shuffle the torch PixelShuffle(2) of it,
// [N, 2H, 2W, Cout/4], where channel n = c*4 + r1*2 + r2 lands at fine
// pixel (2*oy + r1, 2*ox + r2), channel c.
__device__ __forceinline__ size_t out_offset(int b, int oy, int ox, int n,
                                             int h, int w, int cout,
                                             int shuffle) {
  if (shuffle) {
    const int c = n >> 2, r1 = (n >> 1) & 1, r2 = n & 1;
    return (((size_t)b * 2 * h + 2 * oy + r1) * 2 * w + 2 * ox + r2) *
               (cout >> 2) + c;
  }
  return (((size_t)b * h + oy) * w + ox) * cout + n;
}

// Output channels per block: Cout in equal chunks of at most BN, each a
// multiple of 8 (73 -> 2 x 40, 204 -> 4 x 56).
inline int chunk_width(int cout) {
  const int chunks = (cout + BN - 1) / BN;
  return ((cout + chunks - 1) / chunks + 7) / 8 * 8;
}

// Persistent launch: as many blocks as fit on the card at once, split
// over the Cout / nw channel chunks (blockIdx.y), each walking the output
// tiles with a stride so that its weights are loaded once.
template <typename P>
int launch_persistent(void (*kernel)(const P), const P& p, int tiles,
                      int chunks, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, smem);
  if (err != cudaSuccess) return err;
  const int blocks = std::max(
      1, std::min(tiles, (sms * std::max(per_sm, 1) + chunks - 1) / chunks));
  kernel<<<dim3(blocks, chunks), THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
