// Staging alone: phase 2 of the stage kernels, the halo'd NHWC input tile
// of each 4 x 32 output tile staged into shared memory, with no GEMM and
// no epilogue.  The same persistent walk over the tiles as the stage
// kernels, at the shared memory (so the occupancy) the caller gives, which
// is the production launch's in the probes.  With `out` it writes each
// staged tile to device memory (to be checked); without, it folds one word
// of each staged tile into a checksum, so that it measures the staging
// alone.
//
// The Hopper counterpart of the K-buffer build probes in the repository's
// tools/ (r4_int8_probe.py's kbuf_i8_build, r4_i8_build_probe.py's four
// build strategies, r4_roll_i16_probe.py's 16-bit roll, the micro rungs of
// the r5_pack_*.py ladder), and where PERF.md's "staging loads one element
// per lane and channel" gets its number.  Modes:
//   BUILD_F32      the bf16 kernel's stage_tile (bf16 -> f32, affine on
//                  in-image taps, -> bf16): production;
//   BUILD_RAW16    16-bit copies with no float round trip, two channels a
//                  32-bit load where the pair is 4-byte aligned (no
//                  affine: it moves the data only);
//   BUILD_I8       the int8 kernel's stage_tile_i8 of a bf16 input
//                  (affine, quantise, one byte store per code);
//   BUILD_I8_PACK  stage_tile_i8_pack: four codes per 32-bit store.
// F32 and RAW16 stage the same bits; I8 and I8_PACK the same codes.

#include <type_traits>

#include "stage_conv.cuh"
#include "stage_conv_i8.cuh"

namespace {

enum BuildMode { BUILD_F32 = 0, BUILD_RAW16 = 1, BUILD_I8 = 2,
                 BUILD_I8_PACK = 3 };

struct BuildParams {
  const __nv_bfloat16* x;   // [N, H, W, Cin]
  const float* in_scale;    // [Cin] or null
  const float* in_shift;    // [Cin] or null
  const float* in_inv;      // [Cin]: int8 modes
  void* out;                // [tiles, IN_PIX, cin_pad] or null
  unsigned* sink;           // [1]: checksum without out
  int n, h, w, cin;
  int cin_pad;              // round16 (bf16 modes) or round32 (int8)
  int stride;               // s_in pitch (elements)
  int tiles_w, tiles_h;
};

// BUILD_RAW16: channel pair 2q, 2q + 1 for q = lane + 32k, one 32-bit load
// where the pair is 4-byte aligned in device memory and wholly below Cin,
// else two 16-bit loads; one 32-bit store.
template <int KP>
__device__ __forceinline__ void stage_tile_raw16(
    __nv_bfloat16* s_in, const __nv_bfloat16* xb, int h, int w, int cin,
    int cin_pad, int stride, int ty0, int tx0, int warp, int lane) {
  constexpr int U = 4;
  for (int p0 = warp; p0 < IN_PIX; p0 += TH * U) {
    uint32_t v[U][KP];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int pix = p0 + u * TH;
      const int iy = ty0 - 1 + pix / IN_W;
      const int ix = tx0 - 1 + pix % IN_W;
      const bool inside = pix < IN_PIX && iy >= 0 && iy < h && ix >= 0 &&
                          ix < w;
      const __nv_bfloat16* src = xb + ((size_t)iy * w + ix) * cin;
      const bool aligned = (reinterpret_cast<uintptr_t>(src) & 3) == 0;
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        const int c = 2 * (lane + 32 * k);
        if (inside && aligned && c + 1 < cin) {
          v[u][k] = ld32(src + c);
        } else {
          const uint32_t lo =
              (inside && c < cin) ? __bfloat16_as_ushort(src[c]) : 0u;
          const uint32_t hi =
              (inside && c + 1 < cin) ? __bfloat16_as_ushort(src[c + 1]) : 0u;
          v[u][k] = lo | (hi << 16);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int pix = p0 + u * TH;
      if (pix >= IN_PIX) break;
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        const int c = 2 * (lane + 32 * k);
        if (c < cin_pad)
          *reinterpret_cast<uint32_t*>(s_in + pix * stride + c) = v[u][k];
      }
    }
  }
}

template <int MODE, int CK>
__global__ void __launch_bounds__(THREADS)
stage_build_kernel(const BuildParams p) {
  using E = std::conditional_t<(MODE >= BUILD_I8), int8_t, __nv_bfloat16>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* s_in = reinterpret_cast<E*>(smem_raw);
  float* s_aff = reinterpret_cast<float*>(s_in + IN_PIX * p.stride);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // the fields of the stage kernels' parameters that their staging reads
  Params sp{};
  sp.h = p.h;
  sp.w = p.w;
  sp.cin = p.cin;
  sp.cin_pad = p.cin_pad;
  sp.stride = p.stride;
  ParamsI8 qp{};
  qp.x = p.x;
  qp.h = p.h;
  qp.w = p.w;
  qp.cin = p.cin;
  qp.cin_pad = p.cin_pad;
  qp.stride = p.stride;
  float in_mul[CK], in_add[CK], in_inv[CK];
#pragma unroll
  for (int k = 0; k < CK; ++k) {
    const int c = lane + 32 * k;
    const bool aff = p.in_scale != nullptr && c < p.cin;
    in_mul[k] = aff ? p.in_scale[c] + 1.0f : 1.0f;
    in_add[k] = aff ? p.in_shift[c] : 0.0f;
    in_inv[k] = (MODE >= BUILD_I8 && c < p.cin) ? p.in_inv[c] : 0.0f;
  }
  if constexpr (MODE == BUILD_I8_PACK) {
    for (int c = threadIdx.x; c < MAX_CIN_PAD; c += THREADS) {
      const bool real = c < p.cin;
      const bool aff = real && p.in_scale != nullptr;
      s_aff[c] = aff ? p.in_scale[c] + 1.0f : 1.0f;
      s_aff[MAX_CIN_PAD + c] = aff ? p.in_shift[c] : 0.0f;
      s_aff[2 * MAX_CIN_PAD + c] = real ? p.in_inv[c] : 0.0f;
    }
  }

  unsigned sum = 0;
  const int tiles_hw = p.tiles_w * p.tiles_h;
  for (int tile = blockIdx.x; tile < tiles_hw * p.n; tile += gridDim.x) {
    const int b = tile / tiles_hw;
    const int ty0 = (tile % tiles_hw) / p.tiles_w * TH;
    const int tx0 = (tile % p.tiles_w) * TW;
    const size_t xb = (size_t)b * p.h * p.w * p.cin;
    __syncthreads();  // the previous tile is read
    if constexpr (MODE == BUILD_F32) {
      stage_tile<3, CK, bnt::SIN_NONE, false>(s_in, sp, p.x + xb, ty0, tx0,
                                              warp, lane, in_mul, in_add);
    } else if constexpr (MODE == BUILD_RAW16) {
      stage_tile_raw16<(CK + 1) / 2>(s_in, p.x + xb, p.h, p.w, p.cin,
                                     p.cin_pad, p.stride, ty0, tx0, warp,
                                     lane);
    } else if constexpr (MODE == BUILD_I8) {
      stage_tile_i8<KIND_BF16, CK>(s_in, qp, xb, ty0, tx0, warp, lane,
                                   in_mul, in_add, in_inv);
    } else {
      stage_tile_i8_pack<KIND_BF16>(s_in, p.x, xb, p.h, p.w, p.cin,
                                    p.cin_pad, p.stride, ty0, tx0, s_aff);
    }
    __syncthreads();
    if (p.out) {
      E* out = static_cast<E*>(p.out) + (size_t)tile * IN_PIX * p.cin_pad;
      for (int i = threadIdx.x; i < IN_PIX * p.cin_pad; i += THREADS) {
        const int pix = i / p.cin_pad, c = i - pix * p.cin_pad;
        out[i] = s_in[pix * p.stride + c];
      }
    } else if (threadIdx.x == 0) {
      sum += reinterpret_cast<const unsigned*>(s_in)[tile & 63];
    }
  }
  if (!p.out && threadIdx.x == 0) atomicAdd(p.sink, sum);
}

using BuildKernel = void (*)(const BuildParams);

template <int MODE>
BuildKernel build_kernel(int ck) {
  switch (ck) {
    case 2: return stage_build_kernel<MODE, 2>;
    case 3: return stage_build_kernel<MODE, 3>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Shared memory a staging launch needs (bytes), or -1 for a mode or Cin it
// does not take (Cin outside 33..96).
int bnt_stage_build_probe_smem(int cin, int mode) {
  const bool i8 = mode >= BUILD_I8;
  const int cin_pad = i8 ? (cin + 31) / 32 * 32 : (cin + 15) / 16 * 16;
  const int ck = (cin_pad + 31) / 32;
  if (mode < BUILD_F32 || mode > BUILD_I8_PACK || ck < 2 || ck > 3)
    return -1;
  const int stride = cin_pad + (i8 ? 16 : 8);
  return IN_PIX * stride * (i8 ? 1 : 2) +
         (mode == BUILD_I8_PACK ? 3 * MAX_CIN_PAD * (int)sizeof(float) : 0);
}

// Stages every input tile of x (NHWC bf16) in `mode`, persistent, at
// max(smem, the launch's own need) bytes of shared memory per block: with
// out, writing each tile ([tiles, IN_PIX, cin_pad], bf16 or int8 codes);
// without, adding a checksum to sink[0].  in_inv is
// needed by the int8 modes; in_scale / in_shift (or null) by all but RAW16.
// Returns cudaErrorInvalidValue for a mode or shape it does not take, else
// cudaGetLastError() after the launch.
int bnt_stage_build_probe(const void* x, const void* in_scale,
                          const void* in_shift, const void* in_inv,
                          void* out, void* sink, int n, int h, int w, int cin,
                          int mode, int smem, void* stream) {
  const int need = bnt_stage_build_probe_smem(cin, mode);
  const bool i8 = mode >= BUILD_I8;
  if (need < 0 || (i8 && in_inv == nullptr) ||
      (mode == BUILD_RAW16 && in_scale != nullptr) || (!out && !sink))
    return cudaErrorInvalidValue;
  BuildParams p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.in_scale = static_cast<const float*>(in_scale);
  p.in_shift = static_cast<const float*>(in_shift);
  p.in_inv = static_cast<const float*>(in_inv);
  p.out = out;
  p.sink = static_cast<unsigned*>(sink);
  p.n = n;
  p.h = h;
  p.w = w;
  p.cin = cin;
  p.cin_pad = i8 ? (cin + 31) / 32 * 32 : (cin + 15) / 16 * 16;
  p.stride = p.cin_pad + (i8 ? 16 : 8);
  p.tiles_w = (w + TW - 1) / TW;
  p.tiles_h = (h + TH - 1) / TH;
  const int ck = (p.cin_pad + 31) / 32;
  BuildKernel k = nullptr;
  switch (mode) {
    case BUILD_F32: k = build_kernel<BUILD_F32>(ck); break;
    case BUILD_RAW16: k = build_kernel<BUILD_RAW16>(ck); break;
    case BUILD_I8: k = build_kernel<BUILD_I8>(ck); break;
    default: k = build_kernel<BUILD_I8_PACK>(ck); break;
  }
  return launch_persistent(k, p, p.tiles_w * p.tiles_h * n, 1,
                           std::max(smem, need),
                           static_cast<cudaStream_t>(stream));
}

}  // extern "C"
