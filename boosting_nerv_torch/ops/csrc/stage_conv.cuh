// The bf16 stage-conv kernel, stage_conv_kernel<KS, CK, Q, S>: one fused
// KS x KS convolution (see stage_conv.cu for what it computes, what bounds
// it and its C entry points).  Its KS = 3 instances are compiled in
// stage_conv.cu, its KS = 1 and KS = 5 ones in stage_conv_taps.cu and its
// sin instances (KS = 3) in stage_conv_sin.cu, so that nvcc builds the
// three in parallel; launch_taps and launch_sin are the bridges.

#pragma once

#include "stage_common.cuh"

namespace bnt {

struct Params {
  const __nv_bfloat16* x;          // [N, H, W, Cin]
  const __nv_bfloat16* wgt;        // [Cout, KS, KS, Cin]
  const __nv_bfloat16* bias;       // [Cout]
  const float* in_scale;           // [Cin] or null
  const float* in_shift;           // [Cin] or null
  const float* out_scale;          // [Cout] or null, after the activation
  const float* out_shift;          // [Cout] or null
  const __nv_bfloat16* residual;   // output-shaped or null
  const float* out_inv;            // [stored channels] or null: int8 out
  void* out;                       // [N, H, W, Cout] or [N, 2H, 2W, Cout/4]
  int n, h, w, cin, cout, act, shuffle;
  int nw;                          // output channels per block (chunk)
  int cin_pad;                     // K per tap, rounded up to 16
  int stride;                      // shared-memory row pitch (elements)
  int tiles_w, tiles_h;            // TH x TW output tiles per image
};

// Where a launch takes the sine of a tensor it reads (a compile-time
// choice): nowhere, of the staged input before the prologue affine
// (SIN_INPUT), or of the residual (SIN_RESIDUAL).
enum Sin { SIN_NONE = 0, SIN_INPUT = 1, SIN_RESIDUAL = 2 };

// The bf16 kernel's staging modes beside its Phase bits (probes only):
// STAGE_DIRECT loads each tap's A fragments straight from device memory
// (no s_in tile; launches without an input affine or sine only), and
// STAGE_UNMASKED applies the input affine to every tap, padding too.
enum Staging { STAGE_DIRECT = 16, STAGE_UNMASKED = 32 };

// Launches a KS = 1 or KS = 5 instance (stage_conv_taps.cu).
int launch_taps(int ks, const Params& p, int smem, cudaStream_t s);

// Launches a KS = 3 instance with SIN_INPUT or SIN_RESIDUAL
// (stage_conv_sin.cu).
int launch_sin(int sin_mode, const Params& p, int smem, cudaStream_t s);

}  // namespace bnt

// Shared memory of one launch (stage_conv.cu), or -1 for a shape the
// kernel does not take.
extern "C" int bnt_stage_conv_smem(int cin, int cout, int ks);

namespace {

using bnt::Params;

constexpr size_t SKIP = ~size_t(0);   // epilogue: no element here

// The halo'd input tile of a KS x KS conv over a TH x TW output tile.
template <int KS>
struct Tile {
  static constexpr int HALO = (KS - 1) / 2;
  static constexpr int H = TH + KS - 1;
  static constexpr int W = TW + KS - 1;
  static constexpr int PIX = H * W;
};

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The A-fragment register of a STAGE_DIRECT probe: channels c and c + 1 of
// pixel (iy, ix) of xb, read from device memory, 0 outside the image and
// beyond Cin (the staged values of a launch without prologue).
__device__ __forceinline__ uint32_t ld_direct(const __nv_bfloat16* xb,
                                              int h, int w, int cin, int iy,
                                              int ix, int c) {
  const bool inside = iy >= 0 && iy < h && ix >= 0 && ix < w;
  const __nv_bfloat16* src = xb + ((size_t)iy * w + ix) * cin + c;
  __nv_bfloat162 v;
  v.x = (inside && c < cin) ? src[0] : __float2bfloat16(0.0f);
  v.y = (inside && c + 1 < cin) ? src[1] : __float2bfloat16(0.0f);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Phase 2 of the kernel: stage the halo'd input tile of the output tile at
// (ty0, tx0) of the NHWC image xb (p.h x p.w x p.cin) into s_in[pixel][c]
// (pitch p.stride, channels < p.cin_pad written), channels lane + 32k,
// with the prologue (sin of S, affine) on in-image taps only: zero padding
// stays 0 (UNMASKED: the affine on every tap, a probe's).  U pixels x CK
// channels of loads in flight per thread.  stage_build_probe.cu times it
// alone.
template <int KS, int CK, int S, bool UNMASKED>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* s_in,
                                           const Params& p,
                                           const __nv_bfloat16* xb, int ty0,
                                           int tx0, int warp, int lane,
                                           const float (&in_mul)[CK],
                                           const float (&in_add)[CK]) {
  using T = Tile<KS>;
  constexpr int U = 4;
  for (int p0 = warp; p0 < T::PIX; p0 += TH * U) {
    float v[U][CK];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int pix = p0 + u * TH;
      const int iy = ty0 - T::HALO + pix / T::W;
      const int ix = tx0 - T::HALO + pix % T::W;
      const bool inside = pix < T::PIX && iy >= 0 && iy < p.h && ix >= 0 &&
                          ix < p.w;
      const __nv_bfloat16* src = xb + ((size_t)iy * p.w + ix) * p.cin;
#pragma unroll
      for (int k = 0; k < CK; ++k) {
        const int c = lane + 32 * k;
        if constexpr (S == bnt::SIN_INPUT) {
          v[u][k] = (inside && c < p.cin)
                        ? sin_reduced(__bfloat162float(src[c])) * in_mul[k] +
                              in_add[k]
                        : 0.0f;
        } else if constexpr (UNMASKED) {
          v[u][k] = c < p.cin ? (inside ? __bfloat162float(src[c]) : 0.0f) *
                                        in_mul[k] + in_add[k]
                              : 0.0f;
        } else {
          v[u][k] = (inside && c < p.cin)
                        ? __bfloat162float(src[c]) * in_mul[k] + in_add[k]
                        : 0.0f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int pix = p0 + u * TH;
      if (pix >= T::PIX) break;
#pragma unroll
      for (int k = 0; k < CK; ++k) {
        const int c = lane + 32 * k;
        if (c < p.cin_pad) s_in[pix * p.stride + c] = __float2bfloat16(v[u][k]);
      }
    }
  }
}

// KS: taps per side.  CK: input channels a lane stages per pixel, lane +
// 32k (cin_pad <= 32 CK).  Q: store int8 codes at out_inv instead of bf16
// (a compile-time choice, so that the bf16 store path carries no code of
// the int8 one).  S (bnt::Sin): the staged input is sin(x) * in_mul +
// in_add on in-image taps, or the residual is sin(residual); the ResBlockSFT
// whose block input is sin(x) is one launch of each (the v1 decode's
// switch stage).  S = SIN_NONE leaves the code as it was.  P: the phases
// it runs and its staging (Phase, bnt::Staging): PHASE_ALL, the default,
// is the production kernel and its code; the other masks are the probes
// of stage_conv_probe.cu.
template <int KS, int CK, bool Q, int S, int P = PHASE_ALL>
__global__ void __launch_bounds__(THREADS)
stage_conv_kernel(const Params p) {
  using T = Tile<KS>;
  constexpr bool kStage = (P & PHASE_STAGE) != 0;
  constexpr bool kGemm = (P & PHASE_GEMM) != 0;
  constexpr bool kEpi = (P & PHASE_EPI) != 0;
  constexpr bool kStore = (P & PHASE_STORE) != 0;
  constexpr bool kDirect = (P & bnt::STAGE_DIRECT) != 0;
  constexpr bool kUnmasked = (P & bnt::STAGE_UNMASKED) != 0;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // s_in[pixel][c]: the T::H x T::W halo tile; s_w[tap][n][c].  The pitch
  // cin_pad + 8 puts the eight rows of a fragment load in distinct banks.
  // The output channels are split into equal chunks of nw <= BN (a
  // multiple of 8), one per blockIdx.y; s_w holds nw rows per tap, so that
  // two blocks fit on an SM at most widths.  s_vec: bias, out_scale + 1,
  // out_shift, out_inv of this channel chunk.
  __nv_bfloat16* s_in = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s_w = s_in + T::PIX * p.stride;
  float* s_vec = reinterpret_cast<float*>(s_w + KS * KS * p.nw * p.stride);
  const __nv_bfloat16* __restrict__ residual = p.residual;
  __nv_bfloat16* __restrict__ out = static_cast<__nv_bfloat16*>(p.out);
  int8_t* __restrict__ out_q = static_cast<int8_t*>(p.out);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n0 = blockIdx.y * p.nw;
  const int nb = min(p.nw, p.cout - n0);  // real channels of this chunk
  const int nt = (nb + 7) >> 3;         // n8 tiles that hold any of them

  // 1. once per block (it walks many tiles): the weights of this
  //    output-channel chunk, zero beyond Cout and Cin, and the per-channel
  //    epilogue vectors
  for (int row = warp; row < KS * KS * nt * 8; row += TH) {
    const int tap = row / (nt * 8);
    const int n = row % (nt * 8);
    const __nv_bfloat16* src =
        p.wgt + ((size_t)(n0 + n) * KS * KS + tap) * p.cin;
    for (int c = lane; c < p.cin_pad; c += 32) {
      s_w[(tap * p.nw + n) * p.stride + c] =
          (n < nb && c < p.cin) ? src[c] : __float2bfloat16(0.0f);
    }
  }
  for (int n = threadIdx.x; n < BN; n += THREADS) {
    const bool ok = n0 + n < p.cout;
    const int stored = p.shuffle ? (n0 + n) >> 2 : n0 + n;
    s_vec[n] = ok ? __bfloat162float(p.bias[n0 + n]) : 0.0f;
    s_vec[BN + n] = ok && p.out_scale ? p.out_scale[n0 + n] + 1.0f : 1.0f;
    s_vec[2 * BN + n] = ok && p.out_shift ? p.out_shift[n0 + n] : 0.0f;
    s_vec[3 * BN + n] = ok && p.out_inv ? p.out_inv[stored] : 0.0f;
  }
  // a lane stages input channels lane + 32k; its prologue affine is
  // loop-invariant
  float in_mul[CK], in_add[CK];
#pragma unroll
  for (int k = 0; k < CK; ++k) {
    const int c = lane + 32 * k;
    const bool aff = p.in_scale != nullptr && c < p.cin;
    in_mul[k] = aff ? p.in_scale[c] + 1.0f : 1.0f;
    in_add[k] = aff ? p.in_shift[c] : 0.0f;
  }

  if constexpr (!kStage) {
    for (int i = threadIdx.x; i < T::PIX * p.stride; i += THREADS)
      s_in[i] = __float2bfloat16(0.0f);
  }

  const bool store = kStore || probe_store();
  const int g = lane >> 2;   // fragment row group
  const int tg = lane & 3;   // thread in group
  const int tiles_hw = p.tiles_w * p.tiles_h;
  for (int tile = blockIdx.x; tile < tiles_hw * p.n; tile += gridDim.x) {
    const int b = tile / tiles_hw;
    const int ty0 = (tile % tiles_hw) / p.tiles_w * TH;
    const int tx0 = (tile % p.tiles_w) * TW;
    const __nv_bfloat16* xb = p.x + (size_t)b * p.h * p.w * p.cin;
    __syncthreads();  // the previous tile's GEMM is done with s_in

    // 2. input tile, prologue affine on in-image taps only: zero padding
    //    stays 0
    if constexpr (kStage && !kDirect) {
      stage_tile<KS, CK, S, kUnmasked>(s_in, p, xb, ty0, tx0, warp, lane,
                                       in_mul, in_add);
    }
    __syncthreads();

    // 3. implicit GEMM: warp `warp` owns output row ty0 + warp
    float acc[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.0f;

    for (int tap = 0; tap < KS * KS && kGemm; ++tap) {
      const int dy = tap / KS, dx = tap % KS;
      const __nv_bfloat16* a_base =
          s_in + ((warp + dy) * T::W + dx + g) * p.stride + tg * 2;
      const __nv_bfloat16* b_base = s_w + (tap * p.nw + g) * p.stride + tg * 2;
      for (int k0 = 0; k0 < p.cin_pad; k0 += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if constexpr (kDirect) {
            // the fragment's pixels g and g + 8 of this tap, read from
            // device memory (no prologue: DIRECT launches have none)
            const int iy = ty0 + warp + dy - T::HALO;
            const int ix = tx0 + mt * 16 + g + dx - T::HALO;
            const int c = k0 + tg * 2;
            a[mt][0] = ld_direct(xb, p.h, p.w, p.cin, iy, ix, c);
            a[mt][1] = ld_direct(xb, p.h, p.w, p.cin, iy, ix + 8, c);
            a[mt][2] = ld_direct(xb, p.h, p.w, p.cin, iy, ix, c + 8);
            a[mt][3] = ld_direct(xb, p.h, p.w, p.cin, iy, ix + 8, c + 8);
          } else {
            const __nv_bfloat16* ap = a_base + mt * 16 * p.stride + k0;
            a[mt][0] = ld32(ap);
            a[mt][1] = ld32(ap + 8 * p.stride);
            a[mt][2] = ld32(ap + 8);
            a[mt][3] = ld32(ap + 8 * p.stride + 8);
          }
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (j < nt) {
            const __nv_bfloat16* bp = b_base + j * 8 * p.stride + k0;
            const uint32_t bfr[2] = {ld32(bp), ld32(bp + 8)};
            mma_bf16(acc[0][j], a[0], bfr);
            mma_bf16(acc[1][j], a[1], bfr);
          }
        }
      }
    }

    // 4. epilogue: bias, activation, output affine, residual, store
    const int oy = ty0 + warp;
    if (oy >= p.h) continue;
    // each 16-pixel half issues its residual loads before its first store
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      size_t off[NT][4];
      float res[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ox = tx0 + mt * 16 + g + (e >> 1) * 8;
          const int n = n0 + j * 8 + tg * 2 + (e & 1);
          const bool ok = j < nt && ox < p.w && n < p.cout;
          off[j][e] = ok ? out_offset(b, oy, ox, n, p.h, p.w, p.cout,
                                      p.shuffle)
                         : SKIP;
          if constexpr (kEpi) {
            res[j][e] = (ok && residual)
                            ? __bfloat162float(residual[off[j][e]])
                            : 0.0f;
            if constexpr (S == bnt::SIN_RESIDUAL) {
              res[j][e] = sin_reduced(res[j][e]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (off[j][e] == SKIP) continue;
          const int n = j * 8 + tg * 2 + (e & 1);
          float v = acc[mt][j][e];
          if constexpr (kEpi) {
            v = activate(v + s_vec[n], p.act);
            v = v * s_vec[BN + n] + s_vec[2 * BN + n] + res[j][e];
          }
          if (!store) continue;
          if constexpr (Q) {
            out_q[off[j][e]] = quant(v, s_vec[3 * BN + n]);
          } else {
            out[off[j][e]] = __float2bfloat16(v);
          }
        }
      }
    }
  }
}

template <int KS, bool Q, int S = bnt::SIN_NONE>
int launch(const Params& p, int smem, cudaStream_t s) {
  const int tiles = p.tiles_w * p.tiles_h * p.n;
  const int chunks = (p.cout + p.nw - 1) / p.nw;
  switch ((p.cin_pad + 31) / 32) {
    case 1: return launch_persistent(stage_conv_kernel<KS, 1, Q, S>, p, tiles, chunks, smem, s);
    case 2: return launch_persistent(stage_conv_kernel<KS, 2, Q, S>, p, tiles, chunks, smem, s);
    case 3: return launch_persistent(stage_conv_kernel<KS, 3, Q, S>, p, tiles, chunks, smem, s);
    default: return launch_persistent(stage_conv_kernel<KS, 4, Q, S>, p, tiles, chunks, smem, s);
  }
}


}  // namespace
