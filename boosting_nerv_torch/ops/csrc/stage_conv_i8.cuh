// The W8A8 stage-conv kernel, stage_conv3x3_i8_kernel<IK, OK, CK, P>: one
// fused 3x3 convolution of int8 codes on the tensor cores (see
// stage_conv_i8.cu for what it computes, what bounds it and its C entry
// points).  Its production instances are compiled in stage_conv_i8.cu,
// its probe instances in stage_conv_i8_probe.cu, so that nvcc builds the
// two in parallel.

#pragma once

#include "stage_common.cuh"

// Shared memory of one W8A8 launch (stage_conv_i8.cu), or -1 for a shape
// the kernel does not take.
extern "C" int bnt_stage_conv3x3_i8_smem(int cin, int cout);

namespace {

enum Kind { KIND_I8 = 0, KIND_BF16 = 1 };

// The int8 kernel's staging modes beside its Phase bits (probes only,
// stage_conv_i8_probe.cu): STAGE_PACK stages four codes per 32-bit
// shared-memory store; STAGE_ASYNC (an int8-code input whose channel
// pitch is cin_pad) copies each pixel's codes with cp.async, 16 bytes a
// copy, with no thread store.
enum StagingI8 { STAGE_PACK = 16, STAGE_ASYNC = 32 };

struct ParamsI8 {
  const void* x;                   // [N, H, W, Cin]: int8 codes or bf16
  const int8_t* wgt;               // [Cout, 3, 3, Cin] int8 codes
  const float* w_scale;            // [Cout] dequant scale
  const float* bias;               // [Cout]
  const float* in_inv;             // [Cin] for a bf16 input
  const float* in_scale;           // [Cin] or null
  const float* in_shift;           // [Cin] or null
  const float* out_scale;          // [Cout] or null, after the activation
  const float* out_shift;          // [Cout] or null
  const __nv_bfloat16* residual;   // output-shaped or null
  const float* out_inv;            // [stored channels] for int8 output
  void* out;                       // [N, H, W, Cout] or [N, 2H, 2W, Cout/4]
  int n, h, w, cin, cout, act, shuffle;
  int nw;                          // output channels per block (chunk)
  int cin_pad;                     // K per tap in bytes, rounded up to 32
  int stride;                      // shared-memory row pitch (bytes)
  int tiles_w, tiles_h;            // TH x TW output tiles per image
};

__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Phase 2 of the kernel: the halo'd input tile of the output tile at
// (ty0, tx0) as int8 codes in s_in[pixel][c] (pitch p.stride bytes,
// channels < p.cin_pad written), channels lane + 32k: copied from int8
// codes, or the bf16 input with the affine (in-image taps only) and
// quantised; padding and channels >= Cin are code 0.  xb: the image's
// first element in p.x (NHWC, p.h x p.w x p.cin).  U pixels x CK channels of loads
// in flight per thread.  stage_build_probe.cu times it alone.
template <int IK, int CK>
__device__ __forceinline__ void stage_tile_i8(
    int8_t* s_in, const ParamsI8& p, size_t xb, int ty0, int tx0, int warp,
    int lane, const float (&in_mul)[CK], const float (&in_add)[CK],
    const float (&in_inv)[CK]) {
  constexpr int U = 4;
  for (int p0 = warp; p0 < IN_PIX; p0 += TH * U) {
    int8_t q[U][CK];
    float v[U][CK];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int pix = p0 + u * TH;
      const int iy = ty0 - 1 + pix / IN_W;
      const int ix = tx0 - 1 + pix % IN_W;
      const bool inside = pix < IN_PIX && iy >= 0 && iy < p.h && ix >= 0 &&
                          ix < p.w;
      const size_t src = xb + ((size_t)iy * p.w + ix) * p.cin;
#pragma unroll
      for (int k = 0; k < CK; ++k) {
        const int c = lane + 32 * k;
        const bool ok = inside && c < p.cin;
        if constexpr (IK == KIND_I8) {
          q[u][k] = ok ? static_cast<const int8_t*>(p.x)[src + c]
                       : int8_t(0);
        } else {
          v[u][k] = ok ? __fadd_rn(
                             __fmul_rn(__bfloat162float(
                                           static_cast<const __nv_bfloat16*>(
                                               p.x)[src + c]),
                                       in_mul[k]),
                             in_add[k])
                       : 0.0f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int pix = p0 + u * TH;
      if (pix >= IN_PIX) break;
#pragma unroll
      for (int k = 0; k < CK; ++k) {
        const int c = lane + 32 * k;
        if constexpr (IK == KIND_BF16) q[u][k] = quant(v[u][k], in_inv[k]);
        if (c < p.cin_pad) s_in[pix * p.stride + c] = q[u][k];
      }
    }
  }
}

// STAGE_PACK: the codes of stage_tile_i8, four channels of a pixel a
// thread, packed into one 32-bit shared-memory store.  The bf16 input's
// per-channel affine and multiplier come from s_aff (in_scale + 1,
// in_shift, in_inv, MAX_CIN_PAD each), since a thread's channels are not
// lane + 32k.  Codes equal stage_tile_i8's: the same _rn arithmetic.
template <int IK>
__device__ __forceinline__ void stage_tile_i8_pack(
    int8_t* s_in, const void* x, size_t xb, int h, int w, int cin,
    int cin_pad, int stride, int ty0, int tx0, const float* s_aff) {
  const int words = cin_pad >> 2;
#pragma unroll 4
  for (int i = threadIdx.x; i < IN_PIX * words; i += THREADS) {
    const int pix = i / words;
    const int c0 = (i - pix * words) * 4;
    const int iy = ty0 - 1 + pix / IN_W;
    const int ix = tx0 - 1 + pix % IN_W;
    const bool inside = iy >= 0 && iy < h && ix >= 0 && ix < w;
    const size_t src = xb + ((size_t)iy * w + ix) * cin;
    uint32_t packed = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + q;
      const bool ok = inside && c < cin;
      int8_t code;
      if constexpr (IK == KIND_I8) {
        code = ok ? static_cast<const int8_t*>(x)[src + c] : int8_t(0);
      } else {
        const float v =
            ok ? __fadd_rn(__fmul_rn(__bfloat162float(
                                         static_cast<const __nv_bfloat16*>(
                                             x)[src + c]),
                                     s_aff[c]),
                           s_aff[MAX_CIN_PAD + c])
               : 0.0f;
        code = quant(v, s_aff[2 * MAX_CIN_PAD + c]);
      }
      packed |= static_cast<uint32_t>(static_cast<uint8_t>(code)) << (8 * q);
    }
    *reinterpret_cast<uint32_t*>(s_in + pix * stride + c0) = packed;
  }
}

// STAGE_ASYNC: int8 codes whose channel pitch is cin_pad (zero beyond
// Cin), copied into s_in by cp.async in 16-byte pieces; a piece outside
// the image is zero-filled (source size 0).  Waits for its copies.
__device__ __forceinline__ void stage_tile_i8_async(
    int8_t* s_in, const int8_t* x, size_t xb, int h, int w, int cin_pad,
    int stride, int ty0, int tx0) {
  const int pieces = cin_pad >> 4;
  for (int i = threadIdx.x; i < IN_PIX * pieces; i += THREADS) {
    const int pix = i / pieces;
    const int c0 = (i - pix * pieces) * 16;
    const int iy = ty0 - 1 + pix / IN_W;
    const int ix = tx0 - 1 + pix % IN_W;
    const bool inside = iy >= 0 && iy < h && ix >= 0 && ix < w;
    const int8_t* src =
        inside ? x + xb + ((size_t)iy * w + ix) * cin_pad + c0 : x;
    const unsigned dst = static_cast<unsigned>(
        __cvta_generic_to_shared(s_in + pix * stride + c0));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(inside ? 16 : 0));
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// IK, OK: the input's and the output's kind (Kind), compile-time so that
// each staging and store path is straight-line code; CK: input channels a
// lane stages per pixel, lane + 32k (cin_pad <= 32 CK).  At most 168
// registers a thread (32-bit output offsets help), so that three blocks
// (12 warps) share an SM wherever their shared memory fits, which it does
// at every tail width (int8 tiles take half the bf16 kernel's bytes): with
// two blocks, the warps' MMA and load latencies stay exposed.  P: the
// phases it runs and its staging (Phase, StagingI8): PHASE_ALL, the
// default, is the production kernel and its code; the other masks are the
// probes of stage_conv_i8_probe.cu.
template <int IK, int OK, int CK, int P = PHASE_ALL>
__global__ void __launch_bounds__(THREADS, 3)
stage_conv3x3_i8_kernel(const ParamsI8 p) {
  constexpr bool kStage = (P & PHASE_STAGE) != 0;
  constexpr bool kGemm = (P & PHASE_GEMM) != 0;
  constexpr bool kEpi = (P & PHASE_EPI) != 0;
  constexpr bool kStore = (P & PHASE_STORE) != 0;
  constexpr bool kPack = (P & STAGE_PACK) != 0;
  constexpr bool kAsync = (P & STAGE_ASYNC) != 0;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // s_in[pixel][c] and s_w[tap][n][c] hold int8 codes at a pitch of
  // cin_pad + 16 bytes; s_vec: w_scale, bias, out_scale + 1, out_shift,
  // out_inv of this block's output-channel chunk; s_aff (STAGE_PACK of a
  // bf16 input): in_scale + 1, in_shift, in_inv per input channel.
  int8_t* s_in = reinterpret_cast<int8_t*>(smem_raw);
  int8_t* s_w = s_in + IN_PIX * p.stride;
  float* s_vec = reinterpret_cast<float*>(s_w + 9 * p.nw * p.stride);
  float* s_aff = s_vec + 5 * BN;
  const __nv_bfloat16* __restrict__ residual = p.residual;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n0 = blockIdx.y * p.nw;
  const int nb = min(p.nw, p.cout - n0);  // real channels of this chunk
  const int nt = (nb + 7) >> 3;         // n8 tiles that hold any of them

  // 1. once per block: this chunk's weights (zero beyond Cout and Cin) and
  //    the per-channel epilogue vectors
  for (int row = warp; row < 9 * nt * 8; row += TH) {
    const int tap = row / (nt * 8);
    const int n = row % (nt * 8);
    const int8_t* src = p.wgt + ((size_t)(n0 + n) * 9 + tap) * p.cin;
    for (int c = lane; c < p.cin_pad; c += 32) {
      s_w[(tap * p.nw + n) * p.stride + c] =
          (n < nb && c < p.cin) ? src[c] : int8_t(0);
    }
  }
  for (int n = threadIdx.x; n < BN; n += THREADS) {
    const bool ok = n0 + n < p.cout;
    const int stored = p.shuffle ? (n0 + n) >> 2 : n0 + n;
    s_vec[n] = ok ? p.w_scale[n0 + n] : 0.0f;
    s_vec[BN + n] = ok ? p.bias[n0 + n] : 0.0f;
    s_vec[2 * BN + n] = ok && p.out_scale ? p.out_scale[n0 + n] + 1.0f : 1.0f;
    s_vec[3 * BN + n] = ok && p.out_shift ? p.out_shift[n0 + n] : 0.0f;
    s_vec[4 * BN + n] = ok && p.out_inv ? p.out_inv[stored] : 0.0f;
  }
  // a lane stages input channels lane + 32k: its prologue affine and
  // quantisation multiplier are loop-invariant
  float in_mul[CK], in_add[CK], in_inv[CK];
#pragma unroll
  for (int k = 0; k < CK; ++k) {
    const int c = lane + 32 * k;
    const bool real = IK == KIND_BF16 && c < p.cin;
    const bool aff = real && p.in_scale != nullptr;
    in_mul[k] = aff ? p.in_scale[c] + 1.0f : 1.0f;
    in_add[k] = aff ? p.in_shift[c] : 0.0f;
    in_inv[k] = real ? p.in_inv[c] : 0.0f;
  }
  if constexpr (kPack && IK == KIND_BF16) {
    for (int c = threadIdx.x; c < MAX_CIN_PAD; c += THREADS) {
      const bool real = c < p.cin;
      const bool aff = real && p.in_scale != nullptr;
      s_aff[c] = aff ? p.in_scale[c] + 1.0f : 1.0f;
      s_aff[MAX_CIN_PAD + c] = aff ? p.in_shift[c] : 0.0f;
      s_aff[2 * MAX_CIN_PAD + c] = real ? p.in_inv[c] : 0.0f;
    }
  }
  if constexpr (!kStage) {
    for (int i = threadIdx.x; i < IN_PIX * p.stride; i += THREADS)
      s_in[i] = 0;
  }

  const bool store = kStore || probe_store();
  const int g = lane >> 2;   // fragment row group
  const int tg = lane & 3;   // thread in group
  const int tiles_hw = p.tiles_w * p.tiles_h;
  for (int tile = blockIdx.x; tile < tiles_hw * p.n; tile += gridDim.x) {
    const int b = tile / tiles_hw;
    const int ty0 = (tile % tiles_hw) / p.tiles_w * TH;
    const int tx0 = (tile % p.tiles_w) * TW;
    const size_t xb = (size_t)b * p.h * p.w * (kAsync ? p.cin_pad : p.cin);
    __syncthreads();  // the previous tile's GEMM is done with s_in

    // 2. input tile as int8 codes: copied, or affine (in-image taps only)
    //    and quantised; padding and channels >= Cin are code 0
    if constexpr (kStage && kPack) {
      stage_tile_i8_pack<IK>(s_in, p.x, xb, p.h, p.w, p.cin, p.cin_pad,
                             p.stride, ty0, tx0, s_aff);
    } else if constexpr (kStage && kAsync) {
      stage_tile_i8_async(s_in, static_cast<const int8_t*>(p.x), xb, p.h,
                          p.w, p.cin_pad, p.stride, ty0, tx0);
    } else if constexpr (kStage) {
      stage_tile_i8<IK, CK>(s_in, p, xb, ty0, tx0, warp, lane, in_mul,
                            in_add, in_inv);
    }
    __syncthreads();

    // 3. implicit GEMM: warp `warp` owns output row ty0 + warp.  The s8
    //    m16n8k32 fragments hold four codes per register at the byte
    //    offsets of the bf16 m16n8k16 ones: A rows g and g + 8, bytes
    //    tg*4 and 16 + tg*4 of the 32-byte K step; B column g, the same.
    int acc[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0;

    for (int tap = 0; tap < 9 && kGemm; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const int8_t* a_base =
          s_in + ((warp + dy) * IN_W + dx + g) * p.stride + tg * 4;
      const int8_t* b_base = s_w + (tap * p.nw + g) * p.stride + tg * 4;
      for (int k0 = 0; k0 < p.cin_pad; k0 += 32) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int8_t* ap = a_base + mt * 16 * p.stride + k0;
          a[mt][0] = ld32(ap);
          a[mt][1] = ld32(ap + 8 * p.stride);
          a[mt][2] = ld32(ap + 16);
          a[mt][3] = ld32(ap + 8 * p.stride + 16);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (j < nt) {
            const int8_t* bp = b_base + j * 8 * p.stride + k0;
            const uint32_t bfr[2] = {ld32(bp), ld32(bp + 16)};
            mma_s8(acc[0][j], a[0], bfr);
            mma_s8(acc[1][j], a[1], bfr);
          }
        }
      }
    }

    // 4. epilogue: dequantise, bias, activation, output affine, residual,
    //    store bf16 or int8 codes
    const int oy = ty0 + warp;
    if (oy >= p.h) continue;
    // offsets within this image fit 32 bits (h * w * cout < 2^31)
    const size_t ob = (size_t)b * p.h * p.w * p.cout;
    const __nv_bfloat16* res_b = residual ? residual + ob : nullptr;
    // each 16-pixel half issues its residual loads before its first store
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      int off[NT][4];
      float res[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ox = tx0 + mt * 16 + g + (e >> 1) * 8;
          const int n = n0 + j * 8 + tg * 2 + (e & 1);
          const bool ok = j < nt && ox < p.w && n < p.cout;
          off[j][e] = ok ? (int)out_offset(0, oy, ox, n, p.h, p.w, p.cout,
                                           p.shuffle)
                         : -1;
          if constexpr (kEpi) {
            res[j][e] = (ok && res_b) ? __bfloat162float(res_b[off[j][e]])
                                      : 0.0f;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (off[j][e] < 0) continue;
          const int n = j * 8 + tg * 2 + (e & 1);
          float v = static_cast<float>(acc[mt][j][e]);
          if constexpr (kEpi) {
            v = __fadd_rn(__fmul_rn(v, s_vec[n]), s_vec[BN + n]);
            v = activate(v, p.act);
            v = __fadd_rn(__fmul_rn(v, s_vec[2 * BN + n]),
                          s_vec[3 * BN + n]);
            v = __fadd_rn(v, res[j][e]);
          }
          if (!store) continue;
          if constexpr (OK == KIND_I8) {
            static_cast<int8_t*>(p.out)[ob + off[j][e]] =
                quant(v, s_vec[4 * BN + n]);
          } else {
            static_cast<__nv_bfloat16*>(p.out)[ob + off[j][e]] =
                __float2bfloat16(v);
          }
        }
      }
    }
  }
}

template <int IK, int OK>
int launch_i8(const ParamsI8& p, int smem, cudaStream_t s) {
  const int tiles = p.tiles_w * p.tiles_h * p.n;
  const int chunks = (p.cout + p.nw - 1) / p.nw;
  switch (p.cin_pad / 32) {
    case 1: return launch_persistent(stage_conv3x3_i8_kernel<IK, OK, 1>, p, tiles, chunks, smem, s);
    case 2: return launch_persistent(stage_conv3x3_i8_kernel<IK, OK, 2>, p, tiles, chunks, smem, s);
    case 3: return launch_persistent(stage_conv3x3_i8_kernel<IK, OK, 3>, p, tiles, chunks, smem, s);
    default: return launch_persistent(stage_conv3x3_i8_kernel<IK, OK, 4>, p, tiles, chunks, smem, s);
  }
}

}  // namespace
