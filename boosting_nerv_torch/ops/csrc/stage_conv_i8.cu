// W8A8 fused 3x3 convolution for the HNeRV-Boost decoder tail: int8 codes
// times int8 weights on the tensor cores (mma.sync m16n8k32 s8, int32
// accumulation), dequantised per output channel in the epilogue.
//
// Replaces the W8A8 forms of the two Pallas stage kernels of
// boosting_nerv_tpu/ops/pallas/planar.py: fused_upconv_rsft with
// prepare_upconv_rsft_i8 (:707) and fused_conv_rsft with
// prepare_conv_rsft_i8 (:673), run with i8 / i8_in / out_inv set.  A stage
// is the launch chain of stage_conv.cu with int8 operands:
//
//   upconv : y   = sin(PS2(dq(conv(q_x(x)))))            bf16 y (shuffle)
//   conv   : y   = sin(dq(conv(q_x(x))))                 bf16 y
//   rsft 0 : t   = q_t1(SFT1(gelu(dq(conv(q_t0(SFT0(y)))))))   int8 codes
//   rsft 1 : out = y + dq(conv(t))                       bf16, or int8 codes
//                                                        at the next bound
//   head   : rgb = outimg(dq(conv(q_h(out))))            bf16
//
// q_b(v) = clip(rint(v * inv_b), +-127) with inv_b = 127 / bound_b per
// input channel (0 for a dead channel), and dq(acc) = float(acc) * s_w[n] +
// b[n], where the weights were folded with bound_b / 127 and quantised per
// output channel (ops/kernels/quant.py).  The prologue either copies int8
// codes (the zero-convert chain: the producer already quantised) or reads
// bf16, applies the optional SFT0 affine on in-image taps only and
// quantises; padding is code 0 either way.  The epilogue stores bf16 or
// int8 codes at out_inv.  Every rounding step is the plain version's
// (ops/kernels/planar.py): products, sums and quantisation use _rn
// intrinsics so that nvcc does not contract them into an fma.
//
// What bounds it on an H100: int8 halves the staged and stored bytes of the
// bf16 kernel and the m16n8k32 MMA runs at twice the bf16 rate; by the
// roofline a launch is still bound by operations (~0.1 TOP per 1080p
// launch against ~40 MB of traffic).  In practice, as for the bf16 kernel,
// the per-element staging and epilogue work binds it: channel counts 51
// and 61 are odd, so staging is one byte per lane and channel.  Same tile
// and persistent schedule as stage_conv.cu but three blocks per SM, and
// the same predicated loads
// (a staged element or residual is a select, not a branch, so that all of
// a thread's loads are in flight at once); the shared-memory pitch
// cin_pad + 16 bytes keeps the eight rows of a fragment load in distinct
// banks for every cin_pad that is a multiple of 32.

#include "stage_common.cuh"

namespace {

enum Kind { KIND_I8 = 0, KIND_BF16 = 1 };

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

// IK, OK: the input's and the output's kind (Kind), compile-time so that
// each staging and store path is straight-line code; CK: input channels a
// lane stages per pixel, lane + 32k (cin_pad <= 32 CK).  At most 168
// registers a thread (32-bit output offsets help), so that three blocks
// (12 warps) share an SM wherever their shared memory fits, which it does
// at every tail width (int8 tiles take half the bf16 kernel's bytes): with
// two blocks, the warps' MMA and load latencies stay exposed.
template <int IK, int OK, int CK>
__global__ void __launch_bounds__(THREADS, 3)
stage_conv3x3_i8_kernel(const ParamsI8 p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // s_in[pixel][c] and s_w[tap][n][c] hold int8 codes at a pitch of
  // cin_pad + 16 bytes; s_vec: w_scale, bias, out_scale + 1, out_shift,
  // out_inv of this block's output-channel chunk.
  int8_t* s_in = reinterpret_cast<int8_t*>(smem_raw);
  int8_t* s_w = s_in + IN_PIX * p.stride;
  float* s_vec = reinterpret_cast<float*>(s_w + 9 * p.nw * p.stride);
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

  const int g = lane >> 2;   // fragment row group
  const int tg = lane & 3;   // thread in group
  const int tiles_hw = p.tiles_w * p.tiles_h;
  for (int tile = blockIdx.x; tile < tiles_hw * p.n; tile += gridDim.x) {
    const int b = tile / tiles_hw;
    const int ty0 = (tile % tiles_hw) / p.tiles_w * TH;
    const int tx0 = (tile % p.tiles_w) * TW;
    const size_t xb = (size_t)b * p.h * p.w * p.cin;
    __syncthreads();  // the previous tile's GEMM is done with s_in

    // 2. input tile as int8 codes: copied, or affine (in-image taps only)
    //    and quantised; padding and channels >= Cin are code 0.  U pixels
    //    x CK channels of loads in flight per thread.
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

    for (int tap = 0; tap < 9; ++tap) {
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
          res[j][e] = (ok && res_b) ? __bfloat162float(res_b[off[j][e]])
                                    : 0.0f;
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (off[j][e] < 0) continue;
          const int n = j * 8 + tg * 2 + (e & 1);
          float v = __fadd_rn(
              __fmul_rn(static_cast<float>(acc[mt][j][e]), s_vec[n]),
              s_vec[BN + n]);
          v = activate(v, p.act);
          v = __fadd_rn(__fmul_rn(v, s_vec[2 * BN + n]), s_vec[3 * BN + n]);
          v = __fadd_rn(v, res[j][e]);
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

extern "C" {

// Shared memory of one W8A8 launch (bytes), or -1 for a shape the kernel
// does not take (more than MAX_CIN_PAD input channels, or more than the
// card's shared memory).
int bnt_stage_conv3x3_i8_smem(int cin, int cout) {
  const int cin_pad = (cin + 31) / 32 * 32;
  const int stride = cin_pad + 16;
  const int nw = chunk_width(cout);
  const int smem = (IN_PIX + 9 * nw) * stride + 5 * BN * (int)sizeof(float);
  return (cin_pad > MAX_CIN_PAD || smem > MAX_SMEM) ? -1 : smem;
}

// One W8A8 fused 3x3 convolution on the given stream: x is int8 codes
// (in_i8 = 1) or bf16 quantised at in_inv; out is int8 codes at out_inv
// (out_inv not null) or bf16.  Pointers may be null where the comment on
// ParamsI8 allows it.  Returns cudaGetLastError() after the launch (0 on
// success).
int bnt_stage_conv3x3_i8(const void* x, const void* w, const void* w_scale,
                         const void* bias, const void* in_inv,
                         const void* in_scale, const void* in_shift,
                         const void* out_scale, const void* out_shift,
                         const void* residual, const void* out_inv, void* out,
                         int n, int h, int w_, int cin, int cout, int act,
                         int shuffle, int in_i8, void* stream) {
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
  const int smem = bnt_stage_conv3x3_i8_smem(cin, cout);
  if (smem < 0 || (!in_i8 && in_inv == nullptr) ||
      (shuffle && cout % 4 != 0))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_i8) {
    return out_inv ? launch_i8<KIND_I8, KIND_I8>(p, smem, s)
                   : launch_i8<KIND_I8, KIND_BF16>(p, smem, s);
  }
  return out_inv ? launch_i8<KIND_BF16, KIND_I8>(p, smem, s)
                 : launch_i8<KIND_BF16, KIND_BF16>(p, smem, s);
}

}  // extern "C"
