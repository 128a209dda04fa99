// Fused 3x3 convolution for the HNeRV-Boost decoder tail, NHWC bf16 in and
// out, fp32 accumulation on the tensor cores (mma.sync m16n8k16).
//
// Replaces the two Pallas stage kernels of boosting_nerv_tpu/ops/pallas/
// planar.py: fused_upconv_rsft (stride-2 stage) and fused_conv_rsft
// (stride-1 stage, optional 3x3 RGB head).  A stage is a chain of launches
// of this one kernel, each with a fused prologue and epilogue:
//
//   upconv : y   = sin(PixelShuffle2(conv(x) + b))       shuffle=1, act=sin
//   conv   : y   = sin(conv(x) + b)                      act=sin
//   rsft 0 : t   = SFT1(gelu(conv(SFT0(y)) + b0))        in/out affine, gelu
//   rsft 1 : out = y + conv(t) + b1                      residual
//   head   : rgb = tanh(conv(out) + bh) * 0.5 + 0.5      act=outimg
//
// with SFTi(v) = v * (scale_i + 1) + shift_i per channel.  The input affine
// is applied only to taps inside the image: the reference pads after the
// affine (models/blocks.py ResBlockSFT), so zero padding stays exactly 0.
// With out_inv the launch stores int8 codes clip(rint(v * out_inv), +-127)
// instead of bf16: the zero-convert chain of the W8A8 decode, where a bf16
// stage hands its output to an int8 stage (planar.py:1297-1301).
//
// What bounds it on an H100: the 1080p stage-7 tensors are
// 1080*1920*51*2 B = 211 MB each and the tail costs about 0.9 TFLOP of
// convolutions per frame, so by the roofline a launch is bound by the
// tensor cores (~0.1 ms of HBM traffic against ~100 GFLOP).  In practice
// the per-element work around the GEMM binds it: staging the input tile
// (channel counts such as 51 and 61 are odd, so loads are 2-byte), the
// activation, and the stores.  This version runs persistent blocks (two
// per SM at the 1080p-zone widths, so that one block's loads overlap the
// other's GEMM), each loading its slice of up to 64 output channels of the
// weights once and walking 4x32 output tiles; per tile it stages the halo'd
// input (prologue applied) in shared memory and runs the implicit GEMM
// (M = 32 pixels per warp, N <= 64, K = 9 * Cin) with mma.sync.
// Intermediates go through device memory in bf16; fusing a stage into one
// launch, TMA and wgmma are later work.

#include "stage_common.cuh"

namespace {

constexpr size_t SKIP = ~size_t(0);   // epilogue: no element here

struct Params {
  const __nv_bfloat16* x;          // [N, H, W, Cin]
  const __nv_bfloat16* wgt;        // [Cout, 3, 3, Cin]
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

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// CK: input channels a lane stages per pixel, lane + 32k (cin_pad <= 32 CK).
// Q: store int8 codes at out_inv instead of bf16 (a compile-time choice, so
// that the bf16 store path carries no code of the int8 one).
template <int CK, bool Q>
__global__ void __launch_bounds__(THREADS)
stage_conv3x3_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // s_in[pixel][c]: the (TH+2) x (TW+2) halo tile; s_w[tap][n][c].  The
  // pitch cin_pad + 8 puts the eight rows of a fragment load in distinct
  // banks.  The output channels are split into equal chunks of nw <= BN
  // (a multiple of 8), one per blockIdx.y; s_w holds nw rows per tap, so
  // that two blocks fit on an SM at most widths.  s_vec: bias,
  // out_scale + 1, out_shift, out_inv of this channel chunk.
  __nv_bfloat16* s_in = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s_w = s_in + IN_PIX * p.stride;
  float* s_vec = reinterpret_cast<float*>(s_w + 9 * p.nw * p.stride);
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
  for (int row = warp; row < 9 * nt * 8; row += TH) {
    const int tap = row / (nt * 8);
    const int n = row % (nt * 8);
    const __nv_bfloat16* src = p.wgt + ((size_t)(n0 + n) * 9 + tap) * p.cin;
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
    //    stays 0.  U pixels x CK channels of loads in flight per thread.
    constexpr int U = 4;
    for (int p0 = warp; p0 < IN_PIX; p0 += TH * U) {
      float v[U][CK];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int pix = p0 + u * TH;
        const int iy = ty0 - 1 + pix / IN_W;
        const int ix = tx0 - 1 + pix % IN_W;
        const bool inside = pix < IN_PIX && iy >= 0 && iy < p.h && ix >= 0 &&
                            ix < p.w;
        const __nv_bfloat16* src = xb + ((size_t)iy * p.w + ix) * p.cin;
#pragma unroll
        for (int k = 0; k < CK; ++k) {
          const int c = lane + 32 * k;
          v[u][k] = (inside && c < p.cin)
                        ? __bfloat162float(src[c]) * in_mul[k] + in_add[k]
                        : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int pix = p0 + u * TH;
        if (pix >= IN_PIX) break;
#pragma unroll
        for (int k = 0; k < CK; ++k) {
          const int c = lane + 32 * k;
          if (c < p.cin_pad) s_in[pix * p.stride + c] = __float2bfloat16(v[u][k]);
        }
      }
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

    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const __nv_bfloat16* a_base =
          s_in + ((warp + dy) * IN_W + dx + g) * p.stride + tg * 2;
      const __nv_bfloat16* b_base = s_w + (tap * p.nw + g) * p.stride + tg * 2;
      for (int k0 = 0; k0 < p.cin_pad; k0 += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const __nv_bfloat16* ap = a_base + mt * 16 * p.stride + k0;
          a[mt][0] = ld32(ap);
          a[mt][1] = ld32(ap + 8 * p.stride);
          a[mt][2] = ld32(ap + 8);
          a[mt][3] = ld32(ap + 8 * p.stride + 8);
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
          res[j][e] = (ok && residual) ? __bfloat162float(residual[off[j][e]])
                                       : 0.0f;
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (off[j][e] == SKIP) continue;
          const int n = j * 8 + tg * 2 + (e & 1);
          float v = activate(acc[mt][j][e] + s_vec[n], p.act);
          v = v * s_vec[BN + n] + s_vec[2 * BN + n] + res[j][e];
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

template <bool Q>
int launch(const Params& p, int smem, cudaStream_t s) {
  const int tiles = p.tiles_w * p.tiles_h * p.n;
  const int chunks = (p.cout + p.nw - 1) / p.nw;
  switch ((p.cin_pad + 31) / 32) {
    case 1: return launch_persistent(stage_conv3x3_kernel<1, Q>, p, tiles, chunks, smem, s);
    case 2: return launch_persistent(stage_conv3x3_kernel<2, Q>, p, tiles, chunks, smem, s);
    case 3: return launch_persistent(stage_conv3x3_kernel<3, Q>, p, tiles, chunks, smem, s);
    default: return launch_persistent(stage_conv3x3_kernel<4, Q>, p, tiles, chunks, smem, s);
  }
}

}  // namespace

extern "C" {

// Shared memory of one launch (bytes), or -1 for a shape the kernel does
// not take (more than MAX_CIN_PAD input channels, or more than the card's
// shared memory).
int bnt_stage_conv3x3_smem(int cin, int cout) {
  const int cin_pad = (cin + 15) / 16 * 16;
  const int stride = cin_pad + 8;
  const int nw = chunk_width(cout);
  const int smem = (IN_PIX + 9 * nw) * stride * (int)sizeof(__nv_bfloat16) +
                   4 * BN * (int)sizeof(float);
  return (cin_pad > MAX_CIN_PAD || smem > MAX_SMEM) ? -1 : smem;
}

// One fused 3x3 convolution on the given stream.  Pointers may be null
// where the comment on Params allows it.  Returns cudaGetLastError() after
// the launch (0 on success).
int bnt_stage_conv3x3(const void* x, const void* w, const void* bias,
                      const void* in_scale, const void* in_shift,
                      const void* out_scale, const void* out_shift,
                      const void* residual, const void* out_inv, void* out,
                      int n, int h, int w_, int cin, int cout, int act,
                      int shuffle, void* stream) {
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.wgt = static_cast<const __nv_bfloat16*>(w);
  p.bias = static_cast<const __nv_bfloat16*>(bias);
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
  p.cin_pad = (cin + 15) / 16 * 16;
  p.stride = p.cin_pad + 8;
  p.tiles_w = (w_ + TW - 1) / TW;
  p.tiles_h = (h + TH - 1) / TH;
  const int smem = bnt_stage_conv3x3_smem(cin, cout);
  if (smem < 0 || (shuffle && cout % 4 != 0)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_inv ? launch<true>(p, smem, s) : launch<false>(p, smem, s);
}

const char* bnt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
