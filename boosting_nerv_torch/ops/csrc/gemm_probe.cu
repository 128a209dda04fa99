// The tensor-core ceiling of the stage kernels' inner loop: each block
// loads an A tile and B once into shared memory, then runs the production
// fragment loop of stage_conv.cuh / stage_conv_i8.cuh (32-bit fragment
// loads at the pitch kpad + 8 bf16 / kpad + 16 bytes, mma.sync m16n8k16
// bf16 or m16n8k32 s8, two m16 tiles a warp, one output row of 32 pixels a
// warp, n8 tiles over the output channels) `reps` times over the same
// operands, and writes C once.  No staging from device memory, no
// epilogue but an optional sine: what is left is the rate at which the
// inner loop feeds the tensor cores.
//
// The Hopper counterpart of the Pallas dot probes in the repository's
// tools/ (im2col_probe.py: 9 per-tap dots against one concatenated-K dot;
// planar_diag2.py: the sine epilogue, chunked accumulators, one K = 768
// bf16 and int8 dot, the dy3-shaped dots; planar_diag3.py: the M sweep
// and the merged dots; planar_diag4.py: M / K / th / nrep): the TPU's
// dot shapes are re-asked as the parameters of this loop:
//   A: tiles of (rows + taps_h - 1) x (32 + taps_w - 1) pixels x kt
//      channels, a halo tile as the stage kernel stages it; tap (dy, dx)
//      reads the window shifted by (dy, dx), so 3 x 3 taps are the
//      per-tap conv (K = 9 x kpad) and 1 x 1 taps one flat dot (im2col,
//      K = kpad once);
//   B: [taps][n][kt], n <= 64 output channels;
//   C[tile][m][n] = reps * sum_tap A_tap[m] . B[tap][n] (float32; int8
//      sums are converted), or sin(alpha * that) with act 1;
//   NTC: n8 tiles of accumulators a pass over K holds (8: all, as in
//      production; 2 and 4 re-read A per chunk of N).
// Block i computes tile i % tiles and stores it only for i < tiles, so a
// launch of more blocks than tiles fills the card with the same work.

#include <type_traits>

#include "stage_conv.cuh"
#include "stage_conv_i8.cuh"

namespace {

struct GemmParams {
  const void* a;     // [tiles, rows + taps_h - 1, 32 + taps_w - 1, kt]
  const void* b;     // [taps_h * taps_w, n, kt]
  float* c;          // [tiles, 32 * rows, n]
  int tiles, rows, taps_h, taps_w;
  int kt, kpad;      // channels per tap, rounded up to the MMA's K step
  int pitch;         // shared-memory row pitch (elements)
  int n, nw;         // output channels, rounded up to 8
  int act;           // 0: C; 1: sin(alpha * C)
  float alpha;
  int reps;
};

template <typename E>
__device__ __forceinline__ E zero() {
  if constexpr (std::is_same_v<E, int8_t>) {
    return 0;
  } else {
    return __float2bfloat16(0.0f);
  }
}

template <bool I8, int NTC>
__global__ void __launch_bounds__(8 * 32)
gemm_probe_kernel(const GemmParams p) {
  using E = std::conditional_t<I8, int8_t, __nv_bfloat16>;
  using Acc = std::conditional_t<I8, int, float>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cols = TW + p.taps_w - 1;
  const int a_pix = (p.rows + p.taps_h - 1) * cols;
  const int taps = p.taps_h * p.taps_w;
  E* s_a = reinterpret_cast<E*>(smem_raw);
  E* s_b = s_a + a_pix * p.pitch;
  const int tile = blockIdx.x % p.tiles;
  const E* a = static_cast<const E*>(p.a) + (size_t)tile * a_pix * p.kt;
  const E* b = static_cast<const E*>(p.b);
  for (int i = threadIdx.x; i < a_pix * p.kpad; i += blockDim.x) {
    const int pix = i / p.kpad, c = i - pix * p.kpad;
    s_a[pix * p.pitch + c] = c < p.kt ? a[(size_t)pix * p.kt + c] : zero<E>();
  }
  for (int i = threadIdx.x; i < taps * p.nw * p.kpad; i += blockDim.x) {
    const int row = i / p.kpad, c = i - row * p.kpad;  // tap * nw + n
    const int tap = row / p.nw, n = row - tap * p.nw;
    s_b[row * p.pitch + c] = (n < p.n && c < p.kt)
                                 ? b[((size_t)tap * p.n + n) * p.kt + c]
                                 : zero<E>();
  }
  __syncthreads();

  // the fragments at the byte offsets of both kernels: A rows g and g + 8,
  // bytes tg * 4 and 16 + tg * 4 of each 32-byte K step; B column g
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int pitch = p.pitch * (int)sizeof(E);   // bytes
  const int kbytes = p.kpad * (int)sizeof(E);
  const unsigned char* sa = reinterpret_cast<const unsigned char*>(s_a);
  const unsigned char* sb = reinterpret_cast<const unsigned char*>(s_b);
  const int nt = p.nw >> 3;
  for (int j0 = 0; j0 < nt; j0 += NTC) {
    Acc acc[2][NTC][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < NTC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0;
    for (int rep = 0; rep < p.reps; ++rep) {
      for (int tap = 0; tap < taps; ++tap) {
        const int dy = tap / p.taps_w, dx = tap % p.taps_w;
        const unsigned char* a_base =
            sa + ((warp + dy) * cols + dx + g) * pitch + tg * 4;
        const unsigned char* b_base =
            sb + (tap * p.nw + j0 * 8 + g) * pitch + tg * 4;
        for (int k0 = 0; k0 < kbytes; k0 += 32) {
          uint32_t af[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const unsigned char* ap = a_base + mt * 16 * pitch + k0;
            af[mt][0] = ld32(ap);
            af[mt][1] = ld32(ap + 8 * pitch);
            af[mt][2] = ld32(ap + 16);
            af[mt][3] = ld32(ap + 8 * pitch + 16);
          }
#pragma unroll
          for (int j = 0; j < NTC; ++j) {
            if (j0 + j < nt) {
              const unsigned char* bp = b_base + j * 8 * pitch + k0;
              const uint32_t bfr[2] = {ld32(bp), ld32(bp + 16)};
              if constexpr (I8) {
                mma_s8(acc[0][j], af[0], bfr);
                mma_s8(acc[1][j], af[1], bfr);
              } else {
                mma_bf16(acc[0][j], af[0], bfr);
                mma_bf16(acc[1][j], af[1], bfr);
              }
            }
          }
        }
      }
    }
    if (blockIdx.x >= p.tiles) continue;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < NTC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = warp * 32 + mt * 16 + g + (e >> 1) * 8;
          const int n = (j0 + j) * 8 + tg * 2 + (e & 1);
          if (j0 + j >= nt || n >= p.n) continue;
          float v = static_cast<float>(acc[mt][j][e]);
          if (p.act) v = sin_reduced(v * p.alpha);
          p.c[((size_t)tile * 32 * p.rows + m) * p.n + n] = v;
        }
  }
}

using GemmKernel = void (*)(const GemmParams);

GemmKernel gemm_kernel(int i8, int n_chunk) {
  if (i8) return n_chunk == 8 ? gemm_probe_kernel<true, 8> : nullptr;
  switch (n_chunk) {
    case 2: return gemm_probe_kernel<false, 2>;
    case 4: return gemm_probe_kernel<false, 4>;
    case 8: return gemm_probe_kernel<false, 8>;
    default: return nullptr;
  }
}

GemmParams gemm_params(int rows, int taps_h, int taps_w, int kt, int n,
                       int i8) {
  GemmParams p{};
  p.rows = rows;
  p.taps_h = taps_h;
  p.taps_w = taps_w;
  p.kt = kt;
  p.kpad = i8 ? (kt + 31) / 32 * 32 : (kt + 15) / 16 * 16;
  p.pitch = p.kpad + (i8 ? 16 : 8);
  p.n = n;
  p.nw = (n + 7) / 8 * 8;
  return p;
}

int gemm_smem(const GemmParams& p, int i8) {
  const int a_pix = (p.rows + p.taps_h - 1) * (TW + p.taps_w - 1);
  const int rows = a_pix + p.taps_h * p.taps_w * p.nw;
  return rows * p.pitch * (i8 ? 1 : 2);
}

}  // namespace

extern "C" {

// Shared memory of one block (bytes), or -1 for a shape the probe does not
// take: rows outside 1..8, n outside 1..64, taps outside 1..3 a side, or
// more than the card's shared memory.
int bnt_gemm_probe_smem(int rows, int taps_h, int taps_w, int kt, int n,
                        int i8) {
  if (rows < 1 || rows > 8 || n < 1 || n > BN || kt < 1 || taps_h < 1 ||
      taps_h > 3 || taps_w < 1 || taps_w > 3)
    return -1;
  const int smem = gemm_smem(gemm_params(rows, taps_h, taps_w, kt, n, i8), i8);
  return smem > MAX_SMEM ? -1 : smem;
}

// Blocks that fill the card at once (SMs x blocks per SM), or -1.
int bnt_gemm_probe_fill(int rows, int taps_h, int taps_w, int kt, int n,
                        int i8, int n_chunk) {
  const int smem = bnt_gemm_probe_smem(rows, taps_h, taps_w, kt, n, i8);
  const GemmKernel k = gemm_kernel(i8, n_chunk);
  if (smem < 0 || !k) return -1;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, rows * 32,
                                                    smem) != cudaSuccess)
    return -1;
  return sms * per_sm;
}

// One launch of `grid` blocks (>= tiles) over `tiles` A tiles on the given
// stream: bf16 (i8 = 0) or int8 operands, n_chunk in {2, 4, 8} (int8: 8),
// act 1 for the sine epilogue.  Returns cudaErrorInvalidValue for a shape
// the probe does not take, else cudaGetLastError() after the launch.
int bnt_gemm_probe(const void* a, const void* b, void* c, int tiles,
                   int grid, int rows, int taps_h, int taps_w, int kt, int n,
                   int i8, int n_chunk, int act, float alpha, int reps,
                   void* stream) {
  const int smem = bnt_gemm_probe_smem(rows, taps_h, taps_w, kt, n, i8);
  const GemmKernel k = gemm_kernel(i8, n_chunk);
  if (smem < 0 || !k || tiles < 1 || grid < tiles || reps < 1)
    return cudaErrorInvalidValue;
  GemmParams p = gemm_params(rows, taps_h, taps_w, kt, n, i8);
  p.a = a;
  p.b = b;
  p.c = static_cast<float*>(c);
  p.tiles = tiles;
  p.act = act;
  p.alpha = alpha;
  p.reps = reps;
  const cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  k<<<grid, rows * 32, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

}  // extern "C"
