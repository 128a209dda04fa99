// The Hopper bf16 conv kernel, conv_sm90_kernel<NS> (see conv_sm90.cu for
// what it computes, what bounds it and its C entry points): a persistent,
// warp-specialised implicit GEMM over 4 x 64-pixel output tiles.
//
// Block: NWG (1 or 2) consumer warpgroups, then one producer warp.
//   producer (lane 0): per tile, one bulk copy (TMA, cp.async.bulk) per
//     in-image input row of the halo'd tile: the flat byte span of that
//     row's pixels, widened to 16-byte bounds, into the raw buffer (a
//     full/empty mbarrier pair: the next tile's rows land while the
//     consumers compute on the operand tile); and the packed weights, as
//     blocks of one (N slice, tap), into a ring of WS buffers: loaded once
//     when every block of the launch fits (resident), else streamed per
//     tile.
//   consumers: repack the raw rows into the operand tile s_pad (prologue
//     affine on in-image taps, zero padding, zero channels beyond Cin),
//     laid out [channel group of 8][pixel][8]; then for every N slice of
//     NS channels and every tap, wgmma m64nNSk16 with both operands in
//     shared memory through no-swizzle K-major descriptors (fp32
//     accumulators): A is the 64 pixels of one output row shifted by the
//     tap, B the weight block; the epilogue stores each slice.
// In s_pad's layout the 8 pixels of an 8 x 16-byte core matrix are
// consecutive pixels of a tile row, so a tap's shift (dy, dx) is only a
// start address (dy * PW + dx pixels): the descriptor takes any 16-byte
// start, and a shifted A needs no copy and no register staging.
// Warpgroup g owns tile rows 2g and 2g + 1 (one m64 tile each; warp w of
// the group holds columns 16w..16w+15 of the accumulators).
//
// The kernel's template parameter P is the phase mask of stage_common.cuh:
// PHASE_ALL in production (conv_sm90.cu), a knockout in the probe units
// (conv_sm90_probe*.cu, K5), where STAGE is the consumers' repack (the
// producer's copies still run).  The kernel and its helpers live in an
// anonymous namespace, so that each unit's instances carry its file's name
// (boosting_nerv_torch/tools/probes.py tells probe instances by it).

#pragma once

#include "stage_common.cuh"

namespace sm90 {

constexpr int TW = 64;                // output columns per tile: one m64
constexpr int ROWS_PER_WG = 2;        // output rows per consumer warpgroup
constexpr int MAX_CIN_PAD = 128;
constexpr int MAX_WS = 8;             // weight ring depth when streamed
constexpr int PRODUCER = 32;          // producer threads (one warp)

struct Params {
  const __nv_bfloat16* x;          // [N, H, W, Cin]
  const __nv_bfloat16* wpk;        // [slice][tap][kstep][NS/8][2][8][8]
  const __nv_bfloat16* bias;       // [Cout]
  const float* in_scale;           // [Cin] or null
  const float* in_shift;           // [Cin] or null
  const float* out_scale;          // [Cout] or null, after the activation
  const float* out_shift;          // [Cout] or null
  const __nv_bfloat16* residual;   // output-shaped or null
  const float* out_inv;            // [stored channels] or null: int8 out
  void* out;                       // [N, H, W, Cout] or [N, 2H, 2W, Cout/4]
  int n, h, w, cin, cout, act, shuffle, ks;
  int cin_pad, nslices, nwg;       // K per tap, N slices, warpgroups
  int ws, resident;                // weight ring depth; loaded once
  int raw_pitch;                   // bytes per raw row slot
  int tiles_w, tiles_h;
};

// Shared-memory carve-up of one launch (offsets in bytes).
struct Layout {
  int pad, raw, wgt, stage, bars, total;
};

__host__ __device__ inline int tile_h(int nwg) { return ROWS_PER_WG * nwg; }

__host__ __device__ inline int wblock_bytes(int ns, int cin_pad) {
  return ns * cin_pad * 2;
}

// Pixels from one 8-channel group of s_pad to the next: the tile's pixel
// count rounded to 1 modulo 8, so that the eight groups a warp's repack
// stores touch lie in distinct banks.
__host__ __device__ inline int group_stride(int ks, int nwg) {
  return (tile_h(nwg) + ks - 1) * (TW + ks - 1) / 8 * 8 + 9;
}

__host__ __device__ inline Layout layout(int ks, int cin_pad, int raw_pitch,
                                         int nwg, int ws, int ns) {
  const int ph = tile_h(nwg) + ks - 1;
  Layout l;
  l.pad = 0;
  l.raw = (cin_pad / 8 * group_stride(ks, nwg) * 16 + 127) / 128 * 128;
  l.wgt = l.raw + ph * raw_pitch;
  l.stage = l.wgt + ws * wblock_bytes(ns, cin_pad);
  l.bars = l.stage + nwg * TW * (ns + 4) * 4;
  l.total = l.bars + 2 * (1 + ws) * 8;
  return l;
}

namespace {

// ---------------------------------------------------------------- PTX ---

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
// A wait that never ends traps (the launch fails) instead of hanging.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 30)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

// One bulk copy (TMA, no tensor map) of `bytes` (a multiple of 16, both
// addresses 16-byte aligned) from device memory into shared memory,
// completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void consumer_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" :: "r"(threads) : "memory");
}

// The 128 threads of consumer warpgroup wg (named barrier 2 + wg).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(2 + wg) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Orders this thread's generic-proxy shared-memory writes before the
// async proxy's (wgmma's) reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keeps the accumulators in place across the asynchronous wgmma.
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}

// A no-swizzle K-major wgmma descriptor: 8 x 16-byte core matrices, the two
// K halves of a k16 step `lbo` bytes apart (leading byte offset), the
// 8-row groups along M or N `sbo` bytes apart (stride byte offset).
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                        uint32_t sbo) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32);
}

// wgmma m64nNk16, bf16 x bf16 -> fp32, both operands K-major from shared
// memory: d += A * B.
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_ss<8>(float* d, uint64_t a,
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<56>(float* d, uint64_t a,
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %30, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27"
      "}, %28, %29, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t a,
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<80>(float* d, uint64_t a,
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39"
      "}, %40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(a), "l"(b), "r"(1));
}


// The 16-byte-aligned bulk copy of input row iy (image b), columns
// [xs, xe): its source, its length, and where the row's first element
// lies in it (elements).
struct Span {
  const unsigned char* src;
  uint32_t bytes;
  int mis;
};

__device__ __forceinline__ Span row_span(const Params& p, int b, int iy,
                                         int xs, int xe) {
  const size_t row = ((size_t)b * p.h + iy) * p.w;
  const uintptr_t a0 =
      reinterpret_cast<uintptr_t>(p.x + (row + xs) * p.cin);
  const uintptr_t a1 =
      reinterpret_cast<uintptr_t>(p.x + (row + xe) * p.cin);
  const uintptr_t lo = a0 & ~uintptr_t(15);
  const uintptr_t hi = (a1 + 15) & ~uintptr_t(15);
  return {reinterpret_cast<const unsigned char*>(lo),
          static_cast<uint32_t>(hi - lo), static_cast<int>((a0 - lo) >> 1)};
}

struct TileAt {
  int b, ty0, tx0;
};

__device__ __forceinline__ TileAt tile_at(const Params& p, int tile) {
  const int tiles_hw = p.tiles_w * p.tiles_h;
  const int r = tile % tiles_hw;
  return {tile / tiles_hw, r / p.tiles_w * tile_h(p.nwg),
          r % p.tiles_w * TW};
}

// Ring position: slot and the parity of its current round.
struct Ring {
  int slot = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next(int depth) {
    if (++slot == depth) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// The producer warp's lane 0: raw input rows of every tile of this block,
// and the weight blocks (once if resident, else per tile).
__device__ __forceinline__ void produce(const Params& p, const Layout& L,
                                        unsigned char* smem, int ns) {
  const int ph = tile_h(p.nwg) + p.ks - 1, pw = TW + p.ks - 1;
  const int halo = (p.ks - 1) / 2;
  const int tiles = p.tiles_w * p.tiles_h * p.n;
  const uint32_t wbytes = wblock_bytes(ns, p.cin_pad);
  const int kblocks = p.nslices * p.ks * p.ks;
  uint64_t* full_raw = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty_raw = full_raw + 1;
  uint64_t* full_w = empty_raw + 1;
  uint64_t* empty_w = full_w + p.ws;
  const unsigned char* wpk = reinterpret_cast<const unsigned char*>(p.wpk);
  if (p.resident) {
    for (int kb = 0; kb < kblocks; ++kb) {
      bar_expect(&full_w[kb], wbytes);
      bulk_load(smem + L.wgt + kb * wbytes, wpk + (size_t)kb * wbytes,
                wbytes, &full_w[kb]);
    }
  }
  Ring wr;
  uint32_t raw_phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const TileAt t = tile_at(p, tile);
    const int xs = max(t.tx0 - halo, 0), xe = min(t.tx0 - halo + pw, p.w);
    const int y0 = max(t.ty0 - halo, 0), y1 = min(t.ty0 - halo + ph, p.h);
    bar_wait(empty_raw, raw_phase ^ 1);
    uint32_t total = 0;
    for (int iy = y0; iy < y1; ++iy)
      total += row_span(p, t.b, iy, xs, xe).bytes;
    bar_expect(full_raw, total);
    for (int iy = y0; iy < y1; ++iy) {
      const Span s = row_span(p, t.b, iy, xs, xe);
      bulk_load(smem + L.raw + (iy - t.ty0 + halo) * p.raw_pitch, s.src,
                s.bytes, full_raw);
    }
    raw_phase ^= 1;
    if (p.resident) continue;
    for (int kb = 0; kb < kblocks; ++kb) {
      bar_wait(&empty_w[wr.slot], wr.phase ^ 1);
      bar_expect(&full_w[wr.slot], wbytes);
      bulk_load(smem + L.wgt + wr.slot * wbytes, wpk + (size_t)kb * wbytes,
                wbytes, &full_w[wr.slot]);
      wr.next(p.ws);
    }
  }
}

// NS: output channels per N slice (the wgmma N).  Threads: 128 * p.nwg
// consumers, then one producer warp.
// The epilogue of one output row segment, element by element: the fp32
// sums of up to 64 pixels (tx0 + px, px < 64) x NS channels (n0 + ch) of
// row oy, staged in s_acc[px][ch] (pitch NS + 4, so that the
// accumulators' float2 stores hit distinct banks): + bias, activation ACT,
// output affine, + residual, a bf16 store or (Q) an int8-code store; warp
// wq of the warpgroup takes pixels wq, wq + 4, ..., its lanes consecutive
// channels, so that a pixel's stores are contiguous.  Each element's
// address is out_offset's.  This is the loop of the N 8 instances (the
// 3-channel head: three live lanes a warp), where epilogue_loop below
// measured a third slower on an H100 (the cause is not resolved).  ACT
// and Q are compile-time, so that the loop carries one activation's code
// and one store's.  Without PHASE_STORE in P the stores happen only under
// probe_store() (never).
template <int NS, int ACT, bool Q, int P>
__device__ __forceinline__ void epilogue_loop_elem(
    const float* s_acc, int b, int oy, int tx0, int n0, int wq, int lane,
    int h, int w, int cout, int shuffle, const __nv_bfloat16* residual,
    const float* out_inv, void* out, const float (&bias)[(NS + 31) / 32],
    const float (&mul)[(NS + 31) / 32], const float (&add)[(NS + 31) / 32]) {
  constexpr int CH = (NS + 31) / 32;
  const bool store = (P & PHASE_STORE) != 0 || probe_store();
  for (int px = wq; px < TW && tx0 + px < w; px += 4) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int ch = lane + 32 * c, n = n0 + ch;
      if (ch >= NS || n >= cout) continue;
      const size_t off = out_offset(b, oy, tx0 + px, n, h, w, cout, shuffle);
      float v = activate(s_acc[px * (NS + 4) + ch] + bias[c], ACT);
      v = v * mul[c] + add[c];
      if (residual) v += __bfloat162float(residual[off]);
      if (!store) continue;
      if constexpr (Q) {
        static_cast<int8_t*>(out)[off] =
            quant(v, out_inv[shuffle ? n >> 2 : n]);
      } else {
        static_cast<__nv_bfloat16*>(out)[off] = __float2bfloat16(v);
      }
    }
  }
}

// The epilogue of one output row segment as epilogue_loop_elem computes
// it, for N 56, 64 and 80: the sums of up to npx pixels (px < npx <= 64)
// of one output row.  Element (px, lane + 32 c) of the output and the
// residual lies at base + px * pstride + coff[c]: the addressing is two
// adds an element (coff[c] < 0 marks a channel beyond NS or Cout).  A
// warp takes two of its pixels at a time and issues both residual loads
// before either's arithmetic, so that two independent chains (loads,
// activation) are in flight and not one.
template <int NS, int ACT, bool Q, int P>
__device__ __forceinline__ void epilogue_loop(
    const float* s_acc, int npx, int wq, int lane, size_t base,
    size_t pstride, const long long (&coff)[(NS + 31) / 32],
    const int (&qch)[(NS + 31) / 32], const __nv_bfloat16* residual,
    const float* out_inv, void* out, const float (&bias)[(NS + 31) / 32],
    const float (&mul)[(NS + 31) / 32], const float (&add)[(NS + 31) / 32]) {
  constexpr int CH = (NS + 31) / 32;
  const bool store = (P & PHASE_STORE) != 0 || probe_store();
  constexpr int U = 2;
  for (int px0 = wq; px0 < npx; px0 += 4 * U) {
    float res[U][CH];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const size_t pix = base + (px0 + 4 * u) * pstride;
#pragma unroll
      for (int c = 0; c < CH; ++c)
        res[u][c] = residual && coff[c] >= 0 && px0 + 4 * u < npx
                        ? __bfloat162float(residual[pix + coff[c]])
                        : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int px = px0 + 4 * u;
      if (px >= npx) break;
      const size_t pix = base + px * pstride;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        if (coff[c] < 0) continue;
        const size_t off = pix + coff[c];
        float v = activate(s_acc[px * (NS + 4) + lane + 32 * c] + bias[c],
                           ACT);
        v = v * mul[c] + add[c];
        if (residual) v += res[u][c];
        if (!store) continue;
        if constexpr (Q) {
          static_cast<int8_t*>(out)[off] = quant(v, out_inv[qch[c]]);
        } else {
          static_cast<__nv_bfloat16*>(out)[off] = __float2bfloat16(v);
        }
      }
    }
  }
}

// The epilogue loop for launch p's activation and store, output row oy,
// pixels tx0.. of image b, channels n0..; for epilogue_loop it works out
// the row's base, the pixel stride and each lane's channel offsets
// (out_offset's arithmetic, PixelShuffle included) once.  Not inlined:
// one copy of the epilogue's code stays in the instruction cache.
// Without PHASE_EPI in P it stores the raw sums (no bias, activation,
// affine or residual).
template <int NS, int P>
__device__ __noinline__ void epilogue_row(const Params& p,
                                          const float* s_acc, int b, int oy,
                                          int tx0, int n0, int wq,
                                          int lane) {
  constexpr bool kEpi = (P & PHASE_EPI) != 0;
  // the fields this uses, read once: the stores could alias p
  const int h = p.h, w = p.w, cout = p.cout;
  const int act = kEpi ? p.act : ACT_NONE;
  const int shuffle = p.shuffle;
  const __nv_bfloat16* residual = kEpi ? p.residual : nullptr;
  const float* out_inv = p.out_inv;
  void* out = p.out;
  constexpr int CH = (NS + 31) / 32;
  float bias[CH], mul[CH], add[CH];
  long long coff[CH];
  int qch[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int n = n0 + lane + 32 * c;
    const bool ok = lane + 32 * c < NS && n < cout;
    const bool aff = kEpi && ok;
    bias[c] = aff ? __bfloat162float(p.bias[n]) : 0.0f;
    mul[c] = aff && p.out_scale ? p.out_scale[n] + 1.0f : 1.0f;
    add[c] = aff && p.out_shift ? p.out_shift[n] : 0.0f;
    const int cq = n >> 2, r1 = (n >> 1) & 1, r2 = n & 1;
    coff[c] = !ok ? -1
              : shuffle ? (long long)(r1 * 2 * w + r2) * (cout >> 2) + cq
                        : n;
    qch[c] = shuffle ? cq : n;
  }
  const size_t base = out_offset(b, oy, tx0, 0, h, w, cout, shuffle);
  const size_t pstride = shuffle ? 2 * (cout >> 2) : cout;
  const int npx = min(TW, w - tx0);
#define BNT_EPI(A, Q)                                                      \
  if constexpr (NS == 8)                                                   \
    epilogue_loop_elem<NS, A, Q, P>(s_acc, b, oy, tx0, n0, wq, lane, h, w, \
                                    cout, shuffle, residual, out_inv, out, \
                                    bias, mul, add);                       \
  else                                                                     \
    epilogue_loop<NS, A, Q, P>(s_acc, npx, wq, lane, base, pstride, coff,  \
                               qch, residual, out_inv, out, bias, mul, add)
  if (out_inv) {
    switch (act) {
      case ACT_SIN: BNT_EPI(ACT_SIN, true); break;
      case ACT_GELU: BNT_EPI(ACT_GELU, true); break;
      case ACT_OUTIMG: BNT_EPI(ACT_OUTIMG, true); break;
      default: BNT_EPI(ACT_NONE, true);
    }
  } else {
    switch (act) {
      case ACT_SIN: BNT_EPI(ACT_SIN, false); break;
      case ACT_GELU: BNT_EPI(ACT_GELU, false); break;
      case ACT_OUTIMG: BNT_EPI(ACT_OUTIMG, false); break;
      default: BNT_EPI(ACT_NONE, false);
    }
  }
#undef BNT_EPI
}

template <int NS, int P = PHASE_ALL>
__global__ void __launch_bounds__(2 * 128 + PRODUCER, 1)
conv_sm90_kernel(const __grid_constant__ Params p) {
  constexpr bool kStage = (P & PHASE_STAGE) != 0;
  constexpr bool kGemm = (P & PHASE_GEMM) != 0;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(p.ks, p.cin_pad, p.raw_pitch, p.nwg, p.ws, NS);
  const int consumers = 128 * p.nwg;
  const int cwarps = 4 * p.nwg;
  uint64_t* full_raw = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty_raw = full_raw + 1;
  uint64_t* full_w = empty_raw + 1;
  uint64_t* empty_w = full_w + p.ws;
  if (threadIdx.x == 0) {
    bar_init(full_raw, 1);
    bar_init(empty_raw, cwarps);
    for (int i = 0; i < p.ws; ++i) {
      bar_init(&full_w[i], 1);
      bar_init(&empty_w[i], cwarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= consumers) {
    if (threadIdx.x == consumers) produce(p, L, smem, NS);
    return;
  }

  const int ph = tile_h(p.nwg) + p.ks - 1, pw = TW + p.ks - 1;
  const int gs = group_stride(p.ks, p.nwg);
  const uint32_t lbo_a = gs * 16;  // next 8 channels of s_pad
  const int halo = (p.ks - 1) / 2;
  const int taps = p.ks * p.ks;
  const int nks = p.cin_pad / 16;
  const int tiles = p.tiles_w * p.tiles_h * p.n;
  const int wbytes = wblock_bytes(NS, p.cin_pad);
  __nv_bfloat16* s_pad = reinterpret_cast<__nv_bfloat16*>(smem + L.pad);
  const unsigned char* s_w = smem + L.wgt;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wq = warp & 3;
  const int g = lane >> 2, tq = lane & 3;

  // a lane repacks input channels 2 lane + 64c and the next; its
  // prologue affine
  float in_mul[2][2], in_add[2][2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int k = 2 * lane + 64 * c + e;
      const bool aff = p.in_scale != nullptr && k < p.cin;
      in_mul[c][e] = aff ? p.in_scale[k] + 1.0f : 1.0f;
      in_add[c][e] = aff ? p.in_shift[k] : 0.0f;
    }
  }

  if constexpr (!kStage) {  // probe: one zero operand tile, never repacked
    for (int i = threadIdx.x; i < L.raw / 16; i += consumers)
      reinterpret_cast<uint4*>(smem + L.pad)[i] = make_uint4(0, 0, 0, 0);
    fence_async_smem();
  }

  Ring wr;
  uint32_t raw_phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const TileAt t = tile_at(p, tile);
    const int xs = max(t.tx0 - halo, 0);

    // 1. repack the raw rows into s_pad, prologue on in-image taps only
    bar_wait(full_raw, raw_phase);
    consumer_sync(consumers);  // the previous tile's GEMM is done with s_pad
    const unsigned char* rbuf = smem + L.raw;
    for (int r = 0; r < (kStage ? ph : 0); ++r) {
      const int iy = t.ty0 - halo + r;
      const bool row_in = iy >= 0 && iy < p.h;
      // element of pixel ix of this row: row + ix * cin
      const __nv_bfloat16* row =
          reinterpret_cast<const __nv_bfloat16*>(rbuf + r * p.raw_pitch) +
          (row_in ? row_span(p, t.b, iy, xs, xs).mis : 0) - xs * p.cin;
      for (int c = warp; c < pw; c += cwarps) {
        const int ix = t.tx0 - halo + c;
        const bool inside = row_in && ix >= 0 && ix < p.w;
        const __nv_bfloat16* src = row + ix * p.cin;
        __nv_bfloat16* dst = s_pad + (r * pw + c) * 8;
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int k = 2 * lane + 64 * cc;
          if (k < p.cin_pad) {
            float v0 = 0.0f, v1 = 0.0f;
            if (inside && k < p.cin)
              v0 = __bfloat162float(src[k]) * in_mul[cc][0] + in_add[cc][0];
            if (inside && k + 1 < p.cin)
              v1 = __bfloat162float(src[k + 1]) * in_mul[cc][1] +
                   in_add[cc][1];
            *reinterpret_cast<__nv_bfloat162*>(
                dst + (k >> 3) * gs * 8 + (k & 7)) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
    fence_async_smem();
    __syncwarp();
    if (lane == 0) bar_arrive(empty_raw);
    raw_phase ^= 1;
    consumer_sync(consumers);  // s_pad is complete

    // 2. per N slice: implicit GEMM over the taps, then the epilogue
    for (int s = 0; s < p.nslices; ++s) {
      float acc[2][NS / 2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int i = 0; i < NS / 2; ++i) acc[mt][i] = 0.0f;

      int held = -1;  // the streamed weight slot the last tap read
      for (int tap = 0; tap < taps; ++tap) {
        const unsigned char* wblk;
        int slot = -1;
        if (p.resident) {
          const int kb = s * taps + tap;
          bar_wait(&full_w[kb], 0);
          wblk = s_w + kb * wbytes;
        } else {
          bar_wait(&full_w[wr.slot], wr.phase);
          slot = wr.slot;
          wblk = s_w + slot * wbytes;
          wr.next(p.ws);
        }
        if constexpr (kGemm) {
          const int dy = tap / p.ks, dx = tap - dy * p.ks;
          const __nv_bfloat16* a0 =
              s_pad + ((wg * ROWS_PER_WG + dy) * pw + dx) * 8;
          wgmma_fence();
          for (int k = 0; k < nks; ++k) {
            const uint64_t db = desc(wblk + k * NS * 32, 128, 256);
            const __nv_bfloat16* ak = a0 + 2 * k * gs * 8;
            wgmma_ss<NS>(acc[0], desc(ak, lbo_a, 128), db);
            wgmma_ss<NS>(acc[1], desc(ak + pw * 8, lbo_a, 128), db);
          }
          wgmma_commit();
          if (slot >= 0) {
            // the previous tap's wgmmas are done: release its weight slot
            wgmma_wait<1>();
            if (held >= 0 && lane == 0) bar_arrive(&empty_w[held]);
            held = slot;
          }
        } else if (slot >= 0 && lane == 0) {  // probe: acc stays 0
          bar_arrive(&empty_w[slot]);
        }
      }
      if constexpr (kGemm) wgmma_wait<0>();
      if (held >= 0 && lane == 0) bar_arrive(&empty_w[held]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int i = 0; i < NS / 2; ++i) fence_reg(acc[mt][i]);

      // epilogue: bias, activation, output affine, residual, store
      const int n0 = s * NS;
      // each m64 tile (one row) through this warpgroup's staging rows
      float* s_acc = reinterpret_cast<float*>(smem + L.stage) +
                     wg * TW * (NS + 4);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int oy = t.ty0 + wg * ROWS_PER_WG + mt;
        if (oy >= p.h) continue;  // uniform over the warpgroup
#pragma unroll
        for (int i = 0; i < NS / 2; i += 2) {
          const int j = i >> 2, e = i & 3;
          const int px = wq * 16 + g + (e >> 1) * 8;
          *reinterpret_cast<float2*>(s_acc + px * (NS + 4) + j * 8 +
                                     tq * 2) =
              make_float2(acc[mt][i], acc[mt][i + 1]);
        }
        wg_sync(wg);
        epilogue_row<NS, P>(p, s_acc, t.b, oy, t.tx0, n0, wq, lane);
        wg_sync(wg);
      }
    }
  }
}

// ------------------------------------------------------------- host ---

// Bytes of one raw row slot: the widest row span plus its 16-byte
// widening, rounded up to 16.
inline int raw_pitch(int ks, int cin) {
  return ((TW + ks - 1) * cin * 2 + 30 + 15) / 16 * 16;
}

// The shared-memory plan of a launch: warpgroups (2, else 1) and the
// weight ring (every block resident, else the deepest ring up to MAX_WS
// that fits, at least 2).  Fills p and returns the bytes, or -1 where
// nothing fits.
inline int fit(Params& p, int ns) {
  const int kblocks = p.nslices * p.ks * p.ks;
  for (int nwg = 2; nwg >= 1; --nwg) {
    for (int ws = kblocks; ws >= 1;) {
      const Layout l = layout(p.ks, p.cin_pad, p.raw_pitch, nwg, ws, ns);
      if (l.total <= MAX_SMEM) {
        p.nwg = nwg;
        p.ws = ws;
        p.resident = ws == kblocks;
        return l.total;
      }
      ws = ws == kblocks ? std::min(kblocks - 1, MAX_WS) : ws - 1;
      if (ws < 2) break;
    }
  }
  return -1;
}

inline bool valid_ns(int ns) {
  return ns == 8 || ns == 56 || ns == 64 || ns == 80;
}

// Fills the shape fields of p; false for a shape the kernel does not take.
inline bool shape(Params& p, int cin, int cout, int ks, int ns) {
  p.cin = cin;
  p.cout = cout;
  p.ks = ks;
  p.cin_pad = (cin + 15) / 16 * 16;
  p.nslices = (cout + ns - 1) / ns;
  p.raw_pitch = raw_pitch(ks, cin);
  return (ks == 1 || ks == 3 || ks == 5) && cin >= 1 && cout >= 1 &&
         p.cin_pad <= MAX_CIN_PAD && valid_ns(ns);
}

// Fills p from a C entry point's arguments and plans its shared memory:
// the bytes, or -1 for a launch the kernel does not take.
inline int prepare(Params& p, const void* x, const void* wpk,
                   const void* bias, const void* in_scale,
                   const void* in_shift, const void* out_scale,
                   const void* out_shift, const void* residual,
                   const void* out_inv, void* out, int n, int h, int w,
                   int cin, int cout, int act, int shuffle, int ks, int ns) {
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.wpk = static_cast<const __nv_bfloat16*>(wpk);
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
  p.w = w;
  p.act = act;
  p.shuffle = shuffle;
  if (!shape(p, cin, cout, ks, ns) || n < 1 || h < 1 || w < 1 ||
      (shuffle && cout % 4 != 0) || act < ACT_NONE || act > ACT_OUTIMG ||
      (reinterpret_cast<uintptr_t>(wpk) & 15) != 0)
    return -1;
  const int smem = fit(p, ns);
  p.tiles_w = (w + TW - 1) / TW;
  p.tiles_h = smem < 0 ? 0 : (h + tile_h(p.nwg) - 1) / tile_h(p.nwg);
  return smem;
}

template <int NS, int P>
int launch(const Params& p, int smem, cudaStream_t s) {
  auto kernel = conv_sm90_kernel<NS, P>;
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  const int threads = 128 * p.nwg + PRODUCER;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return err;
  const int tiles = p.tiles_w * p.tiles_h * p.n;
  const int blocks = std::max(1, std::min(tiles, sms * std::max(per_sm, 1)));
  kernel<<<blocks, threads, smem, s>>>(p);
  return cudaGetLastError();
}

// The knockout instance <NS, mask> of a probe launch (K5); mask is one of
// PROBE_MASKS.
constexpr int PROBE_MASKS[] = {
    PHASE_ALL, PHASE_ALL & ~PHASE_STAGE, PHASE_ALL & ~PHASE_GEMM,
    PHASE_ALL & ~PHASE_EPI, PHASE_ALL & ~PHASE_STORE};

template <int NS, int I = 0>
int launch_masked(int phases, const Params& p, int smem, cudaStream_t s) {
  if constexpr (I < 5) {
    if (phases == PROBE_MASKS[I])
      return launch<NS, PROBE_MASKS[I]>(p, smem, s);
    return launch_masked<NS, I + 1>(phases, p, smem, s);
  } else {
    return cudaErrorInvalidValue;
  }
}

}  // namespace

// K5 probe launches at N slice 8, 56, 64, 80 with the phase mask
// `phases`, each defined by its own probe unit (conv_sm90_probe*.cu), so
// that their instances compile in parallel.
int launch_probe_8(const Params& p, int smem, int phases, cudaStream_t s);
int launch_probe_56(const Params& p, int smem, int phases, cudaStream_t s);
int launch_probe_64(const Params& p, int smem, int phases, cudaStream_t s);
int launch_probe_80(const Params& p, int smem, int phases, cudaStream_t s);

}  // namespace sm90
