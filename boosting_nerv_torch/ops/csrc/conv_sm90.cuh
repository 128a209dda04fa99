// The Hopper conv kernel, conv_sm90_kernel<NS, P, F, R> (see conv_sm90.cu
// for what it computes, what bounds it and its C entry points, and
// conv_sm90_i8.cu for its int8 form): a persistent, warp-specialised
// implicit GEMM over 4 x 64-pixel output tiles.
//
// F is the operand form (Form): bf16 operands (FORM_BF16, fp32 sums), or
// int8 operands (wgmma s8, int32 sums dequantised per output channel in
// the epilogue) repacked from int8 codes (FORM_S8) or from a bf16 input
// quantised in the repack (FORM_S8Q).  Both forms' operand tiles and
// weight blocks are 16-byte core matrices: a k16 step of bf16 spans the
// bytes of a k32 step of s8, so the layouts and the descriptors' leading
// and stride byte offsets are the same; only the channels per 16-byte
// group (8 or 16) differ.  R is the output rows per consumer warpgroup
// (2, or 3 at N 64 in the int8 form: ROWS_S8_64).
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
//     affine on in-image taps, zero padding, zero channels beyond Cin;
//     in FORM_S8Q then the quantisation), laid out [16-byte channel
//     group][pixel][16 bytes]; then for every N slice of NS channels and
//     every tap, wgmma m64nNSk16 (bf16) or m64nNSk32 (s8) with both
//     operands in shared memory through no-swizzle K-major descriptors
//     (fp32 or s32 accumulators): A is the 64 pixels of one output row
//     shifted by the tap, B the weight block; the epilogue stores each
//     slice.
// In s_pad's layout the 8 pixels of an 8 x 16-byte core matrix are
// consecutive pixels of a tile row, so a tap's shift (dy, dx) is only a
// start address (dy * PW + dx pixels): the descriptor takes any 16-byte
// start, and a shifted A needs no copy and no register staging.
// Warpgroup g owns tile rows R g .. R g + R - 1 (one m64 tile each; warp w
// of the group holds columns 16w..16w+15 of the accumulators).
//
// The kernel's template parameter P is the phase mask of stage_common.cuh:
// PHASE_ALL in production (conv_sm90.cu), a knockout in the probe units
// (conv_sm90_probe*.cu, K5), where STAGE is the consumers' repack (the
// producer's copies still run).  The kernel and its helpers live in an
// anonymous namespace, so that each unit's instances carry its file's name
// (boosting_nerv_torch/tools/probes.py tells probe instances by it).
//
// M is the mode of a bf16 launch (Mode, MODE_NONE by default, which leaves
// the other instances' code as it was): the sine of the staged input
// (MODE_SIN_INPUT: sin(x) * (scale + 1) + shift on in-image taps) or of
// the residual (MODE_SIN_RESIDUAL), the two launches of the ResBlockSFT
// whose block input is sin(x) (conv_sm90_sin.cu); or the planar layout
// (MODE_PLANAR_IN: the input is a planar tensor, staged by one 4-D TMA
// tensor copy a tile; MODE_PLANAR_OUT: the residual is read from and the
// output stored into planar tensors), the two launches of the planar
// ResBlockSFT, and both at once (MODE_PLANAR_IO: planar input staged as
// MODE_PLANAR_IN's, planar store as MODE_PLANAR_OUT's, with an activation
// and no residual), the planar conv (conv_sm90_planar.cu).  A planar
// tensor (4 Cp, Hc, Wd) holds the fine (C, 2 hc, 2 wc) one as
// planar[(2 r1 + r2) Cp + c, y, x] = fine[c, 2 y + r1, 2 x + r2].
// MODE_KLOOP takes an input of more than MAX_CIN_PAD channels (padded, up
// to MAX_CIN_KLOOP) in bf16 with every epilogue option of MODE_NONE: a K
// loop over chunks of KC input channels inside the kernel
// (consume_kloop; conv_sm90_kloop.cu).

#pragma once

#include <cuda.h>

#include <type_traits>

#include "stage_common.cuh"

namespace sm90 {

constexpr int TW = 64;                // output columns per tile: one m64
constexpr int ROWS_PER_WG = 2;        // output rows per consumer warpgroup
constexpr int ROWS_S8_64 = 3;         // the int8 form's at N 64 (rows_of)
constexpr int MAX_CIN_PAD = 128;
constexpr int MAX_CIN_KLOOP = 256;    // MODE_KLOOP's Cin (padded to 16)
constexpr int KC = 64;                // MODE_KLOOP's input channels a chunk
constexpr int MAX_WS = 8;             // weight ring depth when streamed
constexpr int PRODUCER = 32;          // producer threads (one warp)

// The operand form of a launch (the kernel's template parameter F).
enum Form { FORM_BF16 = 0, FORM_S8 = 1, FORM_S8Q = 2 };

// Bytes of one operand element and of one input element of form f.
__host__ __device__ constexpr int op_bytes(int f) {
  return f == FORM_BF16 ? 2 : 1;
}
__host__ __device__ constexpr int in_bytes(int f) {
  return f == FORM_S8 ? 1 : 2;
}

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

// An int8-form launch: Params with x int8 codes (FORM_S8) or bf16
// (FORM_S8Q), wpk int8 codes [slice][tap][k32 step][NS/8][2][8][16] and
// bias unused, and
struct ParamsS8 : Params {
  const float* dq_scale;           // [Cout] dequant scale of the sums
  const float* dq_bias;            // [Cout] float32 bias
  const float* in_inv;             // [Cin] quantisation multiplier (S8Q)
};

// The mode of a bf16 launch (the kernel's template parameter M).
enum Mode {
  MODE_NONE = 0,
  MODE_SIN_INPUT = 1,
  MODE_SIN_RESIDUAL = 2,
  MODE_PLANAR_IN = 3,
  MODE_PLANAR_OUT = 4,
  MODE_PLANAR_IO = 5,
  MODE_KLOOP = 6
};

__host__ __device__ constexpr bool planar_mode(int m) {
  return m == MODE_PLANAR_IN || m == MODE_PLANAR_OUT || m == MODE_PLANAR_IO;
}

// A mode that stages a planar input (its box through the tensor map) /
// stores into a planar output (its sums staged transposed).
__host__ __device__ constexpr bool planar_in(int m) {
  return m == MODE_PLANAR_IN || m == MODE_PLANAR_IO;
}
__host__ __device__ constexpr bool planar_out(int m) {
  return m == MODE_PLANAR_OUT || m == MODE_PLANAR_IO;
}

// A planar launch (3 x 3 only): Params with h x w the fine grid (n = 1),
// and, in MODE_PLANAR_IN, x the planar input, read only through tmap (the
// box of one tile: planar_rows(nwg) rows of PBX columns, all Cin channels
// and 4 planes; zero beyond the real region); in MODE_PLANAR_OUT,
// residual and out planar tensors of cp channels a plane, hc x wd.
struct ParamsPlanar : Params {
  CUtensorMap tmap;                // the planar-input modes only
  int cp, hc, wd;
};

// A MODE_PLANAR_IO launch: ParamsPlanar with x the planar input of cp
// channels a plane (read through tmap, as in MODE_PLANAR_IN) and out a
// planar output of cpo, both hc x wd.  A struct of its own, so that the
// other planar instances' parameters stay as they were.
struct ParamsPlanarIO : ParamsPlanar {
  int cpo;
};

// A MODE_KLOOP launch: Params with cin_pad the channels of one chunk
// (KC: the operand tile and a weight ring slot hold one chunk's) and raw
// rows of all Cin channels, and
struct ParamsKloop : Params {
  int cin_all;                     // Cin padded to KC: the conv's K
  int nkc;                         // chunks of KC channels
};

template <int F, int M = MODE_NONE>
using ParamsOf = std::conditional_t<
    F == FORM_BF16,
    std::conditional_t<
        M == MODE_PLANAR_IO, ParamsPlanarIO,
        std::conditional_t<
            planar_mode(M), ParamsPlanar,
            std::conditional_t<M == MODE_KLOOP, ParamsKloop, Params>>>,
    ParamsS8>;

// The chunk that slice s of a MODE_KLOOP tile takes cc-th: even slices
// walk the chunks forward, odd ones backward, so that a slice starts on
// the chunk its predecessor ended on, which the operand tile still holds.
__host__ __device__ inline int chunk_at(int s, int cc, int nkc) {
  return s & 1 ? nkc - 1 - cc : cc;
}

// Planar columns of a MODE_PLANAR_IN box: a tile's TW + 2 fine columns
// span planar columns tx0 / 2 - 1 .. tx0 / 2 + TW / 2; a tensor copy's
// innermost start must lie on 16 bytes (an H100 faults on an illegal
// instruction otherwise), so the box starts PBX_LEAD columns earlier, at
// tx0 / 2 - 8, and spans PBX, a multiple of 16 bytes.
constexpr int PBX_LEAD = 8;
constexpr int PBX = 48;

// Planar rows of a MODE_PLANAR_IN box at nwg warpgroups of ROWS_PER_WG
// rows: the tile's fine rows and their halo, ty0 - 1 .. ty0 + tile rows.
__host__ __device__ inline int planar_rows(int nwg) {
  return ROWS_PER_WG * nwg / 2 + 2;
}

// Shared-memory carve-up of one launch (offsets in bytes).
struct Layout {
  int pad, raw, wgt, stage, bars, total;
};

__host__ __device__ inline int tile_h(int nwg, int rows = ROWS_PER_WG) {
  return rows * nwg;
}

// e: the bytes of one operand element (op_bytes).
__host__ __device__ inline int wblock_bytes(int ns, int cin_pad, int e = 2) {
  return ns * cin_pad * e;
}

// Pixels from one 16-byte channel group of s_pad to the next: the tile's
// pixel count rounded to 1 modulo 8, so that the eight groups a warp's
// repack stores touch lie in distinct banks.
__host__ __device__ inline int group_stride(int ks, int nwg,
                                            int rows = ROWS_PER_WG) {
  return (tile_h(nwg, rows) + ks - 1) * (TW + ks - 1) / 8 * 8 + 9;
}

__host__ __device__ inline Layout layout(int ks, int cin_pad, int raw_pitch,
                                         int nwg, int ws, int ns,
                                         int rows = ROWS_PER_WG, int e = 2) {
  const int ph = tile_h(nwg, rows) + ks - 1;
  Layout l;
  l.pad = 0;
  l.raw = (cin_pad / (16 / e) * group_stride(ks, nwg, rows) * 16 + 127) /
          128 * 128;
  l.wgt = l.raw + ph * raw_pitch;
  l.stage = l.wgt + ws * wblock_bytes(ns, cin_pad, e);
  l.bars = l.stage + nwg * TW * (ns + 4) * 4;
  l.total = l.bars + 2 * (1 + ws) * 8;
  return l;
}

// Staged floats of one warpgroup's output row in mode m: [pixel][ns + 4],
// or in a planar-output mode [channel][TW + 4] (transposed, so that the
// planar stores' lanes run along the pixels), whichever is larger.
__host__ __device__ constexpr int stage_floats(int ns, int m) {
  return planar_out(m) && ns * (TW + 4) > TW * (ns + 4)
             ? ns * (TW + 4)
             : TW * (ns + 4);
}

// layout's carve-up with mode m's staging (larger only in a planar-output
// mode at N 80).
__host__ __device__ inline Layout mode_layout(Layout l, int m, int nwg,
                                              int ns) {
  const int extra = nwg * (stage_floats(ns, m) - TW * (ns + 4)) * 4;
  l.bars += extra;
  l.total += extra;
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

// One TMA tensor copy (cp.async.bulk.tensor) of the 4-D box at (c0, c1,
// c2, c3) of the tensor map `map` (a __grid_constant__ parameter's
// address) into shared memory, completing on `bar`; elements outside the
// tensor are zero.
__device__ __forceinline__ void tensor_load_4d(void* dst, const void* map,
                                               int c0, int c1, int c2,
                                               int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
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

__device__ __forceinline__ void fence_reg(int& r) {
  asm volatile("" : "+r"(r) :: "memory");
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


// wgmma m64nNk32, s8 x s8 -> s32, both operands K-major from shared memory
// (the only layout 8-bit wgmma takes): d += A * B.  The integer shapes take
// N in 8, 16, 24, 32, then steps of 16: no 56.
template <int N>
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_s8<8>(int* d, uint64_t a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int* d, uint64_t a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<80>(int* d, uint64_t a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39"
      "}, %40, %41, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39])
      : "l"(a), "l"(b), "r"(1));
}

// The input element type of form F (int8 codes or bf16) and the operand
// element type (bf16 or int8 codes).
template <int F>
using InOf = std::conditional_t<F == FORM_S8, int8_t, __nv_bfloat16>;
template <int F>
using OpOf = std::conditional_t<F == FORM_BF16, __nv_bfloat16, int8_t>;

// One wgmma of form F's operand type: d += A * B.
template <int F, int N, typename Acc>
__device__ __forceinline__ void wgmma(Acc* d, uint64_t a, uint64_t b) {
  if constexpr (F == FORM_BF16) {
    wgmma_ss<N>(d, a, b);
  } else {
    wgmma_s8<N>(d, a, b);
  }
}

// The 16-byte-aligned bulk copy of input row iy (image b), columns
// [xs, xe) of an input of TI elements: its source, its length, and where
// the row's first element lies in it (elements).
struct Span {
  const unsigned char* src;
  uint32_t bytes;
  int mis;
};

template <typename TI>
__device__ __forceinline__ Span row_span(const Params& p, int b, int iy,
                                         int xs, int xe) {
  const size_t row = ((size_t)b * p.h + iy) * p.w;
  const TI* x = reinterpret_cast<const TI*>(p.x);
  const uintptr_t a0 = reinterpret_cast<uintptr_t>(x + (row + xs) * p.cin);
  const uintptr_t a1 = reinterpret_cast<uintptr_t>(x + (row + xe) * p.cin);
  const uintptr_t lo = a0 & ~uintptr_t(15);
  const uintptr_t hi = (a1 + 15) & ~uintptr_t(15);
  return {reinterpret_cast<const unsigned char*>(lo),
          static_cast<uint32_t>(hi - lo),
          static_cast<int>((a0 - lo) / sizeof(TI))};
}

struct TileAt {
  int b, ty0, tx0;
};

template <int R>
__device__ __forceinline__ TileAt tile_at(const Params& p, int tile) {
  const int tiles_hw = p.tiles_w * p.tiles_h;
  const int r = tile % tiles_hw;
  return {tile / tiles_hw, r / p.tiles_w * tile_h(p.nwg, R),
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

// The N slices [s0, s1) of a SPLIT instance's block: group blockIdx.y of
// gridDim.y groups of consecutive slices (conv_sm90.py::group_slices
// mirrors it).  The other instances take every slice and read p.nslices
// as they did before SPLIT existed, so that their code stays the same.
__device__ __forceinline__ void slice_range(const Params& p, int& s0,
                                            int& s1) {
  const int per = (p.nslices + gridDim.y - 1) / gridDim.y;
  s0 = blockIdx.y * per;
  s1 = min(p.nslices, s0 + per);
}

// The producer warp's lane 0: raw input rows of every tile of this block
// (in MODE_PLANAR_IN and MODE_PLANAR_IO its planar box, one tensor copy),
// and the weight blocks of its slices (once if resident, else per tile).
template <int F, int R, bool SPLIT, int M = MODE_NONE>
__device__ __forceinline__ void produce(const Params& p, const Layout& L,
                                        unsigned char* smem, int ns) {
  using TI = InOf<F>;
  const int ph = tile_h(p.nwg, R) + p.ks - 1, pw = TW + p.ks - 1;
  const int halo = (p.ks - 1) / 2;
  const int tiles = p.tiles_w * p.tiles_h * p.n;
  const uint32_t wbytes = wblock_bytes(ns, p.cin_pad, op_bytes(F));
  int kblocks = p.nslices * p.ks * p.ks;
  uint64_t* full_raw = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty_raw = full_raw + 1;
  uint64_t* full_w = empty_raw + 1;
  uint64_t* empty_w = full_w + p.ws;
  const unsigned char* wpk = reinterpret_cast<const unsigned char*>(p.wpk);
  if constexpr (SPLIT) {  // this group's blocks only
    int s0, s1;
    slice_range(p, s0, s1);
    kblocks = (s1 - s0) * p.ks * p.ks;
    wpk += (size_t)s0 * p.ks * p.ks * wbytes;
  }
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
    const TileAt t = tile_at<R>(p, tile);
    if constexpr (planar_in(M)) {
      // the box at planar (tx0 / 2 - PBX_LEAD, ty0 / 2 - 1), channel 0,
      // plane 0: ty0 and tx0 are even, so it holds fine rows ty0 - 1 ..
      // and columns tx0 - 2 PBX_LEAD ..; the copy counts the whole box
      const ParamsPlanar& q = static_cast<const ParamsPlanar&>(p);
      bar_wait(empty_raw, raw_phase ^ 1);
      bar_expect(full_raw, PBX * planar_rows(p.nwg) * p.cin * 4 * 2);
      tensor_load_4d(smem + L.raw, &q.tmap, t.tx0 / 2 - PBX_LEAD, t.ty0 / 2 - 1,
                     0, 0, full_raw);
      raw_phase ^= 1;
    } else {
      const int xs = max(t.tx0 - halo, 0), xe = min(t.tx0 - halo + pw, p.w);
      const int y0 = max(t.ty0 - halo, 0), y1 = min(t.ty0 - halo + ph, p.h);
      bar_wait(empty_raw, raw_phase ^ 1);
      uint32_t total = 0;
      for (int iy = y0; iy < y1; ++iy)
        total += row_span<TI>(p, t.b, iy, xs, xe).bytes;
      bar_expect(full_raw, total);
      for (int iy = y0; iy < y1; ++iy) {
        const Span s = row_span<TI>(p, t.b, iy, xs, xe);
        bulk_load(smem + L.raw + (iy - t.ty0 + halo) * p.raw_pitch, s.src,
                  s.bytes, full_raw);
      }
      raw_phase ^= 1;
    }
    if (p.resident) continue;
    if constexpr (M == MODE_KLOOP) {
      // block (slice s, chunk ci, tap) of [slice][chunk][tap][kstep]...,
      // in the order the consumers take them (chunk_at)
      const ParamsKloop& q = static_cast<const ParamsKloop&>(p);
      const int taps = p.ks * p.ks;
      for (int s = 0; s < p.nslices; ++s) {
        for (int cc = 0; cc < q.nkc; ++cc) {
          const int ci = chunk_at(s, cc, q.nkc);
          const unsigned char* src =
              wpk +
              ((size_t)s * q.cin_all + (size_t)ci * KC) * taps * ns * 2;
          for (int tap = 0; tap < taps; ++tap) {
            bar_wait(&empty_w[wr.slot], wr.phase ^ 1);
            bar_expect(&full_w[wr.slot], wbytes);
            bulk_load(smem + L.wgt + wr.slot * wbytes,
                      src + (size_t)tap * wbytes, wbytes, &full_w[wr.slot]);
            wr.next(p.ws);
          }
        }
      }
    } else {
      for (int kb = 0; kb < kblocks; ++kb) {
        bar_wait(&empty_w[wr.slot], wr.phase ^ 1);
        bar_expect(&full_w[wr.slot], wbytes);
        bulk_load(smem + L.wgt + wr.slot * wbytes, wpk + (size_t)kb * wbytes,
                  wbytes, &full_w[wr.slot]);
        wr.next(p.ws);
      }
    }
  }
}

// NS: output channels per N slice (the wgmma N).  Threads: 128 * p.nwg
// consumers, then one producer warp.
// The first epilogue step of one element: the bf16 form's fp32 sum +
// bias, or (S8) the int8 form's int32 sum dequantised, sum * dq + bias;
// then the output affine and the residual.  The int8 form rounds each
// product and sum on its own, as the plain version computes them (no
// fused multiply-add), so that the int8 codes it stores match its codes.
template <bool S8>
__device__ __forceinline__ float dequant(float sum, float bias, float dq) {
  if constexpr (S8) {
    return __fadd_rn(__fmul_rn(sum, dq), bias);
  } else {
    return sum + bias;
  }
}

template <bool S8>
__device__ __forceinline__ float affine(float v, float mul, float add) {
  if constexpr (S8) {
    return __fadd_rn(__fmul_rn(v, mul), add);
  } else {
    return v * mul + add;
  }
}

template <bool S8>
__device__ __forceinline__ float add_res(float v, float r) {
  if constexpr (S8) {
    return __fadd_rn(v, r);
  } else {
    return v + r;
  }
}

// A residual element as the epilogue adds it: r, or with SR (the
// MODE_SIN_RESIDUAL instances) sin(r), the reduced SFU sine of ACT_SIN.
template <bool SR>
__device__ __forceinline__ float res_of(float r) {
  if constexpr (SR) {
    return sin_reduced(r);
  } else {
    return r;
  }
}

// The epilogue of one output row segment, element by element: the sums
// (as floats) of up to 64 pixels (tx0 + px, px < 64) x NS channels (n0 +
// ch) of row oy, staged in s_acc[px][ch] (pitch NS + 4, so that the
// accumulators' float2 stores hit distinct banks): dequant<S8> (+ bias),
// activation ACT, output affine, + residual, a bf16 store or (Q) an
// int8-code store; warp wq of the warpgroup takes pixels wq, wq + 4, ...,
// its lanes consecutive channels, so that a pixel's stores are
// contiguous.  Each element's address is out_offset's.  This is the loop
// of the N 8 instances (the 3-channel head: three live lanes a warp),
// where epilogue_loop below measured a third slower on an H100 (the cause
// is not resolved).  ACT and Q are compile-time, so that the loop carries
// one activation's code and one store's.  Without PHASE_STORE in P the
// stores happen only under probe_store() (never).  SR: the residual's
// sine is added (res_of).
template <int NS, int ACT, bool Q, int P, bool S8, bool SR = false>
__device__ __forceinline__ void epilogue_loop_elem(
    const float* s_acc, int b, int oy, int tx0, int n0, int wq, int lane,
    int h, int w, int cout, int shuffle, const __nv_bfloat16* residual,
    const float* out_inv, void* out, const float (&bias)[(NS + 31) / 32],
    const float (&dq)[(NS + 31) / 32], const float (&mul)[(NS + 31) / 32],
    const float (&add)[(NS + 31) / 32]) {
  constexpr int CH = (NS + 31) / 32;
  const bool store = (P & PHASE_STORE) != 0 || probe_store();
  for (int px = wq; px < TW && tx0 + px < w; px += 4) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int ch = lane + 32 * c, n = n0 + ch;
      if (ch >= NS || n >= cout) continue;
      const size_t off = out_offset(b, oy, tx0 + px, n, h, w, cout, shuffle);
      float v = activate(
          dequant<S8>(s_acc[px * (NS + 4) + ch], bias[c], dq[c]), ACT);
      v = affine<S8>(v, mul[c], add[c]);
      if (residual)
        v = add_res<S8>(v, res_of<SR>(__bfloat162float(residual[off])));
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
// activation) are in flight and not one.  SR as epilogue_loop_elem's.
template <int NS, int ACT, bool Q, int P, bool S8, bool SR = false>
__device__ __forceinline__ void epilogue_loop(
    const float* s_acc, int npx, int wq, int lane, size_t base,
    size_t pstride, const long long (&coff)[(NS + 31) / 32],
    const int (&qch)[(NS + 31) / 32], const __nv_bfloat16* residual,
    const float* out_inv, void* out, const float (&bias)[(NS + 31) / 32],
    const float (&dq)[(NS + 31) / 32], const float (&mul)[(NS + 31) / 32],
    const float (&add)[(NS + 31) / 32]) {
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
        float v = activate(dequant<S8>(s_acc[px * (NS + 4) + lane + 32 * c],
                                       bias[c], dq[c]),
                           ACT);
        v = affine<S8>(v, mul[c], add[c]);
        if (residual) v = add_res<S8>(v, res_of<SR>(res[u][c]));
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
// Without PHASE_EPI in P it stores the raw sums (no bias, dequant,
// activation, affine or residual).  SR: the residual's sine is added
// (MODE_SIN_RESIDUAL).  Inlined into epilogue_row / epilogue_row_sin.
template <int NS, int P, int F, bool SR>
__device__ __forceinline__ void epilogue_body(const ParamsOf<F>& p,
                                              const float* s_acc, int b,
                                              int oy, int tx0, int n0,
                                              int wq, int lane) {
  constexpr bool kEpi = (P & PHASE_EPI) != 0;
  constexpr bool kS8 = F != FORM_BF16;
  // the fields this uses, read once: the stores could alias p
  const int h = p.h, w = p.w, cout = p.cout;
  const int act = kEpi ? p.act : ACT_NONE;
  const int shuffle = p.shuffle;
  const __nv_bfloat16* residual = kEpi ? p.residual : nullptr;
  const float* out_inv = p.out_inv;
  void* out = p.out;
  constexpr int CH = (NS + 31) / 32;
  float bias[CH], dq[CH], mul[CH], add[CH];
  long long coff[CH];
  int qch[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int n = n0 + lane + 32 * c;
    const bool ok = lane + 32 * c < NS && n < cout;
    const bool aff = kEpi && ok;
    if constexpr (kS8) {
      bias[c] = aff ? p.dq_bias[n] : 0.0f;
      dq[c] = aff ? p.dq_scale[n] : 1.0f;
    } else {
      bias[c] = aff ? __bfloat162float(p.bias[n]) : 0.0f;
      dq[c] = 1.0f;
    }
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
    epilogue_loop_elem<NS, A, Q, P, kS8, SR>(s_acc, b, oy, tx0, n0, wq,    \
                                             lane, h, w, cout, shuffle,    \
                                             residual, out_inv, out, bias, \
                                             dq, mul, add);                \
  else                                                                     \
    epilogue_loop<NS, A, Q, P, kS8, SR>(s_acc, npx, wq, lane, base,        \
                                        pstride, coff, qch, residual,      \
                                        out_inv, out, bias, dq, mul, add)
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

// The epilogue of one output row (epilogue_body), not inlined: one copy
// of its code stays in the instruction cache.
template <int NS, int P, int F>
__device__ __noinline__ void epilogue_row(const ParamsOf<F>& p,
                                          const float* s_acc, int b, int oy,
                                          int tx0, int n0, int wq,
                                          int lane) {
  epilogue_body<NS, P, F, false>(p, s_acc, b, oy, tx0, n0, wq, lane);
}

// The same with the residual's sine added (MODE_SIN_RESIDUAL).
template <int NS, int P, int F>
__device__ __noinline__ void epilogue_row_sin(const ParamsOf<F>& p,
                                              const float* s_acc, int b,
                                              int oy, int tx0, int n0,
                                              int wq, int lane) {
  epilogue_body<NS, P, F, true>(p, s_acc, b, oy, tx0, n0, wq, lane);
}

// The planes (channels a plane) of the planar output of a launch in mode
// M: cp in MODE_PLANAR_OUT (the residual's too), cpo in MODE_PLANAR_IO.
template <int M>
__device__ __forceinline__ int out_planes(const ParamsOf<FORM_BF16, M>& p) {
  if constexpr (M == MODE_PLANAR_IO) {
    return p.cpo;
  } else {
    return p.cp;
  }
}

// The epilogue of one output row of a planar-output launch: fine row oy,
// pixels tx0 + px (px < 64) x NS channels (n0 + ch), staged transposed in
// s_acc[ch][px] (pitch TW + 4: the accumulators' scalar stores hit
// distinct banks, and a warp's reads of one channel's 32 consecutive
// pixels too).  + bias, then in MODE_PLANAR_OUT + the planar residual (no
// activation and no output affine: conv1 of a ResBlockSFT), in
// MODE_PLANAR_IO the activation ACT (compile-time, as epilogue_body's; no
// residual: the planar conv); a bf16 store into the planar output: a
// warp's item is one channel and 32 consecutive pixels, whose even and
// odd pixels lie in two planes (r2 = 0, 1) at 16 consecutive planar
// columns each, so that its residual loads and its stores are two 32-byte
// runs.  A warp takes items wq, wq + 4, ..., U at a time, their bias and
// residual loads issued before any store, so that U loads are in flight
// and not one.
template <int NS, int P, int M = MODE_PLANAR_OUT, int ACT = ACT_NONE>
__device__ __noinline__ void epilogue_planar(const ParamsOf<FORM_BF16, M>& p,
                                             const float* s_acc, int oy,
                                             int tx0, int n0, int wq,
                                             int lane) {
  constexpr bool kEpi = (P & PHASE_EPI) != 0;
  constexpr int U = 4;
  const bool store = (P & PHASE_STORE) != 0 || probe_store();
  const int w = p.w, cout = p.cout;
  const __nv_bfloat16* bias = p.bias;
  const __nv_bfloat16* residual = kEpi ? p.residual : nullptr;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
  const size_t chan = (size_t)p.hc * p.wd;  // elements of one channel
  // pixel tx0 of row oy in plane 2 r1 (r1 = oy & 1), channel 0
  const size_t row = (size_t)(2 * (oy & 1)) * out_planes<M>(p) * chan +
                     (size_t)(oy >> 1) * p.wd + (tx0 >> 1);
  for (int it0 = wq; it0 < 2 * NS; it0 += 4 * U) {
    size_t off[U];
    bool ok[U];
    float add[U];  // bias + residual
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int it = it0 + 4 * u, n = n0 + (it >> 1);
      const int px = (it & 1) * 32 + lane;
      ok[u] = it < 2 * NS && n < cout && tx0 + px < w;
      off[u] = row + ((px & 1) * out_planes<M>(p) + n) * chan + (px >> 1);
      add[u] = kEpi && ok[u] ? __bfloat162float(bias[n]) : 0.0f;
      // compile-time, not only the null test: with the residual's loads
      // live, the MODE_PLANAR_IO instances took up to 18 more registers
      // (ptxas) and their 1080x1920x51 launch read slower on an H100
      if constexpr (M != MODE_PLANAR_IO)
        if (residual && ok[u]) add[u] += __bfloat162float(residual[off[u]]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int it = it0 + 4 * u;
      if constexpr (M == MODE_PLANAR_IO) {
        if (ok[u] && store)
          out[off[u]] = __float2bfloat16(activate(
              s_acc[(it >> 1) * (TW + 4) + (it & 1) * 32 + lane] + add[u],
              kEpi ? ACT : ACT_NONE));
      } else {
        if (ok[u] && store)
          out[off[u]] = __float2bfloat16(
              s_acc[(it >> 1) * (TW + 4) + (it & 1) * 32 + lane] + add[u]);
      }
    }
  }
}

// MODE_PLANAR_IO's epilogue of one output row at launch p's activation
// (epilogue_planar, one copy a compile-time activation).
template <int NS, int P>
__device__ __forceinline__ void epilogue_planar_io(const ParamsPlanarIO& p,
                                                   const float* s_acc,
                                                   int oy, int tx0, int n0,
                                                   int wq, int lane) {
  constexpr int M = MODE_PLANAR_IO;
  switch (p.act) {
    case ACT_SIN:
      epilogue_planar<NS, P, M, ACT_SIN>(p, s_acc, oy, tx0, n0, wq, lane);
      break;
    case ACT_GELU:
      epilogue_planar<NS, P, M, ACT_GELU>(p, s_acc, oy, tx0, n0, wq, lane);
      break;
    case ACT_OUTIMG:
      epilogue_planar<NS, P, M, ACT_OUTIMG>(p, s_acc, oy, tx0, n0, wq, lane);
      break;
    default:
      epilogue_planar<NS, P, M, ACT_NONE>(p, s_acc, oy, tx0, n0, wq, lane);
  }
}

// An input element as the bf16 repack stages it (before the prologue
// affine): x, or in MODE_SIN_INPUT sin(x), the reduced SFU sine of ACT_SIN.
template <int M>
__device__ __forceinline__ float staged(__nv_bfloat16 x) {
  if constexpr (M == MODE_SIN_INPUT) {
    return sin_reduced(__bfloat162float(x));
  } else {
    return __bfloat162float(x);
  }
}

// The planar-input modes' repack of one tile: its planar box in the raw buffer,
// [plane][Cin][planar_rows(nwg)][PBX], into the operand tile s_pad
// ([8-channel group][pixel][8]).  Warp w takes the channel groups w, w +
// cwarps, ..., its lanes consecutive pixels of the halo'd tile (fine row
// ty0 - 1 + r, column tx0 - 1 + col; r < ph, col < TW + 2), a lane one
// pixel's 8 channels: eight loads from the box (a warp's even and odd
// columns read two planes, in the same banks: two-way conflicts), the
// prologue affine on in-image taps (zero padding after it, as the NHWC
// repack), one 16-byte store (a warp's 32 stores contiguous).
__device__ __forceinline__ void repack_planar(
    const Params& p, const __nv_bfloat16* box, __nv_bfloat16* s_pad, int gs,
    int ty0, int tx0, int ph, int warp, int cwarps, int lane) {
  constexpr int pw = TW + 2;
  const int cstr = planar_rows(p.nwg) * PBX;  // one channel to the next
  const int pstr = p.cin * cstr;              // one plane to the next
  for (int grp = warp; grp < p.cin_pad / 8; grp += cwarps) {
    const int k0 = grp * 8;
    float mul[8], add[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const bool aff = p.in_scale != nullptr && k0 + e < p.cin;
      mul[e] = aff ? p.in_scale[k0 + e] + 1.0f : 1.0f;
      add[e] = aff ? p.in_shift[k0 + e] : 0.0f;
    }
    const __nv_bfloat16* gbox = box + k0 * cstr;
    uint4* dst = reinterpret_cast<uint4*>(s_pad + grp * gs * 8);
    for (int pix = lane; pix < ph * pw; pix += 32) {
      const int r = pix / pw, col = pix - r * pw;
      const int fy = ty0 - 1 + r, fx = tx0 - 1 + col;
      const bool inside = fy >= 0 && fy < p.h && fx >= 0 && fx < p.w;
      // ty0 and tx0 are even: fine row fy = 2 y + r1 lies in box row
      // (r + 1) / 2 with r1 = (r + 1) & 1, and so for the columns, from
      // box column PBX_LEAD - 1
      const __nv_bfloat16* src =
          gbox + (2 * ((r + 1) & 1) + ((col + 1) & 1)) * pstr +
          ((r + 1) >> 1) * PBX + ((col + 1) >> 1) + PBX_LEAD - 1;
      uint32_t u[4];
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        float v0 = 0.0f, v1 = 0.0f;
        if (inside && k0 + e < p.cin)
          v0 = __bfloat162float(src[e * cstr]) * mul[e] + add[e];
        if (inside && k0 + e + 1 < p.cin)
          v1 = __bfloat162float(src[(e + 1) * cstr]) * mul[e + 1] +
               add[e + 1];
        const __nv_bfloat162 b2 = __floats2bfloat162_rn(v0, v1);
        u[e / 2] = *reinterpret_cast<const uint32_t*>(&b2);
      }
      dst[pix] = make_uint4(u[0], u[1], u[2], u[3]);
    }
  }
}

// The consumers of a MODE_KLOOP launch (bf16, 2 rows a warpgroup, the
// weights streamed): per tile and N slice, a K loop over the chunks of KC
// input channels in chunk_at's order.  A chunk that the operand tile does
// not hold is repacked into it from the raw rows (which hold all Cin
// channels: the producer's copies are MODE_NONE's) once the GEMM is done
// with the tile; the tile's last repack releases the raw buffer.  Each
// chunk's taps run wgmma over its KC / 16 K steps into the same
// accumulators, which the epilogue (MODE_NONE's) takes after the last
// chunk.  Every chunk is KC wide (Cin is padded to KC, zeros beyond it):
// a K-step count that changed from chunk to chunk made ptxas serialise
// the wgmmas (C7520, on an H100's toolkit).
template <int NS>
__device__ __forceinline__ void consume_kloop(const ParamsKloop& p,
                                              const Layout& L,
                                              unsigned char* smem) {
  constexpr int R = ROWS_PER_WG, G = 8;
  uint64_t* full_raw = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty_raw = full_raw + 1;
  uint64_t* full_w = empty_raw + 1;
  uint64_t* empty_w = full_w + p.ws;
  const int consumers = 128 * p.nwg, cwarps = 4 * p.nwg;
  const int ph = tile_h(p.nwg) + p.ks - 1, pw = TW + p.ks - 1;
  const int gs = group_stride(p.ks, p.nwg);
  const uint32_t lbo_a = gs * 16;
  const int halo = (p.ks - 1) / 2, taps = p.ks * p.ks;
  const int tiles = p.tiles_w * p.tiles_h * p.n;
  const int wbytes = wblock_bytes(NS, p.cin_pad);  // a ring slot
  __nv_bfloat16* s_pad = reinterpret_cast<__nv_bfloat16*>(smem + L.pad);
  const unsigned char* s_w = smem + L.wgt;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wq = warp & 3;
  const int g = lane >> 2, tq = lane & 3;
  Ring wr;
  uint32_t raw_phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const TileAt t = tile_at<R>(p, tile);
    const int xs = max(t.tx0 - halo, 0);
    int have = -1;  // the chunk the operand tile holds
    for (int s = 0; s < p.nslices; ++s) {
      float acc[R][NS / 2];
#pragma unroll
      for (int mt = 0; mt < R; ++mt)
#pragma unroll
        for (int i = 0; i < NS / 2; ++i) acc[mt][i] = 0.0f;
      int held = -1;  // the weight slot the last tap read
      for (int cc = 0; cc < p.nkc; ++cc) {
        const int ci = chunk_at(s, cc, p.nkc);
        const int k0 = ci * KC;
        if (ci != have) {
          // the GEMM is done with the operand tile and its weight slot
          wgmma_wait<0>();
          if (held >= 0 && lane == 0) bar_arrive(&empty_w[held]);
          held = -1;
          if (have < 0) bar_wait(full_raw, raw_phase);
          consumer_sync(consumers);
          // a lane repacks chunk channels 2 lane and 2 lane + 1 of a pixel
          float mul[2], add[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = k0 + 2 * lane + e;
            const bool aff = p.in_scale != nullptr && k < p.cin;
            mul[e] = aff ? p.in_scale[k] + 1.0f : 1.0f;
            add[e] = aff ? p.in_shift[k] : 0.0f;
          }
          const unsigned char* rbuf = smem + L.raw;
          for (int r = 0; r < ph; ++r) {
            const int iy = t.ty0 - halo + r;
            const bool row_in = iy >= 0 && iy < p.h;
            // channel k0 of pixel ix of this row: row + ix * cin
            const __nv_bfloat16* row =
                reinterpret_cast<const __nv_bfloat16*>(rbuf +
                                                       r * p.raw_pitch) +
                (row_in ? row_span<__nv_bfloat16>(p, t.b, iy, xs, xs).mis
                        : 0) -
                xs * p.cin + k0;
            for (int c = warp; c < pw; c += cwarps) {
              const int ix = t.tx0 - halo + c;
              const bool inside = row_in && ix >= 0 && ix < p.w;
              const __nv_bfloat16* src = row + ix * p.cin;
              const int k = 2 * lane;  // KC = 64: a lane's two channels
              float v0 = 0.0f, v1 = 0.0f;
              if (inside && k0 + k < p.cin)
                v0 = __bfloat162float(src[k]) * mul[0] + add[0];
              if (inside && k0 + k + 1 < p.cin)
                v1 = __bfloat162float(src[k + 1]) * mul[1] + add[1];
              *reinterpret_cast<__nv_bfloat162*>(
                  s_pad + (r * pw + c) * G + (k >> 3) * gs * 8 + (k & 7)) =
                  __floats2bfloat162_rn(v0, v1);
            }
          }
          fence_async_smem();
          if (s == p.nslices - 1 && cc == p.nkc - 1) {  // the last repack
            __syncwarp();
            if (lane == 0) bar_arrive(empty_raw);
            raw_phase ^= 1;
          }
          consumer_sync(consumers);  // the operand tile is complete
          have = ci;
        }
        for (int tap = 0; tap < taps; ++tap) {
          bar_wait(&full_w[wr.slot], wr.phase);
          const int slot = wr.slot;
          const unsigned char* wblk = s_w + slot * wbytes;
          wr.next(p.ws);
          const int dy = tap / p.ks, dx = tap - dy * p.ks;
          const __nv_bfloat16* a0 = s_pad + ((wg * R + dy) * pw + dx) * G;
          wgmma_fence();
          for (int k = 0; k < KC / 16; ++k) {
            const uint64_t db = desc(wblk + k * NS * 32, 128, 256);
            const __nv_bfloat16* ak = a0 + 2 * k * gs * G;
            wgmma_ss<NS>(acc[0], desc(ak, lbo_a, 128), db);
            wgmma_ss<NS>(acc[1], desc(ak + pw * G, lbo_a, 128), db);
          }
          wgmma_commit();
          // the previous tap's wgmmas are done: release its weight slot
          wgmma_wait<1>();
          if (held >= 0 && lane == 0) bar_arrive(&empty_w[held]);
          held = slot;
        }
      }
      wgmma_wait<0>();
      if (held >= 0 && lane == 0) bar_arrive(&empty_w[held]);
#pragma unroll
      for (int mt = 0; mt < R; ++mt)
#pragma unroll
        for (int i = 0; i < NS / 2; ++i) fence_reg(acc[mt][i]);

      // the epilogue of MODE_NONE, once after the last chunk
      const int n0 = s * NS;
      float* s_acc = reinterpret_cast<float*>(smem + L.stage) +
                     wg * stage_floats(NS, MODE_KLOOP);
#pragma unroll
      for (int mt = 0; mt < R; ++mt) {
        const int oy = t.ty0 + wg * R + mt;
        if (oy >= p.h) continue;  // uniform over the warpgroup
#pragma unroll
        for (int i = 0; i < NS / 2; i += 2) {
          const int j = i >> 2, e = i & 3;
          const int px = wq * 16 + g + (e >> 1) * 8;
          *reinterpret_cast<float2*>(s_acc + px * (NS + 4) + j * 8 + tq * 2) =
              make_float2(acc[mt][i], acc[mt][i + 1]);
        }
        wg_sync(wg);
        epilogue_row<NS, PHASE_ALL, FORM_BF16>(p, s_acc, t.b, oy, t.tx0, n0,
                                                wq, lane);
        wg_sync(wg);
      }
    }
  }
}

// SPLIT: the block takes one group of the launch's N slices (slice_range),
// in the bf16 form only; the other instances take them all.  M: the mode
// (Mode), in the bf16 form at 2 rows a warpgroup and without SPLIT only;
// the planar modes 3 x 3 only.
template <int NS, int P = PHASE_ALL, int F = FORM_BF16, int R = ROWS_PER_WG,
          bool SPLIT = false, int M = MODE_NONE>
__global__ void __launch_bounds__(2 * 128 + PRODUCER, 1)
conv_sm90_kernel(const __grid_constant__ ParamsOf<F, M> p) {
  static_assert(!SPLIT || F == FORM_BF16, "slice groups in bf16 only");
  static_assert(R == 2 || R == 3, "2 or 3 output rows a warpgroup");
  static_assert(M == MODE_NONE ||
                    (F == FORM_BF16 && R == ROWS_PER_WG && !SPLIT),
                "modes in bf16, at 2 rows a warpgroup, one slice group");
  static_assert(M != MODE_KLOOP || P == PHASE_ALL, "no K loop probes");
  constexpr bool kStage = (P & PHASE_STAGE) != 0;
  constexpr bool kGemm = (P & PHASE_GEMM) != 0;
  constexpr int E = op_bytes(F);
  constexpr int G = 16 / E;  // operand elements in 16 bytes
  using TI = InOf<F>;
  using TO = OpOf<F>;
  using Acc = std::conditional_t<F == FORM_BF16, float, int>;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = mode_layout(
      layout(p.ks, p.cin_pad, p.raw_pitch, p.nwg, p.ws, NS, R, E), M, p.nwg,
      NS);
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
    if (threadIdx.x == consumers) produce<F, R, SPLIT, M>(p, L, smem, NS);
    return;
  }
  if constexpr (M == MODE_KLOOP) {
    consume_kloop<NS>(p, L, smem);
    return;
  }

  const int ph = tile_h(p.nwg, R) + p.ks - 1, pw = TW + p.ks - 1;
  const int gs = group_stride(p.ks, p.nwg, R);
  const uint32_t lbo_a = gs * 16;  // the next 16 bytes of K of s_pad
  const int halo = (p.ks - 1) / 2;
  const int taps = p.ks * p.ks;
  const int nks = p.cin_pad / (2 * G);  // k16 (bf16) or k32 (s8) steps
  const int tiles = p.tiles_w * p.tiles_h * p.n;
  const int wbytes = wblock_bytes(NS, p.cin_pad, E);
  TO* s_pad = reinterpret_cast<TO*>(smem + L.pad);
  const unsigned char* s_w = smem + L.wgt;
  int s0 = 0, s1 = 0;  // SPLIT: this group's slices
  if constexpr (SPLIT) slice_range(p, s0, s1);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wq = warp & 3;
  const int g = lane >> 2, tq = lane & 3;

  // FORM_S8's repack: a lane copies four codes, input channels k4 + 64c,
  // and keeps those below Cin (a 32-bit mask)
  const int k4 = 4 * (lane & 15);
  [[maybe_unused]] uint32_t keep[2];
  if constexpr (F == FORM_S8) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int left = p.cin - k4 - 64 * c;
      keep[c] = left >= 4 ? ~0u : left <= 0 ? 0u : (1u << (8 * left)) - 1;
    }
  }

  // a lane repacks input channels 2 lane + 64c and the next; its
  // prologue affine, and in FORM_S8Q its quantisation multiplier: loaded
  // once in bf16, per tile in int8, so that they hold no registers beside
  // the int8 form's accumulators (3 rows a warpgroup)
  float in_mul[2][2], in_add[2][2];
  [[maybe_unused]] float in_inv[2][2];
  auto prologue = [&]() {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 2 * lane + 64 * c + e;
        const bool aff = p.in_scale != nullptr && k < p.cin;
        in_mul[c][e] = aff ? p.in_scale[k] + 1.0f : 1.0f;
        in_add[c][e] = aff ? p.in_shift[k] : 0.0f;
        if constexpr (F == FORM_S8Q)
          in_inv[c][e] = k < p.cin ? p.in_inv[k] : 0.0f;
      }
    }
  };
  if constexpr (F == FORM_BF16) prologue();

  if constexpr (!kStage) {  // probe: one zero operand tile, never repacked
    for (int i = threadIdx.x; i < L.raw / 16; i += consumers)
      reinterpret_cast<uint4*>(smem + L.pad)[i] = make_uint4(0, 0, 0, 0);
    fence_async_smem();
  }

  Ring wr;
  uint32_t raw_phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const TileAt t = tile_at<R>(p, tile);
    const int xs = max(t.tx0 - halo, 0);

    // 1. repack the raw rows into s_pad, prologue on in-image taps only
    bar_wait(full_raw, raw_phase);
    if constexpr (F != FORM_BF16) prologue();
    consumer_sync(consumers);  // the previous tile's GEMM is done with s_pad
    const unsigned char* rbuf = smem + L.raw;
    if constexpr (planar_in(M)) {
      if (kStage)
        repack_planar(p, reinterpret_cast<const __nv_bfloat16*>(rbuf), s_pad,
                      gs, t.ty0, t.tx0, ph, warp, cwarps, lane);
    }
    for (int r = 0; r < (kStage && !planar_in(M) ? ph : 0); ++r) {
      const int iy = t.ty0 - halo + r;
      const bool row_in = iy >= 0 && iy < p.h;
      // element of pixel ix of this row: row + ix * cin
      const TI* row =
          reinterpret_cast<const TI*>(rbuf + r * p.raw_pitch) +
          (row_in ? row_span<TI>(p, t.b, iy, xs, xs).mis : 0) - xs * p.cin;
      if constexpr (F == FORM_S8) {
        // codes: 16 lanes a pixel, four codes a lane from two aligned
        // 32-bit loads of the raw row, one 32-bit store; a warp's halves
        // take pixels four apart, whose 16-byte groups lie in distinct
        // bank quads
        for (int q = warp; q < (pw + 7) / 8 * 4; q += cwarps) {
          const int c = (q >> 2) * 8 + (q & 3) + 4 * (lane >> 4);
          const int ix = t.tx0 - halo + c;
          const bool inside = row_in && ix >= 0 && ix < p.w;
          if (c >= pw) continue;
          TO* dst = s_pad + (r * pw + c) * G;
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int k = k4 + 64 * cc;
            if (k >= p.cin_pad) continue;
            uint32_t v = 0;
            if (inside && keep[cc]) {
              const uintptr_t a =
                  reinterpret_cast<uintptr_t>(row + ix * p.cin + k);
              const uint32_t* w =
                  reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
              v = __funnelshift_r(w[0], w[1], (a & 3) * 8) & keep[cc];
            }
            *reinterpret_cast<uint32_t*>(dst + (k >> 4) * gs * 16 +
                                         (k & 15)) = v;
          }
        }
      } else {
        for (int c = warp; c < pw; c += cwarps) {
          const int ix = t.tx0 - halo + c;
          const bool inside = row_in && ix >= 0 && ix < p.w;
          const TI* src = row + ix * p.cin;
          TO* dst = s_pad + (r * pw + c) * G;
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int k = 2 * lane + 64 * cc;
            if (k >= p.cin_pad) continue;
            if constexpr (F == FORM_BF16) {
              float v0 = 0.0f, v1 = 0.0f;
              if (inside && k < p.cin)
                v0 = staged<M>(src[k]) * in_mul[cc][0] + in_add[cc][0];
              if (inside && k + 1 < p.cin)
                v1 = staged<M>(src[k + 1]) * in_mul[cc][1] + in_add[cc][1];
              *reinterpret_cast<__nv_bfloat162*>(
                  dst + (k >> 3) * gs * 8 + (k & 7)) =
                  __floats2bfloat162_rn(v0, v1);
            } else {
              // S8Q: the affine then quant_act's quantisation; code 0
              // beyond Cin and outside the image
              uint32_t q[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                int8_t code = 0;
                if (inside && k + e < p.cin) {
                  const float v = __bfloat162float(src[k + e]);
                  code = quant(__fadd_rn(__fmul_rn(v, in_mul[cc][e]),
                                         in_add[cc][e]),
                               in_inv[cc][e]);
                }
                q[e] = static_cast<uint8_t>(code);
              }
              *reinterpret_cast<uint16_t*>(dst + (k >> 4) * gs * 16 +
                                           (k & 15)) =
                  static_cast<uint16_t>(q[0] | (q[1] << 8));
            }
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
    for (int s = s0; s < (SPLIT ? s1 : p.nslices); ++s) {
      Acc acc[R][NS / 2];
#pragma unroll
      for (int mt = 0; mt < R; ++mt)
#pragma unroll
        for (int i = 0; i < NS / 2; ++i) acc[mt][i] = 0;

      int held = -1;  // the streamed weight slot the last tap read
      for (int tap = 0; tap < taps; ++tap) {
        const unsigned char* wblk;
        int slot = -1;
        if (p.resident) {
          const int kb = (SPLIT ? s - s0 : s) * taps + tap;
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
          const TO* a0 = s_pad + ((wg * R + dy) * pw + dx) * G;
          wgmma_fence();
          for (int k = 0; k < nks; ++k) {
            const uint64_t db = desc(wblk + k * NS * 32, 128, 256);
            const TO* ak = a0 + 2 * k * gs * G;
            // one m64 tile a row; written out, not as a loop over the
            // rows, which changed the bf16 instances' code
            wgmma<F, NS>(acc[0], desc(ak, lbo_a, 128), db);
            wgmma<F, NS>(acc[1], desc(ak + pw * G, lbo_a, 128), db);
            if constexpr (R == 3)
              wgmma<F, NS>(acc[2], desc(ak + 2 * pw * G, lbo_a, 128), db);
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
      for (int mt = 0; mt < R; ++mt)
#pragma unroll
        for (int i = 0; i < NS / 2; ++i) fence_reg(acc[mt][i]);

      // epilogue: bias, activation, output affine, residual, store
      const int n0 = s * NS;
      // each m64 tile (one row) through this warpgroup's staging rows
      float* s_acc = reinterpret_cast<float*>(smem + L.stage) +
                     wg * stage_floats(NS, M);
#pragma unroll
      for (int mt = 0; mt < R; ++mt) {
        const int oy = t.ty0 + wg * R + mt;
        if (oy >= p.h) continue;  // uniform over the warpgroup
        if constexpr (planar_out(M)) {
          // transposed, s_acc[ch][px]: lanes (g, tq) store to banks
          // 8 tq + g, all distinct
#pragma unroll
          for (int i = 0; i < NS / 2; i += 2) {
            const int j = i >> 2, e = i & 3;
            const int px = wq * 16 + g + (e >> 1) * 8, ch = j * 8 + tq * 2;
            s_acc[ch * (TW + 4) + px] = acc[mt][i];
            s_acc[(ch + 1) * (TW + 4) + px] = acc[mt][i + 1];
          }
        } else {
#pragma unroll
          for (int i = 0; i < NS / 2; i += 2) {
            const int j = i >> 2, e = i & 3;
            const int px = wq * 16 + g + (e >> 1) * 8;
            // an int32 sum converts to the nearest float, as the plain
            // version's exact sum does
            *reinterpret_cast<float2*>(s_acc + px * (NS + 4) + j * 8 +
                                       tq * 2) =
                make_float2(static_cast<float>(acc[mt][i]),
                            static_cast<float>(acc[mt][i + 1]));
          }
        }
        wg_sync(wg);
        if constexpr (M == MODE_PLANAR_OUT)
          epilogue_planar<NS, P>(p, s_acc, oy, t.tx0, n0, wq, lane);
        else if constexpr (M == MODE_PLANAR_IO)
          epilogue_planar_io<NS, P>(p, s_acc, oy, t.tx0, n0, wq, lane);
        else if constexpr (M == MODE_SIN_RESIDUAL)
          epilogue_row_sin<NS, P, F>(p, s_acc, t.b, oy, t.tx0, n0, wq, lane);
        else
          epilogue_row<NS, P, F>(p, s_acc, t.b, oy, t.tx0, n0, wq, lane);
        wg_sync(wg);
      }
    }
  }
}

// ------------------------------------------------------------- host ---

// Bytes of one raw row slot: the widest row span of an input of ei-byte
// elements plus its 16-byte widening, rounded up to 16.
inline int raw_pitch(int ks, int cin, int ei = 2) {
  return ((TW + ks - 1) * cin * ei + 30 + 15) / 16 * 16;
}

// The raw "row" bytes of a MODE_PLANAR_IN launch at nwg warpgroups: its
// box, PBX x planar_rows(nwg) x cin x 4 planes of bf16, spread over the
// raw buffer's tile_h + 2 slots (rounded up to 16).
inline int planar_raw_pitch(int cin, int nwg) {
  const int box = PBX * planar_rows(nwg) * cin * 4 * 2;
  const int slots = tile_h(nwg) + 2;
  return ((box + slots - 1) / slots + 15) / 16 * 16;
}

// Output rows a consumer warpgroup of a launch at N slice ns in form f
// (conv_sm90.py::rows_at mirrors it).
inline int rows_of(int ns, int f) {
  return f != FORM_BF16 && ns == 64 ? ROWS_S8_64 : ROWS_PER_WG;
}

// The shared-memory plan of a launch of form f in mode m: warpgroups (2,
// else 1; at most max_nwg) and the weight ring (every block resident, else
// the deepest ring up to MAX_WS that fits, at least 2); in a planar-input
// mode the raw pitch of the planar box at those warpgroups.
// Fills p and returns the bytes, or -1 where nothing fits.
// MODE_KLOOP streams its weights (a chunk's blocks are not resident).
inline int fit(Params& p, int ns, int f = FORM_BF16, int max_nwg = 2,
               int m = MODE_NONE) {
  const int rows = rows_of(ns, f);
  const int kblocks = p.nslices * p.ks * p.ks;
  const bool stream = m == MODE_KLOOP;
  for (int nwg = max_nwg; nwg >= 1; --nwg) {
    if (planar_in(m)) p.raw_pitch = planar_raw_pitch(p.cin, nwg);
    for (int ws = stream ? MAX_WS : kblocks; ws >= 1;) {
      const Layout l = mode_layout(
          layout(p.ks, p.cin_pad, p.raw_pitch, nwg, ws, ns, rows,
                 op_bytes(f)),
          m, nwg, ns);
      if (l.total <= MAX_SMEM) {
        p.nwg = nwg;
        p.ws = ws;
        p.resident = !stream && ws == kblocks;
        return l.total;
      }
      ws = !stream && ws == kblocks ? std::min(kblocks - 1, MAX_WS) : ws - 1;
      if (ws < 2) break;
    }
  }
  return -1;
}

// The N slices with an instance: 8, 56, 64, 80 in bf16; 8, 64, 80 in
// int8 (the integer wgmma shapes have no N 56).
inline bool valid_ns(int ns, int f = FORM_BF16) {
  return ns == 8 || ns == 64 || ns == 80 || (f == FORM_BF16 && ns == 56);
}

// Fills the shape fields of p; false for a shape the kernel does not
// take.  Cin is padded to whole K steps: 16 channels in bf16, 32 in int8.
// In MODE_KLOOP (bf16, Cin padded beyond MAX_CIN_PAD, up to
// MAX_CIN_KLOOP) cin_pad is a chunk's KC.
inline bool shape(Params& p, int cin, int cout, int ks, int ns,
                  int f = FORM_BF16, int m = MODE_NONE) {
  const int kstep = 32 / op_bytes(f);
  p.cin = cin;
  p.cout = cout;
  p.ks = ks;
  p.cin_pad = (cin + kstep - 1) / kstep * kstep;
  p.nslices = (cout + ns - 1) / ns;
  p.raw_pitch = raw_pitch(ks, cin, in_bytes(f));
  const int max_cin = m == MODE_KLOOP ? MAX_CIN_KLOOP : MAX_CIN_PAD;
  const bool wide = p.cin_pad > MAX_CIN_PAD;
  if (m == MODE_KLOOP) p.cin_pad = KC;
  return (ks == 1 || ks == 3 || ks == 5) && cin >= 1 && cout >= 1 &&
         (cin + kstep - 1) / kstep * kstep <= max_cin &&
         wide == (m == MODE_KLOOP) && valid_ns(ns, f);
}

// Fills p from a C entry point's arguments and plans its shared memory
// (at most max_nwg warpgroups; mode m): the bytes, or -1 for a launch the
// kernel does not take (a mode takes bf16 only, a planar one 3 x 3 on one
// image of even height and width; a mode other than MODE_KLOOP no shuffle
// and no int8 store).
inline int prepare(Params& p, const void* x, const void* wpk,
                   const void* bias, const void* in_scale,
                   const void* in_shift, const void* out_scale,
                   const void* out_shift, const void* residual,
                   const void* out_inv, void* out, int n, int h, int w,
                   int cin, int cout, int act, int shuffle, int ks, int ns,
                   int f = FORM_BF16, int max_nwg = 2, int m = MODE_NONE) {
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
  if (!shape(p, cin, cout, ks, ns, f, m) || n < 1 || h < 1 || w < 1 ||
      (shuffle && cout % 4 != 0) || act < ACT_NONE || act > ACT_OUTIMG ||
      (reinterpret_cast<uintptr_t>(wpk) & 15) != 0 ||
      (m != MODE_NONE &&
       (f != FORM_BF16 || (m != MODE_KLOOP && (shuffle || out_inv)))) ||
      (planar_mode(m) && (ks != 3 || n != 1 || h % 2 || w % 2)))
    return -1;
  const int smem =
      max_nwg < 1 || max_nwg > 2 ? -1 : fit(p, ns, f, max_nwg, m);
  const int rows = rows_of(ns, f);
  p.tiles_w = (w + TW - 1) / TW;
  p.tiles_h =
      smem < 0 ? 0 : (h + tile_h(p.nwg, rows) - 1) / tile_h(p.nwg, rows);
  return smem;
}

// The slice-group plan of a launch of `tiles` output tiles and `nslices` N
// slices on `sms` SMs holding `per_sm` blocks each (conv_sm90.py::groups
// mirrors it): G = 1 where the tiles fill FULL_WAVES waves of blocks or
// more; else the G groups of consecutive slices, none empty, each block
// taking one group's slices of its tiles (a grid of blocks(tiles, G, ...)
// x G), that minimise rounds x (REPACK_COST + SLICE_COST x slices a
// group), rounds being the tiles a block walks (each group repacks its
// tiles again); the least such G.  The costs are fitted to the times of
// every G at the bench config's 45 x 80 and 135 x 240 launches on an H100
// (chip_smoke.py's "schedule" lines), where they order the G as measured.
constexpr int FULL_WAVES = 4;
constexpr int REPACK_COST = 1;  // a tile's repack, against
constexpr int SLICE_COST = 4;   // one slice's GEMM and epilogue

inline int blocks(int tiles, int groups, int sms, int per_sm) {
  return std::max(1, std::min(tiles, sms * std::max(per_sm, 1) / groups));
}

inline int groups(int tiles, int nslices, int sms, int per_sm) {
  if (tiles >= FULL_WAVES * sms * std::max(per_sm, 1)) return 1;
  int best = 1;
  long long best_cost = 0;
  for (int g = 1; g <= nslices; ++g) {
    const int per = (nslices + g - 1) / g;
    if ((nslices + per - 1) / per != g) continue;  // a group would be empty
    const int bx = blocks(tiles, g, sms, per_sm);
    const long long cost = (long long)((tiles + bx - 1) / bx) *
                           (REPACK_COST + SLICE_COST * per);
    if (g == 1 || cost < best_cost) {
      best = g;
      best_cost = cost;
    }
  }
  return best;
}

// SMs and the blocks of `kernel` an SM holds at `threads` and `smem`.
template <typename K>
cudaError_t occupancy(K kernel, int threads, int smem, int& sms,
                      int& per_sm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  return err;
}

// Instance <NS, P, F, R, SPLIT, M>, allowed MAX_SMEM bytes of dynamic
// shared memory (set once), in `kernel`.
template <int NS, int P, int F, int R, bool SPLIT, int M = MODE_NONE>
cudaError_t instance(void (*&kernel)(ParamsOf<F, M>)) {
  kernel = conv_sm90_kernel<NS, P, F, R, SPLIT, M>;
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  return cudaSuccess;
}

// One launch of instance <NS, P, F, R, SPLIT, M>: a grid of blocks(tiles,
// groups, ...) x groups blocks (groups > 1 only in a SPLIT instance).
template <int NS, int P, int F = FORM_BF16, int R = ROWS_PER_WG,
          bool SPLIT = false, int M = MODE_NONE>
int launch(const ParamsOf<F, M>& p, int smem, cudaStream_t s,
           int groups = 1) {
  void (*kernel)(ParamsOf<F, M>) = nullptr;
  cudaError_t err = instance<NS, P, F, R, SPLIT, M>(kernel);
  const int threads = 128 * p.nwg + PRODUCER;
  int sms = 0, per_sm = 0;
  if (err == cudaSuccess)
    err = occupancy(kernel, threads, smem, sms, per_sm);
  if (err != cudaSuccess) return err;
  const int tiles = p.tiles_w * p.tiles_h * p.n;
  kernel<<<dim3(blocks(tiles, groups, sms, per_sm), groups), threads, smem,
           s>>>(p);
  return cudaGetLastError();
}

// The inputs of the slice-group plan of a bf16 launch p of the production
// instance at N slice NS in mode M: {tiles, N slices, SMs, blocks an SM}
// into info (sm90::groups takes them); the occupancy query's error.
template <int NS, int M = MODE_NONE>
cudaError_t plan_info(const ParamsOf<FORM_BF16, M>& p, int smem,
                      int* info) {
  void (*kernel)(ParamsOf<FORM_BF16, M>) = nullptr;
  cudaError_t err =
      instance<NS, PHASE_ALL, FORM_BF16, ROWS_PER_WG, false, M>(kernel);
  if (err == cudaSuccess)
    err = occupancy(kernel, 128 * p.nwg + PRODUCER, smem, info[2], info[3]);
  info[0] = p.tiles_w * p.tiles_h * p.n;
  info[1] = p.nslices;
  return err;
}

// The slice-group plan of a launch in mode M, which takes one group (no
// SPLIT instance): its inputs into info and G = 1, or -1 where the
// occupancy query fails.
template <int NS, int M>
int mode_plan(const ParamsOf<FORM_BF16, M>& p, int smem, int* info) {
  return plan_info<NS, M>(p, smem, info) == cudaSuccess ? 1 : -1;
}

// An int8-form launch of form f (FORM_S8 or FORM_S8Q).
template <int NS, int P = PHASE_ALL, int R = ROWS_PER_WG>
int launch_s8(const ParamsS8& p, int smem, int f, cudaStream_t s) {
  return f == FORM_S8 ? launch<NS, P, FORM_S8, R>(p, smem, s)
                      : launch<NS, P, FORM_S8Q, R>(p, smem, s);
}

// The knockout instance <NS, mask, F, R> of a probe launch (K5); mask is
// one of PROBE_MASKS.
constexpr int PROBE_MASKS[] = {
    PHASE_ALL, PHASE_ALL & ~PHASE_STAGE, PHASE_ALL & ~PHASE_GEMM,
    PHASE_ALL & ~PHASE_EPI, PHASE_ALL & ~PHASE_STORE};

template <int NS, int F = FORM_BF16, int R = ROWS_PER_WG, int I = 0>
int launch_masked(int phases, const ParamsOf<F>& p, int smem,
                  cudaStream_t s) {
  if constexpr (I < 5) {
    if (phases == PROBE_MASKS[I])
      return launch<NS, PROBE_MASKS[I], F, R>(p, smem, s);
    return launch_masked<NS, F, R, I + 1>(phases, p, smem, s);
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

// The same (K5) on the int8 form's instances that the W8A8 stages' chains
// launch: N 8 codes in (the head), N 64 codes in and bf16 in (ROWS_S8_64
// rows a warpgroup), N 80 codes in (stage 6's upconv), each defined by
// its own probe unit (conv_sm90_i8_probe*.cu).
int launch_probe_s8_8(const ParamsS8& p, int smem, int phases,
                      cudaStream_t s);
int launch_probe_s8_64(const ParamsS8& p, int smem, int phases,
                       cudaStream_t s);
int launch_probe_s8_64q(const ParamsS8& p, int smem, int phases,
                        cudaStream_t s);
int launch_probe_s8_80(const ParamsS8& p, int smem, int phases,
                       cudaStream_t s);

// The bf16 form's launches of one slice group a block (SPLIT instances,
// groups > 1), defined by conv_sm90_split.cu.
int launch_split(int ns, const Params& p, int smem, int groups,
                 cudaStream_t s);

// The int8 form's production launches (form f) at N slice 8, 64 (at
// ROWS_S8_64 rows a warpgroup) and 80, each N defined by its own unit
// (conv_sm90_i8*.cu), so that their instances compile in parallel.
int launch_s8_8(const ParamsS8& p, int smem, int f, cudaStream_t s);
int launch_s8_64(const ParamsS8& p, int smem, int f, cudaStream_t s);
int launch_s8_80(const ParamsS8& p, int smem, int f, cudaStream_t s);

}  // namespace sm90
