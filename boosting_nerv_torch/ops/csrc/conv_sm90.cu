// The Hopper bf16 conv kernel: a same-padded KS x KS convolution (KS in
// {1, 3, 5}, Cin <= 128; up to 256 on the K-loop instances of
// conv_sm90_kloop.cu) of NHWC bf16 with an OHWI weight, fp32
// accumulation on the tensor cores with wgmma, and the fused prologue and
// epilogue of the stage kernel (stage_conv.cu):
//
//   prologue: x * (in_scale + 1) + in_shift per input channel, on in-image
//             taps only (zero padding stays exactly 0);
//   epilogue: + bias; act none / sin / gelu / outimg; * (out_scale + 1) +
//             out_shift; + residual; a bf16 store, or int8 codes
//             clip(rint(v * out_inv), +-127); PixelShuffle(2) folded into
//             the store addressing.
//
// It replaces eight Pallas kernels of boosting_nerv_tpu/ops/pallas/:
// tile_conv.py:144 conv_tile (k x k conv + bias, one launch),
// tile_conv.py:473 conv_tile_v3 (k in {1, 3}, + none / sin / outimg /
// gelu in the epilogue, one launch), tile_conv.py:951 resblock_sft_tile
// and tile_conv.py:788 resblock_sft_tile_v3 (the ResBlockSFT pair: conv0
// with both affines and gelu, conv1 with the residual; two launches),
// ops/kernels/tile_conv.py; planar.py:1308 fused_upconv_rsft (the
// stride-2 stage: upconv with shuffle and sin, then the pair with the
// optional int8-code store; three launches) and planar.py:1541
// fused_conv_rsft in bf16 (the stride-1 stage: conv and sin, the pair,
// the optional 51 -> 3 head with outimg; three or four launches),
// ops/kernels/planar.py through ops/kernels/conv_sm90.py; fused_sft.py:138
// resblock_sft_chw (the pair; with input_sin on its sin instances,
// conv_sm90_sin.cu) and conv_chw.py:64 _run (conv3x3_act_chw :88, sin;
// head_conv_chw :95, outimg; one launch each), ops/kernels/fused_sft.py
// and conv_chw.py.  Its int8 form (conv_sm90_i8.cu) serves the W8A8 forms
// of fused_upconv_rsft and fused_conv_rsft, its planar instances
// (conv_sm90_planar.cu) the planar entry points rsft_planar and
// conv_planar.  No wrapper launches the stage kernel stage_conv.cu any
// more: it serves the K1 probes and chip_smoke.py's A/B.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): conv_tile's
// v2 stage-6 call (540x960, 61 -> 204) is 116 GFLOP, 0.117 ms of tensor
// cores; its stage-7 call (1080x1920, 51 -> 51) moves 423 MB, 0.126 ms of
// HBM (0.098 ms of tensor cores); fused_upconv_rsft's stage 6 (540x960x61
// -> 1080x1920x51) is 0.314 ms of tensor cores.  The stage kernel ran
// these at 3-13% of the bound, its time split between staging (one 2-byte
// load per lane and channel, since C = 51, 61, 73 are odd, redone by every
// output-channel chunk), the mma.sync fragment loop (32-bit shared-memory
// fragment loads, a third of the peak at best) and no overlap of the two
// inside a block.  This design answers each:
//
// - Each input tile is staged once for all output channels: one block
//   loops over the N slices (NS channels each) of one staged tile; the
//   weights of all slices stay resident when they fit the shared memory
//   beside the tile (51, 61 -> same width), else they are streamed per
//   tile as (slice, tap) blocks through a ring of up to eight (61 -> 204:
//   27 blocks of 10 KB), from L2.
// - Staging is asynchronous: a producer warp issues one bulk copy (TMA)
//   per input row of the halo'd tile, the flat byte span of its pixels
//   widened to 16-byte bounds, so any row pitch and any C is taken.  The
//   consumers repack the raw rows from shared memory into the operand tile
//   (prologue and padding mask applied, two channels a lane), release the
//   raw buffer, and the next tile's rows land while they run the GEMM and
//   the epilogue: raw buffer -> operand tile is the two-buffer pipeline,
//   ordered by a full/empty mbarrier pair (a second raw buffer measured
//   slower: it cost the head's call its second block per SM), the weight
//   ring by one pair per slot.
// - The tensor cores are fed by wgmma m64nNSk16 with both operands in
//   shared memory.  The operand tile is laid out [8-channel group][pixel]
//   [8], so that the eight rows of a no-swizzle core matrix are eight
//   consecutive pixels of a tile row: a tap's shift of whole pixels is a
//   start address, which a swizzled layout could not express and which
//   spares the A fragments' register staging (ldmatrix) altogether.  B is
//   packed on the host into the same core-matrix layout
//   (ops/kernels/conv_sm90.py::pack_weight).  A tap's wgmmas issue back to
//   back and run asynchronously; a streamed weight block is released when
//   the next tap's group has been committed and the previous one is done.
// - The epilogue stages each warpgroup's sums of one output row in shared
//   memory, then stores them with a warp per pixel and its lanes on
//   consecutive channels (contiguous NHWC stores, not the accumulators'
//   scattered 2-byte ones), in one non-inlined function whose activation
//   and store kind are template arguments: an epilogue unrolled per
//   accumulator register, with the runtime activation switch in each
//   copy, overflowed the instruction cache and cost more than the GEMM.
// - The epilogue, the largest phase (36-42% of a stride-1 stage by the
//   phase probes, K5: conv_sm90_probe.cu), was a chain of dependent
//   latencies per element (its residual load, its activation) with two
//   warps a scheduler to hide them.  It works out each row's base
//   address, its pixel stride and each lane's channel offsets once, so
//   that an element's address is two adds (PixelShuffle included), and a
//   warp keeps two pixels in flight (N 56, 64, 80; the N 8 head keeps
//   the element-by-element loop, which measured faster there).  The two
//   warpgroups meet only at the repack, so one's epilogue already runs
//   beside the other's wgmmas; a ping-pong schedule (a 2 x 64 tile per
//   warpgroup, turns on the tensor cores) measured slower, its extra halo
//   rows costing more than the GEMM time it hid.
//
// The tile is 4 x 64 output pixels (two consumer warpgroups, each two m64
// tiles, one a row), or 2 x 64 with one warpgroup where the larger tile
// does not fit the shared memory.
//
// - A launch of few tiles and many N slices left most SMs idle: at the
//   bench config the fine-grid decodes' 45 x 80 calls (stage 1's conv,
//   106 -> 792 in ten N 80 slices, 46 tiles; stage 0's ResBlockSFT) ran
//   one block a tile, each through all its slices in turn.  The slice-
//   group plan (sm90::groups, at the occupancy of this unit's instances)
//   splits such a launch's slices into G groups of consecutive slices, a
//   grid of blocks x G, each block repacking its tiles for its group
//   alone (the SPLIT instances of conv_sm90_split.cu; a group's weight
//   blocks resident where they fit), and keeps G = 1, and these
//   instances' code, wherever the tiles fill the card.

#include "conv_sm90.cuh"

namespace {

// The bf16 launch of p at N slice NS with `groups` slice groups (0: the
// plan's, sm90::groups at the occupancy of the instance with none); with
// `info`, the plan alone: {tiles, N slices, SMs, blocks an SM} into info
// and G returned, nothing launched.
template <int NS>
int run(sm90::Params& p, int smem, int groups, cudaStream_t s, int* info) {
  int g = groups;
  if (g == 0 || info) {
    int plan[4] = {};
    const cudaError_t err = sm90::plan_info<NS>(p, smem, plan);
    if (err != cudaSuccess) return info ? -1 : err;
    const int planned = sm90::groups(plan[0], plan[1], plan[2], plan[3]);
    if (info) {
      std::copy(plan, plan + 4, info);
      return planned;
    }
    g = planned;
  }
  const int per = (p.nslices + g - 1) / g;
  if (g < 1 || g > p.nslices || (p.nslices + per - 1) / per != g)
    return cudaErrorInvalidValue;  // a group would be empty
  if (g == 1) return sm90::launch<NS, PHASE_ALL>(p, smem, s);
  // a group's weight blocks: resident where they fit, at the same
  // warpgroups (and so the same tiles)
  sm90::Params q = p;
  q.nslices = per;
  const int gsmem = sm90::fit(q, NS, sm90::FORM_BF16, p.nwg);
  if (gsmem < 0 || q.nwg != p.nwg) return cudaErrorInvalidValue;
  q.nslices = p.nslices;
  return sm90::launch_split(NS, q, gsmem, g, s);
}

// The launch's plan (prepare) and its run at N slice ns.
int conv(const void* x, const void* wpk, const void* bias,
         const void* in_scale, const void* in_shift, const void* out_scale,
         const void* out_shift, const void* residual, const void* out_inv,
         void* out, int n, int h, int w, int cin, int cout, int act,
         int shuffle, int ks, int ns, int groups, int max_nwg,
         cudaStream_t s, int* info) {
  sm90::Params p{};
  const int smem = sm90::prepare(p, x, wpk, bias, in_scale, in_shift,
                                 out_scale, out_shift, residual, out_inv,
                                 out, n, h, w, cin, cout, act, shuffle, ks,
                                 ns, sm90::FORM_BF16, max_nwg);
  if (smem < 0 || groups < 0) return info ? -1 : cudaErrorInvalidValue;
  switch (ns) {
    case 8: return run<8>(p, smem, groups, s, info);
    case 56: return run<56>(p, smem, groups, s, info);
    case 64: return run<64>(p, smem, groups, s, info);
    default: return run<80>(p, smem, groups, s, info);
  }
}

}  // namespace

extern "C" {

// Shared memory of one launch (bytes) with N slices of ns channels, or -1
// for a shape the kernel does not take: ks not in {1, 3, 5}, more than
// MAX_CIN_PAD input channels, an ns without an instance, or no plan that
// fits the card's shared memory.
int bnt_conv_sm90_smem(int cin, int cout, int ks, int ns) {
  sm90::Params p{};
  if (!sm90::shape(p, cin, cout, ks, ns)) return -1;
  return sm90::fit(p, ns);
}

// One fused ks x ks convolution on the given stream; wpk is the weight
// packed for ns-channel slices (conv_sm90.py::pack_weight).  Pointers may
// be null where the comment on sm90::Params allows it.  The slice groups
// are the plan's (sm90::groups).  Returns cudaGetLastError() after the
// launch (0 on success).
int bnt_conv_sm90(const void* x, const void* wpk, const void* bias,
                  const void* in_scale, const void* in_shift,
                  const void* out_scale, const void* out_shift,
                  const void* residual, const void* out_inv, void* out,
                  int n, int h, int w, int cin, int cout, int act,
                  int shuffle, int ks, int ns, void* stream) {
  return conv(x, wpk, bias, in_scale, in_shift, out_scale, out_shift,
              residual, out_inv, out, n, h, w, cin, cout, act, shuffle, ks,
              ns, 0, 2, static_cast<cudaStream_t>(stream), nullptr);
}

// The same launch at a schedule the caller gives (for measuring the
// plan): `groups` slice groups (0: the plan's) and at most `max_nwg`
// warpgroups (1 or 2).
int bnt_conv_sm90_at(const void* x, const void* wpk, const void* bias,
                     const void* in_scale, const void* in_shift,
                     const void* out_scale, const void* out_shift,
                     const void* residual, const void* out_inv, void* out,
                     int n, int h, int w, int cin, int cout, int act,
                     int shuffle, int ks, int ns, int groups, int max_nwg,
                     void* stream) {
  return conv(x, wpk, bias, in_scale, in_shift, out_scale, out_shift,
              residual, out_inv, out, n, h, w, cin, cout, act, shuffle, ks,
              ns, groups, max_nwg, static_cast<cudaStream_t>(stream),
              nullptr);
}

// The slice-group plan of a launch of n x h x w pixels, cin -> cout, at
// N slice ns (sm90::groups): G, with info = {tiles, N slices, SMs, blocks
// an SM}; -1 for a launch the kernel does not take.
int bnt_conv_sm90_groups(int n, int h, int w, int cin, int cout, int ks,
                         int ns, int* info) {
  alignas(16) static const unsigned char wpk[16] = {};  // no weight read
  return conv(nullptr, wpk, nullptr, nullptr, nullptr, nullptr, nullptr,
              nullptr, nullptr, nullptr, n, h, w, cin, cout, 0, 0, ks, ns, 0,
              2, nullptr, info);
}

}  // extern "C"
