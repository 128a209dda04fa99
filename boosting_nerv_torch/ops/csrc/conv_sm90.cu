// The Hopper bf16 conv kernel: a same-padded KS x KS convolution (KS in
// {1, 3, 5}, Cin <= 128) of NHWC bf16 with an OHWI weight, fp32
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
// It replaces two Pallas kernels of boosting_nerv_tpu/ops/pallas/:
// tile_conv.py:144 conv_tile (k x k conv + bias, one launch,
// ops/kernels/tile_conv.py) and planar.py:1308 fused_upconv_rsft (the
// stride-2 stage: upconv with shuffle and sin, rsft 0 with both affines
// and gelu, rsft 1 with the residual and the optional int8-code store;
// three launches, ops/kernels/planar.py).  Every other wrapper stays on
// stage_conv.cu.
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
//
// The tile is 4 x 64 output pixels (two consumer warpgroups, each two m64
// tiles, one a row), or 2 x 64 with one warpgroup where the larger tile
// does not fit the shared memory.

#include "conv_sm90.cuh"

namespace {

using sm90::Params;  // MAX_SMEM: stage_common.cuh, the card's opt-in limit

// Bytes of one raw row slot: the widest row span plus its 16-byte
// widening, rounded up to 16.
int raw_pitch(int ks, int cin) {
  return ((sm90::TW + ks - 1) * cin * 2 + 30 + 15) / 16 * 16;
}

// The shared-memory plan of a launch: warpgroups (2, else 1) and the
// weight ring (every block resident, else the deepest ring up to MAX_WS
// that fits, at least 2).  Fills p and returns the bytes, or -1 where
// nothing fits.
int fit(Params& p, int ns) {
  const int kblocks = p.nslices * p.ks * p.ks;
  for (int nwg = 2; nwg >= 1; --nwg) {
    for (int ws = kblocks; ws >= 1;) {
      const sm90::Layout l =
          sm90::layout(p.ks, p.cin_pad, p.raw_pitch, nwg, ws, ns);
      if (l.total <= MAX_SMEM) {
        p.nwg = nwg;
        p.ws = ws;
        p.resident = ws == kblocks;
        return l.total;
      }
      ws = ws == kblocks ? std::min(kblocks - 1, sm90::MAX_WS) : ws - 1;
      if (ws < 2) break;
    }
  }
  return -1;
}

bool valid_ns(int ns) {
  return ns == 8 || ns == 56 || ns == 64 || ns == 80;
}

// Fills the shape fields of p; false for a shape the kernel does not take.
bool shape(Params& p, int cin, int cout, int ks, int ns) {
  p.cin = cin;
  p.cout = cout;
  p.ks = ks;
  p.cin_pad = (cin + 15) / 16 * 16;
  p.nslices = (cout + ns - 1) / ns;
  p.raw_pitch = raw_pitch(ks, cin);
  return (ks == 1 || ks == 3 || ks == 5) && cin >= 1 && cout >= 1 &&
         p.cin_pad <= sm90::MAX_CIN_PAD && valid_ns(ns);
}

template <int NS>
int launch(const Params& p, int smem, cudaStream_t s) {
  auto kernel = sm90::conv_sm90_kernel<NS>;
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  const int threads = 128 * p.nwg + sm90::PRODUCER;
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

}  // namespace

extern "C" {

// Shared memory of one launch (bytes) with N slices of ns channels, or -1
// for a shape the kernel does not take: ks not in {1, 3, 5}, more than
// MAX_CIN_PAD input channels, an ns without an instance, or no plan that
// fits the card's shared memory.
int bnt_conv_sm90_smem(int cin, int cout, int ks, int ns) {
  Params p{};
  if (!shape(p, cin, cout, ks, ns)) return -1;
  return fit(p, ns);
}

// One fused ks x ks convolution on the given stream; wpk is the weight
// packed for ns-channel slices (conv_sm90.py::pack_weight).  Pointers may
// be null where the comment on sm90::Params allows it.  Returns
// cudaGetLastError() after the launch (0 on success).
int bnt_conv_sm90(const void* x, const void* wpk, const void* bias,
                  const void* in_scale, const void* in_shift,
                  const void* out_scale, const void* out_shift,
                  const void* residual, const void* out_inv, void* out,
                  int n, int h, int w, int cin, int cout, int act,
                  int shuffle, int ks, int ns, void* stream) {
  Params p{};
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
    return cudaErrorInvalidValue;
  const int smem = fit(p, ns);
  if (smem < 0) return cudaErrorInvalidValue;
  p.tiles_w = (w + sm90::TW - 1) / sm90::TW;
  p.tiles_h = (h + sm90::tile_h(p.nwg) - 1) / sm90::tile_h(p.nwg);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ns) {
    case 8: return launch<8>(p, smem, s);
    case 56: return launch<56>(p, smem, s);
    case 64: return launch<64>(p, smem, s);
    default: return launch<80>(p, smem, s);
  }
}

}  // extern "C"
