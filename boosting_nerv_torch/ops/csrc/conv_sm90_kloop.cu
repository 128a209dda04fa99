// The K-loop instances of the bf16 Hopper conv kernel (conv_sm90.cuh, mode
// MODE_KLOOP at N 8, 56, 64 and 80), compiled beside conv_sm90.cu's, whose
// instances keep their code: a same-padded ks x ks convolution as
// bnt_conv_sm90 computes it (every prologue and epilogue option, the
// PixelShuffle store and the int8-code store included) of an input of more
// than MAX_CIN_PAD channels, padded to 16, up to MAX_CIN_KLOOP.  It serves
// the stride-2 stage whose input is wider than 128 channels: stage 2 of
// E-NeRV-Boost at UVG-1080p (172 -> 4 x 86 at 10M, 213 -> 4 x 106 at
// 15M), the upconv of ops/kernels/planar.py::fused_upconv_rsft, the port
// of boosting_nerv_tpu/ops/pallas/planar.py:1308, whose K-buffers take
// any Cin.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): at
// 135 x 240 x 172 -> 4 x 86 the conv is 2 x 9 x 172 x 344 multiply-adds a
// pixel, 34.5 GFLOP, 0.035 ms of tensor cores; its 11 MB in and 22 MB out
// take 0.010 ms of HBM.  The operand tile and a weight block of 128 or
// more channels do not fit the shared memory beside the raw rows of 176
// channels, so the design keeps the kernel's and changes one thing: the K
// of a slice is a loop over chunks of KC (64) input channels.
//
// - The producer's copies are MODE_NONE's: one bulk copy per input row of
//   the halo'd tile, all Cin channels, into the raw buffer.
// - The consumers repack one chunk of the raw rows into the operand tile
//   (KC channels: a lane takes two of a pixel), run its taps' wgmmas into
//   the slice's accumulators, and go on to the next chunk; the epilogue
//   runs once, after the last chunk.  A slice walks the chunks in the
//   order opposite to the previous slice's (chunk_at), so that it starts
//   on the chunk the operand tile already holds: nslices (nkc - 1) + 1
//   repacks a tile, not nslices nkc.  The tile's last repack releases the
//   raw buffer, so the next tile's rows land during the last chunks'
//   GEMM and the epilogues.
// - The weights are packed [slice][chunk][tap][K step]... (blocks of NS x
//   KC, Cin padded to KC with zeros: every chunk's K-step count is the
//   same, which keeps ptxas from serialising the wgmmas) and streamed
//   through the ring in the consumers' order, a block a ring slot.
// The raw rows of all Cin channels fit one warpgroup's tile (2 x 64
// pixels): at 176 channels they take 93 KB, the operand tile 35 KB, the
// ring eight slots of up to 10 KB (N 80).

#include "conv_sm90.cuh"

namespace {

// The launch of p at N slice NS, or with `info` its plan alone.
template <int NS>
int run(const sm90::ParamsKloop& p, int smem, cudaStream_t s, int* info) {
  constexpr int M = sm90::MODE_KLOOP;
  return info ? sm90::mode_plan<NS, M>(p, smem, info)
              : sm90::launch<NS, PHASE_ALL, sm90::FORM_BF16,
                             sm90::ROWS_PER_WG, false, M>(p, smem, s);
}

}  // namespace

extern "C" {

// Shared memory of one K-loop launch (bytes) with N slices of ns channels,
// or -1 for a shape it does not take: ks not in {1, 3, 5}, Cin padded to
// 16 at most MAX_CIN_PAD or beyond MAX_CIN_KLOOP, an ns without an
// instance, or no plan that fits the card's shared memory.
int bnt_conv_sm90_kloop_smem(int cin, int cout, int ks, int ns) {
  sm90::Params p{};
  if (!sm90::shape(p, cin, cout, ks, ns, sm90::FORM_BF16, sm90::MODE_KLOOP))
    return -1;
  return sm90::fit(p, ns, sm90::FORM_BF16, 2, sm90::MODE_KLOOP);
}

// One fused ks x ks convolution as bnt_conv_sm90 (conv_sm90.cu) computes
// it, of an input whose Cin is padded beyond MAX_CIN_PAD; wpk is the
// weight packed for ns-channel slices in chunks of KC input channels
// (conv_sm90.py::pack_weight).  With `info` not null nothing is launched:
// info = {tiles, N slices, SMs, blocks an SM} and the slice groups (1) are
// returned, -1 for a launch the kernel does not take.  Else returns
// cudaGetLastError() after the launch (0 on success).
int bnt_conv_sm90_kloop(const void* x, const void* wpk, const void* bias,
                        const void* in_scale, const void* in_shift,
                        const void* out_scale, const void* out_shift,
                        const void* residual, const void* out_inv, void* out,
                        int n, int h, int w, int cin, int cout, int act,
                        int shuffle, int ks, int ns, int* info,
                        void* stream) {
  sm90::ParamsKloop p{};
  const int smem = sm90::prepare(
      p, x, wpk, bias, in_scale, in_shift, out_scale, out_shift, residual,
      out_inv, out, n, h, w, cin, cout, act, shuffle, ks, ns,
      sm90::FORM_BF16, 2, sm90::MODE_KLOOP);
  if (smem < 0) return info ? -1 : cudaErrorInvalidValue;
  p.nkc = (cin + sm90::KC - 1) / sm90::KC;
  p.cin_all = p.nkc * sm90::KC;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ns) {
    case 8: return run<8>(p, smem, s, info);
    case 56: return run<56>(p, smem, s, info);
    case 64: return run<64>(p, smem, s, info);
    default: return run<80>(p, smem, s, info);
  }
}

}  // extern "C"
