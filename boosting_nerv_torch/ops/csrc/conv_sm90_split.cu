// The SPLIT instances of the bf16 Hopper conv kernel (conv_sm90.cuh), N 8,
// 56, 64 and 80, compiled beside conv_sm90.cu's: each block takes one
// group of a launch's N slices, repacking its tiles for that group alone,
// so that a launch of few tiles and many slices (the 45 x 80 and
// 135 x 240 calls of the fine-grid decodes at the bench config) fills the
// card's SMs (sm90::groups plans it).  conv_sm90.cu's instances, which
// take every slice of a tile, keep their code.  Only conv_sm90.cu calls
// launch_split, after checking the plan.

#include "conv_sm90.cuh"

int sm90::launch_split(int ns, const Params& p, int smem, int groups,
                       cudaStream_t s) {
  switch (ns) {
    case 8:
      return launch<8, PHASE_ALL, FORM_BF16, ROWS_PER_WG, true>(p, smem, s,
                                                                 groups);
    case 56:
      return launch<56, PHASE_ALL, FORM_BF16, ROWS_PER_WG, true>(p, smem, s,
                                                                  groups);
    case 64:
      return launch<64, PHASE_ALL, FORM_BF16, ROWS_PER_WG, true>(p, smem, s,
                                                                  groups);
    default:
      return launch<80, PHASE_ALL, FORM_BF16, ROWS_PER_WG, true>(p, smem, s,
                                                                  groups);
  }
}
