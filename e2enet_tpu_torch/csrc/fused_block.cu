// Fused shiftConvPP block for NVIDIA Hopper (sm_90a), bfloat16.
//
// Replaces the Pallas TPU kernel e2enet_tpu/ops/fused_block.py:_kernel
// (fused_shift_conv_block). For an implicit channel concat of up to four
// channels-last parts x_p (N, D, H, W, C_p) it computes
//
//   u_p = lrelu(x_p * mult_p + off_p)       f32, rounded to bf16 (parts that
//                                           carry a pending norm only)
//   S   = depth_shift(concat(u_p))          channel groups of the whole
//                                           concat; zero fill after the norm
//   y   = conv2d_3x3(S) + b                 f32 accumulation, stored bf16
//   stats[n, co] += (sum y, sum y^2)        of the f32 accumulator, over the
//                                           block's valid pixels (atomics)
//
// What bounds it: an implicit GEMM with M = N*D*H*W pixels, K = 9*C and
// N = CO. At K = 9*96 and above its arithmetic intensity is far above the
// card's ~295 FLOP/byte ridge, so it is compute-bound and the bf16 tensor
// cores are the resource. At level 0 of the bench geometry (128^3, C = 96,
// CO = 48) it reads ~2 x 201 MB and writes 201 MB per call against
// ~174 GFLOP.
//
// Design (simple, correct first): one block of 16 warps per (n, d, TH image
// rows, W tile) and CO tile. A W tile is 16*WF columns; rows wider than a
// block's row fragments take several tiles of equal width, so any W works.
//  * A per-channel table for the block's (n, d) is built first: source
//    pointer (part, depth d - shift, channel), pending affine, and whether
//    the shift leaves [0, D). The block then stages the normalised, shifted,
//    zero-haloed operand of its rows, (TH + 2) x (16*WF + 2) pixels x Cs
//    channels (Cs = C rounded up to 16: the K padding lives only in shared
//    memory), once in shared memory, in 16-byte units of 8 channels: one
//    cp.async when the unit's channels share part and shift, four 4-byte
//    cp.async when its channel pairs do (shift groups need not start at a
//    multiple of 8), channel by channel otherwise; zeros where the shift or
//    the halo leaves the volume. A second pass over shared memory, over the
//    copied units that carry a norm only, applies the pending norms, so the
//    zero fill stays zero. Address math steps through the tile without
//    divisions: at 16 warps per SM the staging is bound by instruction
//    latency, not by memory.
//  * Each of the 9 taps is then a plain offset into that tile. Warps form
//    an (M x N) grid of 16-pixel row fragments by 16-wide CO fragments;
//    fragments come from shared memory by ldmatrix and go through
//    mma.sync.m16n8k16 bf16 with f32 accumulators in registers. Staged rows
//    are Cp = Cs + 8 channels apart where that fits, so the eight 16-byte
//    rows of an ldmatrix fall in distinct bank groups. No im2col buffer
//    exists; every input element is read from device memory once per block
//    plus the halo rows.
//  * The taps' weights, (CO, C) per tap with K contiguous, are staged per
//    tap into two shared buffers with cp.async, the next tap's copy in
//    flight during this tap's MMAs.
//  * Two instantiations: CO <= 48 (one warp column of three CO fragments,
//    two row fragments per warp) and a 96-wide CO tile (two warp columns of
//    three). TH is the largest that fits shared memory. The accumulators
//    pass through shared memory for the bias, the bf16 store and the
//    per-channel statistics.
// wgmma, TMA and warp specialisation are later work. The block machinery is
// in shift_conv_block.cuh, shared with the lazy up-link kernel (qfused.cu)
// and the block's backward (fused_block_bwd.cu).

#include "shift_conv_block.cuh"

template <int NG, int NFW, int MPW>
__global__ void __launch_bounds__(NTHREADS)
fused_block_kernel(const Params p, const NoHook hook) {
  shift_conv_block_body<NG, NFW, MPW>(p, hook);
}

// Plain C entry point (bound with ctypes). Arrays hold one entry per part;
// groups holds (c0, c1, shift) triples; part_vec gives the widest copy
// (16, 4 or 2 bytes) that every pixel row of a part is aligned for; w is
// (9, CO, C) bf16, 16-byte aligned. Returns a cudaError_t: the
// configuration check, cudaFuncSetAttribute, or cudaGetLastError() after
// the launch. Launches on `stream`; does not synchronise.
extern "C" int fused_block_launch(const void* const* xs,
                                  const void* const* mults,
                                  const void* const* offs, const int* part_c,
                                  const int* part_vec, int nparts,
                                  const int* groups, int ngroups,
                                  const void* w, const void* b, void* y,
                                  void* stats, int N, int D, int H, int W,
                                  int CO, void* stream) {
  Params p;
  if (!make_params(p, xs, mults, offs, part_c, part_vec, nparts, groups,
                   ngroups, w, b, y, stats, N, D, H, W, CO))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < nparts; ++i)
    if (p.x[i] == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const NoHook hook;
  return CO <= 48 ? launch<1, 3, 2>(p, hook, fused_block_kernel<1, 3, 2>, s)
                  : launch<2, 3, 1>(p, hook, fused_block_kernel<2, 3, 1>, s);
}
