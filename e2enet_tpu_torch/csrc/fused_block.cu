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
// N = CO. At the level-0 nest node of the bench geometry (128^3, C = 96,
// CO = 48) it reads ~2 x 201 MB and writes 201 MB against ~174 GFLOP, the
// two bounds nearly equal (~0.18 ms); at level 1 (64^3, C = 240, CO = 96)
// the bf16 tensor cores bound it. In practice a block of 16 warps with
// ~220 KB of shared memory runs alone on its SM, so what a design can win
// is overlap: staging, products and epilogue each take a similar share of
// a tile and are bound by latency when they follow one another.
//
// Design: the K-chunked wgmma body of shift_conv_block.cuh, shared with the
// lazy up-link block (#3, qfused.cu), with no up part, in persistent
// blocks (one per SM) that walk the output tiles.
//  * A tile is TH rows x (at most) 32 columns of one (n, d): 16 x 32 at CO
//    <= 48 (two m64 wgmma tiles per warpgroup, n <= 48), 8 x 32 at CO 49-96
//    (one m64 tile, n <= 96), so every output channel of the tile comes
//    from one staged operand; CO > 96 (off the model's path) takes tiles of
//    96 output channels. Rows wider than 32 columns take W tiles of equal
//    width.
//  * The operand is staged in K chunks of 48 channels (32 or 16 where two
//    buffers of 48 do not fit: 32 at CO 96), by stage_operand_issue: a
//    per-channel table (source pointer for depth d - shift, pending norm),
//    16-byte / 4-byte cp.async per 8-channel unit where its channels share
//    a source row, channel by channel otherwise, zeros where the shift or
//    the halo leaves the volume; then stage_operand_finish applies the
//    pending norms in place (f32, one rounding to bf16) to the copied units
//    only, so the zero fill stays zero.
//  * Two operand buffers. Each chunk step (chunk_step) waits for its copies,
//    normalises, issues the NEXT chunk's copies (after a tile's last chunk,
//    the first chunk of the block's next tile) into the other buffer, then
//    runs its 9 taps on wgmma (wgmma_taps: A from registers by ldmatrix at
//    each tap's offset, B by descriptor, straight-line code per chunk width
//    KS and output width N8, one commit group in flight).
//  * A first small kernel (pack_weights_kernel) packs the weights of every
//    (output-channel tile, K chunk) for wgmma (wgmma_b_index), each chunk
//    contiguous, into scratch from the wrapper; a chunk then arrives by
//    one bulk copy (cp.async.bulk on an mbarrier) instead of thousands of
//    16-byte copies. All chunks stay resident where they fit (CO 48, C <=
//    96); else two buffers, each chunk's weights issued with its copies.
//    fused_block_scratch_bytes gives the scratch's size.
//  * The epilogue works from the registers (store_tile_regs): the bf16 bias,
//    y stored as bf16 pairs, the statistics summed over the block by
//    shuffles and shared memory, one atomic pair per output channel and
//    tile; it runs while the next tile's copies land.
//  * The same kernel with its taps on mma.sync (mma_taps_packed over the
//    same packed weights) is the control that measures the wgmma loop.
//    The pipelined block (#13, fused_block_pipe.cu) runs this body's taps
//    and epilogue in warp-specialised persistent blocks.

#include "bulk_copy.cuh"
#include "shift_conv_block.cuh"

#define KC_MAX 48          // widest staged K chunk
#define CO_TILE_MAX 96     // widest output-channel tile (n96)

// the persistent schedule of a launch
struct Chunks {
  int nch;          // K chunks of p.Cs channels
  int resident;     // 1: every chunk's weights staged once per block; 0:
                    // two buffers, a chunk's weights issued with its copies
  int w_bytes;      // the packed weights of one chunk
  int op_bytes;     // one operand buffer
  int n_co;         // output-channel tiles of 16 * NFW
  int n_ht;         // row tiles
  int ntiles;
  const bf16* wpk;  // the packed weights (pack_weights_kernel): chunk ch of
                    // output-channel tile ct at (ct * nch + ch) * w_bytes
  int off_bar;      // two mbarriers, one per weight buffer
};

// a block tile: (n, d, rows h0 .., columns w0 ..) and output channels
// co0 .. co0 + ncol; output-channel tiles innermost
template <int NFW>
struct TileAt {
  int n, d, h0, w0, co0, ncol, nf, N8;
  __device__ TileAt(const Params& p, const Chunks& ck, int t) {
    const int ct = t % ck.n_co;
    int rest = t / ck.n_co;
    const int wt = rest % p.n_wt;
    rest /= p.n_wt;
    const int ht = rest % ck.n_ht;
    rest /= ck.n_ht;
    d = rest % p.D;
    n = rest / p.D;
    h0 = ht * p.TH;
    w0 = wt * p.WF * 16;
    co0 = ct * NFW * 16;
    ncol = min(NFW * 16, p.CO - co0);
    nf = (ncol + 15) / 16;
    N8 = (ncol + 7) / 8;
  }
};

// The fused block on the K-chunked wgmma body (shift_conv_block.cuh:
// materialised_chunks), persistent: each block walks the tiles t =
// blockIdx.x, + gridDim.x, .., the first chunk of its next tile issued
// during the last chunk's taps of this one; the epilogue from the
// registers (store_tile_regs) while those copies land. WGMMA: the taps on
// wgmma_taps, else on mma_taps_packed (the control).
template <int MPW, int NFW, bool WGMMA>
__global__ void __launch_bounds__(NTHREADS)
fused_chunked_kernel(const Params p, const Chunks ck) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  bf16* op0 = reinterpret_cast<bf16*>(smem);
  bf16* op1 = reinterpret_cast<bf16*>(smem + ck.op_bytes);
  unsigned char* s_wb = smem + p.off_w;
  unsigned char* tab = smem + p.off_tab;
  float* red = reinterpret_cast<float*>(smem + p.off_hook);

  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + ck.off_bar);
  if (tid == 0) {
    for (int b = 0; b < 2; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
          smem_u32(bar + b)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  unsigned phase = 0;                  // bit b: the next phase of bar[b]
                                       // (two buffers)

  // chunk ch's weights: resident, or in the buffer of the step's copies
  auto w_at = [&](int ch, int b) {
    return reinterpret_cast<bf16*>(
        s_wb + (size_t)(ck.resident ? ch : b) * ck.w_bytes);
  };
  // chunk ch of tile a (its output-channel tile's packed weights)
  auto w_src = [&](const TileAt<NFW>& a, int ch) {
    return ck.wpk + (size_t)(a.co0 / (NFW * 16) * ck.nch + ch) *
                        (ck.w_bytes / 2);
  };
  // chunk ch of tile a into buffer b: its weights unless resident (one
  // bulk copy), and its copies
  auto issue = [&](const TileAt<NFW>& a, int ch, bf16* s_op, int b) {
    if (!ck.resident && tid == 0) {
      mbar_expect(bar + b, ck.w_bytes);
      bulk_load(w_at(ch, b), w_src(a, ch), ck.w_bytes, bar + b);
    }
    stage_operand_issue(p, s_op, tab, ch * p.Cs, a.n, a.d, a.h0, a.w0, tid);
  };

  {                                    // the grid holds at most ntiles
    const TileAt<NFW> a(p, ck, blockIdx.x);
    if (ck.resident && tid == 0) {     // every chunk, on bar[1]
      mbar_expect(bar + 1, ck.nch * ck.w_bytes);
      for (int ch = 0; ch < ck.nch; ++ch)
        bulk_load(w_at(ch, 0), w_src(a, ch), ck.w_bytes, bar + 1);
    }
    issue(a, 0, op0, 0);
    if (ck.resident) mbar_wait(bar + 1, 0);
  }
  int buf = 0;
  for (int tile = blockIdx.x; tile < ck.ntiles; tile += gridDim.x) {
    const TileAt<NFW> a(p, ck, tile);
    const int next = tile + gridDim.x;
    const WarpTile<1, NFW, MPW> wtile(p, tid, a.nf);
    float acc[MPW][NFW][2][4];
#pragma unroll
    for (int f = 0; f < MPW; ++f)
#pragma unroll
      for (int j = 0; j < NFW; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[f][j][h][e] = 0.0f;
    materialised_chunks<MPW, NFW, WGMMA>(
        p, wtile, acc, smem, op0, op1, buf, tab, a.n, a.d, a.h0, a.w0, a.N8,
        ck.nch, tid,
        [&](int ch, int b) -> const bf16* {
          if (!ck.resident) {          // this step's weights landed
            mbar_wait(bar + b, (phase >> b) & 1u);
            phase ^= 1u << b;
          }
          return w_at(ch, b);
        },
        [&](int ch, bf16* s_op, int b) { issue(a, ch, s_op, b); },
        [&](bf16* s_op, int b) {
          if (next < ck.ntiles) issue(TileAt<NFW>(p, ck, next), 0, s_op, b);
        });
    store_tile_regs<MPW, NFW>(p, wtile, acc, a.n, a.d, a.h0, a.w0, a.co0,
                              a.nf * 16, a.ncol, tid, red);
  }
}

static size_t align128(size_t v) { return (v + 127) / 128 * 128; }

// The block tile (W tiles of at most 32 columns, of equal width; then the
// most rows, up to 16 * MPW / WF), the K chunk (the widest of 48, 32, 16
// channels) and the weights (resident, else two buffers) such that two
// operand buffers fit shared memory; then the persistent launch, one block
// per SM.
template <int MPW, int NFW>
static int launch_chunked(Params& p, bf16* wpk, int wpk_bytes, bool wgmma,
                          cudaStream_t stream) {
  constexpr int CO_TILE = NFW * 16;
  static_assert(CO_TILE <= CO_TILE_MAX, "fused_block_scratch_bytes");
  Chunks ck;
  ck.n_co = (p.CO + CO_TILE - 1) / CO_TILE;
  const int bn = min(CO_TILE, (p.CO + 15) / 16 * 16);
  const int n8 = (min(CO_TILE, p.CO) + 7) / 8;
  const int wf_all = (p.W + 15) / 16;
  int wf = min(wf_all, 2);
  while ((wf_all + (wf_all + wf - 1) / wf - 1) / ((wf_all + wf - 1) / wf) !=
         wf)
    --wf;
  p.WF = wf;
  p.n_wt = (wf_all + wf - 1) / wf;
  p.Ws = wf * 16 + 2;
  const int cs_all = p.Cs;             // C rounded up to 16
  size_t smem = 0;
  bool fit = false;
  for (int th = min(p.H, NWARPS * MPW / wf); th >= 1 && !fit; --th) {
    for (int kc : {KC_MAX, 32, 16}) {
      const int cs = min(kc, cs_all);
      const int nch = (p.C + cs - 1) / cs;
      const size_t op = align128((size_t)(th + 2) * p.Ws * (cs + 8) *
                                 sizeof(bf16));
      const size_t wch = (size_t)9 * (cs / 16) * n8 * 256;
      // table: pointer, info, mult, off per channel; two ints per unit, a
      // count (stage_operand_issue)
      const size_t tab = align128((size_t)cs * (sizeof(void*) + 12) +
                                  (size_t)(cs / 8) * 8 + 4);
      const size_t red = (size_t)2 * NWARPS * bn * sizeof(float);
      for (int res = ck.n_co == 1 ? 1 : 0; res >= 0 && !fit; --res) {
        const size_t w = res ? nch * wch : 2 * wch;
        const size_t total = 2 * op + w + tab + red + 16;  // 2 mbarriers
        if (total > SMEM_LIMIT) continue;
        fit = true;
        smem = total;
        p.TH = th;
        p.Cs = cs;
        p.Cp = cs + 8;                 // an odd number of 16-byte units
        ck.nch = nch;
        ck.resident = res;
        ck.w_bytes = (int)wch;
        ck.op_bytes = (int)op;
        p.off_w = (int)(2 * op);
        p.off_tab = (int)(2 * op + w);
        p.off_hook = (int)(2 * op + w + tab);
        ck.off_bar = (int)(2 * op + w + tab + red);
      }
      if (fit) break;
    }
  }
  if (!fit) return (int)cudaErrorInvalidValue;
  ck.n_ht = (p.H + p.TH - 1) / p.TH;
  if ((long long)ck.n_co * ck.nch * ck.w_bytes > wpk_bytes)
    return (int)cudaErrorInvalidValue;
  ck.wpk = wpk;
  const long long ntiles =
      (long long)p.N * p.D * ck.n_ht * p.n_wt * ck.n_co;
  if (ntiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  ck.ntiles = (int)ntiles;
  pack_weights_kernel<NFW><<<64, 256, 0, stream>>>(p, ck.n_co, ck.nch,
                                                  ck.w_bytes, wpk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  void (*kernel)(const Params, const Chunks) =
      wgmma ? fused_chunked_kernel<MPW, NFW, true>
            : fused_chunked_kernel<MPW, NFW, false>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int grid = ck.ntiles < sms ? ck.ntiles : sms;
  kernel<<<grid, NTHREADS, smem, stream>>>(p, ck);
  return (int)cudaGetLastError();
}

// The bytes of packed-weights scratch that fused_block_launch needs for C
// input and CO output channels: room for every K chunk (of at most KC_MAX
// channels) and output-channel tile (of at most CO_TILE_MAX) with its
// padding.
extern "C" int fused_block_scratch_bytes(int C, int CO) {
  return (int)sizeof(bf16) * 9 * (C + KC_MAX - 1) * (CO + CO_TILE_MAX - 1);
}

// Plain C entry point (bound with ctypes). Arrays hold one entry per part;
// groups holds (c0, c1, shift) triples; part_vec gives the widest copy
// (16, 4 or 2 bytes) that every pixel row of a part is aligned for; w is
// (9, CO, C) bf16, 16-byte aligned; w_packed is scratch of
// fused_block_scratch_bytes(C, CO) bytes for the packed weights. wgmma: 1
// runs the taps on wgmma, 0 on mma.sync (the control). xts / xbs: per part
// the halo row above row 0 / below row H - 1 of an H slab, (N, D, 1, W,
// pc) bf16 raw under the part's pending norm, or null (arrays or entries):
// zero fill there, as without them. Returns a
// cudaError_t: the configuration check, cudaFuncSetAttribute, or
// cudaGetLastError() after a launch. Launches on `stream`; does not
// synchronise.
extern "C" int fused_block_launch(const void* const* xs,
                                  const void* const* mults,
                                  const void* const* offs, const int* part_c,
                                  const int* part_vec, int nparts,
                                  const int* groups, int ngroups,
                                  const void* w, const void* b, void* y,
                                  void* stats, int N, int D, int H, int W,
                                  int CO, void* w_packed, int w_packed_bytes,
                                  int wgmma, const void* const* xts,
                                  const void* const* xbs, void* stream) {
  Params p;
  if (!make_params(p, xs, mults, offs, part_c, part_vec, nparts, groups,
                   ngroups, w, b, y, stats, N, D, H, W, CO))
    return (int)cudaErrorInvalidValue;
  set_halo(p, xts, xbs);
  for (int i = 0; i < nparts; ++i)
    if (p.x[i] == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // CO <= 48: 16 x 32 tiles, n48 (two m64 tiles per warpgroup); else
  // 8 x 32 tiles, n96 (one m64 tile), in output-channel tiles of 96
  bf16* wpk = static_cast<bf16*>(w_packed);
  return CO <= 48 ? launch_chunked<2, 3>(p, wpk, w_packed_bytes, wgmma, s)
                  : launch_chunked<1, 6>(p, wpk, w_packed_bytes, wgmma, s);
}
