// Software-pipelined fused shiftConvPP block for NVIDIA Hopper (sm_90a),
// bfloat16: the function of fused_block.cu (#1) with the staging of the
// next depth's operand in flight during this depth's products.
//
// Replaces the Pallas TPU kernel experiments/exp_pipeline_fwd.py:_pipe_kernel
// (pipelined_forward), which asked whether double-buffering the operand
// assembly of depth d+1 against the matrix products of depth d pays. It
// computes exactly what #1 computes (parts with per-(N, C) pending affines,
// the depth shift of the whole concat, the (1,3,3) conv, bias, y in bf16,
// per-channel (sum y, sum y^2) of the f32 accumulator), on the per-tap
// mma.sync loop (mma_tap). #1 sums on wgmma over K chunks, in another
// float32 order: y is within one bf16 step of #1's (equal to the bit to
// #1's mma.sync control where that stages one K chunk), the statistics
// differ in the order of their float32 sums.
//
// What bounds it: as #1, the bf16 tensor cores at the level-0 shape (two
// 48-channel parts -> 48, 128^3: 174 GFLOP against 604 MB of traffic, the
// two bounds nearly equal).
//
// Design: #1's machinery (shift_conv_block.cuh: the staging table and
// copies, the per-tap ldmatrix + mma.sync loop, the epilogue) in a
// persistent loop. A block owns an (n, TH rows, W tile, CO tile) and a
// chunk of consecutive depths; two operand buffers alternate:
//   issue(d+1) into the other buffer     stage_operand_issue: the table and
//                                        the cp.async copies, committed,
//                                        not waited for
//   9 taps of products on this buffer    mma_tap; the next tap's weights
//                                        are loaded into registers before a
//                                        tap's products and stored after
//                                        (no cp.async group of their own, so
//                                        waiting for them never waits for
//                                        the operand copies in flight)
//   finish(d+1)                          stage_operand_finish: wait, the
//                                        pending norms in place
//   epilogue(d)                          store_tile, through this buffer
// The tile (TH, WF) is the one that fits two operand buffers and keeps the
// most warps busy per staged pixel; the depth chunk the one that fills the
// card's SMs in the fewest steps. With `overlap` off the same kernel issues
// the next depth's staging after the products instead of before them: the
// same tile, the same work, no overlap, so that the two times measure the
// overlap alone.

#include "shift_conv_block.cuh"

// one tap's weights (ncol rows x C of p.w) in registers between their load
// and their store: 8-channel units when C % 8 == 0, single values otherwise
struct WeightRegs {
  static constexpr int U = 4;          // 16-byte units per thread
  uint4 u[U];
  __device__ __forceinline__ void load(const Params& p, int t, int co0,
                                       int ncol, bool vec, int tid) {
    const bf16* src = p.w + ((size_t)t * p.CO + co0) * p.C;
    if (vec) {
      const int per_row = p.C / 8;
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const int i = tid + k * NTHREADS;
        if (i < ncol * per_row)
          u[k] = __ldg(reinterpret_cast<const uint4*>(
              src + (size_t)(i / per_row) * p.C + (i % per_row) * 8));
      }
    } else {
      bf16* v = reinterpret_cast<bf16*>(u);
#pragma unroll
      for (int k = 0; k < U * 8; ++k) {
        const int i = tid + k * NTHREADS;
        if (i < ncol * p.C) v[k] = src[i];
      }
    }
  }
  __device__ __forceinline__ void store(const Params& p, bf16* s_w, int ncol,
                                        bool vec, int tid) const {
    if (vec) {
      const int per_row = p.C / 8;
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const int i = tid + k * NTHREADS;
        if (i < ncol * per_row)
          *reinterpret_cast<uint4*>(s_w + (i / per_row) * p.Cp +
                                    (i % per_row) * 8) = u[k];
      }
    } else {
      const bf16* v = reinterpret_cast<const bf16*>(u);
#pragma unroll
      for (int k = 0; k < U * 8; ++k) {
        const int i = tid + k * NTHREADS;
        if (i < ncol * p.C) s_w[(i / p.C) * p.Cp + i % p.C] = v[k];
      }
    }
  }
};

template <int NG, int NFW, int MPW>
__global__ void __launch_bounds__(NTHREADS)
fused_block_pipe_kernel(const Params p, const int d_chunk,
                        const int buf_bytes, const int overlap) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int n_ht = (p.H + p.TH - 1) / p.TH;
  const int n_dc = (p.D + d_chunk - 1) / d_chunk;
  int bid = blockIdx.x;
  const int wt = bid % p.n_wt;
  bid /= p.n_wt;
  const int ht = bid % n_ht;
  bid /= n_ht;
  const int dc = bid % n_dc;
  const int n = bid / n_dc;
  const int h0 = ht * p.TH;
  const int w0 = wt * p.WF * 16;
  const int d0 = dc * d_chunk;
  const int d1 = min(p.D, d0 + d_chunk);
  const int co0 = blockIdx.y * NG * NFW * 16;
  const int nf = min(NG * NFW, (p.CO - co0 + 15) / 16);  // CO fragments
  const int BN = nf * 16;
  const int ncol = min(BN, p.CO - co0);  // real columns of this tile

  // the two operand and the two weight buffers, by index (no local array)
  auto s_buf = [&](int i) {
    return reinterpret_cast<bf16*>(smem + (i ? buf_bytes : 0));
  };
  auto s_w = [&](int i) {
    return reinterpret_cast<bf16*>(smem + p.off_w) + (i ? BN * p.Cp : 0);
  };
  unsigned char* tab = smem + p.off_tab;
  const NoHook hook;
  const bool vec_w = (p.C % 8 == 0);

  // ---- tap 0's weights, the first depth's operand
  zero_weight_padding(p, s_w(0), 2, BN, ncol, tid);
  WeightRegs wr;
  wr.load(p, 0, co0, ncol, vec_w, tid);
  wr.store(p, s_w(0), ncol, vec_w, tid);
  stage_operand_issue(p, s_buf(0), tab, 0, n, d0, h0, w0, tid);
  stage_operand_finish(p, hook, smem, s_buf(0), tab, n, d0, h0, w0, tid);

  const WarpTile<NG, NFW, MPW> wtile(p, tid, nf);
  int k = 0;                // taps done; tap k's weights in s_w(k & 1)
  for (int d = d0; d < d1; ++d) {
    const int cur = (d - d0) & 1;
    const bool more = d + 1 < d1;
    if (more && overlap)               // the next depth's copies, in flight
      stage_operand_issue(p, s_buf(cur ^ 1), tab, 0, n, d + 1, h0, w0, tid);
    float acc[MPW][NFW][2][4];
#pragma unroll
    for (int f = 0; f < MPW; ++f)
#pragma unroll
      for (int j = 0; j < NFW; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[f][j][h][e] = 0.0f;
    for (int t = 0; t < 9; ++t, ++k) {
      const bool next_w = more || t + 1 < 9;
      if (next_w) wr.load(p, (t + 1) % 9, co0, ncol, vec_w, tid);
      mma_tap(p, wtile, acc, s_buf(cur), s_w(k & 1), t);
      // the other buffer was freed by the last tap's barrier
      if (next_w) wr.store(p, s_w((k + 1) & 1), ncol, vec_w, tid);
      __syncthreads();
    }
    if (more) {
      if (!overlap)
        stage_operand_issue(p, s_buf(cur ^ 1), tab, 0, n, d + 1, h0, w0, tid);
      stage_operand_finish(p, hook, smem, s_buf(cur ^ 1), tab, n, d + 1, h0,
                           w0, tid);
    }
    store_tile(p, wtile, acc, reinterpret_cast<float*>(s_buf(cur)), n, d, h0,
               w0, co0, BN, ncol, tid);
    __syncthreads();                   // s_buf(cur) is the next depth's
  }
}

// Tile, shared-memory layout and depth chunk; then the launch.
template <int NG, int NFW, int MPW>
static int launch_pipe(Params& p, int overlap, cudaStream_t stream) {
  auto kernel = fused_block_pipe_kernel<NG, NFW, MPW>;
  const int tile = NG * NFW * 16;
  const int bn_max = min(tile, (p.CO + 15) / 16 * 16);
  if (bn_max * p.C > WeightRegs::U * 8 * NTHREADS)
    return (int)cudaErrorInvalidValue;
  constexpr int WPM = NWARPS / NG;
  const int max_frags = WPM * MPW;
  const int wf_all = (p.W + 15) / 16;
  const size_t tab_bytes = ((size_t)p.Cs * (sizeof(void*) + 12) +
                            (size_t)(p.Cs / 8) * 8 + 4 + 127) / 128 * 128;
  auto up128 = [](size_t b) { return (b + 127) / 128 * 128; };
  double best = 0.0;
  int b_wf = 0, b_th = 0, b_cp = 0;
  size_t b_buf = 0, b_w = 0;
  for (int wf = 1; wf <= min(wf_all, max_frags); ++wf) {
    const int n_wt = (wf_all + wf - 1) / wf;
    if ((wf_all + n_wt - 1) / n_wt != wf) continue;  // tiles unequal
    const int Ws = wf * 16 + 2;
    for (int th = 1; th <= min(p.H, max_frags / wf); ++th) {
      for (int cp : {p.Cs + 8, p.Cs}) {
        const size_t in_b = (size_t)(th + 2) * Ws * cp * sizeof(bf16);
        const size_t ep_b = (size_t)th * wf * 16 * bn_max * sizeof(float);
        const size_t buf = up128(in_b > ep_b ? in_b : ep_b);
        const size_t w_b = up128((size_t)2 * bn_max * cp * sizeof(bf16));
        if (2 * buf + w_b + tab_bytes > SMEM_LIMIT) continue;
        // busy share of the warps' fragment slots, times outputs per staged
        // pixel, times the share of computed rows and columns inside H, W
        const int mf = th * wf;
        const double slots = (double)WPM * ((mf + WPM - 1) / WPM);
        const int n_ht = (p.H + th - 1) / th;
        const double score = mf / slots * (th * wf * 16.0) / ((th + 2) * Ws)
                             * p.H / ((double)n_ht * th)
                             * p.W / ((double)n_wt * wf * 16);
        if (score > best) {
          best = score;
          b_wf = wf; b_th = th; b_cp = cp; b_buf = buf; b_w = w_b;
        }
        break;                         // the padded stride when it fits
      }
    }
  }
  if (b_wf == 0) return (int)cudaErrorInvalidValue;
  p.WF = b_wf;
  p.n_wt = (wf_all + b_wf - 1) / b_wf;
  p.Ws = b_wf * 16 + 2;
  p.TH = b_th;
  p.Cp = b_cp;
  p.off_w = (int)(2 * b_buf);
  p.off_tab = (int)(2 * b_buf + b_w);
  p.off_hook = p.off_tab + (int)tab_bytes;
  const size_t smem = (size_t)p.off_hook;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;

  // depth chunk: the fewest steps per block slot of the card, then the
  // longest chunks
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, NTHREADS, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long co_tiles = (p.CO + tile - 1) / tile;
  const long long tiles =
      (long long)p.N * ((p.H + p.TH - 1) / p.TH) * p.n_wt * co_tiles;
  const long long slots = (long long)sms * per_sm;
  long long best_steps = -1;
  int d_chunk = p.D;
  for (int c = 1; c <= p.D; ++c) {
    const int len = (p.D + c - 1) / c;
    if (c > 1 && (p.D + len - 1) / len != c) continue;  // same as fewer
    const long long steps = (tiles * c + slots - 1) / slots * len;
    if (best_steps < 0 || steps < best_steps) {
      best_steps = steps;
      d_chunk = len;
    }
  }
  const long long n_blocks = tiles / co_tiles * ((p.D + d_chunk - 1) /
                                                 d_chunk);
  if (n_blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)n_blocks, (unsigned)co_tiles);
  kernel<<<grid, NTHREADS, smem, stream>>>(p, d_chunk, (int)b_buf, overlap);
  return (int)cudaGetLastError();
}

// Plain C entry point (bound with ctypes), the arguments of
// fused_block_launch and `overlap` (0: the next depth's staging after this
// depth's products). Returns a cudaError_t: the configuration check,
// cudaFuncSetAttribute, the occupancy query, or cudaGetLastError() after the
// launch. Launches on `stream`; does not synchronise.
extern "C" int fused_block_pipe_launch(
    const void* const* xs, const void* const* mults, const void* const* offs,
    const int* part_c, const int* part_vec, int nparts, const int* groups,
    int ngroups, const void* w, const void* b, void* y, void* stats, int N,
    int D, int H, int W, int CO, int overlap, void* stream) {
  Params p;
  if (!make_params(p, xs, mults, offs, part_c, part_vec, nparts, groups,
                   ngroups, w, b, y, stats, N, D, H, W, CO))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < nparts; ++i)
    if (p.x[i] == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return CO <= 48 ? launch_pipe<1, 3, 2>(p, overlap, s)
                  : launch_pipe<2, 3, 1>(p, overlap, s);
}
