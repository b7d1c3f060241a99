// Warp-specialised pipelined fused shiftConvPP block for NVIDIA Hopper
// (sm_90a), bfloat16: the function of fused_block.cu (#1) with the
// operand's assembly (copies and pending norms) in a producer warpgroup
// beside the consumers' wgmma products.
//
// Replaces the Pallas TPU kernel experiments/exp_pipeline_fwd.py:_pipe_kernel
// (pipelined_forward), which asked whether overlapping the operand assembly
// of the next step with the matrix products of this one pays. It computes
// exactly what #1 computes (parts with per-(N, C) pending affines, the
// depth shift of the whole concat, the (1,3,3) conv, bias, y in bf16,
// per-channel (sum y, sum y^2) of the f32 accumulator) on #1's K-chunked
// wgmma body: where both stage the same K chunks (widths of 48, 32 or 16
// channels), y equals #1's to the bit; the statistics differ in the order
// of their float32 sums.
//
// What bounds it: as #1, at the level-0 shape (two 48-channel parts -> 48,
// 128^3: 174 GFLOP against 604 MB of traffic) the bytes and the bf16
// tensor cores nearly equally (~0.18 ms). In #1 all 16 warps run every
// phase, so each warp's copies, norm pass and epilogue stand between its
// products; here they do not.
//
// Design: persistent blocks, one per SM, each walking a contiguous range of
// tiles with the depth innermost (consecutive depths of one (n, rows,
// columns, output channels) tile, the reference's grid order). A tile is
// #1's: TH rows x up to 32 columns, all of its output channels (CO <= 48)
// or 96 of them (n96), its operand staged in K chunks. Four warpgroups:
//  * two producers (warps 0-7), taking the block's (tile, K chunk) steps in
//    turn: for its step a producer waits for its stage of the operand ring
//    to be free (the stage's empty mbarrier), issues the chunk's copies
//    with stage_operand_issue (its own per-channel table, 16- and 4-byte
//    cp.async, zero fill), waits for them, applies the pending norms in
//    place (producer_norms, the zero fill left at zero) and arrives
//    on the stage's full mbarrier. Each meets only itself at its barriers
//    (named barriers 1 and 2) and gives registers away (setmaxnreg). One
//    warpgroup alone could not keep up: its table, copy and norm loops
//    are chains of shared-memory loads with no other warp of its own to
//    hide them, so two stage two chunks at once.
//  * two consumers (warps 8-15): each waits on the stage's full mbarrier,
//    runs the chunk's 9 taps on wgmma (chunk_taps: A from registers by
//    ldmatrix at each tap's offset, B by descriptor), arrives on its empty
//    mbarrier, and after a tile's last chunk runs the register epilogue
//    (store_tile_regs: bias, bf16 pairs, statistics by shuffles and one
//    atomic pair per channel and tile; named barrier 3) while the
//    producers stage the next tile.
//  * The weights are packed for wgmma by pack_weights_kernel into scratch
//    first; they stay resident (all chunks, one bulk copy each, at the
//    start) where they fit, as at CO 48 with C <= 96, else each stage
//    carries its chunk's weights by one bulk copy on its full mbarrier.
//  * The ring holds 4 stages where shared memory allows, else 2 (the
//    level-0 shape): each producer fills its own. `overlap` off runs the
//    same kernel with a ring of one stage: a producer stages a chunk only
//    after the consumers released the last one. Tiles, chunks and sums are
//    the same, so y is equal to the bit, and the two times measure the
//    overlap.

#include "bulk_copy.cuh"
#include "shift_conv_block.cuh"

#define PIPE_THREADS 512             // two producers, two consumers
#define PIPE_CWARPS 8                // consumer warps
#define PIPE_KC_MAX 48               // widest staged K chunk
#define PIPE_CO_TILE_MAX 96          // widest output-channel tile (n96)
// setmaxnreg: 256 * 88 + 256 * 168 = 512 * 128, the block's registers
#define PIPE_PRODUCER_REGS 88
#define PIPE_CONSUMER_REGS 168

// named barriers: 1 and 2 the producer warpgroups', 3 the consumers'
typedef NamedSync<3, PIPE_CWARPS * 32> ConsumerSync;

// the persistent schedule of a launch
struct PipeSched {
  int nch;          // K chunks of p.Cs channels
  int resident;     // 1: every chunk's weights staged once per block; 0:
                    // each stage carries its chunk's weights
  int w_bytes;      // the packed weights of one chunk
  int op_bytes;     // one stage's operand
  int stages;       // the ring's depth: 2 or 4 (each producer warpgroup
                    // fills its own stages), 1 (the control)
  int n_co;         // output-channel tiles of 16 * NFW
  int n_ht;         // row tiles
  int ntiles;       // (tile, depth) units, depth innermost
  const bf16* wpk;  // the packed weights (pack_weights_kernel)
  int off_w;        // weights: nch chunks (resident) or one per stage
  int tab_bytes;    // one producer warpgroup's staging table
  int off_red;      // two epilogue reduction buffers of 2 * 8 * BN floats
  int red_floats;
  int off_bar;      // full[stages], empty[stages], the resident weights'
};

// The second half of one producer warpgroup's staging (what
// stage_operand_finish does for a whole block): wait for its copies, then
// the pending norms in place, zero fill left at zero. Each thread keeps one
// 8-channel unit with a norm (its 8 (mult, off) pairs in registers) and
// walks that unit's cells with a stride of the threads sharing it, four
// cells in flight; the same arithmetic and rounding as the block's pass.
template <class Sync>
__device__ __forceinline__ void producer_norms(const Params& p, bf16* s_in,
                                               unsigned char* tab, int h0,
                                               int w0, int tid) {
  cp_async_wait_all();
  Sync::sync();
  const StageTable t(tab, p.Cs);
  const int naff = *t.naff;
  const int per = naff > 0 ? Sync::threads / naff : 0;  // threads per unit
  if (naff > 0 && tid < naff * per) {
    const int k = t.affk[tid / per], c0 = k * 8;
    const bool all = (t.unit[k] & 3) == UNIT_16;  // one part, one shift
    float m[8], o[8];
    bool on[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      m[e] = t.m[c0 + e];
      o[e] = t.o[c0 + e];
      const int ie = t.info[c0 + e];
      on[e] = all || (ie >= 0 && (ie & 4));
    }
    const int rows = p.TH + 2, Ws = p.Ws;
    int row = (tid % per) / Ws, col = (tid % per) % Ws;
    while (row < rows) {
      uint4 v[4];
      bf16* at[4];
      bool in[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int hh = h0 - 1 + row, ww = w0 - 1 + col;
        in[j] = row < rows && hh >= 0 && hh < p.H && ww >= 0 && ww < p.W;
        at[j] = s_in + (size_t)(row * Ws + col) * p.Cp + c0;
        if (in[j]) v[j] = *reinterpret_cast<const uint4*>(at[j]);
        col += per;
        while (col >= Ws) {
          col -= Ws;
          ++row;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!in[j]) continue;
        __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&v[j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h2[e]);
          const __nv_bfloat162 n2 = __floats2bfloat162_rn(
              norm_lrelu(f.x, m[2 * e], o[2 * e]),
              norm_lrelu(f.y, m[2 * e + 1], o[2 * e + 1]));
          h2[e] = __halves2bfloat162(
              on[2 * e] ? __low2bfloat16(n2) : __low2bfloat16(h2[e]),
              on[2 * e + 1] ? __high2bfloat16(n2) : __high2bfloat16(h2[e]));
        }
        *reinterpret_cast<uint4*>(at[j]) = v[j];
      }
    }
  }
  Sync::sync();
}

// unit u: (n, row tile, column tile, output-channel tile) u / D, depth
// u % D
template <int NFW>
struct PipeTile {
  int n, d, h0, w0, ct, co0, ncol, nf, N8;
  __device__ PipeTile(const Params& p, const PipeSched& ps, int u) {
    d = u % p.D;
    int rest = u / p.D;
    ct = rest % ps.n_co;
    rest /= ps.n_co;
    const int wt = rest % p.n_wt;
    rest /= p.n_wt;
    const int ht = rest % ps.n_ht;
    n = rest / ps.n_ht;
    h0 = ht * p.TH;
    w0 = wt * p.WF * 16;
    co0 = ct * NFW * 16;
    ncol = min(NFW * 16, p.CO - co0);
    nf = (ncol + 15) / 16;
    N8 = (ncol + 7) / 8;
  }
};

template <int MPW, int NFW>
__global__ void __launch_bounds__(PIPE_THREADS, 1)
fused_block_pipe_kernel(const Params p, const PipeSched ps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ps.off_bar);
  uint64_t* empty = full + ps.stages;
  uint64_t* wbar = empty + ps.stages;
  if (tid == 0) {
    for (int s = 0; s < ps.stages; ++s) {
      mbar_init(full + s, 128 + (ps.resident ? 0 : 1));
      mbar_init(empty + s, PIPE_CWARPS);
    }
    mbar_init(wbar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  // this block's units: a contiguous range, consecutive depths
  const int u0 = (int)((long long)blockIdx.x * ps.ntiles / gridDim.x);
  const int u1 = (int)((long long)(blockIdx.x + 1) * ps.ntiles / gridDim.x);
  auto stage_op = [&](int s) {
    return reinterpret_cast<bf16*>(smem + (size_t)s * ps.op_bytes);
  };
  // chunk ch's weights: resident, or the stage's own
  auto stage_w = [&](int ch, int s) {
    return reinterpret_cast<bf16*>(
        smem + ps.off_w + (size_t)(ps.resident ? ch : s) * ps.w_bytes);
  };
  auto w_src = [&](int ct, int ch) {
    return ps.wpk + (size_t)(ct * ps.nch + ch) * (ps.w_bytes / 2);
  };

  if (tid < 256) {
    // ---- the two producer warpgroups: warpgroup pw stages the block's
    // (tile, K chunk) steps j with j % 2 == pw, into stage j % stages
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        PIPE_PRODUCER_REGS));
    const int pw = tid / 128, ptid = tid % 128;
    unsigned char* tab = smem + p.off_tab + pw * ps.tab_bytes;
    if (ps.resident && tid == 0) {     // every chunk of the one CO tile
      mbar_expect(wbar, ps.nch * ps.w_bytes);
      for (int ch = 0; ch < ps.nch; ++ch)
        bulk_load(stage_w(ch, 0), w_src(0, ch), ps.w_bytes, wbar);
    }
    auto stage = [&](auto sync, const PipeTile<NFW>& a, int ch, int s) {
      typedef decltype(sync) Sync;
      if (!ps.resident && ptid == 0) {
        mbar_expect(full + s, ps.w_bytes);
        bulk_load(stage_w(ch, s), w_src(a.ct, ch), ps.w_bytes, full + s);
      }
      bf16* op = stage_op(s);
      stage_operand_issue<Sync>(p, op, tab, ch * p.Cs, a.n, a.d, a.h0, a.w0,
                                ptid);
      producer_norms<Sync>(p, op, tab, a.h0, a.w0, ptid);
      mbar_arrive(full + s);           // this thread's copies and norms
    };
    int j = 0;
    for (int u = u0; u < u1; ++u) {
      const PipeTile<NFW> a(p, ps, u);
      for (int ch = 0; ch < ps.nch; ++ch, ++j) {
        if ((j & 1) != pw) continue;
        // the stage's last use released: with 2 or 4 stages this
        // warpgroup's own last use of it; with one, the other warpgroup's
        // step j - 1, after step j - 2 (a phase is told only from the next)
        const int s = j % ps.stages, k = j / ps.stages;
        if (ps.stages == 1 && j >= 2) mbar_wait(empty, (j - 2) & 1);
        if (k >= 1) mbar_wait(empty + s, (k - 1) & 1);
        if (pw == 0)
          stage(NamedSync<1, 128>(), a, ch, s);
        else
          stage(NamedSync<2, 128>(), a, ch, s);
      }
    }
  } else {
    // ---- the two consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        PIPE_CONSUMER_REGS));
    const int ctid = tid - 256;
    float* red = reinterpret_cast<float*>(smem + ps.off_red);
    if (ps.resident) mbar_wait(wbar, 0);
    int s = 0;
    unsigned ph = 0;
    for (int u = u0; u < u1; ++u) {
      const PipeTile<NFW> a(p, ps, u);
      const WarpTile<1, NFW, MPW, PIPE_CWARPS> wt(p, ctid, a.nf);
      float acc[MPW][NFW][2][4];
#pragma unroll
      for (int f = 0; f < MPW; ++f)
#pragma unroll
        for (int j = 0; j < NFW; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[f][j][h][e] = 0.0f;
      for (int ch = 0; ch < ps.nch; ++ch) {
        mbar_wait(full + s, ph);
        chunk_taps<MPW, NFW, true>(p, wt, acc, stage_op(s), stage_w(ch, s),
                                   a.N8);
        if (wt.lane == 0) mbar_arrive(empty + s);  // this warp's reads done
        if (++s == ps.stages) {
          s = 0;
          ph ^= 1;
        }
      }
      // two reduction buffers in turn: a tile's writes come after the last
      // tile's barrier, which every reader of the one before has passed
      store_tile_regs<MPW, NFW, ConsumerSync>(
          p, wt, acc, a.n, a.d, a.h0, a.w0, a.co0, a.nf * 16, a.ncol, ctid,
          red + ((u - u0) & 1) * ps.red_floats);
    }
  }
}

static size_t align128(size_t v) { return (v + 127) / 128 * 128; }

// The tile (#1's: W tiles of at most 32 columns, of equal width; then the
// most rows, up to 8 * MPW fragments), the K chunk (the widest of 48, 32,
// 16 channels), the weights (resident, else one chunk per stage) and the
// ring (4 stages, else 2) such that the block fits shared memory;
// with `overlap` off the same tile and chunks on a ring of one stage. Then
// the weights' packing and the persistent launch, one block per SM.
template <int MPW, int NFW>
static int launch_pipe(Params& p, bf16* wpk, int wpk_bytes, int overlap,
                       int* stages_out, cudaStream_t stream) {
  constexpr int CO_TILE = NFW * 16;
  static_assert(CO_TILE <= PIPE_CO_TILE_MAX,
                "fused_block_pipe_scratch_bytes");
  PipeSched ps;
  ps.n_co = (p.CO + CO_TILE - 1) / CO_TILE;
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
  const size_t red = (size_t)2 * 2 * PIPE_CWARPS * bn * sizeof(float);
  size_t smem = 0;
  bool fit = false;
  for (int th = min(p.H, PIPE_CWARPS * MPW / wf); th >= 1 && !fit; --th) {
    for (int kc : {PIPE_KC_MAX, 32, 16}) {
      const int cs = min(kc, cs_all);
      const int nch = (p.C + cs - 1) / cs;
      const size_t op = align128((size_t)(th + 2) * p.Ws * (cs + 8) *
                                 sizeof(bf16));
      const size_t wch = (size_t)9 * (cs / 16) * n8 * 256;
      const size_t tab = align128((size_t)cs * (sizeof(void*) + 12) +
                                  (size_t)(cs / 8) * 8 + 4);
      for (int res = ps.n_co == 1 ? 1 : 0; res >= 0 && !fit; --res) {
        for (int st : {4, 2}) {
          if (fit) break;
          const size_t w = res ? nch * wch : st * wch;
          const size_t total = st * op + w + 2 * tab + red +
                               8 * (2 * st + 1);
          if (total > SMEM_LIMIT) continue;
          fit = true;
          p.TH = th;
          p.Cs = cs;
          p.Cp = cs + 8;               // an odd number of 16-byte units
          ps.nch = nch;
          ps.resident = res;
          ps.w_bytes = (int)wch;
          ps.op_bytes = (int)op;
          ps.stages = overlap ? st : 1;
          ps.off_w = (int)(st * op);
          p.off_tab = (int)(st * op + w);
          ps.tab_bytes = (int)tab;
          ps.off_red = (int)(st * op + w + 2 * tab);
          ps.red_floats = 2 * PIPE_CWARPS * bn;
          ps.off_bar = (int)(st * op + w + 2 * tab + red);
          smem = total;
        }
      }
      if (fit) break;
    }
  }
  if (!fit) return (int)cudaErrorInvalidValue;
  ps.n_ht = (p.H + p.TH - 1) / p.TH;
  if ((long long)ps.n_co * ps.nch * ps.w_bytes > wpk_bytes)
    return (int)cudaErrorInvalidValue;
  ps.wpk = wpk;
  const long long ntiles =
      (long long)p.N * ps.n_ht * p.n_wt * ps.n_co * p.D;
  if (ntiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  ps.ntiles = (int)ntiles;
  pack_weights_kernel<NFW><<<64, 256, 0, stream>>>(p, ps.n_co, ps.nch,
                                                  ps.w_bytes, wpk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto kernel = fused_block_pipe_kernel<MPW, NFW>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int grid = ps.ntiles < sms ? ps.ntiles : sms;
  kernel<<<grid, PIPE_THREADS, smem, stream>>>(p, ps);
  *stages_out = ps.stages;
  return (int)cudaGetLastError();
}

// The bytes of packed-weights scratch that fused_block_pipe_launch needs
// for C input and CO output channels: room for every K chunk (of at most
// PIPE_KC_MAX channels) and output-channel tile (of at most
// PIPE_CO_TILE_MAX) with its padding.
extern "C" int fused_block_pipe_scratch_bytes(int C, int CO) {
  return (int)sizeof(bf16) * 9 * (C + PIPE_KC_MAX - 1) *
         (CO + PIPE_CO_TILE_MAX - 1);
}

// Plain C entry point (bound with ctypes), the arguments of
// fused_block_launch up to CO; w_packed is scratch of
// fused_block_pipe_scratch_bytes(C, CO) bytes for the packed weights;
// overlap 0 runs the ring with one stage (the control); *stages receives
// the ring's depth. Returns a cudaError_t: the configuration check,
// cudaFuncSetAttribute, or cudaGetLastError() after a launch. Launches on
// `stream`; does not synchronise.
extern "C" int fused_block_pipe_launch(
    const void* const* xs, const void* const* mults, const void* const* offs,
    const int* part_c, const int* part_vec, int nparts, const int* groups,
    int ngroups, const void* w, const void* b, void* y, void* stats, int N,
    int D, int H, int W, int CO, void* w_packed, int w_packed_bytes,
    int overlap, int* stages, void* stream) {
  Params p;
  if (!make_params(p, xs, mults, offs, part_c, part_vec, nparts, groups,
                   ngroups, w, b, y, stats, N, D, H, W, CO))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < nparts; ++i)
    if (p.x[i] == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* wpk = static_cast<bf16*>(w_packed);
  // CO <= 48: 16 x 32 tiles, n48, four m64 tiles per consumer warpgroup;
  // else 8 x 32 tiles, n96, two, in output-channel tiles of 96
  return CO <= 48
             ? launch_pipe<4, 3>(p, wpk, w_packed_bytes, overlap, stages, s)
             : launch_pipe<2, 6>(p, wpk, w_packed_bytes, overlap, stages, s);
}
