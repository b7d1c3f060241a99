// Channels-first fused depth shift + (1,3,3) conv, and the in-kernel
// (H, W*C) -> (H*W, C) relayout probe, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of experiments/exp_cf_fused.py:
//   reshape_hwc_launch  `try_reshape_hwc`'s kernel (E1): stages each
//                       (W*C) row in shared memory and writes it as W rows
//                       of C; exact
//   cf_fused_launch     `_cf_kernel` and `_cf_kernel_v2` (E4, E5): for x
//                       channels-first (N, D, C, H*W), bf16,
//                         u = lrelu(x * mult + off)   f32, rounded to bf16
//                                                     (mult/off (C,) shared
//                                                     by the batch; optional)
//                         S = depth_shift(u)          zero outside [0, D),
//                                                     after the affine
//                         y = conv_(1,3,3)(S) + b     (N, D, CO, H*W) bf16,
//                                                     f32 sums, zero taps
//                                                     outside H x W
//                         stats[n, co] += (sum y, sum y^2) of the f32 sums,
//                                                     bias included
//                                                     (optional)
//
// What bounds it: bytes, as the channels-last ring kernel: at 1 x 128^3 x
// 48 -> 48 201 MB in and 201 MB out (0.120 ms at 3.35 TB/s) against
// 87 GFLOP; the affine and the statistics add nothing that counts.
//
// The question (exp_cf_fused.py:1-23): can a channels-first layout carry
// the fused block? In it a shift group is a range of channel planes, so
// the Tensor Memory Accelerator can stage a group's window as one box,
// where channels-last staging breaks into 16- and 4-byte requests at the
// groups' edges. Two routes, chosen by one rule (cf_route):
//
//  * TMA (cf_fused_tma_kernel), where a tensor map can describe x and y
//    (16-byte-aligned tensors, W % 8 == 0), CO <= 48, C <= 80, the shift
//    groups cut to at most CF_SLOTS slots of 16 channels and the stages fit
//    shared memory. Persistent blocks of three warpgroups walk tiles of TH
//    rows x 64 columns (the m64 of one wgmma per row), all output
//    channels, one tile per stage of the ring: per tile one TMA box per
//    slot (each group of 10 at C = 48), (88 columns from w0 - 8, the widest
//    slot's channels, TH + 2 rows) at the slot's source depth d - shift,
//    into shared memory [slot][row][channel][88]. A tensor map of x over
//    (W, C, H, D, N) gives that order; its zero fill outside [0, D) x
//    [0, H) x [0, W) x [0, C) replaces every bounds test. TMA takes a box's
//    first column only on 16 bytes, so a tap column's one-pixel shift can
//    be neither a box nor a wgmma descriptor offset: the consumers build
//    each step's A fragment in registers from 16-bit loads at the shifted
//    column (the 176-byte rows put the four channel rows of a load in
//    distinct banks). That also frees the K order: K is the channels in
//    order, each lane reading its channel from its slot's box, so a group
//    of 10 costs no padding to 16 (K = 48 per tap at C = 48, the weights
//    packed on the host for wgmma's B as #1's). Warp 0 keeps the stages
//    full (one thread; full and empty mbarriers per stage). With the affine
//    on, warps 1-3 apply it in place between a box's arrival and the
//    products (the zero fill left at zero: TMA's zeros would otherwise
//    become lrelu(off)) and arrive on the stage's ready mbarrier; their
//    warpgroup gives registers to the consumers (setmaxnreg). Two
//    consumer warpgroups each own rows of the tile and run 9 taps x
//    ceil(C / 16) steps of wgmma.m64n48k16 per row, A from registers, B
//    the packed weights (resident, one bulk copy per block), straight-line,
//    the next step's A loaded while two groups may be in flight. The
//    epilogue adds the bias, gathers the statistics in registers (one
//    atomic pair per channel and block, or per sample the block's tiles
//    cover), writes each row's (48 x 64) tile swizzled into shared memory
//    and sends it by a TMA store over y's tensor map (W, H, CO, D, N),
//    which drops what lies outside y.
//  * ldg (cf_fused_ldg_kernel), the first design, for every other shape: a
//    block stages three dw-shifted copies of an 8 x 16 window by scalar
//    loads, then runs mma.sync through ldmatrix(.trans), depth by depth.

#include "shift_conv_block.cuh"
#include "tma.cuh"

// ===========================================================================
// The ldg route: the weights, row-major with k = tap * Cs + channel, are the
// A operand of mma.sync.m16n8k16 (bf16, f32 accumulate) through ldmatrix;
// the operand, H*W-contiguous per channel, is its B operand through
// ldmatrix.trans, which hands mma.sync the k-major fragment. An ldmatrix
// row must start on 16 bytes, so a tap's one-pixel shift along W cannot be
// an address offset of one staged copy: the block stages three copies of
// its (TH + 2) x WT window, one per tap column dw, each already shifted by
// dw and zero outside the image; the three tap rows dh are whole-row
// offsets into them. A block owns (n, 8 image rows x 16 columns, up to 48
// output channels) and walks a chunk of depths; its weights stay in shared
// memory. Warp r computes image row r: 3 CO fragments x 2 n8 pixel
// fragments. Staging reads each element once with a scalar load, applies
// the affine in float32 and writes it into the copies that hold it. The
// statistics gather in registers over the block's depths and reach device
// memory by one atomic per channel and block.

#define CF_THREADS 256                 // 8 warps, one image row each
#define CF_TH 8
#define CF_WT 16
#define CF_MF 3                        // CO fragments of 16 per block
#define CF_NO_SHIFT (-1000)

struct CfParams {
  const bf16* x;                       // (N, D, C, H*W)
  const bf16* w;                       // (CO, 9*C), k = tap * C + channel
  const bf16* b;                       // (CO)
  const float* mult;                   // (C) or null: no affine
  const float* off;
  bf16* y;                             // (N, D, CO, H*W)
  float* stats;                        // (N, CO, 2), zeroed, or null
  int N, D, H, W, C, CO;
  int g0[MAX_GROUPS], g1[MAX_GROUPS], gs[MAX_GROUPS];
  int ngroups;
  int Cs, KP, CS;                      // C to 16; weight / channel strides
  int d_chunk;
  int off_op, off_tab;
};

__global__ void __launch_bounds__(CF_THREADS)
cf_fused_ldg_kernel(const CfParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int HW = p.H * p.W;
  const int n_wt = (p.W + CF_WT - 1) / CF_WT;
  const int n_ht = (p.H + CF_TH - 1) / CF_TH;
  const int n_dc = (p.D + p.d_chunk - 1) / p.d_chunk;
  int bid = blockIdx.x;
  const int wt = bid % n_wt;
  bid /= n_wt;
  const int ht = bid % n_ht;
  bid /= n_ht;
  const int dc = bid % n_dc;
  const int n = bid / n_dc;
  const int h0 = ht * CF_TH, w0 = wt * CF_WT;
  const int d0 = dc * p.d_chunk, d1 = min(p.D, d0 + p.d_chunk);
  constexpr int BM = CF_MF * 16;
  const int co0 = blockIdx.y * BM;
  const int ncol = min(BM, p.CO - co0);
  const int Cs = p.Cs, KP = p.KP, CS = p.CS;
  constexpr int RH = CF_TH + 2, RW = CF_WT + 2;
  bf16* s_w = reinterpret_cast<bf16*>(smem);               // BM x KP
  bf16* s_op = reinterpret_cast<bf16*>(smem + p.off_op);   // 3 x Cs x CS
  int* s_cs = reinterpret_cast<int*>(smem + p.off_tab);    // Cs shifts
  float* s_m = reinterpret_cast<float*>(s_cs + Cs);
  float* s_o = s_m + Cs;
  float* s_red = s_o + Cs;                                 // 8 x BM x 2

  // ---- the channel table and the weights (zero beyond C and ncol)
  for (int c = tid; c < Cs; c += CF_THREADS) {
    int s = CF_NO_SHIFT;
    if (c < p.C) {
      s = 0;
      for (int g = 0; g < p.ngroups; ++g)
        if (c >= p.g0[g] && c < p.g1[g]) s = p.gs[g];
    }
    s_cs[c] = s;
    s_m[c] = (p.mult && c < p.C) ? p.mult[c] : 1.0f;
    s_o[c] = (p.mult && c < p.C) ? p.off[c] : 0.0f;
  }
  for (int i = tid; i < BM * KP; i += CF_THREADS) {
    const int j = i / KP, k = i % KP, t = k / Cs, c = k % Cs;
    s_w[i] = (j < ncol && t < 9 && c < p.C)
                 ? p.w[(size_t)(co0 + j) * 9 * p.C + t * p.C + c]
                 : __float2bfloat16(0.0f);
  }

  const bool row_on = h0 + warp < p.H;
  const int a_row = lane % 16, a_k = (lane / 16) * 8;
  float bias[CF_MF][2];
  float s1[CF_MF][2], s2[CF_MF][2];
#pragma unroll
  for (int i = 0; i < CF_MF; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = i * 16 + lane / 4 + 8 * h;
      bias[i][h] = co < ncol ? __bfloat162float(p.b[co0 + co]) : 0.0f;
      s1[i][h] = 0.0f;
      s2[i][h] = 0.0f;
    }

  for (int d = d0; d < d1; ++d) {
    __syncthreads();                   // tables ready; last depth's reads done
    // ---- stage the three dw-shifted copies: the value at column
    // w0 - 1 + jj goes to copy dw at j = jj - 1 - dw
    const int per_c = RH * RW;
    for (int i = tid; i < Cs * per_c; i += CF_THREADS) {
      const int c = i / per_c, rem = i % per_c;
      const int r = rem / RW, jj = rem % RW;
      const int hh = h0 - 1 + r, ww = w0 - 1 + jj;
      const int s = s_cs[c];
      const int ds = d - s;
      bf16 v = __float2bfloat16(0.0f);
      if (s != CF_NO_SHIFT && ds >= 0 && ds < p.D && hh >= 0 && hh < p.H &&
          ww >= 0 && ww < p.W) {
        v = p.x[(((size_t)n * p.D + ds) * p.C + c) * HW + (size_t)hh * p.W +
                ww];
        if (p.mult) v = __float2bfloat16(
            norm_lrelu(__bfloat162float(v), s_m[c], s_o[c]));
      }
#pragma unroll
      for (int dw = -1; dw <= 1; ++dw) {
        const int j = jj - 1 - dw;
        if (j >= 0 && j < CF_WT)
          s_op[((size_t)(dw + 1) * Cs + c) * CS + r * CF_WT + j] = v;
      }
    }
    __syncthreads();

    // ---- (CO x 9Cs) . (9Cs x 16 pixels of row `warp`)
    float acc[CF_MF][2][4];
#pragma unroll
    for (int i = 0; i < CF_MF; ++i)
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][q][e] = 0.0f;
    if (row_on) {
      for (int t = 0; t < 9; ++t) {
        const int dh = t / 3 - 1, dw = t % 3 - 1;
        const unsigned b_addr = (unsigned)__cvta_generic_to_shared(
            s_op + ((size_t)(dw + 1) * Cs + lane % 8 + ((lane / 8) % 2) * 8) *
                       CS +
            (warp + 1 + dh) * CF_WT + (lane / 16) * 8);
        const unsigned a_addr = (unsigned)__cvta_generic_to_shared(
            s_w + (size_t)a_row * KP + t * Cs + a_k);
        for (int kc = 0; kc < Cs; kc += 16) {
          unsigned bq[4], a[CF_MF][4];
          ldmatrix_x4_trans(bq, b_addr + kc * CS * 2);
#pragma unroll
          for (int i = 0; i < CF_MF; ++i)
            if (i * 16 < ncol) ldmatrix_x4(a[i], a_addr + (i * 16 * KP + kc) * 2);
#pragma unroll
          for (int i = 0; i < CF_MF; ++i)
            if (i * 16 < ncol) {
              mma_16816(acc[i][0], a[i], bq[0], bq[1]);
              mma_16816(acc[i][1], a[i], bq[2], bq[3]);
            }
        }
      }
      // ---- y: channels lane/4 (+8) of each CO fragment, pixels
      // 2*(lane%4) + 0, 1 of each n8 fragment
      const int hh = h0 + warp;
#pragma unroll
      for (int i = 0; i < CF_MF; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int co = i * 16 + lane / 4 + 8 * h;
          if (co >= ncol) continue;
          bf16* yrow = p.y + (((size_t)n * p.D + d) * p.CO + co0 + co) * HW +
                       (size_t)hh * p.W;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int ww = w0 + q * 8 + (lane % 4) * 2;
            const float v0 = acc[i][q][2 * h] + bias[i][h];
            const float v1 = acc[i][q][2 * h + 1] + bias[i][h];
            const bool ok0 = ww < p.W, ok1 = ww + 1 < p.W;
            if (ok0) { s1[i][h] += v0; s2[i][h] += v0 * v0; }
            if (ok1) { s1[i][h] += v1; s2[i][h] += v1 * v1; }
            if (ok1 && HW % 2 == 0 && p.W % 2 == 0) {
              *reinterpret_cast<__nv_bfloat162*>(yrow + ww) =
                  __floats2bfloat162_rn(v0, v1);
            } else {
              if (ok0) yrow[ww] = __float2bfloat16(v0);
              if (ok1) yrow[ww + 1] = __float2bfloat16(v1);
            }
          }
        }
    }
  }

  // ---- statistics: the 4 lanes of a channel, then the 8 warps, then one
  // atomic per channel
  if (p.stats == nullptr) return;
#pragma unroll
  for (int i = 0; i < CF_MF; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        s1[i][h] += __shfl_xor_sync(0xffffffffu, s1[i][h], o);
        s2[i][h] += __shfl_xor_sync(0xffffffffu, s2[i][h], o);
      }
  if (lane % 4 == 0)
#pragma unroll
    for (int i = 0; i < CF_MF; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int co = i * 16 + lane / 4 + 8 * h;
        s_red[(warp * BM + co) * 2] = s1[i][h];
        s_red[(warp * BM + co) * 2 + 1] = s2[i][h];
      }
  __syncthreads();
  if (tid < 2 * ncol) {
    const int co = tid / 2, k = tid % 2;
    float v = 0.0f;
    for (int r = 0; r < CF_THREADS / 32; ++r) v += s_red[(r * BM + co) * 2 + k];
    atomicAdd(&p.stats[((size_t)n * p.CO + co0 + co) * 2 + k], v);
  }
}

// ===========================================================================
// The TMA route

#define CF_SLOTS 5                     // boxes per tile: shift groups
                                       // cut to 16 channels
#define CF_KSMAX 5                     // 16-channel K steps per tap: C <= 80
#define CF_CMAX (16 * CF_KSMAX)
#define CF_TW 64                       // tile columns: one wgmma's m64
#define CF_BOXW 88                     // staged columns: w0 - 8 .. w0 + 79
#define CF_LINE (CF_BOXW * 2)          // bytes of one staged channel row
#define CF_NCO 48                      // output channels: n48
#define CF_N8 (CF_NCO / 8)
#define CF_TMA_THREADS 384             // loader warpgroup, two consumers
#define CF_OUT_BYTES (CF_NCO * 128)    // one output row tile, 48 x 64
#define CF_MAX_STAGES 3
// setmaxnreg: 128 * 64 + 256 * 216 <= 384 * 168, the block's registers
#define CF_LOADER_REGS 64
#define CF_CONSUMER_REGS 216

struct CfTmaParams {
  const bf16* b;                       // (CO)
  const float* mult;                   // (C) or null: no affine
  const float* off;
  float* stats;                        // (N, CO, 2), zeroed, or null
  const bf16* wpk;                     // packed weights, w_bytes
  int N, D, H, W, C, CO;
  int KS;                              // 16-channel K steps per tap
  int w_bytes;                         // 9 * KS * CF_N8 * 256
  int nslots;                          // slots, <= CF_SLOTS
  int s_c0[CF_SLOTS], s_n[CF_SLOTS], s_sh[CF_SLOTS];  // first channel,
                                       // channels, shift of each slot
  int bw;                              // channels per box: the widest slot
  int TH;                              // rows per tile, 2 * MPW
  int stages;
  int n_ht, n_wt, ntiles;
  int slot_bytes;                      // one slot's box, to 128 bytes
  int stage_bytes;                     // nslots slots, and a zero slot
                                       // where C % 16 != 0
  int off_out, off_w, off_tab, off_red, off_bar;
};

__device__ __forceinline__ unsigned lds16(unsigned addr) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr));
  return v;
}

// a tile u: (n, depth, row tile, column tile), column tiles innermost
struct CfTile {
  int n, d, h0, w0;
  __device__ CfTile(const CfTmaParams& p, int u) {
    w0 = (u % p.n_wt) * CF_TW;
    int rest = u / p.n_wt;
    h0 = (rest % p.n_ht) * p.TH;
    rest /= p.n_ht;
    d = rest % p.D;
    n = rest / p.D;
  }
};

// MPW: rows of a tile per consumer warpgroup (TH = 2 * MPW); KS: 16-channel
// K steps per tap (p.KS)
template <int MPW, int KS>
__global__ void __launch_bounds__(CF_TMA_THREADS, 1)
cf_fused_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap ymap,
                    const CfTmaParams p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzled output tiles want 1024-byte alignment
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int S = p.stages, R = p.TH + 2, bw = p.bw;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.off_bar);
  uint64_t* ready = full + S;
  uint64_t* empty = ready + S;
  uint64_t* wbar = empty + S;
  float* s_m = reinterpret_cast<float*>(smem + p.off_tab);  // per channel
  float* s_o = s_m + CF_CMAX;
  const bool affine = p.mult != nullptr;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(ready + s, 96);        // the transform warps' threads
      mbar_init(empty + s, 8);         // the consumer warps
    }
    mbar_init(wbar, 1);
    mbar_init_fence();
  }
  for (int c = tid; c < p.C; c += CF_TMA_THREADS) {
    s_m[c] = affine ? p.mult[c] : 1.0f;
    s_o[c] = affine ? p.off[c] : 0.0f;
  }
  // the zero slot of each stage (K rows past C read it), never loaded
  {
    const int zero16 = (p.stage_bytes - p.nslots * p.slot_bytes) / 16;
    for (int i = tid; i < S * zero16; i += CF_TMA_THREADS)
      reinterpret_cast<uint4*>(smem + (i / zero16) * p.stage_bytes +
                               p.nslots * p.slot_bytes)[i % zero16] =
          make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  // this block's tiles: a contiguous range
  const int u0 = (int)((long long)blockIdx.x * p.ntiles / gridDim.x);
  const int u1 = (int)((long long)(blockIdx.x + 1) * p.ntiles / gridDim.x);

  if (warp < 4) {
    // the loader and transform warps give registers away; every path of
    // theirs ends here
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        CF_LOADER_REGS));
    if (warp == 0) {
      // ---- the loader: one thread issues every copy
      if (lane != 0) return;
      mbar_expect(wbar, p.w_bytes);
      bulk_load(smem + p.off_w, p.wpk, p.w_bytes, wbar);
      const unsigned bytes = p.nslots * bw * R * CF_LINE;
      int s = 0;
      unsigned ph = 0;
      for (int u = u0; u < u1; ++u) {
        const CfTile a(p, u);
        mbar_wait(empty + s, ph ^ 1);    // the stage's last use released
        mbar_expect(full + s, bytes);
        unsigned char* st = smem + s * p.stage_bytes;
        // one box per slot, its first column (w0 - 8) on 16 bytes as TMA
        // requires
        for (int g = 0; g < p.nslots; ++g)
          tma_load_5d(st + g * p.slot_bytes, &xmap, a.w0 - 8, p.s_c0[g],
                      a.h0 - 1, a.d - p.s_sh[g], a.n, full + s);
        if (++s == S) {
          s = 0;
          ph ^= 1;
        }
      }
      return;
    }
    {
      // ---- the transform warps: the affine in place, where the source lies
      // inside the volume (TMA's zeros stay zero)
      if (!affine) return;
      const int twarp = warp - 1;
      int s = 0;
      unsigned ph = 0;
      for (int u = u0; u < u1; ++u) {
        const CfTile a(p, u);
        mbar_wait(full + s, ph);
        unsigned char* st = smem + s * p.stage_bytes;
        // rows of the slots' boxes across the 3 warps, a row's 16-byte
        // chunks (11 per channel row) across the lanes; rows and slots whose
        // source lies outside the volume stay TMA's zeros
        for (int g = 0; g < p.nslots; ++g) {
          const int ds = a.d - p.s_sh[g];
          if (ds < 0 || ds >= p.D) continue;
          for (int r = twarp; r < R; r += 3) {
            const int h = a.h0 - 1 + r;
            if (h < 0 || h >= p.H) continue;
            unsigned char* row = st + g * p.slot_bytes + r * bw * CF_LINE;
            for (int i = lane; i < p.s_n[g] * (CF_LINE / 16); i += 32) {
              const int k = i / (CF_LINE / 16), pc = i - k * (CF_LINE / 16);
              const int w = a.w0 - 8 + 8 * pc;
              uint4* ptr =
                  reinterpret_cast<uint4*>(row + k * CF_LINE + pc * 16);
              uint4 v = *ptr;
              __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&v);
              const float m = s_m[p.s_c0[g] + k], o = s_o[p.s_c0[g] + k];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float2 f = __bfloat1622float2(h2[e]);
                const bool in0 = w + 2 * e >= 0 && w + 2 * e < p.W;
                const bool in1 = w + 2 * e + 1 >= 0 && w + 2 * e + 1 < p.W;
                h2[e] = __floats2bfloat162_rn(
                    in0 ? norm_lrelu(f.x, m, o) : f.x,
                    in1 ? norm_lrelu(f.y, m, o) : f.y);
              }
              *ptr = v;
            }
          }
        }
        mbar_arrive(ready + s);
        if (++s == S) {
          s = 0;
          ph ^= 1;
        }
      }
      return;
    }
  }

  // ---- the two consumer warpgroups: warpgroup wg owns rows wg + 2f
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      CF_CONSUMER_REGS));
  const int ctid = tid - 128, wg = ctid / 128, wq = (ctid / 32) % 4;
  const int q = lane % 4;
  uint64_t* arrived = affine ? ready : full;
  float bias[2 * CF_N8], s1[2 * CF_N8], s2[2 * CF_N8];
#pragma unroll
  for (int i = 0; i < 2 * CF_N8; ++i) {
    const int co = 8 * (i / 2) + 2 * q + i % 2;
    bias[i] = co < p.CO ? __bfloat162float(p.b[co]) : 0.0f;
    s1[i] = s2[i] = 0.0f;
  }
  float* red = reinterpret_cast<float*>(smem + p.off_red);
  // the statistics of sample N_ so far: over the lanes of a column, then
  // the 8 warps, one atomic pair per channel
#define CF_FLUSH(N_)                                                        \
  {                                                                         \
    _Pragma("unroll") for (int i = 0; i < 2 * CF_N8; ++i)                   \
    _Pragma("unroll") for (int m = 4; m < 32; m *= 2) {                     \
      s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], m);                      \
      s2[i] += __shfl_xor_sync(0xffffffffu, s2[i], m);                      \
    }                                                                       \
    if (lane < 4)                                                           \
      _Pragma("unroll") for (int i = 0; i < 2 * CF_N8; ++i) {               \
        const int co = 8 * (i / 2) + 2 * lane + i % 2;                      \
        red[((ctid / 32) * CF_NCO + co) * 2] = s1[i];                       \
        red[((ctid / 32) * CF_NCO + co) * 2 + 1] = s2[i];                   \
      }                                                                     \
    NamedSync<3, 256>::sync();                                              \
    if (ctid < 2 * p.CO) {                                                  \
      const int co = ctid / 2, k = ctid % 2;                                \
      float v = 0.0f;                                                       \
      for (int w = 0; w < 8; ++w) v += red[(w * CF_NCO + co) * 2 + k];      \
      atomicAdd(&p.stats[((size_t)(N_) * p.CO + co) * 2 + k], v);           \
    }                                                                       \
    NamedSync<3, 256>::sync();                                              \
    _Pragma("unroll") for (int i = 0; i < 2 * CF_N8; ++i) s1[i] = s2[i] =   \
        0.0f;                                                               \
  }
  // A of one (row, tap, K step), this warp's 16 columns x 16 channels in
  // mma.m16n8k16's A layout: (column m, channels 2q, 2q + 1) in a[0], m +
  // 8 in a[1], channels + 8 in a[2], a[3]; column m of tap column dw is
  // staged column m + 7 + dw. K is the channels in order: each lane's
  // channel sits in its slot's box (coff: slot and row of the box);
  // channels past C read the zero slot (against zero weights).
  unsigned coff[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int c = 16 * ks + 2 * q + 8 * (v / 2) + v % 2;
      int off = p.nslots * p.slot_bytes;
      for (int g = 0; g < p.nslots; ++g)
        if (c >= p.s_c0[g] && c < p.s_c0[g] + p.s_n[g])
          off = g * p.slot_bytes + (c - p.s_c0[g]) * CF_LINE;
      coff[ks][v] = off;
    }
  const unsigned col = (16 * wq + lane / 4 + 7) * 2;
// A of step K_ (tap t, channel step ks) of every row into ab[B_]
#define CF_LOAD_A(B_, K_)                                                   \
  {                                                                         \
    const int t_ = (K_) / KS, ks_ = (K_) % KS;                              \
    _Pragma("unroll") for (int f = 0; f < MPW; ++f) {                       \
      const unsigned row = st + ((wg + 2 * f + t_ / 3) * bw) * CF_LINE +     \
                           col + (t_ % 3) * 2;                              \
      _Pragma("unroll") for (int h = 0; h < 2; ++h)                         \
      _Pragma("unroll") for (int i = 0; i < 2; ++i) {                       \
        const unsigned at = row + 16 * i;                                   \
        ab[B_][f][2 * h + i] = lds16(at + coff[ks_][2 * h]) |               \
                               lds16(at + coff[ks_][2 * h + 1]) << 16;      \
      }                                                                     \
    }                                                                       \
  }
  unsigned char* out = smem + p.off_out + wg * MPW * CF_OUT_BYTES;
  mbar_wait(wbar, 0);
  const unsigned char* wsm = smem + p.off_w;
  int s = 0;
  unsigned ph = 0;
  int cur_n = -1;
  for (int u = u0; u < u1; ++u) {
    const CfTile a(p, u);
    if (p.stats && a.n != cur_n) {
      if (cur_n >= 0) CF_FLUSH(cur_n);
      cur_n = a.n;
    }
    mbar_wait(arrived + s, ph);
    const unsigned st = smem_u32(smem + s * p.stage_bytes);
    float acc[MPW][4 * CF_N8];
#pragma unroll
    for (int f = 0; f < MPW; ++f)
#pragma unroll
      for (int i = 0; i < 4 * CF_N8; ++i) acc[f][i] = 0.0f;
    // 9 taps x KS steps of one m64n48k16 per row, straight-line; A in
    // three register buffers: the next step's loads while two groups may
    // be in flight
    unsigned ab[3][MPW][4];
    CF_LOAD_A(0, 0);
#pragma unroll
    for (int f = 0; f < MPW; ++f)
#pragma unroll
      for (int i = 0; i < 4 * CF_N8; ++i)
        asm volatile("" : "+f"(acc[f][i])::"memory");
#pragma unroll
    for (int k = 0; k < 9 * KS; ++k) {
      wgmma_fence();
      const uint64_t desc = wgmma_desc(wsm + k * CF_N8 * 256);
#pragma unroll
      for (int f = 0; f < MPW; ++f)
        WgmmaRS<CF_N8>::mma(acc[f], ab[k % 3][f], desc);
      wgmma_commit();
      if (k + 1 < 9 * KS) CF_LOAD_A((k + 1) % 3, k + 1);
      wgmma_wait<1>();                 // step k - 1 done: its A free
#pragma unroll
      for (int f = 0; f < MPW; ++f) keep_live(ab[(k + 2) % 3][f]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int b = 0; b < 3; ++b)
#pragma unroll
      for (int f = 0; f < MPW; ++f) keep_live(ab[b][f]);
#pragma unroll
    for (int f = 0; f < MPW; ++f)
#pragma unroll
      for (int i = 0; i < 4 * CF_N8; ++i)
        asm volatile("" : "+f"(acc[f][i])::"memory");
    if (lane == 0) mbar_arrive(empty + s);   // this warp's reads done
    if (++s == S) {
      s = 0;
      ph ^= 1;
    }

    // ---- epilogue: bias, statistics, the swizzled (48 x 64) row tiles,
    // one TMA store per row inside H
    if (ctid % 128 == 0) bulk_wait_read<0>();  // the last stores read
    if (wg == 0) NamedSync<1, 128>::sync(); else NamedSync<2, 128>::sync();
#pragma unroll
    for (int f = 0; f < MPW; ++f) {
      const bool row_in = a.h0 + wg + 2 * f < p.H;
      unsigned char* o = out + f * CF_OUT_BYTES;
#pragma unroll
      for (int i = 0; i < 4 * CF_N8; ++i) {
        const int j = i / 4, hh = (i / 2) % 2, e = i % 2;
        const int m = 16 * wq + lane / 4 + 8 * hh;   // column in the tile
        const int co = 8 * j + 2 * q + e;
        const float v = acc[f][i] + bias[2 * j + e];
        if (row_in && a.w0 + m < p.W && co < p.CO) {
          s1[2 * j + e] += v;
          s2[2 * j + e] += v * v;
        }
        *reinterpret_cast<bf16*>(o + co * 128 +
                                 (((m >> 3) ^ (co & 7)) << 4) +
                                 (m & 7) * 2) = __float2bfloat16(v);
      }
    }
    fence_proxy_async();               // for the TMA store
    if (wg == 0) NamedSync<1, 128>::sync(); else NamedSync<2, 128>::sync();
    if (ctid % 128 == 0) {
      for (int f = 0; f < MPW; ++f)
        if (a.h0 + wg + 2 * f < p.H)
          tma_store_5d(&ymap, out + f * CF_OUT_BYTES, a.w0,
                       a.h0 + wg + 2 * f, 0, a.d, a.n);
      bulk_commit();
    }
  }
  if (p.stats && cur_n >= 0) CF_FLUSH(cur_n);
  if (ctid % 128 == 0) bulk_wait_all();  // the stores done before exit
#undef CF_LOAD_A
#undef CF_FLUSH
}

// The TMA route's tile rows, ring and shared-memory layout for nslots
// boxes of bw channels and KS K steps, or false where they do not fit: 4
// rows (two m64 tiles per consumer warpgroup), else 2, on the most stages
// (3, else 2)
static bool cf_tma_layout(CfTmaParams& p) {
  p.w_bytes = 9 * p.KS * CF_N8 * 256;
  for (int th : {4, 2}) {
    for (int st = CF_MAX_STAGES; st >= 2; --st) {
      const int slot = (p.bw * (th + 2) * CF_LINE + 127) / 128 * 128;
      const int stage = (p.nslots + (p.C % 16 ? 1 : 0)) * slot;
      const size_t out = (size_t)th * CF_OUT_BYTES;
      const size_t tab = 2 * CF_CMAX * sizeof(float);
      const size_t red = (size_t)8 * CF_NCO * 2 * sizeof(float);
      const size_t off_out = ((size_t)st * stage + 1023) / 1024 * 1024;
      const size_t total = 1024 + off_out + out + p.w_bytes + tab + red +
                           8 * (3 * st + 1);
      if (total > SMEM_LIMIT) continue;
      p.TH = th;
      p.stages = st;
      p.slot_bytes = slot;
      p.stage_bytes = stage;
      p.off_out = (int)off_out;
      p.off_w = p.off_out + (int)out;
      p.off_tab = p.off_w + p.w_bytes;
      p.off_red = p.off_tab + (int)tab;
      p.off_bar = p.off_red + (int)red;
      return true;
    }
  }
  return false;
}

// x (N, D, C, H, W) over (W, C, H, D, N) in boxes of (88, bw, TH + 2, 1,
// 1): a box lands as [row][channel][88]. No swizzle: the consumers read
// single values at any column.
static int cf_x_map(CUtensorMap* map, const void* x, const CfTmaParams& p) {
  const uint64_t HW2 = 2ull * p.H * p.W;
  const uint64_t dims[5] = {(uint64_t)p.W, (uint64_t)p.C, (uint64_t)p.H,
                            (uint64_t)p.D, (uint64_t)p.N};
  const uint64_t strides[4] = {HW2, 2ull * p.W, HW2 * p.C, HW2 * p.C * p.D};
  const int box[5] = {CF_BOXW, p.bw, p.TH + 2, 1, 1};
  return tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, x, dims,
                    strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

// y (N, D, CO, H, W) over (W, H, CO, D, N) in boxes of one row of 64
// columns and 48 output channels, 128-byte swizzle
static int cf_y_map(CUtensorMap* map, void* y, const CfTmaParams& p) {
  const uint64_t HW2 = 2ull * p.H * p.W;
  const uint64_t dims[5] = {(uint64_t)p.W, (uint64_t)p.H, (uint64_t)p.CO,
                            (uint64_t)p.D, (uint64_t)p.N};
  const uint64_t strides[4] = {2ull * p.W, HW2, HW2 * p.CO,
                               HW2 * p.CO * p.D};
  const int box[5] = {CF_TW, 1, CF_NCO, 1, 1};
  return tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, y, dims,
                    strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// the widest of nslots slots, or 0 where a slot is not 1 .. 16 channels
static int cf_box_channels(const int* slots, int nslots) {
  int bw = 0;
  for (int g = 0; g < nslots; ++g) {
    const int n = slots[3 * g + 1];
    if (n < 1 || n > 16) return 0;
    bw = n > bw ? n : bw;
  }
  return bw;
}

static int launch_cf_tma(const void* x, const void* wpk, const void* b,
                         const void* mult, const void* off, void* y,
                         void* stats, const int* slots, int nslots, int N,
                         int D, int H, int W, int C, int CO,
                         cudaStream_t stream) {
  CfTmaParams p;
  p.b = static_cast<const bf16*>(b);
  p.mult = static_cast<const float*>(mult);
  p.off = static_cast<const float*>(off);
  p.stats = static_cast<float*>(stats);
  p.wpk = static_cast<const bf16*>(wpk);
  p.N = N; p.D = D; p.H = H; p.W = W; p.C = C; p.CO = CO;
  p.nslots = nslots;
  p.KS = (C + 15) / 16;
  for (int g = 0; g < CF_SLOTS; ++g) {
    const bool on = g < nslots;
    p.s_c0[g] = on ? slots[3 * g] : 0;
    p.s_n[g] = on ? slots[3 * g + 1] : 0;
    p.s_sh[g] = on ? slots[3 * g + 2] : 0;
    if (on && (p.s_c0[g] < 0 || p.s_c0[g] + p.s_n[g] > C))
      return (int)cudaErrorInvalidValue;
  }
  p.bw = cf_box_channels(slots, nslots);
  if (p.bw == 0 || p.KS > CF_KSMAX || nslots > CF_SLOTS || wpk == nullptr ||
      (uintptr_t)wpk % 16 || !cf_tma_layout(p))
    return (int)cudaErrorInvalidValue;
  p.n_ht = (H + p.TH - 1) / p.TH;
  p.n_wt = (W + CF_TW - 1) / CF_TW;
  const long long ntiles = (long long)N * D * p.n_ht * p.n_wt;
  if (ntiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  p.ntiles = (int)ntiles;
  CUtensorMap xmap, ymap;
  int err = cf_x_map(&xmap, x, p);
  if (!err) err = cf_y_map(&ymap, y, p);
  if (err) return err;
  const size_t smem = 1024 + (size_t)p.off_bar + 8 * (3 * p.stages + 1);
  typedef void (*Kernel)(const CUtensorMap, const CUtensorMap,
                         const CfTmaParams);
  static const Kernel kernels[2][CF_KSMAX] = {
      {cf_fused_tma_kernel<1, 1>, cf_fused_tma_kernel<1, 2>,
       cf_fused_tma_kernel<1, 3>, cf_fused_tma_kernel<1, 4>,
       cf_fused_tma_kernel<1, 5>},
      {cf_fused_tma_kernel<2, 1>, cf_fused_tma_kernel<2, 2>,
       cf_fused_tma_kernel<2, 3>, cf_fused_tma_kernel<2, 4>,
       cf_fused_tma_kernel<2, 5>}};
  const Kernel kernel = kernels[p.TH / 2 - 1][p.KS - 1];
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int grid = p.ntiles < sms ? p.ntiles : sms;
  kernel<<<grid, CF_TMA_THREADS, smem, stream>>>(xmap, ymap, p);
  return (int)cudaGetLastError();
}

// one image row (W*C values of `esize` bytes) per block, through shared
// memory: read as the row, written as W rows of C (the same bytes)
__global__ void reshape_hwc_kernel(const unsigned char* x, unsigned char* y,
                                   int row_bytes) {
  extern __shared__ __align__(16) unsigned char s_row[];
  const unsigned char* src = x + (size_t)blockIdx.x * row_bytes;
  unsigned char* dst = y + (size_t)blockIdx.x * row_bytes;
  const bool vec = row_bytes % 16 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)y % 16 == 0;
  if (vec) {
    for (int i = threadIdx.x; i < row_bytes / 16; i += blockDim.x)
      reinterpret_cast<uint4*>(s_row)[i] =
          reinterpret_cast<const uint4*>(src)[i];
  } else {
    for (int i = threadIdx.x; i < row_bytes; i += blockDim.x)
      s_row[i] = src[i];
  }
  __syncthreads();
  if (vec) {
    for (int i = threadIdx.x; i < row_bytes / 16; i += blockDim.x)
      reinterpret_cast<uint4*>(dst)[i] =
          reinterpret_cast<const uint4*>(s_row)[i];
  } else {
    for (int i = threadIdx.x; i < row_bytes; i += blockDim.x)
      dst[i] = s_row[i];
  }
}

// ===========================================================================
// Plain C entry points (bound with ctypes). The launches return a
// cudaError_t: the configuration check, the tensor maps,
// cudaFuncSetAttribute, or cudaGetLastError() after the launch. They launch
// on `stream` and do not synchronise.

// y (H*W, C) = x (H, W*C), elements of `esize` bytes
extern "C" int reshape_hwc_launch(const void* x, void* y, int H, int W,
                                  int C, int esize, void* stream) {
  if (H < 1 || W < 1 || C < 1 || esize < 1) return (int)cudaErrorInvalidValue;
  const long long row = (long long)W * C * esize;
  if (row > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      reshape_hwc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)row);
  if (err != cudaSuccess) return (int)err;
  reshape_hwc_kernel<<<H, 256, (size_t)row,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(x), static_cast<unsigned char*>(y),
      (int)row);
  return (int)cudaGetLastError();
}

// The route of the channels-first block, the one place the rule lives: 1
// (TMA) where tensor maps describe x (N, D, C, H*W) and y (N, D, CO, H*W)
// (16-byte-aligned tensors, W % 8 == 0 for 16-byte row strides), CO <= 48
// (one n48 tile), C <= 80, the shift groups fall in 1 .. CF_SLOTS slots of
// 1 .. 16 channels (slots: (first channel, channels, shift) triples, the
// host's cut) and the stages fit shared memory; else 0 (ldg)
extern "C" int cf_route(const void* x, const void* y, int N, int D, int H,
                        int W, int C, int CO, const int* slots, int nslots) {
  if (N < 1 || D < 1 || H < 1 || W < 1 || C < 1 || CO < 1) return 0;
  if ((uintptr_t)x % 16 || (uintptr_t)y % 16 || W % 8) return 0;
  if (CO > CF_NCO || C > CF_CMAX || nslots < 1 || nslots > CF_SLOTS)
    return 0;
  CfTmaParams p;
  p.C = C;
  p.KS = (C + 15) / 16;
  p.nslots = nslots;
  p.bw = cf_box_channels(slots, nslots);
  return p.bw > 0 && cf_tma_layout(p) ? 1 : 0;
}

// x (N, D, C, H*W) bf16; w (CO, 9*C) bf16, k = tap * C + channel, tap =
// 3*(dh+1) + (dw+1) (the ldg route); wpk the packed weights of the TMA
// route (9 * ceil(C / 16) * CF_N8 * 256 bytes: per tap the channels in
// 16-channel steps by wgmma_b_index over CF_N8 groups of 8 output
// channels, zero past CO and C); b (CO) bf16; mult/off (C) float32 or
// both null; y (N, D, CO, H*W) bf16; stats (N, CO, 2) float32 zeroed, or
// null; groups (c0, c1, shift) triples (the ldg route), slots (first
// channel, channels, shift) triples (the TMA route). Runs the route
// cf_route gives, which then needs its weights (the other pointer may be
// null), and stores it in *route.
extern "C" int cf_fused_launch(const void* x, const void* w, const void* wpk,
                               const void* b, const void* mult,
                               const void* off, void* y, void* stats,
                               const int* groups, int ngroups,
                               const int* slots, int nslots, int N, int D,
                               int H, int W, int C, int CO, int* route,
                               void* stream) {
  if (N < 1 || D < 1 || H < 1 || W < 1 || C < 1 || CO < 1 || ngroups < 1 ||
      ngroups > MAX_GROUPS || (mult == nullptr) != (off == nullptr))
    return (int)cudaErrorInvalidValue;
  *route = cf_route(x, y, N, D, H, W, C, CO, slots, nslots);
  if (*route)
    return launch_cf_tma(x, wpk, b, mult, off, y, stats, slots, nslots, N, D,
                         H, W, C, CO, static_cast<cudaStream_t>(stream));
  if (w == nullptr) return (int)cudaErrorInvalidValue;
  CfParams p;
  p.x = static_cast<const bf16*>(x);
  p.w = static_cast<const bf16*>(w);
  p.b = static_cast<const bf16*>(b);
  p.mult = static_cast<const float*>(mult);
  p.off = static_cast<const float*>(off);
  p.y = static_cast<bf16*>(y);
  p.stats = static_cast<float*>(stats);
  p.N = N; p.D = D; p.H = H; p.W = W; p.C = C; p.CO = CO;
  for (int g = 0; g < MAX_GROUPS; ++g) {
    const bool on = g < ngroups;
    p.g0[g] = on ? groups[3 * g] : 0;
    p.g1[g] = on ? groups[3 * g + 1] : 0;
    p.gs[g] = on ? groups[3 * g + 2] : 0;
  }
  p.ngroups = ngroups;
  p.Cs = (C + 15) / 16 * 16;
  p.KP = 9 * p.Cs + 8;                 // an odd number of 16-byte units
  // a channel's staged window, (TH + 2) rows of WT, padded so that the 8
  // channel rows of an ldmatrix fall in distinct bank groups
  p.CS = (CF_TH + 2) * CF_WT + 8;
  constexpr int BM = CF_MF * 16;
  const size_t w_bytes = ((size_t)BM * p.KP * 2 + 127) / 128 * 128;
  const size_t op_bytes = ((size_t)3 * p.Cs * p.CS * 2 + 127) / 128 * 128;
  p.off_op = (int)w_bytes;
  p.off_tab = (int)(w_bytes + op_bytes);
  const size_t smem = w_bytes + op_bytes + (size_t)p.Cs * 12 +
                      (size_t)(CF_THREADS / 32) * BM * 2 * 4;
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      cf_fused_ldg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  // depth chunks: at least ~4 blocks per SM of a 132-SM card in all
  const long long tiles = (long long)N * ((H + CF_TH - 1) / CF_TH) *
                          ((W + CF_WT - 1) / CF_WT);
  long long n_dc = (4 * 132 + tiles - 1) / tiles;
  if (n_dc > D) n_dc = D;
  if (n_dc < 1) n_dc = 1;
  p.d_chunk = (int)((D + n_dc - 1) / n_dc);
  n_dc = (D + p.d_chunk - 1) / p.d_chunk;
  const long long n_blocks = tiles * n_dc;
  if (n_blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)n_blocks, (CO + BM - 1) / BM);
  cf_fused_ldg_kernel<<<grid, CF_THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
