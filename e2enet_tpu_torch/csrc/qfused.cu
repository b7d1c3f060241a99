// The fused shiftConvPP block with a lazy up-link part, for NVIDIA Hopper
// (sm_90a), bfloat16.
//
// Replaces the lazy mode of the Pallas TPU kernel
// e2enet_tpu/ops/qfused.py:_fwd_kernel (LazyUp, qfused.py:585-623): the
// k == s transposed-conv up-link of the level below is computed on load,
// inside the conv kernel, so the finer level's (N, D, H, W, C_up) up tensor
// never reaches device memory. For an implicit concat of parts whose last
// part is the up-link, and a level-0 voxel (d, h, w) of an up channel c in
// shift group s:
//
//   a        = lrelu(raw * m + o)              the level-1 pending raw
//                                              (N, D/2, H/2, W/2, cin), in
//                                              bf16 arithmetic: m, o rounded
//                                              to bf16, every step rounded
//   u[d', h, w, c] = bf16( sum_ci Wu[d'&1, h&1, w&1, ci, c]
//                          * a[d'>>1, h>>1, w>>1, ci] )   f32 sums
//   staged value   = u[d - s, h, w, c]          zero where d - s leaves
//                                               [0, D) and in the H/W halo
//
// and then exactly the fused block of fused_block.cu on the concat: y =
// conv2d_3x3(S) + b (bias rounded to bf16), f32 statistics by atomics. The
// up weight Wu (8 parities, C_up, cin) carries the mirror flips already,
// the conv taps and negated groups carry the rest, so one kernel serves
// all 8 mirror passes and the sparse plan's compact groups. The depth
// parity follows the SHIFTED source depth d - s: each up column reads its
// own coarse depth and depth parity, which the kernel derives from the
// shift groups it stages the operand by (source_depth).
//
// What bounds it: at the dense level-0 shape (128^3; 48 pending + up 96 ->
// 48; CO 48) 174 GFLOP of conv plus 19.3 GFLOP of up GEMM against ~450 MB
// of traffic: the bf16 tensor cores (~0.195 ms at 989 TFLOP/s). In
// practice a block runs alone on its SM (~200 KB of shared memory, 16 warps
// at up to 128 registers), so its phases (staging, up-link, products,
// epilogue) follow one another between barriers, each bound by latency
// rather than by a unit's throughput; the design keeps the phases few and
// overlaps copies with products where a buffer is free.
//
// Design. One block of 16 warps per (n, d, TH image rows, W tile of at most
// 32 columns) and 48-wide CO tile, 32 row fragments of 16 pixels (TH = 16
// at W >= 32): a tall, narrow tile, whose halo is 1.2x the output's pixels
// and whose window of coarse pixels is 1.4x those the output needs. The
// operand is staged in K chunks (one for a concat of at most 48 channels,
// else 48-channel chunks from 0 up to the up part and the up part's own
// 48-column chunks), each chunk's 9 taps accumulating into the same
// registers: half the operand per pass at the bench's shape, so the tile is
// twice as tall as a whole-operand tile could be. The up part's chunks come
// first (the bench's has one; a wider one runs in a second instantiation,
// which computes each further chunk's up-link after the previous taps):
//  1. cp.async of the chunk's weights for all 9 taps (no barrier between
//     taps), of the up weights (each up column's depth parity at this
//     output depth, all four (h, w) parity classes) and of the first coarse
//     depth's raw pixels; zeros for the up channels of the operand;
//  2. the up-link, per coarse depth that the up columns read (two at the
//     bench's shape, at most three): the window's coarse pixels, rows and
//     columns flattened, normalised in bf16x2 arithmetic (16-byte units), a
//     barrier, ONE product over every up column that reads this depth
//     (ldmatrix + mma.sync, a warp per 16 coarse pixels x 16 columns, the
//     four parity classes from one A fragment; the next depth's loads in
//     flight meanwhile), each value rounded to bf16 into its fine pixel of
//     the staged chunk (only inside the volume), a barrier;
//  3. the first materialised chunk's copies issued into the up-link's
//     buffers, now free, then the chunk's 9 taps on wgmma
//     (shift_conv_block.cuh: wgmma_taps, straight-line code per chunk
//     width and output tile): A from registers by ldmatrix at each tap's
//     offset, B the tap's weights by descriptor, two m64 tiles per
//     warpgroup, one commit group in flight;
// then each materialised chunk's weights, pending norms and taps, the next
// chunk's copies in flight during them. Steps 1-3 and the materialised
// chunks are the K-chunked body that the fused block (#1, fused_block.cu)
// runs too (shift_conv_block.cuh: chunk_step, materialised_chunks), here
// with the up chunks in front, one tile per block and each chunk's weights
// staged when it is reached. The epilogue is #1's too (store_tile_regs):
// y stored from the registers, the statistics summed over the block before
// one atomic pair per output channel. Each up value is
// computed once per consuming block plus its halo; each coarse pixel is
// normalised once per output depth and up chunk that reads it. Output
// channels come in tiles of 48 on the grid's y; each tile stages the
// operand and computes the up-link again (2x the up-link's products at CO
// 96; the bench's lazy nodes have CO 48 at most). The same kernel with its
// taps on mma.sync (mma_taps_packed, the same packed weights) is the
// control that measures the wgmma loop.

#include "shift_conv_block.cuh"

#define KC_MAX 48          // channels of one staged K chunk
#define MPW_LAZY 2         // row fragments per warp: 32 per block
#define WF_MAX 2           // row fragments per W tile: 32 columns
#define A_UPT 5            // coarse units per thread held in registers

// floor(x / 2) for any sign
__device__ __forceinline__ int floor_half(int x) { return (x - (x < 0)) / 2; }

// the up-link's norm of 8 channels in bf16x2 arithmetic: each op rounded
// once to bf16, which is the f32 op rounded to bf16 for bf16 operands (see
// fused_block_bwd.cu: geff_unit); m, o and the slope are bf16 values
__device__ __forceinline__ uint4 norm_unit_bf16(uint4 v, uint4 m, uint4 o) {
  __nv_bfloat162* x2 = reinterpret_cast<__nv_bfloat162*>(&v);
  const __nv_bfloat162* m2 = reinterpret_cast<const __nv_bfloat162*>(&m);
  const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o);
  const __nv_bfloat162 slope = __float2bfloat162_rn(0.01f);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const __nv_bfloat162 a = __hadd2_rn(__hmul2_rn(x2[e], m2[e]), o2[e]);
    x2[e] = __hmax2(a, __hmul2_rn(a, slope));
  }
  return v;
}

// the source depth d - s of concat channel c at output depth d, s the
// shift of its group (0 outside every group, as stage_operand_issue reads
// it), or -1 where d - s leaves [0, D)
__device__ __forceinline__ int source_depth(const Params& p, int d, int c) {
  int s = 0;
  for (int g = 0; g < p.ngroups; ++g)
    if (c >= p.g0[g] && c < p.g1[g]) s = p.gs[g];
  const int ds = d - s;
  return ds >= 0 && ds < p.D ? ds : -1;
}

struct LazyUp {
  const bf16* raw;        // (N, Dc, Hc, Wc, cin)
  const float* mult;      // (N, cin)
  const float* off;
  const bf16* w;          // (8 parities bd*4 + bh*2 + bw, C_up, cin)
  int Dc, Hc, Wc, cin, cout;
  int cins;               // cin rounded up to 16
  int cpa;                // shared row stride of the A and B stages
  int vec16;              // raw rows copy in 16-byte units
  int cb_up;              // first concat channel of the up part's first
                          // chunk: 0 (one chunk holds all) or its first
  int nup;                // chunks of the up part, KC_MAX columns each
  int nmat;               // chunks of p.Cs channels from 0 before them
  // within the hook region: column codes, norm pairs, B, A
  int off_mo, off_b, off_a;

  // up columns j0 .. j0 + cols(j0) form one chunk
  __device__ __forceinline__ int cols(int j0) const {
    return min(KC_MAX, cout - j0);
  }

  // Issue the up stage of columns j0 ..: their codes at depth d (the source
  // depth d - s, -1 outside [0, D) and past the chunk), the bf16 norm, and
  // by cp.async the columns' up weights, rows (parity class, column) with K
  // contiguous, of each column's depth parity; zero rows for columns
  // outside [0, D) or past the chunk
  __device__ __forceinline__ void issue(const Params& p, unsigned char* region,
                                        int n, int d, int j0, int tid) const {
    const int nc = cols(j0), NC = (nc + 15) / 16 * 16;
    const int c_up = p.pc0[p.nparts - 1] + j0;   // concat channel of j0
    int* s_code = reinterpret_cast<int*>(region);
    bf16* s_mo = reinterpret_cast<bf16*>(region + off_mo);
    bf16* s_b = reinterpret_cast<bf16*>(region + off_b);
    for (int j = tid; j < NC; j += NTHREADS)
      s_code[j] = j < nc ? source_depth(p, d, c_up + j) : -1;
    for (int c = tid; c < cins; c += NTHREADS) {
      const bool on = c < cin;
      s_mo[c] = __float2bfloat16(on ? mult[(size_t)n * cin + c] : 0.0f);
      s_mo[cins + c] = __float2bfloat16(on ? off[(size_t)n * cin + c] : 0.0f);
    }
    const int KC8 = cins / 8;
    const bool vec = cin % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(w) % 16 == 0;
    for (int u = tid; u < 4 * NC * KC8; u += NTHREADS) {
      const int k8 = u % KC8, r = u / KC8;
      const int j = r % NC, cls = r / NC, k0 = k8 * 8;
      const int code = j < nc ? source_depth(p, d, c_up + j) : -1;
      bf16* dst = s_b + (size_t)r * cpa + k0;
      const bf16* src =
          w + ((size_t)((code & 1) * 4 + cls) * cout + j0 + j) * cin + k0;
      if (code >= 0 && vec && k0 < cin) {
        cp_async16(dst, src);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = code >= 0 && k0 + e < cin ? src[e]
                                             : __float2bfloat16(0.0f);
      }
    }
  }

  // the tile's window of coarse pixels (rows hc0 .., columns wc0 ..),
  // flattened: the coarse pixels under the staged rows and columns
  struct Window {
    int hc0, wc0, AW, npix, MFa;
    __device__ Window(const Params& p, int h0, int w0) {
      hc0 = floor_half(h0 - 1);
      wc0 = floor_half(w0 - 1);
      AW = floor_half(w0 + 16 * p.WF) - wc0 + 1;
      npix = (floor_half(h0 + p.TH) - hc0 + 1) * AW;
      MFa = (npix + 15) / 16;
    }
  };

  // coarse depths lo .. hi holding every one that up columns j0 .. read at
  // output depth d: those of the shift groups over the chunk's columns,
  // and shift 0's where the groups leave a column out
  __device__ __forceinline__ void depths(const Params& p, int d, int j0,
                                         int& lo, int& hi) const {
    const int c0 = p.pc0[p.nparts - 1] + j0, c1 = c0 + cols(j0);
    lo = Dc;
    hi = -1;
    int covered = 0;
    for (int g = 0; g <= p.ngroups; ++g) {
      int s = 0;
      if (g < p.ngroups) {
        const int o = min(c1, p.g1[g]) - max(c0, p.g0[g]);
        if (o <= 0) continue;
        covered += o;
        s = p.gs[g];
      } else if (covered >= c1 - c0) {
        break;
      }
      const int ds = d - s;
      if (ds >= 0 && ds < p.D) {
        lo = min(lo, ds >> 1);
        hi = max(hi, ds >> 1);
      }
    }
  }

  // 16-byte unit u (pixel, 8 channels) of the window at depth dc: its
  // source, or null outside the coarse volume
  __device__ __forceinline__ const bf16* unit_src(const Window& wd, int n,
                                                  int dc, int u) const {
    const int KC8 = cins / 8;
    const int pix = u / KC8, k0 = (u - pix * KC8) * 8;
    const int row = pix / wd.AW;
    const int hc = wd.hc0 + row, wc = wd.wc0 + pix - row * wd.AW;
    if (pix >= wd.npix || hc < 0 || hc >= Hc || wc < 0 || wc >= Wc ||
        k0 >= cin)
      return nullptr;
    return raw + ((((size_t)n * Dc + dc) * Hc + hc) * Wc + wc) * cin + k0;
  }
  __device__ __forceinline__ uint4 load_unit(const bf16* src) const {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (src == nullptr) return v;
    if (vec16) return __ldg(reinterpret_cast<const uint4*>(src));
    bf16* e = reinterpret_cast<bf16*>(&v);
    const int k0 = (int)((src - raw) % cin);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      e[i] = k0 + i < cin ? src[i] : __float2bfloat16(0.0f);
    return v;
  }
  // cp.async of depth dc's window of raw coarse pixels into A (zeros
  // outside the coarse volume), for norm_a; raw rows of 16-byte units only
  __device__ __forceinline__ void issue_a(const Window& wd, bf16* s_a, int n,
                                          int dc, int tid) const {
    const int KC8 = cins / 8, units = wd.MFa * 16 * KC8;
    for (int u = tid; u < units; u += NTHREADS) {
      const int pix = u / KC8, k0 = (u - pix * KC8) * 8;
      bf16* dst = s_a + (size_t)pix * cpa + k0;
      const bf16* src = unit_src(wd, n, dc, u);
      if (src != nullptr)
        cp_async16(dst, src);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  // the norm in place on the raw window issue_a copied (landed)
  __device__ __forceinline__ void norm_a(const Window& wd, bf16* s_a,
                                         const bf16* s_mo, int n, int dc,
                                         int tid) const {
    const int KC8 = cins / 8, units = wd.MFa * 16 * KC8;
    for (int u = tid; u < units; u += NTHREADS) {
      if (unit_src(wd, n, dc, u) == nullptr) continue;
      const int pix = u / KC8, k0 = (u - pix * KC8) * 8;
      uint4* ptr = reinterpret_cast<uint4*>(s_a + (size_t)pix * cpa + k0);
      *ptr = norm_unit_bf16(*ptr, *reinterpret_cast<const uint4*>(s_mo + k0),
                            *reinterpret_cast<const uint4*>(s_mo + cins + k0));
    }
  }
  // the normalised unit u into A; zero outside the coarse volume
  __device__ __forceinline__ void store_unit(bf16* s_a, const bf16* s_mo,
                                             int u, uint4 v, bool ok) const {
    const int KC8 = cins / 8;
    const int pix = u / KC8, k0 = (u - pix * KC8) * 8;
    *reinterpret_cast<uint4*>(s_a + (size_t)pix * cpa + k0) =
        ok ? norm_unit_bf16(v, *reinterpret_cast<const uint4*>(s_mo + k0),
                            *reinterpret_cast<const uint4*>(s_mo + cins + k0))
           : make_uint4(0u, 0u, 0u, 0u);
  }
  // loads this thread's first A_UPT units of depth dc's window into
  // registers; returns which lie inside the coarse volume
  __device__ __forceinline__ unsigned load_a(const Window& wd, int n, int dc,
                                             uint4 v[A_UPT], int tid) const {
    const int units = wd.MFa * 16 * (cins / 8);
    unsigned ok = 0;
#pragma unroll
    for (int e = 0; e < A_UPT; ++e) {
      const int u = tid + e * NTHREADS;
      const bf16* src = u < units ? unit_src(wd, n, dc, u) : nullptr;
      v[e] = load_unit(src);
      ok |= (unsigned)(src != nullptr) << e;
    }
    return ok;
  }
  // A of depth dc: the units load_a holds, then any beyond them (loaded
  // here, one at a time)
  __device__ __forceinline__ void store_a(const Window& wd, bf16* s_a,
                                          const bf16* s_mo, int n, int dc,
                                          const uint4 v[A_UPT], unsigned ok,
                                          int tid) const {
    const int units = wd.MFa * 16 * (cins / 8);
#pragma unroll
    for (int e = 0; e < A_UPT; ++e) {
      const int u = tid + e * NTHREADS;
      if (u < units) store_unit(s_a, s_mo, u, v[e], (ok >> e) & 1);
    }
    for (int u = A_UPT * NTHREADS + tid; u < units; u += NTHREADS) {
      const bf16* src = unit_src(wd, n, dc, u);
      store_unit(s_a, s_mo, u, load_unit(src), src != nullptr);
    }
  }

  // Up columns j0 .. of the staged chunk (concat channels cb .., issued
  // and landed), per coarse depth dc_lo .. dc_hi that they read; with
  // vec16, depth dc_lo's raw window is in A already (issue_a). Ends with
  // the block synchronised.
  __device__ __forceinline__ void compute(const Params& p, bf16* s_in,
                                          unsigned char* region, int cb,
                                          int j0, int n, int h0, int w0,
                                          int dc_lo, int dc_hi,
                                          int tid) const {
    const int NF = (cols(j0) + 15) / 16;
    const int* s_code = reinterpret_cast<const int*>(region);
    const bf16* s_mo = reinterpret_cast<const bf16*>(region + off_mo);
    const bf16* s_b = reinterpret_cast<const bf16*>(region + off_b);
    bf16* s_a = reinterpret_cast<bf16*>(region + off_a);
    const Window wd(p, h0, w0);
    const int ch0 = p.pc0[p.nparts - 1] + j0 - cb;  // staged channel of j0
    const bool pairs = ch0 % 2 == 0;
    const int warp = tid / 32, lane = tid % 32;
    const int a_row = lane % 16, a_k = (lane / 16) * 8;
    const int b_row = lane % 8 + (lane / 16) * 8, b_k = ((lane / 8) % 2) * 8;
    const unsigned b_cls = NF * 16 * cpa * 2;        // bytes per class
    const int hc0 = wd.hc0, wc0 = wd.wc0, AW = wd.AW, npix = wd.npix;
    const int MFa = wd.MFa;
    uint4 av[A_UPT];
    unsigned aok = 0;
    if (!vec16 && dc_lo <= dc_hi) aok = load_a(wd, n, dc_lo, av, tid);
    for (int dc = dc_lo; dc <= dc_hi; ++dc) {
      if (dc == dc_lo && vec16)
        norm_a(wd, s_a, s_mo, n, dc, tid);
      else
        store_a(wd, s_a, s_mo, n, dc, av, aok, tid);
      __syncthreads();                 // A staged
      // the next depth's loads in flight during this product
      if (dc < dc_hi) aok = load_a(wd, n, dc + 1, av, tid);
      // ---- one product over the up columns that read dc: a warp per 16
      // coarse pixels x 16 columns, the four parity classes together
      for (int task = warp; task < MFa * NF; task += NWARPS) {
        const int mf = task / NF, nf = task - mf * NF;
        const int mine = s_code[nf * 16 + lane % 16];
        if (!__any_sync(0xffffffffu, mine >= 0 && (mine >> 1) == dc))
          continue;
        float acc[4][2][4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[c][h][e] = 0.0f;
        const unsigned a_addr = (unsigned)__cvta_generic_to_shared(
            s_a + (size_t)(mf * 16 + a_row) * cpa + a_k);
        const unsigned b_addr = (unsigned)__cvta_generic_to_shared(
            s_b + (size_t)(nf * 16 + b_row) * cpa + b_k);
        for (int kc = 0; kc < cins; kc += 16) {
          unsigned a[4];
          ldmatrix_x4(a, a_addr + kc * 2);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            unsigned b[4];
            ldmatrix_x4(b, b_addr + c * b_cls + kc * 2);
            mma_16816(acc[c][0], a, b[0], b[1]);
            mma_16816(acc[c][1], a, b[2], b[3]);
          }
        }
        // this lane's columns nf*16 + h*8 + 2*(lane%4) + {0, 1}
        bool on[2][2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int code = s_code[nf * 16 + h * 8 + (lane % 4) * 2 + e];
            on[h][e] = code >= 0 && (code >> 1) == dc;
          }
#pragma unroll
        for (int i = 0; i < 2; ++i) {  // pixels lane/4 and lane/4 + 8
          const int pix = mf * 16 + lane / 4 + 8 * i;
          if (pix >= npix) continue;
          const int row = pix / AW;
          const int hc = hc0 + row, wc = wc0 + pix - row * AW;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int hh = 2 * hc + (c >> 1), ww = 2 * wc + (c & 1);
            const int r = hh - (h0 - 1), q = ww - (w0 - 1);
            if (hh < 0 || hh >= p.H || ww < 0 || ww >= p.W || r < 0 ||
                r > p.TH + 1 || q < 0 || q >= p.Ws)
              continue;
            bf16* dst = s_in + ((size_t)r * p.Ws + q) * p.Cp + ch0 +
                        nf * 16 + (lane % 4) * 2;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float v0 = acc[c][h][2 * i], v1 = acc[c][h][2 * i + 1];
              if (pairs && on[h][0] && on[h][1]) {
                *reinterpret_cast<__nv_bfloat162*>(dst + h * 8) =
                    __floats2bfloat162_rn(v0, v1);
              } else {
                if (on[h][0]) dst[h * 8] = __float2bfloat16(v0);
                if (on[h][1]) dst[h * 8 + 1] = __float2bfloat16(v1);
              }
            }
          }
        }
      }
      __syncthreads();                 // A free; the chunk's up part staged
    }
  }
};

// cp.async of the chunk's weights (concat channels cb .. cb + p.Cs) for
// all 9 taps and the tile's output channels co0 .. co0 + ncol, packed for
// wgmma (wgmma_b_index, N8 groups of 8 output channels); zero past ncol
// and past C
__device__ __forceinline__ void stage_chunk_weights(const Params& p,
                                                    bf16* s_w, int cb,
                                                    int co0, int ncol,
                                                    int N8, int tid) {
  const int KC8 = p.Cs / 8, KS = p.Cs / 16, rows = N8 * 8;
  const bool vec = p.C % 8 == 0 && cb % 8 == 0;
  for (int u = tid; u < 9 * rows * KC8; u += NTHREADS) {
    const int k8 = u % KC8, r = u / KC8;
    const int n = r % rows, t = r / rows;
    const int k = cb + k8 * 8;
    bf16* dst = s_w + wgmma_b_index(t, n, k8 * 8, KS, N8);
    const bf16* src = p.w + ((size_t)t * p.CO + co0 + n) * p.C + k;
    if (n < ncol && k < p.C && vec) {
      cp_async16(dst, src);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = n < ncol && k + e < p.C ? src[e] : __float2bfloat16(0.0f);
    }
  }
}

// WGMMA: the taps on wgmma_taps, else on mma_taps_packed (the control that
// measures it). WIDE: the up part in up.nup chunks, the up-link of each
// after the previous chunk's taps; otherwise one chunk, computed before
// any product (no up-link beside live accumulators, which ptxas answers by
// serialising the wgmmas)
template <bool WGMMA, bool WIDE>
__global__ void __launch_bounds__(NTHREADS)
qfused_lazy_kernel(const Params p, const LazyUp up) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int n_ht = (p.H + p.TH - 1) / p.TH;
  int bid = blockIdx.x;
  const int wt = bid % p.n_wt;
  bid /= p.n_wt;
  const int ht = bid % n_ht;
  bid /= n_ht;
  const int d = bid % p.D;
  const int n = bid / p.D;
  const int h0 = ht * p.TH;
  const int w0 = wt * p.WF * 16;
  const int co0 = blockIdx.y * 48;
  const int nf = min(3, (p.CO - co0 + 15) / 16);  // CO fragments
  const int BN = nf * 16;
  const int ncol = min(BN, p.CO - co0);
  const int N8 = (ncol + 7) / 8;

  bf16* s_in = reinterpret_cast<bf16*>(smem);
  bf16* s_w = reinterpret_cast<bf16*>(smem + p.off_w);
  unsigned char* tab = smem + p.off_tab;
  unsigned char* region = smem + p.off_hook;

  const WarpTile<1, 3, MPW_LAZY> wtile(p, tid, nf);
  float acc[MPW_LAZY][3][2][4];
#pragma unroll
  for (int f = 0; f < MPW_LAZY; ++f)
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[f][j][h][e] = 0.0f;

  // the second operand buffer: the hook's up weights and coarse pixels
  // until its up-link is computed
  bf16* s_op2 = reinterpret_cast<bf16*>(region + up.off_b);

  // ---- the chunks of the up part first: the first one's up-link is
  // computed before any product, while the accumulators hold nothing.
  // Each chunk's first coarse depth's raw pixels are copied with it.
  const int nup = WIDE ? up.nup : 1;
  for (int u = 0; u < nup; ++u) {
    const int j0 = u * KC_MAX, cb = up.cb_up + j0;
    if (u > 0) __syncthreads();        // the last taps done: s_in, s_w free
    int dc_lo, dc_hi;
    up.depths(p, d, j0, dc_lo, dc_hi);
    if (up.vec16 && dc_lo <= dc_hi)
      up.issue_a(LazyUp::Window(p, h0, w0),
                 reinterpret_cast<bf16*>(region + up.off_a), n, dc_lo, tid);
    stage_chunk_weights(p, s_w, cb, co0, ncol, N8, tid);
    up.issue(p, region, n, d, j0, tid);
    stage_operand_issue(p, s_in, tab, cb, n, d, h0, w0, tid);
    chunk_step<MPW_LAZY, 3, WGMMA>(
        p, wtile, acc, smem, s_in, s_w, tab, n, d, h0, w0, N8, tid,
        [&] {
          up.compute(p, s_in, region, cb, j0, n, h0, w0, dc_lo, dc_hi, tid);
        },
        [&] {
          // the first materialised chunk's copies in flight during the
          // last up chunk's taps
          if (u == nup - 1 && up.nmat > 0)
            stage_operand_issue(p, s_op2, tab, 0, n, d, h0, w0, tid);
        });
  }

  // ---- the chunks of the materialised parts, in the two buffers in turn,
  // the next one's copies in flight during this one's taps; each chunk's
  // weights staged when it is reached
  int buf = 0;
  materialised_chunks<MPW_LAZY, 3, WGMMA>(
      p, wtile, acc, smem, s_op2, s_in, buf, tab, n, d, h0, w0, N8, up.nmat,
      tid,
      [&](int ch, int) -> const bf16* {
        __syncthreads();               // the last taps done: the weights
                                       // and the other buffer free
        stage_chunk_weights(p, s_w, ch * p.Cs, co0, ncol, N8, tid);
        cp_async_commit();
        return s_w;
      },
      [&](int ch, bf16* s_op, int) {
        stage_operand_issue(p, s_op, tab, ch * p.Cs, n, d, h0, w0, tid);
      },
      [](bf16*, int) {});

  // ---- epilogue from the registers; its partial statistics in the hook
  // region, free once the last taps are done
  __syncthreads();
  store_tile_regs<MPW_LAZY, 3>(p, wtile, acc, n, d, h0, w0, co0, BN, ncol,
                               tid, reinterpret_cast<float*>(region));
}

static size_t align128(size_t v) { return (v + 127) / 128 * 128; }

// shared memory of a TH-row tile (p.WF, p.Ws, p.Cs, p.Cp set): the operand
// chunk then the weights, the staging table, the hook region (the
// epilogue's partial statistics at its start); sets the offsets
static size_t lazy_smem_bytes(Params& p, LazyUp& up, int TH, int nfu) {
  const int bn_max = min(48, (p.CO + 15) / 16 * 16);
  p.TH = TH;
  p.off_w = (int)align128((size_t)(TH + 2) * p.Ws * p.Cp * sizeof(bf16));
  const size_t w_bytes = (size_t)9 * (p.Cs / 16) * (bn_max / 8) * 256;
  p.off_tab = (int)align128(p.off_w + w_bytes);
  // table: pointer, info, mult, off per channel; two ints per unit, a count
  const size_t tab_bytes = align128((size_t)p.Cs * (sizeof(void*) + 12) +
                                    (size_t)(p.Cs / 8) * 8 + 4);
  p.off_hook = p.off_tab + (int)tab_bytes;
  // the coarse window: TH/2 + 2 rows of 8*WF + 2 pixels at most
  const int npa = ((TH / 2 + 2) * (8 * p.WF + 2) + 15) / 16 * 16;
  up.off_mo = nfu * 16 * (int)sizeof(int);
  up.off_b = (int)align128(up.off_mo + (size_t)2 * up.cins * sizeof(bf16));
  up.off_a = (int)align128(up.off_b +
                           (size_t)4 * nfu * 16 * up.cpa * sizeof(bf16));
  // the up weights and coarse pixels, then the second operand buffer; the
  // epilogue's partial statistics
  size_t hook = up.off_a + (size_t)npa * up.cpa * sizeof(bf16);
  const size_t op2 = up.off_b + (size_t)p.off_w;
  const size_t red = (size_t)2 * NWARPS * 48 * sizeof(float);
  hook = hook > op2 ? hook : op2;
  return (size_t)p.off_hook + (hook > red ? hook : red);
}

// Plain C entry point (bound with ctypes). The parts are those of
// fused_block_launch, the LAST of which is the lazy up-link: its pointers
// are null and part_c[nparts-1] is C_up. up_raw is the level-below pending
// raw (N, D/2, H/2, W/2, cin) bf16, up_mult/up_off (N, cin) f32, up_w
// (8, C_up, cin) bf16 with the parity index bd*4 + bh*2 + bw. wgmma: 1 runs
// the taps on wgmma, 0 on mma.sync (the control). Returns a cudaError_t;
// launches on `stream`; does not synchronise.
extern "C" int qfused_lazy_launch(const void* const* xs,
                                  const void* const* mults,
                                  const void* const* offs, const int* part_c,
                                  const int* part_vec, int nparts,
                                  const int* groups, int ngroups,
                                  const void* w, const void* b, void* y,
                                  void* stats, int N, int D, int H, int W,
                                  int CO, const void* up_raw,
                                  const void* up_mult, const void* up_off,
                                  const void* up_w, int cin, int wgmma,
                                  void* stream) {
  Params p;
  if (!make_params(p, xs, mults, offs, part_c, part_vec, nparts, groups,
                   ngroups, w, b, y, stats, N, D, H, W, CO))
    return (int)cudaErrorInvalidValue;
  if (nparts < 2 || cin < 1 || D % 2 || H % 2 || W % 2)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < nparts; ++i)
    if ((p.x[i] == nullptr) != (i == nparts - 1))
      return (int)cudaErrorInvalidValue;
  LazyUp up;
  up.raw = static_cast<const bf16*>(up_raw);
  up.mult = static_cast<const float*>(up_mult);
  up.off = static_cast<const float*>(up_off);
  up.w = static_cast<const bf16*>(up_w);
  up.Dc = D / 2; up.Hc = H / 2; up.Wc = W / 2; up.cin = cin;
  up.cout = p.pc[nparts - 1];
  up.cins = (cin + 15) / 16 * 16;
  up.cpa = up.cins + 8;                // an odd number of 16-byte units
  up.vec16 = cin % 8 == 0 && reinterpret_cast<uintptr_t>(up_raw) % 16 == 0;
  // K chunks of p.Cs channels: one for the whole concat where it has at
  // most KC_MAX channels, else KC_MAX from 0 up to the up part and the up
  // part's own chunks of KC_MAX from its first channel
  const int c_lo = p.pc0[nparts - 1];
  up.nup = 1;
  if (p.Cs <= KC_MAX) {
    up.cb_up = 0;
    up.nmat = 0;
  } else {
    p.Cs = KC_MAX;
    up.cb_up = c_lo;
    up.nup = (up.cout + KC_MAX - 1) / KC_MAX;
    up.nmat = (c_lo + KC_MAX - 1) / KC_MAX;
  }
  p.Cp = p.Cs + 8;                     // an odd number of 16-byte units
  // W tiles of at most WF_MAX row fragments, of equal width; then the most
  // rows, up to 32 fragments, that fit shared memory
  const int wf_all = (W + 15) / 16;
  int wf = min(wf_all, WF_MAX);
  while ((wf_all + (wf_all + wf - 1) / wf - 1) / ((wf_all + wf - 1) / wf) !=
         wf)
    --wf;
  p.WF = wf;
  p.n_wt = (wf_all + wf - 1) / wf;
  p.Ws = wf * 16 + 2;
  size_t smem = 0;
  int th = min(H, NWARPS * MPW_LAZY / wf);
  for (; th >= 1; --th) {
    smem = lazy_smem_bytes(p, up, th, (min(up.cout, KC_MAX) + 15) / 16);
    if (smem <= SMEM_LIMIT) break;
  }
  if (th < 1) return (int)cudaErrorInvalidValue;
  void (*kernel)(const Params, const LazyUp) =
      wgmma ? (up.nup > 1 ? qfused_lazy_kernel<true, true>
                          : qfused_lazy_kernel<true, false>)
            : (up.nup > 1 ? qfused_lazy_kernel<false, true>
                          : qfused_lazy_kernel<false, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long n_blocks =
      (long long)N * D * ((H + p.TH - 1) / p.TH) * p.n_wt;
  if (n_blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)n_blocks, (CO + 47) / 48);
  kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(p, up);
  return (int)cudaGetLastError();
}
