// Strided encoder transition for NVIDIA Hopper (sm_90a), bfloat16.
//
// Replaces the Pallas TPU kernel e2enet_tpu/ops/qstride.py:_kernel
// (quadrant_strided_fused), the level 0 -> 1 convolutional pooling with the
// previous block's instance norm applied on load. The TPU kernel works on
// the quadrant layout; this one reads the channels-last pending raw
// x (N, D, H, W, C) directly and computes
//
//   u   = lrelu(x * mult + off)          f32, rounded to bf16
//   S   = depth_shift(u)                 zero fill AFTER the norm; output
//                                        row do of a group with shift sh
//                                        reads row sd*do + parity - sh
//   y   = conv_(1,3,3), stride (sh, sw)  f32 accumulation; the f32 bias is
//         (S) + b                        added unrounded; stored bf16
//   stats[n, co] += (sum y, sum y^2)     of the f32 accumulator
//
// Tap t in {0, 1, 2} of output (ho, wo) reads H/W position s*o + origin + t
// (origin -1, or 0 on a mirrored stride-2 axis); the mirrored taps and the
// parity come from the host, so one kernel serves all eight mirror passes.
//
// What bounds it: at the bench geometry (N=1, 128^3 x 48 -> 64^3 x 96)
// each output depth reads one source depth per channel, so a pass reads
// half of x (101 MB) and writes 50 MB against 21.7 GFLOP (K = 9*48 = 432):
// device memory bounds it (~0.045 ms at 3.35 TB/s). What held the first
// build back was memory latency: synchronous 16-byte loads into registers
// between barriers kept ~4 KB in flight per SM.
//
// Design: persistent blocks of 16 warps, one per SM, each walking output
// tiles of TH rows x 16*WF columns of one (n, do), with the next tile's
// copies in flight during this tile's products.
//  * All nine taps' weights are staged once per block, packed without
//    padding in the layout of wgmma_b_index (8 x 8 core matrices of 128
//    contiguous bytes): one ldmatrix_x4 at 16 bytes per lane reads two
//    groups of 8 output channels without bank conflicts.
//  * Two operand buffers. Per tile, a per-channel table gives each
//    channel's source depth (or none: outside [0, D), or K padding), and
//    8-channel units are classified as zero, one 16-byte cp.async, four
//    4-byte cp.async (channel pairs of one source depth), or eight scalar
//    loads (normalised at once). The raw, shifted, zero-haloed input rows
//    land in shared memory with the columns split by parity at stride 2
//    (plane = column % 2), so the 16 pixels of an MMA row fragment are
//    consecutive staged rows Cp = Cs + 8 channels apart: ldmatrix's eight
//    rows fall in distinct bank groups. After the copies land, one pass over
//    shared memory applies the norm to the copied units that hold data
//    (f32, one rounding to bf16), so the zero fill stays zero.
//  * Per tile: wait for its copies, normalise, issue the NEXT tile's copies
//    into the other buffer, then this tile's 9 taps x Cs/16 K-steps of
//    ldmatrix + mma.sync.m16n8k16 (bf16, f32 accumulators); warps form an
//    8 (M) x 2 (N) grid, one 16-pixel row fragment each: 16 warps, not 8,
//    because every phase of a tile (copies, norm pass, products, stores)
//    is bound by latency, and 16 warps halve each warp's share. About
//    one tile of copies (~60 KB at the bench shape) is in flight per SM
//    while the products run. Where two buffers do not fit, one buffer,
//    with the copies issued after the products.
//  * A pair unit's four 4-byte copies go to four adjacent lanes, so the
//    pairs that share a source depth are adjacent bytes of one request.
//  * The epilogue adds the f32 bias, stores bf16 pairs and reduces the
//    statistics over the warp's rows with shuffles into shared memory,
//    flushed to the (zeroed) output with f32 atomics when the sample
//    changes: at the top of the tile that starts the new sample, so the
//    flush carries the sample of the tiles already finished, not that of
//    the tile whose copies are in flight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define MAX_GROUPS 8
#define NWARPS 16
#define NTHREADS (NWARPS * 32)
#define WARPS_M 8
#define WARPS_N 2
#define MPW 1        // row fragments per warp
#define SMEM_LIMIT (227 * 1024)

#define UNIT_ZERO 0
#define UNIT_16 1
#define UNIT_PAIRS 2
#define UNIT_SCALAR 3

struct Params {
  const bf16* x;                      // (N, D, H, W, C)
  // an H slab's halo rows (N, D, 1, W, C), raw: above row 0 (xt) and
  // below row H - 1 (xb), read through the norm where the staging would
  // zero-fill row -1 / row H; null: zero fill (the volume's edge)
  const bf16* xt;
  const bf16* xb;
  const float* mult;                  // (N, C)
  const float* off;
  int g0[MAX_GROUPS], g1[MAX_GROUPS], gs[MAX_GROUPS];
  int ngroups;
  const bf16* w;                      // (9, CO, C), tap = 3*th + tw
  const float* b;                     // (CO)
  bf16* y;                            // (N, Do, Ho, Wo, CO)
  float* stats;                       // (N, CO, 2), zeroed by the caller
  int N, D, H, W, C, CO, Do, Ho, Wo;
  int sd, sh, sw, parity, org_h, org_w;
  int Cs, Cp, BN, KS, N8;             // K and CO padded; smem row stride
  int WF, TW, TH, n_wt, n_ht, ntiles;
  int SR, PL;                         // staged rows; entries per plane
  int vec16, vec4;                    // widest aligned pixel-row copy
  int nbuf;                           // operand buffers: 2, or 1
  int off_in, in_stride, off_tab, off_st;  // shared-memory layout (bytes)
};

__device__ __forceinline__ float norm_lrelu(float x, float m, float o) {
  // no fma contraction: the plain torch version rounds the product
  const float a = __fadd_rn(__fmul_rn(x, m), o);
  return fmaxf(a, __fmul_rn(a, 0.01f));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
// 4 bytes from gmem, or zeros when !valid (gmem then not read)
__device__ __forceinline__ void cp_async4_zfill(void* smem, const void* gmem,
                                                bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_16816(float d[4], const unsigned a[4],
                                          unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// element offset of (tap t, output channel n, channel k) in the packed
// weights of KS 16-channel steps and N8 groups of 8 output channels per
// tap (shift_conv_block.cuh's wgmma_b_index): 8 x 8 core matrices of 8
// output channels by 8 channels, 128 contiguous bytes each
__device__ __forceinline__ int packed_index(int t, int n, int k, int KS,
                                            int N8) {
  return ((((t * KS + k / 16) * N8 + n / 8) * 2 + (k % 16) / 8) * 8 + n % 8) *
             8 + k % 8;
}

// the per-tile table at p.off_tab: source depth, norm per channel; unit
// kinds, the units a norm pass visits and their count
struct Table {
  int* dsrc;
  float* m;
  float* o;
  int* unit;
  int* normk;
  int* nnorm;
  __device__ Table(unsigned char* smem, const Params& p) {
    dsrc = reinterpret_cast<int*>(smem + p.off_tab);
    m = reinterpret_cast<float*>(dsrc + p.Cs);
    o = m + p.Cs;
    unit = reinterpret_cast<int*>(o + p.Cs);
    normk = unit + p.Cs / 8;
    nnorm = normk + p.Cs / 8;
  }
};

struct Tile {
  int n, dout, h0, w0;
  __device__ Tile(const Params& p, int tile) {
    int rest = tile;
    const int wt = rest % p.n_wt;
    rest /= p.n_wt;
    const int ht = rest % p.n_ht;
    rest /= p.n_ht;
    dout = rest % p.Do;
    n = rest / p.Do;
    h0 = ht * p.TH;
    w0 = wt * p.TW;
  }
};

// The table of tile `tl`: each thread of a unit computes its 8 channels'
// source depths (and, when the sample changes, their norm) and the unit's
// kind; thread 0 lists the units a norm pass visits. Ends synchronised.
__device__ __forceinline__ void prepare(const Params& p, const Table& tb,
                                        const Tile& tl, bool new_n, int tid) {
  const int KC8 = p.Cs / 8;
  if (tid < KC8) {
    const int c0 = tid * 8;
    int ds[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int c = c0 + e;
      ds[e] = -1;
      if (c < p.C) {
        int s = 0;
        for (int g = 0; g < p.ngroups; ++g)
          if (c >= p.g0[g] && c < p.g1[g]) s = p.gs[g];
        const int d = p.sd * tl.dout + p.parity - s;
        if (d >= 0 && d < p.D) ds[e] = d;
      }
      tb.dsrc[c] = ds[e];
      if (new_n) {
        tb.m[c] = c < p.C ? p.mult[(size_t)tl.n * p.C + c] : 0.0f;
        tb.o[c] = c < p.C ? p.off[(size_t)tl.n * p.C + c] : 0.0f;
      }
    }
    bool zero = true, one = p.vec16 != 0, pairs = p.vec4 != 0;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      zero = zero && ds[e] < 0;
      one = one && ds[e] >= 0 && ds[e] == ds[0];
      if (e % 2 == 0) pairs = pairs && ds[e] == ds[e + 1];
    }
    tb.unit[tid] = zero ? UNIT_ZERO : one ? UNIT_16
                   : pairs ? UNIT_PAIRS : UNIT_SCALAR;
  }
  __syncthreads();
  if (tid == 0) {
    int nn = 0;
    for (int k = 0; k < KC8; ++k)
      if (tb.unit[k] == UNIT_16 || tb.unit[k] == UNIT_PAIRS)
        tb.normk[nn++] = k;
    *tb.nnorm = nn;
  }
}

// Issue the staging of tile `tl` into s_in as one committed cp.async group:
// rows sh*h0 + org_h .. + SR, columns sw*w0 + org_w + j, j = idx*sw + plane.
// A warp takes a line (unit k, staged row, plane) at a time, its lanes the
// line's PL columns, so the unit's kind and source depths are the warp's
// (no divergence, no division per unit). Zeros and the scalar units
// (normalised here) are stored at once.
__device__ __forceinline__ void issue(const Params& p, const Table& tb,
                                      const Tile& tl, bf16* s_in, int warp,
                                      int lane) {
  const int KC8 = p.Cs / 8, Cp = p.Cp;
  const int lines = p.SR * p.sw;       // (row, plane) pairs
  const size_t dimage = (size_t)p.H * p.W * p.C;
  for (int l = warp; l < KC8 * lines; l += NWARPS) {
    const int k = l / lines, rp = l - k * lines;
    const int row = rp / p.sw, plane = rp - row * p.sw;
    const int hi = p.sh * tl.h0 + p.org_h + row;
    const int c0 = k * 8;
    const bf16* halo = hi == -1 ? p.xt : hi == p.H ? p.xb : nullptr;
    const bool inside = hi >= 0 && hi < p.H;
    const int kind = inside || halo ? tb.unit[k] : UNIT_ZERO;
    bf16* dst0 = s_in + (size_t)rp * p.PL * Cp + c0;
    // a halo row's depths lie W * C apart
    const size_t dstride = inside ? dimage : (size_t)p.W * p.C;
    const bf16* src0 =
        inside ? p.x + (((size_t)tl.n * p.D * p.H + hi) * p.W) * p.C + c0
               : halo + (size_t)tl.n * p.D * p.W * p.C + c0;
    const int wf = p.sw * tl.w0 + p.org_w + plane;
    int de[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) de[e] = tb.dsrc[c0 + e];
    if (kind == UNIT_PAIRS) {
      // four lanes per column, a pair each: the pairs of one depth in a
      // unit are adjacent bytes, whose copies the load unit merges
      const int e = (lane % 4) * 2;
      for (int idx = lane / 4; idx < p.PL; idx += 8) {
        const int wi = wf + idx * p.sw;
        bf16* dst = dst0 + (size_t)idx * Cp + e;
        if (wi < 0 || wi >= p.W) {
          *reinterpret_cast<unsigned*>(dst) = 0u;
          continue;
        }
        const int d = lane % 4 == 0 ? de[0] : lane % 4 == 1 ? de[2]
                      : lane % 4 == 2 ? de[4] : de[6];
        cp_async4_zfill(dst,
                        d >= 0 ? src0 + (size_t)wi * p.C + d * dstride + e
                               : p.x,
                        d >= 0);
      }
      continue;
    }
    for (int idx = lane; idx < p.PL; idx += 32) {
      const int wi = wf + idx * p.sw;
      bf16* dst = dst0 + (size_t)idx * Cp;
      if (kind == UNIT_ZERO || wi < 0 || wi >= p.W) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
        continue;
      }
      const bf16* src = src0 + (size_t)wi * p.C;
      if (kind == UNIT_16) {
        cp_async16(dst, src + de[0] * dstride);
      } else {
        uint4 out;
        bf16* vals = reinterpret_cast<bf16*>(&out);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          vals[e] = de[e] >= 0
                        ? __float2bfloat16(norm_lrelu(
                              __bfloat162float(src[de[e] * dstride + e]),
                              tb.m[c0 + e], tb.o[c0 + e]))
                        : __float2bfloat16(0.0f);
        *reinterpret_cast<uint4*>(dst) = out;
      }
    }
  }
  cp_async_commit();
}

// The norm in place on the landed copies of tile `tl`: the 16-byte and
// pair units inside the image, channels with a source depth only; a warp
// per line (listed unit, staged row, plane), its norm in registers
__device__ __forceinline__ void normalise(const Params& p, const Table& tb,
                                          const Tile& tl, bf16* s_in,
                                          int warp, int lane) {
  const int nn = *tb.nnorm;
  const int lines = p.SR * p.sw;
  for (int l = warp; l < nn * lines; l += NWARPS) {
    const int j = l / lines, rp = l - j * lines;
    const int row = rp / p.sw, plane = rp - row * p.sw;
    const int hi = p.sh * tl.h0 + p.org_h + row;
    if ((hi < 0 || hi >= p.H) && !(hi == -1 && p.xt) &&
        !(hi == p.H && p.xb))
      continue;                         // zeros
    const int c0 = tb.normk[j] * 8;
    float m[8], o[8];
    bool on[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      m[e] = tb.m[c0 + e];
      o[e] = tb.o[c0 + e];
      on[e] = tb.dsrc[c0 + e] >= 0;
    }
    bf16* dst0 = s_in + (size_t)rp * p.PL * p.Cp + c0;
    const int wf = p.sw * tl.w0 + p.org_w + plane;
    for (int idx = lane; idx < p.PL; idx += 32) {
      const int wi = wf + idx * p.sw;
      if (wi < 0 || wi >= p.W) continue;
      uint4* ptr = reinterpret_cast<uint4*>(dst0 + (size_t)idx * p.Cp);
      uint4 val = *ptr;
      bf16* v = reinterpret_cast<bf16*>(&val);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (on[e])
          v[e] = __float2bfloat16(norm_lrelu(__bfloat162float(v[e]), m[e],
                                             o[e]));
      *ptr = val;
    }
  }
}

template <int NFW>
__global__ void __launch_bounds__(NTHREADS, 1) qstride_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int Cs = p.Cs, Cp = p.Cp, BN = p.BN, KC8 = Cs / 8;
  const int KS = p.KS, N8 = p.N8;

  bf16* s_w = reinterpret_cast<bf16*>(smem);
  // operand buffer b
  auto s_buf = [&](int b) {
    return reinterpret_cast<bf16*>(smem + p.off_in + b * p.in_stride);
  };
  float* s_st = reinterpret_cast<float*>(smem + p.off_st);
  const Table tb(smem, p);

  // ---- all taps' weights, packed, zero padding in K and CO (one cp.async
  // group with the first tile's copies)
  const bool vec_w =
      p.C % 8 == 0 && reinterpret_cast<uintptr_t>(p.w) % 16 == 0;
  for (int u = tid; u < 9 * BN * KC8; u += NTHREADS) {
    const int k8 = u % KC8, r = u / KC8;
    const int co = r % BN, t = r / BN, k0 = k8 * 8;
    bf16* dst = s_w + packed_index(t, co, k0, KS, N8);
    const bf16* src = p.w + ((size_t)t * p.CO + co) * p.C + k0;
    if (vec_w && co < p.CO && k0 < p.C) {
      cp_async16(dst, src);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = co < p.CO && k0 + e < p.C ? src[e] : __float2bfloat16(0.0f);
    }
  }
  for (int i = tid; i < BN * 2; i += NTHREADS) s_st[i] = 0.0f;

  // warp tile: row fragments wm, wm + WARPS_M; CO fragments wn*NFW ..
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int MF = p.TH * p.WF, NF = BN / 16;
  const int a_row = lane % 16, a_k = (lane / 16) * 8;
  const size_t plane_stride = (size_t)p.PL * Cp;
  const size_t row_stride = plane_stride * p.sw;
  bool fr_on[MPW], nf_on[NFW];
  int fr_r[MPW], fr_c[MPW];
#pragma unroll
  for (int f = 0; f < MPW; ++f) {
    const int mf = wm + f * WARPS_M;
    fr_on[f] = mf < MF;
    fr_r[f] = mf / p.WF;
    fr_c[f] = (mf % p.WF) * 16;
  }
#pragma unroll
  for (int j = 0; j < NFW; ++j) nf_on[j] = wn * NFW + j < NF;
  const unsigned w_base = (unsigned)__cvta_generic_to_shared(s_w) + lane * 16;

  // the first tile's copies (the grid holds no more blocks than tiles)
  int n_acc = -1;                      // the sample s_st sums
  int n_tab;                           // the sample of the table's norm
  {
    const Tile t0(p, blockIdx.x);
    prepare(p, tb, t0, true, tid);
    n_tab = t0.n;
    issue(p, tb, t0, s_buf(0), warp, lane);
  }
  int buf = 0;
  for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
    const Tile tl(p, tile);
    bf16* s_in = s_buf(buf);
    cp_async_wait_all();
    __syncthreads();                   // this tile's copies landed; the
                                       // last epilogue's atomics are done
    if (tl.n != n_acc) {               // flush the finished tiles' sample
      if (n_acc >= 0)
        for (int i = tid; i < p.CO * 2; i += NTHREADS) {
          atomicAdd(&p.stats[(size_t)n_acc * p.CO * 2 + i], s_st[i]);
          s_st[i] = 0.0f;
        }
      n_acc = tl.n;
    }
    normalise(p, tb, tl, s_in, warp, lane);
    __syncthreads();                   // normalised; the table is free
    const int next = tile + gridDim.x;
    if (p.nbuf == 2 && next < p.ntiles) {
      // the next tile's copies in flight during this tile's products
      const Tile tn(p, next);
      prepare(p, tb, tn, tn.n != n_tab, tid);
      n_tab = tn.n;
      issue(p, tb, tn, s_buf(buf ^ 1), warp, lane);
    }

    // ---- 9 taps x Cs/16 K-steps of m16n8k16 MMAs
    float acc[MPW][NFW][2][4];
#pragma unroll
    for (int f = 0; f < MPW; ++f)
#pragma unroll
      for (int j = 0; j < NFW; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[f][j][h][e] = 0.0f;
    if (fr_on[0] && nf_on[0]) {
      for (int t = 0; t < 9; ++t) {
        const int th = t / 3, tw = t % 3;
        const int plane = p.sw == 2 ? (tw & 1) : 0;
        const int dcol = p.sw == 2 ? (tw >> 1) : tw;
        unsigned a_addr[MPW];
#pragma unroll
        for (int f = 0; f < MPW; ++f)
          a_addr[f] = (unsigned)__cvta_generic_to_shared(
              s_in + (p.sh * fr_r[f] + th) * row_stride +
              plane * plane_stride +
              (size_t)(fr_c[f] + a_row + dcol) * Cp + a_k);
        for (int ks = 0; ks < KS; ++ks) {
          unsigned a[MPW][4], b[NFW][4];
#pragma unroll
          for (int f = 0; f < MPW; ++f)
            if (fr_on[f]) ldmatrix_x4(a[f], a_addr[f] + ks * 32);
          // two groups of 8 output channels (both K halves): 512 bytes
          const unsigned b_step =
              w_base + ((t * KS + ks) * N8 + wn * NFW * 2) * 256;
#pragma unroll
          for (int j = 0; j < NFW; ++j)
            if (nf_on[j]) ldmatrix_x4(b[j], b_step + j * 512);
#pragma unroll
          for (int j = 0; j < NFW; ++j)
#pragma unroll
            for (int f = 0; f < MPW; ++f)
              if (nf_on[j] && fr_on[f]) {
                mma_16816(acc[f][j][0], a[f], b[j][0], b[j][1]);
                mma_16816(acc[f][j][1], a[f], b[j][2], b[j][3]);
              }
        }
      }
    }

    // ---- epilogue: an n8 accumulator holds rows lane/4 and lane/4 + 8,
    // columns 2*(lane%4) + {0, 1}
    const bool pair_store = p.CO % 2 == 0;
#pragma unroll
    for (int j = 0; j < NFW; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int co = (wn * NFW + j) * 16 + h * 8 + (lane % 4) * 2;
        const float b0 = co < p.CO ? p.b[co] : 0.0f;
        const float b1 = co + 1 < p.CO ? p.b[co + 1] : 0.0f;
        float s1[2] = {0.0f, 0.0f}, s2[2] = {0.0f, 0.0f};
#pragma unroll
        for (int f = 0; f < MPW; ++f) {
          if (!(fr_on[f] && nf_on[j])) continue;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int ho = tl.h0 + fr_r[f];
            const int wo = tl.w0 + fr_c[f] + lane / 4 + half * 8;
            if (ho >= p.Ho || wo >= p.Wo) continue;
            const float v0 = acc[f][j][h][2 * half] + b0;
            const float v1 = acc[f][j][h][2 * half + 1] + b1;
            bf16* dst = p.y + ((((size_t)tl.n * p.Do + tl.dout) * p.Ho + ho) *
                                   p.Wo + wo) * p.CO + co;
            if (pair_store && co + 1 < p.CO) {
              *reinterpret_cast<__nv_bfloat162*>(dst) =
                  __floats2bfloat162_rn(v0, v1);
            } else {
              if (co < p.CO) dst[0] = __float2bfloat16(v0);
              if (co + 1 < p.CO) dst[1] = __float2bfloat16(v1);
            }
            s1[0] += v0;
            s2[0] += v0 * v0;
            s1[1] += v1;
            s2[1] += v1 * v1;
          }
        }
        // sum over the lanes holding the same columns (lane % 4)
#pragma unroll
        for (int sft = 4; sft < 32; sft *= 2)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            s1[e] += __shfl_xor_sync(0xffffffffu, s1[e], sft);
            s2[e] += __shfl_xor_sync(0xffffffffu, s2[e], sft);
          }
        if (lane < 4 && nf_on[j]) {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (co + e < p.CO) {
              atomicAdd(&s_st[(co + e) * 2], s1[e]);
              atomicAdd(&s_st[(co + e) * 2 + 1], s2[e]);
            }
        }
      }
    }
    if (p.nbuf == 1 && next < p.ntiles) {
      // one buffer: the next tile's copies after this tile's products
      __syncthreads();
      const Tile tn(p, next);
      prepare(p, tb, tn, tn.n != n_tab, tid);
      n_tab = tn.n;
      issue(p, tb, tn, s_in, warp, lane);
    }
    buf ^= p.nbuf - 1;
  }
  __syncthreads();
  if (n_acc >= 0)
    for (int i = tid; i < p.CO * 2; i += NTHREADS)
      atomicAdd(&p.stats[(size_t)n_acc * p.CO * 2 + i], s_st[i]);
}

// Plain C entry point (bound with ctypes). groups holds (c0, c1, shift)
// triples; w is (9, CO, C) bf16 with the taps already mirrored; b is f32.
// Returns a cudaError_t: the configuration check, cudaFuncSetAttribute, or
// cudaGetLastError() after the launch. Launches on `stream`; does not
// synchronise. xt / xb: an H slab's halo rows (Params), or null.
extern "C" int qstride_launch(const void* x, const void* mult,
                              const void* off, const int* groups,
                              int ngroups, const void* w, const void* b,
                              void* y, void* stats, int N, int D, int H,
                              int W, int C, int CO, int Do, int Ho, int Wo,
                              int sd, int sh, int sw, int parity, int org_h,
                              int org_w, const void* xt, const void* xb,
                              void* stream) {
  if (ngroups < 1 || ngroups > MAX_GROUPS || N < 1 || D < 1 || H < 1 ||
      W < 1 || C < 1 || CO < 1 || CO > 4 * WARPS_N * 16 || Do < 1 ||
      Ho < 1 || Wo < 1 || sd < 1 || sd > 2 || sh < 1 || sh > 2 || sw < 1 ||
      sw > 2)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const bf16*>(x);
  p.xt = static_cast<const bf16*>(xt);
  p.xb = static_cast<const bf16*>(xb);
  p.mult = static_cast<const float*>(mult);
  p.off = static_cast<const float*>(off);
  for (int g = 0; g < MAX_GROUPS; ++g) {
    const bool on = g < ngroups;
    p.g0[g] = on ? groups[3 * g] : 0;
    p.g1[g] = on ? groups[3 * g + 1] : 0;
    p.gs[g] = on ? groups[3 * g + 2] : 0;
  }
  p.ngroups = ngroups;
  p.w = static_cast<const bf16*>(w);
  p.b = static_cast<const float*>(b);
  p.y = static_cast<bf16*>(y);
  p.stats = static_cast<float*>(stats);
  p.N = N; p.D = D; p.H = H; p.W = W; p.C = C; p.CO = CO;
  p.Do = Do; p.Ho = Ho; p.Wo = Wo;
  p.sd = sd; p.sh = sh; p.sw = sw; p.parity = parity;
  p.org_h = org_h; p.org_w = org_w;
  p.Cs = (C + 15) / 16 * 16;
  p.Cp = p.Cs + 8;                   // an odd number of 16-byte units
  p.BN = (CO + 15) / 16 * 16;
  p.KS = p.Cs / 16;
  p.N8 = p.BN / 8;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t ha = reinterpret_cast<uintptr_t>(xt) |
                       reinterpret_cast<uintptr_t>(xb);
  p.vec16 = ((xa | ha) % 16 == 0 && C % 8 == 0);
  p.vec4 = ((xa | ha) % 4 == 0 && C % 2 == 0);
  // output tile: equal W tiles of at most 4 row fragments, then rows up to
  // WARPS_M * MPW fragments in all, as many as two operand buffers allow
  // (else one buffer)
  const int wf_all = (Wo + 15) / 16;
  p.n_wt = (wf_all + 3) / 4;
  p.WF = (wf_all + p.n_wt - 1) / p.n_wt;
  p.TW = 16 * p.WF;
  p.PL = p.TW + 2;
  const int th_max = min(Ho, (WARPS_M * MPW) / p.WF);
  const size_t w_bytes = (size_t)9 * p.BN * p.Cs * sizeof(bf16);
  p.off_in = (int)((w_bytes + 127) / 128 * 128);
  size_t smem = 0;
  bool fit = false;
  for (int nbuf = 2; nbuf >= 1 && !fit; --nbuf) {
    for (int th = th_max; th >= 1 && !fit; --th) {
      const int SR = sh * (th - 1) + 3;
      const size_t in_bytes = (size_t)SR * sw * p.PL * p.Cp * sizeof(bf16);
      p.in_stride = (int)((in_bytes + 127) / 128 * 128);
      p.off_tab = p.off_in + nbuf * p.in_stride;
      // table: source depth, mult, off per channel; kind and norm list per
      // unit; the list's length
      p.off_st = (p.off_tab + p.Cs * 12 + (p.Cs / 8) * 8 + 4 + 15) / 16 * 16;
      smem = (size_t)p.off_st + (size_t)p.BN * 2 * sizeof(float);
      if (smem <= SMEM_LIMIT) {
        fit = true;
        p.nbuf = nbuf;
        p.TH = th;
        p.SR = SR;
      }
    }
  }
  if (!fit) return (int)cudaErrorInvalidValue;
  p.n_ht = (Ho + p.TH - 1) / p.TH;
  const long long ntiles = (long long)N * Do * p.n_ht * p.n_wt;
  if (ntiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  p.ntiles = (int)ntiles;
  void (*kernel)(const Params) =
      p.BN <= 3 * WARPS_N * 16 ? qstride_kernel<3> : qstride_kernel<4>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int grid = p.ntiles < sms ? p.ntiles : sms;
  kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
