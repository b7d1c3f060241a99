// Depth-ring shift + (1,3,3) conv, and the ring shift alone, for NVIDIA
// Hopper (sm_90a), bfloat16.
//
// Replaces the Pallas TPU kernels of experiments/shift_conv_pallas.py:
//   shift_conv_ring_launch   `_kernel` / `_kernel_v2` (fused_shift_conv,
//                            fused_shift_conv_v2):
//                              y = conv_(1,3,3)(depth_shift(x)) + b
//                            x (N, D, H, W, C), f32 sums of bf16 products,
//                            the bias added in f32, y rounded once
//   depth_shift_ring_launch  `_kernel_shift_ring` (pallas_depth_shift):
//                            y = depth_shift(x), exact; its backward is the
//                            same kernel with the groups' shifts negated
// The channel groups are torch.chunk's (c0, c1, shift) ranges, any shift in
// [-2, 2]; a depth row the shift reads outside [0, D) is zero.
//
// What bounds them: bytes. At 1 x 128^3 x 48 -> 48 the fused kernel moves
// 201 MB in and 201 MB out (0.120 ms at 3.35 TB/s) against 87 GFLOP
// (0.088 ms at 989 TFLOP/s): nearly balanced, so the halo's re-reads and
// the operand's assembly count; the shift alone moves the same bytes.
//
// The question these kernels answer (shift_conv_pallas.py:24-47): does a
// depth ring, which reads each input row from device memory once, beat
// restaging the operand from device memory for every output depth (#1's
// way)?
//
// The fused kernel has two routes, chosen by one rule by shape
// (shift_conv_ring_route, the one place it lives):
//
//  * TMA (shift_conv_tma_kernel) where C % 8 == 0 (a tensor map's strides
//    and inner box bytes are multiples of 16), every group edge is even,
//    CO <= 48 and CO % 8 == 0 (one n48 tile; y's strides), C <= 64, x and
//    y are 16-byte aligned and the ring fits shared memory. Persistent
//    blocks, one per SM, each take a contiguous range of the (n, 8 x 16
//    tile of H x W, depth) items, cut into runs of consecutive depths of
//    one tile. A loader warp starts one cp.async.bulk.tensor per depth
//    slice and run: the box (16 KS + 8 channels, 18 columns, 10 rows) from
//    (0, w0 - 1, h0 - 1, r, n), into a ring of 6-8 slots handed over on
//    full/empty mbarriers. TMA's zero fill gives the H/W halo, the depth
//    rows r < 0 and r >= D and the channels from C to 16 KS + 8, with no
//    branch; the 8 channels past the K steps pad the pixel pitch to 4 mod
//    8 words, so the 8 pixels of an A load fall in distinct banks. Two
//    consumer warpgroups each own one m64 tile (4 rows x 16 columns) and
//    run 9 taps x KS steps of wgmma.m64n48k16 per depth, straight-line, one
//    commit group per tap, B the packed weights (resident, one bulk copy
//    per block), A built in registers: each 32-bit A register is one
//    channel pair of one pixel, and with every group edge even a pair lies
//    in one group, so the shift only picks the ring slot it is read from,
//    by one 32-bit shared load at a tap offset of whole pixels. The pairs'
//    slot offsets depend on the K step and lane % 4 only, and rotate by
//    one slot per depth in registers. The epilogue adds the bias in
//    float32, rounds once, and each warp stages its image row and writes
//    it by one TMA store, which clips the ragged H/W edges (a warp's own
//    row: no barrier beyond the warp).
//  * cp.async (shift_conv_ring_kernel), the first design, for every other
//    shape: a block owns an (n, 8-row x 16-column tile of H x W, CO tile of
//    up to 48) and walks depth with a 5-slot ring of the tile's input
//    slices plus halo, copying slice d+3 with cp.async while the tensor
//    cores work on d; per depth it assembles the shifted, zero-haloed
//    operand from the ring (8-channel units of one shift as 16-byte words,
//    mixed units channel by channel), then each warp computes one image
//    row of 16 pixels with ldmatrix + mma.sync.m16n8k16 and stores y
//    straight from its registers.
//
// The shift alone: a block owns 64 consecutive pixels of the H x W plane of
// one n and walks depth with an 8-slot ring, three slices in flight ahead of
// the one it writes; 8-channel units of one shift are copied as 16-byte
// words.

#include "shift_conv_block.cuh"
#include "tma.cuh"

#define RING_THREADS 256               // 8 warps, one image row each
#define RING_SLOTS 5
#define RING_TW 16                     // tile width: one 16-pixel fragment
#define RING_NFW 3                     // CO fragments of 16 per block
#define SH_THREADS 128
#define SH_SLOTS 8
#define SH_AHEAD 3                     // slices in flight beyond d + 2
#define SH_PIX 64
#define NO_SHIFT (-1000)               // a channel beyond C
#define MIXED (-2000)                  // a unit copied channel by channel

struct RingParams {
  const bf16* x;                       // (N, D, H, W, C)
  const bf16* w;                       // (9, CO, C), tap = 3*(dh+1) + (dw+1)
  const bf16* b;                       // (CO)
  bf16* y;                             // (N, D, H, W, CO) or (N, D, H, W, C)
  int N, D, H, W, C, CO;
  int g0[MAX_GROUPS], g1[MAX_GROUPS], gs[MAX_GROUPS];
  int ngroups;
  int vec;                             // C % 8 == 0 and x, y 16-byte aligned
  int Cr;                              // ring pixel stride: C rounded to 8
  int Cs, Cp;                          // operand: C rounded to 16; row stride
  int TH;                              // image rows per block
  int off_op, off_w, off_tab;          // shared-memory offsets (bytes)
};

__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the shift table: s_cs[c] the shift of channel c (NO_SHIFT at or beyond
// C); s_us[k] the shift of 8-channel unit k where all 8 share it and the
// 16-byte path applies, else MIXED
__device__ __forceinline__ void shift_tables(const RingParams& p, int nc,
                                             int* s_cs, int* s_us, int tid,
                                             int nthreads) {
  for (int c = tid; c < nc; c += nthreads) {
    int s = NO_SHIFT;
    if (c < p.C) {
      s = 0;
      for (int g = 0; g < p.ngroups; ++g)
        if (c >= p.g0[g] && c < p.g1[g]) s = p.gs[g];
    }
    s_cs[c] = s;
  }
  __syncthreads();
  for (int k = tid; k < nc / 8; k += nthreads) {
    int s = s_cs[8 * k];
    for (int e = 1; e < 8; ++e)
      if (s_cs[8 * k + e] != s) s = MIXED;
    s_us[k] = (p.vec && s != NO_SHIFT) ? s : MIXED;
  }
  __syncthreads();
}

// the 8 values of unit k of one pixel of the shifted slice d: rows r of the
// ring at ring + slot(r) * slot_elems + pix * Cr
__device__ __forceinline__ uint4 shifted_unit(const RingParams& p,
                                              const bf16* ring, int nslots,
                                              size_t slot_elems, int pix,
                                              int k, int d, const int* s_cs,
                                              const int* s_us) {
  const int us = s_us[k];
  if (us != MIXED) {
    const int r = d - us;
    if (r < 0 || r >= p.D) return make_uint4(0u, 0u, 0u, 0u);
    return *reinterpret_cast<const uint4*>(
        ring + (r % nslots) * slot_elems + (size_t)pix * p.Cr + 8 * k);
  }
  uint4 out;
  bf16* v = reinterpret_cast<bf16*>(&out);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int c = 8 * k + e;
    const int s = s_cs[c];
    const int r = d - s;
    v[e] = (s != NO_SHIFT && r >= 0 && r < p.D)
               ? ring[(r % nslots) * slot_elems + (size_t)pix * p.Cr + c]
               : __float2bfloat16(0.0f);
  }
  return out;
}

// ---------------------------------------------------------------- fused
__global__ void __launch_bounds__(RING_THREADS)
shift_conv_ring_kernel(const RingParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n_wt = (p.W + RING_TW - 1) / RING_TW;
  const int n_ht = (p.H + p.TH - 1) / p.TH;
  int bid = blockIdx.x;
  const int wt = bid % n_wt;
  bid /= n_wt;
  const int ht = bid % n_ht;
  const int n = bid / n_ht;
  const int h0 = ht * p.TH, w0 = wt * RING_TW;
  constexpr int BN = RING_NFW * 16;
  const int co0 = blockIdx.y * BN;
  const int ncol = min(BN, p.CO - co0);
  const int RW = RING_TW + 2, npix = (p.TH + 2) * RW;
  const int Cp = p.Cp;
  const size_t slot_elems = (size_t)npix * p.Cr;
  bf16* s_ring = reinterpret_cast<bf16*>(smem);
  bf16* s_op = reinterpret_cast<bf16*>(smem + p.off_op);
  bf16* s_w = reinterpret_cast<bf16*>(smem + p.off_w);
  int* s_cs = reinterpret_cast<int*>(smem + p.off_tab);
  int* s_us = s_cs + p.Cs;

  // depth row r of the tile and its halo into slot r % RING_SLOTS; pixels
  // outside the image are zero
  auto load_row = [&](int r) {
    bf16* dst = s_ring + (r % RING_SLOTS) * slot_elems;
    const bf16* src = p.x + ((size_t)n * p.D + r) * p.H * p.W * p.C;
    if (p.vec) {
      const int upp = p.C / 8;
      for (int i = tid; i < npix * upp; i += RING_THREADS) {
        const int pix = i / upp, u = i % upp;
        const int hh = h0 - 1 + pix / RW, ww = w0 - 1 + pix % RW;
        const bool ok = hh >= 0 && hh < p.H && ww >= 0 && ww < p.W;
        cp_async16_zfill(dst + (size_t)pix * p.Cr + 8 * u,
                         ok ? src + ((size_t)hh * p.W + ww) * p.C + 8 * u
                            : p.x,
                         ok);
      }
    } else {
      for (int i = tid; i < npix * p.C; i += RING_THREADS) {
        const int pix = i / p.C, c = i % p.C;
        const int hh = h0 - 1 + pix / RW, ww = w0 - 1 + pix % RW;
        const bool ok = hh >= 0 && hh < p.H && ww >= 0 && ww < p.W;
        dst[(size_t)pix * p.Cr + c] =
            ok ? src[((size_t)hh * p.W + ww) * p.C + c]
               : __float2bfloat16(0.0f);
      }
    }
    cp_async_commit();
  };

  // ---- slices 0..2 in flight; the tables; all 9 taps' weights, zero
  // beyond C and ncol
  for (int r = 0; r < 3 && r < p.D; ++r) load_row(r);
  shift_tables(p, p.Cs, s_cs, s_us, tid, RING_THREADS);
  for (int i = tid; i < 9 * BN * Cp; i += RING_THREADS) {
    const int t = i / (BN * Cp), j = (i / Cp) % BN, c = i % Cp;
    s_w[i] = (j < ncol && c < p.C)
                 ? p.w[((size_t)t * p.CO + co0 + j) * p.C + c]
                 : __float2bfloat16(0.0f);
  }

  const int nf = (ncol + 15) / 16;
  const bool active = warp < p.TH && h0 + warp < p.H;
  const int a_row = lane % 16, a_k = (lane / 16) * 8;
  const int b_row = lane % 8 + (lane / 16) * 8, b_k = ((lane / 8) % 2) * 8;
  float bias[RING_NFW][2][2];
#pragma unroll
  for (int j = 0; j < RING_NFW; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int co = j * 16 + h * 8 + (lane % 4) * 2 + e;
        bias[j][h][e] = co < ncol ? __bfloat162float(p.b[co0 + co]) : 0.0f;
      }

  for (int d = 0; d < p.D; ++d) {
    cp_async_wait_all();               // slice d+2 landed
    __syncthreads();
    // ---- assemble the shifted, zero-haloed operand of depth d
    const int KU = p.Cs / 8;
    for (int i = tid; i < npix * KU; i += RING_THREADS) {
      const int pix = i / KU, k = i % KU;
      *reinterpret_cast<uint4*>(s_op + (size_t)pix * Cp + 8 * k) =
          shifted_unit(p, s_ring, RING_SLOTS, slot_elems, pix, k, d, s_cs,
                       s_us);
    }
    __syncthreads();                   // slot of d-2 free
    if (d + 3 < p.D) load_row(d + 3);

    // ---- 9 taps x Cs/16 k steps
    float acc[RING_NFW][2][4];
#pragma unroll
    for (int j = 0; j < RING_NFW; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][h][e] = 0.0f;
    if (active) {
      for (int t = 0; t < 9; ++t) {
        const int dh = t / 3 - 1, dw = t % 3 - 1;
        const unsigned a_addr = (unsigned)__cvta_generic_to_shared(
            s_op + ((size_t)(warp + 1 + dh) * RW + 1 + dw + a_row) * Cp +
            a_k);
        const unsigned b_addr = (unsigned)__cvta_generic_to_shared(
            s_w + ((size_t)t * BN + b_row) * Cp + b_k);
        for (int kc = 0; kc < p.Cs; kc += 16) {
          unsigned a[4], b[RING_NFW][4];
          ldmatrix_x4(a, a_addr + kc * 2);
#pragma unroll
          for (int j = 0; j < RING_NFW; ++j)
            if (j < nf) ldmatrix_x4(b[j], b_addr + (j * 16 * Cp + kc) * 2);
#pragma unroll
          for (int j = 0; j < RING_NFW; ++j)
            if (j < nf) {
              mma_16816(acc[j][0], a, b[j][0], b[j][1]);
              mma_16816(acc[j][1], a, b[j][2], b[j][3]);
            }
        }
      }
      // ---- y from the registers: pixels lane/4 and lane/4 + 8 of the row,
      // channels 2*(lane%4) + 0, 1 of each n8 accumulator
      const int hh = h0 + warp;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int ww = w0 + lane / 4 + 8 * q;
        if (ww >= p.W) continue;
        bf16* yp = p.y + ((((size_t)n * p.D + d) * p.H + hh) * p.W + ww) *
                             p.CO + co0;
#pragma unroll
        for (int j = 0; j < RING_NFW; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int co = j * 16 + h * 8 + (lane % 4) * 2;
            const float v0 = acc[j][h][2 * q] + bias[j][h][0];
            const float v1 = acc[j][h][2 * q + 1] + bias[j][h][1];
            if (co + 1 < ncol && p.CO % 2 == 0) {
              *reinterpret_cast<__nv_bfloat162*>(yp + co) =
                  __floats2bfloat162_rn(v0, v1);
            } else {
              if (co < ncol) yp[co] = __float2bfloat16(v0);
              if (co + 1 < ncol) yp[co + 1] = __float2bfloat16(v1);
            }
          }
      }
    }
  }
}

// ---------------------------------------------------------------- shift
__global__ void __launch_bounds__(SH_THREADS)
depth_shift_ring_kernel(const RingParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int HW = p.H * p.W;
  const int n_pt = (HW + SH_PIX - 1) / SH_PIX;
  const int n = blockIdx.x / n_pt;
  const int p0 = (blockIdx.x % n_pt) * SH_PIX;
  const int np = min(SH_PIX, HW - p0);
  const size_t slot_elems = (size_t)SH_PIX * p.Cr;
  bf16* s_ring = reinterpret_cast<bf16*>(smem);
  int* s_cs = reinterpret_cast<int*>(smem + p.off_tab);
  int* s_us = s_cs + p.Cr;

  // depth row r's np pixels into slot r % SH_SLOTS, one commit group
  auto load_row = [&](int r) {
    if (r < p.D) {
      bf16* dst = s_ring + (r % SH_SLOTS) * slot_elems;
      const bf16* src = p.x + (((size_t)n * p.D + r) * HW + p0) * p.C;
      if (p.vec) {
        const int upp = p.C / 8;
        for (int i = tid; i < np * upp; i += SH_THREADS)
          cp_async16(dst + (size_t)(i / upp) * p.Cr + 8 * (i % upp),
                     src + (size_t)8 * i);
      } else {
        for (int i = tid; i < np * p.C; i += SH_THREADS)
          dst[(size_t)(i / p.C) * p.Cr + i % p.C] = src[i];
      }
    }
    cp_async_commit();
  };

  for (int r = 0; r < 2 + SH_AHEAD; ++r) load_row(r);
  shift_tables(p, p.Cr, s_cs, s_us, tid, SH_THREADS);
  const int KU = p.Cr / 8;
  for (int d = 0; d < p.D; ++d) {
    load_row(d + 2 + SH_AHEAD);        // into the slot of d - 3
    cp_async_wait<SH_AHEAD>();         // slices up to d + 2 landed
    __syncthreads();
    bf16* yp = p.y + (((size_t)n * p.D + d) * HW + p0) * p.C;
    for (int i = tid; i < np * KU; i += SH_THREADS) {
      const int pix = i / KU, k = i % KU;
      const uint4 v = shifted_unit(p, s_ring, SH_SLOTS, slot_elems, pix, k,
                                   d, s_cs, s_us);
      if (p.vec) {
        *reinterpret_cast<uint4*>(yp + (size_t)pix * p.C + 8 * k) = v;
      } else {
        const bf16* vals = reinterpret_cast<const bf16*>(&v);
        for (int e = 0; e < 8 && 8 * k + e < p.C; ++e)
          yp[(size_t)pix * p.C + 8 * k + e] = vals[e];
      }
    }
    __syncthreads();                   // the slot of d - 2 is reloaded next
  }
}

// ---------------------------------------------------------------- TMA route
#define TR_TH 8                        // tile rows: two m64 tiles of 4 x 16
#define TR_TW 16                       // tile columns
#define TR_RW (TR_TW + 2)              // staged columns, the halo included
#define TR_PIX ((TR_TH + 2) * TR_RW)   // staged pixels of one depth slice
#define TR_NCO 48                      // output channels: one n48 tile
#define TR_N8 (TR_NCO / 8)
#define TR_KSMAX 4                     // 16-channel K steps: C <= 64
#define TR_THREADS 288                 // two consumer warpgroups, a loader
#define TR_SLOTS_MIN 6                 // the 5-slice window, one in flight
#define TR_SLOTS_MAX 8

struct TmaRingParams {
  const bf16* b;                       // (CO)
  const bf16* wpk;                     // packed weights, w_bytes
  int D, H, C, CO;
  int g0[MAX_GROUPS], g1[MAX_GROUPS], gs[MAX_GROUPS];
  int ngroups;
  int n_ht, n_wt;
  int total;                           // (n, tile, depth) items
  int slots, slot_bytes, w_bytes;
  int off_w, off_out, off_bar;         // shared-memory offsets (bytes)
};

// one 32-bit shared-memory load (a channel pair of one pixel)
__device__ __forceinline__ unsigned lds32(const unsigned char* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// a run of consecutive depths [d0, d1) of one tile, from item u of a
// block's range [u, u1) (items: depth innermost, then column tiles, row
// tiles, n)
struct TrRun {
  int n, h0, w0, d0, d1;
  __device__ TrRun(const TmaRingParams& p, int u, int u1) {
    const int tile = u / p.D;
    d0 = u - tile * p.D;
    d1 = min(p.D, d0 + (u1 - u));
    w0 = (tile % p.n_wt) * TR_TW;
    const int rest = tile / p.n_wt;
    h0 = (rest % p.n_ht) * TR_TH;
    n = rest / p.n_ht;
  }
};

// KS: 16-channel K steps (C <= 16 KS); a staged pixel holds 16 KS + 8
// channels
template <int KS>
__global__ void __launch_bounds__(TR_THREADS, 1)
shift_conv_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap ymap,
                      const TmaRingParams p) {
  constexpr int PITCH = 2 * (16 * KS + 8);   // bytes of a staged pixel
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const unsigned S = p.slots;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.off_bar);
  uint64_t* empty = full + S;
  uint64_t* wbar = empty + S;
  if (tid == 0) {
    for (unsigned s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);         // the consumer warps
    }
    mbar_init(wbar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  // this block's items: a contiguous range
  const int u0 = (int)((long long)blockIdx.x * p.total / gridDim.x);
  const int u1 = (int)((long long)(blockIdx.x + 1) * p.total / gridDim.x);

  if (warp == 8) {
    // ---- the loader: one thread starts every copy. Copy L of the block
    // (its runs in order, each the depth rows d0 - 2 .. d1 + 1) goes to
    // slot L % S.
    if (lane != 0) return;
    mbar_expect(wbar, p.w_bytes);
    bulk_load(smem + p.off_w, p.wpk, p.w_bytes, wbar);
    unsigned L = 0;
    for (int u = u0; u < u1;) {
      const TrRun a(p, u, u1);
      for (int r = a.d0 - 2; r < a.d1 + 2; ++r, ++L) {
        const unsigned s = L % S;
        mbar_wait(empty + s, ((L / S) & 1) ^ 1);   // the slot released
        mbar_expect(full + s, TR_PIX * PITCH);
        tma_load_5d(smem + s * p.slot_bytes, &xmap, 0, a.w0 - 1, a.h0 - 1, r,
                    a.n, full + s);
      }
      u += a.d1 - a.d0;
    }
    return;
  }

  // ---- the consumer warpgroups: warpgroup w / 4 runs the m64 tile of
  // rows 4 (w / 4) .. 4 (w / 4) + 3 of the tile, warp w its row w; lane
  // (g, q) holds the A rows of pixels g and g + 8 and channel pairs 2q
  // (+ 8) of each K step, and the sums of output channels 8 j + 2 q, + 1
  const int row = warp, q = lane % 4, g = lane / 4;
  const unsigned char* pix =
      smem + ((row + 1) * TR_RW + g + 1) * PITCH + 4 * q;
  // the shift of each of the thread's pairs (channels 16 ks + 8 h + 2 q,
  // + 1): every group edge is even, so a pair lies in one group; pairs
  // past C read TMA's zero fill, in any slot
  int psh[KS][2];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 16 * ks + 8 * h + 2 * q;
      int s = 0;
      for (int gi = 0; gi < p.ngroups; ++gi)
        if (c >= p.g0[gi] && c < p.g1[gi]) s = p.gs[gi];
      psh[ks][h] = s;
    }
  float bias[2 * TR_N8];
#pragma unroll
  for (int i = 0; i < 2 * TR_N8; ++i) {
    const int co = 8 * (i / 2) + 2 * q + i % 2;
    bias[i] = co < p.CO ? __bfloat162float(p.b[co]) : 0.0f;
  }
  unsigned char* out = smem + p.off_out + row * TR_TW * p.CO * 2;
  const unsigned char* wsm = smem + p.off_w;
  const unsigned ring_bytes = S * p.slot_bytes;
  mbar_wait(wbar, 0);
  unsigned L0 = 0;                     // the run's first copy
  for (int u = u0; u < u1;) {
    const TrRun a(p, u, u1);
    const int nd = a.d1 - a.d0;
    // depth d0 + i reads window position 2 - shift, copy L0 + i + 2 -
    // shift: each pair's slot offset, rotated by one slot per depth
    unsigned sl[KS][2];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        sl[ks][h] = ((L0 + 2 - psh[ks][h]) % S) * p.slot_bytes;
    for (unsigned j = L0; j < L0 + 4; ++j)
      mbar_wait(full + j % S, (j / S) & 1);
    for (int i = 0; i < nd; ++i) {
      const unsigned lw = L0 + i + 4;  // the window's newest slice
      mbar_wait(full + lw % S, (lw / S) & 1);
      const unsigned char* at[KS][2];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          at[ks][h] = pix + sl[ks][h] + 32 * ks + 16 * h;
      float acc[4 * TR_N8];
#pragma unroll
      for (int e = 0; e < 4 * TR_N8; ++e) acc[e] = 0.0f;
// A of tap T_ into ab[B_]: for each K step, pixels g, g + 8 at the tap's
// offset of whole pixels, pairs 2q and 2q + 8 of the step
#define TR_LOAD_A(B_, T_)                                                   \
  {                                                                         \
    const int off_ = (((T_) / 3 - 1) * TR_RW + (T_) % 3 - 1) * PITCH;       \
    _Pragma("unroll") for (int ks = 0; ks < KS; ++ks) {                     \
      ab[B_][ks][0] = lds32(at[ks][0] + off_);                              \
      ab[B_][ks][1] = lds32(at[ks][0] + off_ + 8 * PITCH);                  \
      ab[B_][ks][2] = lds32(at[ks][1] + off_);                              \
      ab[B_][ks][3] = lds32(at[ks][1] + off_ + 8 * PITCH);                  \
    }                                                                       \
  }
      // 9 taps of KS m64n48k16 steps each, straight-line, one commit group
      // per tap; A in three register buffers of a tap: the next tap's loads
      // while two taps may be in flight
      unsigned ab[3][KS][4];
      TR_LOAD_A(0, 0);
#pragma unroll
      for (int e = 0; e < 4 * TR_N8; ++e)
        asm volatile("" : "+f"(acc[e])::"memory");
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          WgmmaRS<TR_N8>::mma(acc, ab[t % 3][ks],
                              wgmma_desc(wsm + (t * KS + ks) * TR_N8 * 256));
        wgmma_commit();
        if (t + 1 < 9) TR_LOAD_A((t + 1) % 3, t + 1);
        wgmma_wait<1>();               // tap t - 1 done: its A free
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) keep_live(ab[(t + 2) % 3][ks]);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int b = 0; b < 3; ++b)
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) keep_live(ab[b][ks]);
#pragma unroll
      for (int e = 0; e < 4 * TR_N8; ++e)
        asm volatile("" : "+f"(acc[e])::"memory");
#undef TR_LOAD_A
      // the window's oldest slice is read for the last time
      if (lane == 0) mbar_arrive(empty + (L0 + i) % S);

      // ---- epilogue: bias, one rounding, the warp's image row (16 x CO)
      // staged and sent by one TMA store, which drops what lies outside y;
      // the warp's own row, so no barrier beyond the warp
      if (lane == 0) bulk_wait_read<0>();    // the last store read the row
      __syncwarp();
#pragma unroll
      for (int j = 0; j < TR_N8; ++j) {
        const int co = 8 * j + 2 * q;
        if (co < p.CO) {               // CO % 8 == 0: co + 1 too
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            *reinterpret_cast<__nv_bfloat162*>(
                out + ((g + 8 * hh) * p.CO + co) * 2) =
                __floats2bfloat162_rn(
                    acc[4 * j + 2 * hh] + bias[2 * j],
                    acc[4 * j + 2 * hh + 1] + bias[2 * j + 1]);
        }
      }
      fence_proxy_async();             // for the TMA store
      __syncwarp();
      if (lane == 0 && row < p.H - a.h0) {
        tma_store_5d(&ymap, out, 0, a.w0, a.h0 + row, a.d0 + i, a.n);
        bulk_commit();
      }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sl[ks][h] += p.slot_bytes;
          if (sl[ks][h] >= ring_bytes) sl[ks][h] -= ring_bytes;
        }
    }
    // the run's last four slices
    if (lane == 0)
      for (unsigned j = L0 + nd; j < L0 + nd + 4; ++j)
        mbar_arrive(empty + j % S);
    L0 += nd + 4;
    u += nd;
  }
  if (lane == 0) bulk_wait_all();      // the stores done before exit
}

// The TMA route's ring (the most slots from TR_SLOTS_MAX down to
// TR_SLOTS_MIN that fit) and shared-memory layout for p.C and p.CO, or
// false where TR_SLOTS_MIN do not fit
static bool tr_layout(TmaRingParams& p) {
  const int KS = (p.C + 15) / 16;
  p.slot_bytes = (TR_PIX * 2 * (16 * KS + 8) + 127) / 128 * 128;
  p.w_bytes = 9 * KS * TR_N8 * 256;
  const int out = TR_TH * TR_TW * p.CO * 2;   // one row per warp
  for (int s = TR_SLOTS_MAX; s >= TR_SLOTS_MIN; --s) {
    const size_t total = 128 + (size_t)s * p.slot_bytes + p.w_bytes + out +
                         8 * (2 * s + 1);
    if (total > SMEM_LIMIT) continue;
    p.slots = s;
    p.off_w = s * p.slot_bytes;
    p.off_out = p.off_w + p.w_bytes;
    p.off_bar = p.off_out + out;
    return true;
  }
  return false;
}

static int launch_shift_conv_tma(const void* x, const void* wpk,
                                 const void* b, void* y, const int* groups,
                                 int ngroups, int N, int D, int H, int W,
                                 int C, int CO, cudaStream_t stream) {
  if (wpk == nullptr || (uintptr_t)wpk % 16)
    return (int)cudaErrorInvalidValue;
  TmaRingParams p;
  p.b = static_cast<const bf16*>(b);
  p.wpk = static_cast<const bf16*>(wpk);
  p.D = D; p.H = H; p.C = C; p.CO = CO;
  for (int g = 0; g < MAX_GROUPS; ++g) {
    const bool on = g < ngroups;
    p.g0[g] = on ? groups[3 * g] : 0;
    p.g1[g] = on ? groups[3 * g + 1] : 0;
    p.gs[g] = on ? groups[3 * g + 2] : 0;
  }
  p.ngroups = ngroups;
  p.n_ht = (H + TR_TH - 1) / TR_TH;
  p.n_wt = (W + TR_TW - 1) / TR_TW;
  p.total = (int)((long long)N * p.n_ht * p.n_wt * D);
  if (!tr_layout(p)) return (int)cudaErrorInvalidValue;
  const int KS = (C + 15) / 16;
  // x over (C, W, H, D, N) in boxes of (16 KS + 8, 18, 10, 1, 1): a box
  // lands as [row][column][channel], zero outside x
  CUtensorMap xmap, ymap;
  const uint64_t px = 2ull * C, py = 2ull * CO;
  const uint64_t xdims[5] = {(uint64_t)C, (uint64_t)W, (uint64_t)H,
                             (uint64_t)D, (uint64_t)N};
  const uint64_t xstr[4] = {px, px * W, px * W * H, px * W * H * D};
  const int xbox[5] = {16 * KS + 8, TR_RW, TR_TH + 2, 1, 1};
  int err = tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, x, xdims,
                       xstr, xbox, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err) return err;
  // y over (CO, W, H, D, N) in boxes of one warp's row of 16 pixels
  const uint64_t ydims[5] = {(uint64_t)CO, (uint64_t)W, (uint64_t)H,
                             (uint64_t)D, (uint64_t)N};
  const uint64_t ystr[4] = {py, py * W, py * W * H, py * W * H * D};
  const int ybox[5] = {CO, TR_TW, 1, 1, 1};
  err = tensor_map(&ymap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, y, ydims, ystr,
                   ybox, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err) return err;
  typedef void (*Kernel)(const CUtensorMap, const CUtensorMap,
                         const TmaRingParams);
  static const Kernel kernels[TR_KSMAX] = {
      shift_conv_tma_kernel<1>, shift_conv_tma_kernel<2>,
      shift_conv_tma_kernel<3>, shift_conv_tma_kernel<4>};
  const Kernel kernel = kernels[KS - 1];
  const size_t smem = 128 + (size_t)p.off_bar + 8 * (2 * p.slots + 1);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int grid = p.total < sms ? p.total : sms;
  kernel<<<grid, TR_THREADS, smem, stream>>>(xmap, ymap, p);
  return (int)cudaGetLastError();
}

static bool ring_params(RingParams& p, const void* x, const void* y,
                        const int* groups, int ngroups, int N, int D, int H,
                        int W, int C) {
  if (N < 1 || D < 1 || H < 1 || W < 1 || C < 1 || ngroups < 1 ||
      ngroups > MAX_GROUPS)
    return false;
  p.x = static_cast<const bf16*>(x);
  p.y = static_cast<bf16*>(const_cast<void*>(y));
  p.N = N; p.D = D; p.H = H; p.W = W; p.C = C;
  for (int g = 0; g < MAX_GROUPS; ++g) {
    const bool on = g < ngroups;
    p.g0[g] = on ? groups[3 * g] : 0;
    p.g1[g] = on ? groups[3 * g + 1] : 0;
    p.gs[g] = on ? groups[3 * g + 2] : 0;
    if (on && (p.gs[g] < -2 || p.gs[g] > 2)) return false;  // 5-row window
  }
  p.ngroups = ngroups;
  p.vec = C % 8 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0;
  p.Cr = (C + 7) / 8 * 8;
  p.Cs = (C + 15) / 16 * 16;
  return true;
}

// Plain C entry points (bound with ctypes); groups holds (c0, c1, shift)
// triples, shifts in [-2, 2]. Each returns a cudaError_t: the configuration
// check, cudaFuncSetAttribute, or cudaGetLastError() after the launch.
// Launches on `stream`; does not synchronise.

// The route of the fused kernel, the one place the rule lives: 1 (TMA)
// where tensor maps describe x (N, D, H, W, C) and y (N, D, H, W, CO)
// (16-byte-aligned tensors, C % 8 == 0 and CO % 8 == 0 for 16-byte
// strides), every group edge is even (a channel pair lies in one group),
// CO <= 48 (one n48 tile), C <= 64 and the ring fits shared memory; else 0
// (cp.async, the first design)
extern "C" int shift_conv_ring_route(const void* x, const void* y,
                                     const int* groups, int ngroups, int N,
                                     int D, int H, int W, int C, int CO) {
  if (N < 1 || D < 1 || H < 1 || W < 1 || C < 1 || CO < 1 || ngroups < 1 ||
      ngroups > MAX_GROUPS)
    return 0;
  if ((uintptr_t)x % 16 || (uintptr_t)y % 16 || C % 8 || CO % 8 ||
      CO > TR_NCO || C > 16 * TR_KSMAX)
    return 0;
  for (int g = 0; g < ngroups; ++g)
    if (groups[3 * g] % 2 || groups[3 * g + 1] % 2) return 0;
  const long long total = (long long)N * ((H + TR_TH - 1) / TR_TH) *
                          ((W + TR_TW - 1) / TR_TW) * D;
  if (total > 2147483647LL) return 0;
  TmaRingParams p;
  p.C = C;
  p.CO = CO;
  return tr_layout(p) ? 1 : 0;
}

// y (N, D, H, W, CO) = conv_(1,3,3)(depth_shift(x)) + b; w (9, CO, C) for
// the cp.async route, wpk the packed weights of the TMA route (9 *
// ceil(C / 16) * 6 * 256 bytes: per tap the channels in 16-channel steps
// by wgmma_b_index over 6 groups of 8 output channels, zero past CO and
// C); the other pointer may be null. tma: the TMA route, refused (an
// error) where shift_conv_ring_route gives 0; else the cp.async route,
// any shape.
extern "C" int shift_conv_ring_launch(const void* x, const void* w,
                                      const void* wpk, const void* b,
                                      void* y, const int* groups,
                                      int ngroups, int N, int D, int H,
                                      int W, int C, int CO, int tma,
                                      void* stream) {
  RingParams p;
  if (!ring_params(p, x, y, groups, ngroups, N, D, H, W, C) || CO < 1)
    return (int)cudaErrorInvalidValue;
  if (tma) {
    if (!shift_conv_ring_route(x, y, groups, ngroups, N, D, H, W, C, CO))
      return (int)cudaErrorInvalidValue;
    return launch_shift_conv_tma(x, wpk, b, y, groups, ngroups, N, D, H, W,
                                 C, CO, static_cast<cudaStream_t>(stream));
  }
  if (w == nullptr) return (int)cudaErrorInvalidValue;
  p.w = static_cast<const bf16*>(w);
  p.b = static_cast<const bf16*>(b);
  p.CO = CO;
  constexpr int BN = RING_NFW * 16;
  size_t smem = 0;
  p.TH = 0;
  for (int th = RING_THREADS / 32; th >= 1 && !p.TH; th /= 2) {
    for (int cp : {p.Cs + 8, p.Cs}) {
      const size_t npix = (size_t)(th + 2) * (RING_TW + 2);
      const size_t ring = (RING_SLOTS * npix * p.Cr * 2 + 127) / 128 * 128;
      const size_t op = (npix * cp * 2 + 127) / 128 * 128;
      const size_t wb = ((size_t)9 * BN * cp * 2 + 127) / 128 * 128;
      const size_t tab = (size_t)(p.Cs + p.Cs / 8) * 4;
      if (ring + op + wb + tab <= SMEM_LIMIT) {
        p.TH = th;
        p.Cp = cp;
        p.off_op = (int)ring;
        p.off_w = (int)(ring + op);
        p.off_tab = (int)(ring + op + wb);
        smem = ring + op + wb + tab;
        break;
      }
    }
  }
  if (p.TH == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      shift_conv_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long n_blocks = (long long)N * ((H + p.TH - 1) / p.TH) *
                             ((W + RING_TW - 1) / RING_TW);
  if (n_blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)n_blocks, (CO + BN - 1) / BN);
  shift_conv_ring_kernel<<<grid, RING_THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// y (N, D, H, W, C) = depth_shift(x) with the given groups
extern "C" int depth_shift_ring_launch(const void* x, void* y,
                                       const int* groups, int ngroups, int N,
                                       int D, int H, int W, int C,
                                       void* stream) {
  RingParams p;
  if (!ring_params(p, x, y, groups, ngroups, N, D, H, W, C))
    return (int)cudaErrorInvalidValue;
  p.w = nullptr;
  p.b = nullptr;
  p.CO = C;
  p.off_tab = (int)(((size_t)SH_SLOTS * SH_PIX * p.Cr * 2 + 127) / 128 * 128);
  const size_t smem = (size_t)p.off_tab + (size_t)(p.Cr + p.Cr / 8) * 4;
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      depth_shift_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long n_blocks =
      (long long)N * ((H * W + SH_PIX - 1) / SH_PIX);
  if (n_blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  depth_shift_ring_kernel<<<(unsigned)n_blocks, SH_THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
