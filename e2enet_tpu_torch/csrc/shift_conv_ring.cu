// Depth-ring shift + (1,3,3) conv, and the ring shift alone, for NVIDIA
// Hopper (sm_90a), bfloat16.
//
// Replaces the Pallas TPU kernels of experiments/shift_conv_pallas.py:
//   shift_conv_ring_launch   `_kernel` / `_kernel_v2` (fused_shift_conv,
//                            fused_shift_conv_v2):
//                              y = conv_(1,3,3)(depth_shift(x)) + b
//                            x (N, D, H, W, C), kernel (9, CO, C) tap-major,
//                            f32 sums of bf16 products, y rounded once
//   depth_shift_ring_launch  `_kernel_shift_ring` (pallas_depth_shift):
//                            y = depth_shift(x), exact; its backward is the
//                            same kernel with the groups' shifts negated
// The channel groups are torch.chunk's (c0, c1, shift) ranges, any shift in
// [-2, 2]; a depth row the shift reads outside [0, D) is zero.
//
// What bounds them: bytes. At 1 x 128^3 x 48 -> 48 the fused kernel moves
// 201 MB in and 201 MB out (0.120 ms at 3.35 TB/s) against 87 GFLOP
// (0.088 ms at 989 TFLOP/s); the shift alone moves the same bytes.
//
// The question these kernels answer (shift_conv_pallas.py:24-47): does a
// depth ring, which reads each input row from device memory once, beat
// restaging the operand from device memory for every output depth (#1's
// way)?
//
// Design of the fused kernel: a block owns an (n, 8-row x 16-column tile of
// H x W, CO tile of up to 48) and walks depth. It keeps a 5-slot ring of the
// input depth slices of its tile plus a 1-pixel halo in shared memory (raw,
// C channels a pixel), and copies slice d+3 with cp.async into the slot of
// d-2 while the tensor cores work on d: each input value is read from device
// memory once per tile (the halo aside). The shift groups need not fall on
// 8-channel boundaries (10, 10, 10, 10, 8 at C = 48), so the operand of
// depth d is assembled from the ring into a zero-haloed (TH+2) x 18 x Cs
// tile (8-channel units of one shift move as one 16-byte word, mixed units
// channel by channel); all 9 taps' weights stay in shared memory. Each warp
// computes one image row of 16 pixels against the CO tile with ldmatrix +
// mma.sync.m16n8k16 (bf16, f32 accumulators) and stores y straight from
// its registers with the bias added in float32.
//
// The shift alone: a block owns 64 consecutive pixels of the H x W plane of
// one n and walks depth with an 8-slot ring, three slices in flight ahead of
// the one it writes; 8-channel units of one shift are copied as 16-byte
// words.

#include "shift_conv_block.cuh"

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

// y (N, D, H, W, CO) = conv_(1,3,3)(depth_shift(x)) + b; w (9, CO, C)
extern "C" int shift_conv_ring_launch(const void* x, const void* w,
                                      const void* b, void* y,
                                      const int* groups, int ngroups, int N,
                                      int D, int H, int W, int C, int CO,
                                      void* stream) {
  RingParams p;
  if (!ring_params(p, x, y, groups, ngroups, N, D, H, W, C) || CO < 1)
    return (int)cudaErrorInvalidValue;
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
