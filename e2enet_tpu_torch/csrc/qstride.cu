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
// What bounds it: at the bench geometry (N=1, 128^3 x 48 -> 64^3 x 96) it
// reads 201 MB and writes 50 MB against 21.7 GFLOP (K = 9*48 = 432): ~86
// FLOP per byte, below the card's ~295 ridge, so device memory bounds it
// (~0.075 ms at 3.35 TB/s).
//
// Design (simple and right first): persistent blocks of 8 warps, one per
// SM, each walking output tiles of TH rows x 16*WF columns of one (n, do).
//  * All nine taps' weights, (CO, C) per tap with K contiguous, are staged
//    once per block, zero-padded to 16-multiples in CO and K.
//  * Per tile, a per-channel table gives each channel's source depth (or
//    none: outside [0, D), or K padding); 8-channel units are classified as
//    zero, one 16-byte load, four 4-byte loads, or eight scalar loads. The
//    normalised, shifted, zero-haloed input rows are staged in shared memory
//    once, with the columns split by parity at stride 2 (plane = column %
//    2), so the 16 pixels of an MMA row fragment are consecutive staged rows
//    Cp = Cs + 8 channels apart: ldmatrix's eight rows fall in distinct
//    bank groups.
//  * Warps form a 4 (M) x 2 (N) grid; each tap is an offset into the staged
//    tile, fragments go through ldmatrix and mma.sync.m16n8k16 bf16 with f32
//    accumulators. No im2col buffer exists.
//  * The epilogue adds the f32 bias, stores bf16 pairs and reduces the
//    statistics over the warp's rows with shuffles into shared memory,
//    flushed to the (zeroed) output with f32 atomics when the sample
//    changes.
// wgmma, TMA and overlapping one tile's staging with another's MMAs are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define MAX_GROUPS 8
#define NWARPS 8
#define NTHREADS (NWARPS * 32)
#define WARPS_M 4
#define WARPS_N 2
#define MPW 2        // row fragments per warp
#define NFW 4        // 16-wide CO fragments per warp: CO <= 128
#define SMEM_LIMIT (227 * 1024)

#define UNIT_ZERO 0
#define UNIT_16 1
#define UNIT_PAIRS 2
#define UNIT_SCALAR 3

struct Params {
  const bf16* x;                      // (N, D, H, W, C)
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
  int Cs, Cp, BN;                     // K and CO padded; smem row stride
  int WF, TW, TH, n_wt, n_ht, ntiles;
  int SR, PL;                         // staged rows; entries per plane
  int vec16, vec4;                    // widest aligned pixel-row copy
  int off_in, off_tab, off_st;        // shared-memory offsets (bytes)
};

__device__ __forceinline__ float norm_lrelu(float x, float m, float o) {
  // no fma contraction: the plain torch version rounds the product
  const float a = __fadd_rn(__fmul_rn(x, m), o);
  return fmaxf(a, __fmul_rn(a, 0.01f));
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

__global__ void __launch_bounds__(NTHREADS) qstride_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int Cs = p.Cs, Cp = p.Cp, BN = p.BN, KC8 = Cs / 8;

  bf16* s_w = reinterpret_cast<bf16*>(smem);
  bf16* s_in = reinterpret_cast<bf16*>(smem + p.off_in);
  int* s_dsrc = reinterpret_cast<int*>(smem + p.off_tab);
  float* s_m = reinterpret_cast<float*>(s_dsrc + Cs);
  float* s_o = s_m + Cs;
  int* s_unit = reinterpret_cast<int*>(s_o + Cs);
  float* s_st = reinterpret_cast<float*>(smem + p.off_st);

  // ---- all taps' weights, zero padding in K and CO
  for (int i = tid; i < 9 * BN * Cs; i += NTHREADS) {
    const int k = i % Cs, r = i / Cs;
    const int co = r % BN, t = r / BN;
    s_w[(size_t)r * Cp + k] = (co < p.CO && k < p.C)
                                  ? p.w[((size_t)t * p.CO + co) * p.C + k]
                                  : __float2bfloat16(0.0f);
  }
  for (int i = tid; i < BN * 2; i += NTHREADS) s_st[i] = 0.0f;

  // warp tile: row fragments wm, wm + WARPS_M; CO fragments wn*NFW ..
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int MF = p.TH * p.WF, NF = BN / 16;
  const int a_row = lane % 16, a_k = (lane / 16) * 8;
  const int b_row = lane % 8 + (lane / 16) * 8, b_k = ((lane / 8) % 2) * 8;
  const size_t plane_stride = (size_t)p.PL * Cp;
  const size_t row_stride = plane_stride * p.sw;

  int n_prev = -1;
  for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
    int rest = tile;
    const int wt = rest % p.n_wt;
    rest /= p.n_wt;
    const int ht = rest % p.n_ht;
    rest /= p.n_ht;
    const int dout = rest % p.Do;
    const int n = rest / p.Do;
    const int h0 = ht * p.TH, w0 = wt * p.TW;

    __syncthreads();                  // previous tile's reads are done
    if (n != n_prev) {
      if (n_prev >= 0) {              // flush the previous sample's stats
        for (int i = tid; i < p.CO * 2; i += NTHREADS) {
          atomicAdd(&p.stats[(size_t)n_prev * p.CO * 2 + i], s_st[i]);
          s_st[i] = 0.0f;
        }
      }
      n_prev = n;
    }
    // ---- per-channel source depth and affine for this (n, dout)
    for (int c = tid; c < Cs; c += NTHREADS) {
      int ds = -1;
      float m = 0.0f, o = 0.0f;
      if (c < p.C) {
        int s = 0;
        for (int g = 0; g < p.ngroups; ++g)
          if (c >= p.g0[g] && c < p.g1[g]) s = p.gs[g];
        const int d = p.sd * dout + p.parity - s;
        if (d >= 0 && d < p.D) ds = d;
        m = p.mult[(size_t)n * p.C + c];
        o = p.off[(size_t)n * p.C + c];
      }
      s_dsrc[c] = ds;
      s_m[c] = m;
      s_o[c] = o;
    }
    __syncthreads();
    for (int k = tid; k < KC8; k += NTHREADS) {
      const int c0 = k * 8;
      bool zero = true, one = p.vec16 != 0, pairs = p.vec4 != 0;
      for (int e = 0; e < 8; ++e) {
        const int de = s_dsrc[c0 + e];
        zero = zero && de < 0;
        one = one && de >= 0 && de == s_dsrc[c0];
        if (e % 2 == 0) pairs = pairs && de == s_dsrc[c0 + e + 1];
      }
      s_unit[k] = zero ? UNIT_ZERO : one ? UNIT_16
                  : pairs ? UNIT_PAIRS : UNIT_SCALAR;
    }
    __syncthreads();

    // ---- stage rows sh*h0 + org_h .. + SR, columns sw*w0 + org_w + j,
    // j = idx*sw + plane
    const int n_units = p.SR * p.sw * p.PL * KC8;
    for (int u = tid; u < n_units; u += NTHREADS) {
      const int k = u % KC8;
      int cell = u / KC8;
      const int idx = cell % p.PL;
      cell /= p.PL;
      const int plane = cell % p.sw;
      const int row = cell / p.sw;
      const int hi = p.sh * h0 + p.org_h + row;
      const int wi = p.sw * w0 + p.org_w + idx * p.sw + plane;
      const int c0 = k * 8;
      uint4 out = make_uint4(0u, 0u, 0u, 0u);
      const int kind = s_unit[k];
      if (kind != UNIT_ZERO && hi >= 0 && hi < p.H && wi >= 0 && wi < p.W) {
        bf16* vals = reinterpret_cast<bf16*>(&out);
        const size_t pix = ((size_t)n * p.D * p.H + hi) * p.W + wi;
        const size_t dstride = (size_t)p.H * p.W;
        float v[8];
        if (kind == UNIT_16) {
          const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
              p.x + (pix + s_dsrc[c0] * dstride) * p.C + c0));
          const bf16* rv = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(rv[e]);
        } else if (kind == UNIT_PAIRS) {
#pragma unroll
          for (int e = 0; e < 8; e += 2) {
            const int de = s_dsrc[c0 + e];
            __nv_bfloat162 r2 = __floats2bfloat162_rn(0.0f, 0.0f);
            if (de >= 0)
              r2 = __ldg(reinterpret_cast<const __nv_bfloat162*>(
                  p.x + (pix + de * dstride) * p.C + c0 + e));
            const float2 f = __bfloat1622float2(r2);
            v[e] = f.x;
            v[e + 1] = f.y;
          }
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int de = s_dsrc[c0 + e];
            v[e] = de >= 0 ? __bfloat162float(
                                 p.x[(pix + de * dstride) * p.C + c0 + e])
                           : 0.0f;
          }
        }
#pragma unroll
        for (int e = 0; e < 8; ++e)
          vals[e] = s_dsrc[c0 + e] >= 0
                        ? __float2bfloat16(
                              norm_lrelu(v[e], s_m[c0 + e], s_o[c0 + e]))
                        : __float2bfloat16(0.0f);
      }
      *reinterpret_cast<uint4*>(s_in + row * row_stride +
                                plane * plane_stride + (size_t)idx * Cp +
                                c0) = out;
    }
    __syncthreads();

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
        const unsigned b_addr = (unsigned)__cvta_generic_to_shared(
            s_w + ((size_t)t * BN + wn * NFW * 16 + b_row) * Cp + b_k);
        for (int kc = 0; kc < Cs; kc += 16) {
          unsigned a[MPW][4], b[NFW][4];
#pragma unroll
          for (int f = 0; f < MPW; ++f)
            if (fr_on[f]) ldmatrix_x4(a[f], a_addr[f] + kc * 2);
#pragma unroll
          for (int j = 0; j < NFW; ++j)
            if (nf_on[j]) ldmatrix_x4(b[j], b_addr + (j * 16 * Cp + kc) * 2);
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
            const int ho = h0 + fr_r[f];
            const int wo = w0 + fr_c[f] + lane / 4 + half * 8;
            if (ho >= p.Ho || wo >= p.Wo) continue;
            const float v0 = acc[f][j][h][2 * half] + b0;
            const float v1 = acc[f][j][h][2 * half + 1] + b1;
            bf16* dst = p.y + ((((size_t)n * p.Do + dout) * p.Ho + ho) *
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
  }
  __syncthreads();
  if (n_prev >= 0)
    for (int i = tid; i < p.CO * 2; i += NTHREADS)
      atomicAdd(&p.stats[(size_t)n_prev * p.CO * 2 + i], s_st[i]);
}

// Plain C entry point (bound with ctypes). groups holds (c0, c1, shift)
// triples; w is (9, CO, C) bf16 with the taps already mirrored; b is f32.
// Returns a cudaError_t: the configuration check, cudaFuncSetAttribute, or
// cudaGetLastError() after the launch. Launches on `stream`; does not
// synchronise.
extern "C" int qstride_launch(const void* x, const void* mult,
                              const void* off, const int* groups,
                              int ngroups, const void* w, const void* b,
                              void* y, void* stats, int N, int D, int H,
                              int W, int C, int CO, int Do, int Ho, int Wo,
                              int sd, int sh, int sw, int parity, int org_h,
                              int org_w, void* stream) {
  if (ngroups < 1 || ngroups > MAX_GROUPS || N < 1 || D < 1 || H < 1 ||
      W < 1 || C < 1 || CO < 1 || CO > NFW * WARPS_N * 16 || Do < 1 ||
      Ho < 1 || Wo < 1 || sd < 1 || sd > 2 || sh < 1 || sh > 2 || sw < 1 ||
      sw > 2)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const bf16*>(x);
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
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  p.vec16 = (xa % 16 == 0 && C % 8 == 0);
  p.vec4 = (xa % 4 == 0 && C % 2 == 0);
  // output tile: equal W tiles of at most 4 row fragments, then rows up to
  // WARPS_M * MPW fragments in all
  const int wf_all = (Wo + 15) / 16;
  p.n_wt = (wf_all + 3) / 4;
  p.WF = (wf_all + p.n_wt - 1) / p.n_wt;
  p.TW = 16 * p.WF;
  p.TH = (WARPS_M * MPW) / p.WF;
  if (p.TH > Ho) p.TH = Ho;
  p.n_ht = (Ho + p.TH - 1) / p.TH;
  p.SR = sh * (p.TH - 1) + 3;
  p.PL = p.TW + 2;
  const long long ntiles = (long long)N * Do * p.n_ht * p.n_wt;
  if (ntiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  p.ntiles = (int)ntiles;
  const size_t w_bytes = (size_t)9 * p.BN * p.Cp * sizeof(bf16);
  const size_t in_bytes = (size_t)p.SR * sw * p.PL * p.Cp * sizeof(bf16);
  p.off_in = (int)((w_bytes + 127) / 128 * 128);
  p.off_tab = (int)((p.off_in + in_bytes + 127) / 128 * 128);
  p.off_st = p.off_tab + p.Cs * 12 + (p.Cs / 8) * 4;
  p.off_st = (p.off_st + 15) / 16 * 16;
  const size_t smem = (size_t)p.off_st + (size_t)p.BN * 2 * sizeof(float);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      qstride_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int grid = p.ntiles < sms ? p.ntiles : sms;
  qstride_kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      p);
  return (int)cudaGetLastError();
}
