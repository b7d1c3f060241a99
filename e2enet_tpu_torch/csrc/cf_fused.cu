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
// the fused block? On the card the GEMM is (CO x 9C) . (9C x H*W): the
// weights, row-major with k = tap * Cs + channel, are the A operand of
// mma.sync.m16n8k16 (bf16, f32 accumulate) through ldmatrix; the operand,
// H*W-contiguous per channel, is its B operand through ldmatrix.trans,
// which hands mma.sync the k-major fragment. An ldmatrix row must start on
// 16 bytes, so a tap's one-pixel shift along W cannot be an address offset
// of one staged copy (it is in the channels-last layout, where a pixel is a
// whole row): the block stages three copies of its (TH + 2) x WT window,
// one per tap column dw, each already shifted by dw and zero outside the
// image; the three tap rows dh are whole-row offsets into them. A block
// owns (n, 8 image rows x 16 columns, up to 48 output channels) and walks a
// chunk of depths; its weights stay in shared memory. Warp r computes image
// row r: 3 CO fragments x 2 n8 pixel fragments. Staging reads each
// element once with a scalar load, applies the affine in float32 and
// writes it into the copies that hold it. The statistics gather in
// registers over the block's depths and reach device memory by one atomic
// per channel and block.

#include "shift_conv_block.cuh"

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
cf_fused_kernel(const CfParams p) {
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

// Plain C entry points (bound with ctypes). Each returns a cudaError_t: the
// configuration check, cudaFuncSetAttribute, or cudaGetLastError() after
// the launch. Launches on `stream`; does not synchronise.

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

// x (N, D, C, H*W) bf16; w (CO, 9*C) bf16, k = tap * C + channel, tap =
// 3*(dh+1) + (dw+1); b (CO) bf16; mult/off (C) float32 or both null; y
// (N, D, CO, H*W) bf16; stats (N, CO, 2) float32 zeroed, or null; groups
// (c0, c1, shift) triples
extern "C" int cf_fused_launch(const void* x, const void* w, const void* b,
                               const void* mult, const void* off, void* y,
                               void* stats, const int* groups, int ngroups,
                               int N, int D, int H, int W, int C, int CO,
                               void* stream) {
  if (N < 1 || D < 1 || H < 1 || W < 1 || C < 1 || CO < 1 || ngroups < 1 ||
      ngroups > MAX_GROUPS || (mult == nullptr) != (off == nullptr))
    return (int)cudaErrorInvalidValue;
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
      cf_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  cf_fused_kernel<<<grid, CF_THREADS, smem,
                    static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
