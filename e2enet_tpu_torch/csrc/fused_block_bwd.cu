// Backward of the fused shiftConvPP block (#1, fused_block.cu, and the
// block of the lazy kernel, qfused.cu) for NVIDIA Hopper (sm_90a),
// bfloat16.
//
// Replaces the Pallas TPU kernels e2enet_tpu/ops/fused_block.py:_bwd_kernel
// (driven by _bwd_pallas) and e2enet_tpu/ops/qfused.py:_bwd_kernel (driven
// by _bwd_pallas and chunked per part by _qfused_bwd), which compute the
// same function in two layouts; their plain form is _fused_bwd_xla. For
// the forward y = conv2d_3x3(S) + b, S = depth_shift(concat(u_p)),
// u_p = lrelu(x_p * m_p + o_p) on parts with a pending norm, and the
// cotangents gy of y and gstats of its statistics (sum y, sum y^2):
//
//   geff = bf16(bf16(gy + bf16(gs1)) + bf16(y * bf16(2 gs2)))   bf16 steps
//   gb   = sum geff                                   f32, over (n, d, h, w)
//   ct   = bf16(conv_T(geff))                         9 flipped taps, CO->C,
//                                                     f32 sums
//   gU[d][c] = ct[d + s_c][c]                         the shift's adjoint,
//                                                     zero outside [0, D)
//   gx_p = bf16(gU * lrelu'(a) * m), a = x m + o      parts with a norm;
//          g(m) = sum gU lrelu'(a) x, g(o) = sum gU lrelu'(a)   f32
//   gx_p = gU                                         other parts
//   gW[t][co][c] = sum S_t[c] geff[co]                f32, S recomputed
//
// with lrelu'(a) = 1 where a >= 0, else 0.01.
//
// What bounds it: two implicit GEMMs of the forward's size (dgrad and
// wgrad, 2 N D H W 9 C CO operations each) against reading parts, y and gy
// and writing gx: at the level-0 lazy node (2 x 128^3, 48 + 48 -> 48) about
// 2.4 GB and 0.70 ms of bf16 tensor-core work at the peak, so bytes and
// operations weigh about the same.
//
// Design (simple and right first), four launches on the stream:
//  1. geff_kernel: the elementwise geff, stored bf16, and gb (per-thread
//     f32 sums of one channel, shared then global atomics).
//  2. the dgrad: #1's block machinery (shift_conv_block.cuh) run on geff as
//     a one-part, unshifted, norm-free input with the transposed, flipped
//     taps and a zero bias: it stores ct in bf16 (its statistics go to a
//     scratch buffer). Only when some part needs its gradient.
//  3. adjoint_kernel, per part that needs it: the shift adjoint as a read
//     of ct at depth d + s_c, the leaky relu's and the norm's backward,
//     gx stored bf16, g(m) and g(o) as per-thread f32 sums of one channel
//     and global atomics.
//  4. wgrad_kernel: persistent blocks each walk a range of the forward's
//     row tiles, stage S exactly as the forward does (stage_operand, a
//     32-channel slice of the concat) and the tile's geff rows, and run
//     (geff^T S_t) on ldmatrix.trans + mma.sync.m16n8k16 for all 9 taps,
//     accumulating in registers across the tiles; each block then adds its
//     9 x CO x 32 partial sums to gW with f32 atomics.
// wgmma, TMA and fusing launches 1-3 are later work.

#include "shift_conv_block.cuh"

#define EW_THREADS 256          // threads of the elementwise kernels
#define WG_CT 32                // concat channels per wgrad block
#define WG_ITEMS (9 * WG_CT / 8)  // (tap, 8-channel fragment) pairs
#define WG_NIT ((WG_ITEMS + NWARPS - 1) / NWARPS)  // pairs per warp

static int num_sms() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// ===========================================================================
// 1. geff and gb

struct GeffParams {
  const bf16* gy;               // (N, P, CO), P = D*H*W pixels
  const bf16* y;
  const float* gstats;          // (N, CO, 2)
  bf16* geff;                   // (N, P, CO)
  float* gb;                    // (CO), zeroed
  long long P;
  int CO, pix_per_block;
};

// block (chunk, n); thread t keeps channel t % CO over pixels t / CO + k *
// (EW_THREADS / CO), so its gb sum is one channel's
__global__ void __launch_bounds__(EW_THREADS) geff_kernel(const GeffParams p) {
  __shared__ float s_gb[EW_THREADS];
  const int tid = threadIdx.x;
  const int n = blockIdx.y;
  const int ppi = EW_THREADS / p.CO;    // pixels per iteration
  const int c = tid % p.CO;
  if (tid < p.CO) s_gb[tid] = 0.0f;
  __syncthreads();
  float acc = 0.0f;
  if (tid < ppi * p.CO) {
    const float* gs = p.gstats + ((size_t)n * p.CO + c) * 2;
    const float s1 = round_bf16(gs[0]);
    const float s2 = round_bf16(2.0f * gs[1]);
    const long long q0 = (long long)blockIdx.x * p.pix_per_block;
    long long q1 = q0 + p.pix_per_block;
    if (q1 > p.P) q1 = p.P;
    for (long long q = q0 + tid / p.CO; q < q1; q += ppi) {
      const size_t i = ((size_t)n * p.P + q) * p.CO + c;
      const float g = __bfloat162float(p.gy[i]);
      const float yv = __bfloat162float(p.y[i]);
      const float v = round_bf16(
          __fadd_rn(round_bf16(__fadd_rn(g, s1)),
                    round_bf16(__fmul_rn(yv, s2))));
      p.geff[i] = __float2bfloat16(v);
      acc += v;
    }
    atomicAdd(&s_gb[c], acc);
  }
  __syncthreads();
  if (tid < p.CO) atomicAdd(&p.gb[tid], s_gb[tid]);
}

// ===========================================================================
// 2. dgrad: the forward block machinery on geff

template <int NG, int NFW, int MPW>
__global__ void __launch_bounds__(NTHREADS)
dgrad_kernel(const Params p, const NoHook hook) {
  shift_conv_block_body<NG, NFW, MPW>(p, hook);
}

// ===========================================================================
// 3. shift adjoint and the norm's backward, one part

struct AdjParams {
  const bf16* ct;               // (N, D, H, W, C)
  const bf16* x;                // (N, D, H, W, ci), the part
  const float* mult;            // (N, ci) or null: no pending norm
  const float* off;
  bf16* gx;                     // (N, D, H, W, ci) or null: not wanted
  float* gaff;                  // (N, ci, 2) zeroed, or null
  long long P;                  // D*H*W
  int HW, D, C, ci, pc0, pix_per_block, ngroups;
  int g0[MAX_GROUPS], g1[MAX_GROUPS], gs[MAX_GROUPS];
};

__global__ void __launch_bounds__(EW_THREADS)
adjoint_kernel(const AdjParams p) {
  const int tid = threadIdx.x;
  const int n = blockIdx.y;
  const int ppi = EW_THREADS / p.ci;
  if (tid >= ppi * p.ci) return;
  const int c = tid % p.ci;
  const int cc = p.pc0 + c;             // concat channel
  int s = 0;
  for (int g = 0; g < p.ngroups; ++g)
    if (cc >= p.g0[g] && cc < p.g1[g]) s = p.gs[g];
  const bool aff = p.mult != nullptr;
  const float m = aff ? p.mult[(size_t)n * p.ci + c] : 1.0f;
  const float o = aff ? p.off[(size_t)n * p.ci + c] : 0.0f;
  const long long q0 = (long long)blockIdx.x * p.pix_per_block;
  long long q1 = q0 + p.pix_per_block;
  if (q1 > p.P) q1 = p.P;
  float sm = 0.0f, so = 0.0f;
  for (long long q = q0 + tid / p.ci; q < q1; q += ppi) {
    const int d = (int)(q / p.HW);
    const long long hw = q - (long long)d * p.HW;
    const int e = d + s;                // ct depth this gradient reads
    const float v =
        (e >= 0 && e < p.D)
            ? __bfloat162float(
                  p.ct[(((size_t)n * p.D + e) * p.HW + hw) * p.C + cc])
            : 0.0f;
    const size_t i = ((size_t)n * p.P + q) * p.ci + c;
    if (aff) {
      const float xv = __bfloat162float(p.x[i]);
      const float a = __fadd_rn(__fmul_rn(xv, m), o);
      const float guf = a >= 0.0f ? v : __fmul_rn(v, 0.01f);
      if (p.gx) p.gx[i] = __float2bfloat16(__fmul_rn(guf, m));
      sm += guf * xv;
      so += guf;
    } else if (p.gx) {
      p.gx[i] = __float2bfloat16(v);
    }
  }
  if (aff && p.gaff) {
    atomicAdd(&p.gaff[((size_t)n * p.ci + c) * 2], sm);
    atomicAdd(&p.gaff[((size_t)n * p.ci + c) * 2 + 1], so);
  }
}

// ===========================================================================
// 4. wgrad

struct WgradArgs {
  const bf16* geff;             // (N, D, H, W, CO)
  float* gw;                    // (9, CO, C), zeroed
  int CO, COp;                  // real output channels; staged row stride
  int off_g;                    // shared offset of the geff tile
  long long n_tiles;            // N * D * row tiles * W tiles
};

// MFR 16-wide output-channel fragments per block (a CO tile of 16 * MFR);
// the block's concat slice is WG_CT channels from blockIdx.y * WG_CT
template <int MFR>
__global__ void __launch_bounds__(NTHREADS)
wgrad_kernel(const Params p, const WgradArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int cb = blockIdx.y * WG_CT;
  const int co0 = blockIdx.z * MFR * 16;
  const int n_ht = (p.H + p.TH - 1) / p.TH;
  const int tile_w = p.WF * 16;
  const int MF = p.TH * p.WF;          // 16-pixel fragments per tile
  const int BM = MF * 16;
  const int u_co = MFR * 2;            // 8-channel units of a geff row
  bf16* s_in = reinterpret_cast<bf16*>(smem);
  bf16* s_g = reinterpret_cast<bf16*>(smem + a.off_g);
  const bool vec_g = (a.CO % 8 == 0) &&
                     (reinterpret_cast<uintptr_t>(a.geff) % 16 == 0);

  float acc[WG_NIT][MFR][4];
#pragma unroll
  for (int r = 0; r < WG_NIT; ++r)
#pragma unroll
    for (int f = 0; f < MFR; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][f][e] = 0.0f;

  // ldmatrix.trans row addresses of this lane: A (geff^T), pixel
  // lane%8 + 8*(lane/16), channel 8*((lane/8)%2); B (S), pixel lane%16
  const int a_pix = lane % 8 + 8 * (lane / 16);
  const int a_co = 8 * ((lane / 8) % 2);
  const int b_pix = lane % 16;

  const long long t0 = a.n_tiles * blockIdx.x / gridDim.x;
  const long long t1 = a.n_tiles * (blockIdx.x + 1) / gridDim.x;
  for (long long tt = t0; tt < t1; ++tt) {
    long long bid = tt;
    const int wt = (int)(bid % p.n_wt);
    bid /= p.n_wt;
    const int ht = (int)(bid % n_ht);
    bid /= n_ht;
    const int d = (int)(bid % p.D);
    const int n = (int)(bid / p.D);
    const int h0 = ht * p.TH;
    const int w0 = wt * tile_w;
    __syncthreads();                   // the last tile's reads are done

    // the tile's geff rows, CO tile co0.., zero outside the image and
    // beyond CO; in flight while the operand is staged
    for (int i = tid; i < BM * u_co; i += NTHREADS) {
      const int lp = i / u_co, k = (i % u_co) * 8;
      const int h = h0 + lp / tile_w, w = w0 + lp % tile_w;
      bf16* dst = s_g + (size_t)lp * a.COp + k;
      const int co = co0 + k;
      const bool pix_ok = h < p.H && w < p.W;
      const bf16* src =
          a.geff + ((((size_t)n * p.D + d) * p.H + h) * p.W + w) * a.CO + co;
      if (pix_ok && vec_g && co + 8 <= a.CO) {
        cp_async16(dst, src);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (pix_ok && co + e < a.CO) ? src[e]
                                             : __float2bfloat16(0.0f);
      }
    }
    cp_async_commit();
    stage_operand(p, NoHook(), smem, cb, n, d, h0, w0, tid);

    for (int f = 0; f < MF; ++f) {
      const int fr_th = f / p.WF;
      const int fr_w = (f % p.WF) * 16;
      if (h0 + fr_th >= p.H || w0 + fr_w >= p.W) continue;  // all zero
      unsigned afr[MFR][4];
#pragma unroll
      for (int mf = 0; mf < MFR; ++mf)
        ldmatrix_x4_trans(afr[mf], (unsigned)__cvta_generic_to_shared(
                                       s_g + (size_t)(f * 16 + a_pix) * a.COp +
                                       mf * 16 + a_co));
#pragma unroll
      for (int r = 0; r < WG_NIT; ++r) {
        const int item = warp + r * NWARPS;
        if (item < WG_ITEMS) {
          const int tap = item / (WG_CT / 8), j = item % (WG_CT / 8);
          const int dh = tap / 3 - 1, dw = tap % 3 - 1;
          unsigned bfr[2];
          ldmatrix_x2_trans(bfr, (unsigned)__cvta_generic_to_shared(
                                     s_in + ((size_t)(fr_th + 1 + dh) * p.Ws +
                                             fr_w + 1 + dw + b_pix) * p.Cp +
                                     j * 8));
#pragma unroll
          for (int mf = 0; mf < MFR; ++mf)
            mma_16816(acc[r][mf], afr[mf], bfr[0], bfr[1]);
        }
      }
    }
  }

  // ---- this block's partial sums into gW (9, CO, C); an accumulator
  // holds rows lane/4 and lane/4 + 8, columns 2*(lane%4) + 0, 1
#pragma unroll
  for (int r = 0; r < WG_NIT; ++r) {
    const int item = warp + r * NWARPS;
    if (item >= WG_ITEMS) continue;
    const int tap = item / (WG_CT / 8), j = item % (WG_CT / 8);
#pragma unroll
    for (int mf = 0; mf < MFR; ++mf)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int co = co0 + mf * 16 + lane / 4 + (e >= 2 ? 8 : 0);
        const int c = cb + j * 8 + 2 * (lane % 4) + (e & 1);
        if (co < a.CO && c < p.C)
          atomicAdd(&a.gw[((size_t)tap * a.CO + co) * p.C + c], acc[r][mf][e]);
      }
  }
}

template <int MFR>
static int launch_wgrad(Params p, WgradArgs a, cudaStream_t stream) {
  // the forward's W tiles (fewest of equal width, at most 8 fragments)
  // and rows for about 16 fragments per tile
  const int wf_all = (p.W + 15) / 16;
  int wf = wf_all < 8 ? wf_all : 8;
  p.n_wt = (wf_all + wf - 1) / wf;
  wf = (wf_all + p.n_wt - 1) / p.n_wt;
  p.WF = wf;
  p.Ws = wf * 16 + 2;
  int th = 16 / wf;
  if (th < 1) th = 1;
  if (th > p.H) th = p.H;
  p.TH = th;
  p.Cs = WG_CT;
  p.Cp = WG_CT + 8;
  a.COp = MFR * 16 + 8;
  const size_t in_bytes =
      ((size_t)(th + 2) * p.Ws * p.Cp * sizeof(bf16) + 127) / 128 * 128;
  const size_t g_bytes =
      ((size_t)th * wf * 16 * a.COp * sizeof(bf16) + 127) / 128 * 128;
  a.off_g = (int)in_bytes;
  p.off_tab = (int)(in_bytes + g_bytes);
  const size_t tab_bytes = ((size_t)p.Cs * (sizeof(void*) + 12) +
                            (size_t)(p.Cs / 8) * 8 + 4 + 127) / 128 * 128;
  p.off_hook = p.off_tab + (int)tab_bytes;
  const size_t smem = (size_t)p.off_hook;
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      wgrad_kernel<MFR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_ht = (p.H + th - 1) / th;
  a.n_tiles = (long long)p.N * p.D * n_ht * p.n_wt;
  const int ny = (p.C + WG_CT - 1) / WG_CT;
  const int nz = (a.CO + MFR * 16 - 1) / (MFR * 16);
  long long nx = (2LL * num_sms() + ny * nz - 1) / (ny * nz);
  if (nx > a.n_tiles) nx = a.n_tiles;
  if (nx < 1) nx = 1;
  dim3 grid((unsigned)nx, (unsigned)ny, (unsigned)nz);
  wgrad_kernel<MFR><<<grid, NTHREADS, smem, stream>>>(p, a);
  return (int)cudaGetLastError();
}

// ===========================================================================
// entry point

// Plain C entry point (bound with ctypes). xs/mults/offs/part_c/part_vec/
// groups as for fused_block_launch (the forward's parts, pending affines
// and effective shift groups); gxs: per part a bf16 output or null (not
// wanted); gaffs: per part a zeroed f32 (N, ci, 2) output (g(m), g(o)) or
// null; y, gy (N, D, H, W, CO) bf16; gstats (N, CO, 2) f32; geff scratch
// (N, D, H, W, CO) bf16; ct scratch (N, D, H, W, C) bf16 and ct_stats
// (N, C, 2) f32 (null when no part is wanted); w9t (9, C, CO) bf16, the
// forward's taps reversed and transposed; zero_b (C) bf16 zeros; gw
// (9, CO, C) f32 and gb (CO) f32, zeroed. Returns a cudaError_t; launches
// on `stream`; does not synchronise.
extern "C" int fused_block_bwd_launch(
    const void* const* xs, const void* const* mults, const void* const* offs,
    const int* part_c, const int* part_vec, int nparts, const int* groups,
    int ngroups, void* const* gxs, void* const* gaffs, const void* y,
    const void* gy, const void* gstats, void* geff, void* ct, void* ct_stats,
    const void* w9t, const void* zero_b, void* gw, void* gb, int N, int D,
    int H, int W, int CO, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params p;
  if (!make_params(p, xs, mults, offs, part_c, part_vec, nparts, groups,
                   ngroups, w9t, zero_b, nullptr, nullptr, N, D, H, W, CO))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < nparts; ++i)
    if (p.x[i] == nullptr) return (int)cudaErrorInvalidValue;
  if (CO > EW_THREADS || p.C > 2147483647 / 9) return (int)cudaErrorInvalidValue;
  const int C = p.C;
  const long long P = (long long)D * H * W;
  const int sms = num_sms();
  const long long per_n = (4LL * sms + N - 1) / N;   // blocks per sample

  // 1. geff, gb
  {
    GeffParams g;
    g.gy = static_cast<const bf16*>(gy);
    g.y = static_cast<const bf16*>(y);
    g.gstats = static_cast<const float*>(gstats);
    g.geff = static_cast<bf16*>(geff);
    g.gb = static_cast<float*>(gb);
    g.P = P;
    g.CO = CO;
    long long ppb = (P + per_n - 1) / per_n;
    if (ppb < 1) ppb = 1;
    g.pix_per_block = (int)ppb;
    dim3 grid((unsigned)((P + ppb - 1) / ppb), (unsigned)N);
    geff_kernel<<<grid, EW_THREADS, 0, s>>>(g);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }

  // 2-3. dgrad and the adjoint, for the parts that are wanted
  bool any = false;
  for (int i = 0; i < nparts; ++i)
    any = any || gxs[i] != nullptr || gaffs[i] != nullptr;
  if (any) {
    if (ct == nullptr || ct_stats == nullptr) return (int)cudaErrorInvalidValue;
    for (int i = 0; i < nparts; ++i)
      if (p.pc[i] > EW_THREADS) return (int)cudaErrorInvalidValue;
    const void* gxs_in[1] = {geff};
    const void* none[1] = {nullptr};
    const int gc[1] = {CO};
    const int gvec[1] = {
        (reinterpret_cast<uintptr_t>(geff) % 16 == 0 && CO % 8 == 0) ? 16
        : (reinterpret_cast<uintptr_t>(geff) % 4 == 0 && CO % 2 == 0) ? 4
                                                                       : 2};
    const int g_one[3] = {0, CO, 0};
    Params q;
    if (!make_params(q, gxs_in, none, none, gc, gvec, 1, g_one, 1, w9t,
                     zero_b, ct, ct_stats, N, D, H, W, C))
      return (int)cudaErrorInvalidValue;
    const NoHook hook;
    int err = C <= 48 ? launch<1, 3, 2>(q, hook, dgrad_kernel<1, 3, 2>, s)
                      : launch<2, 3, 1>(q, hook, dgrad_kernel<2, 3, 1>, s);
    if (err != 0) return err;
    for (int i = 0; i < nparts; ++i) {
      if (gxs[i] == nullptr && gaffs[i] == nullptr) continue;
      AdjParams a;
      a.ct = static_cast<const bf16*>(ct);
      a.x = p.x[i];
      a.mult = p.mult[i];
      a.off = p.off[i];
      a.gx = static_cast<bf16*>(gxs[i]);
      a.gaff = static_cast<float*>(gaffs[i]);
      a.P = P;
      a.HW = H * W;
      a.D = D;
      a.C = C;
      a.ci = p.pc[i];
      a.pc0 = p.pc0[i];
      a.ngroups = p.ngroups;
      for (int g = 0; g < MAX_GROUPS; ++g) {
        a.g0[g] = p.g0[g];
        a.g1[g] = p.g1[g];
        a.gs[g] = p.gs[g];
      }
      long long ppb = (P + per_n - 1) / per_n;
      if (ppb < 1) ppb = 1;
      a.pix_per_block = (int)ppb;
      dim3 grid((unsigned)((P + ppb - 1) / ppb), (unsigned)N);
      adjoint_kernel<<<grid, EW_THREADS, 0, s>>>(a);
      cudaError_t e2 = cudaGetLastError();
      if (e2 != cudaSuccess) return (int)e2;
    }
  }

  // 4. wgrad
  WgradArgs wa;
  wa.geff = static_cast<const bf16*>(geff);
  wa.gw = static_cast<float*>(gw);
  wa.CO = CO;
  return CO <= 48 ? launch_wgrad<3>(p, wa, s) : launch_wgrad<6>(p, wa, s);
}
