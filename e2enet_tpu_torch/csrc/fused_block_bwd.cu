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
//   geff = bf16(bf16(gy + bf16(gs1)) + bf16(y * bf16(2 gs2)))   bf16 steps;
//                                                     zero outside the image
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
// operations weigh about the same. geff and ct, which the TPU kernel keeps
// in VMEM (a depth ring of ct), never reach device memory here either.
//
// Design: two launches on the stream, both on the mma.sync tap loop of
// shift_conv_block.cuh.
//  1. the dgrad, only when some part's gradient is wanted: #1's block body
//     on a one-part, unshifted, norm-free input whose source pointer is
//     null, with the transposed, flipped taps. Its hook (DgradOps::stage)
//     loads gy and y (16-byte loads, two units in flight per thread) and
//     writes geff into the operand tile in bf16x2 arithmetic, zero outside
//     the image. Its epilogue (DgradOps::epilogue) rounds each ct value to
//     bf16 and writes it where the shift's adjoint puts it: the columns of
//     a shift group s at depth d go to depth d - s of their part, with the
//     norm's backward applied on the way (x read at that depth, four pixels
//     in flight per thread; g(m), g(o) summed in registers, reduced in
//     shared memory, one pair of f32 atomics per channel and block). A
//     block also writes the zeros of depth d for the groups whose d + s
//     leaves [0, D), so every gx element is written exactly once. 16-byte
//     loads and stores where an 8-column unit lies in one part and one
//     group, element by element elsewhere. At 96 columns each warp takes
//     three 16-pixel fragments (#1 takes one), so that the block's fixed
//     costs of staging and epilogue spread over more products.
//  2. the wgrad: persistent blocks each walk a range of the forward's row
//     tiles, stage S exactly as the forward does (stage_operand, a 64- or
//     32-channel slice of the concat) and the tile's gy and y rows, form
//     geff in shared memory (the blocks of the first slice also sum it into
//     gb), and run (geff^T S_t) on ldmatrix.trans + mma.sync.m16n8k16 for
//     all 9 taps, accumulating in registers across the tiles; each block
//     then adds its 9 x CO x slice partial sums to gW with f32 atomics.
// wgmma for both products is later work, in the shared header, with #1 and
// #3: each tap reads the staged halo tile at a one-pixel offset, which a
// wgmma shared-memory descriptor's 8-row core matrices do not express.

#include "shift_conv_block.cuh"

#define DG_MAX_BN 96            // widest dgrad column tile, NG * NFW * 16

static int num_sms() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// geff of one element from gy, y and its channel's bf16(gs1), bf16(2 gs2),
// in the plain version's bf16 steps
__device__ __forceinline__ float geff_value(float g, float yv, float s1,
                                            float s2) {
  return round_bf16(__fadd_rn(round_bf16(__fadd_rn(g, s1)),
                              round_bf16(__fmul_rn(yv, s2))));
}

// geff of 8 channels (one 16-byte unit) in bf16x2 arithmetic: a bf16 add
// or product rounded once equals the plain version's float32 op rounded
// to bf16 (the product of two bf16 values and the sum of two bf16 values
// within 2^16 of each other are exact in float32; a sum further apart
// rounds to the larger either way), so geff_value's bits, at a quarter of
// the instructions
__device__ __forceinline__ uint4 geff_unit(uint4 g, uint4 yv, const float* s1,
                                           const float* s2) {
  __nv_bfloat162* g2 = reinterpret_cast<__nv_bfloat162*>(&g);
  const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&yv);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    g2[e] = __hadd2_rn(
        __hadd2_rn(g2[e], __floats2bfloat162_rn(s1[2 * e], s1[2 * e + 1])),
        __hmul2_rn(y2[e], __floats2bfloat162_rn(s2[2 * e], s2[2 * e + 1])));
  return g;
}

// the norm's backward of one element: returns gU lrelu'(a) m and adds
// gU lrelu'(a) x, gU lrelu'(a) to the sums of g(m), g(o)
__device__ __forceinline__ float norm_bwd(float gu, float xv, float m,
                                          float o, float& sm, float& so) {
  const float a = __fadd_rn(__fmul_rn(xv, m), o);
  const float guf = a >= 0.0f ? gu : __fmul_rn(gu, 0.01f);
  sm += guf * xv;
  so += guf;
  return __fmul_rn(guf, m);
}

__host__ __device__ __forceinline__ bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// ===========================================================================
// 1. dgrad: the forward block machinery on geff, computed on load, with the
// shift's adjoint and the norm's backward in its epilogue

struct DgradOps {
  static constexpr bool active = true;
  // the staging hook: geff from gy and y
  const bf16* gy;               // (N, D, H, W, CO)
  const bf16* y;
  // an H slab's neighbour rows of gy and y, (N, D, 1, W, CO): above row 0
  // (gy_t, y_t) and below row H - 1 (gy_b, y_b), or null (zero geff there)
  const bf16 *gy_t, *y_t, *gy_b, *y_b;
  const float* gstats;          // (N, CO, 2)
  int vec16;                    // gy and y rows take 16-byte copies
  // the epilogue: the forward's parts, their shift groups and outputs
  const bf16* x[MAX_PARTS];     // (N, D, H, W, ci)
  const float* mult[MAX_PARTS]; // (N, ci) or null: no pending norm
  const float* off[MAX_PARTS];
  bf16* gx[MAX_PARTS];          // (N, D, H, W, ci) or null: not wanted
  float* gaff[MAX_PARTS];       // (N, ci, 2) zeroed, or null
  int pc[MAX_PARTS], pc0[MAX_PARTS], nparts;
  int g0[MAX_GROUPS], g1[MAX_GROUPS], gs[MAX_GROUPS], ngroups;

  // shared memory at p.off_hook: bf16(gs1) and bf16(2 gs2) per staged
  // channel, then the epilogue's column tables (part, local channel,
  // shift, m, o, g(m), g(o))
  __host__ __device__ static size_t tab_offset(const Params& p) {
    return 2 * (size_t)p.Cs * sizeof(float);
  }
  size_t smem_bytes(const Params& p) const {
    return tab_offset(p) + 7 * DG_MAX_BN * sizeof(float);
  }
  size_t fit(const Params&, size_t) { return 0; }

  // geff into the operand tile (staged as zeros: the part's pointer is
  // null), zero outside the image but for the slab's neighbour rows; p.C
  // is the forward's CO. Two units of gy and y in flight per thread, geff
  // formed in registers.
  __device__ void stage(const Params& p, bf16* s_in, unsigned char* region,
                        int n, int d, int h0, int w0, int tid) const {
    const int CO = p.C, Cp = p.Cp, Ws = p.Ws, rows = p.TH + 2;
    float* s1 = reinterpret_cast<float*>(region);
    float* s2 = s1 + p.Cs;
    for (int c = tid; c < CO; c += NTHREADS) {
      const float* g = gstats + ((size_t)n * CO + c) * 2;
      s1[c] = round_bf16(g[0]);
      s2[c] = round_bf16(2.0f * g[1]);
    }
    const int KC8 = (CO + 7) / 8;
    const size_t slice = (size_t)(n * p.D + d) * p.H * p.W * CO;
    const bf16* gy_d = gy + slice;
    const bf16* y_d = y + slice;
    const size_t hslice = (size_t)(n * p.D + d) * p.W * CO;
    __syncthreads();                   // s1, s2
    const int units = rows * Ws * KC8;
    for (int u0 = tid; u0 < units; u0 += 2 * NTHREADS) {
      uint4 g4[2], y4[2];
      int si[2], cc[2];
      const bf16* gsrc[2];
      const bf16* ysrc[2];
      bool ok[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int u = u0 + e * NTHREADS;
        const int cell = u / KC8;
        cc[e] = (u - cell * KC8) * 8;
        const int row = cell / Ws, col = cell - row * Ws;
        const int hh = h0 - 1 + row, ww = w0 - 1 + col;
        const bool top = hh == -1 && gy_t != nullptr;
        const bool bot = hh == p.H && gy_b != nullptr;
        ok[e] = u < units && ((hh >= 0 && hh < p.H) || top || bot) &&
                ww >= 0 && ww < p.W;
        si[e] = cell * Cp + cc[e];
        if (top || bot) {              // a neighbour's row
          const size_t i = hslice + (size_t)ww * CO + cc[e];
          gsrc[e] = (top ? gy_t : gy_b) + i;
          ysrc[e] = (top ? y_t : y_b) + i;
        } else {
          const size_t i = ((size_t)hh * p.W + ww) * CO + cc[e];
          gsrc[e] = gy_d + i;
          ysrc[e] = y_d + i;
        }
        if (ok[e] && vec16) {
          g4[e] = __ldg(reinterpret_cast<const uint4*>(gsrc[e]));
          y4[e] = __ldg(reinterpret_cast<const uint4*>(ysrc[e]));
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (!ok[e]) continue;          // zero outside the image
        const int c0 = cc[e];
        bf16* dst = s_in + si[e];
        if (vec16) {
          *reinterpret_cast<uint4*>(dst) =
              geff_unit(g4[e], y4[e], s1 + c0, s2 + c0);
        } else {
          for (int k = 0; k < 8 && c0 + k < CO; ++k)
            dst[k] = __float2bfloat16(geff_value(
                __bfloat162float(gsrc[e][k]), __bfloat162float(ysrc[e][k]),
                s1[c0 + k], s2[c0 + k]));
        }
      }
    }
  }

  // the block tile's ct (pixels of depth d x concat channels co0 ..
  // co0+ncol of the forward) to gx at the shifted depths, with the norm's
  // backward; p.CO is the forward's C
  template <int NG, int NFW, int MPW>
  __device__ void epilogue(const Params& p, const WarpTile<NG, NFW, MPW>& wt,
                           float acc[MPW][NFW][2][4], float* s_acc,
                           unsigned char* region, int n, int d, int h0,
                           int w0, int co0, int BN, int ncol, int tid) const {
    static_assert(NG * NFW * 16 <= DG_MAX_BN, "column tables too small");
    int* s_part = reinterpret_cast<int*>(region + tab_offset(p));
    int* s_cl = s_part + DG_MAX_BN;
    int* s_shift = s_cl + DG_MAX_BN;
    float* s_m = reinterpret_cast<float*>(s_shift + DG_MAX_BN);
    float* s_o = s_m + DG_MAX_BN;
    float* s_gm = s_o + DG_MAX_BN;
    float* s_go = s_gm + DG_MAX_BN;
    // column j: its part (-1: beyond C or not wanted), local channel,
    // shift, and the part's pending norm
    for (int j = tid; j < BN; j += NTHREADS) {
      const int c = co0 + j;
      int q = 0, s = 0;
      for (int k = 1; k < nparts; ++k)
        if (c >= pc0[k]) q = k;
      for (int g = 0; g < ngroups; ++g)
        if (c >= g0[g] && c < g1[g]) s = gs[g];
      const int cl = c - pc0[q];
      const bool on = j < ncol && (gx[q] != nullptr || gaff[q] != nullptr);
      const bool aff = on && mult[q] != nullptr;
      s_part[j] = on ? q : -1;
      s_cl[j] = cl;
      s_shift[j] = s;
      s_m[j] = aff ? mult[q][(size_t)n * pc[q] + cl] : 1.0f;
      s_o[j] = aff ? off[q][(size_t)n * pc[q] + cl] : 0.0f;
      s_gm[j] = 0.0f;
      s_go[j] = 0.0f;
    }
    acc_to_smem(wt, acc, s_acc, BN);   // its barrier covers the tables too

    // thread: 8-column unit j0 / 8, pixels tid / ku + i * lanes
    const int BM = p.TH * p.WF * 16;
    const int D = p.D;
    const size_t HW = (size_t)p.H * p.W;
    const TilePixel pixel(p, h0, w0);
    const int ku = (ncol + 7) / 8;
    const int lanes = NTHREADS / ku;
    const int j0 = (tid % ku) * 8;
    float sm[8], so[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) sm[e] = so[e] = 0.0f;
    // one 16-byte load of x and store of gx: the unit's 8 columns in one
    // part and one group, on 16-byte rows
    const int q0 = s_part[j0], cl0 = s_cl[j0], sh0 = s_shift[j0];
    bool vec = q0 >= 0 && cl0 % 8 == 0 && pc[q0] % 8 == 0 &&
               (gx[q0] == nullptr || aligned16(gx[q0])) &&
               (mult[q0] == nullptr || aligned16(x[q0]));
    for (int e = 1; e < 8; ++e)
      vec = vec && s_part[j0 + e] == q0 && s_shift[j0 + e] == sh0;
    const bool vec_aff = vec && mult[q0] != nullptr;
    if (tid < lanes * ku) {
      for (int lb = tid / ku; lb < BM; lb += 4 * lanes) {
        // the x rows these pixels' gU multiplies, all in flight
        int px[4];
        uint4 xr[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int lp = lb + r * lanes;
          px[r] = lp < BM ? pixel(lp) : -1;
          if (vec_aff && px[r] >= 0 && d - sh0 >= 0 && d - sh0 < D)
            xr[r] = __ldg(reinterpret_cast<const uint4*>(
                x[q0] + ((size_t)(n * D + d - sh0) * HW + px[r]) * pc[q0] +
                cl0));
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (px[r] < 0) continue;
          const float* a = s_acc + (size_t)(lb + r * lanes) * BN + j0;
          if (vec) {
            const int ci = pc[q0];
            bf16* g = gx[q0];
            const int dp = d - sh0;    // the depth this ct value is gU of
            if (dp >= 0 && dp < D) {
              const size_t i =
                  ((size_t)(n * D + dp) * HW + px[r]) * ci + cl0;
              const float4 a0 = *reinterpret_cast<const float4*>(a);
              const float4 a1 = *reinterpret_cast<const float4*>(a + 4);
              const float v[8] = {a0.x, a0.y, a0.z, a0.w,
                                  a1.x, a1.y, a1.z, a1.w};
              uint4 out;
              bf16* ov = reinterpret_cast<bf16*>(&out);
              if (vec_aff) {
                const bf16* xv = reinterpret_cast<const bf16*>(&xr[r]);
#pragma unroll
                for (int e = 0; e < 8; ++e)
                  ov[e] = __float2bfloat16(norm_bwd(
                      round_bf16(v[e]), __bfloat162float(xv[e]),
                      s_m[j0 + e], s_o[j0 + e], sm[e], so[e]));
              } else {
#pragma unroll
                for (int e = 0; e < 8; ++e) ov[e] = __float2bfloat16(v[e]);
              }
              if (g) *reinterpret_cast<uint4*>(g + i) = out;
            }
            if (g && (d + sh0 < 0 || d + sh0 >= D))  // gU of depth d: zero
              *reinterpret_cast<uint4*>(
                  g + ((size_t)(n * D + d) * HW + px[r]) * ci + cl0) =
                  make_uint4(0u, 0u, 0u, 0u);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const int j = j0 + e, q = s_part[j];
              if (q < 0) continue;
              const int ci = pc[q], s = s_shift[j], cl = s_cl[j];
              bf16* g = gx[q];
              const int dp = d - s;
              if (dp >= 0 && dp < D) {
                const size_t i =
                    ((size_t)(n * D + dp) * HW + px[r]) * ci + cl;
                const float gu = round_bf16(a[e]);
                const float out =
                    mult[q] != nullptr
                        ? norm_bwd(gu, __bfloat162float(x[q][i]), s_m[j],
                                   s_o[j], sm[e], so[e])
                        : gu;
                if (g) g[i] = __float2bfloat16(out);
              }
              if (g && (d + s < 0 || d + s >= D))
                g[((size_t)(n * D + d) * HW + px[r]) * ci + cl] =
                    __float2bfloat16(0.0f);
            }
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int q = s_part[j0 + e];
        if (q >= 0 && mult[q] != nullptr) {
          atomicAdd(&s_gm[j0 + e], sm[e]);
          atomicAdd(&s_go[j0 + e], so[e]);
        }
      }
    }
    __syncthreads();
    for (int j = tid; j < ncol; j += NTHREADS) {
      const int q = s_part[j];
      if (q >= 0 && mult[q] != nullptr && gaff[q] != nullptr) {
        float* ga = gaff[q] + ((size_t)n * pc[q] + s_cl[j]) * 2;
        atomicAdd(ga, s_gm[j]);
        atomicAdd(ga + 1, s_go[j]);
      }
    }
  }
};

template <int NG, int NFW, int MPW>
__global__ void __launch_bounds__(NTHREADS)
dgrad_kernel(const Params p, const DgradOps ops) {
  shift_conv_block_body<NG, NFW, MPW>(p, ops, ops);
}

// ===========================================================================
// 2. wgrad, with geff formed from gy and y and gb

struct WgradArgs {
  const bf16* gy;               // (N, D, H, W, CO)
  const bf16* y;
  const float* gstats;          // (N, CO, 2)
  float* gw;                    // (9, CO, C), zeroed
  float* gb;                    // (CO), zeroed
  int CO, COp;                  // real output channels; staged row stride
  int off_g, off_y, off_s;      // shared offsets of the geff and y tiles
                                // and of the CO tile's bf16(gs1),
                                // bf16(2 gs2)
  long long n_tiles;            // N * D * row tiles * W tiles
};

// MFR 16-wide output-channel fragments per block (a CO tile of 16 * MFR);
// the block's concat slice is CT channels from blockIdx.y * CT
template <int MFR, int CT>
__global__ void __launch_bounds__(NTHREADS)
wgrad_kernel(const Params p, const WgradArgs a) {
  constexpr int ITEMS = 9 * CT / 8;    // (tap, 8-channel fragment) pairs
  constexpr int NIT = (ITEMS + NWARPS - 1) / NWARPS;  // pairs per warp
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int cb = blockIdx.y * CT;
  const int co0 = blockIdx.z * MFR * 16;
  const int n_ht = (p.H + p.TH - 1) / p.TH;
  const int tile_w = p.WF * 16;
  const int MF = p.TH * p.WF;          // 16-pixel fragments per tile
  const int BM = MF * 16;
  const int u_co = MFR * 2;            // 8-channel units of a geff row
  bf16* s_in = reinterpret_cast<bf16*>(smem);
  bf16* s_g = reinterpret_cast<bf16*>(smem + a.off_g);
  bf16* s_y = reinterpret_cast<bf16*>(smem + a.off_y);
  float* s_gs = reinterpret_cast<float*>(smem + a.off_s);
  const bool vec_g = (a.CO % 8 == 0) && aligned16(a.gy) && aligned16(a.y);

  float acc[NIT][MFR][4];
#pragma unroll
  for (int r = 0; r < NIT; ++r)
#pragma unroll
    for (int f = 0; f < MFR; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][f][e] = 0.0f;

  // geff pass: this thread's 8-channel unit gk of the rows
  // tid / u_co + i * g_lanes, and its sums of gb
  const int gk = tid % u_co, g_lanes = NTHREADS / u_co;
  const bool g_on = tid < g_lanes * u_co;
  float gbs[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) gbs[e] = 0.0f;

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
    for (int j = tid; j < MFR * 16; j += NTHREADS) {
      const int co = co0 + j;
      const float* g = a.gstats + ((size_t)n * a.CO + co) * 2;
      s_gs[j] = co < a.CO ? round_bf16(g[0]) : 0.0f;
      s_gs[MFR * 16 + j] = co < a.CO ? round_bf16(2.0f * g[1]) : 0.0f;
    }

    // the tile's gy and y rows, CO tile co0.., zero outside the image and
    // beyond CO; in flight while the operand is staged
    for (int i = tid; i < BM * u_co; i += NTHREADS) {
      const int lp = i / u_co, k = (i % u_co) * 8;
      const int h = h0 + lp / tile_w, w = w0 + lp % tile_w;
      bf16* dg = s_g + (size_t)lp * a.COp + k;
      bf16* dy = s_y + (size_t)lp * a.COp + k;
      const int co = co0 + k;
      const bool pix_ok = h < p.H && w < p.W;
      const size_t src =
          ((((size_t)n * p.D + d) * p.H + h) * p.W + w) * a.CO + co;
      if (pix_ok && vec_g && co + 8 <= a.CO) {
        cp_async16(dg, a.gy + src);
        cp_async16(dy, a.y + src);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const bool ok = pix_ok && co + e < a.CO;
          dg[e] = ok ? a.gy[src + e] : __float2bfloat16(0.0f);
          dy[e] = ok ? a.y[src + e] : __float2bfloat16(0.0f);
        }
      }
    }
    cp_async_commit();
    stage_operand(p, NoHook(), smem, cb, n, d, h0, w0, tid);

    // geff in place of gy, zero outside the image and beyond CO
    if (g_on) {
      const float* s1 = s_gs + gk * 8;
      const float* s2 = s1 + MFR * 16;
      for (int lp = tid / u_co; lp < BM; lp += g_lanes) {
        if (h0 + lp / tile_w >= p.H || w0 + lp % tile_w >= p.W) continue;
        uint4* gp = reinterpret_cast<uint4*>(s_g + (size_t)lp * a.COp +
                                             gk * 8);
        uint4 g4 = *gp;
        const uint4 y4 = *reinterpret_cast<const uint4*>(
            s_y + (size_t)lp * a.COp + gk * 8);
        if (co0 + gk * 8 + 8 <= a.CO) {
          g4 = geff_unit(g4, y4, s1, s2);
        } else {                       // the last unit of a ragged CO
          bf16* gv = reinterpret_cast<bf16*>(&g4);
          const bf16* yv = reinterpret_cast<const bf16*>(&y4);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            gv[e] = __float2bfloat16(
                co0 + gk * 8 + e < a.CO
                    ? geff_value(__bfloat162float(gv[e]),
                                 __bfloat162float(yv[e]), s1[e], s2[e])
                    : 0.0f);
        }
        const __nv_bfloat162* g2 =
            reinterpret_cast<const __nv_bfloat162*>(&g4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(g2[e]);
          gbs[2 * e] += f.x;
          gbs[2 * e + 1] += f.y;
        }
        *gp = g4;
      }
    }
    __syncthreads();

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
      for (int r = 0; r < NIT; ++r) {
        const int item = warp + r * NWARPS;
        if (item < ITEMS) {
          const int tap = item / (CT / 8), j = item % (CT / 8);
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
  for (int r = 0; r < NIT; ++r) {
    const int item = warp + r * NWARPS;
    if (item >= ITEMS) continue;
    const int tap = item / (CT / 8), j = item % (CT / 8);
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

  // ---- gb: the first concat slice's blocks, through shared memory
  if (blockIdx.y == 0) {
    float* s_gb = reinterpret_cast<float*>(smem);
    __syncthreads();                   // the last tile's reads are done
    for (int j = tid; j < MFR * 16; j += NTHREADS) s_gb[j] = 0.0f;
    __syncthreads();
    if (g_on) {
#pragma unroll
      for (int e = 0; e < 8; ++e) atomicAdd(&s_gb[gk * 8 + e], gbs[e]);
    }
    __syncthreads();
    for (int j = tid; j < MFR * 16 && co0 + j < a.CO; j += NTHREADS)
      atomicAdd(&a.gb[co0 + j], s_gb[j]);
  }
}

template <int MFR, int CT>
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
  p.Cs = CT;
  p.Cp = CT + 8;
  a.COp = MFR * 16 + 8;
  const size_t in_bytes =
      ((size_t)(th + 2) * p.Ws * p.Cp * sizeof(bf16) + 127) / 128 * 128;
  const size_t g_bytes =
      ((size_t)th * wf * 16 * a.COp * sizeof(bf16) + 127) / 128 * 128;
  a.off_g = (int)in_bytes;
  a.off_y = (int)(in_bytes + g_bytes);
  a.off_s = (int)(in_bytes + 2 * g_bytes);
  p.off_tab = a.off_s + (2 * MFR * 16 * (int)sizeof(float) + 127) / 128 * 128;
  const size_t tab_bytes = ((size_t)p.Cs * (sizeof(void*) + 12) +
                            (size_t)(p.Cs / 8) * 8 + 4 + 127) / 128 * 128;
  p.off_hook = p.off_tab + (int)tab_bytes;
  const size_t smem = (size_t)p.off_hook;
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      wgrad_kernel<MFR, CT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_ht = (p.H + th - 1) / th;
  a.n_tiles = (long long)p.N * p.D * n_ht * p.n_wt;
  const int ny = (p.C + CT - 1) / CT;
  const int nz = (a.CO + MFR * 16 - 1) / (MFR * 16);
  long long nx = (2LL * num_sms() + ny * nz - 1) / (ny * nz);
  if (nx > a.n_tiles) nx = a.n_tiles;
  if (nx < 1) nx = 1;
  dim3 grid((unsigned)nx, (unsigned)ny, (unsigned)nz);
  wgrad_kernel<MFR, CT><<<grid, NTHREADS, smem, stream>>>(p, a);
  return (int)cudaGetLastError();
}

// ===========================================================================
// entry point

// Plain C entry point (bound with ctypes). xs/mults/offs/part_c/part_vec/
// groups as for fused_block_launch (the forward's parts, pending affines
// and effective shift groups); gxs: per part a bf16 output or null (not
// wanted), every element written; gaffs: per part a zeroed f32 (N, ci, 2)
// output (g(m), g(o)) or null; y, gy (N, D, H, W, CO) bf16; gstats
// (N, CO, 2) f32; w9t (9, C, CO) bf16, the forward's taps reversed and
// transposed; gw (9, CO, C) f32 and gb (CO) f32, zeroed. An H slab of
// spatial parallelism: xts / xbs the forward's halo rows per part (as
// fused_block_launch takes them), read where the wgrad's staged S would
// zero-fill; y_t, gy_t / y_b, gy_b (N, D, 1, W, CO) bf16 the neighbours' y
// and gy rows above row 0 / below row H - 1, whose geff the dgrad reads
// where it would zero-fill (null: none, the volume's edge). Returns a
// cudaError_t; launches on `stream` (the dgrad only when some part is
// wanted, then the wgrad); does not synchronise.
extern "C" int fused_block_bwd_launch(
    const void* const* xs, const void* const* mults, const void* const* offs,
    const int* part_c, const int* part_vec, int nparts, const int* groups,
    int ngroups, void* const* gxs, void* const* gaffs, const void* y,
    const void* gy, const void* gstats, const void* w9t, void* gw, void* gb,
    int N, int D, int H, int W, int CO, const void* const* xts,
    const void* const* xbs, const void* y_t, const void* gy_t,
    const void* y_b, const void* gy_b, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params p;
  if (!make_params(p, xs, mults, offs, part_c, part_vec, nparts, groups,
                   ngroups, nullptr, nullptr, nullptr, nullptr, N, D, H, W,
                   CO))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < nparts; ++i)
    if (p.x[i] == nullptr) return (int)cudaErrorInvalidValue;
  if (p.C > 2147483647 / 9) return (int)cudaErrorInvalidValue;
  set_halo(p, xts, xbs);
  const int C = p.C;
  const bf16* gy16 = static_cast<const bf16*>(gy);
  const bf16* y16 = static_cast<const bf16*>(y);
  const float* gst = static_cast<const float*>(gstats);

  // 1. dgrad with the adjoint, for the parts that are wanted
  bool any = false;
  for (int i = 0; i < nparts; ++i)
    any = any || gxs[i] != nullptr || gaffs[i] != nullptr;
  if (any) {
    DgradOps ops;
    ops.gy = gy16;
    ops.y = y16;
    ops.gy_t = static_cast<const bf16*>(gy_t);
    ops.y_t = static_cast<const bf16*>(y_t);
    ops.gy_b = static_cast<const bf16*>(gy_b);
    ops.y_b = static_cast<const bf16*>(y_b);
    if ((ops.gy_t == nullptr) != (ops.y_t == nullptr) ||
        (ops.gy_b == nullptr) != (ops.y_b == nullptr))
      return (int)cudaErrorInvalidValue;
    ops.gstats = gst;
    ops.vec16 = CO % 8 == 0 && aligned16(gy) && aligned16(y) &&
                aligned16(gy_t) && aligned16(y_t) && aligned16(gy_b) &&
                aligned16(y_b);
    for (int i = 0; i < MAX_PARTS; ++i) {
      ops.x[i] = p.x[i];
      ops.mult[i] = p.mult[i];
      ops.off[i] = p.off[i];
      ops.pc[i] = p.pc[i];
      ops.pc0[i] = p.pc0[i];
      ops.gx[i] = i < nparts ? static_cast<bf16*>(gxs[i]) : nullptr;
      ops.gaff[i] = i < nparts ? static_cast<float*>(gaffs[i]) : nullptr;
    }
    ops.nparts = nparts;
    for (int g = 0; g < MAX_GROUPS; ++g) {
      ops.g0[g] = p.g0[g];
      ops.g1[g] = p.g1[g];
      ops.gs[g] = p.gs[g];
    }
    ops.ngroups = p.ngroups;
    // geff as a one-part, unshifted input the hook stages
    const void* none[1] = {nullptr};
    const int gc[1] = {CO};
    const int gvec[1] = {2};
    const int g_one[3] = {0, CO, 0};
    Params q;
    if (!make_params(q, none, none, none, gc, gvec, 1, g_one, 1, w9t,
                     nullptr, nullptr, nullptr, N, D, H, W, C))
      return (int)cudaErrorInvalidValue;
    // 96 columns: three 16-pixel fragments per warp (#1 takes one), so that
    // the block's fixed costs (staging, the geff pass, the epilogue's
    // tables and reductions) spread over three times the products
    int err = C <= 48 ? launch<1, 3, 2>(q, ops, dgrad_kernel<1, 3, 2>, s)
                      : launch<2, 3, 3>(q, ops, dgrad_kernel<2, 3, 3>, s);
    if (err != 0) return err;
  }

  // 2. wgrad and gb
  WgradArgs wa;
  wa.gy = gy16;
  wa.y = y16;
  wa.gstats = gst;
  wa.gw = static_cast<float*>(gw);
  wa.gb = static_cast<float*>(gb);
  wa.CO = CO;
  // a CO tile of 48 leaves registers for a 64-channel slice (fewer slices
  // recomputing geff, more products per staged tile); of 96, a 32-channel
  // one
  return CO <= 48 ? launch_wgrad<3, 64>(p, wa, s)
                  : launch_wgrad<6, 32>(p, wa, s);
}
