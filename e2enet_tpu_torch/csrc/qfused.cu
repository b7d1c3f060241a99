// The fused shiftConvPP block with a lazy up-link part, for NVIDIA Hopper
// (sm_90a), bfloat16.
//
// Replaces the lazy mode of the Pallas TPU kernel
// e2enet_tpu/ops/qfused.py:_fwd_kernel (LazyUp, qfused.py:590-623): the
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
// all 8 mirror passes. The tap parity follows the SHIFTED source depth
// d - s: each shift group of the up part reads its own coarse depth and
// depth parity.
//
// What bounds it: at the dense level-0 shape (128^3; 48 pending + up 96 ->
// 48; CO 48) 174 GFLOP of conv plus 19.3 GFLOP of up GEMM against ~450 MB
// of traffic: the bf16 tensor cores (~0.196 ms at 989 TFLOP/s).
//
// Design (simple and right first): the block machinery of #1
// (shift_conv_block.cuh) with a staging hook. The main staging pass stages
// the materialised parts and zeros for the up part; then, per coarse depth
// that the up part's shift groups read inside the volume (at most three):
//  1. stage the normalised coarse rows of the tile's window (TH/2 + 2
//     rows; as many at once as shared memory holds, 16-byte loads, four in
//     flight per thread, bf16 norm);
//  2. per shift group of that depth, stage its up weights for its depth
//     parity (the four (h, w) parity classes x its columns x cin, K
//     contiguous) and run the (coarse pixels x cin) x (cin x columns)
//     product on ldmatrix + mma.sync.m16n8k16, a warp taking one 16-pixel
//     fragment of one coarse row for all four parity classes (one A
//     fragment, four B, eight independent accumulators), and round each
//     value to bf16 into its fine pixel of the staged tile (zero outside
//     the volume).
// Each up value is computed once per consuming block plus its halo. The
// conv's MMAs and the epilogue are #1's.

#include "shift_conv_block.cuh"

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// the up-link's norm in bf16 arithmetic: each op computed in f32 from bf16
// operands and rounded to bf16, as a bf16 tensor op rounds; m, o and the
// slope are bf16 values
__device__ __forceinline__ float norm_lrelu_bf16(float x, float m, float o) {
  const float a = round_bf16(__fadd_rn(round_bf16(__fmul_rn(x, m)), o));
  // bf16(0.01) = 0.010009765625
  return fmaxf(a, round_bf16(__fmul_rn(a, 0.010009765625f)));
}

// floor(x / 2) for any sign
__device__ __forceinline__ int floor_half(int x) { return (x - (x < 0)) / 2; }

// coarse pixels of a staged row of Ws fine columns, rounded up to whole
// 16-row fragments
__host__ __device__ inline int coarse_row_cap(int Ws) {
  return (Ws / 2 + 1 + 15) / 16 * 16;
}

struct LazyUpStage {
  static constexpr bool active = true;
  const bf16* raw;        // (N, Dc, Hc, Wc, cin)
  const float* mult;      // (N, cin)
  const float* off;
  const bf16* w;          // (8 parities bd*4 + bh*2 + bw, C_up, cin)
  int Dc, Hc, Wc, cin;
  int cins;               // cin rounded up to 16
  int cpa;                // shared row stride of the A and B stages
  int nf_max;             // 16-column fragments of the widest group
  int vec16, wvec16;      // 16-byte loads of raw rows / weight rows
  int ra = 1;             // coarse rows staged at once

  size_t smem_bytes(const Params& p) const {
    return (size_t)(ra * coarse_row_cap(p.Ws) + 4 * nf_max * 16) * cpa *
               sizeof(bf16) +
           2 * cins * sizeof(float);
  }

  // stage as many of the window's coarse rows at once (at most TH/2 + 2)
  // as the spare shared memory holds
  size_t fit(const Params& p, size_t spare) {
    const size_t per_row = (size_t)coarse_row_cap(p.Ws) * cpa * sizeof(bf16);
    size_t more = spare / per_row;
    if (more > (size_t)(p.TH / 2 + 1)) more = p.TH / 2 + 1;
    ra = 1 + (int)more;
    return more * per_row;
  }

  __device__ void stage(const Params& p, bf16* s_in, unsigned char* region,
                        int n, int d, int h0, int w0, int tid) const {
    const int up = p.nparts - 1;
    const int c_lo = p.pc0[up], cout = p.pc[up];
    const int ar = coarse_row_cap(p.Ws);
    const int KC8 = cins / 8;
    bf16* s_a = reinterpret_cast<bf16*>(region);
    bf16* s_b = s_a + (size_t)ra * ar * cpa;
    float* s_m = reinterpret_cast<float*>(s_b + (size_t)4 * nf_max * 16 * cpa);
    float* s_o = s_m + cins;
    for (int c = tid; c < cins; c += NTHREADS) {
      const bool on = c < cin;
      s_m[c] = on ? round_bf16(mult[(size_t)n * cin + c]) : 0.0f;
      s_o[c] = on ? round_bf16(off[(size_t)n * cin + c]) : 0.0f;
    }
    const int warp = tid / 32, lane = tid % 32;
    const int a_row = lane % 16, a_k = (lane / 16) * 8;
    const int b_row = lane % 8 + (lane / 16) * 8, b_k = ((lane / 8) % 2) * 8;
    const int hc0 = floor_half(h0 - 1), hc1 = floor_half(h0 + p.TH);
    const int wc0 = floor_half(w0 - 1);
    const int MFc = ar / 16;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    // the coarse depths the up part's shift groups read: the groups of one
    // coarse depth share its staged rows
    int dc_lo = Dc, dc_hi = -1;
    for (int g = 0; g < p.ngroups; ++g) {
      const int ds = d - p.gs[g];
      if (max(p.g0[g], c_lo) < min(p.g1[g], c_lo + cout) && ds >= 0 &&
          ds < p.D) {
        dc_lo = min(dc_lo, ds >> 1);
        dc_hi = max(dc_hi, ds >> 1);
      }
    }
    __syncthreads();                   // s_m, s_o
    for (int dc = dc_lo; dc <= dc_hi; ++dc) {
      const bf16* xdep = raw + ((size_t)n * Dc + dc) * Hc * Wc * cin;
      for (int hs = hc0; hs <= hc1; hs += ra) {
        const int nr = min(ra, hc1 - hs + 1);
        // ---- A: the normalised coarse rows hs .. hs+nr-1 of depth dc,
        // columns wc0 .. wc0+ar; four units per thread in flight
        const int units = nr * ar * KC8;
        for (int u0 = tid; u0 < units; u0 += 4 * NTHREADS) {
          uint4 rv[4];
          const bf16* src[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int u = u0 + e * NTHREADS;
            const int k8 = u % KC8, r = (u / KC8) % ar;
            const int hc = hs + u / (KC8 * ar), wc = wc0 + r;
            const bool ok = u < units && hc >= 0 && hc < Hc && wc >= 0 &&
                            wc < Wc && k8 * 8 < cin;
            src[e] = ok ? xdep + ((size_t)hc * Wc + wc) * cin + k8 * 8
                        : nullptr;
            rv[e] = zero;
            if (ok && vec16)
              rv[e] = __ldg(reinterpret_cast<const uint4*>(src[e]));
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int u = u0 + e * NTHREADS;
            if (u >= units) break;
            const int c0 = (u % KC8) * 8;
            uint4 out = zero;
            if (src[e] != nullptr) {
              const bf16* rb = reinterpret_cast<const bf16*>(&rv[e]);
              bf16* vals = reinterpret_cast<bf16*>(&out);
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                const float v = vec16 ? __bfloat162float(rb[i])
                                : c0 + i < cin ? __bfloat162float(src[e][i])
                                               : 0.0f;
                vals[i] = __float2bfloat16(
                    c0 + i < cin ? norm_lrelu_bf16(v, s_m[c0 + i],
                                                   s_o[c0 + i])
                                 : 0.0f);
              }
            }
            *reinterpret_cast<uint4*>(s_a + (size_t)(u / KC8) * cpa + c0) =
                out;
          }
        }
        for (int g = 0; g < p.ngroups; ++g) {
          const int j0 = max(p.g0[g], c_lo) - c_lo;
          const int j1 = min(p.g1[g], c_lo + cout) - c_lo;
          const int ds = d - p.gs[g];
          if (j0 >= j1 || ds < 0 || ds >= p.D || (ds >> 1) != dc) continue;
          const int NF = (j1 - j0 + 15) / 16;
          // ---- B: the group's weights of its depth parity, rows (parity
          // class, column), K contiguous; zero past its columns and cin
          for (int u = tid; u < 4 * NF * 16 * KC8; u += NTHREADS) {
            const int k8 = u % KC8, r = u / KC8;
            const int col = r % (NF * 16), cls = r / (NF * 16);
            const int j = j0 + col, k0 = k8 * 8;
            const bf16* src =
                w + ((size_t)((ds & 1) * 4 + cls) * cout + j) * cin + k0;
            uint4 v = zero;
            if (j < j1 && k0 < cin) {
              if (wvec16) {
                v = __ldg(reinterpret_cast<const uint4*>(src));
              } else {
                bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
                for (int i = 0; i < 8; ++i)
                  e[i] = k0 + i < cin ? src[i] : __float2bfloat16(0.0f);
              }
            }
            *reinterpret_cast<uint4*>(s_b + (size_t)r * cpa + k0) = v;
          }
          __syncthreads();             // A and B staged
          // ---- per (coarse row, row fragment, 16 columns): one warp, the
          // four parity classes together (one A fragment, four B)
          for (int task = warp; task < nr * MFc * NF; task += NWARPS) {
            const int nf = task % NF, mf = (task / NF) % MFc;
            const int row = task / (NF * MFc);
            const int r0 = 2 * (hs + row) - (h0 - 1);  // tile row of ph = 0
            const bool ph_on[2] = {r0 >= 0 && r0 < p.TH + 2,
                                   r0 + 1 >= 0 && r0 + 1 < p.TH + 2};
            if (!ph_on[0] && !ph_on[1]) continue;
            float acc[4][2][4];
#pragma unroll
            for (int c = 0; c < 4; ++c)
#pragma unroll
              for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[c][h][e] = 0.0f;
            const unsigned a_addr = (unsigned)__cvta_generic_to_shared(
                s_a + (size_t)(row * ar + mf * 16 + a_row) * cpa + a_k);
            const unsigned b_addr = (unsigned)__cvta_generic_to_shared(
                s_b + (size_t)(nf * 16 + b_row) * cpa + b_k);
            const unsigned b_cls = NF * 16 * cpa * 2;  // bytes per class
            for (int kc = 0; kc < cins; kc += 16) {
              unsigned a[4];
              ldmatrix_x4(a, a_addr + kc * 2);
#pragma unroll
              for (int c = 0; c < 4; ++c)
                if (ph_on[c >> 1]) {
                  unsigned b[4];
                  ldmatrix_x4(b, b_addr + c * b_cls + kc * 2);
                  mma_16816(acc[c][0], a, b[0], b[1]);
                  mma_16816(acc[c][1], a, b[2], b[3]);
                }
            }
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              if (!ph_on[c >> 1]) continue;
              const int r = r0 + (c >> 1), hh = r + h0 - 1;
              const bool h_in = hh >= 0 && hh < p.H;
              bf16* dst = s_in + (size_t)r * p.Ws * p.Cp + c_lo + j0;
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const int ww = 2 * (wc0 + mf * 16 + lane / 4 + half * 8) +
                               (c & 1);
                const int q = ww - (w0 - 1);
                if (q < 0 || q >= p.Ws) continue;
                const bool in = h_in && ww >= 0 && ww < p.W;
#pragma unroll
                for (int h = 0; h < 2; ++h)
#pragma unroll
                  for (int e = 0; e < 2; ++e) {
                    const int col = nf * 16 + h * 8 + (lane % 4) * 2 + e;
                    if (j0 + col < j1)
                      dst[(size_t)q * p.Cp + col] = __float2bfloat16(
                          in ? acc[c][h][2 * half + e] : 0.0f);
                  }
              }
            }
          }
          __syncthreads();             // B (and after the last group A) free
        }
      }
    }
  }
};

template <int NG, int NFW, int MPW>
__global__ void __launch_bounds__(NTHREADS)
qfused_lazy_kernel(const Params p, const LazyUpStage up) {
  shift_conv_block_body<NG, NFW, MPW>(p, up);
}

// Plain C entry point (bound with ctypes). The parts are those of
// fused_block_launch, the LAST of which is the lazy up-link: its pointers
// are null and part_c[nparts-1] is C_up. up_raw is the level-below pending
// raw (N, D/2, H/2, W/2, cin) bf16, up_mult/up_off (N, cin) f32, up_w
// (8, C_up, cin) bf16 with the parity index bd*4 + bh*2 + bw. Returns a
// cudaError_t; launches on `stream`; does not synchronise.
extern "C" int qfused_lazy_launch(const void* const* xs,
                                  const void* const* mults,
                                  const void* const* offs, const int* part_c,
                                  const int* part_vec, int nparts,
                                  const int* groups, int ngroups,
                                  const void* w, const void* b, void* y,
                                  void* stats, int N, int D, int H, int W,
                                  int CO, const void* up_raw,
                                  const void* up_mult, const void* up_off,
                                  const void* up_w, int cin, void* stream) {
  Params p;
  if (!make_params(p, xs, mults, offs, part_c, part_vec, nparts, groups,
                   ngroups, w, b, y, stats, N, D, H, W, CO))
    return (int)cudaErrorInvalidValue;
  if (nparts < 2 || cin < 1 || D % 2 || H % 2 || W % 2)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < nparts; ++i)
    if ((p.x[i] == nullptr) != (i == nparts - 1))
      return (int)cudaErrorInvalidValue;
  LazyUpStage up;
  up.raw = static_cast<const bf16*>(up_raw);
  up.mult = static_cast<const float*>(up_mult);
  up.off = static_cast<const float*>(up_off);
  up.w = static_cast<const bf16*>(up_w);
  up.Dc = D / 2; up.Hc = H / 2; up.Wc = W / 2; up.cin = cin;
  up.cins = (cin + 15) / 16 * 16;
  up.cpa = up.cins + 8;                // an odd number of 16-byte units
  const int c_lo = p.pc0[nparts - 1], c_hi = c_lo + p.pc[nparts - 1];
  int widest = 0;
  for (int g = 0; g < ngroups; ++g) {
    const int cols = min(p.g1[g], c_hi) - max(p.g0[g], c_lo);
    widest = cols > widest ? cols : widest;
  }
  up.nf_max = (widest + 15) / 16;
  up.vec16 = cin % 8 == 0 && reinterpret_cast<uintptr_t>(up_raw) % 16 == 0;
  up.wvec16 = cin % 8 == 0 && reinterpret_cast<uintptr_t>(up_w) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return CO <= 48 ? launch<1, 3, 2>(p, up, qfused_lazy_kernel<1, 3, 2>, s)
                  : launch<2, 3, 1>(p, up, qfused_lazy_kernel<2, 3, 1>, s);
}
