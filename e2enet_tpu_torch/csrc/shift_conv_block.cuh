// The shiftConvPP block machinery shared by the fused block (#1,
// fused_block.cu), the fused block with a lazy up-link part (#3,
// qfused.cu), the block's backward (fused_block_bwd.cu: its dgrad runs
// the whole body with its own hook and epilogue, its wgrad stage_operand
// alone) and the software-pipelined block (fused_block_pipe.cu:
// stage_operand_issue / stage_operand_finish, mma_tap and store_tile around
// its own depth loop), for NVIDIA Hopper (sm_90a), bfloat16. The design is
// described in fused_block.cu. A kernel is
//
//   template <...> __global__ void k(const Params p, const Hook hook)
//   { shift_conv_block_body<NG, NFW, MPW>(p, hook); }
//
// and `Hook` adds a staging pass: after the operand tile is staged and its
// pending norms are applied, hook.stage() may write more channels into it
// (in shared memory at p.off_hook: hook.smem_bytes(p) bytes, grown by
// hook.fit(p, spare) into what the block tile leaves spare). A part whose
// source pointer is null is staged as zeros for the hook to fill. A third
// argument, an epilogue type (default StoreTile: bias, the y store and the
// statistics), replaces what is done with the block tile's sums.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

typedef __nv_bfloat16 bf16;

#define MAX_PARTS 4
#define MAX_GROUPS 8
#define NWARPS 16
#define NTHREADS (NWARPS * 32)
#define SMEM_LIMIT (227 * 1024)

// how an 8-channel unit is staged; bit 2: a channel carries a pending norm
#define UNIT_SCALAR 0
#define UNIT_16 1
#define UNIT_PAIRS 2
#define UNIT_ZERO 3
#define UNIT_AFF 4

struct Params {
  const bf16* x[MAX_PARTS];           // (N, D, H, W, pc) each; null: a part
                                      // the hook stages
  const float* mult[MAX_PARTS];       // (N, pc) or null: no pending norm
  const float* off[MAX_PARTS];
  int pc[MAX_PARTS];                  // channels of each part
  int pc0[MAX_PARTS];                 // first concat channel of each part
  int vec[MAX_PARTS];                 // widest aligned copy of a part's
                                      // pixel rows: 16, 4 or 2 bytes
  int nparts;
  int g0[MAX_GROUPS], g1[MAX_GROUPS], gs[MAX_GROUPS];  // shift groups
  int ngroups;
  const bf16* w;                      // (9, CO, C), tap = 3*(dh+1) + (dw+1)
  const bf16* b;                      // (CO)
  bf16* y;                            // (N, D, H, W, CO)
  float* stats;                       // (N, CO, 2), zeroed by the caller
  int N, D, H, W, C, CO;
  int Cs;                             // C rounded up to 16
  int Cp;                             // shared row stride, >= Cs
  int WF;                             // 16-pixel fragments per W tile
  int n_wt;                           // W tiles per image row
  int TH;                             // image rows per block
  int Ws;                             // staged tile width: 16*WF + 2
  int off_w, off_tab, off_hook;       // shared-memory offsets (bytes)
};

// the staging pass of a plain fused block: none
struct NoHook {
  static constexpr bool active = false;
  size_t smem_bytes(const Params&) const { return 0; }
  size_t fit(const Params&, size_t) { return 0; }
  __device__ void stage(const Params&, bf16*, unsigned char*, int, int, int,
                        int, int) const {}
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
__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
// the same, each 8x8 matrix transposed on the way (rows in shared memory
// are the fragment's columns)
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned r[4],
                                                  unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x2_trans(unsigned r[2],
                                                  unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
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
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// stage tap t's weights, output channels co0 .. co0+ncol, all C, into
// s_w[j * Cp + k]
__device__ __forceinline__ void stage_weights(const Params& p, bf16* s_w,
                                              int t, int co0, int ncol,
                                              bool vec, int tid) {
  const bf16* src = p.w + ((size_t)t * p.CO + co0) * p.C;
  if (vec) {
    const int per_row = p.C / 8;
    for (int i = tid; i < ncol * per_row; i += NTHREADS) {
      const int j = i / per_row, k = (i % per_row) * 8;
      cp_async16(s_w + j * p.Cp + k, src + (size_t)j * p.C + k);
    }
    cp_async_commit();
  } else {
    for (int i = tid; i < ncol * p.C; i += NTHREADS) {
      const int j = i / p.C, k = i % p.C;
      s_w[j * p.Cp + k] = src[(size_t)j * p.C + k];
    }
  }
}

// visits the staged units (cell, 8-channel chunk k) of this thread in
// order, stepping (k, col, row) without divisions
struct UnitWalk {
  int k, col, row, step_k, step_cell;
  __device__ UnitWalk(int tid, int KC8, int Ws) {
    k = tid % KC8;
    const int cell = tid / KC8;
    col = cell % Ws;
    row = cell / Ws;
    step_k = NTHREADS % KC8;
    step_cell = NTHREADS / KC8;
  }
  __device__ void next(int KC8, int Ws) {
    k += step_k;
    col += step_cell;
    if (k >= KC8) { k -= KC8; ++col; }
    while (col >= Ws) { col -= Ws; ++row; }
  }
};

// The per-channel table of stage_operand, laid out at `tab`
struct StageTable {
  const bf16** src;
  int* info;
  float* m;
  float* o;
  int* unit;
  int* affk;
  int* naff;
  __device__ StageTable(unsigned char* tab, int Cs) {
    src = reinterpret_cast<const bf16**>(tab);
    info = reinterpret_cast<int*>(src + Cs);
    m = reinterpret_cast<float*>(info + Cs);
    o = m + Cs;
    unit = reinterpret_cast<int*>(o + Cs);
    affk = unit + Cs / 8;              // copied units with a pending norm
    naff = affk + Cs / 8;
  }
};

// First half of stage_operand: builds the per-channel table at `tab` and
// issues the staging of the operand into s_in as one committed cp.async
// group (units staged channel by channel, and zeros, are stored at once).
// Does not wait for the copies: stage_operand_finish does.
__device__ __forceinline__ void stage_operand_issue(const Params& p,
                                                    bf16* s_in,
                                                    unsigned char* tab,
                                                    int cb, int n, int d,
                                                    int h0, int w0, int tid) {
  const int Cs = p.Cs, Cp = p.Cp, Ws = p.Ws;
  const int KC8 = Cs / 8;
  const int HW = p.H * p.W;
  const StageTable t(tab, Cs);
  const bf16** s_src = t.src;
  int* s_info = t.info;
  float* s_m = t.m;
  float* s_o = t.o;
  int* s_unit = t.unit;
  int* s_affk = t.affk;
  int* s_naff = t.naff;

  // ---- per-channel table for this (n, d). info: -1 when the channel is
  // zero (beyond C, its shift reads outside [0, D), or its part is the
  // hook's); else bit 0 no 16-byte copy, bit 1 no 4-byte copy, bit 2
  // pending norm, bits 3-4 part, bits 5.. channels of the part (the pixel
  // stride); s_src: the channel's element at pixel (0, 0) of depth d - shift
  for (int c = tid; c < Cs; c += NTHREADS) {
    int info = -1;
    float m = 1.0f, o = 0.0f;
    const bf16* src = p.x[0];
    const int cc = cb + c;             // concat channel
    if (cc < p.C) {
      int q = 0;
      for (int k = 1; k < p.nparts; ++k)
        if (cc >= p.pc0[k]) q = k;
      int s = 0;
      for (int g = 0; g < p.ngroups; ++g)
        if (cc >= p.g0[g] && cc < p.g1[g]) s = p.gs[g];
      const int ds = d - s;
      if (ds >= 0 && ds < p.D && p.x[q] != nullptr) {
        const int cl = cc - p.pc0[q];
        const int ci = p.pc[q];
        const bool aff = p.mult[q] != nullptr;
        if (aff) {
          m = p.mult[q][n * ci + cl];
          o = p.off[q][n * ci + cl];
        }
        src = p.x[q] + (size_t)(n * p.D + ds) * HW * ci + cl;
        info = ((int)aff << 2) | (q << 3) | (ci << 5);
        if (p.vec[q] < 16 || cl % 8) info |= 1;
        if (p.vec[q] < 4 || cl % 2) info |= 2;
      }
    }
    s_src[c] = src;
    s_info[c] = info;
    s_m[c] = m;
    s_o[c] = o;
  }
  __syncthreads();
  for (int k = tid; k < KC8; k += NTHREADS) {
    const int c0 = k * 8;
    const int i0 = s_info[c0];
    bool zero = true, one = i0 >= 0 && !(i0 & 1), pairs = true, aff = false;
    for (int e = 0; e < 8; ++e) {
      const int ie = s_info[c0 + e];
      zero = zero && ie < 0;
      aff = aff || (ie >= 0 && (ie & 4));
      // one copy: consecutive elements of one source row
      one = one && ie >= 0 && (ie >> 3) == (i0 >> 3) &&
            s_src[c0 + e] == s_src[c0] + e;
      if (e % 2 == 0) {
        const int in = s_info[c0 + e + 1];
        pairs = pairs && ((ie < 0 && in < 0) ||
                          (ie >= 0 && in >= 0 && !(ie & 2) &&
                           (in >> 3) == (ie >> 3) &&
                           s_src[c0 + e + 1] == s_src[c0 + e] + 1));
      }
    }
    s_unit[k] = (zero ? UNIT_ZERO : one ? UNIT_16
                 : pairs ? UNIT_PAIRS : UNIT_SCALAR) | (aff ? UNIT_AFF : 0);
  }
  __syncthreads();
  if (tid == 0) {
    int naff = 0;
    for (int k = 0; k < KC8; ++k) {
      const int kind = s_unit[k] & 3;
      if ((s_unit[k] & UNIT_AFF) && (kind == UNIT_16 || kind == UNIT_PAIRS))
        s_affk[naff++] = k;
    }
    *s_naff = naff;
  }

  // ---- stage the operand: rows h0-1 .. h0+TH, columns w0-1 .. w0+16*WF
  const int rows = p.TH + 2;
  UnitWalk it(tid, KC8, Ws);
  for (; it.row < rows; it.next(KC8, Ws)) {
    const int hh = h0 - 1 + it.row;
    const int ww = w0 - 1 + it.col;
    const int c0 = it.k * 8;
    const bool pix_ok = hh >= 0 && hh < p.H && ww >= 0 && ww < p.W;
    const int pix = pix_ok ? hh * p.W + ww : 0;
    bf16* dst = s_in + (size_t)(it.row * Ws + it.col) * Cp + c0;
    const int unit = s_unit[it.k];
    const int kind = unit & 3;
    if (kind == UNIT_ZERO || !pix_ok) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    if (kind == UNIT_16) {
      cp_async16(dst, s_src[c0] + (size_t)pix * (s_info[c0] >> 5));
    } else if (kind == UNIT_PAIRS) {
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        const int info = s_info[c0 + e];
        const bool ok = info >= 0;
        cp_async4_zfill(dst + e,
                        s_src[c0 + e] + (ok ? (size_t)pix * (info >> 5) : 0),
                        ok);
      }
    } else {
      // channel by channel: eight independent loads, norms applied here
      bf16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int info = s_info[c0 + e];
        v[e] = s_src[c0 + e][info >= 0 ? (size_t)pix * (info >> 5) : 0];
      }
      uint4 out;
      bf16* vals = reinterpret_cast<bf16*>(&out);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int info = s_info[c0 + e];
        const float a =
            norm_lrelu(__bfloat162float(v[e]), s_m[c0 + e], s_o[c0 + e]);
        vals[e] = info < 0 ? __float2bfloat16(0.0f)
                           : (info & 4) ? __float2bfloat16(a) : v[e];
      }
      *reinterpret_cast<uint4*>(dst) = out;
    }
  }
  cp_async_commit();
}

// Second half of stage_operand: waits for every copy (the caller's cp.async
// groups included), applies the pending norms in place and runs the hook's
// staging pass; ends with the block synchronised.
template <class Hook>
__device__ __forceinline__ void stage_operand_finish(const Params& p,
                                                     const Hook& hook,
                                                     unsigned char* smem,
                                                     bf16* s_in,
                                                     unsigned char* tab,
                                                     int n, int d, int h0,
                                                     int w0, int tid) {
  const int Cp = p.Cp, Ws = p.Ws;
  const StageTable t(tab, p.Cs);
  const int* s_info = t.info;
  const float* s_m = t.m;
  const float* s_o = t.o;
  const int* s_unit = t.unit;
  const int* s_affk = t.affk;
  const int rows = p.TH + 2;
  cp_async_wait_all();
  __syncthreads();
  // pending norms of the copied units, in place; zero fill stays zero.
  // Walks (cell, unit with a norm) pairs only.
  const int naff = *t.naff;
  if (naff > 0) {
    UnitWalk iw(tid, naff, Ws);
    for (; iw.row < rows; iw.next(naff, Ws)) {
      const int hh = h0 - 1 + iw.row;
      const int ww = w0 - 1 + iw.col;
      if (hh < 0 || hh >= p.H || ww < 0 || ww >= p.W) continue;
      const int k = s_affk[iw.k];
      const int c0 = k * 8;
      uint4* ptr = reinterpret_cast<uint4*>(
          s_in + (size_t)(iw.row * Ws + iw.col) * Cp + c0);
      uint4 val = *ptr;
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&val);
      const float4 m0 = *reinterpret_cast<const float4*>(s_m + c0);
      const float4 m1 = *reinterpret_cast<const float4*>(s_m + c0 + 4);
      const float4 o0 = *reinterpret_cast<const float4*>(s_o + c0);
      const float4 o1 = *reinterpret_cast<const float4*>(s_o + c0 + 4);
      const float m[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
      const float o[8] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
      // a 16-byte unit is one part and one shift: all 8 carry the norm
      const bool all = (s_unit[k] & 3) == UNIT_16;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h2[e]);
        const __nv_bfloat162 n2 = __floats2bfloat162_rn(
            norm_lrelu(f.x, m[2 * e], o[2 * e]),
            norm_lrelu(f.y, m[2 * e + 1], o[2 * e + 1]));
        const int i0 = s_info[c0 + 2 * e], i1 = s_info[c0 + 2 * e + 1];
        const bool on0 = all || (i0 >= 0 && (i0 & 4));
        const bool on1 = all || (i1 >= 0 && (i1 & 4));
        h2[e] = __halves2bfloat162(on0 ? __low2bfloat16(n2) : __low2bfloat16(h2[e]),
                                   on1 ? __high2bfloat16(n2) : __high2bfloat16(h2[e]));
      }
      *ptr = val;
    }
  }
  __syncthreads();
  if constexpr (Hook::active) {
    hook.stage(p, s_in, smem + p.off_hook, n, d, h0, w0, tid);
    __syncthreads();
  }
}

// Stage the shifted, normalised, zero-haloed operand of one block's rows
// into shared memory: rows h0-1 .. h0+TH, columns w0-1 .. w0+16*WF, p.Cs
// channels, the staged channel c being concat channel cb + c (channels at
// or beyond p.C are zero), at smem[0..] with row stride p.Cp; the
// per-channel table lives at p.off_tab. Ends with every copy landed (the
// caller's cp.async groups included) and the block synchronised.
template <class Hook>
__device__ __forceinline__ void stage_operand(const Params& p,
                                              const Hook& hook,
                                              unsigned char* smem, int cb,
                                              int n, int d, int h0, int w0,
                                              int tid) {
  bf16* s_in = reinterpret_cast<bf16*>(smem);
  stage_operand_issue(p, s_in, smem + p.off_tab, cb, n, d, h0, w0, tid);
  stage_operand_finish(p, hook, smem, s_in, smem + p.off_tab, n, d, h0, w0,
                       tid);
}

// The warp's share of a block tile: row fragments wm + f*WPM (f < MPW) of
// the TH x WF grid of 16-pixel fragments, CO fragments ng*NFW + j (j < NFW)
// of the nf in the tile
template <int NG, int NFW, int MPW>
struct WarpTile {
  static constexpr int WPM = NWARPS / NG;  // warps along M
  int ng, wm, lane;
  int th[MPW], w[MPW];
  bool on[MPW], nf_on[NFW], active;
  __device__ WarpTile(const Params& p, int tid, int nf) {
    const int warp = tid / 32;
    const int MF = p.TH * p.WF;          // 16-pixel fragments in this block
    ng = warp % NG;
    wm = warp / NG;
    lane = tid % 32;
#pragma unroll
    for (int f = 0; f < MPW; ++f) {
      const int mf = wm + f * WPM;
      on[f] = mf < MF;
      th[f] = mf / p.WF;
      w[f] = (mf % p.WF) * 16;
    }
#pragma unroll
    for (int j = 0; j < NFW; ++j) nf_on[j] = ng * NFW + j < nf;
    active = on[0] && nf_on[0];
  }
};

// zero the padding of `nbuf` consecutive weight buffers of BN rows x Cp:
// columns C .. Cp of every row and rows ncol .. BN
__device__ __forceinline__ void zero_weight_padding(const Params& p,
                                                    bf16* s_w, int nbuf,
                                                    int BN, int ncol,
                                                    int tid) {
  const int kpad = p.Cp - p.C;         // columns C .. Cp of every row
  for (int i = tid; i < nbuf * BN * kpad; i += NTHREADS)
    s_w[(i / kpad) * p.Cp + p.C + i % kpad] = __float2bfloat16(0.0f);
  for (int i = tid; i < nbuf * (BN - ncol) * p.C; i += NTHREADS) {
    const int r = i / p.C;             // rows ncol .. BN of every buffer
    s_w[((r / (BN - ncol)) * BN + ncol + r % (BN - ncol)) * p.Cp + i % p.C] =
        __float2bfloat16(0.0f);
  }
}

// acc += tap t's products over all Cs channels: the operand at s_in as
// stage_operand stages it, the tap's weights at s_w (BN rows x Cp)
template <int NG, int NFW, int MPW>
__device__ __forceinline__ void mma_tap(const Params& p,
                                        const WarpTile<NG, NFW, MPW>& wt,
                                        float acc[MPW][NFW][2][4],
                                        const bf16* s_in, const bf16* s_w,
                                        int t) {
  if (!wt.active) return;
  const int Cs = p.Cs, Cp = p.Cp, Ws = p.Ws;
  const int dh = t / 3 - 1;
  const int dw = t % 3 - 1;
  // ldmatrix row addresses of this lane: A, row lane%16 of the fragment,
  // k half lane/16; B, output channel (lane%8) + 8*(lane/16), k half
  // (lane/8)%2
  const int lane = wt.lane;
  const int a_row = lane % 16, a_k = (lane / 16) * 8;
  const int b_row = lane % 8 + (lane / 16) * 8, b_k = ((lane / 8) % 2) * 8;
  unsigned a_addr[MPW];
#pragma unroll
  for (int f = 0; f < MPW; ++f)
    a_addr[f] = (unsigned)__cvta_generic_to_shared(
        s_in + ((size_t)(wt.th[f] + 1 + dh) * Ws + wt.w[f] + 1 + dw +
                a_row) * Cp + a_k);
  const unsigned b_addr = (unsigned)__cvta_generic_to_shared(
      s_w + (size_t)(wt.ng * NFW * 16 + b_row) * Cp + b_k);
  for (int kc = 0; kc < Cs; kc += 16) {
    unsigned a[MPW][4], b[NFW][4];
#pragma unroll
    for (int f = 0; f < MPW; ++f)
      if (wt.on[f]) ldmatrix_x4(a[f], a_addr[f] + kc * 2);
#pragma unroll
    for (int j = 0; j < NFW; ++j)
      if (wt.nf_on[j]) ldmatrix_x4(b[j], b_addr + (j * 16 * Cp + kc) * 2);
#pragma unroll
    for (int j = 0; j < NFW; ++j)
#pragma unroll
      for (int f = 0; f < MPW; ++f)
        if (wt.nf_on[j] && wt.on[f]) {
          mma_16816(acc[f][j][0], a[f], b[j][0], b[j][1]);
          mma_16816(acc[f][j][1], a[f], b[j][2], b[j][3]);
        }
  }
}

// The accumulators of one block tile into shared memory at s_acc (TH*WF*16
// x BN floats, pixel-major; the caller has synchronised the block since the
// last read of what it aliases), then a block barrier. An n8 accumulator
// holds rows lane/4 and lane/4 + 8, columns 2*(lane%4)+0,1.
template <int NG, int NFW, int MPW>
__device__ __forceinline__ void acc_to_smem(const WarpTile<NG, NFW, MPW>& wt,
                                            float acc[MPW][NFW][2][4],
                                            float* s_acc, int BN) {
  const int lane = wt.lane;
#pragma unroll
  for (int f = 0; f < MPW; ++f) {
    const int mf = wt.wm + f * WarpTile<NG, NFW, MPW>::WPM;
#pragma unroll
    for (int j = 0; j < NFW; ++j)
      if (wt.on[f] && wt.nf_on[j]) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* o = s_acc + (size_t)(mf * 16 + lane / 4) * BN +
                     (wt.ng * NFW + j) * 16 + h * 8 + (lane % 4) * 2;
          *reinterpret_cast<float2*>(o) =
              make_float2(acc[f][j][h][0], acc[f][j][h][1]);
          *reinterpret_cast<float2*>(o + 8 * BN) =
              make_float2(acc[f][j][h][2], acc[f][j][h][3]);
        }
      }
  }
  __syncthreads();
}

// tile pixel lp -> pixel h*W + w of the (n, d) slice, or -1 outside it; a
// tile that is the whole row needs no division
struct TilePixel {
  int h0, w0, W, H, tile_w, n_valid;
  bool full_w;
  __device__ TilePixel(const Params& p, int h0_, int w0_)
      : h0(h0_), w0(w0_), W(p.W), H(p.H), tile_w(p.WF * 16),
        n_valid((p.H - h0_) * p.W),
        full_w(p.n_wt == 1 && p.W == p.WF * 16) {}
  __device__ int operator()(int lp) const {
    if (full_w) return lp < n_valid ? h0 * W + lp : -1;
    const int h = h0 + lp / tile_w, w = w0 + lp % tile_w;
    return (h < H && w < W) ? h * W + w : -1;
  }
};

// The epilogue of one block tile through shared memory at s_acc (TH*WF*16
// x BN floats; the caller has synchronised the block since the last read of
// what it aliases): bias, the bf16 store of y and the per-channel
// statistics (atomics).
template <int NG, int NFW, int MPW>
__device__ __forceinline__ void store_tile(const Params& p,
                                           const WarpTile<NG, NFW, MPW>& wt,
                                           float acc[MPW][NFW][2][4],
                                           float* s_acc, int n, int d,
                                           int h0, int w0, int co0, int BN,
                                           int ncol, int tid) {
  acc_to_smem(wt, acc, s_acc, BN);
  const int BM = p.TH * p.WF * 16;
  const TilePixel pixel(p, h0, w0);
  bf16* y_slice = p.y + (size_t)(n * p.D + d) * p.H * p.W * p.CO + co0;
  if (p.CO % 8 == 0) {
    const int per_row = ncol / 8;
    for (UnitWalk iy(tid, per_row, BM); iy.row == 0; iy.next(per_row, BM)) {
      const int px = pixel(iy.col);
      if (px < 0) continue;
      const int j = iy.k * 8;
      uint4 o;
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&o);
      const float* a = s_acc + (size_t)iy.col * BN + j;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        h2[e] = __floats2bfloat162_rn(
            a[2 * e] + __bfloat162float(p.b[co0 + j + 2 * e]),
            a[2 * e + 1] + __bfloat162float(p.b[co0 + j + 2 * e + 1]));
      *reinterpret_cast<uint4*>(y_slice + (size_t)px * p.CO + j) = o;
    }
  } else {
    for (int idx = tid; idx < BM * BN; idx += NTHREADS) {
      const int j = idx % BN;
      const int px = pixel(idx / BN);
      if (px >= 0 && j < ncol)
        y_slice[(size_t)px * p.CO + j] =
            __float2bfloat16(s_acc[idx] + __bfloat162float(p.b[co0 + j]));
    }
  }

  const int G = NTHREADS / BN;          // threads per output channel
  if (tid < G * BN) {
    const int j = tid % BN;
    if (j < ncol) {
      const int co = co0 + j;
      const float bias = __bfloat162float(p.b[co]);
      float s1 = 0.0f, s2 = 0.0f;
#pragma unroll 4
      for (int lp = tid / BN; lp < BM; lp += G) {
        if (pixel(lp) >= 0) {
          const float v = s_acc[lp * BN + j] + bias;
          s1 += v;
          s2 += v * v;
        }
      }
      atomicAdd(&p.stats[((size_t)n * p.CO + co) * 2], s1);
      atomicAdd(&p.stats[((size_t)n * p.CO + co) * 2 + 1], s2);
    }
  }
}

// The epilogue of a plain fused block: store_tile. Another epilogue type
// has the same member; it may use the hook's shared memory at `region`.
struct StoreTile {
  template <int NG, int NFW, int MPW>
  __device__ __forceinline__ void epilogue(
      const Params& p, const WarpTile<NG, NFW, MPW>& wt,
      float acc[MPW][NFW][2][4], float* s_acc, unsigned char* /*region*/,
      int n, int d, int h0, int w0, int co0, int BN, int ncol,
      int tid) const {
    store_tile(p, wt, acc, s_acc, n, d, h0, w0, co0, BN, ncol, tid);
  }
};

template <int NG, int NFW, int MPW, class Hook, class Epilogue = StoreTile>
__device__ __forceinline__ void shift_conv_block_body(
    const Params& p, const Hook& hook, const Epilogue& epi = Epilogue()) {
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
  const int co0 = blockIdx.y * NG * NFW * 16;
  const int nf = min(NG * NFW, (p.CO - co0 + 15) / 16);  // CO fragments
  const int BN = nf * 16;
  const int ncol = min(BN, p.CO - co0);  // real columns of this tile
  const int Cp = p.Cp;

  bf16* s_in = reinterpret_cast<bf16*>(smem);
  bf16* s_w0 = reinterpret_cast<bf16*>(smem + p.off_w);
  bf16* s_w1 = s_w0 + BN * Cp;

  // ---- weights: zero the padding of both buffers once, start tap 0
  const bool vec_w = (p.C % 8 == 0);
  zero_weight_padding(p, s_w0, 2, BN, ncol, tid);
  stage_weights(p, s_w0, 0, co0, ncol, vec_w, tid);

  // ---- the operand (its copies wait for the weights' copy too)
  stage_operand(p, hook, smem, 0, n, d, h0, w0, tid);

  // ---- 9 taps x Cs/16 K-steps of m16n8k16 MMAs
  const WarpTile<NG, NFW, MPW> wtile(p, tid, nf);
  // per 16-wide CO fragment j, two n8 accumulators of 4 floats
  float acc[MPW][NFW][2][4];
#pragma unroll
  for (int f = 0; f < MPW; ++f)
#pragma unroll
    for (int j = 0; j < NFW; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[f][j][h][e] = 0.0f;

  for (int t = 0; t < 9; ++t) {
    const bf16* s_w = (t & 1) ? s_w1 : s_w0;
    if (t + 1 < 9)                     // next tap's buffer was freed at t-1
      stage_weights(p, (t & 1) ? s_w0 : s_w1, t + 1, co0, ncol, vec_w, tid);
    mma_tap(p, wtile, acc, s_in, s_w, t);
    if (vec_w) cp_async_wait_all();
    __syncthreads();                   // next buffer landed, this one free
  }

  // ---- epilogue through shared memory (aliases the operand region)
  epi.epilogue(p, wtile, acc, reinterpret_cast<float*>(smem),
               smem + p.off_hook, n, d, h0, w0, co0, BN, ncol, tid);
}

template <class Hook>
static size_t smem_bytes(Params& p, const Hook& hook, int TH, int bn_max) {
  const size_t in_bytes = (size_t)(TH + 2) * p.Ws * p.Cp * sizeof(bf16);
  const size_t ep_bytes = (size_t)TH * p.WF * 16 * bn_max * sizeof(float);
  size_t region0 = in_bytes > ep_bytes ? in_bytes : ep_bytes;
  region0 = (region0 + 127) / 128 * 128;
  const size_t w_bytes = ((size_t)2 * bn_max * p.Cp * sizeof(bf16) + 127) /
                         128 * 128;
  p.off_w = (int)region0;
  p.off_tab = (int)(region0 + w_bytes);
  // table: pointer, info, mult, off per channel; two ints per unit, a count
  const size_t tab_bytes = ((size_t)p.Cs * (sizeof(void*) + 12) +
                            (size_t)(p.Cs / 8) * 8 + 4 + 127) / 128 * 128;
  p.off_hook = p.off_tab + (int)tab_bytes;
  p.TH = TH;
  return (size_t)p.off_hook + hook.smem_bytes(p);
}

// block tile: the widest W tile (fewest tiles of equal width) and then the
// most rows that fit shared memory, at most MPW row fragments per warp
template <int NG, int NFW, int MPW, class Hook>
static int launch(Params& p, const Hook& hook,
                  void (*kernel)(const Params, const Hook),
                  cudaStream_t stream) {
  const int tile = NG * NFW * 16;
  const int bn_max = min(tile, (p.CO + 15) / 16 * 16);
  const int max_frags = NWARPS / NG * MPW;
  const int wf_all = (p.W + 15) / 16;
  size_t smem = 0;
  int th_fit = 0;
  for (int wf = min(wf_all, max_frags); wf >= 1 && !th_fit; --wf) {
    p.n_wt = (wf_all + wf - 1) / wf;
    if ((wf_all + p.n_wt - 1) / p.n_wt != wf) continue;  // tiles unequal
    p.WF = wf;
    p.Ws = wf * 16 + 2;
    for (int th = min(p.H, max_frags / wf); th >= 1 && !th_fit; --th) {
      // a row stride of an odd number of 16-byte units puts the eight rows
      // of an ldmatrix in eight distinct bank groups; where that does not
      // fit, the unpadded stride (two-way conflicts)
      for (int cp : {p.Cs + 8, p.Cs}) {
        p.Cp = cp;
        smem = smem_bytes(p, hook, th, bn_max);
        if (smem <= SMEM_LIMIT) {
          th_fit = th;
          break;
        }
      }
    }
  }
  if (th_fit == 0) return (int)cudaErrorInvalidValue;
  Hook h = hook;
  smem += h.fit(p, SMEM_LIMIT - smem);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long n_blocks =
      (long long)p.N * p.D * ((p.H + p.TH - 1) / p.TH) * p.n_wt;
  if (n_blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)n_blocks, (p.CO + tile - 1) / tile);
  kernel<<<grid, NTHREADS, smem, stream>>>(p, h);
  return (int)cudaGetLastError();
}

// Params from the C entry points' arrays (one entry per part; groups as
// (c0, c1, shift) triples); a null part pointer marks a part the hook
// stages. Returns false on an invalid configuration.
static bool make_params(Params& p, const void* const* xs,
                        const void* const* mults, const void* const* offs,
                        const int* part_c, const int* part_vec, int nparts,
                        const int* groups, int ngroups, const void* w,
                        const void* b, void* y, void* stats, int N, int D,
                        int H, int W, int CO) {
  if (nparts < 1 || nparts > MAX_PARTS || ngroups < 1 ||
      ngroups > MAX_GROUPS || N < 1 || D < 1 || H < 1 || W < 1 || CO < 1)
    return false;
  int C = 0;
  for (int i = 0; i < MAX_PARTS; ++i) {
    const bool on = i < nparts;
    p.x[i] = on ? static_cast<const bf16*>(xs[i]) : nullptr;
    p.mult[i] = on ? static_cast<const float*>(mults[i]) : nullptr;
    p.off[i] = on ? static_cast<const float*>(offs[i]) : nullptr;
    p.pc[i] = on ? part_c[i] : 0;
    p.vec[i] = on ? part_vec[i] : 0;
    p.pc0[i] = C;
    C += p.pc[i];
  }
  p.nparts = nparts;
  for (int g = 0; g < MAX_GROUPS; ++g) {
    const bool on = g < ngroups;
    p.g0[g] = on ? groups[3 * g] : 0;
    p.g1[g] = on ? groups[3 * g + 1] : 0;
    p.gs[g] = on ? groups[3 * g + 2] : 0;
  }
  p.ngroups = ngroups;
  p.w = static_cast<const bf16*>(w);
  p.b = static_cast<const bf16*>(b);
  p.y = static_cast<bf16*>(y);
  p.stats = static_cast<float*>(stats);
  p.N = N; p.D = D; p.H = H; p.W = W; p.C = C; p.CO = CO;
  p.Cs = (C + 15) / 16 * 16;
  return true;
}
