// The shiftConvPP block machinery shared by the fused block (#1,
// fused_block.cu), the fused block with a lazy up-link part (#3,
// qfused.cu), the block's backward (fused_block_bwd.cu: its dgrad runs
// the whole body with its own hook and epilogue, its wgrad stage_operand
// alone) and the warp-specialised pipelined block (#13,
// fused_block_pipe.cu: the staging in its producer warpgroups, the
// K-chunked wgmma taps and the register epilogue in its consumer
// warpgroups), for NVIDIA Hopper (sm_90a), bfloat16.
//
// Staging (all of them): stage_operand_issue builds a per-channel table
// (source pointer of the shifted depth, pending norm) and issues the
// operand tile's copies by cp.async, 16 or 4 bytes per 8-channel unit where
// its channels share a source row, channel by channel otherwise, zeros
// where the shift or the halo leaves the volume; stage_operand_finish waits
// and applies the pending norms in place to the copied units only. Both run
// on the whole block; stage_operand_issue also, with a NamedSync, on one
// warpgroup (each of #13's producers, which run their own norm pass); the
// register epilogue likewise on the block or on #13's consumers.
//
// Two bodies run on it:
//  * shift_conv_block_body: the first design, kept for the dgrad, whose
//    hook and epilogue it runs: the whole operand per block, then per tap
//    mma_tap (ldmatrix + mma.sync.m16n8k16 over the tap's weights as (CO,
//    K) rows, double-buffered per tap), then the epilogue type's
//    epilogue() (the accumulators, shared memory that aliases the operand,
//    the hook's region). A kernel is
//      template <...> __global__ void k(const Params p, const Ops ops)
//      { shift_conv_block_body<NG, NFW, MPW>(p, ops, ops); }
//    and the hook adds a staging pass after the norms (hook.stage(),
//    shared memory at p.off_hook; a part with a null source pointer is
//    staged as zeros for the hook to fill).
//  * The K-chunked wgmma body of #1, #3 and #13 (#1 and #3: chunk_step,
//    materialised_chunks; #13: chunk_taps between its mbarriers; the
//    weights of #1 and #13 packed by pack_weights_kernel): the operand in
//    K chunks of at most 48 channels, each chunk's 9 taps on wgmma_taps
//    (wgmma.mma_async with A from registers by mma_tap's ldmatrix
//    addressing, B by descriptor from weights packed by wgmma_b_index,
//    straight-line code per chunk width and output width, n <= 48 with two
//    m64 tiles per warpgroup or n <= 96 with one), the next chunk's copies
//    in flight during this chunk's
//    wgmmas (across tiles too, in #1's persistent blocks; in #13 staged by
//    its producer warpgroups beside the consumers' wgmmas), and one
//    epilogue from the registers (store_tile_regs: y stored as bf16 pairs,
//    the statistics summed over the block). mma_taps_packed runs the same
//    products on mma.sync: the control that measures the wgmma loop.
// Both leave the sums in the same registers (acc[f][j][h][e]: row
// fragment f, 16 output channels j, 8-channel half h).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "bulk_copy.cuh"     // fence_proxy_async

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
  // halo rows of an H slab (spatial parallel): (N, D, 1, W, pc) raw rows
  // of the part just above row 0 (xt) and just below row H - 1 (xb), read
  // through the part's pending norm where the staging would zero-fill
  // row -1 / row H; null: zero fill (the volume's edge)
  const bf16* xt[MAX_PARTS];
  const bf16* xb[MAX_PARTS];
  int halo;                           // bit 0: some xt, bit 1: some xb
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

// Who meets at a barrier: the whole block (the default of the staging and
// the epilogue), or one role of a warp-specialised block at a named barrier
// (#13: each producer warpgroup, the consumer warpgroups)
struct BlockSync {
  static constexpr int threads = NTHREADS;
  __device__ __forceinline__ static void sync() { __syncthreads(); }
};
template <int ID, int THREADS>
struct NamedSync {
  static constexpr int threads = THREADS;
  __device__ __forceinline__ static void sync() {
    asm volatile("bar.sync %0, %1;\n" ::"n"(ID), "n"(THREADS) : "memory");
  }
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
// two 8x8 matrices, rows addressed by lanes 0-15
__device__ __forceinline__ void ldmatrix_x2(unsigned r[2], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
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

// visits the staged units (cell, 8-channel chunk k) of this thread of
// `nthreads` in order, stepping (k, col, row) without divisions
struct UnitWalk {
  int k, col, row, step_k, step_cell;
  __device__ UnitWalk(int tid, int KC8, int Ws, int nthreads = NTHREADS) {
    k = tid % KC8;
    const int cell = tid / KC8;
    col = cell % Ws;
    row = cell / Ws;
    step_k = nthreads % KC8;
    step_cell = nthreads / KC8;
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

// One 8-channel unit of a halo row (row -1 from xt, row H from xb) at
// column ww, channel by channel, its pending norms applied: each channel's
// (sample, source depth) and local channel come from its table entry (its
// offset from its part's base), the element from the halo row of that
// part, zero where the channel is zero or its part has no halo row there.
__device__ __forceinline__ uint4 halo_unit(const Params& p,
                                           const bf16* const* src,
                                           const int* info, const float* m,
                                           const float* o, bool top,
                                           int ww) {
  uint4 out;
  bf16* vals = reinterpret_cast<bf16*>(&out);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int ie = info[e];
    const int q = (ie >> 3) & 3;
    const bf16* row = ie < 0 ? nullptr : top ? p.xt[q] : p.xb[q];
    vals[e] = __float2bfloat16(0.0f);
    if (row == nullptr) continue;
    const size_t ci = (size_t)(ie >> 5);
    const size_t rel = (size_t)(src[e] - p.x[q]);
    const size_t plane = (size_t)p.H * p.W * ci;
    const size_t nd = rel / plane;     // n * D + source depth
    const bf16 v = row[(nd * p.W + ww) * ci + (rel - nd * plane)];
    vals[e] = (ie & 4) ? __float2bfloat16(norm_lrelu(__bfloat162float(v),
                                                     m[e], o[e]))
                       : v;
  }
  return out;
}

// First half of stage_operand: builds the per-channel table at `tab` and
// issues the staging of the operand into s_in as one committed cp.async
// group (units staged channel by channel, and zeros, are stored at once).
// Does not wait for the copies: stage_operand_finish (#13: producer_norms)
// does. Run by the threads of Sync (tid their index among them), which meet
// at its barrier.
template <class Sync = BlockSync>
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
  for (int c = tid; c < Cs; c += Sync::threads) {
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
  Sync::sync();
  for (int k = tid; k < KC8; k += Sync::threads) {
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
  Sync::sync();
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
  UnitWalk it(tid, KC8, Ws, Sync::threads);
  for (; it.row < rows; it.next(KC8, Ws)) {
    const int hh = h0 - 1 + it.row;
    const int ww = w0 - 1 + it.col;
    const int c0 = it.k * 8;
    const bool pix_ok = hh >= 0 && hh < p.H && ww >= 0 && ww < p.W;
    const int pix = pix_ok ? hh * p.W + ww : 0;
    bf16* dst = s_in + (size_t)(it.row * Ws + it.col) * Cp + c0;
    const int unit = s_unit[it.k];
    const int kind = unit & 3;
    if (p.halo && kind != UNIT_ZERO && ww >= 0 && ww < p.W &&
        ((hh == -1 && (p.halo & 1)) || (hh == p.H && (p.halo & 2)))) {
      *reinterpret_cast<uint4*>(dst) =
          halo_unit(p, s_src + c0, s_info + c0, s_m + c0, s_o + c0, hh < 0,
                    ww);
      continue;
    }
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

// The warp's share of a block tile computed by NW warps (tid / 32 the
// warp's index among them): row fragments wm + f*WPM (f < MPW) of the TH x
// WF grid of 16-pixel fragments, CO fragments ng*NFW + j (j < NFW) of the
// nf in the tile
template <int NG, int NFW, int MPW, int NW = NWARPS>
struct WarpTile {
  static constexpr int WPM = NW / NG;  // warps along M
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

// ---- The wgmma tap loop. A warpgroup (four consecutive warps) issues
// wgmma.mma_async.m64nNk16 with A (64 pixels x 16 channels) from registers
// and B (16 channels x N output channels) from shared memory through a
// matrix descriptor. A warp's 16 rows of A have the layout of mma.m16n8k16's
// A fragment, so mma_tap's ldmatrix at each tap's shifted row addresses
// feeds it unchanged: the tap's one-pixel offset is an address, which no
// descriptor could express. B is packed in the canonical K-major layout
// without swizzle (wgmma_b_index): 8 x 8 core matrices of 8 output channels
// by 8 channels, 128 contiguous bytes each, the two K halves of a 16-channel
// step LBO = 128 bytes apart, consecutive groups of 8 output channels
// SBO = 256 bytes apart. A warp's 16 rows of the accumulator have
// mma.m16n8's layout per 8 output channels, so they land in mma_tap's
// acc[f][j][h][e] and the epilogue is the same.

// element offset of (tap t, output channel n, channel k of the staged
// chunk) in the packed B of KS 16-channel steps and N8 groups of 8 output
// channels per tap; one core-matrix row (8 channels) is 16 contiguous bytes
__host__ __device__ inline int wgmma_b_index(int t, int n, int k, int KS,
                                             int N8) {
  return ((((t * KS + k / 16) * N8 + n / 8) * 2 + (k % 16) / 8) * 8 + n % 8) *
             8 + k % 8;
}

// The weights p.w of every (output-channel tile of 16 * NFW, K chunk of
// p.Cs channels) packed for wgmma (wgmma_b_index), each chunk contiguous at
// wpk + (ct * nch + ch) * w_bytes bytes, zero past CO and C: one bulk copy
// (cp.async.bulk, the Tensor Memory Accelerator) brings a chunk into
// shared memory, where 16-byte copies would take thousands of requests.
// Run before #1's and #13's kernels.
template <int NFW>
__global__ void pack_weights_kernel(const Params p, int n_co, int nch,
                                    int w_bytes, bf16* wpk) {
  const int KS = p.Cs / 16, KC8 = p.Cs / 8, rows = NFW * 16;
  const int total = n_co * nch * 9 * rows * KC8;
  for (int u = blockIdx.x * blockDim.x + threadIdx.x; u < total;
       u += gridDim.x * blockDim.x) {
    int rest = u;
    const int k8 = rest % KC8;
    rest /= KC8;
    const int n = rest % rows;
    rest /= rows;
    const int t = rest % 9;
    rest /= 9;
    const int ch = rest % nch, ct = rest / nch;
    const int co0 = ct * rows;
    const int ncol = min(rows, p.CO - co0), N8 = (ncol + 7) / 8;
    if (n >= N8 * 8) continue;
    bf16* dst = wpk + (size_t)(ct * nch + ch) * (w_bytes / 2) +
                wgmma_b_index(t, n, k8 * 8, KS, N8);
    const int k = ch * p.Cs + k8 * 8;
    const bf16* src = p.w + ((size_t)t * p.CO + co0 + n) * p.C + k;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      dst[e] = n < ncol && k + e < p.C ? src[e] : __float2bfloat16(0.0f);
  }
}

// descriptor of a packed B step at `smem`: start address, LBO 128 bytes,
// SBO 256 bytes, no swizzle
__device__ __forceinline__ uint64_t wgmma_desc(const void* smem) {
  const uint64_t addr = (uint64_t)__cvta_generic_to_shared(smem);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// holds A registers that an issued wgmma still reads until this point (the
// compiler sees the wgmma's use end with the asm statement)
__device__ __forceinline__ void keep_live(const unsigned a[4]) {
  asm volatile("" ::"r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]));
}

// d (4 * N8 floats) += a (this warp's 16 rows x 16, registers) * B (16 x
// 8 * N8, descriptor), one m64 tile of the warpgroup
template <int N8>
struct WgmmaRS;
template <>
struct WgmmaRS<1> {
  __device__ __forceinline__ static void mma(float* d, const unsigned a[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <>
struct WgmmaRS<2> {
  __device__ __forceinline__ static void mma(float* d, const unsigned a[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <>
struct WgmmaRS<3> {
  __device__ __forceinline__ static void mma(float* d, const unsigned a[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11}, "
        "{%12, %13, %14, %15}, %16, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <>
struct WgmmaRS<4> {
  __device__ __forceinline__ static void mma(float* d, const unsigned a[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <>
struct WgmmaRS<5> {
  __device__ __forceinline__ static void mma(float* d, const unsigned a[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19}, "
        "{%20, %21, %22, %23}, %24, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <>
struct WgmmaRS<6> {
  __device__ __forceinline__ static void mma(float* d, const unsigned a[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23}, "
        "{%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <>
struct WgmmaRS<7> {
  __device__ __forceinline__ static void mma(float* d, const unsigned a[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27}, "
        "{%28, %29, %30, %31}, %32, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <>
struct WgmmaRS<8> {
  __device__ __forceinline__ static void mma(float* d, const unsigned a[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <>
struct WgmmaRS<9> {
  __device__ __forceinline__ static void mma(float* d, const unsigned a[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35}, "
        "{%36, %37, %38, %39}, %40, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <>
struct WgmmaRS<10> {
  __device__ __forceinline__ static void mma(float* d, const unsigned a[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39}, "
        "{%40, %41, %42, %43}, %44, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <>
struct WgmmaRS<11> {
  __device__ __forceinline__ static void mma(float* d, const unsigned a[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %49, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n88k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43}, "
        "{%44, %45, %46, %47}, %48, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <>
struct WgmmaRS<12> {
  __device__ __forceinline__ static void mma(float* d, const unsigned a[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47}, "
        "{%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

// pins the accumulators' definitions before and their uses after the
// wgmma pipeline (no other instruction may define them inside it)
template <int MPW, int NFW>
__device__ __forceinline__ void wgmma_fence_acc(float acc[MPW][NFW][2][4]) {
#pragma unroll
  for (int f = 0; f < MPW; ++f)
#pragma unroll
    for (int j = 0; j < NFW; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          asm volatile("" : "+f"(acc[f][j][h][e])::"memory");
}

// one (tap, 16-channel step) of wgmma_taps: A of each issued tile by
// ldmatrix at the tap's offset, then one commit group
template <int MPW, int NFW, int N8>
__device__ __forceinline__ void wgmma_step(float acc[MPW][NFW][2][4],
                                           unsigned a[MPW][4],
                                           const unsigned a_addr[MPW],
                                           const unsigned char* s_w, int s,
                                           int KS, int Ws, int Cp) {
  const int t = s / KS, ks = s - t * KS;
  const int off = ((t / 3 - 1) * Ws + t % 3 - 1) * Cp + ks * 16;
#pragma unroll
  for (int f = 0; f < MPW; ++f) ldmatrix_x4(a[f], a_addr[f] + off * 2);
  wgmma_fence();
  const uint64_t desc = wgmma_desc(s_w + (size_t)(t * KS + ks) * N8 * 256);
#pragma unroll
  for (int f = 0; f < MPW; ++f)
    WgmmaRS<N8>::mma(&acc[f][0][0][0], a[f], desc);
  wgmma_commit();
}

// acc += the products of all 9 taps over the KS*16 staged channels on
// wgmma, for a warp tile of one warp column (NG = 1) and N = 8 * N8 <=
// 16 * NFW output channels (NFW = 3: n48, two m64 tiles per warpgroup;
// NFW = 6: n96, one m64 tile): the operand at s_in as stage_operand
// stages it, the 9 taps' weights at s_w packed by wgmma_b_index. Warpgroup
// g issues m64 tile f over the row fragments 16f + 4g .. 16f + 4g + 3 (one
// per warp, WarpTile's); a warp whose own fragment is not in the block
// reads fragment 0's rows, and its sums are never stored (no branch around
// a wgmma: ptxas serialises wgmmas on a path it cannot prove uniform). One
// commit group per (tap, step), the next step's A loaded and its wgmmas
// issued while it runs: the 9 * KS steps are straight-line code, with no
// branch or loop edge while a group is in flight, which ptxas would
// serialise. Returns with every product done.
template <int MPW, int NFW, int N8, int KS, int NW>
__device__ __forceinline__ void wgmma_taps(const Params& p,
                                           const WarpTile<1, NFW, MPW, NW>& wt,
                                           float acc[MPW][NFW][2][4],
                                           const bf16* s_in,
                                           const bf16* s_w) {
  const int Cp = p.Cp, Ws = p.Ws;
  const int lane = wt.lane;
  const int a_row = lane % 16, a_k = (lane / 16) * 8;
  unsigned a_addr[MPW];
#pragma unroll
  for (int f = 0; f < MPW; ++f) {
    const int th = wt.on[f] ? wt.th[f] : 0, w = wt.on[f] ? wt.w[f] : 0;
    a_addr[f] = (unsigned)__cvta_generic_to_shared(
        s_in + ((size_t)(th + 1) * Ws + w + 1 + a_row) * Cp + a_k);
  }
  const unsigned char* sw = reinterpret_cast<const unsigned char*>(s_w);
  unsigned a0[MPW][4], a1[MPW][4];
#pragma unroll
  for (int f = 0; f < MPW; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) a0[f][e] = a1[f][e] = 0u;
  wgmma_fence_acc<MPW, NFW>(acc);
#pragma unroll
  for (int s = 0; s < 9 * KS; ++s) {
    wgmma_step<MPW, NFW, N8>(acc, (s & 1) ? a1 : a0, a_addr, sw, s, KS, Ws,
                             Cp);
    wgmma_wait<1>();                   // step s - 1 done: its A free
#pragma unroll
    for (int f = 0; f < MPW; ++f) keep_live((s & 1) ? a0[f] : a1[f]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int f = 0; f < MPW; ++f) {
    keep_live(a0[f]);
    keep_live(a1[f]);
  }
  wgmma_fence_acc<MPW, NFW>(acc);
}

// The control that measures wgmma_taps: the same products, operand and
// packed weights on mma.sync, each warp over its own row fragments. The
// four 8 x 8 core matrices of two consecutive groups of 8 output channels
// in a step (both K halves) are 512 contiguous bytes, so one ldmatrix_x4
// at 16 bytes per lane gives two groups' B fragments.
template <int MPW, int NFW, int NW>
__device__ __forceinline__ void mma_taps_packed(
    const Params& p, const WarpTile<1, NFW, MPW, NW>& wt,
    float acc[MPW][NFW][2][4], const bf16* s_in, const bf16* s_w, int KS,
    int N8) {
  const int Cp = p.Cp, Ws = p.Ws;
  const int lane = wt.lane;
  const int a_row = lane % 16, a_k = (lane / 16) * 8;
  unsigned a_addr[MPW];
#pragma unroll
  for (int f = 0; f < MPW; ++f) {
    const int th = wt.on[f] ? wt.th[f] : 0, w = wt.on[f] ? wt.w[f] : 0;
    a_addr[f] = (unsigned)__cvta_generic_to_shared(
        s_in + ((size_t)(th + 1) * Ws + w + 1 + a_row) * Cp + a_k);
  }
  const unsigned b_base = (unsigned)__cvta_generic_to_shared(s_w) + lane * 16;
  for (int s = 0; s < 9 * KS; ++s) {
    const int t = s / KS, ks = s - t * KS;
    const int off = ((t / 3 - 1) * Ws + t % 3 - 1) * Cp + ks * 16;
    unsigned a[MPW][4];
#pragma unroll
    for (int f = 0; f < MPW; ++f) ldmatrix_x4(a[f], a_addr[f] + off * 2);
    const unsigned b_step = b_base + (t * KS + ks) * N8 * 256;
#pragma unroll
    for (int j = 0; j < NFW; ++j) {
      if (2 * j >= N8) continue;
      unsigned b[4];
      if (2 * j + 1 < N8)
        ldmatrix_x4(b, b_step + j * 512);
      else
        ldmatrix_x2(b, b_step + j * 512);
#pragma unroll
      for (int f = 0; f < MPW; ++f) {
        mma_16816(acc[f][j][0], a[f], b[0], b[1]);
        if (2 * j + 1 < N8) mma_16816(acc[f][j][1], a[f], b[2], b[3]);
      }
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

// ---- The K-chunked wgmma body of the fused block (#1, fused_block.cu) and
// the lazy up-link block (#3, qfused.cu). A block tile's operand is staged
// in K chunks of p.Cs <= 48 channels, each chunk's 9 taps accumulating into
// the same registers. A chunk step waits for its chunk's copies, applies the
// pending norms, issues the NEXT chunk's copies into the other operand
// buffer (and, where they do not stay resident, its weights), and then runs
// this chunk's taps on wgmma, so the next copies land while the products
// run. After a tile's last chunk the next copies are those of the first
// chunk of the block's next tile: #1's blocks are persistent, #3's compute
// one tile each.

// wgmma_taps for the chunk's KS steps and the tile's n8 groups of 8 output
// channels (n8 <= 2 * NFW): one straight-line instantiation each
template <int MPW, int NFW, int KS, int NW>
__device__ __forceinline__ void wgmma_taps_n8(
    const Params& p, const WarpTile<1, NFW, MPW, NW>& wt,
    float acc[MPW][NFW][2][4], const bf16* s_op, const bf16* s_w, int n8) {
  switch (n8) {
    case 1: wgmma_taps<MPW, NFW, 1, KS>(p, wt, acc, s_op, s_w); break;
    case 2: wgmma_taps<MPW, NFW, 2, KS>(p, wt, acc, s_op, s_w); break;
    case 3: wgmma_taps<MPW, NFW, 3, KS>(p, wt, acc, s_op, s_w); break;
    case 4: wgmma_taps<MPW, NFW, 4, KS>(p, wt, acc, s_op, s_w); break;
    case 5: wgmma_taps<MPW, NFW, 5, KS>(p, wt, acc, s_op, s_w); break;
    default:
      if constexpr (NFW == 3) {
        wgmma_taps<MPW, NFW, 6, KS>(p, wt, acc, s_op, s_w);
      } else {
        switch (n8) {
          case 6: wgmma_taps<MPW, NFW, 6, KS>(p, wt, acc, s_op, s_w); break;
          case 7: wgmma_taps<MPW, NFW, 7, KS>(p, wt, acc, s_op, s_w); break;
          case 8: wgmma_taps<MPW, NFW, 8, KS>(p, wt, acc, s_op, s_w); break;
          case 9: wgmma_taps<MPW, NFW, 9, KS>(p, wt, acc, s_op, s_w); break;
          case 10: wgmma_taps<MPW, NFW, 10, KS>(p, wt, acc, s_op, s_w); break;
          case 11: wgmma_taps<MPW, NFW, 11, KS>(p, wt, acc, s_op, s_w); break;
          default: wgmma_taps<MPW, NFW, 12, KS>(p, wt, acc, s_op, s_w);
        }
      }
  }
}

// the 9 taps over the staged chunk at s_op: on wgmma (WGMMA), else on
// mma.sync over the same packed weights (mma_taps_packed, the control)
template <int MPW, int NFW, bool WGMMA, int NW>
__device__ __forceinline__ void chunk_taps(const Params& p,
                                           const WarpTile<1, NFW, MPW, NW>& wt,
                                           float acc[MPW][NFW][2][4],
                                           const bf16* s_op, const bf16* s_w,
                                           int N8) {
  const int KS = p.Cs / 16;
  if constexpr (WGMMA) {
    if (KS == 1)
      wgmma_taps_n8<MPW, NFW, 1>(p, wt, acc, s_op, s_w, N8);
    else if (KS == 2)
      wgmma_taps_n8<MPW, NFW, 2>(p, wt, acc, s_op, s_w, N8);
    else
      wgmma_taps_n8<MPW, NFW, 3>(p, wt, acc, s_op, s_w, N8);
  } else {
    mma_taps_packed<MPW, NFW>(p, wt, acc, s_op, s_w, KS, N8);
  }
}

// One chunk step: wait for the chunk's copies (and its weights'), apply its
// pending norms (stage_operand_finish), staged() (#3: the up-link into the
// staged chunk), next() (issue the next chunk's copies into the other
// buffer), then the chunk's taps. Returns with every product done.
template <int MPW, int NFW, bool WGMMA, class Staged, class Next>
__device__ __forceinline__ void chunk_step(
    const Params& p, const WarpTile<1, NFW, MPW>& wt,
    float acc[MPW][NFW][2][4], unsigned char* smem, bf16* s_op,
    const bf16* s_w, unsigned char* tab, int n, int d, int h0, int w0,
    int N8, int tid, const Staged& staged, const Next& next) {
  cp_async_wait_all();
  fence_proxy_async();                 // the weights, for wgmma
  stage_operand_finish(p, NoHook(), smem, s_op, tab, n, d, h0, w0, tid);
  staged();
  next();
  chunk_taps<MPW, NFW, WGMMA>(p, wt, acc, s_op, s_w, N8);
}

// The materialised chunks ch = 0 .. nch-1 (concat channels ch*p.Cs ..) of
// one block tile, in the operand buffers op0 (buf 0) and op1 (buf 1) in
// turn from buf, the first one's copies issued already. Per chunk:
// stage_w(ch, buf) gives the chunk's packed weights (staging them if need
// be), a chunk step whose next() issues the next chunk's weights and copies
// (issue(ch + 1, the other buffer, buf ^ 1)), or after the last chunk
// next_tile(the other buffer, buf ^ 1). Leaves buf at the buffer of the
// next copies.
template <int MPW, int NFW, bool WGMMA, class StageW, class Issue,
          class NextTile>
__device__ __forceinline__ void materialised_chunks(
    const Params& p, const WarpTile<1, NFW, MPW>& wt,
    float acc[MPW][NFW][2][4], unsigned char* smem, bf16* op0, bf16* op1,
    int& buf, unsigned char* tab, int n, int d, int h0, int w0, int N8,
    int nch, int tid, const StageW& stage_w, const Issue& issue,
    const NextTile& next_tile) {
  for (int ch = 0; ch < nch; ++ch) {
    bf16* s_op = buf ? op1 : op0;
    bf16* s_next = buf ? op0 : op1;
    const bf16* s_w = stage_w(ch, buf);
    chunk_step<MPW, NFW, WGMMA>(
        p, wt, acc, smem, s_op, s_w, tab, n, d, h0, w0, N8, tid, [] {},
        [&] {
          if (ch + 1 < nch)
            issue(ch + 1, s_next, buf ^ 1);
          else
            next_tile(s_next, buf ^ 1);
        });
    buf ^= 1;
  }
}

// The epilogue of one block tile from the registers, with no tile in shared
// memory (so it runs while the next tile's copies land): the bias (bf16),
// y stored as bf16 pairs, and the statistics of the f32 values summed
// over each warp's pixels by shuffles, then over the NW warps in `red`
// (2 * NW * BN floats), before one atomic pair per output channel and
// block. Run by the threads of Sync (tid their index among them), the NW
// warps of the tile.
template <int MPW, int NFW, class Sync = BlockSync, int NW = NWARPS>
__device__ __forceinline__ void store_tile_regs(
    const Params& p, const WarpTile<1, NFW, MPW, NW>& wt,
    float acc[MPW][NFW][2][4], int n, int d, int h0, int w0, int co0,
    int BN, int ncol, int tid, float* red) {
  const int lane = wt.lane;
  bf16* y_slice = p.y + (size_t)(n * p.D + d) * p.H * p.W * p.CO + co0;
  const bool pairs = p.CO % 2 == 0;
  int px[MPW][2];                      // this lane's pixels, or -1
#pragma unroll
  for (int f = 0; f < MPW; ++f)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int h = h0 + wt.th[f], w = w0 + wt.w[f] + lane / 4 + 8 * r;
      px[f][r] = wt.on[f] && h < p.H && w < p.W ? h * p.W + w : -1;
    }
#pragma unroll
  for (int j = 0; j < NFW; ++j) {
    if (!wt.nf_on[j]) continue;        // warp-uniform
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = j * 16 + h * 8 + (lane % 4) * 2;
      const float b0 = col < ncol ? __bfloat162float(p.b[co0 + col]) : 0.0f;
      const float b1 =
          col + 1 < ncol ? __bfloat162float(p.b[co0 + col + 1]) : 0.0f;
      float s1[2] = {0.0f, 0.0f}, s2[2] = {0.0f, 0.0f};
#pragma unroll
      for (int f = 0; f < MPW; ++f)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (px[f][r] < 0) continue;
          const float v0 = acc[f][j][h][2 * r] + b0;
          const float v1 = acc[f][j][h][2 * r + 1] + b1;
          bf16* dst = y_slice + (size_t)px[f][r] * p.CO + col;
          if (pairs && col + 1 < ncol) {
            *reinterpret_cast<__nv_bfloat162*>(dst) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            if (col < ncol) dst[0] = __float2bfloat16(v0);
            if (col + 1 < ncol) dst[1] = __float2bfloat16(v1);
          }
          s1[0] += v0;
          s2[0] += v0 * v0;
          s1[1] += v1;
          s2[1] += v1 * v1;
        }
#pragma unroll
      for (int m = 4; m < 32; m *= 2)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s1[e] += __shfl_xor_sync(0xffffffffu, s1[e], m);
          s2[e] += __shfl_xor_sync(0xffffffffu, s2[e], m);
        }
      if (lane < 4) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          red[wt.wm * BN + col + e] = s1[e];
          red[(NW + wt.wm) * BN + col + e] = s2[e];
        }
      }
    }
  }
  Sync::sync();
  if (tid < ncol) {
    float s1 = 0.0f, s2 = 0.0f;
    for (int m = 0; m < WarpTile<1, NFW, MPW, NW>::WPM; ++m) {
      s1 += red[m * BN + tid];
      s2 += red[(NW + m) * BN + tid];
    }
    atomicAdd(&p.stats[((size_t)n * p.CO + co0 + tid) * 2], s1);
    atomicAdd(&p.stats[((size_t)n * p.CO + co0 + tid) * 2 + 1], s2);
  }
}

template <int NG, int NFW, int MPW, class Hook, class Epilogue>
__device__ __forceinline__ void shift_conv_block_body(
    const Params& p, const Hook& hook, const Epilogue& epi) {
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

  // ---- the epilogue: shared memory at s_acc aliases the operand region,
  // and it may use the hook's region
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
// The halo rows of each part (null arrays or entries: none), after
// make_params
static void set_halo(Params& p, const void* const* xts,
                     const void* const* xbs) {
  for (int i = 0; i < p.nparts; ++i) {
    p.xt[i] = xts ? static_cast<const bf16*>(xts[i]) : nullptr;
    p.xb[i] = xbs ? static_cast<const bf16*>(xbs[i]) : nullptr;
    p.halo |= (p.xt[i] != nullptr ? 1 : 0) | (p.xb[i] != nullptr ? 2 : 0);
  }
}

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
    p.xt[i] = nullptr;
    p.xb[i] = nullptr;
    p.pc[i] = on ? part_c[i] : 0;
    p.vec[i] = on ? part_vec[i] : 0;
    p.pc0[i] = C;
    C += p.pc[i];
  }
  p.nparts = nparts;
  p.halo = 0;
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
