// Matrix product on the tensor cores for NVIDIA Hopper (sm_90a):
// C = A @ B for row-major A (M, K) and B (K, N), bf16 x bf16 -> float32 and
// int8 x int8 -> int32.
//
// Replaces the Pallas TPU kernel of experiments/exp_int8_mxu.py (the inline
// `kernel` of `main`: (512, K) x (K, 512) blocks, jnp.dot with f32 or int32
// accumulation), which measured what int8 products deliver against bf16.
//
// What bounds it on this card: at M = N = K = 4096 the tensor cores (137.4
// GOP; 0.139 ms at bf16's 989 TFLOP/s, 0.069 ms at int8's 1,979 TOP/s
// dense), far above the bytes (~100 MB, 0.03 ms). Only wgmma reaches that
// rate; mma.sync, fed by ldmatrix from tiles that every thread copies in,
// spends the issue slots on addresses and copies.
//
// Two routes, chosen by shape alone (mma_gemm_wgmma_ok):
//  * wgmma (the main route): where TMA can describe the operands, that is
//    16-byte-aligned pointers and row strides (bf16: K and N multiples of
//    8; int8: K a multiple of 16, since B is repacked). Persistent blocks
//    of three warpgroups, one per SM, walk the 128 x 256 tiles of C.
//    Warpgroup 0 is the producer: one thread keeps a 4-stage ring of 48 KB
//    stages full with TMA loads (cp.async.bulk.tensor into
//    128-byte-swizzled tiles, completion on a full mbarrier per stage,
//    reuse gated by an empty mbarrier), and gives its registers away
//    (setmaxnreg). Warpgroups 1 and 2 each own 64 rows
//    x 256 columns: per stage 4 wgmma.mma_async.m64n256 (k16 bf16, k32 s8)
//    with A and B read by descriptor, one wgmma group left in flight while
//    the previous stage is released. The accumulators (128 per thread) are
//    stored from the registers, float32 or int32, while the producer
//    already loads the next tile's stages. bf16 B is read as it is,
//    (K, N) row-major, through the descriptor's transpose bit (MN-major);
//    s8 operands must be K-major, so a small kernel first repacks B to
//    (N, K) in a scratch tensor the wrapper allocates, and its time is part
//    of every call. The tensor maps are encoded on the host with the
//    driver's cuTensorMapEncodeTiled, fetched through the runtime
//    (cudaGetDriverEntryPoint): no driver library is linked. TMA zero-fills
//    the ragged edges of M, N and K; the epilogue masks its stores.
//  * mma.sync (other shapes, and the control at any shape): one block of 8
//    warps per 128 x 128 tile, a K loop over 64-byte slices in a 3-stage
//    cp.async ring, ldmatrix(.trans) into mma.sync.m16n8k16 / m16n8k32;
//    int8 B transposed in registers with byte permutes; scalar copies where
//    rows are not 16-byte aligned.
//
// What still holds the wgmma route back (estimates from the shapes, not
// profiled): every block reads its A and B stages from L2, 48 KB per k
// step of its tile, about 12 TB/s across the card at the tensor cores'
// peak; a cluster of two blocks sharing one operand by TMA multicast would
// halve that. The epilogue's stores from the registers do not overlap the
// same warpgroups' next products, and the int8 route also pays the repack
// of B.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tma.cuh"         // tensor maps, TMA loads, desc_sw128; mbarriers

#define GEMM_BM 128
#define GEMM_BN 128
#define GEMM_THREADS 256
#define GEMM_STAGES 3
#define ROW_BYTES 80                   // 64 bytes of k + 16 of padding
#define A_BYTES (GEMM_BM * ROW_BYTES)
#define B16_STRIDE (GEMM_BN + 8)       // bf16 B rows: 136 values, 272 bytes
#define B_BYTES (GEMM_BN * ROW_BYTES)  // >= 32 * B16_STRIDE * 2
#define STAGE_BYTES (A_BYTES + B_BYTES)

__device__ __forceinline__ void cp_async16_n(void* smem, const void* gmem,
                                             int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldsm_x4(unsigned r[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned r[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void mma_bf16(float d[4], const unsigned a[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_s8(int d[4], const unsigned a[4],
                                       unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16 values are handled as their 16-bit patterns, int8 as bytes
template <bool INT8>
struct Elem {
  typedef typename std::conditional<INT8, int8_t, uint16_t>::type T;
  typedef typename std::conditional<INT8, int, float>::type Acc;
  static constexpr int SIZE = INT8 ? 1 : 2;
  static constexpr int BK = 64 / SIZE;       // values of k per slice
  static constexpr int PER16 = 16 / SIZE;    // values per 16-byte unit
};

struct GemmArgs {
  const void* a;
  const void* b;
  void* c;
  int M, N, K;
  int vec_a, vec_b;                    // rows are 16-byte aligned units
};

// A's slice kt: 128 rows x 64 bytes into the stage
template <bool INT8>
__device__ __forceinline__ void load_a(const GemmArgs& g, unsigned char* s_a,
                                       int m0, int kt, int tid) {
  typedef Elem<INT8> E;
  const typename E::T* a = static_cast<const typename E::T*>(g.a);
  const int k0 = kt * E::BK;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int u = tid + i * GEMM_THREADS;    // 512 units of 16 bytes
    const int row = u / 4, cu = u % 4;
    const int m = m0 + row, k = k0 + cu * E::PER16;
    unsigned char* dst = s_a + row * ROW_BYTES + cu * 16;
    if (g.vec_a) {
      const int n_ok = m < g.M ? max(0, min(E::PER16, g.K - k)) : 0;
      cp_async16_n(dst, n_ok ? (const void*)(a + (size_t)m * g.K + k) : g.a,
                   n_ok * E::SIZE);
    } else {
      typename E::T* d = reinterpret_cast<typename E::T*>(dst);
#pragma unroll
      for (int e = 0; e < E::PER16; ++e)
        d[e] = (m < g.M && k + e < g.K) ? a[(size_t)m * g.K + k + e]
                                        : (typename E::T)0;
    }
  }
}

// bf16 B's slice kt: 32 rows of k x 128 n, k-major, into the stage
__device__ __forceinline__ void load_b16(const GemmArgs& g,
                                         unsigned char* s_b, int n0, int kt,
                                         int tid) {
  const uint16_t* b = static_cast<const uint16_t*>(g.b);
  const int k0 = kt * 32;
  uint16_t* sb = reinterpret_cast<uint16_t*>(s_b);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int u = tid + i * GEMM_THREADS;    // 32 rows x 16 units
    const int row = u / 16, cu = u % 16;
    const int k = k0 + row, n = n0 + cu * 8;
    uint16_t* dst = sb + row * B16_STRIDE + cu * 8;
    if (g.vec_b) {
      const int n_ok = k < g.K ? max(0, min(8, g.N - n)) : 0;
      cp_async16_n(dst, n_ok ? (const void*)(b + (size_t)k * g.N + n) : g.b,
                   n_ok * 2);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = (k < g.K && n + e < g.N) ? b[(size_t)k * g.N + n + e]
                                          : (uint16_t)0;
    }
  }
}

// int8 B's slice: 64 k x 128 n as 16 x 32 blocks of 4 x 4 bytes, two per
// thread; w[i][r] holds row k + r, bytes n .. n+3. A warp takes 8 blocks
// along n (each row read as 32 contiguous bytes) by 4 along k, so that its
// transposed stores, 80 bytes apart per n, spread over 8 banks, not 2.
__device__ __forceinline__ void block_kn(int blk, int& bk, int& bn) {
  const int lane = blk % 32, w = blk / 32;
  bn = (w % 4) * 8 + lane % 8;
  bk = (w / 4) * 4 + lane / 8;
}
struct BRegs8 {
  unsigned w[2][4];
  __device__ __forceinline__ void load(const GemmArgs& g, int n0, int kt,
                                       int tid) {
    const int8_t* b = static_cast<const int8_t*>(g.b);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int bk, bn;
      block_kn(tid + i * GEMM_THREADS, bk, bn);
      const int k = kt * 64 + bk * 4, n = n0 + bn * 4;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const bool row_ok = k + r < g.K;
        if (g.vec_b) {               // N % 4 == 0: the word is in or out
          w[i][r] = (row_ok && n < g.N)
                        ? __ldg(reinterpret_cast<const unsigned*>(
                              b + (size_t)(k + r) * g.N + n))
                        : 0u;
        } else {
          unsigned v = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (row_ok && n + e < g.N)
              v |= (unsigned)(uint8_t)b[(size_t)(k + r) * g.N + n + e]
                   << (8 * e);
          w[i][r] = v;
        }
      }
    }
  }
  // transposed: column e (n + e) as the 4 bytes of k .. k+3, n-major rows
  __device__ __forceinline__ void store(unsigned char* s_b, int tid) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int bk, bn;
      block_kn(tid + i * GEMM_THREADS, bk, bn);
      const int kk = bk * 4, nn = bn * 4;
      const unsigned t0 = __byte_perm(w[i][0], w[i][1], 0x5140);
      const unsigned t1 = __byte_perm(w[i][0], w[i][1], 0x7362);
      const unsigned t2 = __byte_perm(w[i][2], w[i][3], 0x5140);
      const unsigned t3 = __byte_perm(w[i][2], w[i][3], 0x7362);
      const unsigned col[4] = {__byte_perm(t0, t2, 0x5410),
                               __byte_perm(t0, t2, 0x7632),
                               __byte_perm(t1, t3, 0x5410),
                               __byte_perm(t1, t3, 0x7632)};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        *reinterpret_cast<unsigned*>(s_b + (nn + e) * ROW_BYTES + kk) =
            col[e];
    }
  }
};

template <bool INT8>
__global__ void __launch_bounds__(GEMM_THREADS)
mma_gemm_kernel(const GemmArgs g) {
  typedef Elem<INT8> E;
  typedef typename E::Acc Acc;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;     // 2 x 4 warps of 64 x 32
  const int m0 = blockIdx.y * GEMM_BM, n0 = blockIdx.x * GEMM_BN;
  const int KT = (g.K + E::BK - 1) / E::BK;
  auto s_a = [&](int st) { return smem + st * STAGE_BYTES; };
  auto s_b = [&](int st) { return smem + st * STAGE_BYTES + A_BYTES; };

  Acc acc[4][4][4];
#pragma unroll
  for (int f = 0; f < 4; ++f)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][j][e] = 0;

  BRegs8 br;
  // ---- the first STAGES-1 slices
#pragma unroll
  for (int st = 0; st < GEMM_STAGES - 1; ++st) {
    if (st < KT) {
      load_a<INT8>(g, s_a(st), m0, st, tid);
      if constexpr (INT8) {
        br.load(g, n0, st, tid);
        br.store(s_b(st), tid);
      } else {
        load_b16(g, s_b(st), n0, st, tid);
      }
    }
    commit_group();
  }

  for (int kt = 0; kt < KT; ++kt) {
    wait_group<GEMM_STAGES - 2>();
    __syncthreads();                 // slice kt landed; slice kt-1's stage free
    const int nxt = kt + GEMM_STAGES - 1;
    const int st_n = nxt % GEMM_STAGES;
    if (nxt < KT) {
      load_a<INT8>(g, s_a(st_n), m0, nxt, tid);
      if constexpr (INT8) br.load(g, n0, nxt, tid);
      else load_b16(g, s_b(st_n), n0, nxt, tid);
    }
    commit_group();

    const int st = kt % GEMM_STAGES;
    const unsigned a_base = (unsigned)__cvta_generic_to_shared(s_a(st));
    const unsigned b_base = (unsigned)__cvta_generic_to_shared(s_b(st));
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {          // two 32-byte k steps
      unsigned a[4][4], b[4][2];
#pragma unroll
      for (int f = 0; f < 4; ++f)
        ldsm_x4(a[f], a_base + (wm * 64 + f * 16 + lane % 16) * ROW_BYTES +
                          ks * 32 + (lane / 16) * 16);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        unsigned r[4];
        if constexpr (INT8) {
          ldsm_x4(r, b_base + (wn * 32 + jj * 16 + lane % 8 +
                               (lane / 16) * 8) * ROW_BYTES +
                         ks * 32 + ((lane / 8) % 2) * 16);
        } else {
          ldsm_x4_trans(r, b_base + ((ks * 16 + lane % 8 +
                                      ((lane / 8) % 2) * 8) * B16_STRIDE +
                                     wn * 32 + jj * 16 + (lane / 16) * 8) *
                                        2);
        }
        b[2 * jj][0] = r[0];
        b[2 * jj][1] = r[1];
        b[2 * jj + 1][0] = r[2];
        b[2 * jj + 1][1] = r[3];
      }
#pragma unroll
      for (int f = 0; f < 4; ++f)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (INT8) mma_s8(acc[f][j], a[f], b[j][0], b[j][1]);
          else mma_bf16(acc[f][j], a[f], b[j][0], b[j][1]);
        }
    }
    // int8 B: the slice loaded above, into the stage freed at the top
    if constexpr (INT8)
      if (nxt < KT) br.store(s_b(st_n), tid);
  }

  // ---- store: rows lane/4 and lane/4 + 8, columns 2*(lane%4) + 0, 1
  Acc* c = static_cast<Acc*>(g.c);
  const bool pairs = g.N % 2 == 0;
#pragma unroll
  for (int f = 0; f < 4; ++f)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 64 + f * 16 + lane / 4 + h * 8;
        const int n = n0 + wn * 32 + j * 8 + (lane % 4) * 2;
        if (m >= g.M) continue;
        Acc* dst = c + (size_t)m * g.N + n;
        if (pairs && n + 1 < g.N) {
          if constexpr (INT8)
            *reinterpret_cast<int2*>(dst) =
                make_int2(acc[f][j][2 * h], acc[f][j][2 * h + 1]);
          else
            *reinterpret_cast<float2*>(dst) =
                make_float2(acc[f][j][2 * h], acc[f][j][2 * h + 1]);
        } else {
          if (n < g.N) dst[0] = acc[f][j][2 * h];
          if (n + 1 < g.N) dst[1] = acc[f][j][2 * h + 1];
        }
      }
}

template <bool INT8>
static int launch_gemm(const GemmArgs& g, cudaStream_t stream) {
  auto kernel = mma_gemm_kernel<INT8>;
  const int smem = GEMM_STAGES * STAGE_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long gy = (g.M + GEMM_BM - 1) / GEMM_BM;
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((g.N + GEMM_BN - 1) / GEMM_BN, (unsigned)gy);
  kernel<<<grid, GEMM_THREADS, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

// ===========================================================================
// The wgmma route

#define WG_BM 128
#define WG_BN 256
#define WG_BK_BYTES 128                  // k per stage: 64 bf16 or 128 s8
#define WG_STAGES 4
#define WG_THREADS 384                   // the producer and two consumers
#define WG_A_BYTES (WG_BM * WG_BK_BYTES)     // 16 KB
#define WG_B_BYTES (WG_BN * WG_BK_BYTES)     // 32 KB
#define WG_STAGE_BYTES (WG_A_BYTES + WG_B_BYTES)
// the stages, 1024-byte aligned for the 128-byte swizzle, then 2 x STAGES
// mbarriers
#define WG_SMEM (1024 + WG_STAGES * WG_STAGE_BYTES + 2 * WG_STAGES * 8)

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

#define WG_REGS                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "    \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "    \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "    \
  "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "    \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "    \
  "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "    \
  "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "   \
  "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "   \
  "%127}"
#define WG_D4(c, i) c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3])
#define WG_D16(c, i) \
  WG_D4(c, i), WG_D4(c, i + 4), WG_D4(c, i + 8), WG_D4(c, i + 12)
#define WG_D128(c)                                                      \
  WG_D16(c, 0), WG_D16(c, 16), WG_D16(c, 32), WG_D16(c, 48),            \
      WG_D16(c, 64), WG_D16(c, 80), WG_D16(c, 96), WG_D16(c, 112)

// d (64 x 256 of the warpgroup, 128 per thread) += A (64 x 16 k, K-major)
// * B (16 k x 256, MN-major), both by descriptor
__device__ __forceinline__ void wgmma_bf16(float* d, uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " WG_REGS
      ", %128, %129, p, 1, 1, 0, 1;\n}\n"
      : WG_D128("+f")
      : "l"(da), "l"(db), "r"(1));
}
// d += A (64 x 32 k) * B (32 k x 256), both K-major, s8 -> s32
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " WG_REGS
      ", %128, %129, p;\n}\n"
      : WG_D128("+r")
      : "l"(da), "l"(db), "r"(1));
}

struct WgArgs {
  void* c;
  int M, N, K;
};

// persistent blocks walk the 128 x 256 tiles of C (n tiles innermost),
// tile t = blockIdx.x + i * gridDim.x; warpgroup 0 loads, warpgroups 1
// and 2 compute rows 0-63 and 64-127 of each tile. The ring's stages and
// phases run on across tiles, so the next tile's loads land while this
// tile's accumulators are stored.
template <bool INT8>
__global__ void __launch_bounds__(WG_THREADS, 1)
wgmma_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b,
                  const WgArgs g) {
  typedef typename Elem<INT8>::Acc Acc;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + WG_STAGES * WG_STAGE_BYTES);
  uint64_t* empty = full + WG_STAGES;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tiles_n = (g.N + WG_BN - 1) / WG_BN;
  const int tiles = tiles_n * ((g.M + WG_BM - 1) / WG_BM);
  const int KT = (g.K * (INT8 ? 1 : 2) + WG_BK_BYTES - 1) / WG_BK_BYTES;
  if (tid == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);           // each consumer warp arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    // ---- the producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      int s = 0;
      unsigned ph = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t / tiles_n) * WG_BM, n0 = (t % tiles_n) * WG_BN;
        for (int kt = 0; kt < KT; ++kt) {
          mbar_wait(&empty[s], ph ^ 1);  // the stage's last use released
          unsigned char* st = smem + s * WG_STAGE_BYTES;
          mbar_expect(&full[s], WG_STAGE_BYTES);
          const int k0 = kt * (INT8 ? WG_BK_BYTES : WG_BK_BYTES / 2);
          tma_load(st, &map_a, k0, m0, &full[s]);
          if constexpr (INT8) {
            tma_load(st + WG_A_BYTES, &map_b, k0, n0, &full[s]);
          } else {
#pragma unroll
            for (int i = 0; i < WG_BN / 64; ++i)   // four 64-column boxes
              tma_load(st + WG_A_BYTES + i * 8192, &map_b, n0 + 64 * i, k0,
                       &full[s]);
          }
          if (++s == WG_STAGES) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {
    // ---- the consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = warp / 4 - 1;         // 64-row half of the tile
    const unsigned base = smem_u32(smem);
    Acc* c = static_cast<Acc*>(g.c);
    const bool pairs = g.N % 2 == 0;
    int s = 0;
    unsigned ph = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t / tiles_n) * WG_BM, n0 = (t % tiles_n) * WG_BN;
      Acc d[128];
#pragma unroll
      for (int i = 0; i < 128; ++i) d[i] = 0;
      int prev = 0;
      for (int kt = 0; kt < KT; ++kt) {
        mbar_wait(&full[s], ph);
        const unsigned st = base + s * WG_STAGE_BYTES;
        const uint64_t da = desc_sw128(st + wg * (64 * 128), 16, 1024);
        wgmma_fence();
        if constexpr (INT8) {
          const uint64_t db = desc_sw128(st + WG_A_BYTES, 16, 1024);
#pragma unroll
          for (int k = 0; k < 4; ++k)    // k32 steps of 32 bytes
            wgmma_s8(d, da + 2 * k, db + 2 * k);
        } else {
          const uint64_t db = desc_sw128(st + WG_A_BYTES, 8192, 1024);
#pragma unroll
          for (int k = 0; k < 4; ++k)    // k16 steps: 32 bytes of A, 16
            wgmma_bf16(d, da + 2 * k, db + 128 * k);   // rows of B
        }
        wgmma_commit();
        // this stage's products stay in flight; the previous stage's are
        // done once at most one group is pending, and its stage is
        // released
        wgmma_wait<1>();
        if (kt > 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = s;
        if (++s == WG_STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(&empty[prev]);

      // ---- store from the registers: per 8 columns j, rows r and r + 8,
      // columns 2 * (lane % 4) + 0, 1
      const int r = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
      for (int j = 0; j < 32; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = r + 8 * h;
          const int n = n0 + 8 * j + 2 * (lane % 4);
          if (m >= g.M || n >= g.N) continue;
          Acc* dst = c + (size_t)m * g.N + n;
          const Acc v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
          if (pairs) {
            if constexpr (INT8)
              *reinterpret_cast<int2*>(dst) = make_int2(v0, v1);
            else
              *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
          } else {
            dst[0] = v0;
            if (n + 1 < g.N) dst[1] = v1;
          }
        }
    }
  }
}

// s8 B (K, N) -> bt (N, K), 64 x 64 tiles through shared memory: a row
// of B in 16-byte loads where N and b allow (vec 16), else 4-byte (vec 4)
// or single bytes; K is a multiple of 16, so each 16-byte unit of a bt row
// is whole
#define TP 64
__global__ void __launch_bounds__(256)
repack_i8_kernel(const int8_t* __restrict__ b, int8_t* __restrict__ bt,
                 int K, int N, int vec) {
  __shared__ __align__(16) unsigned char tile[TP][TP + 4];   // [k][n]
  const int k0 = blockIdx.y * TP, n0 = blockIdx.x * TP, tid = threadIdx.x;
  {
    const int rk = tid / 4, cn = (tid % 4) * 16;   // 16 bytes of a row
    const int k = k0 + rk, n = n0 + cn;
    unsigned w[4] = {0u, 0u, 0u, 0u};
    if (k < K) {
      const int8_t* src = b + (size_t)k * N + n;
      if (vec == 16 && n + 15 < N) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
        w[0] = v.x;
        w[1] = v.y;
        w[2] = v.z;
        w[3] = v.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (vec == 4 && n + 4 * q + 3 < N) {
            w[q] = __ldg(reinterpret_cast<const unsigned*>(src + 4 * q));
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (n + 4 * q + e < N)
                w[q] |= (unsigned)(uint8_t)src[4 * q + e] << (8 * e);
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      *reinterpret_cast<unsigned*>(&tile[rk][cn + 4 * q]) = w[q];
  }
  __syncthreads();
  const int rn = tid / 4, ck = (tid % 4) * 16;
  const int n = n0 + rn, k = k0 + ck;
  if (n < N && k < K) {
    unsigned w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      w[q] = (unsigned)tile[ck + 4 * q][rn] |
             (unsigned)tile[ck + 4 * q + 1][rn] << 8 |
             (unsigned)tile[ck + 4 * q + 2][rn] << 16 |
             (unsigned)tile[ck + 4 * q + 3][rn] << 24;
    *reinterpret_cast<uint4*>(bt + (size_t)n * K + k) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

static int launch_repack(const void* b, void* bt, int K, int N,
                         cudaStream_t stream) {
  const uintptr_t pb = (uintptr_t)b;
  const int vec = pb % 16 == 0 && N % 16 == 0 ? 16
                  : pb % 4 == 0 && N % 4 == 0 ? 4
                                              : 1;
  const long long gy = (K + TP - 1) / TP;
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((N + TP - 1) / TP, (unsigned)gy);
  repack_i8_kernel<<<grid, 256, 0, stream>>>(
      static_cast<const int8_t*>(b), static_cast<int8_t*>(bt), K, N, vec);
  return (int)cudaGetLastError();
}

template <bool INT8>
static int launch_wgmma(const void* a, const void* b, void* c, int M, int N,
                        int K, cudaStream_t stream) {
  CUtensorMap map_a, map_b;
  int err;
  if constexpr (INT8) {
    err = tensor_map_2d(&map_a, CU_TENSOR_MAP_DATA_TYPE_UINT8, a, K, M, K,
                        128, WG_BM);
    if (!err)   // b is the repacked (N, K)
      err = tensor_map_2d(&map_b, CU_TENSOR_MAP_DATA_TYPE_UINT8, b, K, N, K,
                          128, WG_BN);
  } else {
    err = tensor_map_2d(&map_a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a, K, M,
                        2ull * K, 64, WG_BM);
    if (!err)   // b as it is, (K, N): 64 columns by 64 k rows per box
      err = tensor_map_2d(&map_b, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, b, N, K,
                          2ull * N, 64, 64);
  }
  if (err) return err;
  auto kernel = wgmma_gemm_kernel<INT8>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
  if (e != cudaSuccess) return (int)e;
  WgArgs g;
  g.c = c;
  g.M = M;
  g.N = N;
  g.K = K;
  const long long tiles =
      (long long)((M + WG_BM - 1) / WG_BM) * ((N + WG_BN - 1) / WG_BN);
  int sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int grid = (int)(tiles < sms ? tiles : (sms > 0 ? sms : 1));
  kernel<<<grid, WG_THREADS, WG_SMEM, stream>>>(map_a, map_b, g);
  return (int)cudaGetLastError();
}

// ===========================================================================
// Plain C entry points (bound with ctypes)

// 1 where the wgmma route takes the shape: TMA needs 16-byte-aligned base
// pointers and row strides (bf16: K and N multiples of 8; int8: K a
// multiple of 16, B being repacked to (N, K))
extern "C" int mma_gemm_wgmma_ok(const void* a, const void* b,
                                 const void* c, int M, int N, int K,
                                 int int8) {
  if (M < 1 || N < 1 || K < 1) return 0;
  const bool aligned = (uintptr_t)a % 16 == 0 && (uintptr_t)b % 16 == 0 &&
                       (uintptr_t)c % 16 == 0;
  if (!aligned) return 0;
  return int8 ? K % 16 == 0 : K % 8 == 0 && N % 8 == 0;
}

// int8 B (K, N) -> bt (N, K), the wgmma route's repack (K a multiple of
// 16, bt 16-byte aligned)
extern "C" int mma_gemm_repack_launch(const void* b, void* bt, int K, int N,
                                      void* stream) {
  if (K < 1 || N < 1 || K % 16 || b == nullptr || bt == nullptr ||
      (uintptr_t)bt % 16)
    return (int)cudaErrorInvalidValue;
  return launch_repack(b, bt, K, N, static_cast<cudaStream_t>(stream));
}

// c (M, N) = a (M, K) @ b (K, N), all row-major and contiguous; int8 != 0:
// int8 inputs, int32 c; else bf16 inputs, float32 c. wgmma != 0: the wgmma
// route, which refuses a shape mma_gemm_wgmma_ok does not take; for int8
// it needs `scratch`, N * K bytes, for the repacked B. wgmma == 0: the
// mma.sync kernel at any shape. Returns a cudaError_t: the configuration
// check, the tensor maps, cudaFuncSetAttribute, or cudaGetLastError()
// after each launch. Launches on `stream`; does not synchronise.
extern "C" int mma_gemm_launch(const void* a, const void* b, void* c, int M,
                               int N, int K, int int8, int wgmma,
                               void* scratch, void* stream) {
  if (M < 1 || N < 1 || K < 1 || a == nullptr || b == nullptr ||
      c == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wgmma) {
    if (!mma_gemm_wgmma_ok(a, b, c, M, N, K, int8))
      return (int)cudaErrorInvalidValue;
    if (!int8) return launch_wgmma<false>(a, b, c, M, N, K, s);
    if (scratch == nullptr || (uintptr_t)scratch % 16)
      return (int)cudaErrorInvalidValue;
    const int err = launch_repack(b, scratch, K, N, s);
    if (err) return err;
    return launch_wgmma<true>(a, scratch, c, M, N, K, s);
  }
  GemmArgs g;
  g.a = a;
  g.b = b;
  g.c = c;
  g.M = M;
  g.N = N;
  g.K = K;
  const uintptr_t pa = (uintptr_t)a, pb = (uintptr_t)b;
  if (int8) {
    g.vec_a = pa % 16 == 0 && K % 16 == 0;
    g.vec_b = pb % 4 == 0 && N % 4 == 0;
    return launch_gemm<true>(g, s);
  }
  g.vec_a = pa % 16 == 0 && K % 8 == 0;
  g.vec_b = pb % 16 == 0 && N % 8 == 0;
  return launch_gemm<false>(g, s);
}
