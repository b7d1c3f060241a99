// Tiled matrix product on the tensor cores for NVIDIA Hopper (sm_90a):
// C = A @ B for row-major A (M, K) and B (K, N), bf16 x bf16 -> float32 and
// int8 x int8 -> int32.
//
// Replaces the Pallas TPU kernel of experiments/exp_int8_mxu.py (the inline
// `kernel` of `main`: (512, K) x (K, 512) blocks, jnp.dot with f32 or int32
// accumulation), which measured what int8 products deliver against bf16.
//
// What bounds it: at M = N = K = 4096 the tensor cores (137.4 GFLOP; bf16
// 989 TFLOP/s, int8 1,979 TOP/s dense), far above the bytes (~100 MB).
//
// Design (simple and correct first; wgmma, TMA and warp specialisation are
// later work): one block of 8 warps per 128 x 128 tile of C, a K loop over
// 64-byte slices (32 bf16 or 64 int8 values) in a 3-stage shared-memory
// ring.
//  * A's slice (128 rows x 64 bytes) is copied with 16-byte cp.async, two
//    slices ahead of the products; rows are 80 bytes apart, so the eight
//    16-byte rows of an ldmatrix fall in distinct bank groups.
//  * bf16 B's slice (32 rows of k x 128 n) is copied the same way and read
//    with ldmatrix.trans, which hands mma.sync its k-major fragment.
//  * int8 B has no transposing ldmatrix (it moves 16-bit elements): each
//    thread loads 4 x 4-byte blocks (4 k x 4 n) into registers before the
//    products of the current slice, transposes them with byte permutes and
//    stores them n-major (80-byte rows) after, two slices ahead.
//  * Warps form a 2 x 4 grid of 64 x 32 sub-tiles: 4 x 4 fragments of
//    mma.sync.m16n8k16 (bf16, f32 accumulate) or m16n8k32 (s8, s32
//    accumulate) per 32-byte k step; the accumulators are stored straight
//    from registers.
//  * Any M, N, K: edge slices are zero-filled (cp.async with a short source
//    size). Rows that are not 16-byte aligned (K or N not a multiple of the
//    16-byte unit, or a pointer off it) take a scalar, synchronous path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// Plain C entry point (bound with ctypes): c (M, N) = a (M, K) @ b (K, N),
// all row-major and contiguous; int8 != 0: int8 inputs, int32 c; else bf16
// inputs, float32 c. Returns a cudaError_t: the configuration check,
// cudaFuncSetAttribute, or cudaGetLastError() after the launch. Launches on
// `stream`; does not synchronise.
extern "C" int mma_gemm_launch(const void* a, const void* b, void* c, int M,
                               int N, int K, int int8, void* stream) {
  if (M < 1 || N < 1 || K < 1 || a == nullptr || b == nullptr ||
      c == nullptr)
    return (int)cudaErrorInvalidValue;
  GemmArgs g;
  g.a = a;
  g.b = b;
  g.c = c;
  g.M = M;
  g.N = N;
  g.K = K;
  const uintptr_t pa = (uintptr_t)a, pb = (uintptr_t)b;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int8) {
    g.vec_a = pa % 16 == 0 && K % 16 == 0;
    g.vec_b = pb % 4 == 0 && N % 4 == 0;
    return launch_gemm<true>(g, s);
  }
  g.vec_a = pa % 16 == 0 && K % 8 == 0;
  g.vec_b = pb % 16 == 0 && N % 8 == 0;
  return launch_gemm<false>(g, s);
}
