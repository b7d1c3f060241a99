// The links between level 0 and level 1 and the seg head, for NVIDIA
// Hopper (sm_90a), bfloat16. Each reads a pending raw tensor (a fused
// block's output, its instance norm not yet applied), channels-last
// (N, D, H, W, C), once.
//
// Replaces the Pallas TPU kernels of e2enet_tpu/ops/qlink.py, which work on
// the quadrant layout:
//  * uplink   <- _uplink_kernel: u = lrelu(x*m + o) in bf16 (m, o rounded
//    to bf16, every step rounded as bf16 arithmetic rounds), then the k == s
//    transposed conv as a (Cin x sd*sh*sw*Cout) product with f32 sums,
//    stored bf16 straight to the finer level's channels-last positions.
//    At the bench geometry (64^3 x 96 -> 128^3 x 48) it reads 50 MB and
//    writes 201 MB against 19.3 GFLOP: bound by memory (~0.075 ms).
//  * downlink <- _downlink_kernel: max and min of the raw over each window,
//    the max where mult > 0 and the min elsewhere, lrelu(pick*m + o) in f32,
//    stored bf16. Reads 201 MB, writes 25 MB: bound by memory (~0.068 ms).
//  * downlink_bwd <- _downlink_bwd_kernel: the backward of the down-link.
//    The raw running max (mult > 0) or min chain over the window is
//    recomputed; ga = gy, times 0.01 where pick*m + o < 0, gives
//    g(mult) += ga*pick and g(off) += ga in f32, and ga*m walks the chain
//    backward, element k taking 1 where it beats the running value before
//    it, 0.5 where it ties, and passing the rest on; gx stored bf16. Reads
//    403 MB and writes 403 MB at 2 x 128^3 x 48: bound by memory
//    (~0.26 ms).
//  * seghead  <- _seghead_probs_kernel, and _seghead_kernel as its logits
//    mode: u = lrelu(x*m + o) in f32, rounded to bf16; the 1x1 conv with f32
//    sums; then a max-subtracted f32 softmax over the classes stored bf16,
//    or the f32 logits. Reads 201 MB, writes 67 MB of probs: bound by memory
//    (~0.080 ms).
//
// Designs (simple and right first):
//  * uplink: persistent blocks of 8 warps walk tiles of 64 coarse voxels of
//    one (n, d, h) row. All weights, (sd*sh chunks, sw*Cout, Cin), are
//    staged once per block. A tile stages its normalised voxels once; per
//    chunk (bd, bh) the product runs on ldmatrix + mma.sync.m16n8k16 and
//    its sw*Cout columns per voxel are exactly the finer row
//    (n, sd*d + bd, sh*h + bh) from column sw*w0 on, contiguous: they pass
//    through shared memory and leave in 16-byte stores.
//  * downlink: one thread per output voxel and 8 channels (16-byte loads of
//    every window position), or per channel where rows are not aligned.
//  * downlink_bwd (redesigned for this card): bound by its bytes, which the
//    first design moved as 2-byte requests (one thread per output voxel
//    and channel, 8 scalar loads and stores, a per-thread address array,
//    one statistics atomic pair per thread). Now one thread per output
//    voxel and 8-channel unit of a 2 x 2 x 2 window: 8 x 16-byte loads of
//    x, one of gy and 8 x 16-byte stores of gx, lanes of a warp on
//    consecutive units and voxels so a request covers whole 32-byte
//    sectors; the float32 chain per element in registers, in the first
//    design's order and rounding (gx equal to the bit); g(mult), g(off)
//    summed in registers over the voxels a thread visits (its unit fixed),
//    added by channel in shared memory, one atomic pair per channel and
//    block. Other windows, C % 8 != 0 or unaligned rows keep the scalar
//    kernel (chosen by shape). What still holds it back: it reaches about
//    80 % of a plain copy of x (the same bytes) on this card; each thread
//    runs its ~500-instruction chain between its loads and its stores,
//    with 8 warps per SM (159 registers), and neither more warps (128
//    registers) nor the next voxel's loads in flight measured faster.
//  * seghead: blocks of 256 voxels; the normalised tile is staged in shared
//    memory (16-byte loads), then one thread per voxel computes its K
//    logits on the CUDA cores from shared-memory weights (transposed, four
//    classes per 16-byte load), the softmax, and stores its K outputs in
//    16-byte rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define NWARPS 8
#define NTHREADS (NWARPS * 32)
#define SMEM_LIMIT (227 * 1024)
#define F32_INF __int_as_float(0x7f800000)

__device__ __forceinline__ float norm_lrelu(float x, float m, float o) {
  // no fma contraction: the plain torch version rounds the product
  const float a = __fadd_rn(__fmul_rn(x, m), o);
  return fmaxf(a, __fmul_rn(a, 0.01f));
}

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

__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void mma_16816(float d[4], const unsigned a[4],
                                          unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

static int num_sms() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

// ===========================================================================
// up-link

#define UP_TM 64           // coarse voxels per tile: 4 row fragments
#define UP_WM 4            // warps along M (one row fragment each)
#define UP_WN 2            // warps along N
#define UP_NFW 4           // 16-wide column fragments per warp: NW <= 128

struct UpParams {
  const bf16* x;           // (N, D, H, W, Cin)
  const float* mult;       // (N, Cin)
  const float* off;
  const bf16* w;           // (sd*sh, NW = sw*Cout, Cin)
  bf16* y;                 // (N, D*sd, H*sh, W*sw, Cout)
  int N, D, H, W, Cin, Cout, sd, sh, sw;
  int NW, NWs, Cs, Cp, n_wt, ntiles, vec16;
  int off_a, off_o, off_mo;
};

__global__ void __launch_bounds__(NTHREADS) uplink_kernel(const UpParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int Cs = p.Cs, Cp = p.Cp, NWs = p.NWs, KC8 = Cs / 8;
  const int chunks = p.sd * p.sh;
  bf16* s_w = reinterpret_cast<bf16*>(smem);
  bf16* s_a = reinterpret_cast<bf16*>(smem + p.off_a);
  bf16* s_o = reinterpret_cast<bf16*>(smem + p.off_o);
  float* s_m = reinterpret_cast<float*>(smem + p.off_mo);
  float* s_of = s_m + Cs;

  for (int i = tid; i < chunks * NWs * Cs; i += NTHREADS) {
    const int k = i % Cs, r = i / Cs;
    const int col = r % NWs, ch = r / NWs;
    s_w[(size_t)r * Cp + k] =
        (col < p.NW && k < p.Cin)
            ? p.w[((size_t)ch * p.NW + col) * p.Cin + k]
            : __float2bfloat16(0.0f);
  }
  const int wm = warp % UP_WM, wn = warp / UP_WM;
  const int NF = NWs / 16;
  bool nf_on[UP_NFW];
#pragma unroll
  for (int j = 0; j < UP_NFW; ++j) nf_on[j] = wn * UP_NFW + j < NF;
  const int a_row = lane % 16, a_k = (lane / 16) * 8;
  const int b_row = lane % 8 + (lane / 16) * 8, b_k = ((lane / 8) % 2) * 8;
  const int Df = p.D * p.sd, Hf = p.H * p.sh, Wf = p.W * p.sw;

  int n_prev = -1;
  for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
    int rest = tile;
    const int wt = rest % p.n_wt;
    rest /= p.n_wt;
    const int h = rest % p.H;
    rest /= p.H;
    const int d = rest % p.D;
    const int n = rest / p.D;
    const int w0 = wt * UP_TM;
    const int nvalid = min(UP_TM, p.W - w0);
    __syncthreads();                  // the previous tile is done
    if (n != n_prev) {
      for (int c = tid; c < Cs; c += NTHREADS) {
        const bool on = c < p.Cin;
        s_m[c] = on ? round_bf16(p.mult[(size_t)n * p.Cin + c]) : 0.0f;
        s_of[c] = on ? round_bf16(p.off[(size_t)n * p.Cin + c]) : 0.0f;
      }
      n_prev = n;
      __syncthreads();
    }
    // ---- stage the tile's normalised voxels (zeros past W and Cin)
    const bf16* xrow =
        p.x + ((((size_t)n * p.D + d) * p.H + h) * p.W + w0) * p.Cin;
    for (int u = tid; u < UP_TM * KC8; u += NTHREADS) {
      const int k = u % KC8, r = u / KC8, c0 = k * 8;
      uint4 out = make_uint4(0u, 0u, 0u, 0u);
      if (r < nvalid && c0 < p.Cin) {
        float v[8];
        if (p.vec16) {
          const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
              xrow + (size_t)r * p.Cin + c0));
          const bf16* rv = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(rv[e]);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[e] = c0 + e < p.Cin
                       ? __bfloat162float(xrow[(size_t)r * p.Cin + c0 + e])
                       : 0.0f;
        }
        bf16* vals = reinterpret_cast<bf16*>(&out);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          vals[e] = __float2bfloat16(
              c0 + e < p.Cin
                  ? norm_lrelu_bf16(v[e], s_m[c0 + e], s_of[c0 + e])
                  : 0.0f);
      }
      *reinterpret_cast<uint4*>(s_a + (size_t)r * Cp + c0) = out;
    }
    __syncthreads();

    const unsigned a_addr = (unsigned)__cvta_generic_to_shared(
        s_a + (size_t)(wm * 16 + a_row) * Cp + a_k);
    for (int ch = 0; ch < chunks; ++ch) {
      float acc[UP_NFW][2][4];
#pragma unroll
      for (int j = 0; j < UP_NFW; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][hh][e] = 0.0f;
      if (nf_on[0]) {
        const unsigned b_addr = (unsigned)__cvta_generic_to_shared(
            s_w + ((size_t)ch * NWs + wn * UP_NFW * 16 + b_row) * Cp + b_k);
        for (int kc = 0; kc < Cs; kc += 16) {
          unsigned a[4], b[UP_NFW][4];
          ldmatrix_x4(a, a_addr + kc * 2);
#pragma unroll
          for (int j = 0; j < UP_NFW; ++j)
            if (nf_on[j]) ldmatrix_x4(b[j], b_addr + (j * 16 * Cp + kc) * 2);
#pragma unroll
          for (int j = 0; j < UP_NFW; ++j)
            if (nf_on[j]) {
              mma_16816(acc[j][0], a, b[j][0], b[j][1]);
              mma_16816(acc[j][1], a, b[j][2], b[j][3]);
            }
        }
      }
      // ---- the chunk's (nvalid x NW) block is one contiguous finer row
      // segment: through shared memory to 16-byte stores
#pragma unroll
      for (int j = 0; j < UP_NFW; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int col = (wn * UP_NFW + j) * 16 + hh * 8 + (lane % 4) * 2;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = wm * 16 + lane / 4 + half * 8;
            if (nf_on[j] && r < nvalid) {
              if (col < p.NW)
                s_o[(size_t)r * p.NW + col] =
                    __float2bfloat16(acc[j][hh][2 * half]);
              if (col + 1 < p.NW)
                s_o[(size_t)r * p.NW + col + 1] =
                    __float2bfloat16(acc[j][hh][2 * half + 1]);
            }
          }
        }
      __syncthreads();
      const int bd = ch / p.sh, bh = ch % p.sh;
      bf16* dst = p.y + ((((size_t)n * Df + (size_t)d * p.sd + bd) * Hf +
                          (size_t)h * p.sh + bh) * Wf +
                         (size_t)w0 * p.sw) * p.Cout;
      const int len = nvalid * p.NW;
      if ((reinterpret_cast<uintptr_t>(dst) % 16) == 0 && p.NW % 8 == 0) {
        for (int i = tid; i < len / 8; i += NTHREADS)
          reinterpret_cast<uint4*>(dst)[i] =
              reinterpret_cast<const uint4*>(s_o)[i];
      } else {
        for (int i = tid; i < len; i += NTHREADS) dst[i] = s_o[i];
      }
      __syncthreads();
    }
  }
}

// Plain C entry point. w is (sd*sh, sw*Cout, Cin) bf16 with the kernel
// already mirrored. Returns a cudaError_t; launches on `stream`.
extern "C" int uplink_launch(const void* x, const void* mult, const void* off,
                             const void* w, void* y, int N, int D, int H,
                             int W, int Cin, int Cout, int sd, int sh, int sw,
                             void* stream) {
  if (N < 1 || D < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 || sd < 1 ||
      sh < 1 || sw < 1)
    return (int)cudaErrorInvalidValue;
  UpParams p;
  p.x = static_cast<const bf16*>(x);
  p.mult = static_cast<const float*>(mult);
  p.off = static_cast<const float*>(off);
  p.w = static_cast<const bf16*>(w);
  p.y = static_cast<bf16*>(y);
  p.N = N; p.D = D; p.H = H; p.W = W; p.Cin = Cin; p.Cout = Cout;
  p.sd = sd; p.sh = sh; p.sw = sw;
  p.NW = sw * Cout;
  p.NWs = (p.NW + 15) / 16 * 16;
  if (p.NWs > UP_WN * UP_NFW * 16) return (int)cudaErrorInvalidValue;
  p.Cs = (Cin + 15) / 16 * 16;
  p.Cp = p.Cs + 8;                   // an odd number of 16-byte units
  p.vec16 = (reinterpret_cast<uintptr_t>(x) % 16 == 0 && Cin % 8 == 0);
  p.n_wt = (W + UP_TM - 1) / UP_TM;
  const long long ntiles = (long long)N * D * H * p.n_wt;
  if (ntiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  p.ntiles = (int)ntiles;
  const size_t w_bytes = (size_t)sd * sh * p.NWs * p.Cp * sizeof(bf16);
  p.off_a = (int)((w_bytes + 127) / 128 * 128);
  p.off_o = p.off_a + (int)((UP_TM * p.Cp * sizeof(bf16) + 127) / 128 * 128);
  p.off_mo = p.off_o + (int)((UP_TM * p.NW * sizeof(bf16) + 127) / 128 * 128);
  const size_t smem = (size_t)p.off_mo + 2 * p.Cs * sizeof(float);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      uplink_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = (int)(SMEM_LIMIT / smem);
  if (per_sm < 1) per_sm = 1;
  if (per_sm > 4) per_sm = 4;
  const int grid = p.ntiles < num_sms() * per_sm ? p.ntiles
                                                 : num_sms() * per_sm;
  uplink_kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      p);
  return (int)cudaGetLastError();
}

// ===========================================================================
// down-link

struct DownParams {
  const bf16* x;           // (N, D, H, W, C)
  const float* mult;       // (N, C)
  const float* off;
  bf16* y;                 // (N, Do, Ho, Wo, C)
  int N, D, H, W, C, wd, wh, ww, Do, Ho, Wo, vec;
};

__global__ void __launch_bounds__(NTHREADS)
downlink_kernel(const DownParams p, long long n_items) {
  const int per = p.vec ? 8 : 1;          // channels per item
  const int cu = p.C / per;               // items per voxel
  for (long long it = (long long)blockIdx.x * NTHREADS + threadIdx.x;
       it < n_items; it += (long long)gridDim.x * NTHREADS) {
    const int c0 = (int)(it % cu) * per;
    long long v = it / cu;
    const int wo = (int)(v % p.Wo);
    v /= p.Wo;
    const int ho = (int)(v % p.Ho);
    v /= p.Ho;
    const int dout = (int)(v % p.Do);
    const int n = (int)(v / p.Do);
    float mx[8], mn[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      mx[e] = -F32_INF;
      mn[e] = F32_INF;
    }
    for (int a = 0; a < p.wd; ++a)
      for (int b = 0; b < p.wh; ++b)
        for (int c = 0; c < p.ww; ++c) {
          const size_t pix =
              (((size_t)n * p.D + dout * p.wd + a) * p.H + ho * p.wh + b) *
                  p.W + wo * p.ww + c;
          const bf16* src = p.x + pix * p.C + c0;
          if (p.vec) {
            const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
            const bf16* rv = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const float f = __bfloat162float(rv[e]);
              mx[e] = fmaxf(mx[e], f);
              mn[e] = fminf(mn[e], f);
            }
          } else {
            const float f = __bfloat162float(src[0]);
            mx[0] = fmaxf(mx[0], f);
            mn[0] = fminf(mn[0], f);
          }
        }
    const size_t oidx =
        ((((size_t)n * p.Do + dout) * p.Ho + ho) * p.Wo + wo) * p.C + c0;
    const float* m = p.mult + (size_t)n * p.C + c0;
    const float* o = p.off + (size_t)n * p.C + c0;
    if (p.vec) {
      uint4 out;
      bf16* vals = reinterpret_cast<bf16*>(&out);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        vals[e] = __float2bfloat16(
            norm_lrelu(m[e] > 0.0f ? mx[e] : mn[e], m[e], o[e]));
      *reinterpret_cast<uint4*>(p.y + oidx) = out;
    } else {
      p.y[oidx] = __float2bfloat16(
          norm_lrelu(m[0] > 0.0f ? mx[0] : mn[0], m[0], o[0]));
    }
  }
}

extern "C" int downlink_launch(const void* x, const void* mult,
                               const void* off, void* y, int N, int D, int H,
                               int W, int C, int wd, int wh, int ww,
                               void* stream) {
  if (N < 1 || C < 1 || wd < 1 || wh < 1 || ww < 1 || D < wd || H < wh ||
      W < ww)
    return (int)cudaErrorInvalidValue;
  DownParams p;
  p.x = static_cast<const bf16*>(x);
  p.mult = static_cast<const float*>(mult);
  p.off = static_cast<const float*>(off);
  p.y = static_cast<bf16*>(y);
  p.N = N; p.D = D; p.H = H; p.W = W; p.C = C;
  p.wd = wd; p.wh = wh; p.ww = ww;
  p.Do = D / wd; p.Ho = H / wh; p.Wo = W / ww;
  p.vec = (C % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(y) % 16 == 0);
  const long long n_items =
      (long long)N * p.Do * p.Ho * p.Wo * (p.vec ? C / 8 : C);
  long long blocks = (n_items + NTHREADS - 1) / NTHREADS;
  const long long cap = (long long)num_sms() * 16;
  if (blocks > cap) blocks = cap;
  downlink_kernel<<<(unsigned)blocks, NTHREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(p, n_items);
  return (int)cudaGetLastError();
}

// ===========================================================================
// down-link backward

#define DB_QMAX 8          // window elements the backward takes

struct DownBwdParams {
  const bf16* x;           // (N, D, H, W, C) the forward's pending raw
  const bf16* gy;          // (N, Do, Ho, Wo, C)
  const float* mult;       // (N, C)
  const float* off;
  bf16* gx;                // (N, D, H, W, C); the ragged edge is the
                           // caller's (zeroed)
  float* gaff;             // (N, C, 2) zeroed: (g mult, g off)
  int D, H, W, C, wd, wh, ww, Do, Ho, Wo, vox_per_block;
};

// block (chunk, n); thread t keeps channel t % C over output voxels
// t / C + k * (NTHREADS / C), so its g(mult), g(off) sums are one
// channel's. The window's elements are taken in the reference's block
// order, (a * wh + b) * ww + c.
__global__ void __launch_bounds__(NTHREADS)
downlink_bwd_kernel(const DownBwdParams p) {
  const int tid = threadIdx.x;
  const int n = blockIdx.y;
  const int vpi = NTHREADS / p.C;         // voxels per iteration
  if (tid >= vpi * p.C) return;
  const int c = tid % p.C;
  const int Q = p.wd * p.wh * p.ww;
  const float m = p.mult[(size_t)n * p.C + c];
  const float o = p.off[(size_t)n * p.C + c];
  const bool use_max = m > 0.0f;
  const long long nvox = (long long)p.Do * p.Ho * p.Wo;
  const long long v0 = (long long)blockIdx.x * p.vox_per_block;
  long long v1 = v0 + p.vox_per_block;
  if (v1 > nvox) v1 = nvox;
  float sm = 0.0f, so = 0.0f;
  for (long long v = v0 + tid / p.C; v < v1; v += vpi) {
    const int wo = (int)(v % p.Wo);
    const int ho = (int)((v / p.Wo) % p.Ho);
    const int dout = (int)(v / ((long long)p.Wo * p.Ho));
    size_t idx[DB_QMAX];
    float xs[DB_QMAX], run[DB_QMAX];
    int k = 0;
    for (int a = 0; a < p.wd; ++a)
      for (int b = 0; b < p.wh; ++b)
        for (int cc = 0; cc < p.ww; ++cc, ++k) {
          idx[k] = ((((size_t)n * p.D + dout * p.wd + a) * p.H + ho * p.wh +
                     b) * p.W + wo * p.ww + cc) * p.C + c;
          xs[k] = __bfloat162float(p.x[idx[k]]);
          // the running max (or min) of the chain up to element k
          run[k] = k == 0 ? xs[0]
                          : (use_max ? fmaxf(run[k - 1], xs[k])
                                     : fminf(run[k - 1], xs[k]));
        }
    const float pick = run[Q - 1];
    const float a = __fadd_rn(__fmul_rn(pick, m), o);
    float ga = __bfloat162float(
        p.gy[((((size_t)n * p.Do + dout) * p.Ho + ho) * p.Wo + wo) * p.C + c]);
    if (!(a >= 0.0f)) ga = __fmul_rn(ga, 0.01f);
    sm += ga * pick;
    so += ga;
    // walk the chain backward: element k takes the share w of what reached
    // step k, 1 where it beats the running value before it, 0.5 where it
    // ties (maximum's subgradient), and passes 1 - w on
    float g = __fmul_rn(ga, m);
    for (int j = Q - 1; j >= 1; --j) {
      const float prev = run[j - 1];
      const bool beats = use_max ? xs[j] > prev : xs[j] < prev;
      const float w = beats ? 1.0f : (xs[j] == prev ? 0.5f : 0.0f);
      p.gx[idx[j]] = __float2bfloat16(g * w);
      g = g * (1.0f - w);
    }
    p.gx[idx[0]] = __float2bfloat16(g);
  }
  atomicAdd(&p.gaff[((size_t)n * p.C + c) * 2], sm);
  atomicAdd(&p.gaff[((size_t)n * p.C + c) * 2 + 1], so);
}

// ---- the 16-byte route: one thread per (output voxel, 8-channel unit) of
// a 2 x 2 x 2 window. Thread t keeps unit t % U (U = C / 8) over the voxels
// v0 + t / U + k * (threads / U) of its block's range, so its g(mult),
// g(off) sums are 8 channels' in registers; the block adds them by channel
// in shared memory and issues one atomic pair per channel. Each voxel
// reads its 8 window positions and gy as 16-byte units and writes gx the
// same way; addresses come from one base and the constant strides, the
// window in the reference's order (a * 2 + b) * 2 + c. The float32 steps
// are the scalar kernel's, in the same order, so gx is equal to the bit.
#define DBV_THREADS 256

// 16-byte load through the read-only path and 16-byte store (streaming
// hints, L1::no_allocate loads and .cs stores, measured slower)
__device__ __forceinline__ uint4 ld16(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ void st16(bf16* p, unsigned w0, unsigned w1,
                                     unsigned w2, unsigned w3) {
  *reinterpret_cast<uint4*>(p) = make_uint4(w0, w1, w2, w3);
}
// element e (0-7) of 8 packed bf16 as float
__device__ __forceinline__ float bf16_at(const uint4& v, int e) {
  const unsigned w = e < 2 ? v.x : e < 4 ? v.y : e < 6 ? v.z : v.w;
  return __uint_as_float(e % 2 ? w & 0xFFFF0000u : w << 16);
}
__device__ __forceinline__ unsigned bf16_bits(float f) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16(f));
}

__global__ void __launch_bounds__(DBV_THREADS, 1)
downlink_bwd_vec_kernel(const DownBwdParams p) {
  __shared__ float s_part[DBV_THREADS][17];   // 8 g(mult), 8 g(off), pad
  const int tid = threadIdx.x;
  const int n = blockIdx.y;
  const int U = p.C / 8;
  const int vpi = DBV_THREADS / U;            // voxels per iteration
  const int u = tid % U, c0 = 8 * u;
  float m[8], o[8], sm[8], so[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    m[e] = p.mult[(size_t)n * p.C + c0 + e];
    o[e] = p.off[(size_t)n * p.C + c0 + e];
    sm[e] = 0.0f;
    so[e] = 0.0f;
  }
  const int nvox = p.Do * p.Ho * p.Wo;
  const int v0 = blockIdx.x * p.vox_per_block;
  const int v1 = min(v0 + p.vox_per_block, nvox);
  const size_t sW = p.C, sH = (size_t)p.W * p.C, sD = (size_t)p.H * sH;
  const int v_first = tid < vpi * U ? v0 + tid / U : v1;
  for (int v = v_first; v < v1; v += vpi) {
    const int wo = v % p.Wo, ho = (v / p.Wo) % p.Ho, dout = v / (p.Wo * p.Ho);
    const size_t base =
        ((((size_t)n * p.D + 2 * dout) * p.H + 2 * ho) * p.W + 2 * wo) *
            p.C + c0;
    const bf16* xb = p.x + base;
    uint4 raw[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      raw[k] = ld16(xb + (k / 4) * sD + ((k / 2) % 2) * sH + (k % 2) * sW);
    const uint4 gyv = ld16(
        p.gy + ((((size_t)n * p.Do + dout) * p.Ho + ho) * p.Wo + wo) * p.C +
        c0);
    unsigned out[8][4];
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int q = 0; q < 4; ++q) out[k][q] = 0u;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const bool use_max = m[e] > 0.0f;
      float xs[8], run[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        xs[k] = bf16_at(raw[k], e);
        run[k] = k == 0 ? xs[0]
                        : (use_max ? fmaxf(run[k - 1], xs[k])
                                   : fminf(run[k - 1], xs[k]));
      }
      const float pick = run[7];
      const float a = __fadd_rn(__fmul_rn(pick, m[e]), o[e]);
      float ga = bf16_at(gyv, e);
      if (!(a >= 0.0f)) ga = __fmul_rn(ga, 0.01f);
      sm[e] += ga * pick;
      so[e] += ga;
      float g = __fmul_rn(ga, m[e]);
#pragma unroll
      for (int j = 7; j >= 1; --j) {
        const float prev = run[j - 1];
        const bool beats = use_max ? xs[j] > prev : xs[j] < prev;
        const float w = beats ? 1.0f : (xs[j] == prev ? 0.5f : 0.0f);
        out[j][e / 2] |= bf16_bits(g * w) << (16 * (e % 2));
        g = g * (1.0f - w);
      }
      out[0][e / 2] |= bf16_bits(g) << (16 * (e % 2));
    }
    bf16* gb = p.gx + base;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      st16(gb + (k / 4) * sD + ((k / 2) % 2) * sH + (k % 2) * sW,
              out[k][0], out[k][1], out[k][2], out[k][3]);
  }
  // ---- the block's sums by channel, one atomic pair per channel
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    s_part[tid][e] = sm[e];
    s_part[tid][8 + e] = so[e];
  }
  __syncthreads();
  for (int ch = tid; ch < p.C; ch += DBV_THREADS) {
    const int uu = ch / 8, e = ch % 8;
    float gm = 0.0f, go = 0.0f;
    for (int j = 0; j < vpi; ++j) {
      gm += s_part[j * U + uu][e];
      go += s_part[j * U + uu][8 + e];
    }
    atomicAdd(&p.gaff[((size_t)n * p.C + ch) * 2], gm);
    atomicAdd(&p.gaff[((size_t)n * p.C + ch) * 2 + 1], go);
  }
}

// The route is chosen by shape: the 16-byte kernel where C is a multiple
// of 8, x, gy and gx are 16-byte aligned and the window is 2 x 2 x 2; the
// scalar kernel otherwise.
extern "C" int downlink_bwd_launch(const void* x, const void* gy,
                                   const void* mult, const void* off,
                                   void* gx, void* gaff, int N, int D, int H,
                                   int W, int C, int wd, int wh, int ww,
                                   void* stream) {
  if (N < 1 || C < 1 || C > NTHREADS || wd < 1 || wh < 1 || ww < 1 ||
      wd * wh * ww > DB_QMAX || D < wd || H < wh || W < ww)
    return (int)cudaErrorInvalidValue;
  DownBwdParams p;
  p.x = static_cast<const bf16*>(x);
  p.gy = static_cast<const bf16*>(gy);
  p.mult = static_cast<const float*>(mult);
  p.off = static_cast<const float*>(off);
  p.gx = static_cast<bf16*>(gx);
  p.gaff = static_cast<float*>(gaff);
  p.D = D; p.H = H; p.W = W; p.C = C;
  p.wd = wd; p.wh = wh; p.ww = ww;
  p.Do = D / wd; p.Ho = H / wh; p.Wo = W / ww;
  const long long nvox = (long long)p.Do * p.Ho * p.Wo;
  if (nvox > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = C % 8 == 0 && wd == 2 && wh == 2 && ww == 2 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(gy) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(gx) % 16 == 0;
  // blocks per sample: 4 (16-byte route, one block per SM; 2-32 measured
  // within 1 % of each other) or 8 per SM's worth across the samples
  const long long per_n = ((vec ? 4LL : 8LL) * num_sms() + N - 1) / N;
  long long vpb = (nvox + per_n - 1) / per_n;
  if (vpb < 1) vpb = 1;
  p.vox_per_block = (int)vpb;
  dim3 grid((unsigned)((nvox + vpb - 1) / vpb), (unsigned)N);
  if (vec)
    downlink_bwd_vec_kernel<<<grid, DBV_THREADS, 0, s>>>(p);
  else
    downlink_bwd_kernel<<<grid, NTHREADS, 0, s>>>(p);
  return (int)cudaGetLastError();
}

// ===========================================================================
// seg head

#define SH_TV NTHREADS     // voxels per tile: one per thread
#define SH_KMAX 32         // classes

struct HeadParams {
  const bf16* x;           // (N * V, C)
  const float* mult;       // (N, C)
  const float* off;
  const bf16* w;           // (K, C)
  void* y;                 // (N * V, K): bf16 probs or f32 logits
  int N, V, C, K, probs, vec16, vec_out;
  long long M;             // N * V voxels
};

__global__ void __launch_bounds__(NTHREADS) seghead_kernel(const HeadParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int C = p.C, K = p.K, Cst = C + 1;   // odd stride: no conflicts
  const int Kp = (K + 3) / 4 * 4;
  // weights transposed, (C, Kp), zero past K: four classes per load
  float* s_w = reinterpret_cast<float*>(smem);
  float* s_a = s_w + Kp * C;                            // (SH_TV, C + 1)
  for (int i = tid; i < Kp * C; i += NTHREADS) {
    const int c = i / Kp, k = i - c * Kp;
    s_w[i] = k < K ? __bfloat162float(p.w[(size_t)k * C + c]) : 0.0f;
  }
  const long long ntiles = (p.M + SH_TV - 1) / SH_TV;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long v0 = tile * SH_TV;
    const int nv = (int)min((long long)SH_TV, p.M - v0);
    // the tile's first sample, and its voxels before the next sample
    const int n0 = (int)(v0 / p.V);
    const long long vb = (long long)(n0 + 1) * p.V - v0;
    __syncthreads();                  // weights staged / tile done
    // ---- stage the tile's normalised voxels: u = bf16(lrelu(x*m + o))
    const bf16* src = p.x + v0 * C;
    if (p.vec16) {
      for (int i = tid; i < nv * C / 8; i += NTHREADS) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src) + i);
        const bf16* rv = reinterpret_cast<const bf16*>(&raw);
        const int e0 = i * 8, v = e0 / C, c0 = e0 - v * C;
        const int n = n0 + (v >= vb);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int c = c0 + e;
          s_a[v * Cst + c] = round_bf16(norm_lrelu(
              __bfloat162float(rv[e]), p.mult[(size_t)n * C + c],
              p.off[(size_t)n * C + c]));
        }
      }
    } else {
      for (int i = tid; i < nv * C; i += NTHREADS) {
        const int v = i / C, c = i - v * C;
        const int n = n0 + (v >= vb);
        s_a[v * Cst + c] = round_bf16(norm_lrelu(
            __bfloat162float(src[i]), p.mult[(size_t)n * C + c],
            p.off[(size_t)n * C + c]));
      }
    }
    __syncthreads();
    if (tid >= nv) continue;
    float l[SH_KMAX];
#pragma unroll
    for (int k = 0; k < SH_KMAX; ++k) l[k] = 0.0f;
    const float* a = s_a + tid * Cst;
    for (int c = 0; c < C; ++c) {
      const float av = a[c];
      const float4* wc = reinterpret_cast<const float4*>(s_w + c * Kp);
#pragma unroll
      for (int k4 = 0; k4 < SH_KMAX / 4; ++k4)
        if (4 * k4 < K) {                       // exact products, f32 sums
          const float4 w4 = wc[k4];
          l[4 * k4] = fmaf(av, w4.x, l[4 * k4]);
          l[4 * k4 + 1] = fmaf(av, w4.y, l[4 * k4 + 1]);
          l[4 * k4 + 2] = fmaf(av, w4.z, l[4 * k4 + 2]);
          l[4 * k4 + 3] = fmaf(av, w4.w, l[4 * k4 + 3]);
        }
    }
    const long long vox = v0 + tid;
    if (p.probs) {
      float mx = -F32_INF;
#pragma unroll
      for (int k = 0; k < SH_KMAX; ++k)
        if (k < K) mx = fmaxf(mx, l[k]);
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < SH_KMAX; ++k)
        if (k < K) {
          l[k] = expf(l[k] - mx);
          s += l[k];
        }
      bf16* out = static_cast<bf16*>(p.y) + vox * K;
      if (p.vec_out) {                // K % 8 == 0: 16-byte stores
#pragma unroll
        for (int k0 = 0; k0 < SH_KMAX; k0 += 8)
          if (k0 < K) {
            uint4 pk;
            __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&pk);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              h2[e] = __floats2bfloat162_rn(l[k0 + 2 * e] / s,
                                            l[k0 + 2 * e + 1] / s);
            *reinterpret_cast<uint4*>(out + k0) = pk;
          }
      } else {
#pragma unroll
        for (int k = 0; k < SH_KMAX; ++k)
          if (k < K) out[k] = __float2bfloat16(l[k] / s);
      }
    } else {
      float* out = static_cast<float*>(p.y) + vox * K;
      if (p.vec_out) {
#pragma unroll
        for (int k0 = 0; k0 < SH_KMAX; k0 += 4)
          if (k0 < K)
            *reinterpret_cast<float4*>(out + k0) =
                make_float4(l[k0], l[k0 + 1], l[k0 + 2], l[k0 + 3]);
      } else {
#pragma unroll
        for (int k = 0; k < SH_KMAX; ++k)
          if (k < K) out[k] = l[k];
      }
    }
  }
}

// Plain C entry point. x is (N, V, C) bf16 with V voxels per sample, w is
// (K, C) bf16; y is bf16 probs (probs != 0) or f32 logits, (N, V, K).
extern "C" int seghead_launch(const void* x, const void* mult,
                              const void* off, const void* w, void* y, int N,
                              int V, int C, int K, int probs, void* stream) {
  if (N < 1 || V < 1 || C < 1 || K < 1 || K > SH_KMAX)
    return (int)cudaErrorInvalidValue;
  HeadParams p;
  p.x = static_cast<const bf16*>(x);
  p.mult = static_cast<const float*>(mult);
  p.off = static_cast<const float*>(off);
  p.w = static_cast<const bf16*>(w);
  p.y = y;
  p.N = N; p.V = V; p.C = C; p.K = K; p.probs = probs;
  p.M = (long long)N * V;
  p.vec16 = (C % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0);
  // whole 16-byte rows of output: 8 bf16 probs or 4 f32 logits
  p.vec_out = (K % (probs ? 8 : 4) == 0 &&
               reinterpret_cast<uintptr_t>(y) % 16 == 0);
  const size_t smem =
      ((size_t)(K + 3) / 4 * 4 * C + (size_t)SH_TV * (C + 1)) * sizeof(float);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      seghead_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long ntiles = (p.M + SH_TV - 1) / SH_TV;
  int per_sm = (int)(SMEM_LIMIT / smem);
  if (per_sm < 1) per_sm = 1;
  if (per_sm > 8) per_sm = 8;
  const long long cap = (long long)num_sms() * per_sm;
  const unsigned grid = (unsigned)(ntiles < cap ? ntiles : cap);
  seghead_kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      p);
  return (int)cudaGetLastError();
}
