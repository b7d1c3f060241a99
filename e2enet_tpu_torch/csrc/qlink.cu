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
//  * downlink <- _downlink_kernel: max and min of the raw over each window,
//    the max where mult > 0 and the min elsewhere, lrelu(pick*m + o) in f32,
//    stored bf16. Reads 201 MB, writes 25 MB: bound by memory (~0.068 ms).
//  * downlink_bwd <- _downlink_bwd_kernel: the backward of the down-link.
//    The raw running max (mult > 0) or min chain over the window is
//    recomputed; ga = gy, times 0.01 where pick*m + o < 0, gives
//    g(mult) += ga*pick and g(off) += ga in f32, and ga*m walks the chain
//    backward, element k taking 1 where it beats the running value before
//    it, 0.5 where it ties, and passing the rest on; gx stored bf16.
//  * seghead  <- _seghead_probs_kernel, and _seghead_kernel as its logits
//    mode: u = lrelu(x*m + o) in f32, rounded to bf16; the 1x1 conv with f32
//    sums; then a max-subtracted f32 softmax over the classes stored bf16,
//    or the f32 logits.
//
// The up-link (redesigned for this card). At the bench geometry (64^3 x 96
// -> 128^3 x 48) it reads 50 MB and writes 201 MB per sample against 19.3
// GFLOP: bound by its bytes (~0.075 ms), the product about 0.02 ms on
// tensor cores. The first design (kept as uplink_ldg_kernel for the shapes
// the bulk route does not take) lost its time in series: every block
// staged the whole 80 KB weight image two bytes at a time with a division
// per element, a tile's x arrived by loads with no next tile in flight, and
// each chunk's product, its 2-byte epilogue and its 16-byte stores were
// separated by block barriers. Now (uplink_kernel): the weights are packed
// once per call (uplink_image_kernel) and reach each block by one bulk
// copy, from which every product warp keeps its share as mma A fragments
// in registers; x tiles arrive by bulk copies with the next in flight;
// four norm warps fill a padded u tile (bf16 arithmetic) for the next tile
// while twelve product warps run this one; the transposed product's sums
// go through movmatrix into output buffers that leave by bulk stores while
// the next tile computes. What still holds it back (copies of this source
// with one phase cut, timed in turns on the card): the product warps are
// the critical path, a call taking as long without the norm pass and
// clearly less without the products. They stay on mma.sync (the kernel is
// bound by bytes) in one block per SM (its shared memory); the output
// buffers' 192-byte rows give their bf16x2 stores 4-way bank conflicts,
// which starting lanes at different units removed at a higher cost in
// selects. Norm and products in series in 8 warps, one barrier per tile,
// measured slower than the two groups of warps.
//
// The down-link: one thread per output voxel and 8 channels (16-byte loads
// of every window position), or per channel where rows are not aligned.
//
// The down-link backward (redesigned for this card): bound by its bytes
// (403 MB read, 403 MB written at 2 x 128^3 x 48, ~0.26 ms), which the
// first design moved as 2-byte requests (one thread per output voxel and
// channel, 8 scalar loads and stores, a per-thread address array, one
// statistics atomic pair per thread). Now one thread per output voxel and
// 8-channel unit of a 2 x 2 x 2 window: 8 x 16-byte loads of x, one of gy
// and 8 x 16-byte stores of gx, lanes of a warp on consecutive units and
// voxels so a request covers whole 32-byte sectors; the float32 chain per
// element in registers, in the first design's order and rounding (gx equal
// to the bit); g(mult), g(off) summed in registers over the voxels a
// thread visits (its unit fixed), added by channel in shared memory, one
// atomic pair per channel and block. Other windows, C % 8 != 0 or
// unaligned rows keep the scalar kernel (chosen by shape). What still
// holds it back: it reaches about 80 % of a plain copy of x (the same
// bytes) on this card; each thread runs its ~500-instruction chain between
// its loads and its stores, with 8 warps per SM (159 registers), and
// neither more warps (128 registers) nor the next voxel's loads in flight
// measured faster.
//
// The seg head (redesigned for this card). It reads 201 MB and writes 67 MB
// of bf16 probs at 1 x 128^3 x 48 -> 16 (~0.080 ms), or 134 MB of f32
// logits (~0.100 ms): bound by its bytes; the 1x1 product is 3.2 GFLOP.
// The first design (kept as seghead_ldg_kernel for C % 16 != 0, C > 96,
// K > 16, N * C > 2048 or unaligned x and y) computed each voxel's logits
// on the CUDA cores from an f32 tile of C + 1 floats per voxel (50 KB at
// C = 48: few blocks per SM), its staging, products and stores in series,
// m and o read from global memory per element. Now (seghead_kernel): tiles
// of 128 voxels arrive by bulk copies into a ring with several in flight,
// the norm is applied to the mma fragments in registers ((m, o) from a
// shared table of every sample's: kept in registers instead, they took up
// to 128 registers and measured slower at the bench's probs shape), the
// 1x1 conv runs on mma.sync with the weights in registers, the softmax
// within each quad of lanes, and the outputs leave by one bulk store per
// tile (two output buffers; a third, or a smaller ring, measured the
// same). What still holds it back: at C = 96 the raw tile's 192-byte rows
// give ldmatrix 4-way bank conflicts (2-way at C = 48), which a bulk copy
// cannot pad away; each block meets one barrier per tile, before its
// store is issued.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

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

#define MAX_DEVICES 16

// A bulk kernel's launch set-up, kept per device: the largest dynamic
// shared memory allowed so far (cudaFuncSetAttribute) and the blocks the
// card holds at the last size asked (SMs x blocks per SM, the occupancy
// query). Both calls cost host time on every launch otherwise, and the
// serving paths are bound by the host.
struct LaunchCache {
  int allowed[MAX_DEVICES];
  size_t smem[MAX_DEVICES];
  int blocks[MAX_DEVICES];
};

// The most resident blocks of `kernel` at `threads` and `smem` on the
// current device (set-up cached in c).
template <class K>
static cudaError_t resident_blocks(K kernel, int threads, size_t smem,
                                   LaunchCache& c, int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool keep = dev >= 0 && dev < MAX_DEVICES;
  if (keep && c.smem[dev] == smem && c.blocks[dev] > 0) {
    *blocks = c.blocks[dev];
    return cudaSuccess;
  }
  if (!keep || (size_t)c.allowed[dev] < smem) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    if (keep) c.allowed[dev] = (int)smem;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = per_sm * num_sms();
  if (keep) {
    c.smem[dev] = smem;
    c.blocks[dev] = *blocks;
  }
  return cudaSuccess;
}

// ===========================================================================
// up-link

#define UP_TM 64           // coarse voxels per tile: one (n, d, h) row segment
#define UP_CWARPS 12       // product warps
#define UP_PWARPS 4        // norm warps
#define UP_THREADS ((UP_CWARPS + UP_PWARPS) * 32)
#define UP_M16W 2          // weight row fragments (16 output columns) per warp
#define UP_KS 6            // k steps of 16 input channels: Cin <= 96
#define UP_UNITS (2 * UP_M16W)   // 8-column output units per warp
#define UP_BARS 7          // x_full[2], u_full[2], u_empty[2], the image

// the shared-memory image of the weights both routes read: (sd*sh chunks,
// NWs columns, Cp inputs) bf16, chunk (bd, bh), column bw*Cout + co, zero
// past NW = sw*Cout and Cin; rows of Cp = Cs + 8 values (an odd number of
// 16-byte units: ldmatrix reads them without bank conflicts)
struct UpImage {
  int Cin, Cout, sd, sh, sw, chunks, NW, NWs, Cs, Cp;
  __host__ __device__ UpImage(int cin, int cout, int d, int h, int w)
      : Cin(cin), Cout(cout), sd(d), sh(h), sw(w), chunks(d * h),
        NW(w * cout), NWs((w * cout + 15) / 16 * 16),
        Cs((cin + 15) / 16 * 16), Cp((cin + 15) / 16 * 16 + 8) {}
  __host__ __device__ size_t elems() const {
    return (size_t)chunks * NWs * Cp;
  }
};

// k (Cin, Cout, sd, sh, sw) bf16, the kernel already mirrored -> the image
__global__ void uplink_image_kernel(const bf16* k, bf16* img,
                                    const UpImage im) {
  const size_t total = im.elems();
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(i % im.Cp);
    const size_t r = i / im.Cp;
    const int col = (int)(r % im.NWs), ch = (int)(r / im.NWs);
    bf16 v = __float2bfloat16(0.0f);
    if (col < im.NW && c < im.Cin) {
      const int bd = ch / im.sh, bh = ch % im.sh;
      const int bw = col / im.Cout, co = col % im.Cout;
      v = k[((((size_t)c * im.Cout + co) * im.sd + bd) * im.sh + bh) *
                im.sw + bw];
    }
    img[i] = v;
  }
}

struct UpParams {
  const bf16* x;           // (N, D, H, W, Cin)
  const float* mult;       // (N, Cin)
  const float* off;
  const bf16* img;         // the weights' image (uplink_image_kernel)
  bf16* y;                 // (N, D*sd, H*sh, W*sw, Cout)
  int N, D, H, W, Cin, Cout, sd, sh, sw;
  int NW, NWs, Cs, Cp, n_wt, ntiles, vec16;
  int img_bytes, off_a, off_o, off_mo;     // the first design's layout
  int x_bytes, u_bytes, o_chunk, nob, off_u, off_ob, off_tab, off_bar;
  int m16w, t16;
};

// the tile's coarse row: (n, d, h) and its first column w0
struct UpTile {
  int n, d, h, w0, nvalid;
  __device__ UpTile(const UpParams& p, int tile) {
    int rest = tile;
    const int wt = rest % p.n_wt;
    rest /= p.n_wt;
    h = rest % p.H;
    rest /= p.H;
    d = rest % p.D;
    n = rest / p.D;
    w0 = wt * UP_TM;
    nvalid = min(UP_TM, p.W - w0);
  }
  // the first element of the tile's x row segment
  __device__ const bf16* src(const UpParams& p) const {
    return p.x + ((((size_t)n * p.D + d) * p.H + h) * p.W + w0) * p.Cin;
  }
  // chunk (bd, bh): one contiguous segment of the finer row
  // (n, sd*d + bd, sh*h + bh) from column sw*w0 on, nvalid * NW values
  __device__ bf16* dst(const UpParams& p, int ch) const {
    const int bd = ch / p.sh, bh = ch % p.sh;
    const size_t Df = (size_t)p.D * p.sd, Hf = (size_t)p.H * p.sh,
                 Wf = (size_t)p.W * p.sw;
    return p.y + (((n * Df + (size_t)d * p.sd + bd) * Hf +
                   (size_t)h * p.sh + bh) * Wf +
                  (size_t)w0 * p.sw) * p.Cout;
  }
};

__device__ __forceinline__ unsigned movmatrix_trans(unsigned a) {
  unsigned d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(d)
               : "r"(a));
  return d;
}

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// The bulk route (uplink_route: Cin % 8 == 0 and <= 96, NW % 8 == 0, at
// most 24 weight row fragments, 16-byte aligned x, y, mult and off).
// Persistent blocks, one per SM, of 12 product warps and 4 norm warps, the
// two groups handing tiles of 64 coarse voxels to each other on mbarriers
// so that the norm of the next tile runs during the products of this one.
// The product is taken transposed: the weights are the A operand, each
// product warp's UP_M16W row fragments (16 output columns each) in
// registers for the whole kernel, read once from the image that one bulk
// copy brings into the output buffers' space; the normalised voxels are B.
//  * x: a tile's row segment (64 x Cin contiguous) arrives by one bulk copy
//    into a 2-stage ring, the tile after next issued as soon as the norm
//    warps have read a stage.
//  * the norm warps: one pass, shared to shared, into one of two padded u
//    tiles, in bf16 arithmetic (m and o rounded to bf16 once per sample
//    into a shared table); rows past W and channels past Cin zero.
//  * the product warps: per 16 voxels, per k step one ldmatrix of u and
//    UP_M16W x 2 mma.sync.m16n8k16; the sums are (output column, voxel)
//    pairs, moved to (voxel, column) pairs by movmatrix and stored as
//    bf16x2 words into the tile's output buffer, each chunk's nvalid x NW
//    block contiguous. With rows of NW = 96 values the eight rows of a
//    store fall in two bank halves (4-way conflicts); lanes starting at
//    different units remove them but measured slower (the selects cost
//    more than the conflicts).
//  * stores: once every product warp has written a tile (a named barrier),
//    one thread sends each chunk with one bulk store; nob output buffers (3
//    where they fit, else 2), a buffer written again only after its stores
//    have read it.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__global__ void __launch_bounds__(UP_THREADS, 1) uplink_kernel(
    const UpParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  unsigned char* s_x = smem;                       // 2 x x_bytes
  unsigned char* s_u = smem + p.off_u;             // 2 x u_bytes
  unsigned char* s_ob = smem + p.off_ob;           // nob x chunks x o_chunk
  float2* s_mo = reinterpret_cast<float2*>(smem + p.off_tab);  // Cs
  // x_full[2], u_full[2], u_empty[2], the image
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + p.off_bar);
  uint64_t *x_full = bar, *u_full = bar + 2, *u_empty = bar + 4;
  const int G = gridDim.x, chunks = p.sd * p.sh, Cp = p.Cp;
  const int KS = p.Cs / 16, KC8 = p.Cs / 8, CI8 = p.Cin / 8;
  const int NT_P = UP_PWARPS * 32, NT_C = UP_CWARPS * 32;
  const bool producer = warp >= UP_CWARPS;
  const int ptid = tid - NT_C;                     // producer thread

  auto issue_x = [&](int tile, int s) {
    const UpTile tl(p, tile);
    const unsigned bytes = (unsigned)(tl.nvalid * p.Cin * 2);
    mbar_expect(x_full + s, bytes);
    bulk_load(s_x + s * p.x_bytes, tl.src(p), bytes, x_full + s);
  };
  if (tid == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(x_full + b);
      mbar_init(u_full + b, NT_P);
      mbar_init(u_empty + b, UP_CWARPS);
    }
    mbar_init(bar + 6);
    mbar_init_fence();
  }
  __syncthreads();

  if (producer) {
    // ---- the norm warps
    if (ptid == 0)
      for (int s = 0; s < 2; ++s)
        if (blockIdx.x + s * G < p.ntiles) issue_x(blockIdx.x + s * G, s);
    int n_prev = -1, i = 0;
    for (int tile = blockIdx.x; tile < p.ntiles; tile += G, ++i) {
      const int s = i & 1;
      const UpTile tl(p, tile);
      if (tl.n != n_prev) {
        // m and o rounded to bf16 (zero past Cin); every norm thread is
        // past the previous tile's pass (the barrier below)
        for (int c = ptid; c < p.Cs; c += NT_P)
          s_mo[c] = c < p.Cin
                        ? make_float2(
                              round_bf16(p.mult[(size_t)tl.n * p.Cin + c]),
                              round_bf16(p.off[(size_t)tl.n * p.Cin + c]))
                        : make_float2(0.0f, 0.0f);
        n_prev = tl.n;
        named_barrier(1, NT_P);
      }
      if (i >= 2) mbar_wait(u_empty + s, ((i >> 1) + 1) & 1);
      mbar_wait(x_full + s, (i >> 1) & 1);
      // u = bf16(lrelu(x*m + o)) in bf16 arithmetic, zeros past W and Cin
      const bf16* xs = reinterpret_cast<const bf16*>(s_x + s * p.x_bytes);
      bf16* u = reinterpret_cast<bf16*>(s_u + s * p.u_bytes);
      for (int v = ptid; v < UP_TM * KC8; v += NT_P) {
        const int r = v / KC8, k8 = v - r * KC8;
        uint4 out = make_uint4(0u, 0u, 0u, 0u);
        if (r < tl.nvalid && k8 < CI8) {
          const uint4 raw = *reinterpret_cast<const uint4*>(
              xs + (size_t)r * p.Cin + 8 * k8);
          const float4* mo = reinterpret_cast<const float4*>(s_mo + 8 * k8);
          const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
          unsigned res[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float4 q = mo[e];          // m, o of channels 2e, 2e + 1
            res[e] = pack_bf16x2(
                norm_lrelu_bf16(__uint_as_float(w[e] << 16), q.x, q.y),
                norm_lrelu_bf16(__uint_as_float(w[e] & 0xFFFF0000u), q.z,
                                q.w));
          }
          out = make_uint4(res[0], res[1], res[2], res[3]);
        }
        *reinterpret_cast<uint4*>(u + (size_t)r * Cp + 8 * k8) = out;
      }
      mbar_arrive(u_full + s);
      // every norm thread has read stage s: it takes the tile after next
      named_barrier(1, NT_P);
      if (ptid == 0 && tile + 2 * G < p.ntiles) issue_x(tile + 2 * G, s);
    }
    return;
  }

  // ---- the product warps: this warp's weight fragments, row fragment
  // q = warp * m16w + i of the t16 (chunk, 16 columns) fragments
  if (tid == 0) {
    mbar_expect(bar + 6, (unsigned)p.img_bytes);
    bulk_load(s_ob, p.img, (unsigned)p.img_bytes, bar + 6);
  }
  bool on[UP_M16W];
  int unit_off[UP_UNITS];            // byte offset of a unit in a buffer
  bool unit_on[UP_UNITS];
  unsigned wa[UP_M16W][UP_KS][4];
  mbar_wait(bar + 6, 0);
#pragma unroll
  for (int i = 0; i < UP_M16W; ++i) {
    const int q = warp * p.m16w + i;
    on[i] = i < p.m16w && q < p.t16;
    const int ch = on[i] ? q / (p.NWs / 16) : 0;
    const int col0 = on[i] ? (q % (p.NWs / 16)) * 16 : 0;
    const unsigned a_addr = smem_u32(
        s_ob + ((size_t)(ch * p.NWs + col0 + lane % 16) * Cp +
                (lane / 16) * 8) * 2);
#pragma unroll
    for (int ks = 0; ks < UP_KS; ++ks) {
      if (on[i] && ks < KS) {
        ldmatrix_x4(wa[i][ks], a_addr + ks * 32);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) wa[i][ks][e] = 0u;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = col0 + 8 * h;
      unit_on[2 * i + h] = on[i] && col < p.NW;
      unit_off[2 * i + h] = ch * p.o_chunk + (col + 2 * t) * 2;
    }
  }
  // every product warp holds its weights before the image's space becomes
  // the output buffers
  named_barrier(2, NT_C);
  const int b_row = lane % 8 + (lane / 16) * 8, b_k = ((lane / 8) % 2) * 8;

  int i = 0;
  for (int tile = blockIdx.x; tile < p.ntiles; tile += G, ++i) {
    const int s = i & 1;
    mbar_wait(u_full + s, (i >> 1) & 1);
    unsigned char* ob = s_ob + (i % p.nob) * chunks * p.o_chunk;
    const unsigned u_addr =
        smem_u32(s_u + s * p.u_bytes + ((size_t)b_row * Cp + b_k) * 2);
    for (int vg = 0; vg < UP_TM / 16; ++vg) {
      float acc[UP_M16W][2][4];
#pragma unroll
      for (int a = 0; a < UP_M16W; ++a)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[a][j][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < UP_KS; ++ks) {
        if (ks < KS) {
          unsigned b[4];
          ldmatrix_x4(b, u_addr + (vg * 16 * Cp + ks * 16) * 2);
#pragma unroll
          for (int a = 0; a < UP_M16W; ++a)
            if (on[a]) {
              mma_16816(acc[a][0], wa[a][ks], b[0], b[1]);
              mma_16816(acc[a][1], wa[a][ks], b[2], b[3]);
            }
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // unit 2a + h: output columns 8h .. 8h + 7 of fragment a; after
        // the transpose, voxel g of the 8 and columns 2t, 2t + 1
        unsigned tr[UP_UNITS];
#pragma unroll
        for (int a = 0; a < UP_M16W; ++a)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            tr[2 * a + h] = movmatrix_trans(
                pack_bf16x2(acc[a][j][2 * h], acc[a][j][2 * h + 1]));
        unsigned char* row =
            ob + (size_t)(vg * 16 + j * 8 + g) * p.NW * 2;
#pragma unroll
        for (int k = 0; k < UP_UNITS; ++k)
          if (unit_on[k]) *reinterpret_cast<unsigned*>(row + unit_off[k]) =
              tr[k];
      }
    }
    // u tile s is free for the norm warps
    __syncwarp();
    if (lane == 0) mbar_arrive(u_empty + s);
    fence_proxy_async();
    // the stores of tile i - nob + 1 have read the buffer tile i + 1 writes
    if (tid == 0) {
      if (p.nob == 3)
        bulk_wait_read<1>();
      else
        bulk_wait_read<0>();
    }
    named_barrier(2, NT_C);
    if (tid == 0) {
      const UpTile tl(p, tile);
      for (int ch = 0; ch < chunks; ++ch)
        bulk_store(tl.dst(p, ch), ob + ch * p.o_chunk,
                   (unsigned)(tl.nvalid * p.NW * 2));
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait_all();
}

// The first design, kept for the shapes the bulk route does not take:
// persistent blocks of 8 warps walk tiles of 64 coarse voxels of one
// (n, d, h) row. The weights' image is staged once per block (16-byte
// loads). A tile stages its normalised voxels once (16-byte loads where x
// rows are aligned); per chunk (bd, bh) the product runs on ldmatrix +
// mma.sync.m16n8k16 with the voxels as A, and its sw*Cout columns per voxel
// pass through shared memory to 16-byte stores.
#define UP_WM 4            // warps along M (one row fragment each)
#define UP_WN 2            // warps along N
#define UP_NFW 4           // 16-wide column fragments per warp: NW <= 128

__global__ void __launch_bounds__(NTHREADS) uplink_ldg_kernel(
    const UpParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int Cs = p.Cs, Cp = p.Cp, NWs = p.NWs, KC8 = Cs / 8;
  const int chunks = p.sd * p.sh;
  bf16* s_w = reinterpret_cast<bf16*>(smem);
  bf16* s_a = reinterpret_cast<bf16*>(smem + p.off_a);
  bf16* s_o = reinterpret_cast<bf16*>(smem + p.off_o);
  float* s_m = reinterpret_cast<float*>(smem + p.off_mo);
  float* s_of = s_m + Cs;

  for (int i = tid; i < p.img_bytes / 16; i += NTHREADS)
    reinterpret_cast<uint4*>(s_w)[i] =
        __ldg(reinterpret_cast<const uint4*>(p.img) + i);
  const int wm = warp % UP_WM, wn = warp / UP_WM;
  const int NF = NWs / 16;
  bool nf_on[UP_NFW];
#pragma unroll
  for (int j = 0; j < UP_NFW; ++j) nf_on[j] = wn * UP_NFW + j < NF;
  const int a_row = lane % 16, a_k = (lane / 16) * 8;
  const int b_row = lane % 8 + (lane / 16) * 8, b_k = ((lane / 8) % 2) * 8;

  int n_prev = -1;
  for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
    const UpTile tl(p, tile);
    const int n = tl.n, nvalid = tl.nvalid;
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
    const bf16* xrow = tl.src(p);
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
      bf16* dst = tl.dst(p, ch);
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

static size_t align128(size_t v) { return (v + 127) / 128 * 128; }

// The layout of the bulk route; false where it does not take the shape.
static bool uplink_bulk_layout(UpParams& p) {
  if (p.Cin % 8 || p.Cs > 16 * UP_KS || p.NW % 8) return false;
  p.t16 = p.sd * p.sh * (p.NWs / 16);
  p.m16w = (p.t16 + UP_CWARPS - 1) / UP_CWARPS;
  if (p.m16w > UP_M16W) return false;
  const int chunks = p.sd * p.sh;
  p.x_bytes = (int)align128((size_t)UP_TM * p.Cin * 2);
  p.u_bytes = (int)align128((size_t)UP_TM * p.Cp * 2);
  p.o_chunk = UP_TM * p.NW * 2;             // a multiple of 128
  p.off_u = 2 * p.x_bytes;
  p.off_ob = p.off_u + 2 * p.u_bytes;
  for (p.nob = 3; p.nob >= 2; --p.nob) {
    const size_t ob = (size_t)p.nob * chunks * p.o_chunk;
    p.off_tab = (int)align128(p.off_ob + (ob > (size_t)p.img_bytes
                                               ? ob : (size_t)p.img_bytes));
    p.off_bar = p.off_tab + (int)align128((size_t)p.Cs * sizeof(float2));
    if ((size_t)p.off_bar + UP_BARS * sizeof(uint64_t) <= SMEM_LIMIT)
      return true;
  }
  return false;
}

static bool uplink_params(UpParams& p, const void* x, const void* mult,
                          const void* off, const void* y, int Cin, int Cout,
                          int sd, int sh, int sw) {
  const UpImage im(Cin, Cout, sd, sh, sw);
  p.Cin = Cin; p.Cout = Cout; p.sd = sd; p.sh = sh; p.sw = sw;
  p.NW = im.NW; p.NWs = im.NWs; p.Cs = im.Cs; p.Cp = im.Cp;
  p.img_bytes = (int)(im.elems() * sizeof(bf16));
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(mult) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(off) % 16 == 0;
  return aligned && uplink_bulk_layout(p);
}

static cudaError_t launch_uplink_image(const void* k, void* img,
                                       const UpImage& im, cudaStream_t s) {
  const int blocks = (int)((im.elems() + 255) / 256);
  uplink_image_kernel<<<blocks < 1024 ? blocks : 1024, 256, 0, s>>>(
      static_cast<const bf16*>(k), static_cast<bf16*>(img), im);
  return cudaGetLastError();
}

// The weights' image alone: k (Cin, Cout, sd, sh, sw) bf16 contiguous ->
// img, uplink_image_bytes of scratch.
extern "C" int uplink_image_launch(const void* k, void* img, int Cin,
                                   int Cout, int sd, int sh, int sw,
                                   void* stream) {
  if (Cin < 1 || Cout < 1 || sd < 1 || sh < 1 || sw < 1)
    return (int)cudaErrorInvalidValue;
  return (int)launch_uplink_image(k, img, UpImage(Cin, Cout, sd, sh, sw),
                                  static_cast<cudaStream_t>(stream));
}

// The bytes of the weights' image, the scratch uplink_launch packs into.
extern "C" int uplink_image_bytes(int Cin, int Cout, int sd, int sh, int sw) {
  return (int)(UpImage(Cin, Cout, sd, sh, sw).elems() * sizeof(bf16));
}

// The route rule: 1 where the bulk route (uplink_kernel) takes the shape,
// 0 where the first design (uplink_ldg_kernel) does.
extern "C" int uplink_route(const void* x, const void* mult, const void* off,
                            const void* y, int Cin, int Cout, int sd, int sh,
                            int sw) {
  UpParams p;
  return uplink_params(p, x, mult, off, y, Cin, Cout, sd, sh, sw) ? 1 : 0;
}

// Plain C entry point. k is (Cin, Cout, sd, sh, sw) bf16 contiguous with
// the kernel already mirrored; img a scratch of uplink_image_bytes. Packs
// the weights' image, then runs the route uplink_route gives (written to
// *route). Returns a cudaError_t; launches on `stream`.
extern "C" int uplink_launch(const void* x, const void* mult, const void* off,
                             const void* k, void* img, void* y, int N, int D,
                             int H, int W, int Cin, int Cout, int sd, int sh,
                             int sw, int* route, void* stream) {
  if (N < 1 || D < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 || sd < 1 ||
      sh < 1 || sw < 1 || img == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  UpParams p;
  const bool bulk = uplink_params(p, x, mult, off, y, Cin, Cout, sd, sh, sw);
  if (reinterpret_cast<uintptr_t>(img) % 16 ||
      (!bulk && p.NWs > UP_WN * UP_NFW * 16))
    return (int)cudaErrorInvalidValue;
  p.x = static_cast<const bf16*>(x);
  p.mult = static_cast<const float*>(mult);
  p.off = static_cast<const float*>(off);
  p.img = static_cast<const bf16*>(img);
  p.y = static_cast<bf16*>(y);
  p.N = N; p.D = D; p.H = H; p.W = W;
  p.vec16 = (reinterpret_cast<uintptr_t>(x) % 16 == 0 && Cin % 8 == 0);
  p.n_wt = (W + UP_TM - 1) / UP_TM;
  const long long ntiles = (long long)N * D * H * p.n_wt;
  if (ntiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  p.ntiles = (int)ntiles;
  cudaError_t err =
      launch_uplink_image(k, img, UpImage(Cin, Cout, sd, sh, sw), s);
  if (err != cudaSuccess) return (int)err;
  if (bulk) {
    static LaunchCache cache;
    const size_t smem = (size_t)p.off_bar + UP_BARS * sizeof(uint64_t);
    int blocks = 0;
    err = resident_blocks(uplink_kernel, UP_THREADS, smem, cache, &blocks);
    if (err != cudaSuccess) return (int)err;
    const int grid = p.ntiles < blocks ? p.ntiles : blocks;
    uplink_kernel<<<grid, UP_THREADS, smem, s>>>(p);
    *route = 1;
    return (int)cudaGetLastError();
  }
  p.off_a = (int)align128((size_t)p.img_bytes);
  p.off_o = p.off_a + (int)align128((size_t)UP_TM * p.Cp * sizeof(bf16));
  p.off_mo = p.off_o + (int)align128((size_t)UP_TM * p.NW * sizeof(bf16));
  const size_t smem = (size_t)p.off_mo + 2 * p.Cs * sizeof(float);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(uplink_ldg_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = (int)(SMEM_LIMIT / smem);
  if (per_sm < 1) per_sm = 1;
  if (per_sm > 4) per_sm = 4;
  const int grid = p.ntiles < num_sms() * per_sm ? p.ntiles
                                                 : num_sms() * per_sm;
  uplink_ldg_kernel<<<grid, NTHREADS, smem, s>>>(p);
  *route = 0;
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

#define SH_WARPS 8
#define SH_THREADS (SH_WARPS * 32)
#define SH_T (16 * SH_WARPS)   // voxels per tile of the bulk route
#define SH_KS_MAX 6            // k steps of 16 channels (bulk): C <= 96
#define SH_RING_BYTES (72 * 1024)
#define SH_MO_BYTES (16 * 1024)  // the (m, o) table of every sample (bulk)
#define SH_TV NTHREADS         // voxels per tile of the ldg route
#define SH_KMAX 32             // classes

struct HeadParams {
  const bf16* x;           // (N * V, C)
  const float* mult;       // (N, C)
  const float* off;
  const bf16* w;           // (K, C)
  void* y;                 // (N * V, K): bf16 probs or f32 logits
  int N, V, C, K, probs, vec16, vec_out;
  long long M;             // N * V voxels
  // the bulk route: S stages of in_bytes, two output buffers of out_bytes
  long long ntiles;
  int S, in_bytes, out_bytes, esize, off_out, off_mo, off_bar;
};

// a bf16 pair of raw values -> the bf16 pair of u = lrelu(x*m + o), f32
__device__ __forceinline__ unsigned norm_pair(unsigned raw, float m0,
                                              float o0, float m1, float o1) {
  return pack_bf16x2(norm_lrelu(__uint_as_float(raw << 16), m0, o0),
                     norm_lrelu(__uint_as_float(raw & 0xFFFF0000u), m1, o1));
}

// The bulk route (seghead_route: C % 16 == 0 and <= 96, K <= 16, N * C <=
// 2048, 16-byte aligned x and y). Persistent blocks of 8 warps walk tiles
// of 128 voxels (128 x C contiguous), which arrive by one bulk copy each
// into a ring of S stages (2-4, about 72 KB), S - 1 tiles in flight while
// one computes. Each warp takes 16 voxels: per k step one ldmatrix of raw
// A fragments and the norm applied to the fragment in registers, each
// register's (m, o) pair of channels one 16-byte load from a shared table
// of every sample's (a tile may straddle two samples: each row reads its
// own sample's), then two mma.sync.m16n8k16 (the K <= 16 classes as two n8
// fragments, the weights in registers for the whole kernel). A voxel's 16
// sums sit in one quad of lanes: the softmax's max and sum take two xor
// shuffles each (expf and an exact division, as the ldg route). The
// outputs (bf16 probs or f32 logits) go to one of two shared output tiles
// and leave by one bulk store per tile, which the next tile's computation
// overlaps; its buffer is written again only after that store has read it.
// wgmma's 64-row warpgroup tiles would buy nothing here: the product is 3.2
// GFLOP at the bench's probs shape, a few microseconds on tensor cores, and
// the kernel is bound by its bytes.
template <int KS>
__global__ void __launch_bounds__(SH_THREADS, 2) seghead_kernel(
    const HeadParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int C = p.C, K = p.K;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + p.off_bar);
  const long long G = gridDim.x;
  auto issue = [&](long long tile, int s) {
    const long long v0 = tile * SH_T;
    const unsigned bytes =
        (unsigned)(min((long long)SH_T, p.M - v0) * C * 2);
    mbar_expect(bar + s, bytes);
    bulk_load(smem + s * p.in_bytes, p.x + v0 * C, bytes, bar + s);
  };
  // (m, o) of every sample and channel, (N, C) float2
  float2* s_mo = reinterpret_cast<float2*>(smem + p.off_mo);
  for (int e = tid; e < p.N * C; e += SH_THREADS)
    s_mo[e] = make_float2(p.mult[e], p.off[e]);
  if (tid == 0) {
    for (int s = 0; s < p.S; ++s) mbar_init(bar + s);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < p.S; ++s)
      if (blockIdx.x + s * G < p.ntiles) issue(blockIdx.x + s * G, s);

  // the weights as B: n8 fragment j holds class 8j + g, channels 16ks + 2t,
  // +1 (b0) and 16ks + 8 + 2t, +1 (b1); zero past K
  unsigned bw[KS][2][2];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int cls = 8 * j + g;
        bw[ks][j][h] = cls < K ? __ldg(reinterpret_cast<const unsigned*>(
                                     p.w + (size_t)cls * C + 16 * ks +
                                     8 * h + 2 * t))
                               : 0u;
      }
  const int a_row = lane % 16, a_k = (lane / 16) * 8;
  const float NEG_INF = -F32_INF;

  int i = 0;
  for (long long tile = blockIdx.x; tile < p.ntiles; tile += G, ++i) {
    const int s = i % p.S;
    mbar_wait(bar + s, (i / p.S) & 1);
    const long long v0 = tile * SH_T;
    const int nv = (int)min((long long)SH_T, p.M - v0);
    unsigned char* ob = smem + p.off_out + (i & 1) * p.out_bytes;
    const int r0 = warp * 16;
    if (r0 < nv) {
      // the (m, o) rows of the samples of row g (h = 0) and g + 8 (h = 1):
      // tiles may straddle samples
      const float2* mo[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        mo[h] = s_mo + (size_t)((v0 + min(r0 + g + 8 * h, nv - 1)) / p.V) *
                           C + 2 * t;
      float acc[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
      const unsigned a_addr = smem_u32(
          smem + s * p.in_bytes + ((size_t)(r0 + a_row) * C + a_k) * 2);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        unsigned a[4];
        ldmatrix_x4(a, a_addr + ks * 32);
        // register e: row g + 8 (e % 2), channels 16ks + 8 (e / 2) + 2t, +1
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // (m, o) of channels c and c + 1 in one 16-byte load
          const float4 q = *reinterpret_cast<const float4*>(
              mo[e % 2] + 16 * ks + 8 * (e / 2));
          a[e] = norm_pair(a[e], q.x, q.y, q.z, q.w);
        }
        mma_16816(acc[0], a, bw[ks][0][0], bw[ks][0][1]);
        mma_16816(acc[1], a, bw[ks][1][0], bw[ks][1][1]);
      }
      // row g + 8h: classes 2t, 2t + 1, 8 + 2t, 9 + 2t
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float l[4] = {acc[0][2 * h], acc[0][2 * h + 1], acc[1][2 * h],
                      acc[1][2 * h + 1]};
        const int row = r0 + g + 8 * h;
        if (p.probs) {
          float mx = NEG_INF;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int cls = 8 * (e / 2) + 2 * t + e % 2;
            if (cls >= K) l[e] = NEG_INF;
            mx = fmaxf(mx, l[e]);
          }
          mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, 2));
#pragma unroll
          for (int e = 0; e < 4; ++e) l[e] = expf(l[e] - mx);
          float sum = (l[0] + l[1]) + (l[2] + l[3]);
          sum += __shfl_xor_sync(0xFFFFFFFFu, sum, 1);
          sum += __shfl_xor_sync(0xFFFFFFFFu, sum, 2);
#pragma unroll
          for (int e = 0; e < 4; ++e) l[e] = l[e] / sum;
          bf16* o = reinterpret_cast<bf16*>(ob) + (size_t)row * K;
          if (K == 16) {
            *reinterpret_cast<unsigned*>(o + 2 * t) = pack_bf16x2(l[0], l[1]);
            *reinterpret_cast<unsigned*>(o + 8 + 2 * t) =
                pack_bf16x2(l[2], l[3]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int cls = 8 * (e / 2) + 2 * t + e % 2;
              if (cls < K) o[cls] = __float2bfloat16(l[e]);
            }
          }
        } else {
          float* o = reinterpret_cast<float*>(ob) + (size_t)row * K;
          if (K == 16) {
            *reinterpret_cast<float2*>(o + 2 * t) = make_float2(l[0], l[1]);
            *reinterpret_cast<float2*>(o + 8 + 2 * t) =
                make_float2(l[2], l[3]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int cls = 8 * (e / 2) + 2 * t + e % 2;
              if (cls < K) o[cls] = l[e];
            }
          }
        }
      }
    }
    fence_proxy_async();
    // the store of the previous tile has read the other output buffer,
    // which the next tile writes
    if (tid == 0) bulk_wait_read<0>();
    __syncthreads();
    char* dst = static_cast<char*>(p.y) + v0 * K * p.esize;
    const int bytes = nv * K * p.esize;
    if (bytes % 16 == 0) {
      if (tid == 0) {
        bulk_store(dst, ob, (unsigned)bytes);
        bulk_commit();
      }
    } else {
      // the ragged last tile of the tensor: element by element
      if (p.probs) {
        for (int e = tid; e < nv * K; e += SH_THREADS)
          reinterpret_cast<bf16*>(dst)[e] = reinterpret_cast<bf16*>(ob)[e];
      } else {
        for (int e = tid; e < nv * K; e += SH_THREADS)
          reinterpret_cast<float*>(dst)[e] = reinterpret_cast<float*>(ob)[e];
      }
    }
    // every warp has read stage s: it takes the tile S tiles on
    if (tid == 0 && tile + p.S * G < p.ntiles) issue(tile + p.S * G, s);
  }
  if (tid == 0) bulk_wait_all();
}

// The first design, kept for the shapes the bulk route does not take:
// blocks of 256 voxels; the normalised tile is staged in shared memory as
// f32 (16-byte loads), then one thread per voxel computes its K logits on
// the CUDA cores from shared-memory weights (transposed, four classes per
// 16-byte load), the softmax, and stores its K outputs in 16-byte rows.
__global__ void __launch_bounds__(NTHREADS) seghead_ldg_kernel(
    const HeadParams p) {
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

// The route rule: 1 where the bulk route (seghead_kernel) takes the shape,
// 0 where the first design (seghead_ldg_kernel) does.
extern "C" int seghead_route(const void* x, const void* w, const void* y,
                             int N, int C, int K) {
  return C % 16 == 0 && C / 16 <= SH_KS_MAX && K >= 1 && K <= 16 &&
         (long long)N * C * sizeof(float2) <= SH_MO_BYTES &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(w) % 4 == 0;
}

template <int KS>
static int launch_seghead_bulk(HeadParams& p, cudaStream_t stream) {
  p.esize = p.probs ? 2 : 4;
  p.in_bytes = SH_T * p.C * 2;                     // a multiple of 128
  p.out_bytes = (int)align128((size_t)SH_T * p.K * p.esize);
  p.S = SH_RING_BYTES / p.in_bytes;
  p.S = p.S < 2 ? 2 : p.S > 4 ? 4 : p.S;
  p.off_out = p.S * p.in_bytes;
  p.off_mo = p.off_out + 2 * p.out_bytes;
  p.off_bar = p.off_mo + (int)align128((size_t)p.N * p.C * sizeof(float2));
  p.ntiles = (p.M + SH_T - 1) / SH_T;
  static LaunchCache cache;
  const size_t smem = (size_t)p.off_bar + 4 * sizeof(uint64_t);
  int blocks = 0;
  const cudaError_t err =
      resident_blocks(seghead_kernel<KS>, SH_THREADS, smem, cache, &blocks);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid =
      (unsigned)(p.ntiles < blocks ? p.ntiles : (long long)blocks);
  seghead_kernel<KS><<<grid, SH_THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Plain C entry point. x is (N, V, C) bf16 with V voxels per sample, w is
// (K, C) bf16; y is bf16 probs (probs != 0) or f32 logits, (N, V, K). Runs
// the route seghead_route gives (written to *route).
extern "C" int seghead_launch(const void* x, const void* mult,
                              const void* off, const void* w, void* y, int N,
                              int V, int C, int K, int probs, int* route,
                              void* stream) {
  if (N < 1 || V < 1 || C < 1 || K < 1 || K > SH_KMAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  HeadParams p;
  p.x = static_cast<const bf16*>(x);
  p.mult = static_cast<const float*>(mult);
  p.off = static_cast<const float*>(off);
  p.w = static_cast<const bf16*>(w);
  p.y = y;
  p.N = N; p.V = V; p.C = C; p.K = K; p.probs = probs;
  p.M = (long long)N * V;
  if (seghead_route(x, w, y, N, C, K)) {
    *route = 1;
    switch (C / 16) {
      case 1: return launch_seghead_bulk<1>(p, s);
      case 2: return launch_seghead_bulk<2>(p, s);
      case 3: return launch_seghead_bulk<3>(p, s);
      case 4: return launch_seghead_bulk<4>(p, s);
      case 5: return launch_seghead_bulk<5>(p, s);
      default: return launch_seghead_bulk<6>(p, s);
    }
  }
  *route = 0;
  p.vec16 = (C % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0);
  // whole 16-byte rows of output: 8 bf16 probs or 4 f32 logits
  p.vec_out = (K % (probs ? 8 : 4) == 0 &&
               reinterpret_cast<uintptr_t>(y) % 16 == 0);
  const size_t smem =
      ((size_t)(K + 3) / 4 * 4 * C + (size_t)SH_TV * (C + 1)) * sizeof(float);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      seghead_ldg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long ntiles = (p.M + SH_TV - 1) / SH_TV;
  int per_sm = (int)(SMEM_LIMIT / smem);
  if (per_sm < 1) per_sm = 1;
  if (per_sm > 8) per_sm = 8;
  const long long cap = (long long)num_sms() * per_sm;
  const unsigned grid = (unsigned)(ntiles < cap ? ntiles : cap);
  seghead_ldg_kernel<<<grid, NTHREADS, smem, s>>>(p);
  return (int)cudaGetLastError();
}
