// Tensor-map copies (cp.async.bulk.tensor, the Tensor Memory Accelerator)
// and the wgmma descriptor of the 128-byte-swizzled tiles they write, for
// NVIDIA Hopper (sm_90a). Shared by the tensor-core product (#14,
// mma_gemm.cu) and the channels-first block (#12, cf_fused.cu).
//
// A tensor map describes a tensor of up to 5 dimensions (dimension 0
// contiguous, the others at strides that are multiples of 16 bytes) and
// the box one copy moves; it is encoded on the host by the driver's
// cuTensorMapEncodeTiled, fetched through the runtime
// (cudaGetDriverEntryPoint), so no driver library is linked. Loads are
// counted on an mbarrier (bulk_copy.cuh); elements of a box outside the
// tensor read as zero, and a store writes only the elements inside it.
// With the 128-byte swizzle a box's rows of 128 bytes land in shared
// memory with their 16-byte chunks permuted: chunk j of row r (rows
// counted from a 1024-byte-aligned base) holds chunk j ^ (r % 8).
#pragma once

#include <cuda.h>          // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

// one 2D box (inner coordinate c0, outer c1) into shared memory, counted
// on the mbarrier
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}
// one 5D box at coordinates c0 (innermost) .. c4 into shared memory,
// counted on the mbarrier
__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            int c4, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4), "r"(smem_u32(bar))
      : "memory");
}
// one 5D box from shared memory to the tensor, in the calling thread's
// open bulk group (bulk_commit, bulk_wait_read in bulk_copy.cuh); the
// writers of the source have made it visible first (fence_proxy_async and
// a barrier)
__device__ __forceinline__ void tma_store_5d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group"
      " [%0, {%1, %2, %3, %4, %5}], [%6];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4), "r"(smem_u32(src))
      : "memory");
}

// wgmma matrix descriptor of a 128-byte-swizzled tile at shared address
// `addr` (the swizzle atom, 8 rows of 128 bytes, 1024-byte aligned): LBO
// and SBO in bytes. K-major: SBO 1024 from one 8-row group to the next,
// LBO unused; a k step moves the start by its 32 bytes. MN-major (rows of
// 64 bf16 along M or N, one row per k): SBO 1024 from 8 k rows to the
// next 8, LBO from one 64-element row block to the next; a k16 step moves
// the start 2048 bytes.
__device__ __forceinline__ uint64_t desc_sw128(unsigned addr, unsigned lbo,
                                               unsigned sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// cuTensorMapEncodeTiled, from the driver through the runtime
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a tensor of `rank` dimensions (dims[0] contiguous; strides[i] the bytes
// between neighbours along dimension i + 1) read or written in boxes of
// box[0] x .. x box[rank - 1], with the given swizzle; zero fill outside
static int tensor_map(CUtensorMap* map, CUtensorMapDataType type, int rank,
                      const void* ptr, const uint64_t* dims,
                      const uint64_t* strides, const int* box,
                      CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  cuuint64_t d[5], st[4];
  cuuint32_t bx[5], unit[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = (cuuint64_t)dims[i];
    bx[i] = (cuuint32_t)box[i];
    unit[i] = 1;
    if (i + 1 < rank) st[i] = (cuuint64_t)strides[i];
  }
  const CUresult r = fn(map, type, (cuuint32_t)rank, const_cast<void*>(ptr),
                        d, st, bx, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// a 2D row-major tensor (outer rows of `inner` elements, `row_bytes`
// apart) read in boxes of box_inner x box_outer, 128-byte swizzle
static int tensor_map_2d(CUtensorMap* map, CUtensorMapDataType type,
                         const void* ptr, int inner, int outer,
                         uint64_t row_bytes, int box_inner, int box_outer) {
  const uint64_t dims[2] = {(uint64_t)inner, (uint64_t)outer};
  const int box[2] = {box_inner, box_outer};
  return tensor_map(map, type, 2, ptr, dims, &row_bytes, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}
