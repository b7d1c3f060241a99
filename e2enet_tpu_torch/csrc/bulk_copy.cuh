// Bulk copies between global and shared memory (cp.async.bulk, the Tensor
// Memory Accelerator without a tensor map), for NVIDIA Hopper (sm_90a).
// Shared by the fused block (#1, fused_block.cu), the links and seg head
// (qlink.cu) and, for fence_proxy_async, the wgmma body
// (shift_conv_block.cuh).
//
// A load is counted on an mbarrier: one thread arms it with the bytes to
// expect (mbar_expect), issues the copies (bulk_load) and every consumer
// waits on the barrier's phase (mbar_wait). A store is counted in the
// issuing thread's bulk groups: the threads that wrote the shared source
// make their writes visible to the copy engine (fence_proxy_async), meet
// at a barrier, then one thread issues the stores (bulk_store), closes the
// group (bulk_commit) and, before the source is written again, waits until
// at most N of its groups still read shared memory (bulk_wait_read<N>).
// Sizes are multiples of 16 bytes, addresses 16-byte aligned.
#pragma once

#include <stdint.h>

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return (unsigned)__cvta_generic_to_shared(ptr);
}
// an mbarrier that completes a phase on `count` arrivals (and the bytes
// armed by mbar_expect)
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}
// the calling thread arrives at the mbarrier (release: its earlier writes
// to shared memory are seen by the threads that then wait on the phase)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// make the initialised mbarriers visible to the copy engine
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// the calling thread arrives at the mbarrier (arrival count 1), which then
// waits for `bytes` more of bulk copies
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// one bulk copy of `bytes` (a multiple of 16) into shared memory, counted
// on the mbarrier
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// shared memory written by this thread (st.shared, cp.async) made visible
// to the async proxy, which bulk stores and wgmma read through: by every
// writer after its writes have landed, before the barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// one bulk copy of `bytes` (a multiple of 16) from shared to global memory,
// in the calling thread's open bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           unsigned bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// wait until at most N of the calling thread's bulk groups still read their
// shared-memory sources
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// wait until the calling thread's bulk groups are complete (their writes
// done)
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
