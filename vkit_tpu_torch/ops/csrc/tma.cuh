// Hopper's bulk asynchronous copy (TMA 1-D, cp.async.bulk) into shared
// memory and the mbarrier it completes on: the staging pieces that
// row_shift.cu (K1 / K4) and banded_resample.cu (K3) share.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One arrival (the thread that starts the copies) completes a phase once
// the expected bytes have landed.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  return done != 0;
}

// Waits for the phase of `parity` to complete.  A copy that never lands is
// a bug: after ~2^34 cycles (seconds) the kernel traps, so the launch fails
// with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long begin = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - begin > (1ll << 34)) __trap();
  }
}

// Orders this CTA's earlier generic-proxy accesses of shared memory before
// the async proxy's writes that follow (a stage is read, then refilled).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// `bytes` (a multiple of 16) from 16-byte-aligned global `src` to
// 16-byte-aligned shared `dst`, completing on `bar`.
__device__ __forceinline__ void bulk_copy_g2s(float* dst, const float* src,
                                              uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)),
         "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

}  // namespace tma
