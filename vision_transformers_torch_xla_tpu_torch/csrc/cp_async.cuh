// cp.async: copies from device memory into shared memory that run under the
// block's work, shared by the CUDA-core kernels (csrc/cc_tiles.cuh's users,
// the fp32 K3 of csrc/mlp_fused.cu, the fp32 K5 and K6 of
// csrc/flash_bwd_simt.cu).

#pragma once

#include <stdint.h>

namespace {

// kBytes (4, 8 or 16) from src into dst, or zeros when !ok (nothing is read
// then). 16-byte copies bypass L1.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool ok = true) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(kBytes), "r"(ok ? kBytes : 0)
                 : "memory");
}

// 16 bytes into dst: the first `bytes` (0 to 16) from src, which is 16-byte
// aligned, then zeros (nothing is read past them).
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src,
                                               int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace
