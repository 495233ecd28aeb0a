// PTX primitives of the PPO gradient kernels (`ppo_grad.cuh`), for sm_90a:
// the split of an f32 operand into two TF32 parts, the m16n8k8 TF32 tensor-
// core product, and asynchronous copies from global to shared memory.

#pragma once

#include <stdint.h>

namespace ppo_grad {

// x = hi + lo up to 2^-22 |x|: hi = tf32(x), x rounded to a 10-bit mantissa
// to nearest, ties away from zero (cvt.rna), and lo = tf32(x - hi) the same
// way, x - hi being exact in f32. lo is rounded by adding half a TF32 ulp:
// the tensor cores ignore an operand's low 13 bits, so they read it rounded.
// A NaN or infinite x keeps hi NaN or infinite (cvt keeps both), which
// every product with hi carries; lo's bits do not matter then.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// c += a b for one 16 x 8 tile over a depth of 8, operands in TF32, the sum
// in f32. Fragments as the PTX ISA lays them out for m16n8k8 .tf32 with
// g = lane / 4 and t = lane % 4: a = A[g][t], A[g+8][t], A[g][t+4],
// A[g+8][t+4]; b = B[t][g], B[t+4][g]; c = C[g][2t], C[g][2t+1],
// C[g+8][2t], C[g+8][2t+1].
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes (both addresses 16-byte aligned) or 4 bytes, global to shared,
// completed by cp_async_wait_all in the copying thread.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

}  // namespace ppo_grad
