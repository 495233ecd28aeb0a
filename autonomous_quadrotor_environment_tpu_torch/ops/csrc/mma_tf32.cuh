// The tensor-core products shared by the PPO gradient kernels
// (`ppo_grad.cuh`) and the rollout kernel (`rollout_fused.cu`), for sm_90a:
// the split of an f32 operand into two TF32 parts, the m16n8k8 TF32 tensor-
// core product, the m16n8k16 bf16 product, asynchronous copies from global
// to shared memory, the fragment views of operands (in shared memory, or in
// global memory where the weights do not fit beside the rest; one with a
// row stride set at run time for the wide kernels) and a warp's tile
// product in 3xTF32 or in bf16.

#pragma once

#include <cuda_bf16.h>
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

// c += a b for one 16 x 8 tile over a depth of 16, operands in bf16, the
// sum in f32. Each register holds two bf16 of consecutive k, the lower k in
// the low half: a = A[g][2t..], A[g+8][2t..], A[g][2t+8..], A[g+8][2t+8..];
// b = B[2t..][g], B[2t+8..][g]; c as for mma_tf32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two floats rounded to bf16 to nearest even (as JAX's astype(bfloat16)),
// packed for mma_bf16: x in the low half.
__device__ __forceinline__ uint32_t bf16x2(float2 v) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// x rounded to bf16 to nearest even, as a float.
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
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
// Wait until at most N of the copying thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// 16-byte reads (read-only global, or any) and writes.
__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void sts4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// The column swizzle of row `row` in a swizzled operand (X^T, H1, H2 and W2
// of the gradient kernels; H1 and W2 of the rollout): it flips bits 2-4 of
// the column only, so aligned groups of 4 (and pairs) stay together.
__device__ __forceinline__ int swz(int row) { return ((row & 3) << 3) | (row & 4); }

// Fragment reads. A warp's operand tiles are 8 x 8 blocks c = 0, 1, ... of
// its rows idx0 + 8 c + g (lane g = lane / 4, t = lane % 4) at depth step i,
// columns k = 8 i + t + 4 q (q = 0, 1): a = (c 2mt, q 0), (2mt + 1, 0),
// (2mt, 1), (2mt + 1, 1) of an m16 tile; b = (nt, 0), (nt, 1) of an n8 tile.
// Each view keeps per-thread bases, so a depth step adds an immediate (or
// one XOR) to them. For the bf16 products each view also reads the pair
// (idx0 + ri, k), (idx0 + ri, k + 1) at an even k (`pair`).
//
// Entry (idx, k) at p[idx * LD + k]: rows padded, no swizzle (W1).
template <int LD>
struct RowsPlain {
  const float* b;
  const float* r;
  __device__ __forceinline__ RowsPlain(const float* p, int idx0) {
    const int lane = threadIdx.x & 31;
    b = p + (idx0 + (lane >> 2)) * LD + (lane & 3);
    r = p + idx0 * LD;
  }
  __device__ __forceinline__ float at(int c, int q, int i) const {
    return b[8 * c * LD + 8 * i + 4 * q];
  }
  __device__ __forceinline__ float2 pair(int ri, int k) const {
    return *reinterpret_cast<const float2*>(r + ri * LD + k);
  }
};

// RowsPlain with a row stride known only at run time (a width-sized
// operand of the wide kernels): with ld = 4 (mod 32) conflict-free.
struct RowsPlainRt {
  const float* b;
  const float* r;
  int ld;
  __device__ __forceinline__ RowsPlainRt(const float* p, int ld_, int idx0) : ld(ld_) {
    const int lane = threadIdx.x & 31;
    b = p + (idx0 + (lane >> 2)) * ld + (lane & 3);
    r = p + idx0 * ld;
  }
  __device__ __forceinline__ float at(int c, int q, int i) const {
    return b[8 * c * ld + 8 * i + 4 * q];
  }
  __device__ __forceinline__ float2 pair(int ri, int k) const {
    return *reinterpret_cast<const float2*>(r + ri * ld + k);
  }
};

// Entry (idx, k) at p[k * LD + idx], k along the stored rows: with LD = 8
// (mod 32) the lanes (g, t) read banks 8 t + g, all distinct.
template <int LD>
struct ColsPlain {
  const float* b;
  const float* r;
  __device__ __forceinline__ ColsPlain(const float* p, int idx0) {
    const int lane = threadIdx.x & 31;
    b = p + (lane & 3) * LD + idx0 + (lane >> 2);
    r = p + idx0;
  }
  __device__ __forceinline__ float at(int c, int q, int i) const {
    return b[(8 * i + 4 * q) * LD + 8 * c];
  }
  __device__ __forceinline__ float2 pair(int ri, int k) const {
    return make_float2(r[k * LD + ri], r[(k + 1) * LD + ri]);
  }
};

// Entry (idx, k) at p[idx * LD + (k ^ swz(idx))], idx0 a multiple of 8:
// swz(idx) = swz(g), and k ^ swz(g) = 8 (i ^ (g & 3)) + t + 4 (q ^ (g >> 2)).
template <int LD>
struct RowsSwz {
  const float* b;
  const float* r;
  int g3, g2, i0;
  __device__ __forceinline__ RowsSwz(const float* p, int idx0) {
    const int lane = threadIdx.x & 31, g = lane >> 2;
    b = p + (idx0 + g) * LD + (lane & 3);
    g3 = g & 3;
    g2 = g >> 2;
    r = p;
    i0 = idx0;
  }
  __device__ __forceinline__ float at(int c, int q, int i) const {
    return b[8 * c * LD + 8 * (i ^ g3) + 4 * (q ^ g2)];
  }
  // swz flips bits 2-4 of the column only, so k and k + 1 stay neighbours.
  __device__ __forceinline__ float2 pair(int ri, int k) const {
    const int idx = i0 + ri;
    return *reinterpret_cast<const float2*>(r + idx * LD + (k ^ swz(idx)));
  }
};

// Entry (idx, k) at p[k * LD + (idx ^ swz(k))], k along the stored rows,
// idx0 = 32 a + 8 c0 and c0 + c < 4: swz(k) = 8 t + 4 q, so the entry is at
// p + (8 i + t + 4 q) LD + 32 a + 8 ((c0 + c) ^ t) + (g ^ 4 q).
template <int LD>
struct ColsSwz {
  const float* b[2];
  const float* r;
  int t, c0, i0;
  __device__ __forceinline__ ColsSwz(const float* p, int idx0) {
    const int lane = threadIdx.x & 31, g = lane >> 2;
    t = lane & 3;
    c0 = (idx0 >> 3) & 3;
    b[0] = p + t * LD + (idx0 & ~31) + g;
    b[1] = p + (t + 4) * LD + (idx0 & ~31) + (g ^ 4);
    r = p;
    i0 = idx0;
  }
  __device__ __forceinline__ float at(int c, int q, int i) const {
    return b[q][8 * i * LD + 8 * ((c0 + c) ^ t)];
  }
  __device__ __forceinline__ float2 pair(int ri, int k) const {
    const int idx = i0 + ri;
    return make_float2(r[k * LD + (idx ^ swz(k))], r[(k + 1) * LD + (idx ^ swz(k + 1))]);
  }
};

// An operand stored already split: its hi parts through view V at p, its lo
// parts (split_tf32's, as bits) through the same view at p + lo_offset.
template <class V>
struct Split {
  V h, l;
  __device__ __forceinline__ Split(const float* p, int lo_offset, int idx0)
      : h(p, idx0), l(p + lo_offset, idx0) {}
};

// Entry (c, q, i) of an operand view as its two TF32 parts: split here, or
// read as stored.
template <class V>
__device__ __forceinline__ void parts(const V& v, int c, int q, int i, uint32_t& hi,
                                      uint32_t& lo) {
  split_tf32(v.at(c, q, i), hi, lo);
}
template <class V>
__device__ __forceinline__ void parts(const Split<V>& v, int c, int q, int i, uint32_t& hi,
                                      uint32_t& lo) {
  hi = __float_as_uint(v.h.at(c, q, i));
  lo = __float_as_uint(v.l.at(c, q, i));
}

// x's two parts as split_tf32 forms them, each as the float with its bits,
// for storing an operand already split.
__device__ __forceinline__ float2 split_store(float x) {
  uint32_t hi, lo;
  split_tf32(x, hi, lo);
  return make_float2(__uint_as_float(hi), __uint_as_float(lo));
}

// acc[mt][nt] += sum_k A(m, k) B(k, n) over `steps` depth steps of 8, for
// the warp's MT x NT tiles of 16 x 8 (the views hold where they start): in
// 3xTF32, the three products of each tile in the order lo hi, hi lo, hi hi.
// The depth loop is unrolled UNROLL times.
template <int MT, int NT, int UNROLL = 2, class VA, class VB>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NT][4], const VA& a, const VB& b,
                                         int steps) {
#pragma unroll (UNROLL)
  for (int i = 0; i < steps; ++i) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int q = 0; q < 4; ++q) parts(a, 2 * mt + (q & 1), q >> 1, i, ah[mt][q], al[mt][q]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t bh[2], bl[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) parts(b, nt, q, i, bh[q], bl[q]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_tf32(acc[mt][nt], al[mt], bh);
        mma_tf32(acc[mt][nt], ah[mt], bl);
        mma_tf32(acc[mt][nt], ah[mt], bh);
      }
    }
  }
}

// The same product in bf16 over `steps` depth steps of 16: each operand
// entry rounded to bf16 to nearest even as it is read, one product a tile,
// f32 sums.
template <int MT, int NT, class VA, class VB>
__device__ __forceinline__ void warp_mma_bf16(float (&acc)[MT][NT][4], const VA& a,
                                              const VB& b, int steps) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int i = 0; i < steps; ++i) {
    const int k0 = 16 * i + 2 * t;
    uint32_t af[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        af[mt][q] = bf16x2(a.pair(16 * mt + 8 * (q & 1) + g, k0 + 8 * (q >> 1)));
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint32_t bf[2] = {bf16x2(b.pair(8 * nt + g, k0)),
                              bf16x2(b.pair(8 * nt + g, k0 + 8))};
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][nt], af[mt], bf);
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
}

}  // namespace ppo_grad
