// The PPO gradient kernels' wide design, for hidden widths above 128:
// device code and the launch sequence shared by `ppo_wide_t.cu` (B2,
// transposed batch) and `ppo_wide.cu` (B3 and B4, row-major batch). They
// compute what the narrow kernels of `ppo_grad.cuh` compute (the clipped-
// surrogate + value loss under the fixed std and the gradients of all 12
// ActorCritic leaves, the clip-tie convention where(surr1 <= surr2, 1,
// in_band)), and write the same (2, G, partial) workspace layout
// (`ppo_common.cuh:Layout`), which the same fixed-order reductions sum.
//
// Why not the narrow design. It keeps a 64-row chunk's activations in one
// CTA's shared memory and the CTA's rows of dW2 and dW1 in its registers,
// and at H = 256 already needs 4 CTAs per walk, each redoing the chunk's
// forward and backward. At H = 512 one chunk's H1 and H2 are 256 KB (more
// than a CTA's 227 KB), dW2 + dW1 of one head 1.18 MB, and W2 1 MB; the
// redo-the-chunk scheme would cost 16 walks or more. At 256 this design
// took B2 13.90 ms at the bench minibatch against the 256 instantiation's
// 37.26 ms (`chip_smoke.py` kernel_options, NVIDIA H100 80GB HBM3, 700 W),
// so the wrappers send every width from 129 here
// (`ops/ppo_fused_t.py:WIDE_FROM`).
//
// Design: two phases a super-chunk, every product a tiled matrix product.
// The minibatch is cut into super-chunks of R rows (R x H <= 2^24 floats an
// activation array: 32,768 rows at H = 512, 16,384 at 1024). For each:
// 1. gather (the loader's own kernel): the rows' obs into X^T (K1 x R; K1 =
//    obs rounded up to 32, the features past obs zero), their aux and live
//    flags (8 x R);
// 2. H1 = tanh(X W1^T + b1), H2 = tanh(H1 W2^T + b2): row-parallel
//    products, 128 x 128 output tiles, both heads (blockIdx.z);
// 3. the loss pass, 64 rows a CTA: the head's outputs (W3 products on the
//    CUDA cores), the loss rows, g_h2 = (g_out W3) (1 - h2^2) in place of
//    H2, and the CTA's column sums (dW3, b2, b3, the loss sums, the ratio
//    max) into a per-CTA row of a scratch table, summed in block order by a
//    small kernel into partial 0;
// 4. dW2 = g_h2^T H1: output-tiled, the super-chunk's rows split over G
//    partials (the G slices of K run in parallel, each tile's sum in fixed
//    order into its own partial: no float atomics);
// 5. g_h1 = (g_h2 W2) (1 - h1^2) in place of H1 (row-parallel);
// 6. dW1 = g_h1^T X: output-tiled, split as dW2; the same CTAs sum g_h1's
//    rows of their slice in f32 as they stage them (b1's gradient: f32 sums
//    of g_h1, as in the plain version, also where the products are bf16).
// Each partial entry is written by one thread (the first super-chunk) or
// read, added to and written back (the later ones), so two launches give
// the same bits. The final reduction (the loader's `reduce`/Adam kernel)
// sums the G partials of each entry in the order 0..G-1.
//
// Any width that is a multiple of 128 runs, set at run time (`hp`): a
// model of hr units runs zero-padded on hp = hr rounded up to 128 (the
// padding identity of `ppo_grad.cuh`). Any obs width: K1 is built in. No
// array is sized by a widest width: the loss pass loops over the units and
// reads W3 in place through L1; the activations' super-chunk is sized by
// the width (R x hp floats fixed); the walkers G follow the SMs (`walkers`),
// so the partials grow as G hp^2 <= 128 SMs hp while G can be cut, and as
// hp^2 once G is 1. Offsets are 32-bit within a
// head's arrays (the pack, a partial, the flat output), 64-bit across
// them: `ops/ppo_fused_t.py:check_fits` refuses, naming the bytes, a width
// whose arrays 32-bit offsets cannot address.
//
// The products (`gemm_kernel`): 256 threads, a 128 x 128 output tile, K in
// steps of 32 through a 3-stage ring of cp.async copies into shared memory
// (each operand tile kept as stored: [idx][32] or [32][idx], rows padded so
// that the fragment reads hit 32 banks), 8 warps of 64 x 32, mma.sync in
// 3xTF32 (f32 mode) or bf16 (operands rounded as read), as the narrow
// kernels do (`mma_tf32.cuh`).
//
// Bound at H = 512, OBS = 75: 3,477,504 f32 FLOP a row (`chip_smoke.py:
// grad_flops_per_row`), 27.2 ms at the bench minibatch (524,288 rows) on the
// 67 TFLOP/s of f32 CUDA cores, 11.0 ms at the TF32 tensor cores' 495
// TFLOP/s in 3xTF32. Each super-chunk also moves its activations through
// device memory (about 8 H floats a row and head: 17 GB at the bench
// minibatch at H = 512, 5 ms at 3.35 TB/s), which the narrow design keeps
// on chip.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tf32.cuh"
#include "ppo_common.cuh"

// The instantiation (set by the build): the obs width and the products'
// precision. The hidden width is an argument.
#ifndef AQE_OBS
#define AQE_OBS 75
#endif
#ifndef AQE_BF16
#define AQE_BF16 0
#endif

namespace ppo_wide {

using namespace ppo_grad;

constexpr int OBS = AQE_OBS;
constexpr bool BF16 = AQE_BF16 != 0;
constexpr int HT = 128;                       // widths run padded to a multiple of this
constexpr int K1 = (OBS + 31) / 32 * 32;      // obs, then zeros
constexpr int THREADS = 256;
constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3;
constexpr int LDK = BK + 4;                   // [idx][BK] tiles: 4 mod 32
constexpr int LDI = BM + 8;                   // [BK][idx] tiles: 8 mod 32
constexpr int TILE_FLOATS = BM * LDK;         // one operand's tile, either way
constexpr int GEMM_SMEM = STAGES * 2 * TILE_FLOATS * 4;
constexpr int LROWS = 64;                     // rows of a loss-pass CTA
constexpr int RMAX_FLOATS = 1 << 24;          // a super-chunk's rows x width
// Above this width the products whose depth grows with the width or the
// rows (all but H1's) add each k-step's tensor-core sum, started from zero,
// to the tile's sum on the CUDA cores ("promotion"). A sum carried through
// the whole depth in the mma accumulator drifts with the number of mma
// steps (the tensor cores' additions are not rounded to nearest): on
// kernel_options' 12,288 seeded rows the weight leaves sat 1.1e-5 off the
// f32 plain version at 1024 and 3.4e-5 at 4096; promoted, 5e-7 to 2.5e-6
// off the float64 plain version at 1152-4096, as the f32 plain version
// itself (`chip_smoke.py`, NVIDIA H100 80GB HBM3, 700 W). The second
// 64-float accumulator costs the product kernel its second CTA an SM; to
// 1024 nothing changes.
constexpr int PROMOTE_ABOVE = 1024;

static_assert(BK * LDI <= TILE_FLOATS && LDK % 4 == 0 && LDI % 4 == 0, "tiles");
static_assert(GEMM_SMEM <= 232448, "more shared memory than a CTA may have");

// x as a product's operand: rounded to bf16 in bf16 mode.
__device__ __forceinline__ float opnd(float x) { return BF16 ? bf16r(x) : x; }

// One head's weight pack at width hp (floats), as `ops/rollout_fused.py:
// weight_pack` builds it with depth K1: W1 (hp, K1), W2 (hp, hp), W3 (NA,
// hp), b1, b2 (hp), b3 (NA).
struct Pack {
  int w1, w2, w3, b1, b2, b3, size;
};
__host__ __device__ constexpr Pack make_pack(int hp) {
  return Pack{0,
              hp * K1,
              hp * K1 + hp * hp,
              hp * K1 + hp * hp + NA * hp,
              hp * K1 + hp * hp + NA * hp + hp,
              hp * K1 + hp * hp + NA * hp + 2 * hp,
              hp * K1 + hp * hp + NA * hp + 2 * hp + NA};
}

__host__ __device__ constexpr int padded(int hr) { return (hr + HT - 1) / HT * HT; }
__host__ __device__ constexpr int partial_floats(int hp) { return make_layout(hp, OBS).acc + NMET; }
// A loss-pass CTA's row of column sums: dW3 (NA x hp), b2 (hp), b3 (NA),
// the loss sum, the ratio max, pad.
__host__ __device__ constexpr int sums_floats(int hp) { return 5 * hp + NA + 4; }
__host__ __device__ constexpr int rows_max(int hp) {
  return RMAX_FLOATS / hp / BM * BM > BM ? RMAX_FLOATS / hp / BM * BM : BM;
}

// The workspace (floats): the (2, G, partial) partials, then X^T (K1 x R),
// aux (8 x R), H1 and H2 (2 heads x R x hp each) and the loss pass's sums
// (2 heads x R / 64 rows), R = rows_max(hp).
struct Work {
  int hp, G, rmax, accs, csw;
  size_t xs, aux, h1, h2, cs, total;
};
inline Work make_work(int hr, int G) {
  Work w;
  w.hp = padded(hr);
  w.G = G;
  w.rmax = rows_max(w.hp);
  w.accs = partial_floats(w.hp);
  w.csw = sums_floats(w.hp);
  w.xs = 2 * (size_t)G * w.accs;
  w.aux = w.xs + (size_t)K1 * w.rmax;
  w.h1 = w.aux + 8 * (size_t)w.rmax;
  w.h2 = w.h1 + 2 * (size_t)w.rmax * w.hp;
  w.cs = w.h2 + 2 * (size_t)w.rmax * w.hp;
  w.total = w.cs + 2 * (size_t)(w.rmax / LROWS) * w.csw;
  return w;
}

// ---------------------------------------------------------------------------
// The tiled product
// ---------------------------------------------------------------------------

enum Epilogue { EPI_TANH, EPI_DGRAD, EPI_PARTIAL };

// C = A B over k in this CTA's slice of K, for an M x N output in 128 x 128
// tiles (grid (N tiles, M tiles x splits, 2 heads)). A(m, k) is a[k * lda +
// m] (A_KR) or a[m * lda + k]; B(k, n) is b[k * ldb + n] (B_KR) or b[n *
// ldb + k]; each head's operands `*_head` floats on. The epilogue:
// EPI_TANH  out[m][n] = tanh(C + bias[n]);
// EPI_DGRAD out[m][n] = C (1 - out[m][n]^2), in place of the activation;
// EPI_PARTIAL the K slice `split`'s sum into partial `split` of the head:
//   entries n < ncols at part + m * ldo + n; where bias_part >= 0 (and A_KR)
//   also the sums over k of A(m, k), in f32, at bias_part + m (the CTAs of
//   the first N tile); set by the first super-chunk, added to by the
//   others.
struct Gemm {
  const float* a;
  const float* b;
  float* out;
  const float* bias;
  size_t a_head, b_head, out_head, bias_head;
  int lda, ldb, ldo;
  int M, N, K, tiles_m, splits;
  // EPI_PARTIAL: the workspace's partial stride and the offsets in one
  size_t slot_stride;
  int part, ncols, bias_part, first;
};

// Operand tile (idx0.., k0..) into shared memory as stored: [BK][LDI]
// (KR: entry at src[k * ld + idx]) or [BM][LDK]; idx >= lim zero-filled
// (lim a multiple of 4).
template <bool KR>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int ld, int idx0, int k0,
                                          int lim) {
  for (int u = threadIdx.x; u < BM * BK / 4; u += THREADS) {
    if constexpr (KR) {
      const int k = u >> 5, i = (u & 31) * 4;
      float* d = dst + k * LDI + i;
      if (idx0 + i < lim) cp_async16(d, src + (size_t)(k0 + k) * ld + idx0 + i);
      else sts4(d, make_float4(0.f, 0.f, 0.f, 0.f));
    } else {
      const int i = u >> 3, k = (u & 7) * 4;
      float* d = dst + i * LDK + k;
      if (idx0 + i < lim) cp_async16(d, src + (size_t)(idx0 + i) * ld + k0 + k);
      else sts4(d, make_float4(0.f, 0.f, 0.f, 0.f));
    }
  }
}

template <bool KR>
using TileView = std::conditional_t<KR, ColsPlain<LDI>, RowsPlain<LDK>>;

template <int MT, int NT, class VA, class VB>
__device__ __forceinline__ void mma_tile(float (&acc)[MT][NT][4], const VA& a, const VB& b,
                                         int depth) {
  if constexpr (BF16) {
    warp_mma_bf16(acc, a, b, depth / 16);
  } else {
    warp_mma<MT, NT, BK / 8>(acc, a, b, depth / 8);  // unrolled: 4 beat 2
  }
}

template <int MT, int NT>
__device__ __forceinline__ void add_to(float (&acc)[MT][NT][4], const float (&s)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] += s[mt][nt][e];
}

// Two CTAs an SM (128 registers a thread, 2 x 108 KB of shared memory); one
// with PROMOTE (each k-step's sum from zero, added to acc in f32).
template <bool A_KR, bool B_KR, int EPI, bool PROMOTE>
__global__ void __launch_bounds__(THREADS, PROMOTE ? 1 : 2) gemm_kernel(Gemm g) {
  extern __shared__ float4 smem4[];
  float* S = reinterpret_cast<float*>(smem4);
  const int head = blockIdx.z, n0 = blockIdx.x * BN;
  const int split = blockIdx.y / g.tiles_m, m0 = (blockIdx.y % g.tiles_m) * BM;
  const int steps = g.K / BK;
  const int kb = (int)((long long)split * steps / g.splits);
  const int ke = (int)((long long)(split + 1) * steps / g.splits);
  const float* A = g.a + head * g.a_head;
  const float* B = g.b + head * g.b_head;
  auto load = [&](int k, int s) {
    load_tile<A_KR>(S + s * 2 * TILE_FLOATS, A, g.lda, m0, k * BK, g.M);
    load_tile<B_KR>(S + s * 2 * TILE_FLOATS + TILE_FLOATS, B, g.ldb, n0, k * BK, g.N);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (kb + s < ke) load(kb + s, s);
    cp_async_commit();
  }
  const int warp = threadIdx.x >> 5, wm = warp & 1, wn = warp >> 1;
  // EPI_PARTIAL with A_KR: A's row sums over k, thread t column t % 128 of
  // the staged tiles' rows t / 128, t / 128 + 2, ...
  const bool row_sums = EPI == EPI_PARTIAL && A_KR && g.bias_part >= 0 && blockIdx.x == 0;
  float rsum = 0.f;
  float acc[4][4][4];
  zero(acc);
  for (int k = kb; k < ke; ++k) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step k staged; every thread done with step k - 1's stage
    if (k + STAGES - 1 < ke) load(k + STAGES - 1, (k + STAGES - 1 - kb) % STAGES);
    cp_async_commit();
    const float* st = S + ((k - kb) % STAGES) * 2 * TILE_FLOATS;
    const TileView<A_KR> va(st, 64 * wm);
    const TileView<B_KR> vb(st + TILE_FLOATS, 32 * wn);
    if constexpr (PROMOTE) {
      float part[4][4][4];
      zero(part);
      mma_tile(part, va, vb, BK);
      add_to(acc, part);
    } else {
      mma_tile(acc, va, vb, BK);
    }
    if (row_sums)
      for (int r = threadIdx.x / BM; r < BK; r += THREADS / BM) rsum += st[r * LDI + threadIdx.x % BM];
  }
  cp_async_wait_all();

  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  float* base = g.out + head * g.out_head;
  if constexpr (EPI == EPI_PARTIAL) {
    base += split * g.slot_stride;
    if (row_sums) {
      __syncthreads();  // every thread done with the stages
      if (threadIdx.x >= BM) S[threadIdx.x - BM] = rsum;
      __syncthreads();
      if (threadIdx.x < BM) {
        float* p = base + g.bias_part + m0 + threadIdx.x;
        const float v = rsum + S[threadIdx.x];
        *p = g.first ? v : *p + v;
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + 64 * wm + 16 * mt + gq + 8 * hh;
        const int col = n0 + 32 * wn + 8 * nt + 2 * tq;
        const float v0 = acc[mt][nt][2 * hh], v1 = acc[mt][nt][2 * hh + 1];
        if constexpr (EPI == EPI_TANH) {
          if (col >= g.N) continue;
          const float* bias = g.bias + head * g.bias_head;
          *reinterpret_cast<float2*>(base + (size_t)row * g.ldo + col) =
              make_float2(tanhf(v0 + bias[col]), tanhf(v1 + bias[col + 1]));
        } else if constexpr (EPI == EPI_DGRAD) {
          if (col >= g.N) continue;
          float2* d = reinterpret_cast<float2*>(base + (size_t)row * g.ldo + col);
          const float2 h = *d;
          *d = make_float2(v0 * (1.f - h.x * h.x), v1 * (1.f - h.y * h.y));
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (col + e >= g.ncols) continue;
            float* p = base + g.part + (size_t)row * g.ldo + col + e;
            *p = g.first ? (e ? v1 : v0) : *p + (e ? v1 : v0);
          }
        }
      }
}

// ---------------------------------------------------------------------------
// The loss pass
// ---------------------------------------------------------------------------

struct LossPass {
  const float* pack;  // (2, Pack.size)
  float* h2;          // [2][rmax][hp]: H2 in, g_h2 out
  const float* aux;   // [8][R]: aux rows 0-6, row 7 the live flags
  float* cs;          // [2][R / 64][csw] column sums
  size_t pack_head, h2_head, cs_head;
  int hp, R, csw;
  LossConsts c;
};

// x as a product's operand, four at a time.
__device__ __forceinline__ float4 opnd4(float4 v) {
  return make_float4(opnd(v.x), opnd(v.y), opnd(v.z), opnd(v.w));
}

// Rows r0..r0+63 of one head (grid (R / 64, 2)): (a) each warp 8 rows, the
// lanes over the units: the head's outputs, the loss row and g_out; (b)
// each thread 4 units at a time, looping over the units, over the 64 rows:
// g_h2 in place of h2, the sums of dW3 and b2 (each column's in row order,
// so two launches give the same bits); (c) the CTA's row of column sums.
// W3 as a product's operand is read in place through L1 and rounded as
// read.
__global__ void __launch_bounds__(THREADS) loss_kernel(LossPass P) {
  __shared__ float go[LROWS][NA];
  __shared__ float wsum[THREADS / 32][2 + NA];
  const int head = blockIdx.y, r0 = blockIdx.x * LROWS, hp = P.hp;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Pack pk = make_pack(hp);
  const float* W = P.pack + head * P.pack_head;
  float* H2 = P.h2 + head * P.h2_head;
  auto w3at = [&](int e) { return opnd4(ld4(W + pk.w3 + e)); };

  // (a)
  float lsum = 0.f, rmax = 0.f, b3[NA] = {0.f, 0.f, 0.f, 0.f};
  for (int i = 0; i < LROWS / 8; ++i) {
    const int rl = 8 * warp + i, r = r0 + rl;
    const float* h = H2 + (size_t)r * hp;
    float s[NA] = {0.f, 0.f, 0.f, 0.f};
    for (int k = 4 * lane; k < hp; k += 128) {
      const float4 hv = lds4(h + k);
#pragma unroll
      for (int o = 0; o < NA; ++o) {
        const float4 wv = w3at(o * hp + k);
        s[o] = fmaf(opnd(hv.x), wv.x, s[o]);
        s[o] = fmaf(opnd(hv.y), wv.y, s[o]);
        s[o] = fmaf(opnd(hv.z), wv.z, s[o]);
        s[o] = fmaf(opnd(hv.w), wv.w, s[o]);
      }
    }
#pragma unroll
    for (int o = 0; o < NA; ++o) s[o] = warp_sum(s[o]);
    if (lane == 0) {
      float mean[NA], aux[7], g[NA], ratio;
#pragma unroll
      for (int o = 0; o < NA; ++o) {
        const float v = s[o] + W[pk.b3 + o];
        mean[o] = head == 0 ? tanhf(v) : v;
      }
#pragma unroll
      for (int j = 0; j < 7; ++j) aux[j] = P.aux[(size_t)j * P.R + r];
      const bool live = P.aux[(size_t)7 * P.R + r] != 0.f;
      lsum += loss_row(head, live, mean, aux, P.c, g, ratio);
      rmax = fmaxf(rmax, ratio);
#pragma unroll
      for (int o = 0; o < NA; ++o) {
        go[rl][o] = g[o];
        b3[o] += g[o];
      }
    }
  }
  if (lane == 0) {
    wsum[warp][0] = lsum;
    wsum[warp][1] = rmax;
#pragma unroll
    for (int o = 0; o < NA; ++o) wsum[warp][2 + o] = b3[o];
  }
  __syncthreads();

  // (b)
  float* cs = P.cs + head * P.cs_head + (size_t)blockIdx.x * P.csw;
  for (int k = 4 * tid; k < hp; k += 4 * THREADS) {
    float w3[NA][4], d3[NA][4], sb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int o = 0; o < NA; ++o) {
      const float4 wv = w3at(o * hp + k);
      w3[o][0] = wv.x;
      w3[o][1] = wv.y;
      w3[o][2] = wv.z;
      w3[o][3] = wv.w;
#pragma unroll
      for (int j = 0; j < 4; ++j) d3[o][j] = 0.f;
    }
    for (int i = 0; i < LROWS; ++i) {
      float* p = H2 + (size_t)(r0 + i) * hp + k;
      const float4 hv = lds4(p);
      const float h[4] = {hv.x, hv.y, hv.z, hv.w};
      float gq[NA];
#pragma unroll
      for (int o = 0; o < NA; ++o) gq[o] = opnd(go[i][o]);
      float gh[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = gq[0] * w3[0][j];
        s = fmaf(gq[1], w3[1][j], s);
        s = fmaf(gq[2], w3[2][j], s);
        s = fmaf(gq[3], w3[3][j], s);
        gh[j] = s * (1.f - h[j] * h[j]);
        const float hq = opnd(h[j]);
#pragma unroll
        for (int o = 0; o < NA; ++o) d3[o][j] = fmaf(gq[o], hq, d3[o][j]);
        sb[j] += gh[j];
      }
      sts4(p, make_float4(gh[0], gh[1], gh[2], gh[3]));
    }
#pragma unroll
    for (int o = 0; o < NA; ++o) sts4(cs + o * hp + k, make_float4(d3[o][0], d3[o][1], d3[o][2], d3[o][3]));
    sts4(cs + NA * hp + k, make_float4(sb[0], sb[1], sb[2], sb[3]));
  }
  // (c)
  if (tid == 0) {
    float l = 0.f, m = 0.f, b[NA] = {0.f, 0.f, 0.f, 0.f};
    for (int w = 0; w < THREADS / 32; ++w) {
      l += wsum[w][0];
      m = fmaxf(m, wsum[w][1]);
#pragma unroll
      for (int o = 0; o < NA; ++o) b[o] += wsum[w][2 + o];
    }
#pragma unroll
    for (int o = 0; o < NA; ++o) cs[5 * hp + o] = b[o];
    cs[5 * hp + NA] = l;
    cs[5 * hp + NA + 1] = m;
  }
}

// The loss pass's column sums of one super-chunk, summed over its nblk
// CTAs in block order, into partial 0 of each head (grid (ceil(csw / 256),
// 2)): set by the first super-chunk, which also zeroes these entries in
// partials 1..G-1, added to by the others (the ratio max by max).
__global__ void sums_kernel(const float* __restrict__ cs, float* __restrict__ work, size_t cs_head,
                            int nblk, int hp, int csw, int G, int accs, int first) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x, head = blockIdx.y;
  if (e >= csw) return;
  const Layout L = make_layout(hp, OBS);
  const bool is_max = e == 5 * hp + NA + 1;
  int dst;
  if (e < NA * hp) dst = L.w3 + e;
  else if (e < 5 * hp) dst = L.b2 + (e - NA * hp);
  else if (e < 5 * hp + NA) dst = L.b3 + (e - 5 * hp);
  else if (e == 5 * hp + NA) dst = L.acc + head;             // actor sum (0), critic sum (1)
  else if (is_max && head == 0) dst = L.acc + 2;             // the ratio max
  else return;
  const float* src = cs + head * cs_head + e;
  float v = 0.f;
  for (int b = 0; b < nblk; ++b) {
    const float x = src[(size_t)b * csw];
    v = is_max ? fmaxf(v, x) : v + x;
  }
  float* p = work + (size_t)head * G * accs + dst;
  if (first) {
    *p = v;
    for (int s = 1; s < G; ++s) p[(size_t)s * accs] = 0.f;
  } else {
    *p = is_max ? fmaxf(*p, v) : *p + v;
  }
}

// ---------------------------------------------------------------------------
// The launch sequence
// ---------------------------------------------------------------------------

template <bool A_KR, bool B_KR, int EPI, bool PROMOTE>
cudaError_t launch_gemm_as(const Gemm& g, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(gemm_kernel<A_KR, B_KR, EPI, PROMOTE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.N + BN - 1) / BN, g.tiles_m * g.splits, 2);
  gemm_kernel<A_KR, B_KR, EPI, PROMOTE><<<grid, THREADS, GEMM_SMEM, s>>>(g);
  return cudaGetLastError();
}

template <bool A_KR, bool B_KR, int EPI>
cudaError_t launch_gemm(const Gemm& g, bool promote, cudaStream_t s) {
  return promote ? launch_gemm_as<A_KR, B_KR, EPI, true>(g, s)
                 : launch_gemm_as<A_KR, B_KR, EPI, false>(g, s);
}

// The chunk walkers per head, G: the slices of K that the weight
// gradients' output tiles are split over, so that dW1's 2 G (hp / 128)
// (K1 / 128) CTAs (dW2 has hp / 128 times more) about fill the SMs twice;
// 1..32 (on the card 32 rather than 16 made B2 at H = 256 faster at the
// bench minibatch and left 512 and 1024 as they were). So G hp <= 128 SMs
// and the partials (G hp^2) grow as hp while G > 1; from 128 SMs units
// (16,896 on 132 SMs) G is 1 and they grow as hp^2, past 8 GB near 31,600
// units; where the card lacks them the wrapper names the bytes.
inline int walkers(int hr, int sms) {
  const int g = sms / (padded(hr) / HT * ((K1 + BN - 1) / BN));
  return g < 1 ? 1 : (g > 32 ? 32 : g);
}

// The whole gradient for a minibatch of mb rows of width hr into the
// workspace's G partials. `gather(r0, R, xs, aux)` launches the loader's
// kernel that writes rows r0..r0+R-1 (R a multiple of 128, rows past mb
// padding) as X^T (K1 x R) and aux (8 x R).
template <class Gather>
cudaError_t run(const Gather& gather, const float* pack, float* work, int hr, int mb, int G,
                const LossConsts& c, cudaStream_t s) {
  const Work w = make_work(hr, G);
  const int hp = w.hp;
  const Pack pk = make_pack(hp);
  const Layout L = make_layout(hp, OBS);
  float* xs = work + w.xs;
  float* aux = work + w.aux;
  float* h1 = work + w.h1;
  float* h2 = work + w.h2;
  float* cs = work + w.cs;
  const size_t act = (size_t)w.rmax * hp;
  const bool promote = hp > PROMOTE_ABOVE;
  cudaError_t err = cudaSuccess;
  for (int r0 = 0; r0 < mb && err == cudaSuccess; r0 += w.rmax) {
    const int left = (mb - r0 + BM - 1) / BM * BM;
    const int R = left < w.rmax ? left : w.rmax;
    const int first = r0 == 0;
    err = gather(r0, R, xs, aux);
    if (err != cudaSuccess) break;
    Gemm g{};
    // H1 = tanh(X W1^T + b1)
    g = Gemm{xs, pack + pk.w1, h1, pack + pk.b1, 0, (size_t)pk.size, act, (size_t)pk.size,
             R, K1, hp, R, hp, K1, R / BM, 1};
    if ((err = launch_gemm_as<true, false, EPI_TANH, false>(g, s)) != cudaSuccess) break;
    // H2 = tanh(H1 W2^T + b2)
    g = Gemm{h1, pack + pk.w2, h2, pack + pk.b2, act, (size_t)pk.size, act, (size_t)pk.size,
             hp, hp, hp, R, hp, hp, R / BM, 1};
    if ((err = launch_gemm<false, false, EPI_TANH>(g, promote, s)) != cudaSuccess) break;
    // the loss rows, g_h2 in place of H2, the column sums
    const LossPass lp{pack, h2, aux, cs, (size_t)pk.size, act,
                      (size_t)(w.rmax / LROWS) * w.csw, hp, R, w.csw, c};
    loss_kernel<<<dim3(R / LROWS, 2), THREADS, 0, s>>>(lp);
    if ((err = cudaGetLastError()) != cudaSuccess) break;
    sums_kernel<<<dim3((w.csw + 255) / 256, 2), 256, 0, s>>>(
        cs, work, (size_t)(w.rmax / LROWS) * w.csw, R / LROWS, hp, w.csw, G, w.accs, first);
    if ((err = cudaGetLastError()) != cudaSuccess) break;
    // dW2 = g_h2^T H1, the rows split over the G partials
    g = Gemm{h2, h1, work, nullptr, act, act, (size_t)G * w.accs, 0,
             hp, hp, hp, hp, hp, R, hp / BM, G,
             (size_t)w.accs, L.w2, hp, -1, first};
    if ((err = launch_gemm<true, true, EPI_PARTIAL>(g, promote, s)) != cudaSuccess) break;
    // g_h1 = (g_h2 W2) (1 - h1^2) in place of H1
    g = Gemm{h2, pack + pk.w2, h1, nullptr, act, (size_t)pk.size, act, 0,
             hp, hp, hp, R, hp, hp, R / BM, 1};
    if ((err = launch_gemm<false, true, EPI_DGRAD>(g, promote, s)) != cudaSuccess) break;
    // dW1 = g_h1^T X, and b1's gradient: g_h1's sums over the rows
    g = Gemm{h1, xs, work, nullptr, act, 0, (size_t)G * w.accs, 0,
             hp, R, L.obs_p, hp, K1, R, hp / BM, G,
             (size_t)w.accs, L.w1, OBS, L.b1, first};
    err = launch_gemm<true, false, EPI_PARTIAL>(g, promote, s);
  }
  return err;
}

// The reduction pass (`ppo_common.cuh:reduce_entry`) at the padded width.
__global__ void reduce_kernel(const float* __restrict__ work, float* __restrict__ out, int G,
                              int hr) {
  reduce_entry(work, out, G, hr, make_layout(padded(hr), OBS));
}

}  // namespace ppo_wide

extern "C" {

// The same entry points as the narrow libraries (`ppo_grad.cuh`), for a
// model of hidden width hr: floats per head of the weight pack; the chunk
// walkers G; floats of the workspace; floats of the flat output.
int ppo_grad_pack_floats(int hr) { return ppo_wide::make_pack(ppo_wide::padded(hr)).size; }
int ppo_grad_walkers(int hr, int sms, int) { return ppo_wide::walkers(hr, sms); }
long long ppo_grad_work_floats(int hr, int, int G) {
  return (long long)ppo_wide::make_work(hr, G).total;
}
int ppo_grad_out_floats(int hr) {
  return ppo_grad::out_actor(ppo_wide::OBS, hr) + ppo_grad::out_critic(ppo_wide::OBS, hr) + 3;
}

// The instantiation, as the narrow libraries report theirs: 0 H (here the
// multiple of which every width runs, zero-padded: 128; the width is an
// argument), 1 OBS, 2 bf16, 3 K1, 4 slices (1: no CTA redoes a chunk), 5
// weights resident (0), 6 shared memory bytes of the product kernel, 7 WIDE
// (0: X is staged).
int ppo_grad_config(int i) {
  using namespace ppo_wide;
  const int v[] = {HT, OBS, BF16 ? 1 : 0, K1, 1, 0, GEMM_SMEM, 0};
  return i >= 0 && i < 8 ? v[i] : -1;
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
