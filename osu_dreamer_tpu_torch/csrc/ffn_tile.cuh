// The wmma (mma.sync) conv-FFN tile pieces of the backward kernels: the
// film-layer backward (film_layer_bwd.cu, K3) recomputes its forward with
// ffn_dwconv, ffn_gate and ffn_out, and both backward kernels (K3 and
// swiglu_bwd.cu, K5/K6) form their hidden tiles with ffn_hidden_tile. The
// forwards (K2, K4) run on the TMA + wgmma core of ffn_core.cuh instead.
//
// One block owns T consecutive positions of one batch row. Everything between
// the input read and the output write stays in shared memory:
//
//   ys (T, C)  depthwise-conv output            bf16
//   hs (T, Hp) v * silu(g)                       bf16
//
// Both projections run on the tensor cores through wmma (mma.sync, bf16 in,
// f32 accumulate). The weights are read straight from global memory, where
// they stay resident in the 50 MB L2 across blocks.
//
// Weight layout (prepared by the Python wrapper, ops/swiglu.py
// ``packed_bwd_weights``):
//   wvg  (C, 2*Hp)  v columns in [0, Hp), g columns in [Hp, 2*Hp), zero padded
//   bvg  (2*Hp)     the same split, zero padded
//   wout (Hp, C)    zero rows past H
// Hp is H rounded up to 16. Padded columns give v = 0, so h = 0 there and the
// RMS statistics (divided by the true H) and the output projection see no
// trace of the padding.
#pragma once

#include "common.cuh"

namespace odt {

constexpr int kFfnWarps = 8;
constexpr int kFfnThreads = kFfnWarps * 32;
constexpr int kScratchPerWarp = 512;  // two 16x16 f32 tiles

// hs[t][j] = bf16(v * silu(g)) with v, g = bf16(bf16(ys @ wvg) + bvg).
template <int T>
__device__ void ffn_gate(const bf16* ys, int lda, int C, const bf16* wvg, const bf16* bvg,
                         int Hp, bf16* hs, int ldh, float* scratch) {
  constexpr int RT = T / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ldw = 2 * Hp;
  for (int ct = warp; ct < Hp / 16; ct += kFfnWarps) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> av[RT], ag[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      wmma::fill_fragment(av[i], 0.f);
      wmma::fill_fragment(ag[i], 0.f);
    }
    for (int k = 0; k < C; k += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv, bg;
      wmma::load_matrix_sync(bv, wvg + (size_t)k * ldw + ct * 16, ldw);
      wmma::load_matrix_sync(bg, wvg + (size_t)k * ldw + Hp + ct * 16, ldw);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, ys + i * 16 * lda + k, lda);
        wmma::mma_sync(av[i], a, bv, av[i]);
        wmma::mma_sync(ag[i], a, bg, ag[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      wmma::store_matrix_sync(scratch, av[i], 16, wmma::mem_row_major);
      wmma::store_matrix_sync(scratch + 256, ag[i], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = e >> 4, c = ct * 16 + (e & 15);
        const float v = bfr(bfr(scratch[e]) + ldf(bvg + c));
        const float g = bfr(bfr(scratch[256 + e]) + ldf(bvg + Hp + c));
        const float silu = bfr(g / (1.f + expf(-g)));
        hs[(i * 16 + r) * ldh + c] = __float2bfloat16(v * silu);
      }
      __syncwarp();
    }
  }
}

// epi(t, c, bf16(bf16(hs @ wout) + bout)) for every t < T, c < C.
template <int T, class Epilogue>
__device__ void ffn_out(const bf16* hs, int ldh, int Hp, const bf16* wout, const bf16* bout,
                        int C, float* scratch, Epilogue epi) {
  constexpr int RT = T / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int ct = warp; ct < C / 16; ct += kFfnWarps) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) wmma::fill_fragment(acc[i], 0.f);
    for (int k = 0; k < Hp; k += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(b, wout + (size_t)k * C + ct * 16, C);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, hs + i * 16 * ldh + k, ldh);
        wmma::mma_sync(acc[i], a, b, acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      wmma::store_matrix_sync(scratch, acc[i], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = e >> 4, c = ct * 16 + (e & 15);
        epi(i * 16 + r, c, bfr(bfr(scratch[e]) + ldf(bout + c)));
      }
      __syncwarp();
    }
  }
}

// The backward kernels' hidden tile j for RT row fragments of ys and gos:
// v and g (columns j*16.. of the two halves of W_vg) and dhn = gos W_out^T
// (rows j*16.. of W_out, read transposed), f32 accumulators without biases.
// The weight fragments come from L2: the next k-step's are in flight while
// this one's products run (two register stages, C a multiple of 32).
template <int RT>
__device__ __forceinline__ void ffn_hidden_tile(
    const bf16* ys, const bf16* gos, int lda, const bf16* wvg, const bf16* wout, int C, int Hp,
    int j, wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&v)[RT],
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&g)[RT],
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&d)[RT]) {
  const int ldw = 2 * Hp;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    wmma::fill_fragment(v[i], 0.f);
    wmma::fill_fragment(g[i], 0.f);
    wmma::fill_fragment(d[i], 0.f);
  }
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv0, bg0, bv1, bg1;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bo0, bo1;
  auto load = [&](auto& bv, auto& bg, auto& bo, int k) {
    wmma::load_matrix_sync(bv, wvg + (size_t)k * ldw + j * 16, ldw);
    wmma::load_matrix_sync(bg, wvg + (size_t)k * ldw + Hp + j * 16, ldw);
    wmma::load_matrix_sync(bo, wout + (size_t)j * 16 * C + k, C);
  };
  auto step = [&](const auto& bv, const auto& bg, const auto& bo, int k) {
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, ys + i * 16 * lda + k, lda);
      wmma::mma_sync(v[i], a, bv, v[i]);
      wmma::mma_sync(g[i], a, bg, g[i]);
      wmma::load_matrix_sync(a, gos + i * 16 * lda + k, lda);
      wmma::mma_sync(d[i], a, bo, d[i]);
    }
  };
  load(bv0, bg0, bo0, 0);
  for (int k = 0; k < C; k += 32) {
    load(bv1, bg1, bo1, k + 16);
    step(bv0, bg0, bo0, k);
    if (k + 32 < C) load(bv0, bg0, bo0, k + 32);
    step(bv1, bg1, bo1, k + 16);
  }
}

// ys[t][c] = depthwise conv over the haloed window src (T + K - 1 rows), in the
// plain version's order: ((x0*w0 + x1*w1) + ...) + bias, each op rounded to bf16.
template <int T>
__device__ void ffn_dwconv(const bf16* src, int lda, const bf16* dww, const bf16* dwb, int K,
                           int C, bf16* ys) {
  for (int idx = threadIdx.x; idx < T * C; idx += blockDim.x) {
    const int t = idx / C, c = idx % C;
    float acc = bfr(ldf(src + t * lda + c) * ldf(dww + c));
    for (int k = 1; k < K; ++k)
      acc = bfr(acc + bfr(ldf(src + (t + k) * lda + c) * ldf(dww + k * C + c)));
    ys[t * lda + c] = __float2bfloat16(acc + ldf(dwb + c));
  }
}

}  // namespace odt
