// Split-K product over shared rows, the weight-gradient shape of the FFN
// backward kernels:
//
//   out (M, N) f32 = sum over r < R of A[r, :M]^T B[r, :N]
//
// with A (R, lda) and B (R, ldb) row-major bf16 (dW = X^T dY summed over all
// B*L positions). R is long (tens of thousands of rows) and M, N short, so
// the rows are cut into S chunks: one block per (64 x 64 output tile,
// chunk), four warps each owning a 32 x 32 sub-tile in wmma accumulators,
// reading A (as a col-major matrix_a, i.e. transposed) and B straight from
// global memory / L2. Each block writes its f32 partial to part[s]; a second
// kernel sums the S partials in index order. No atomics: two runs give
// bit-identical results.
//
// Requirements: M, N multiples of 16; lda, ldb multiples of 8; the base
// pointers 32-byte aligned. R may be ragged: a last group of fewer than 16
// rows is staged through shared memory with zero rows (no read past row R).
// The caller allocates part (S, M, N) and out.
#pragma once

#include "common.cuh"

namespace odt {

constexpr int kGemmTile = 64;
constexpr int kGemmWarps = 4;  // 2 x 2 warps of 32 x 32

template <int Warps = kGemmWarps>
__global__ void __launch_bounds__(Warps * 32)
gemm_tn_partial_kernel(const bf16* __restrict__ A, int lda, const bf16* __restrict__ B, int ldb,
                       int R, int M, int N, int rows_per_split, float* __restrict__ part) {
  const int warp = threadIdx.x >> 5;
  const int m0 = blockIdx.x * kGemmTile + (warp & 1) * 32;
  const int n0 = blockIdx.y * kGemmTile + (warp >> 1) * 32;
  const int s = blockIdx.z;
  const int r0 = s * rows_per_split;
  const int r1 = min(R, r0 + rows_per_split);
  const bool mv[2] = {m0 < M, m0 + 16 < M};
  const bool nv[2] = {n0 < N, n0 + 16 < N};
  if (!mv[0] || !nv[0]) return;
  // a warp's ragged last 16 rows of its A and B columns, zero past row R
  __shared__ __align__(32) bf16 tail[Warps][2][16 * 32];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  for (int r = r0; r < r1; r += 16) {
    const bf16* a_src = A + (size_t)r * lda + m0;
    const bf16* b_src = B + (size_t)r * ldb + n0;
    int a_ld = lda, b_ld = ldb;
    if (r + 16 > R) {
      bf16* ta = tail[warp][0];
      bf16* tb = tail[warp][1];
      const bf16 zero = __float2bfloat16(0.f);
      for (int idx = threadIdx.x & 31; idx < 16 * 32; idx += 32) {
        const int rr = r + idx / 32, c = idx % 32;
        ta[idx] = rr < R && m0 + c < M ? A[(size_t)rr * lda + m0 + c] : zero;
        tb[idx] = rr < R && n0 + c < N ? B[(size_t)rr * ldb + n0 + c] : zero;
      }
      __syncwarp();
      a_src = ta;
      b_src = tb;
      a_ld = b_ld = 32;
    }
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (mv[i]) wmma::load_matrix_sync(a[i], a_src + 16 * i, a_ld);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (nv[j]) wmma::load_matrix_sync(b[j], b_src + 16 * j, b_ld);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (mv[i] && nv[j]) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
  }
  float* p = part + (size_t)s * M * N;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (mv[i] && nv[j])
        wmma::store_matrix_sync(p + (size_t)(m0 + 16 * i) * N + n0 + 16 * j, acc[i][j], N,
                                wmma::mem_row_major);
}

// out[i] = sum over s < S of part[s][i], in order of s
template <int Threads = 256>
__global__ void __launch_bounds__(Threads)
splitk_reduce_kernel(const float* __restrict__ part, int S, size_t n, float* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * Threads + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += part[(size_t)s * n + i];
  out[i] = acc;
}

// Launch both kernels on `stream`; -> the first launch error.
inline cudaError_t gemm_tn_splitk(const bf16* A, int lda, const bf16* B, int ldb, int R, int M,
                                  int N, int S, float* part, float* out, cudaStream_t stream) {
  if (M % 16 || N % 16 || lda % 8 || ldb % 8 || S < 1 || R < 1) return cudaErrorInvalidValue;
  const int rows_per_split = (((R + 15) / 16 + S - 1) / S) * 16;
  dim3 grid((M + kGemmTile - 1) / kGemmTile, (N + kGemmTile - 1) / kGemmTile, S);
  gemm_tn_partial_kernel<><<<grid, kGemmWarps * 32, 0, stream>>>(A, lda, B, ldb, R, M, N,
                                                                 rows_per_split, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n = (size_t)M * N;
  splitk_reduce_kernel<><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(part, S, n, out);
  return cudaGetLastError();
}

}  // namespace odt
