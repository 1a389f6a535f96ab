// Split-K product over shared rows, the weight-gradient shape of the FFN
// backward kernels (K3 film_layer_bwd.cu, K5 swiglu_bwd.cu, K12
// film_qkv.cu):
//
//   out (M, N) f32 = sum over r < R of A[r, :M]^T B[r, :N]
//
// with A (R, M) and B (R, N) row-major bf16 (dW = X^T dY summed over all
// B L positions). R is long (thousands to tens of thousands of rows), M and N
// short, so it is a memory-bound product: every row of A and B is read once,
// 2 M N operations per row against 2 (M + N) bytes.
//
// Design for Hopper. Work items are (128 x 128 output tile, chunk of rows);
// persistent CTAs walk them, one CTA per SM at most. A producer warpgroup
// (one thread issuing) keeps a ring of 32 KB stages in flight with TMA: per
// 64 rows, two 64 x 64 boxes of A (the tile's two 64-column halves of M) and
// two of B, 128-byte swizzled, zero-filled past R, M and N. Two consumer
// warpgroups each own 64 rows of M and all 128 columns of N: wgmma with A
// read MN-major (A^T, the transpose bit) and B MN-major, two m64n64
// accumulators a thread. Each item's f32 partial goes to part[chunk]; a
// second kernel sums the chunks in index order (no float atomics, so two
// runs are bit-identical). With one chunk the tile goes straight to `out`.
//
// Requirements: M and N multiples of 8 (the TMA row stride), lda == M and
// ldb == N, the base pointers 16-byte aligned. The caller allocates part
// (S, M, N) and out; fewer chunks than S may be used (never an empty one).
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace odt {

constexpr int kGtStages = 4;
constexpr uint32_t kGtTile = 64 * 64 * 2;           // a 64 x 64 bf16 swizzled box
constexpr uint32_t kGtStageBytes = 4 * kGtTile;    // A0, A1, B0, B1
constexpr size_t kGtSmem = kGtStages * kGtStageBytes + 2 * kGtStages * sizeof(uint64_t) + 1024;

struct GemmArgs {
  float* dst;  // part (S, M, N), or out when S == 1
  int M, N, R, S, rps, tm, tn;  // rps: rows a chunk (a multiple of 64)
};

// (static: the header is compiled into every backward kernel's file)
static __global__ void __launch_bounds__(384, 1)
gemm_tn_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
               const GemmArgs g) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kGtStages * kGtStageBytes);
  uint64_t* empty = full + kGtStages;
  const int wg = threadIdx.x / 128, items = g.tm * g.tn * g.S;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kGtStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (threadIdx.x % 128 == 0) {
      int it = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int s = item % g.S, t = item / g.S;
        const int m0 = (t % g.tm) * 128, n0 = (t / g.tm) * 128;
        const int r0 = s * g.rps, r1 = min(g.R, r0 + g.rps);
        for (int r = r0; r < r1; r += 64, ++it) {
          const int st = it % kGtStages;
          if (it >= kGtStages) mbar_wait(&empty[st], (it / kGtStages - 1) & 1);
          mbar_arrive_expect_tx(&full[st], kGtStageBytes);
          unsigned char* dst = ring + (size_t)st * kGtStageBytes;
          tma_load_3d(dst, &tm_a, &full[st], m0, r, 0);
          tma_load_3d(dst + kGtTile, &tm_a, &full[st], m0 + 64, r, 0);
          tma_load_3d(dst + 2 * kGtTile, &tm_b, &full[st], n0, r, 0);
          tma_load_3d(dst + 3 * kGtTile, &tm_b, &full[st], n0 + 64, r, 0);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<232>();

  const int tid = threadIdx.x % 128, lane = tid % 32;
  int it = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int s = item % g.S, t = item / g.S;
    const int m0 = (t % g.tm) * 128, n0 = (t / g.tm) * 128;
    const int r0 = s * g.rps, nb = (min(g.R, r0 + g.rps) - r0 + 63) / 64;
    float acc0[32], acc1[32];
    for (int b = 0; b < nb; ++b, ++it) {
      const int st = it % kGtStages;
      mbar_wait(&full[st], (it / kGtStages) & 1);
      const unsigned char* w = ring + (size_t)st * kGtStageBytes;
      const uint64_t ad = wgmma_desc(w + wg * kGtTile, 1024, 1024);
      const uint64_t bd0 = wgmma_desc(w + 2 * kGtTile, 1024, 1024);
      const uint64_t bd1 = wgmma_desc(w + 3 * kGtTile, 1024, 1024);
      fence_regs(acc0);
      fence_regs(acc1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_m64n64k16_ss_tt(acc0, ad + 128 * kk, bd0 + 128 * kk, (b | kk) != 0);
        wgmma_m64n64k16_ss_tt(acc1, ad + 128 * kk, bd1 + 128 * kk, (b | kk) != 0);
      }
      wgmma_commit();
      if (b > 0) {
        wgmma_wait<1>();
        fence_regs(acc0);
        fence_regs(acc1);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(it - 1) % kGtStages]);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc0);
    fence_regs(acc1);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[(it - 1) % kGtStages]);

    // thread t holds d[4j + e] at row 16 (t / 32) + (t % 32) / 4 + 8 (e / 2),
    // column 8 j + 2 (t % 4) + e % 2 of its warpgroup's 64 x 64 block
    float* dst = g.dst + (size_t)(g.S > 1 ? s : 0) * g.M * g.N;
    const int row = m0 + wg * 64 + (tid / 32) * 16 + lane / 4;
    auto store = [&](const float (&acc)[32], int h) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + h * 64 + j * 8 + (lane % 4) * 2;
        if (col >= g.N) continue;
        if (row < g.M)
          *reinterpret_cast<float2*>(dst + (size_t)row * g.N + col) = make_float2(acc[4 * j], acc[4 * j + 1]);
        if (row + 8 < g.M)
          *reinterpret_cast<float2*>(dst + (size_t)(row + 8) * g.N + col) =
              make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    };
    store(acc0, 0);
    store(acc1, 1);
  }
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

// the chunks the product really uses for S asked: none empty, at most one
// per 64 rows (ops/swiglu.py gemm_splits sizes `part` for S)
inline int gemm_chunks(int R, int S) {
  const int nb = (R + 63) / 64, ask = S < nb ? S : nb;
  const int per = (nb + ask - 1) / ask;
  return (nb + per - 1) / per;
}

// Launch the product (and the reduction of its chunks) on `stream`; -> the
// first launch error.
inline cudaError_t gemm_tn_splitk(const bf16* A, int lda, const bf16* B, int ldb, int R, int M,
                                  int N, int S, float* part, float* out, cudaStream_t stream) {
  if (lda != M || ldb != N || M % 8 || N % 8 || M < 1 || N < 1 || S < 1 || R < 1)
    return cudaErrorInvalidValue;
  const int chunks = gemm_chunks(R, S);
  const int per = ((R + 63) / 64 + chunks - 1) / chunks;
  CUtensorMap ma, mb;
  cudaError_t err = hopper::tma_map_bf16_3d(&ma, A, M, R, 1, 64, 64);
  if (err == cudaSuccess) err = hopper::tma_map_bf16_3d(&mb, B, N, R, 1, 64, 64);
  if (err != cudaSuccess) return err;
  const GemmArgs g{chunks > 1 ? part : out, M, N, R, chunks, per * 64, (M + 127) / 128, (N + 127) / 128};
  const int items = g.tm * g.tn * chunks, sms = device_sms();
  if (sms < 1) return cudaErrorInvalidDevice;
  err = launch(gemm_tn_kernel, dim3(items < sms ? items : sms), dim3(384), kGtSmem, stream, ma, mb, g);
  if (err != cudaSuccess || chunks == 1) return err;
  const size_t n = (size_t)M * N;
  splitk_reduce_kernel<><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(part, chunks, n, out);
  return cudaGetLastError();
}

}  // namespace odt
