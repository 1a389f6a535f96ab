// Resonator-bank recurrence for Hopper: (S, K, 98) frames -> (S, K, 72, 2)
// complex states at frame boundaries, f32 throughout.
//
// Replaces the Pallas TPU kernel osu_dreamer_tpu/ops/resonator.py `_kernel`
// (launched by `resonate_frames_pallas`). Per frame k and bin f the state obeys
// y_k = A_f y_{k-1} + c_k with c_k = frames[k] @ W (the frame's contribution)
// and A_f = b_f^98 (see osu_dreamer_tpu/audio/spectrogram.py).
//
// The TPU kernel carries the state from one tile to the next through scratch
// memory, relying on its grid running in order. Blocks on Hopper run in no
// order, so the scan is split into three launches:
//   1. per (chunk of 64 frames, song): the (64 x 98) @ (98 x 144) contribution
//      product, then the in-chunk scan y_i = A y_{i-1} + c_i from a zero state;
//   2. per (song, bin): a sequential carry across the song's chunks
//      (K / 64 = 320 steps for a 2-minute song), never crossing songs;
//   3. per (song, frame, bin): y_i += A^(i+1) * carry_in(chunk).
//
// What bounds it on the H100: 98 x 144 multiply-adds per frame against 392
// bytes of wave read and 576 bytes of state written, about 70 FLOP per byte,
// so it is memory-bound at a few microseconds per song; the carry pass is a
// latency chain of 320 dependent complex multiply-adds.
// What the design does: the contribution product and the in-chunk scan share
// one pass over shared memory (W, 56 KB, is staged once per block), so each
// frame is read once and each state written once by launch 1 and updated once
// by launch 3; the serial part is cut from K to K / 64 steps.
#include "common.cuh"

namespace odt {

constexpr int kHop = 98;
constexpr int kBins = 72;
constexpr int kCols = 2 * kBins;     // [re | im]
constexpr int kChunk = 64;
constexpr int kResThreads = 256;
constexpr size_t kResSmem = (size_t)(kChunk * kHop + kHop * kCols + kChunk * kCols) * sizeof(float);

__global__ void __launch_bounds__(kResThreads)
resonate_chunk_kernel(const float* __restrict__ frames, const float* __restrict__ W,
                      const float* __restrict__ A, float* __restrict__ out,
                      float* __restrict__ last, int K, int n_chunks) {
  extern __shared__ __align__(128) float sm[];
  float* Xs = sm;                       // (kChunk, kHop)
  float* Ws = Xs + kChunk * kHop;       // (kHop, kCols)
  float* Cs = Ws + kHop * kCols;        // (kChunk, kCols)
  const int c = blockIdx.x, s = blockIdx.y, k0 = c * kChunk;
  const int n_valid = min(kChunk, K - k0);
  const float* fs = frames + ((size_t)s * K + k0) * kHop;

  for (int i = threadIdx.x; i < kChunk * kHop; i += blockDim.x)
    Xs[i] = i < n_valid * kHop ? fs[i] : 0.f;
  for (int i = threadIdx.x; i < kHop * kCols; i += blockDim.x) Ws[i] = W[i];
  __syncthreads();

  // contribution product (kChunk x kHop) @ (kHop x kCols)
  for (int idx = threadIdx.x; idx < kChunk * kCols; idx += blockDim.x) {
    const int i = idx / kCols, j = idx % kCols;
    float acc = 0.f;
#pragma unroll 14
    for (int h = 0; h < kHop; ++h) acc = fmaf(Xs[i * kHop + h], Ws[h * kCols + j], acc);
    Cs[idx] = acc;
  }
  __syncthreads();

  // in-chunk scan from a zero state, one thread per bin
  if (threadIdx.x < kBins) {
    const int f = threadIdx.x;
    const float ar = A[2 * f], ai = A[2 * f + 1];
    float yr = 0.f, yi = 0.f;
    for (int i = 0; i < n_valid; ++i) {
      const float nr = ar * yr - ai * yi + Cs[i * kCols + f];
      const float ni = ar * yi + ai * yr + Cs[i * kCols + kBins + f];
      yr = nr;
      yi = ni;
      float* o = out + (((size_t)s * K + k0 + i) * kBins + f) * 2;
      o[0] = yr;
      o[1] = yi;
    }
    float* lo = last + (((size_t)s * n_chunks + c) * kBins + f) * 2;
    lo[0] = yr;
    lo[1] = yi;
  }
}

// carry[s][c] = the true state entering chunk c; AT = A^kChunk
__global__ void resonate_carry_kernel(const float* __restrict__ AT, const float* __restrict__ last,
                                      float* __restrict__ carry, int S, int n_chunks) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= S * kBins) return;
  const int s = idx / kBins, f = idx % kBins;
  const float ar = AT[2 * f], ai = AT[2 * f + 1];
  float yr = 0.f, yi = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const size_t o = (((size_t)s * n_chunks + c) * kBins + f) * 2;
    carry[o] = yr;
    carry[o + 1] = yi;
    const float nr = ar * yr - ai * yi + last[o];
    const float ni = ar * yi + ai * yr + last[o + 1];
    yr = nr;
    yi = ni;
  }
}

// out[s][k] += A^(i+1) * carry[s][k / kChunk], i = k % kChunk; P = A^(i+1)
__global__ void resonate_apply_kernel(const float* __restrict__ P, const float* __restrict__ carry,
                                      float* __restrict__ out, int S, int K, int n_chunks) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)S * K * kBins) return;
  const int f = idx % kBins;
  const size_t sk = idx / kBins;
  const int k = sk % K, s = sk / K;
  const int c = k / kChunk, i = k % kChunk;
  if (c == 0) return;  // the first chunk enters from the zero state
  const float pr = P[(i * kBins + f) * 2], pi = P[(i * kBins + f) * 2 + 1];
  const size_t o = (((size_t)s * n_chunks + c) * kBins + f) * 2;
  const float cr = carry[o], ci = carry[o + 1];
  out[idx * 2] += pr * cr - pi * ci;
  out[idx * 2 + 1] += pr * ci + pi * cr;
}

}  // namespace odt

extern "C" int odt_resonate(const void* frames, const void* W, const void* A, const void* AT,
                            const void* P, void* out, void* last, void* carry, int S, int K,
                            void* stream) {
  using namespace odt;
  const cudaStream_t st = (cudaStream_t)stream;
  const int n_chunks = (K + kChunk - 1) / kChunk;
  cudaError_t err = launch(resonate_chunk_kernel, dim3(n_chunks, S), dim3(kResThreads), kResSmem,
                           st, (const float*)frames, (const float*)W, (const float*)A,
                           (float*)out, (float*)last, K, n_chunks);
  if (err != cudaSuccess) return (int)err;
  resonate_carry_kernel<<<(S * kBins + 127) / 128, 128, 0, st>>>(
      (const float*)AT, (const float*)last, (float*)carry, S, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)S * K * kBins;
  resonate_apply_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      (const float*)P, (const float*)carry, (float*)out, S, K, n_chunks);
  return (int)cudaGetLastError();
}
