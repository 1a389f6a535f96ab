// SwiGLU conv-FFN forward for Hopper.
//
// Replaces the Pallas TPU kernel osu_dreamer_tpu/ops/swiglu.py `_kernel`
// (launched by `_fused_swiglu_fwd_impl`): depthwise conv (2r+1 taps) ->
// (C, 2H) projection -> v * silu(g) -> f32 RMS over H -> (H, C) projection.
// On the main path it is the denoiser FFN: bf16 (B, 759, 512), H = 1365, r = 2,
// 8 layers x 33 passes per sample.
//
// What bounds it on the H100: the two projections are 3*C*H multiply-adds per
// position (2.1 MFLOP at C = 512), so at the sampler's few thousand positions
// the kernel is compute- and L2-bound, not HBM-bound; the (T, 2H) activations
// would cost an HBM round trip each if they left the chip.
// What the design does: one block per 32 positions keeps the conv output and
// the gated hidden (32 x 1376 bf16, 88 KB) in shared memory, so activations
// touch HBM once in and once out, and both products run on the tensor cores.
// The weights stream from L2 for every block; a TMA/wgmma pipeline that
// reuses them across a persistent block is later work.
#include "ffn_tile.cuh"

namespace odt {

constexpr int kSwigluTile = 32;

struct SwigluSmem {
  size_t xs, ys, hs, scratch, total;
  __host__ __device__ SwigluSmem(int T, int C, int Hp, int K) {
    const int lda = C + 8, ldh = Hp + 8, E = T + K - 1;
    xs = 0;
    ys = xs + align128((size_t)E * lda * sizeof(bf16));
    hs = ys + align128((size_t)T * lda * sizeof(bf16));
    scratch = hs + align128((size_t)T * ldh * sizeof(bf16));
    total = scratch + (size_t)kFfnWarps * kScratchPerWarp * sizeof(float);
  }
};

template <int T>
__global__ void __launch_bounds__(kFfnThreads)
swiglu_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dww,
                  const bf16* __restrict__ dwb, const bf16* __restrict__ wvg,
                  const bf16* __restrict__ bvg, const bf16* __restrict__ wout,
                  const bf16* __restrict__ bout, bf16* __restrict__ out, int L, int C, int H,
                  int Hp, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  const SwigluSmem lay(T, C, Hp, K);
  bf16* xs = reinterpret_cast<bf16*>(smem + lay.xs);
  bf16* ys = reinterpret_cast<bf16*>(smem + lay.ys);
  bf16* hs = reinterpret_cast<bf16*>(smem + lay.hs);
  float* scratch = reinterpret_cast<float*>(smem + lay.scratch) + (threadIdx.x >> 5) * kScratchPerWarp;
  const int lda = C + 8, ldh = Hp + 8, r = K / 2, E = T + K - 1;
  const int b = blockIdx.y, t0 = blockIdx.x * T;
  const bf16* xb = x + (size_t)b * L * C;

  // haloed input window; the conv reads zeros outside [0, L)
  for (int idx = threadIdx.x; idx < E * C; idx += blockDim.x) {
    const int e = idx / C, c = idx % C, pos = t0 - r + e;
    xs[e * lda + c] = (pos >= 0 && pos < L) ? xb[(size_t)pos * C + c] : __float2bfloat16(0.f);
  }
  __syncthreads();
  ffn_dwconv<T>(xs, lda, dww, dwb, K, C, ys);
  __syncthreads();
  ffn_gate<T>(ys, lda, C, wvg, bvg, Hp, hs, ldh, scratch);
  __syncthreads();
  ffn_rms_rows<T>(hs, ldh, H);
  __syncthreads();
  bf16* ob = out + (size_t)b * L * C;
  ffn_out<T>(hs, ldh, Hp, wout, bout, C, scratch, [&](int t, int c, float v) {
    if (t0 + t < L) ob[(size_t)(t0 + t) * C + c] = __float2bfloat16(v);
  });
}

}  // namespace odt

extern "C" int odt_swiglu_fwd(const void* x, const void* dww, const void* dwb, const void* wvg,
                              const void* bvg, const void* wout, const void* bout, void* out,
                              int B, int L, int C, int H, int Hp, int K, void* stream) {
  using namespace odt;
  constexpr int T = kSwigluTile;
  const SwigluSmem lay(T, C, Hp, K);
  dim3 grid((L + T - 1) / T, B);
  return (int)launch(swiglu_fwd_kernel<T>, grid, dim3(kFfnThreads), lay.total,
                     (cudaStream_t)stream, (const bf16*)x, (const bf16*)dww, (const bf16*)dwb,
                     (const bf16*)wvg, (const bf16*)bvg, (const bf16*)wout, (const bf16*)bout,
                     (bf16*)out, L, C, H, Hp, K);
}
