// FiLM-modulated SwiGLU residual layer, forward, for Hopper.
//
// Replaces the Pallas TPU kernel osu_dreamer_tpu/ops/film_layer.py
// `_fwd_kernel` (launched by `_fused_film_layer_fwd_impl`). Per position:
//
//   h  = rms(x) * g1 * (1 + scale) + shift      pre-norm + FiLM
//   h  = SwiGLU(h)                              dwconv -> (C,2H) -> v*silu(g)
//                                               -> rms -> (H,C)
//   out = x + rms(h) * g2 * (1 + gate)          block norm + gated residual
//
// On the main path it is every latent U-Net layer: bf16 (B, L, 128), H = 341,
// r = 2, at L = 20493 / 6831 / 2277 (48 layers per request).
//
// What bounds it on the H100: at C = 128 a position costs 3*C*H = 131k
// multiply-adds against 512 bytes in and out, about 500 FLOP per HBM byte, so
// the layer is compute-bound once its chain of norms and projections stays on
// chip; unfused, each of the eight stages above would round-trip a (B, L, C)
// or (B, L, 2H) tensor through HBM.
// What the design does: one block per 64 positions runs the whole layer out of
// shared memory (the pre-norm window, conv output, gated hidden and block
// output, 130 KB), reading x once (plus a 2-row halo) and writing once; the
// projections run on the tensor cores. As in the Pallas kernel, positions of
// the halo outside [0, L) are zeroed AFTER the pre-norm and FiLM, because the
// shift makes a normed zero row nonzero while the conv must read zero padding.
#include "ffn_tile.cuh"

namespace odt {

constexpr int kFilmTile = 64;

struct FilmSmem {
  size_t h1, ys, hs, os, scratch, total;
  __host__ __device__ FilmSmem(int T, int C, int Hp, int K) {
    const int lda = C + 8, ldh = Hp + 8, E = T + K - 1;
    h1 = 0;
    ys = h1 + align128((size_t)E * lda * sizeof(bf16));
    hs = ys + align128((size_t)T * lda * sizeof(bf16));
    os = hs + align128((size_t)T * ldh * sizeof(bf16));
    scratch = os + align128((size_t)T * C * sizeof(float));
    total = scratch + (size_t)kFfnWarps * kScratchPerWarp * sizeof(float);
  }
};

template <int T>
__global__ void __launch_bounds__(kFfnThreads)
film_layer_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ scale,
                      const bf16* __restrict__ shift, const bf16* __restrict__ gate,
                      const bf16* __restrict__ g1, const bf16* __restrict__ g2,
                      const bf16* __restrict__ dww, const bf16* __restrict__ dwb,
                      const bf16* __restrict__ wvg, const bf16* __restrict__ bvg,
                      const bf16* __restrict__ wout, const bf16* __restrict__ bout,
                      bf16* __restrict__ out, int L, int C, int H, int Hp, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FilmSmem lay(T, C, Hp, K);
  bf16* h1 = reinterpret_cast<bf16*>(smem + lay.h1);
  bf16* ys = reinterpret_cast<bf16*>(smem + lay.ys);
  bf16* hs = reinterpret_cast<bf16*>(smem + lay.hs);
  float* os = reinterpret_cast<float*>(smem + lay.os);
  float* scratch = reinterpret_cast<float*>(smem + lay.scratch) + (threadIdx.x >> 5) * kScratchPerWarp;
  const int lda = C + 8, ldh = Hp + 8, r = K / 2, E = T + K - 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y, t0 = blockIdx.x * T;
  const bf16* xb = x + (size_t)b * L * C;
  const bf16* sc = scale + (size_t)b * C;
  const bf16* sh = shift + (size_t)b * C;
  const bf16* gt = gate + (size_t)b * C;

  // pre-norm + FiLM over the haloed window, one warp per row; rows outside
  // [0, L) are zero (see the header note)
  for (int e = warp; e < E; e += kFfnWarps) {
    const int pos = t0 - r + e;
    bf16* row = h1 + e * lda;
    if (pos < 0 || pos >= L) {
      for (int c = lane; c < C; c += 32) row[c] = __float2bfloat16(0.f);
      continue;
    }
    const bf16* xr = xb + (size_t)pos * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float v = ldf(xr + c);
      s += v * v;
    }
    const float inv = rsqrtf(warp_sum(s) / C + 1e-6f);
    for (int c = lane; c < C; c += 32) {
      const float n = bfr(bfr(ldf(xr + c) * inv) * ldf(g1 + c));
      row[c] = __float2bfloat16(bfr(n * bfr(1.f + ldf(sc + c))) + ldf(sh + c));
    }
  }
  __syncthreads();
  ffn_dwconv<T>(h1, lda, dww, dwb, K, C, ys);
  __syncthreads();
  ffn_gate<T>(ys, lda, C, wvg, bvg, Hp, hs, ldh, scratch);
  __syncthreads();
  ffn_rms_rows<T>(hs, ldh, H);
  __syncthreads();
  ffn_out<T>(hs, ldh, Hp, wout, bout, C, scratch, [&](int t, int c, float v) { os[t * C + c] = v; });
  __syncthreads();

  // block norm + gated residual, one warp per row
  bf16* ob = out + (size_t)b * L * C;
  for (int t = warp; t < T && t0 + t < L; t += kFfnWarps) {
    const float* orow = os + t * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += orow[c] * orow[c];
    const float inv = rsqrtf(warp_sum(s) / C + 1e-6f);
    const bf16* xr = xb + (size_t)(t0 + t) * C;
    for (int c = lane; c < C; c += 32) {
      const float h = bfr(bfr(orow[c] * inv) * ldf(g2 + c));
      ob[(size_t)(t0 + t) * C + c] = __float2bfloat16(ldf(xr + c) + bfr(h * bfr(1.f + ldf(gt + c))));
    }
  }
}

}  // namespace odt

extern "C" int odt_film_layer_fwd(const void* x, const void* scale, const void* shift,
                                  const void* gate, const void* g1, const void* g2,
                                  const void* dww, const void* dwb, const void* wvg,
                                  const void* bvg, const void* wout, const void* bout, void* out,
                                  int B, int L, int C, int H, int Hp, int K, void* stream) {
  using namespace odt;
  constexpr int T = kFilmTile;
  const FilmSmem lay(T, C, Hp, K);
  dim3 grid((L + T - 1) / T, B);
  return (int)launch(film_layer_fwd_kernel<T>, grid, dim3(kFfnThreads), lay.total,
                     (cudaStream_t)stream, (const bf16*)x, (const bf16*)scale,
                     (const bf16*)shift, (const bf16*)gate, (const bf16*)g1, (const bf16*)g2,
                     (const bf16*)dww, (const bf16*)dwb, (const bf16*)wvg, (const bf16*)bvg,
                     (const bf16*)wout, (const bf16*)bout, (bf16*)out, L, C, H, Hp, K);
}
