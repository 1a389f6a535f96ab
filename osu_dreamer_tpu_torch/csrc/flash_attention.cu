// Flash attention forward for Hopper over q/k/v that are already normed and
// rotated.
//
// Replaces both Pallas TPU kernels of osu_dreamer_tpu/ops/long_attention.py:
// `_fwd_kernel` (k/v resident in VMEM, L <= 2048) and `_blocked_kernel`
// (online softmax over 512-wide k-blocks, longer L). The resident variant
// exists only for the TPU's VMEM budget; here one online-softmax kernel serves
// every L. Inputs (B, L, H, 64) bf16, output packed (B, L, H*64) bf16. Logits
// and softmax are f32; P @ V takes bf16 probabilities with an f32
// accumulator, as ops/long_attention.py:121-133 does.
//
// What bounds it on the H100: at the sampler's L = 759 a head's scores are
// 759 x 759; materialised in f32 they would cost 2.3 MB of HBM traffic per
// head and layer, more than q, k and v together. Computing them is 2*L*L*64
// multiply-adds per head, which the tensor cores do far faster than HBM could
// move the scores.
// What the design does: one block of 4 warps per (64 queries, head, batch
// row) walks the keys in 64-wide tiles; scores, probabilities and the output
// accumulator live in shared memory only, and both products run on the
// tensor cores through wmma. The ragged key tail (759 is no multiple of 64)
// is masked with -1e30 as the Pallas kernels do.
#include "common.cuh"

namespace odt {

constexpr int kFaD = 64;                 // head dim
constexpr int kFaBQ = 64;                // queries per block (16 per warp)
constexpr int kFaBK = 64;                // keys per tile
constexpr int kFaWarps = 4;
constexpr int kFaLd = kFaD + 8;          // bf16 row stride of the q/k/v tiles
constexpr int kFaLdp = kFaBK + 8;        // bf16 row stride of P
constexpr float kFaNeg = -1e30f;

constexpr size_t kFaTileBytes = (size_t)kFaBQ * kFaLd * sizeof(bf16);
constexpr size_t kFaSOff = 3 * kFaTileBytes;
constexpr size_t kFaOOff = kFaSOff + (size_t)kFaWarps * 16 * kFaBK * sizeof(float);
constexpr size_t kFaPOff = kFaOOff + (size_t)kFaWarps * 16 * kFaD * sizeof(float);
constexpr size_t kFaSmem = kFaPOff + (size_t)kFaWarps * 16 * kFaLdp * sizeof(bf16);
static_assert(kFaBK == kFaD, "the score tile doubles as the P @ V output tile");

// rows [p0, p0 + 64) of one head into a (64, kFaLd) tile, zero past L
__device__ __forceinline__ void fa_load_tile(bf16* dst, const bf16* src, int p0, int L,
                                             size_t row_stride) {
  for (int idx = threadIdx.x; idx < 64 * (kFaD / 8); idx += blockDim.x) {
    const int r = idx / (kFaD / 8), ch = idx % (kFaD / 8), pos = p0 + r;
    int4 v = make_int4(0, 0, 0, 0);
    if (pos < L) v = *reinterpret_cast<const int4*>(src + pos * row_stride + ch * 8);
    *reinterpret_cast<int4*>(dst + r * kFaLd + ch * 8) = v;
  }
}

__global__ void __launch_bounds__(kFaWarps * 32)
flash_attention_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ out, int L, int H,
                           float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = reinterpret_cast<bf16*>(smem + kFaTileBytes);
  bf16* Vs = reinterpret_cast<bf16*>(smem + 2 * kFaTileBytes);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* Sw = reinterpret_cast<float*>(smem + kFaSOff) + warp * 16 * kFaBK;
  float* Ow = reinterpret_cast<float*>(smem + kFaOOff) + warp * 16 * kFaD;
  bf16* Pw = reinterpret_cast<bf16*>(smem + kFaPOff) + warp * 16 * kFaLdp;

  const int q0 = blockIdx.x * kFaBQ, h = blockIdx.y, b = blockIdx.z;
  const size_t row_stride = (size_t)H * kFaD;
  const size_t head_base = (size_t)b * L * row_stride + (size_t)h * kFaD;

  fa_load_tile(Qs, q + head_base, q0, L, row_stride);

  // each lane owns half (32 columns) of one of its warp's 16 rows
  const int rr = lane >> 1, c0 = (lane & 1) * 32;
  for (int c = 0; c < 32; ++c) Ow[rr * kFaD + c0 + c] = 0.f;
  float m = kFaNeg, l = 0.f;

  for (int kb = 0; kb * kFaBK < L; ++kb) {
    __syncthreads();  // every warp is done with the previous k/v tiles
    fa_load_tile(Ks, k + head_base, kb * kFaBK, L, row_stride);
    fa_load_tile(Vs, v + head_base, kb * kFaBK, L, row_stride);
    __syncthreads();

    // S = Q_w K^T (16 x 64), f32
#pragma unroll
    for (int ct = 0; ct < kFaBK / 16; ++ct) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
      wmma::fill_fragment(s, 0.f);
#pragma unroll
      for (int kk = 0; kk < kFaD; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
        wmma::load_matrix_sync(a, Qs + warp * 16 * kFaLd + kk, kFaLd);
        wmma::load_matrix_sync(bt, Ks + ct * 16 * kFaLd + kk, kFaLd);
        wmma::mma_sync(s, a, bt, s);
      }
      wmma::store_matrix_sync(Sw + ct * 16, s, kFaBK, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this tile's columns
    float sv[32];
    float mx = kFaNeg;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = c0 + c;
      const float x = (kb * kFaBK + col < L) ? Sw[rr * kFaBK + col] * scale : kFaNeg;
      sv[c] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float ps = 0.f;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float p = expf(sv[c] - m_new);
      ps += p;
      Pw[rr * kFaLdp + c0 + c] = __float2bfloat16(p);
    }
    ps += __shfl_xor_sync(0xffffffffu, ps, 1);
    l = l * alpha + ps;
    m = m_new;
    for (int c = 0; c < 32; ++c) Ow[rr * kFaD + c0 + c] *= alpha;
    __syncwarp();

    // O += P V (16 x 64), bf16 in, f32 accumulate; Sw holds the product
#pragma unroll
    for (int ct = 0; ct < kFaD / 16; ++ct) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
      wmma::fill_fragment(o, 0.f);
#pragma unroll
      for (int kk = 0; kk < kFaBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, Pw + kk, kFaLdp);
        wmma::load_matrix_sync(bv, Vs + kk * kFaLd + ct * 16, kFaLd);
        wmma::mma_sync(o, a, bv, o);
      }
      wmma::store_matrix_sync(Sw + ct * 16, o, kFaD, wmma::mem_row_major);
    }
    __syncwarp();
    for (int c = 0; c < 32; ++c) Ow[rr * kFaD + c0 + c] += Sw[rr * kFaD + c0 + c];
    __syncwarp();
  }

  const int pos = q0 + warp * 16 + rr;
  if (pos < L) {
    const float inv = 1.f / l;
    bf16* orow = out + head_base + (size_t)pos * row_stride + c0;
    for (int c = 0; c < 32; ++c) orow[c] = __float2bfloat16(Ow[rr * kFaD + c0 + c] * inv);
  }
}

}  // namespace odt

extern "C" int odt_flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                       int B, int L, int H, float scale, void* stream) {
  using namespace odt;
  dim3 grid((L + kFaBQ - 1) / kFaBQ, H, B);
  return (int)launch(flash_attention_fwd_kernel, grid, dim3(kFaWarps * 32), kFaSmem,
                     (cudaStream_t)stream, (const bf16*)q, (const bf16*)k, (const bf16*)v,
                     (bf16*)out, L, H, scale);
}
