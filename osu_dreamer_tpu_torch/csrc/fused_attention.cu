// Fused per-head RMS norm + RoPE + softmax attention for Hopper, forward (K9)
// and backward (K10), straight off the packed qkv projection.
//
// Replaces the Pallas TPU kernels of osu_dreamer_tpu/ops/fused_attention.py:
// `_fwd_kernel` (launched by `_fwd_impl`) and `_bwd_kernel` (launched by
// `_vjp_bwd`). On the main path they are the denoiser's attention in training:
// qkv bf16 (128, 152, 3 x 16 x 64), gammas (64,), 8 layers per step.
//
// What bounds them on the H100: per (batch, head) the L x L logits cost
// 2 L^2 D multiply-adds per product (5 products in the backward), while the
// inputs are only a few L x 64 rows; materialised in HBM the f32 (L, L)
// probabilities would be the largest traffic of the layer. At L <= 256 a
// head's rotated keys, values and gradient rows fit in shared memory, so the
// kernels are bound by the tensor-core products and the exp/softmax work,
// not by HBM.
// What the design does: the norm (f32 statistics), gamma and RoPE are applied
// while the rows are loaded, and nothing of size L x L leaves the chip.
//   K9: one block of 4 warps per (64 queries, head, batch row). The block
//       copies the head's L key and value rows and its 64 query rows into
//       shared memory (16 bytes a thread), normalises and rotates them in
//       place, each warp computes its 16 score rows over all L keys (wmma,
//       f32), a two-pass softmax (max, sum, then the normalised probability
//       rounded to bf16 once, as the plain version rounds it) whose P
//       overwrites the key rows, and P V on the tensor cores; at L = 152 two
//       blocks share an SM. It saves rq, rk (bf16), 1/rms of q and k (f32) and
//       the log-sum-exp of each query row for the backward.
//   K10: one block of 8 warps per (head, batch row) holds rq, rk, v and dO of
//       all L rows in shared memory. Phase 1: each warp owns key tiles of 16
//       and walks every query tile, recomputing P from the saved
//       log-sum-exp, and accumulates dV = P^T dO and dK = dS^T Q in registers, with
//       dS = P (dP - rowsum(dO O)) / sqrt(D). Phase 2: each warp owns query
//       tiles and accumulates dQ = dS K the same way. Every row of dQ/dK/dV
//       is owned by one warp, so no atomics are needed and the result is
//       deterministic. Each finished 16-row tile goes back through the
//       inverse rotation and the gamma-scaled RMS norm (f32) into dqkv; the
//       gamma gradients leave as one f32 partial per (batch, head), summed by
//       the wrapper.
// A first design on wmma/mma.sync; TMA and wgmma pipelines are later work.
#include "common.cuh"

namespace odt {

constexpr int kAtD = 64;                 // head dim
constexpr int kAtWarps = 4;              // forward
constexpr int kAtThreads = kAtWarps * 32;
constexpr int kAtBwdWarps = 8;           // backward
constexpr int kAtBwdThreads = kAtBwdWarps * 32;
constexpr int kAtBQ = 64;                // queries per forward block (16 per warp)
constexpr int kAtLd = kAtD + 8;          // bf16 row stride of the q/k/v/dO rows
constexpr int kAtLdT = kAtD + 4;         // f32 row stride of a 16 x 64 gradient tile

using FragAccum = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
using FragARow = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragACol = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;

__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }

// rows [p0, p0 + rows) of one head (row stride `stride`) into (rows, kAtLd),
// zero from L on; 16 bytes a thread, neighbouring threads on neighbouring
// addresses
__device__ __forceinline__ void at_load_rows(bf16* dst, const bf16* src, int p0, int rows,
                                             int L, size_t stride) {
  for (int idx = threadIdx.x; idx < rows * (kAtD / 8); idx += blockDim.x) {
    const int r = idx / (kAtD / 8), ch = idx % (kAtD / 8);
    int4 v = make_int4(0, 0, 0, 0);
    if (p0 + r < L) v = *reinterpret_cast<const int4*>(src + (size_t)(p0 + r) * stride + ch * 8);
    *reinterpret_cast<int4*>(dst + r * kAtLd + ch * 8) = v;
  }
}

// One warp normalises and rotates one head row of 64 values in place (lane j
// owns the rotary pair j, j + 32) in the plain version's rounding order: f32
// 1/rms, bf16(x / rms), bf16(* gamma), then bf16 rotary products and sums.
// -> 1/rms
__device__ __forceinline__ float norm_rope_row(bf16* row, float g1, float g2, const bf16* cos_t,
                                               const bf16* sin_t, int pos, int lane) {
  const float c = ldf(cos_t + pos * (kAtD / 2) + lane), s = ldf(sin_t + pos * (kAtD / 2) + lane);
  const float x1 = ldf(row + lane), x2 = ldf(row + lane + 32);
  const float inv = 1.f / sqrtf(warp_sum(x1 * x1 + x2 * x2) / kAtD + 1e-6f);
  const float n1 = bfr(bfr(x1 * inv) * g1);
  const float n2 = bfr(bfr(x2 * inv) * g2);
  row[lane] = __float2bfloat16(bfr(n1 * c) - bfr(n2 * s));
  row[lane + 32] = __float2bfloat16(bfr(n1 * s) + bfr(n2 * c));
  return inv;
}

// ------------------------------------------------------------------ forward --

// The bf16 probabilities P take the place of the key rows once every warp
// has its scores: at L = 152 the block then needs 98 KB, so two blocks share
// an SM.
struct AttnFwdSmem {
  int Lk, lds, ldp;
  size_t q, k, v, s, invq, invk, total;
  __host__ __device__ AttnFwdSmem(int L) {
    Lk = round16(L);
    lds = (Lk > kAtD ? Lk : kAtD) + 4;  // f32 scores; also the 16 x 64 output tile
    ldp = Lk + 8;
    const size_t kbytes = align128((size_t)Lk * kAtLd * sizeof(bf16));
    const size_t pbytes = align128((size_t)kAtWarps * 16 * ldp * sizeof(bf16));
    q = 0;
    k = q + align128((size_t)kAtBQ * kAtLd * sizeof(bf16));
    v = k + (kbytes > pbytes ? kbytes : pbytes);
    s = v + kbytes;
    invq = s + align128((size_t)kAtWarps * 16 * lds * sizeof(float));
    invk = invq + align128(kAtBQ * sizeof(float));
    total = invk + align128((size_t)Lk * sizeof(float));
  }
};

__global__ void __launch_bounds__(kAtThreads)
fused_attention_fwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ gq,
                           const bf16* __restrict__ gk, const bf16* __restrict__ cos_t,
                           const bf16* __restrict__ sin_t, bf16* __restrict__ out,
                           float* __restrict__ lse, bf16* __restrict__ rq, bf16* __restrict__ rk,
                           float* __restrict__ iq, float* __restrict__ ik, int L, int H,
                           float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const AttnFwdSmem lay(L);
  bf16* Qs = reinterpret_cast<bf16*>(smem + lay.q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + lay.k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + lay.v);
  float* invq = reinterpret_cast<float*>(smem + lay.invq);
  float* invk = reinterpret_cast<float*>(smem + lay.invk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* Sw = reinterpret_cast<float*>(smem + lay.s) + warp * 16 * lay.lds;
  bf16* Pw = reinterpret_cast<bf16*>(smem + lay.k) + warp * 16 * lay.ldp;

  const int q0 = blockIdx.x * kAtBQ, h = blockIdx.y, b = blockIdx.z;
  const int HD = H * kAtD, Lk = lay.Lk;
  const size_t row3 = 3 * (size_t)HD;
  const bf16* base = qkv + (size_t)b * L * row3 + h * kAtD;
  const bf16 zero = __float2bfloat16(0.f);
  // raw rows in: the head's keys and values, this block's queries
  at_load_rows(Ks, base + HD, 0, Lk, L, row3);
  at_load_rows(Vs, base + 2 * HD, 0, Lk, L, row3);
  at_load_rows(Qs, base, q0, kAtBQ, L, row3);
  __syncthreads();
  // normed and rotated in place, a warp per row
  {
    const float gk1 = ldf(gk + lane), gk2 = ldf(gk + lane + 32);
    for (int r = warp; r < L; r += kAtWarps)
      invk[r] = norm_rope_row(Ks + r * kAtLd, gk1, gk2, cos_t, sin_t, r, lane);
    const float gq1 = ldf(gq + lane), gq2 = ldf(gq + lane + 32);
    for (int r = warp; r < kAtBQ && q0 + r < L; r += kAtWarps)
      invq[r] = norm_rope_row(Qs + r * kAtLd, gq1, gq2, cos_t, sin_t, q0 + r, lane);
  }
  __syncthreads();

  // residuals for the backward: this block's query rows, and the key rows of
  // the same positions (every key row is written by exactly one block)
  for (int r = warp; r < kAtBQ; r += kAtWarps) {
    const int pos = q0 + r;
    if (pos >= L) break;
    const size_t o = ((size_t)b * L + pos) * HD + h * kAtD;
    rq[o + lane] = Qs[r * kAtLd + lane];
    rq[o + lane + 32] = Qs[r * kAtLd + lane + 32];
    rk[o + lane] = Ks[pos * kAtLd + lane];
    rk[o + lane + 32] = Ks[pos * kAtLd + lane + 32];
    if (lane == 0) {
      iq[((size_t)b * L + pos) * H + h] = invq[r];
      ik[((size_t)b * L + pos) * H + h] = invk[pos];
    }
  }

  // S = Q_w K^T (16 x Lk), f32
  for (int ct = 0; ct < Lk / 16; ++ct) {
    FragAccum s;
    wmma::fill_fragment(s, 0.f);
#pragma unroll
    for (int kk = 0; kk < kAtD; kk += 16) {
      FragARow a;
      FragBCol bt;
      wmma::load_matrix_sync(a, Qs + warp * 16 * kAtLd + kk, kAtLd);
      wmma::load_matrix_sync(bt, Ks + ct * 16 * kAtLd + kk, kAtLd);
      wmma::mma_sync(s, a, bt, s);
    }
    wmma::store_matrix_sync(Sw + ct * 16, s, lay.lds, wmma::mem_row_major);
  }
  __syncthreads();  // every warp is done with the key rows: P may overwrite them

  // softmax over the L valid keys: a lane pair per row, columns interleaved
  const int rr = lane >> 1, half = lane & 1;
  const float* srow = Sw + rr * lay.lds;
  float m = -INFINITY;
  for (int c = half; c < L; c += 2) m = fmaxf(m, srow[c] * scale);
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  float l = 0.f;
  for (int c = half; c < L; c += 2) l += expf(srow[c] * scale - m);
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  for (int c = half; c < Lk; c += 2)
    Pw[rr * lay.ldp + c] = c < L ? __float2bfloat16(expf(srow[c] * scale - m) / l) : zero;
  const int pos = q0 + warp * 16 + rr;
  if (half == 0 && pos < L) lse[((size_t)b * H + h) * L + pos] = m + logf(l);
  __syncwarp();

  // O = P V (16 x 64): bf16 probabilities, f32 accumulate; Sw holds the product
#pragma unroll
  for (int ct = 0; ct < kAtD / 16; ++ct) {
    FragAccum o;
    wmma::fill_fragment(o, 0.f);
    for (int kk = 0; kk < Lk; kk += 16) {
      FragARow a;
      FragBRow bv;
      wmma::load_matrix_sync(a, Pw + kk, lay.ldp);
      wmma::load_matrix_sync(bv, Vs + kk * kAtLd + ct * 16, kAtLd);
      wmma::mma_sync(o, a, bv, o);
    }
    wmma::store_matrix_sync(Sw + ct * 16, o, lay.lds, wmma::mem_row_major);
  }
  __syncwarp();
  if (pos < L) {
    bf16* orow = out + ((size_t)b * L + pos) * HD + h * kAtD + half * 32;
    for (int c = 0; c < 32; ++c) orow[c] = __float2bfloat16(Sw[rr * lay.lds + half * 32 + c]);
  }
}

// ----------------------------------------------------------------- backward --

constexpr size_t kAtScrT = 0;                                    // 16 x kAtLdT f32
constexpr size_t kAtScrS = kAtScrT + 16 * kAtLdT * sizeof(float);  // 16 x 16 f32
constexpr size_t kAtScrDP = kAtScrS + 256 * sizeof(float);         // 16 x 16 f32
constexpr size_t kAtScrP = kAtScrDP + 256 * sizeof(float);         // 16 x 16 bf16
constexpr size_t kAtScrDS = kAtScrP + 256 * sizeof(bf16);          // 16 x 16 bf16
constexpr size_t kAtScr = align128(kAtScrDS + 256 * sizeof(bf16));

struct AttnBwdSmem {
  int Lk;
  size_t q, k, v, dO, lse, delta, scratch, dg, total;
  __host__ __device__ AttnBwdSmem(int L) {
    Lk = round16(L);
    const size_t rows = align128((size_t)Lk * kAtLd * sizeof(bf16));
    q = 0;
    k = q + rows;
    v = k + rows;
    dO = v + rows;
    lse = dO + rows;
    delta = lse + align128((size_t)Lk * sizeof(float));
    scratch = delta + align128((size_t)Lk * sizeof(float));
    dg = scratch + kAtBwdWarps * kAtScr;
    total = dg + 2 * kAtBwdWarps * kAtD * sizeof(float);
  }
};

struct AttnBwdTiles {
  const bf16 *Qs, *Ks, *Vs, *dOs;
  const float *lse, *delta;
  float *S, *dP;
  bf16 *P, *dS;
};

// For query tile qt and key tile kt (16 x 16): S = Q K^T and dP = dO V^T on
// the tensor cores, then P = exp(S * scale - lse) (0 past L: lse is +inf
// for padded queries, padded keys are masked) and
// dS = P (dP - delta) * scale, both rounded to bf16.
__device__ __forceinline__ void at_bwd_tile(const AttnBwdTiles& t, int qt, int kt, int L,
                                            float scale, int lane) {
  FragAccum s, dp;
  wmma::fill_fragment(s, 0.f);
  wmma::fill_fragment(dp, 0.f);
#pragma unroll
  for (int kk = 0; kk < kAtD; kk += 16) {
    FragARow a;
    FragBCol bt;
    wmma::load_matrix_sync(a, t.Qs + qt * 16 * kAtLd + kk, kAtLd);
    wmma::load_matrix_sync(bt, t.Ks + kt * 16 * kAtLd + kk, kAtLd);
    wmma::mma_sync(s, a, bt, s);
    wmma::load_matrix_sync(a, t.dOs + qt * 16 * kAtLd + kk, kAtLd);
    wmma::load_matrix_sync(bt, t.Vs + kt * 16 * kAtLd + kk, kAtLd);
    wmma::mma_sync(dp, a, bt, dp);
  }
  wmma::store_matrix_sync(t.S, s, 16, wmma::mem_row_major);
  wmma::store_matrix_sync(t.dP, dp, 16, wmma::mem_row_major);
  __syncwarp();
  for (int e = lane; e < 256; e += 32) {
    const int q = qt * 16 + (e >> 4), key = kt * 16 + (e & 15);
    const float p = key < L ? expf(t.S[e] * scale - t.lse[q]) : 0.f;
    t.P[e] = __float2bfloat16(p);
    t.dS[e] = __float2bfloat16(p * (t.dP[e] - t.delta[q]) * scale);
  }
  __syncwarp();
}

// The 16 x 64 f32 gradient tile T of the rotated rows pos0.. back through the
// inverse rotation and the gamma-scaled RMS norm (f32) into dx (bf16); lane
// j's gamma partials for elements j and j + 32 accumulate in dg1, dg2.
__device__ __forceinline__ void at_norm_rope_bwd(const float* T, int pos0, int L, const bf16* x,
                                                 size_t stride, const float* inv, int H,
                                                 const bf16* gamma, const bf16* cos_t,
                                                 const bf16* sin_t, bf16* dx, float& dg1,
                                                 float& dg2, int lane) {
  const float g1 = ldf(gamma + lane), g2 = ldf(gamma + lane + 32);
  for (int r = 0; r < 16; ++r) {
    const int pos = pos0 + r;
    if (pos >= L) break;
    const float d1 = T[r * kAtLdT + lane], d2 = T[r * kAtLdT + lane + 32];
    const float c = ldf(cos_t + pos * (kAtD / 2) + lane);
    const float s = ldf(sin_t + pos * (kAtD / 2) + lane);
    const float gn1 = d1 * c + d2 * s, gn2 = d2 * c - d1 * s;
    const float iv = inv[(size_t)pos * H];
    const float x1 = ldf(x + pos * stride + lane), x2 = ldf(x + pos * stride + lane + 32);
    dg1 += gn1 * x1 * iv;
    dg2 += gn2 * x2 * iv;
    const float gh1 = gn1 * g1, gh2 = gn2 * g2;
    const float m = warp_sum(gh1 * x1 + gh2 * x2) / kAtD;
    const float i3 = iv * iv * iv;
    dx[pos * stride + lane] = __float2bfloat16(gh1 * iv - x1 * i3 * m);
    dx[pos * stride + lane + 32] = __float2bfloat16(gh2 * iv - x2 * i3 * m);
  }
}

__device__ __forceinline__ void at_store_tile(float* T, FragAccum (&acc)[kAtD / 16]) {
#pragma unroll
  for (int n = 0; n < kAtD / 16; ++n)
    wmma::store_matrix_sync(T + n * 16, acc[n], kAtLdT, wmma::mem_row_major);
  __syncwarp();
}

__global__ void __launch_bounds__(kAtBwdThreads)
fused_attention_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                           const bf16* __restrict__ out, const float* __restrict__ lse,
                           const bf16* __restrict__ rq, const bf16* __restrict__ rk,
                           const float* __restrict__ iq, const float* __restrict__ ik,
                           const bf16* __restrict__ gq, const bf16* __restrict__ gk,
                           const bf16* __restrict__ cos_t, const bf16* __restrict__ sin_t,
                           bf16* __restrict__ dqkv, float* __restrict__ dgq,
                           float* __restrict__ dgk, int L, int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const AttnBwdSmem lay(L);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.x, b = blockIdx.y;
  const int HD = H * kAtD, Lk = lay.Lk, nt = Lk / 16;
  const size_t row3 = 3 * (size_t)HD;
  bf16* Qs = reinterpret_cast<bf16*>(smem + lay.q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + lay.k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + lay.v);
  bf16* dOs = reinterpret_cast<bf16*>(smem + lay.dO);
  float* lse_s = reinterpret_cast<float*>(smem + lay.lse);
  float* delta_s = reinterpret_cast<float*>(smem + lay.delta);
  unsigned char* scr = smem + lay.scratch + warp * kAtScr;
  float* T = reinterpret_cast<float*>(scr + kAtScrT);
  float* dgs = reinterpret_cast<float*>(smem + lay.dg);

  const size_t head = (size_t)b * L * HD + h * kAtD;  // (B, L, HD) tensors
  const bf16* xq = qkv + (size_t)b * L * row3 + h * kAtD;
  at_load_rows(Qs, rq + head, 0, Lk, L, HD);
  at_load_rows(Ks, rk + head, 0, Lk, L, HD);
  at_load_rows(Vs, xq + 2 * HD, 0, Lk, L, row3);
  at_load_rows(dOs, dout + head, 0, Lk, L, HD);
  __syncthreads();
  // delta = rowsum(dO * O): 8 threads per row, 16 bytes of O each
  for (int idx = threadIdx.x; idx < Lk * (kAtD / 8); idx += blockDim.x) {
    const int r = idx / (kAtD / 8), ch = idx % (kAtD / 8);
    float d = 0.f;
    if (r < L) {
      const int4 raw = *reinterpret_cast<const int4*>(out + head + (size_t)r * HD + ch * 8);
      const bf16* o = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int e = 0; e < 8; ++e) d += ldf(o + e) * ldf(dOs + r * kAtLd + ch * 8 + e);
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    d += __shfl_xor_sync(0xffffffffu, d, 4);
    if (ch == 0) {
      delta_s[r] = d;
      lse_s[r] = r < L ? lse[((size_t)b * H + h) * L + r] : INFINITY;
    }
  }
  __syncthreads();

  const AttnBwdTiles t{Qs, Ks, Vs, dOs, lse_s, delta_s,
                       reinterpret_cast<float*>(scr + kAtScrS),
                       reinterpret_cast<float*>(scr + kAtScrDP),
                       reinterpret_cast<bf16*>(scr + kAtScrP),
                       reinterpret_cast<bf16*>(scr + kAtScrDS)};
  bf16* dq = dqkv + (size_t)b * L * row3 + h * kAtD;
  float dgq1 = 0.f, dgq2 = 0.f, dgk1 = 0.f, dgk2 = 0.f;

  // phase 1: dV = P^T dO and dK = dS^T Q over the key tiles this warp owns
  for (int kt = warp; kt < nt; kt += kAtBwdWarps) {
    FragAccum dv[kAtD / 16], dk[kAtD / 16];
#pragma unroll
    for (int n = 0; n < kAtD / 16; ++n) {
      wmma::fill_fragment(dv[n], 0.f);
      wmma::fill_fragment(dk[n], 0.f);
    }
    for (int qt = 0; qt < nt; ++qt) {
      at_bwd_tile(t, qt, kt, L, scale, lane);
      FragACol pt, dst;
      wmma::load_matrix_sync(pt, t.P, 16);
      wmma::load_matrix_sync(dst, t.dS, 16);
#pragma unroll
      for (int n = 0; n < kAtD / 16; ++n) {
        FragBRow bm;
        wmma::load_matrix_sync(bm, dOs + qt * 16 * kAtLd + n * 16, kAtLd);
        wmma::mma_sync(dv[n], pt, bm, dv[n]);
        wmma::load_matrix_sync(bm, Qs + qt * 16 * kAtLd + n * 16, kAtLd);
        wmma::mma_sync(dk[n], dst, bm, dk[n]);
      }
    }
    at_store_tile(T, dv);
    for (int r = 0; r < 16; ++r) {
      const int pos = kt * 16 + r;
      if (pos >= L) break;
      bf16* drow = dq + pos * row3 + 2 * HD;
      drow[lane] = __float2bfloat16(T[r * kAtLdT + lane]);
      drow[lane + 32] = __float2bfloat16(T[r * kAtLdT + lane + 32]);
    }
    __syncwarp();
    at_store_tile(T, dk);
    at_norm_rope_bwd(T, kt * 16, L, xq + HD, row3, ik + (size_t)b * L * H + h, H, gk, cos_t,
                     sin_t, dq + HD, dgk1, dgk2, lane);
    __syncwarp();
  }

  // phase 2: dQ = dS K over the query tiles this warp owns
  for (int qt = warp; qt < nt; qt += kAtBwdWarps) {
    FragAccum dqa[kAtD / 16];
#pragma unroll
    for (int n = 0; n < kAtD / 16; ++n) wmma::fill_fragment(dqa[n], 0.f);
    for (int kt = 0; kt < nt; ++kt) {
      at_bwd_tile(t, qt, kt, L, scale, lane);
      FragARow ds;
      wmma::load_matrix_sync(ds, t.dS, 16);
#pragma unroll
      for (int n = 0; n < kAtD / 16; ++n) {
        FragBRow bm;
        wmma::load_matrix_sync(bm, Ks + kt * 16 * kAtLd + n * 16, kAtLd);
        wmma::mma_sync(dqa[n], ds, bm, dqa[n]);
      }
    }
    at_store_tile(T, dqa);
    at_norm_rope_bwd(T, qt * 16, L, xq, row3, iq + (size_t)b * L * H + h, H, gq, cos_t, sin_t,
                     dq, dgq1, dgq2, lane);
    __syncwarp();
  }

  // gamma partials of this (batch, head), summed over the warps in order
  dgs[(0 * kAtBwdWarps + warp) * kAtD + lane] = dgq1;
  dgs[(0 * kAtBwdWarps + warp) * kAtD + lane + 32] = dgq2;
  dgs[(1 * kAtBwdWarps + warp) * kAtD + lane] = dgk1;
  dgs[(1 * kAtBwdWarps + warp) * kAtD + lane + 32] = dgk2;
  __syncthreads();
  if (threadIdx.x < 2 * kAtD) {
    const int which = threadIdx.x / kAtD, d = threadIdx.x % kAtD;
    float s = 0.f;
    for (int w = 0; w < kAtBwdWarps; ++w) s += dgs[(which * kAtBwdWarps + w) * kAtD + d];
    (which ? dgk : dgq)[((size_t)b * H + h) * kAtD + d] = s;
  }
}

}  // namespace odt

extern "C" int odt_fused_attention_fwd(const void* qkv, const void* gq, const void* gk,
                                       const void* cos_t, const void* sin_t, void* out, void* lse,
                                       void* rq, void* rk, void* iq, void* ik, int B, int L, int H,
                                       float scale, void* stream) {
  using namespace odt;
  const AttnFwdSmem lay(L);
  dim3 grid((L + kAtBQ - 1) / kAtBQ, H, B);
  return (int)launch(fused_attention_fwd_kernel, grid, dim3(kAtThreads), lay.total,
                     (cudaStream_t)stream, (const bf16*)qkv, (const bf16*)gq, (const bf16*)gk,
                     (const bf16*)cos_t, (const bf16*)sin_t, (bf16*)out, (float*)lse, (bf16*)rq,
                     (bf16*)rk, (float*)iq, (float*)ik, L, H, scale);
}

extern "C" int odt_fused_attention_bwd(const void* qkv, const void* dout, const void* out,
                                       const void* lse, const void* rq, const void* rk,
                                       const void* iq, const void* ik, const void* gq,
                                       const void* gk, const void* cos_t, const void* sin_t,
                                       void* dqkv, void* dgq, void* dgk, int B, int L, int H,
                                       float scale, void* stream) {
  using namespace odt;
  const AttnBwdSmem lay(L);
  return (int)launch(fused_attention_bwd_kernel, dim3(H, B), dim3(kAtBwdThreads), lay.total,
                     (cudaStream_t)stream, (const bf16*)qkv, (const bf16*)dout, (const bf16*)out,
                     (const float*)lse, (const bf16*)rq, (const bf16*)rk, (const float*)iq,
                     (const float*)ik, (const bf16*)gq, (const bf16*)gk, (const bf16*)cos_t,
                     (const bf16*)sin_t, (bf16*)dqkv, (float*)dgq, (float*)dgk, L, H, scale);
}
