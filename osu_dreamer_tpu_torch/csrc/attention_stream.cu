// Streamed attention for Hopper at any head dim and any length: the flash
// attention forward (K7/K8) at head dims other than 32, 64 and 128, and the
// fused norm + RoPE attention forward (K9) and backward (K10) wherever the
// resident kernels of fused_attention.cu do not take the shape (a head dim
// other than 32, 64 and 128, or L > 256).
//
// Replaces, at those shapes, the Pallas TPU kernels of
// osu_dreamer_tpu/ops/long_attention.py (`_fwd_kernel` launched by
// `_fwd_impl`, `_blocked_kernel` by `_blocked_impl`) and of
// osu_dreamer_tpu/ops/fused_attention.py (`_fwd_kernel` launched by
// `_fwd_impl`, `_bwd_kernel` launched by `_vjp_bwd`). On the main path they
// are a denoiser of 8 x 96 heads: its training at L 320 (K9, K10), its
// sampler at L 759 (K7); and 8 x 64 heads trained at L 257..512.
//
// What bounds them on the H100: 4 L^2 D operations per (batch row, head)
// in the forward, 10 L^2 D in the backward, on the tensor cores, against
// a few L D rows of bf16: at L 320 and D 96 about 100 operations a byte,
// below the card's ~295, so bound by bytes at the training lengths and by
// operations past L ~ 1000. The JAX gate admits every head dim with L H D
// <= 262,144 (fused) and H D up to ~5,600 (long), so neither a head's rows
// nor its head dim may be held whole in shared memory: the design streams
// everything, and is simple before it is fast.
//
// The layout: every operand of the products is a (B, L, heads, Dp) bf16
// array with Dp = D rounded up to 8 (TMA's 16-byte stride rule), read in
// 64 x 64 boxes through a 4-D tensor map (Dp, heads, L, B) with 128-byte
// swizzle: columns past Dp and rows past L are zero-filled on the load, so
// a box never reads the next head or batch row and zero columns add
// nothing to Q K^T. K7 reads q, k and v as they are where D % 8 == 0 (the
// wrapper pads them otherwise). For K9/K10 a prep pass (one warp a row and
// head) normalises and rotates q and k in the plain version's rounding
// order and copies v into padded arrays, so the rotary pair (j, j + D/2)
// never has to meet inside a box at any D; the backward runs the same pass
// again, so its rq/rk are the forward's bit for bit, and the forward saves
// only lse.
//
// Common to the products: one CTA = one consumer warpgroup (64 query or key
// rows) and one producer warp whose one thread keeps a ring of kStStages
// stages of two boxes in flight by TMA (full / empty mbarriers, one
// arrival a consumer warp); every product is one m64n64 wgmma chain per
// stage, A and B K-major (Q K^T over the D boxes of a pair of tiles) or A
// from registers and B MN-major (P V, P^T dO, dS^T Q, dS K). A CTA owns
// NB output boxes (64 columns) of its rows and sweeps the other side's
// tiles: S over all ceil(Dp / 64) boxes, so at head dims past 64 NB one
// CTA forms S for its own output columns (the split over CTAs re-forms S).
// - forward (K7, K9's core): per key tile, the stages (Q box c, K box c)
//   for S, the online softmax in registers (f32 logits, running maxima,
//   probabilities ex2((s - m) scale log2 e) rounded to bf16 unnormalised),
//   then one stage of the CTA's V boxes for O += P V; one division by the
//   row sum at the end; lse = m scale + ln l for the backward; O stored
//   from registers, columns past D and rows past L skipped;
// - backward dK/dV (`attention_stream_bwd_kv_kernel`), one CTA per (key
//   tile, output box): per query tile the stages (K c, Q_j c) for S^T and
//   (V c, dO_j c) for dP^T, P^T = exp(S^T scale - lse_j), dS^T = P^T
//   (dP^T - delta_j) scale, each rounded to bf16 once, then one stage
//   (dO_j, Q_j) of the output box for dV += P^T dO_j and dK += dS^T Q_j;
// - backward dQ (`attention_stream_bwd_q_kernel`), one CTA per (query
//   tile, output box): per key tile S and dP again, dS, then dQ += dS K_t;
// - dQ, dK and dV leave as f32 (B, L, H, Dp) arrays; a post pass (one warp
//   a 32-row chunk and head) takes dQ and dK back through the inverse
//   rotation and the gamma-scaled RMS norm in f32 (1/rms recomputed by the
//   prep pass's code), rounds dV, writes dqkv, and one f32 gamma partial per
//   (chunk, head, column) that the wrapper sums in a fixed order: no float
//   atomics, a rerun is bit-identical. At L = 1 dS is exactly 0.
#include "common.cuh"
#include "hopper.cuh"

namespace odt {

using namespace hopper;

namespace {

constexpr int kStRows = 64;                               // rows of a box
constexpr uint32_t kStBox = kStRows * 64 * sizeof(bf16);  // 8 KB, one swizzled 64 x 64 box
constexpr int kStStages = 4;                              // ring stages
constexpr uint32_t kStStage = 2 * kStBox;                 // two boxes a stage
constexpr int kStThreads = 128 + 32;                      // consumer warpgroup + producer warp
// + 1024 so the base can be rounded up to the swizzle atom
constexpr size_t kStSmem =
    kStStages * (size_t)kStStage + 2 * kStStages * sizeof(uint64_t) + 1024;
constexpr int kStPrepWarps = 4;                           // warps a block of prep and post
constexpr int kStChunk = 32;                              // rows a warp of the post pass
constexpr float kStNeg = -1e30f;
constexpr float kStLog2e = 1.4426950408889634f;

// the ring of two-box stages and where its producer and consumers are
struct Ring {
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  int it;  // stages produced (producer) or consumed (consumers) so far
  __device__ __forceinline__ unsigned char* slot(int s, int i) const {
    return base + s * kStStage + i * kStBox;
  }
};

// the ring at the 1024-byte aligned base of the dynamic shared memory, its
// barriers initialised (every thread of the CTA calls this)
__device__ __forceinline__ Ring ring_init(unsigned char* raw) {
  Ring r;
  r.base = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                            ~uintptr_t(1023));
  r.full = reinterpret_cast<uint64_t*>(r.base + kStStages * kStStage);
  r.empty = r.full + kStStages;
  r.it = 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStStages; ++s) {
      mbar_init(&r.full[s], 1);
      mbar_init(&r.empty[s], 4);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  return r;
}

// producer: the next stage once its consumers released it, armed for
// `boxes` boxes (a zero-filled box counts its full bytes); -> its index
__device__ __forceinline__ int ring_produce(Ring& r, int boxes) {
  const int s = r.it % kStStages;
  if (r.it >= kStStages) mbar_wait(&r.empty[s], (r.it / kStStages - 1) & 1);
  mbar_arrive_expect_tx(&r.full[s], boxes * kStBox);
  ++r.it;
  return s;
}

// consumer: wait for the next stage -> its index
__device__ __forceinline__ int ring_wait(Ring& r) {
  const int s = r.it % kStStages;
  mbar_wait(&r.full[s], (r.it / kStStages) & 1);
  return s;
}

// consumer: release the stage ring_wait returned, its products complete
__device__ __forceinline__ void ring_release(Ring& r, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(&r.empty[r.it % kStStages]);
  ++r.it;
}

// box c (columns 64 c ..) of head h, rows row.., batch row b
__device__ __forceinline__ void load_box(Ring& r, int s, int i, const CUtensorMap* map, int c,
                                         int h, int row, int b) {
  tma_load_4d(r.slot(s, i), map, &r.full[s], 64 * c, h, row, b);
}

__device__ __forceinline__ uint32_t st_pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the MUFU unit alone (a denormal result flushes to 0, -inf gives 0)
__device__ __forceinline__ float st_ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float st_quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float st_quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// acc (+)= A B^T over one box each (64 rows x 64 columns, both K-major);
// `first` starts the sum
__device__ __forceinline__ void product_ss(float (&acc)[32], const void* a, const void* b,
                                           bool first) {
  const uint64_t ad = wgmma_desc(a, 16, 1024), bd = wgmma_desc(b, 16, 1024);
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n64k16_ss(acc, ad + 2 * kk, bd + 2 * kk, (first && kk == 0) ? 0 : 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

// acc += A B: A (64 x 64, bf16 pairs in the accumulator's layout) from
// registers, B one box read MN-major (its 64 rows are the reduced dimension)
__device__ __forceinline__ void product_rs(float (&acc)[32], uint32_t (&a)[16], const void* b) {
  const uint64_t bd = wgmma_desc(b, 1024, 1024);
  fence_regs(acc);
  fence_regs(a);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t ak[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3]};
    wgmma_m64n64k16_rs_bt(acc, ak, bd + 128 * kk, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(a);
}

// an accumulator's two rows (r, r + 8 of the box) into a (rows, H, width)
// f32 array at columns col0.., skipping rows past L and columns past width
__device__ __forceinline__ void store_f32(const float (&acc)[32], float* __restrict__ dst,
                                          int row, int L, int H, int h, int width, int col0,
                                          int lane) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (row + 8 * hr >= L) continue;
    float* p = dst + ((size_t)(row + 8 * hr) * H + h) * width;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + j * 8 + (lane % 4) * 2;
      if (col < width)
        *reinterpret_cast<float2*>(p + col) =
            make_float2(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
    }
  }
}

// 1/rms of one raw row of D bf16 values, read by a warp (lanes stride the
// columns, the same order in every pass that calls it)
__device__ __forceinline__ float row_inv(const bf16* __restrict__ x, int D, int lane) {
  float ss = 0.f;
  for (int j = lane; j < D; j += 32) {
    const float v = ldf(x + j);
    ss += v * v;
  }
  ss = warp_sum(ss);
  return 1.f / sqrtf(ss / D + 1e-6f);
}

// raw row x -> its normalised and rotated row y (Dp columns, zero past D)
// in the plain version's rounding order: bf16(x / rms), bf16(* gamma), then
// bf16 rotary products and their bf16 sums; lane-strided over the pairs
// (j, j + D/2)
__device__ __forceinline__ void norm_rope_row(const bf16* __restrict__ x, float inv,
                                              const bf16* __restrict__ gamma,
                                              const bf16* __restrict__ cos_r,
                                              const bf16* __restrict__ sin_r, bf16* __restrict__ y,
                                              int D, int Dp, int lane) {
  const int half = D / 2;
  for (int j = lane; j < half; j += 32) {
    const float n1 = bfr(bfr(ldf(x + j) * inv) * ldf(gamma + j));
    const float n2 = bfr(bfr(ldf(x + j + half) * inv) * ldf(gamma + j + half));
    const float c = ldf(cos_r + j), s = ldf(sin_r + j);
    y[j] = __float2bfloat16(bfr(n1 * c) - bfr(n2 * s));
    y[j + half] = __float2bfloat16(bfr(n1 * s) + bfr(n2 * c));
  }
  for (int j = D + lane; j < Dp; j += 32) y[j] = __float2bfloat16(0.f);
}

// a row of D values into Dp columns, zero past D
__device__ __forceinline__ void copy_row(const bf16* __restrict__ x, bf16* __restrict__ y, int D,
                                         int Dp, int lane) {
  for (int j = lane; j < Dp; j += 32) y[j] = __float2bfloat16(j < D ? ldf(x + j) : 0.f);
}

}  // namespace

// ------------------------------------------------------------------ forward --

// O (and lse) of query tile blockIdx.x / ncs, output boxes NB (blockIdx.x %
// ncs) .. of it; lse (may be null) written by the first box's CTA
template <int NB>
__global__ void __launch_bounds__(kStThreads, 2)
attention_stream_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ out,
                            float* __restrict__ lse, int L, int H, int D, int nbox, int ncs,
                            float scale) {
  extern __shared__ unsigned char smem_raw[];
  Ring ring = ring_init(smem_raw);
  const int qt = blockIdx.x / ncs, cs = blockIdx.x % ncs, h = blockIdx.y, b = blockIdx.z;
  const int c0 = cs * NB, nb = min(NB, nbox - c0);
  const int ntiles = (L + kStRows - 1) / kStRows;

  if (threadIdx.x >= 128) {
    if (threadIdx.x == 128) {
      for (int t = 0; t < ntiles; ++t) {
        for (int c = 0; c < nbox; ++c) {
          const int s = ring_produce(ring, 2);
          load_box(ring, s, 0, &tm_q, c, h, qt * kStRows, b);
          load_box(ring, s, 1, &tm_k, c, h, t * kStRows, b);
        }
        const int s = ring_produce(ring, nb);
        for (int c = 0; c < nb; ++c) load_box(ring, s, c, &tm_v, c0 + c, h, t * kStRows, b);
      }
    }
    return;
  }

  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * 16 + lane / 4;  // this thread's rows r0, r0 + 8
  const float c2 = scale * kStLog2e;                   // logits to log2 units
  float o[NB][32], sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m0 = kStNeg, m1 = kStNeg, l0 = 0.f, l1 = 0.f;  // running maxima, this thread's sums

  for (int t = 0; t < ntiles; ++t) {
    for (int c = 0; c < nbox; ++c) {
      const int s = ring_wait(ring);
      product_ss(sc, ring.slot(s, 0), ring.slot(s, 1), c == 0);
      ring_release(ring, lane);
    }
    if (t == ntiles - 1 && L % kStRows) {
      const int lim = L - t * kStRows;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if ((i / 4) * 8 + (lane % 4) * 2 + (i % 2) >= lim) sc[i] = kStNeg;
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    mx0 = st_quad_max(mx0);
    mx1 = st_quad_max(mx1);
    const float a0 = st_ex2((m0 - mx0) * c2), a1 = st_ex2((m1 - mx1) * c2);
    m0 = mx0;
    m1 = mx1;
    const float b0 = -m0 * c2, b1 = -m1 * c2;
    float s0 = 0.f, s1 = 0.f;
    uint32_t p[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = st_ex2(fmaf(sc[4 * j], c2, b0)), p1 = st_ex2(fmaf(sc[4 * j + 1], c2, b0));
      const float p2 = st_ex2(fmaf(sc[4 * j + 2], c2, b1));
      const float p3 = st_ex2(fmaf(sc[4 * j + 3], c2, b1));
      s0 += p0 + p1;
      s1 += p2 + p3;
      p[2 * j] = st_pack(p0, p1);
      p[2 * j + 1] = st_pack(p2, p3);
    }
    l0 = l0 * a0 + s0;
    l1 = l1 * a1 + s1;
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[c][4 * j] *= a0;
        o[c][4 * j + 1] *= a0;
        o[c][4 * j + 2] *= a1;
        o[c][4 * j + 3] *= a1;
      }
    const int s = ring_wait(ring);
#pragma unroll
    for (int c = 0; c < NB; ++c)
      if (c < nb) product_rs(o[c], p, ring.slot(s, c));
    ring_release(ring, lane);
  }

  // epilogue: O / l in bf16 straight to global memory
  l0 = st_quad_sum(l0);
  l1 = st_quad_sum(l1);
  const float inv[2] = {1.f / l0, 1.f / l1};
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int q = qt * kStRows + r0 + 8 * hr;
    if (q >= L) continue;
    bf16* row = out + ((size_t)((size_t)b * L + q) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      if (c >= nb) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = (c0 + c) * 64 + j * 8 + (lane % 4) * 2;
        if (col < D) row[col] = __float2bfloat16(o[c][4 * j + 2 * hr] * inv[hr]);
        if (col + 1 < D) row[col + 1] = __float2bfloat16(o[c][4 * j + 2 * hr + 1] * inv[hr]);
      }
    }
  }
  if (lse != nullptr && cs == 0 && lane % 4 == 0) {
    float* lrow = lse + ((size_t)b * H + h) * L;
    const int q = qt * kStRows + r0;
    if (q < L) lrow[q] = m0 * scale + logf(l0);
    if (q + 8 < L) lrow[q + 8] = m1 * scale + logf(l1);
  }
}

// ----------------------------------------------------------------- backward --

// dK and dV (f32, the gradients of the rotated k and of v) of key tile
// blockIdx.x / nbox, output box blockIdx.x % nbox
__global__ void __launch_bounds__(kStThreads, 2)
attention_stream_bwd_kv_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_do,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               float* __restrict__ dk, float* __restrict__ dv, int L, int H,
                               int Dp, int nbox, float scale) {
  extern __shared__ unsigned char smem_raw[];
  Ring ring = ring_init(smem_raw);
  const int kt = blockIdx.x / nbox, c0 = blockIdx.x % nbox, h = blockIdx.y, b = blockIdx.z;
  const int ntiles = (L + kStRows - 1) / kStRows;

  if (threadIdx.x >= 128) {
    if (threadIdx.x == 128) {
      for (int j = 0; j < ntiles; ++j) {
        for (int c = 0; c < nbox; ++c) {
          const int s = ring_produce(ring, 2);
          load_box(ring, s, 0, &tm_k, c, h, kt * kStRows, b);
          load_box(ring, s, 1, &tm_q, c, h, j * kStRows, b);
        }
        for (int c = 0; c < nbox; ++c) {
          const int s = ring_produce(ring, 2);
          load_box(ring, s, 0, &tm_v, c, h, kt * kStRows, b);
          load_box(ring, s, 1, &tm_do, c, h, j * kStRows, b);
        }
        const int s = ring_produce(ring, 2);
        load_box(ring, s, 0, &tm_do, c0, h, j * kStRows, b);
        load_box(ring, s, 1, &tm_q, c0, h, j * kStRows, b);
      }
    }
    return;
  }

  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * 16 + lane / 4;  // this thread's keys r0, r0 + 8 of the tile
  const float c2 = scale * kStLog2e;
  // a softmax over one key is constant: its logits' gradient is exactly 0
  const float ds_scale = L > 1 ? scale : 0.f;
  const bool key0 = kt * kStRows + r0 < L, key1 = kt * kStRows + r0 + 8 < L;
  const float* lse_r = lse + ((size_t)b * H + h) * L;
  const float* delta_r = delta + ((size_t)b * H + h) * L;
  float st[32], dpt[32], dka[32], dva[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) st[i] = dpt[i] = dka[i] = dva[i] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    for (int c = 0; c < nbox; ++c) {
      const int s = ring_wait(ring);
      product_ss(st, ring.slot(s, 0), ring.slot(s, 1), c == 0);  // S^T = K Q_j^T
      ring_release(ring, lane);
    }
    for (int c = 0; c < nbox; ++c) {
      const int s = ring_wait(ring);
      product_ss(dpt, ring.slot(s, 0), ring.slot(s, 1), c == 0);  // dP^T = V dO_j^T
      ring_release(ring, lane);
    }
    // P^T = exp(S^T scale - lse) (0 for keys past L; queries past L have
    // lse = +inf), dS^T = P^T (dP^T - delta) scale
    uint32_t pa[16], da[16];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int q = j * kStRows + jj * 8 + (lane % 4) * 2;
      const float la = q < L ? lse_r[q] * kStLog2e : INFINITY;
      const float lb = q + 1 < L ? lse_r[q + 1] * kStLog2e : INFINITY;
      const float d0 = q < L ? delta_r[q] : 0.f, d1 = q + 1 < L ? delta_r[q + 1] : 0.f;
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool key = e < 2 ? key0 : key1;
        p[e] = key ? st_ex2(fmaf(st[4 * jj + e], c2, -(e % 2 ? lb : la))) : 0.f;
        ds[e] = p[e] * (dpt[4 * jj + e] - (e % 2 ? d1 : d0)) * ds_scale;
      }
      pa[2 * jj] = st_pack(p[0], p[1]);
      pa[2 * jj + 1] = st_pack(p[2], p[3]);
      da[2 * jj] = st_pack(ds[0], ds[1]);
      da[2 * jj + 1] = st_pack(ds[2], ds[3]);
    }
    const int s = ring_wait(ring);
    product_rs(dva, pa, ring.slot(s, 0));  // dV += P^T dO_j
    product_rs(dka, da, ring.slot(s, 1));  // dK += dS^T Q_j
    ring_release(ring, lane);
  }
  const int row = b * L + kt * kStRows + r0;
  const int rows = b * L + L;  // this batch row's end in the flattened rows
  store_f32(dva, dv, row, rows, H, h, Dp, c0 * 64, lane);
  store_f32(dka, dk, row, rows, H, h, Dp, c0 * 64, lane);
}

// dQ (f32, the gradient of the rotated q) of query tile blockIdx.x / nbox,
// output box blockIdx.x % nbox
__global__ void __launch_bounds__(kStThreads, 2)
attention_stream_bwd_q_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              float* __restrict__ dq, int L, int H, int Dp, int nbox,
                              float scale) {
  extern __shared__ unsigned char smem_raw[];
  Ring ring = ring_init(smem_raw);
  const int qt = blockIdx.x / nbox, c0 = blockIdx.x % nbox, h = blockIdx.y, b = blockIdx.z;
  const int ntiles = (L + kStRows - 1) / kStRows;

  if (threadIdx.x >= 128) {
    if (threadIdx.x == 128) {
      for (int t = 0; t < ntiles; ++t) {
        for (int c = 0; c < nbox; ++c) {
          const int s = ring_produce(ring, 2);
          load_box(ring, s, 0, &tm_q, c, h, qt * kStRows, b);
          load_box(ring, s, 1, &tm_k, c, h, t * kStRows, b);
        }
        for (int c = 0; c < nbox; ++c) {
          const int s = ring_produce(ring, 2);
          load_box(ring, s, 0, &tm_do, c, h, qt * kStRows, b);
          load_box(ring, s, 1, &tm_v, c, h, t * kStRows, b);
        }
        const int s = ring_produce(ring, 1);
        load_box(ring, s, 0, &tm_k, c0, h, t * kStRows, b);
      }
    }
    return;
  }

  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * 16 + lane / 4;  // this thread's queries r0, r0 + 8
  const float c2 = scale * kStLog2e;
  const float ds_scale = L > 1 ? scale : 0.f;
  const int qa = qt * kStRows + r0, qb = qa + 8;
  const float* lse_r = lse + ((size_t)b * H + h) * L;
  const float* delta_r = delta + ((size_t)b * H + h) * L;
  const float la = qa < L ? lse_r[qa] * kStLog2e : INFINITY;
  const float lb = qb < L ? lse_r[qb] * kStLog2e : INFINITY;
  const float d0 = qa < L ? delta_r[qa] : 0.f, d1 = qb < L ? delta_r[qb] : 0.f;
  float sa[32], dpa[32], dqa[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sa[i] = dpa[i] = dqa[i] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    for (int c = 0; c < nbox; ++c) {
      const int s = ring_wait(ring);
      product_ss(sa, ring.slot(s, 0), ring.slot(s, 1), c == 0);  // S = Q K_t^T
      ring_release(ring, lane);
    }
    for (int c = 0; c < nbox; ++c) {
      const int s = ring_wait(ring);
      product_ss(dpa, ring.slot(s, 0), ring.slot(s, 1), c == 0);  // dP = dO V_t^T
      ring_release(ring, lane);
    }
    // P = exp(S scale - lse) (0 for keys past L), dS = P (dP - delta) scale
    uint32_t dsa[16];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int key = t * kStRows + jj * 8 + (lane % 4) * 2;
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = key + (e % 2) < L;
        const float p = ok ? st_ex2(fmaf(sa[4 * jj + e], c2, -(e < 2 ? la : lb))) : 0.f;
        ds[e] = p * (dpa[4 * jj + e] - (e < 2 ? d0 : d1)) * ds_scale;
      }
      dsa[2 * jj] = st_pack(ds[0], ds[1]);
      dsa[2 * jj + 1] = st_pack(ds[2], ds[3]);
    }
    const int s = ring_wait(ring);
    product_rs(dqa, dsa, ring.slot(s, 0));  // dQ += dS K_t
    ring_release(ring, lane);
  }
  store_f32(dqa, dq, b * L + qa, b * L + L, H, h, Dp, c0 * 64, lane);
}

// -------------------------------------------------------- prep and post --

// One warp a (row, head) of the (B L) rows: q and k normalised and rotated,
// v copied, into the padded (B L, H, Dp) arrays rq, rk, rv; with dout (the
// backward): delta = rowsum(dO O) into (B, H, L) and, where rdo is given,
// dO copied padded
__global__ void __launch_bounds__(kStPrepWarps * 32)
attention_prep_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ gq,
                      const bf16* __restrict__ gk, const bf16* __restrict__ cos_t,
                      const bf16* __restrict__ sin_t, bf16* __restrict__ rq,
                      bf16* __restrict__ rk, bf16* __restrict__ rv,
                      const bf16* __restrict__ dout, const bf16* __restrict__ o,
                      bf16* __restrict__ rdo, float* __restrict__ delta, int BL, int L, int H,
                      int D, int Dp) {
  const int lane = threadIdx.x % 32;
  const size_t w = (size_t)blockIdx.x * kStPrepWarps + threadIdx.x / 32;
  if (w >= (size_t)BL * H) return;
  const int row = (int)(w / H), h = (int)(w % H), pos = row % L, half = D / 2;
  const size_t HD = (size_t)H * D, dst = ((size_t)row * H + h) * Dp;
  const bf16* x = qkv + (size_t)row * 3 * HD + (size_t)h * D;
  const bf16* cr = cos_t + (size_t)pos * half;
  const bf16* sr = sin_t + (size_t)pos * half;
  norm_rope_row(x, row_inv(x, D, lane), gq, cr, sr, rq + dst, D, Dp, lane);
  norm_rope_row(x + HD, row_inv(x + HD, D, lane), gk, cr, sr, rk + dst, D, Dp, lane);
  copy_row(x + 2 * HD, rv + dst, D, Dp, lane);
  if (dout != nullptr) {
    const bf16* g = dout + (size_t)row * HD + (size_t)h * D;
    const bf16* oo = o + (size_t)row * HD + (size_t)h * D;
    float d = 0.f;
    for (int j = lane; j < D; j += 32) d += ldf(g + j) * ldf(oo + j);
    d = warp_sum(d);
    if (lane == 0) delta[((size_t)(row / L) * H + h) * L + pos] = d;
    if (rdo != nullptr) copy_row(g, rdo + dst, D, Dp, lane);
  }
}

// One warp a (chunk of kStChunk rows, head): the f32 gradients dq and dk of
// the rotated rows back through the inverse rotation and the gamma-scaled
// RMS norm into dqkv (bf16), dv rounded into it; the gamma gradients of the
// chunk's rows as one f32 partial a column at (chunk, h) of dgq and dgk
__global__ void __launch_bounds__(kStPrepWarps * 32)
attention_post_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ gq,
                      const bf16* __restrict__ gk, const bf16* __restrict__ cos_t,
                      const bf16* __restrict__ sin_t, const float* __restrict__ dq,
                      const float* __restrict__ dk, const float* __restrict__ dv,
                      bf16* __restrict__ dqkv, float* __restrict__ dgq, float* __restrict__ dgk,
                      int BL, int L, int H, int D, int Dp) {
  const int lane = threadIdx.x % 32;
  const int nchunks = (BL + kStChunk - 1) / kStChunk;
  const size_t w = (size_t)blockIdx.x * kStPrepWarps + threadIdx.x / 32;
  if (w >= (size_t)nchunks * H) return;
  const int chunk = (int)(w / H), h = (int)(w % H), half = D / 2;
  const int row0 = chunk * kStChunk, nr = min(kStChunk, BL - row0);
  const size_t HD = (size_t)H * D;

  // pass 1: each row's 1/rms and sum over the row of gh x (gh the gradient
  // of the gamma-scaled normalised row), for q (t 0) and k (t 1); lane r
  // keeps row r's
  float inv[2] = {0.f, 0.f}, msum[2] = {0.f, 0.f};
  for (int r = 0; r < nr; ++r) {
    const int row = row0 + r, pos = row % L;
    const bf16* cr = cos_t + (size_t)pos * half;
    const bf16* sr = sin_t + (size_t)pos * half;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const bf16* x = qkv + (size_t)row * 3 * HD + t * HD + (size_t)h * D;
      const float* d = (t ? dk : dq) + ((size_t)row * H + h) * Dp;
      const bf16* g = t ? gk : gq;
      const float iv = row_inv(x, D, lane);
      float m = 0.f;
      for (int j = lane; j < half; j += 32) {
        const float c = ldf(cr + j), s = ldf(sr + j), d1 = d[j], d2 = d[j + half];
        m += (d1 * c + d2 * s) * ldf(g + j) * ldf(x + j) +
             (d2 * c - d1 * s) * ldf(g + j + half) * ldf(x + j + half);
      }
      m = warp_sum(m);
      if (lane == r) {
        inv[t] = iv;
        msum[t] = m;
      }
    }
  }

  // pass 2: lane-strided over the rotary pairs, the chunk's rows in order
  for (int j0 = 0; j0 < half; j0 += 32) {
    const int j = j0 + lane;
    const bool on = j < half;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const bf16* g = t ? gk : gq;
      const float g1 = on ? ldf(g + j) : 0.f, g2 = on ? ldf(g + j + half) : 0.f;
      float dg1 = 0.f, dg2 = 0.f;
      for (int r = 0; r < nr; ++r) {
        const float iv = __shfl_sync(0xffffffffu, inv[t], r);
        const float m = __shfl_sync(0xffffffffu, msum[t], r);
        if (!on) continue;
        const int row = row0 + r, pos = row % L;
        const bf16* x = qkv + (size_t)row * 3 * HD + t * HD + (size_t)h * D;
        const float* d = (t ? dk : dq) + ((size_t)row * H + h) * Dp;
        const float c = ldf(cos_t + (size_t)pos * half + j);
        const float s = ldf(sin_t + (size_t)pos * half + j);
        const float d1 = d[j], d2 = d[j + half], x1 = ldf(x + j), x2 = ldf(x + j + half);
        const float gn1 = d1 * c + d2 * s, gn2 = d2 * c - d1 * s;
        dg1 += gn1 * x1 * iv;
        dg2 += gn2 * x2 * iv;
        const float i3m = iv * iv * iv * (m / D);
        bf16* y = dqkv + (size_t)row * 3 * HD + t * HD + (size_t)h * D;
        y[j] = __float2bfloat16(gn1 * g1 * iv - x1 * i3m);
        y[j + half] = __float2bfloat16(gn2 * g2 * iv - x2 * i3m);
      }
      if (on) {
        float* part = (t ? dgk : dgq) + ((size_t)chunk * H + h) * D;
        part[j] = dg1;
        part[j + half] = dg2;
      }
    }
  }
  for (int r = 0; r < nr; ++r) {
    const int row = row0 + r;
    const float* d = dv + ((size_t)row * H + h) * Dp;
    bf16* y = dqkv + (size_t)row * 3 * HD + 2 * HD + (size_t)h * D;
    for (int j = lane; j < D; j += 32) y[j] = __float2bfloat16(d[j]);
  }
}

// ------------------------------------------------------------------- host --

namespace {

// the 4-D tensor map of a (B, L, H, Dp) bf16 array in 64 x 64 boxes
cudaError_t stream_map(CUtensorMap* map, const void* base, int Dp, int H, int L, int B) {
  return tma_map_bf16_heads(map, base, Dp, H, L, B, kStRows);
}

template <int NB>
int stream_fwd_launch(const CUtensorMap* maps, void* out, void* lse, int B, int L, int H, int D,
                      int nbox, float scale, cudaStream_t stream) {
  const int ncs = (nbox + NB - 1) / NB, ntiles = (L + kStRows - 1) / kStRows;
  return (int)launch(attention_stream_fwd_kernel<NB>, dim3(ntiles * ncs, H, B),
                     dim3(kStThreads), kStSmem, stream, maps[0], maps[1], maps[2], (bf16*)out,
                     (float*)lse, L, H, D, nbox, ncs, scale);
}

// the forward over padded (B, L, H, Dp) q, k, v: one output box a CTA at
// one box a head, else two
int stream_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int B, int L,
               int H, int D, int Dp, float scale, cudaStream_t stream) {
  if (B < 1 || L < 1 || H < 1 || D < 1 || Dp < D || Dp % 8) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[3];
  const void* bases[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err = stream_map(&maps[i], bases[i], Dp, H, L, B);
    if (err != cudaSuccess) return (int)err;
  }
  const int nbox = (Dp + 63) / 64;
  if (nbox == 1) return stream_fwd_launch<1>(maps, out, lse, B, L, H, D, nbox, scale, stream);
  return stream_fwd_launch<2>(maps, out, lse, B, L, H, D, nbox, scale, stream);
}

int prep_launch(const void* qkv, const void* gq, const void* gk, const void* cos_t,
                const void* sin_t, void* rq, void* rk, void* rv, const void* dout,
                const void* o, void* rdo, void* delta, int B, int L, int H, int D, int Dp,
                cudaStream_t stream) {
  const size_t warps = (size_t)B * L * H;
  return (int)launch(attention_prep_kernel,
                     dim3((unsigned)((warps + kStPrepWarps - 1) / kStPrepWarps)),
                     dim3(kStPrepWarps * 32), 0, stream, (const bf16*)qkv, (const bf16*)gq,
                     (const bf16*)gk, (const bf16*)cos_t, (const bf16*)sin_t, (bf16*)rq,
                     (bf16*)rk, (bf16*)rv, (const bf16*)dout, (const bf16*)o, (bf16*)rdo,
                     (float*)delta, B * L, L, H, D, Dp);
}

}  // namespace

}  // namespace odt

// K7/K8 at a head dim without its own instantiation: q, k, v (B, L, H, Dp)
// bf16 (Dp = D rounded up to 8, zero past D), out (B, L, H D); lse may be null
extern "C" int odt_attention_stream_fwd(const void* q, const void* k, const void* v, void* out,
                                        void* lse, int B, int L, int H, int D, int Dp,
                                        float scale, void* stream) {
  return odt::stream_fwd(q, k, v, out, lse, B, L, H, D, Dp, scale, (cudaStream_t)stream);
}

// K9 streamed: the prep pass into rq, rk, rv (B, L, H, Dp) bf16 scratch,
// then the forward; lse may be null (no gradient will be taken)
extern "C" int odt_fused_attention_stream_fwd(const void* qkv, const void* gq, const void* gk,
                                              const void* cos_t, const void* sin_t, void* rq,
                                              void* rk, void* rv, void* out, void* lse, int B,
                                              int L, int H, int D, int Dp, float scale,
                                              void* stream) {
  using namespace odt;
  if (D % 2 || Dp < D || Dp % 8) return (int)cudaErrorInvalidValue;
  const int err = prep_launch(qkv, gq, gk, cos_t, sin_t, rq, rk, rv, nullptr, nullptr, nullptr,
                              nullptr, B, L, H, D, Dp, (cudaStream_t)stream);
  if (err != 0) return err;
  return stream_fwd(rq, rk, rv, out, lse, B, L, H, D, Dp, scale, (cudaStream_t)stream);
}

// K10 streamed: the prep pass (rq, rk, rv, delta (B, H, L) f32, and dO
// padded into rdo unless rdo is null, which needs Dp == D), the dK/dV and
// dQ launches into dq, dk, dv (B, L, H, Dp) f32 scratch, and the post pass
// into dqkv and the gamma partials dgq, dgk (ceil(B L / 32) H, D) f32
extern "C" int odt_fused_attention_stream_bwd(
    const void* qkv, const void* dout, const void* out, const void* lse, const void* gq,
    const void* gk, const void* cos_t, const void* sin_t, void* rq, void* rk, void* rv, void* rdo,
    void* delta, void* dq, void* dk, void* dv, void* dqkv, void* dgq, void* dgk, int B, int L,
    int H, int D, int Dp, float scale, void* stream) {
  using namespace odt;
  const cudaStream_t st = (cudaStream_t)stream;
  if (B < 1 || L < 1 || H < 1 || D < 2 || D % 2 || Dp < D || Dp % 8 ||
      (rdo == nullptr && Dp != D))
    return (int)cudaErrorInvalidValue;
  int err = prep_launch(qkv, gq, gk, cos_t, sin_t, rq, rk, rv, dout, out, rdo, delta, B, L, H, D,
                        Dp, st);
  if (err != 0) return err;
  CUtensorMap maps[4];
  const void* bases[4] = {rq, rk, rv, rdo != nullptr ? rdo : dout};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t e = stream_map(&maps[i], bases[i], Dp, H, L, B);
    if (e != cudaSuccess) return (int)e;
  }
  const int nbox = (Dp + 63) / 64, ntiles = (L + kStRows - 1) / kStRows;
  const dim3 grid(ntiles * nbox, H, B);
  err = (int)launch(attention_stream_bwd_kv_kernel, grid, dim3(kStThreads), kStSmem, st, maps[0],
                    maps[1], maps[2], maps[3], (const float*)lse, (const float*)delta, (float*)dk,
                    (float*)dv, L, H, Dp, nbox, scale);
  if (err != 0) return err;
  err = (int)launch(attention_stream_bwd_q_kernel, grid, dim3(kStThreads), kStSmem, st, maps[0],
                    maps[1], maps[2], maps[3], (const float*)lse, (const float*)delta, (float*)dq,
                    L, H, Dp, nbox, scale);
  if (err != 0) return err;
  const size_t warps = (size_t)((B * L + kStChunk - 1) / kStChunk) * H;
  return (int)launch(attention_post_kernel,
                     dim3((unsigned)((warps + kStPrepWarps - 1) / kStPrepWarps)),
                     dim3(kStPrepWarps * 32), 0, st, (const bf16*)qkv, (const bf16*)gq,
                     (const bf16*)gk, (const bf16*)cos_t, (const bf16*)sin_t, (const float*)dq,
                     (const float*)dk, (const float*)dv, (bf16*)dqkv, (float*)dgq, (float*)dgk,
                     B * L, L, H, D, Dp);
}
