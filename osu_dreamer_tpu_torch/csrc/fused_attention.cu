// Fused per-head RMS norm + RoPE + softmax attention for Hopper, forward (K9)
// and backward (K10), straight off the packed qkv projection.
//
// Replaces the Pallas TPU kernels of osu_dreamer_tpu/ops/fused_attention.py:
// `_fwd_kernel` (launched by `_fwd_impl`) and `_bwd_kernel` (launched by
// `_vjp_bwd`). On the main path they are the denoiser's attention in training:
// qkv bf16 (128, 152, 3 x 16 x 64), gammas (64,), 8 layers per step; K9 also
// answers inference at latent lengths <= 256.
//
// What bounds them on the H100: per (batch row, head) a few L x 64 rows come
// in and go out, and the products over them are 2 L^2 64 multiply-adds each
// (2 in the forward, 5 in the backward): at L = 152 about 50 operations a
// byte against the card's ~295, so both are bound by bytes. The design
// therefore reads each of a head's rows once, keeps everything of size L x L
// on the chip and runs the products on wgmma so that they hide under the
// loads of the other CTAs.
//
// Residual contract: the forward saves only the f32 log-sum-exp of each
// query row (and only when a gradient will be taken). The backward reads the
// raw q/k rows anyway for the norm's backward, so it normalises and rotates
// them again with the forward's own code (`norm_rope_tiles`): its rq/rk are
// bit-identical to the forward's, and no rq/rk/1/rms residual is written or
// read. On the TPU the residuals skipped a recompute made of permutation
// matmuls; here that recompute is elementwise.
//
// Common to both (hopper.cuh holds the primitives):
// - one CTA per (head, batch row), one consumer warpgroup per 64-row tile
//   (the forward) or per 64-key tile (the backward); the head's rows come
//   in by TMA from 3-D tensor maps over the packed (B, L, 3 H 64) tensors
//   with 128-byte swizzle: rows past L are zero-filled inside batch row b,
//   never read from b + 1, and the output stores clip at L;
// - the q/k rows are normalised and rotated in place in the swizzled tiles,
//   each row once a CTA (four threads a row; the rotary pair (j, j + 32)
//   sits in chunks c and c + 4 of one row under any swizzle), then fenced to
//   the async proxy: f32 1/rms, bf16(x / rms), bf16(* gamma), bf16 rotary
//   products and sums, the plain version's rounding order;
// - results leave as bf16 tiles written in the swizzle into a spent input
//   tile and stored by TMA.
//
// K9 (forward), NT = ceil(L / 64) warpgroups, warpgroup w owns query tile w:
// - a first sweep of S = Q_w K_t^T tiles (m64n64) gives each row's maximum
//   and sum (so its log-sum-exp); a second sweep forms
//   P = exp(s - m) / l, normalised before its single bf16 rounding as the
//   plain softmax rounds it, 32 keys at a time (m64n32, to keep the
//   registers of two CTAs an SM at L <= 192) and O += P V with P from
//   registers and V read MN-major (the transpose bit);
// - O leaves through the warpgroup's spent Q tile; lse from registers.
//
// K10 (backward), NT tiles, NW = NT consumer warpgroups (2 at NT = 4, in two
// passes of two key tiles), warpgroup w owns key tile kt:
// - for each query tile j: S^T = K_kt Q_j^T and dP^T = V_kt dO_j^T on wgmma,
//   P^T = exp(S^T scale - lse_j), dS^T = P^T (dP^T - delta_j) scale, with
//   delta = rowsum(dO O) formed once a CTA (O comes in by TMA into the dS^T
//   tiles, before phase A writes them; at L = 1 dS is exactly 0, the
//   gradient of a softmax over one key); P and dS rounded to bf16 once,
//   dV += P^T dO_j and dK += dS^T Q_j with P^T and dS^T from registers as
//   the A operand (dO_j, Q_j MN-major);
// - each dS^T tile is written bf16 into shared memory in the 128-byte
//   swizzle (then fenced to the async proxy); after a CTA barrier
//   dQ_j = sum_w (dS^T_wj)^T K_w is one wgmma chain over those tiles, both
//   operands MN-major. No phase recomputes S or dP. At L 193..256 the
//   whole dS does not fit beside Q, K, V and dO, so the key tiles run in
//   two passes of two and dQ accumulates in registers across them;
// - epilogues: dV straight to bf16; dK and dQ through the inverse rotation
//   and the gamma-scaled RMS-norm backward in f32, the raw rows re-read
//   from global memory (L2), a row's reduction over the four threads of a
//   quad; the gamma gradients as one f32 partial per (batch, head), summed
//   per warp and then over the warps in a fixed order: no float atomics, a
//   rerun is bit-identical.
#include "common.cuh"
#include "hopper.cuh"

namespace odt {

using namespace hopper;

namespace {

constexpr int kAtD = 64;                                   // head dim
constexpr int kAtRows = 64;                                // rows of a tile
constexpr uint32_t kAtTile = kAtRows * kAtD * sizeof(bf16);  // 8 KB, one swizzled tile
constexpr int kAtMaxTiles = 4;                             // L <= 256
constexpr float kAtNeg = -1e30f;
constexpr float kAtLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t at_pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 at_unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// two neighbouring bf16 values from global memory
__device__ __forceinline__ float2 at_ld2(const bf16* p) {
  return at_unpack(__ldg(reinterpret_cast<const unsigned int*>(p)));
}

// 2^x on the MUFU unit alone (a denormal result flushes to 0, -inf gives 0)
__device__ __forceinline__ float at_ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float at_quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float at_quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// a barrier over the 128 threads of warpgroup wg (ids 1..4)
__device__ __forceinline__ void at_wg_barrier(int wg) {
  switch (wg) {
    case 0: named_barrier<1, 128>(); break;
    case 1: named_barrier<2, 128>(); break;
    case 2: named_barrier<3, 128>(); break;
    default: named_barrier<4, 128>(); break;
  }
}

// Normalise and rotate in place the 64 ntiles rows of `tiles` (ntiles
// consecutive swizzled 64-row tiles: row p of the head is row p % 64 of tile
// p / 64) in the plain version's rounding order: f32 1/rms over the row,
// bf16(x / rms), bf16(* gamma), then bf16 rotary products and sums. Four
// neighbouring threads share a row: thread u holds chunks u and u + 4, i.e.
// the rotary pairs (8u + e, 8u + 32 + e). Rows past L are zero (TMA fill)
// and stay so. The forward and the backward both call this, so the
// backward's rotated rows are bit-identical to the forward's. inv_out (may
// be null) receives each valid row's 1/rms.
__device__ __forceinline__ void norm_rope_tiles(unsigned char* tiles, int ntiles, int L,
                                                const bf16* __restrict__ gamma,
                                                const bf16* __restrict__ cos_t,
                                                const bf16* __restrict__ sin_t, float* inv_out) {
  const int nthreads = blockDim.x, work = ntiles * kAtRows * 4;
  for (int base = 0; base < work; base += nthreads) {
    const int idx = base + threadIdx.x;
    const int row = idx >> 2, u = idx & 3;
    const bool ok = idx < work && row < L;
    unsigned char* tile = tiles + (row / kAtRows) * kAtTile;
    const int r = row % kAtRows;
    uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
    if (ok) {
      lo = *reinterpret_cast<const uint4*>(tile + swizzle128(r, 8 * u));
      hi = *reinterpret_cast<const uint4*>(tile + swizzle128(r, 8 * u + 32));
    }
    const uint32_t lw[4] = {lo.x, lo.y, lo.z, lo.w}, hw[4] = {hi.x, hi.y, hi.z, hi.w};
    float x1[8], x2[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = at_unpack(lw[i]), b = at_unpack(hw[i]);
      x1[2 * i] = a.x;
      x1[2 * i + 1] = a.y;
      x2[2 * i] = b.x;
      x2[2 * i + 1] = b.y;
    }
    float ss = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) ss += x1[e] * x1[e] + x2[e] * x2[e];
    ss = at_quad_sum(ss);
    if (!ok) continue;
    const float inv = 1.f / sqrtf(ss / kAtD + 1e-6f);
    const uint4 gl = __ldg(reinterpret_cast<const uint4*>(gamma + 8 * u));
    const uint4 gh = __ldg(reinterpret_cast<const uint4*>(gamma + 8 * u + 32));
    const uint4 cv = __ldg(reinterpret_cast<const uint4*>(cos_t + row * (kAtD / 2) + 8 * u));
    const uint4 sv = __ldg(reinterpret_cast<const uint4*>(sin_t + row * (kAtD / 2) + 8 * u));
    const uint32_t g1w[4] = {gl.x, gl.y, gl.z, gl.w}, g2w[4] = {gh.x, gh.y, gh.z, gh.w};
    const uint32_t cw[4] = {cv.x, cv.y, cv.z, cv.w}, sw[4] = {sv.x, sv.y, sv.z, sv.w};
    uint32_t o1[4], o2[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 g1 = at_unpack(g1w[i]), g2 = at_unpack(g2w[i]);
      const float2 c = at_unpack(cw[i]), s = at_unpack(sw[i]);
      float r1[2], r2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float ge1 = e ? g1.y : g1.x, ge2 = e ? g2.y : g2.x;
        const float ce = e ? c.y : c.x, se = e ? s.y : s.x;
        const float n1 = bfr(bfr(x1[2 * i + e] * inv) * ge1);
        const float n2 = bfr(bfr(x2[2 * i + e] * inv) * ge2);
        r1[e] = bfr(n1 * ce) - bfr(n2 * se);
        r2[e] = bfr(n1 * se) + bfr(n2 * ce);
      }
      o1[i] = at_pack(r1[0], r1[1]);
      o2[i] = at_pack(r2[0], r2[1]);
    }
    *reinterpret_cast<uint4*>(tile + swizzle128(r, 8 * u)) = make_uint4(o1[0], o1[1], o1[2], o1[3]);
    *reinterpret_cast<uint4*>(tile + swizzle128(r, 8 * u + 32)) =
        make_uint4(o2[0], o2[1], o2[2], o2[3]);
    if (u == 0 && inv_out != nullptr) inv_out[row] = inv;
  }
}

// 1024-byte aligned base of the dynamic shared memory (the swizzle atom)
__device__ __forceinline__ unsigned char* at_smem_base(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                          ~uintptr_t(1023));
}

// ------------------------------------------------------------------ forward --

// shared memory: NT tiles each of Q, K, V, one mbarrier; + 1024 to align
__host__ __device__ constexpr size_t fwd_smem(int nt) {
  return 3 * (size_t)nt * kAtTile + 64 + 1024;
}

}  // namespace

// Two CTAs an SM up to three tiles (L <= 192): 80 registers a thread at
// three warpgroups
template <int NT>
__global__ void __launch_bounds__(NT * 128, NT == 1 ? 4 : NT == 2 ? 3 : NT == 3 ? 2 : 1)
fused_attention_fwd_kernel(const __grid_constant__ CUtensorMap tm_qkv,
                           const __grid_constant__ CUtensorMap tm_out,
                           const bf16* __restrict__ gq, const bf16* __restrict__ gk,
                           const bf16* __restrict__ cos_t, const bf16* __restrict__ sin_t,
                           float* __restrict__ lse, int L, int H, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = at_smem_base(smem_raw);
  unsigned char* qs = smem;
  unsigned char* ks = qs + NT * kAtTile;
  unsigned char* vs = ks + NT * kAtTile;
  uint64_t* bar = reinterpret_cast<uint64_t*>(vs + NT * kAtTile);
  const int h = blockIdx.x, b = blockIdx.y, HD = H * kAtD;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, lane = tid % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(bar, 3 * NT * kAtTile);
    for (int t = 0; t < NT; ++t) {
      tma_load_3d(qs + t * kAtTile, &tm_qkv, bar, h * kAtD, t * kAtRows, b);
      tma_load_3d(ks + t * kAtTile, &tm_qkv, bar, HD + h * kAtD, t * kAtRows, b);
      tma_load_3d(vs + t * kAtTile, &tm_qkv, bar, 2 * HD + h * kAtD, t * kAtRows, b);
    }
  }
  mbar_wait(bar, 0);
  norm_rope_tiles(qs, NT, L, gq, cos_t, sin_t, nullptr);
  norm_rope_tiles(ks, NT, L, gk, cos_t, sin_t, nullptr);
  fence_proxy_async();
  __syncthreads();

  // warpgroup wg: query rows 64 wg + r0 and + 8 (even and odd pairs of the
  // accumulators)
  const int r0 = (tid / 32) * 16 + lane / 4;
  unsigned char* qtile = qs + wg * kAtTile;
  const uint64_t qdesc = wgmma_desc(qtile, 16, 1024);
  const float c2 = scale * kAtLog2e;  // logits to log2 units

  // sweep 1: each row's maximum m (of the raw logits) and sum l of
  // exp((s - m) scale), online over the key tiles; this thread's share of l
  float m0 = kAtNeg, m1 = kAtNeg, l0 = 0.f, l1 = 0.f;
  for (int t = 0; t < NT; ++t) {
    float sc[32];
    const uint64_t kdesc = wgmma_desc(ks + t * kAtTile, 16, 1024);
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kAtD / 16; ++kk) wgmma_m64n64k16_ss(sc, qdesc + 2 * kk, kdesc + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    if (t == NT - 1 && L % kAtRows) {
      const int lim = L - t * kAtRows;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if ((i / 4) * 8 + (lane % 4) * 2 + (i % 2) >= lim) sc[i] = kAtNeg;
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    mx0 = at_quad_max(mx0);
    mx1 = at_quad_max(mx1);
    l0 *= at_ex2((m0 - mx0) * c2);
    l1 *= at_ex2((m1 - mx1) * c2);
    m0 = mx0;
    m1 = mx1;
    const float b0 = -m0 * c2, b1 = -m1 * c2;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      l0 += at_ex2(fmaf(sc[4 * j], c2, b0)) + at_ex2(fmaf(sc[4 * j + 1], c2, b0));
      l1 += at_ex2(fmaf(sc[4 * j + 2], c2, b1)) + at_ex2(fmaf(sc[4 * j + 3], c2, b1));
    }
  }
  l0 = at_quad_sum(l0);
  l1 = at_quad_sum(l1);

  // sweep 2: P = exp((s - m) scale) / l rounded to bf16 once, 32 keys at a
  // time, and O += P V
  const float il0 = 1.f / l0, il1 = 1.f / l1, b0 = -m0 * c2, b1 = -m1 * c2;
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  for (int t = 0; t < NT; ++t) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int lim = L - t * kAtRows - hf * 32;  // valid keys of this half
      if (lim <= 0) continue;                     // wholly past L (the same in the whole CTA)
      float sc[16];
      uint32_t p[8];
      const unsigned char* khalf = ks + t * kAtTile + hf * (kAtTile / 2);
      const uint64_t kdesc = wgmma_desc(khalf, 16, 1024);
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kAtD / 16; ++kk)
        wgmma_m64n32k16_ss(sc, qdesc + 2 * kk, kdesc + 2 * kk, kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float pr[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool valid = j * 8 + (lane % 4) * 2 + (e % 2) < lim;
          pr[e] = valid ? at_ex2(fmaf(sc[4 * j + e], c2, e < 2 ? b0 : b1)) * (e < 2 ? il0 : il1)
                        : 0.f;
        }
        p[2 * j] = at_pack(pr[0], pr[1]);
        p[2 * j + 1] = at_pack(pr[2], pr[3]);
      }
      const uint64_t vdesc = wgmma_desc(vs + t * kAtTile + hf * (kAtTile / 2), 1024, 1024);
      fence_regs(o);
      fence_regs(p);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
        wgmma_m64n64k16_rs_bt(o, a, vdesc + 128 * kk, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);
    }
  }

  // epilogue: O in bf16 into the spent Q tile (swizzled), one TMA store; lse
  at_wg_barrier(wg);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = j * 8 + (lane % 4) * 2;
    *reinterpret_cast<uint32_t*>(qtile + swizzle128(r0, col)) = at_pack(o[4 * j], o[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(qtile + swizzle128(r0 + 8, col)) =
        at_pack(o[4 * j + 2], o[4 * j + 3]);
  }
  fence_proxy_async();
  at_wg_barrier(wg);
  if (tid == 0) {
    tma_store_3d(&tm_out, qtile, h * kAtD, wg * kAtRows, b);
    tma_store_commit_and_wait();
  }
  if (lse != nullptr && lane % 4 == 0) {
    const int q = wg * kAtRows + r0;
    float* row = lse + ((size_t)b * H + h) * L;
    if (q < L) row[q] = m0 * scale + logf(l0);
    if (q + 8 < L) row[q + 8] = m1 * scale + logf(l1);
  }
}

// ----------------------------------------------------------------- backward --

namespace {

// consumer warpgroups: one per key tile, two (in two passes) at four tiles
__host__ __device__ constexpr int bwd_warpgroups(int nt) { return nt == 4 ? 2 : nt; }

// Shared memory of the backward at NT tiles (offsets from the aligned base):
// Q, K, V, dO (NT tiles each), the dS^T tiles of one pass (NW x NT), the
// per-row lse (log2 units), delta, 1/rms of q and k (f32), the per-warp
// gamma partials (q, k), one mbarrier; + 1024 to align
struct AttnBwdSmem {
  size_t q = 0, k = 0, v = 0, dO = 0, ds = 0, lse = 0, delta = 0, invq = 0, invk = 0, dg = 0,
         bar = 0, total = 0;
  __host__ __device__ constexpr AttnBwdSmem(int nt) {
    const size_t tiles = (size_t)nt * kAtTile;
    const size_t rows = (size_t)nt * kAtRows * sizeof(float);
    k = q + tiles;
    v = k + tiles;
    dO = v + tiles;
    ds = dO + tiles;
    lse = ds + bwd_warpgroups(nt) * tiles;
    delta = lse + rows;
    invq = delta + rows;
    invk = invq + rows;
    dg = invk + rows;
    bar = dg + 2 * bwd_warpgroups(nt) * 4 * kAtD * sizeof(float);
    total = bar + 64 + 1024;
  }
};

// The 64 x 64 f32 gradient `acc` of rotated rows tile * 64 + [0, 64) (this
// thread's rows r0 and r0 + 8, as a wgmma accumulator) back through the
// inverse rotation and the gamma-scaled RMS norm in f32, into dx in bf16
// written swizzled into `stage`; the raw rows x (row stride `stride`) come
// from global memory. The gamma gradient of the thread's 16 columns
// (8 jj + 2 (lane % 4) + e, held at 2 jj + e) accumulates in dg.
__device__ __forceinline__ void norm_rope_bwd_tile(const float (&acc)[32], int tile, int r0,
                                                   int lane, int L, const bf16* __restrict__ x,
                                                   size_t stride, const float* inv_s,
                                                   const bf16* __restrict__ gamma,
                                                   const bf16* __restrict__ cos_t,
                                                   const bf16* __restrict__ sin_t,
                                                   unsigned char* stage, float (&dg)[16]) {
  const int cq = 2 * (lane % 4);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + 8 * hr, pos = tile * kAtRows + row;
    const bool ok = pos < L;
    const float iv = ok ? inv_s[pos] : 0.f;
    float gh[16], xv[16];
    float msum = 0.f;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = 8 * jj + cq;
      float2 cs = make_float2(0.f, 0.f), sn = cs, x1 = cs, x2 = cs;
      if (ok) {
        cs = at_ld2(cos_t + pos * (kAtD / 2) + c);
        sn = at_ld2(sin_t + pos * (kAtD / 2) + c);
        x1 = at_ld2(x + pos * stride + c);
        x2 = at_ld2(x + pos * stride + c + 32);
      }
      const float2 g1 = at_ld2(gamma + c), g2 = at_ld2(gamma + c + 32);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float d1 = acc[4 * jj + 2 * hr + e], d2 = acc[4 * (jj + 4) + 2 * hr + e];
        const float ce = e ? cs.y : cs.x, se = e ? sn.y : sn.x;
        const float xa = e ? x1.y : x1.x, xb = e ? x2.y : x2.x;
        const float gn1 = d1 * ce + d2 * se, gn2 = d2 * ce - d1 * se;
        dg[2 * jj + e] += gn1 * xa * iv;
        dg[2 * (jj + 4) + e] += gn2 * xb * iv;
        const float gh1 = gn1 * (e ? g1.y : g1.x), gh2 = gn2 * (e ? g2.y : g2.x);
        msum += gh1 * xa + gh2 * xb;
        gh[2 * jj + e] = gh1;
        gh[2 * (jj + 4) + e] = gh2;
        xv[2 * jj + e] = xa;
        xv[2 * (jj + 4) + e] = xb;
      }
    }
    const float i3m = iv * iv * iv * (at_quad_sum(msum) / kAtD);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
      *reinterpret_cast<uint32_t*>(stage + swizzle128(row, 8 * jj + cq)) =
          at_pack(gh[2 * jj] * iv - xv[2 * jj] * i3m, gh[2 * jj + 1] * iv - xv[2 * jj + 1] * i3m);
  }
}

// the warp's sum of each thread's 16 gamma-gradient columns, added by lanes
// 0..3 to this warp's row of partials (in program order: deterministic)
__device__ __forceinline__ void add_gamma_partials(float (&dg)[16], float* slot, int lane) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    float v = dg[i];
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    v += __shfl_xor_sync(0xffffffffu, v, 16);
    if (lane < 4) slot[8 * (i / 2) + 2 * lane + i % 2] += v;
    dg[i] = 0.f;
  }
}

// stage (written swizzled by warpgroup wg, fenced) -> one TMA store; the
// stage may be written again once this returns
__device__ __forceinline__ void store_tile(const CUtensorMap* map, unsigned char* stage, int col,
                                           int row, int b, int wg, int tid) {
  fence_proxy_async();
  at_wg_barrier(wg);
  if (tid == 0) {
    tma_store_3d(map, stage, col, row, b);
    tma_store_commit_and_wait();
  }
  at_wg_barrier(wg);
}

}  // namespace

template <int NT>
__global__ void __launch_bounds__(bwd_warpgroups(NT) * 128, 1)
fused_attention_bwd_kernel(const __grid_constant__ CUtensorMap tm_qkv,
                           const __grid_constant__ CUtensorMap tm_do,
                           const __grid_constant__ CUtensorMap tm_dqkv,
                           const __grid_constant__ CUtensorMap tm_o,
                           const bf16* __restrict__ qkv, const float* __restrict__ lse, const bf16* __restrict__ gq,
                           const bf16* __restrict__ gk, const bf16* __restrict__ cos_t,
                           const bf16* __restrict__ sin_t, float* __restrict__ dgq,
                           float* __restrict__ dgk, int L, int H, float scale) {
  constexpr int NW = bwd_warpgroups(NT), NP = NT / NW, QT = NT / NW;
  constexpr AttnBwdSmem lay(NT);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = at_smem_base(smem_raw);
  unsigned char* qs = smem + lay.q;
  unsigned char* ks = smem + lay.k;
  unsigned char* vs = smem + lay.v;
  unsigned char* dos = smem + lay.dO;
  unsigned char* dss = smem + lay.ds;
  float* lse_s = reinterpret_cast<float*>(smem + lay.lse);
  float* delta_s = reinterpret_cast<float*>(smem + lay.delta);
  float* invq_s = reinterpret_cast<float*>(smem + lay.invq);
  float* invk_s = reinterpret_cast<float*>(smem + lay.invk);
  float* dg_s = reinterpret_cast<float*>(smem + lay.dg);  // [2][NW * 4 warps][64]
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + lay.bar);

  const int h = blockIdx.x, b = blockIdx.y, HD = H * kAtD;
  const size_t row3 = 3 * (size_t)HD;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, lane = tid % 32;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  for (int i = threadIdx.x; i < 2 * NW * 4 * kAtD; i += blockDim.x) dg_s[i] = 0.f;
  __syncthreads();
  if (threadIdx.x == 0) {
    // O (for delta only) into the dS^T tiles, which phase A writes later
    mbar_arrive_expect_tx(bar, 5 * NT * kAtTile);
    for (int t = 0; t < NT; ++t) {
      tma_load_3d(qs + t * kAtTile, &tm_qkv, bar, h * kAtD, t * kAtRows, b);
      tma_load_3d(ks + t * kAtTile, &tm_qkv, bar, HD + h * kAtD, t * kAtRows, b);
      tma_load_3d(vs + t * kAtTile, &tm_qkv, bar, 2 * HD + h * kAtD, t * kAtRows, b);
      tma_load_3d(dos + t * kAtTile, &tm_do, bar, h * kAtD, t * kAtRows, b);
      tma_load_3d(dss + t * kAtTile, &tm_o, bar, h * kAtD, t * kAtRows, b);
    }
  }
  // lse in log2 units; +inf past L, so that a padded query's P is 0
  for (int q = threadIdx.x; q < NT * kAtRows; q += blockDim.x)
    lse_s[q] = q < L ? lse[((size_t)b * H + h) * L + q] * kAtLog2e : INFINITY;
  mbar_wait(bar, 0);
  // delta = rowsum(dO O): eight threads a row, 16 bytes of each (rows past
  // L are zero in both)
  for (int base = 0; base < NT * kAtRows * 8; base += blockDim.x) {
    const int idx = base + threadIdx.x;
    const int r = idx / 8, ch = idx % 8;
    float d = 0.f;
    if (idx < NT * kAtRows * 8) {
      const uint32_t at = (r / kAtRows) * kAtTile + swizzle128(r % kAtRows, ch * 8);
      const uint4 ov = *reinterpret_cast<const uint4*>(dss + at);
      const uint4 dv = *reinterpret_cast<const uint4*>(dos + at);
      const uint32_t ow[4] = {ov.x, ov.y, ov.z, ov.w}, dw[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 a = at_unpack(ow[i]), c = at_unpack(dw[i]);
        d += a.x * c.x + a.y * c.y;
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    d += __shfl_xor_sync(0xffffffffu, d, 4);
    if (ch == 0 && idx < NT * kAtRows * 8) delta_s[r] = d;
  }
  norm_rope_tiles(qs, NT, L, gq, cos_t, sin_t, invq_s);
  norm_rope_tiles(ks, NT, L, gk, cos_t, sin_t, invk_s);
  fence_proxy_async();
  __syncthreads();

  const int r0 = (tid / 32) * 16 + lane / 4;  // this thread's rows r0, r0 + 8 of a tile
  const float c2 = scale * kAtLog2e;
  // a softmax over one key is constant: its logits' gradient is exactly 0,
  // not the f32 rounding of dP - delta summed in two orders
  const float ds_scale = L > 1 ? scale : 0.f;
  float* dgq_slot = dg_s + (0 * NW * 4 + warp) * kAtD;
  float* dgk_slot = dg_s + (1 * NW * 4 + warp) * kAtD;
  float dg[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) dg[i] = 0.f;
  float dq[QT][32];

#pragma unroll 1
  for (int pass = 0; pass < NP; ++pass) {
    // ---- phase A: key tile kt; dK, dV over every query tile ----
    const int kt = pass * NW + wg;
    const uint64_t kdesc = wgmma_desc(ks + kt * kAtTile, 16, 1024);
    const uint64_t vdesc = wgmma_desc(vs + kt * kAtTile, 16, 1024);
    float dk[32], dv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
    const bool key0 = kt * kAtRows + r0 < L, key1 = kt * kAtRows + r0 + 8 < L;
#pragma unroll 1
    for (int j = 0; j < NT; ++j) {
      float s[32], dp[32];
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      const uint64_t qdesc = wgmma_desc(qs + j * kAtTile, 16, 1024);
      const uint64_t odesc = wgmma_desc(dos + j * kAtTile, 16, 1024);
#pragma unroll
      for (int kk = 0; kk < kAtD / 16; ++kk) wgmma_m64n64k16_ss(s, kdesc + 2 * kk, qdesc + 2 * kk, kk);
#pragma unroll
      for (int kk = 0; kk < kAtD / 16; ++kk) wgmma_m64n64k16_ss(dp, vdesc + 2 * kk, odesc + 2 * kk, kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      // P^T = exp(S^T scale - lse) (0 for keys past L), dS^T = P^T (dP^T - delta) scale
      uint32_t pa[16], da[16];
      unsigned char* slot = dss + (wg * NT + j) * kAtTile;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = jj * 8 + (lane % 4) * 2, q = j * kAtRows + col;
        const float la = lse_s[q], lb = lse_s[q + 1], da0 = delta_s[q], da1 = delta_s[q + 1];
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool key = e < 2 ? key0 : key1;
          p[e] = key ? at_ex2(fmaf(s[4 * jj + e], c2, -(e % 2 ? lb : la))) : 0.f;
          ds[e] = p[e] * (dp[4 * jj + e] - (e % 2 ? da1 : da0)) * ds_scale;
        }
        pa[2 * jj] = at_pack(p[0], p[1]);
        pa[2 * jj + 1] = at_pack(p[2], p[3]);
        da[2 * jj] = at_pack(ds[0], ds[1]);
        da[2 * jj + 1] = at_pack(ds[2], ds[3]);
        *reinterpret_cast<uint32_t*>(slot + swizzle128(r0, col)) = da[2 * jj];
        *reinterpret_cast<uint32_t*>(slot + swizzle128(r0 + 8, col)) = da[2 * jj + 1];
      }
      // dV += P^T dO_j, dK += dS^T Q_j: A from registers, B MN-major
      const uint64_t ot = wgmma_desc(dos + j * kAtTile, 1024, 1024);
      const uint64_t qt = wgmma_desc(qs + j * kAtTile, 1024, 1024);
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(pa);
      fence_regs(da);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
        wgmma_m64n64k16_rs_bt(dv, a, ot + 128 * kk, 1);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t a[4] = {da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3]};
        wgmma_m64n64k16_rs_bt(dk, a, qt + 128 * kk, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(pa);
      fence_regs(da);
    }
    fence_proxy_async();  // this warpgroup's dS^T tiles, for phase B's wgmma

    // dV: straight to bf16, staged in the (spent, this warpgroup's) V tile
    unsigned char* stage = vs + kt * kAtTile;
    at_wg_barrier(wg);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = jj * 8 + (lane % 4) * 2;
      *reinterpret_cast<uint32_t*>(stage + swizzle128(r0, col)) = at_pack(dv[4 * jj], dv[4 * jj + 1]);
      *reinterpret_cast<uint32_t*>(stage + swizzle128(r0 + 8, col)) =
          at_pack(dv[4 * jj + 2], dv[4 * jj + 3]);
    }
    store_tile(&tm_dqkv, stage, 2 * HD + h * kAtD, kt * kAtRows, b, wg, tid);
    // dK: the norm + RoPE backward, staged in the same tile
    norm_rope_bwd_tile(dk, kt, r0, lane, L, qkv + (size_t)b * L * row3 + HD + h * kAtD, row3,
                       invk_s, gk, cos_t, sin_t, stage, dg);
    add_gamma_partials(dg, dgk_slot, lane);
    store_tile(&tm_dqkv, stage, HD + h * kAtD, kt * kAtRows, b, wg, tid);
    __syncthreads();  // every dS^T tile of this pass is written

    // ---- phase B: dQ_j += sum over this pass's key tiles of dS_j K ----
#pragma unroll
    for (int qi = 0; qi < QT; ++qi) {
      const int j = wg + qi * NW;
      fence_regs(dq[qi]);
      wgmma_fence();
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const uint64_t ad = wgmma_desc(dss + (w * NT + j) * kAtTile, 1024, 1024);
        const uint64_t bd = wgmma_desc(ks + (pass * NW + w) * kAtTile, 1024, 1024);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n64k16_ss_tt(dq[qi], ad + 128 * kk, bd + 128 * kk, (pass | w | kk) != 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq[qi]);
    }
    if (pass + 1 < NP) __syncthreads();  // the dS^T tiles are read before the next pass
  }

  // dQ: the norm + RoPE backward, staged in the spent dO tile of query tile j
#pragma unroll
  for (int qi = 0; qi < QT; ++qi) {
    const int j = wg + qi * NW;
    unsigned char* stage = dos + j * kAtTile;
    norm_rope_bwd_tile(dq[qi], j, r0, lane, L, qkv + (size_t)b * L * row3 + h * kAtD, row3,
                       invq_s, gq, cos_t, sin_t, stage, dg);
    add_gamma_partials(dg, dgq_slot, lane);
    store_tile(&tm_dqkv, stage, h * kAtD, j * kAtRows, b, wg, tid);
  }

  // gamma partials of this (batch, head): the warps' rows summed in order
  __syncthreads();
  if (threadIdx.x < 2 * kAtD) {
    const int which = threadIdx.x / kAtD, d = threadIdx.x % kAtD;
    float s = 0.f;
    for (int w = 0; w < NW * 4; ++w) s += dg_s[(which * NW * 4 + w) * kAtD + d];
    (which ? dgk : dgq)[((size_t)b * H + h) * kAtD + d] = s;
  }
}

static_assert(AttnBwdSmem(kAtMaxTiles - 1).total <= kMaxSmem &&
                  AttnBwdSmem(kAtMaxTiles).total <= kMaxSmem,
              "the backward's tiles exceed a block's shared memory");

}  // namespace odt

// lse may be null: the forward then writes only out (no gradient will be taken)
extern "C" int odt_fused_attention_fwd(const void* qkv, const void* gq, const void* gk,
                                       const void* cos_t, const void* sin_t, void* out, void* lse,
                                       int B, int L, int H, float scale, void* stream) {
  using namespace odt;
  if (L < 1 || L > kAtMaxTiles * kAtRows) return (int)cudaErrorInvalidValue;
  const uint64_t HD = (uint64_t)H * kAtD;
  CUtensorMap maps[2];
  cudaError_t err = hopper::tma_map_bf16_3d(&maps[0], qkv, 3 * HD, L, B, kAtD, kAtRows);
  if (err == cudaSuccess) err = hopper::tma_map_bf16_3d(&maps[1], out, HD, L, B, kAtD, kAtRows);
  if (err != cudaSuccess) return (int)err;
  const int nt = (L + kAtRows - 1) / kAtRows;
  decltype(&fused_attention_fwd_kernel<1>) kernels[] = {
      fused_attention_fwd_kernel<1>, fused_attention_fwd_kernel<2>, fused_attention_fwd_kernel<3>,
      fused_attention_fwd_kernel<4>};
  return (int)launch(kernels[nt - 1], dim3(H, B), dim3(nt * 128), fwd_smem(nt),
                     (cudaStream_t)stream, maps[0], maps[1], (const bf16*)gq, (const bf16*)gk,
                     (const bf16*)cos_t, (const bf16*)sin_t, (float*)lse, L, H, scale);
}

extern "C" int odt_fused_attention_bwd(const void* qkv, const void* dout, const void* out,
                                       const void* lse, const void* gq, const void* gk,
                                       const void* cos_t, const void* sin_t, void* dqkv,
                                       void* dgq, void* dgk, int B, int L, int H, float scale,
                                       void* stream) {
  using namespace odt;
  if (L < 1 || L > kAtMaxTiles * kAtRows) return (int)cudaErrorInvalidValue;
  const uint64_t HD = (uint64_t)H * kAtD;
  CUtensorMap maps[4];
  cudaError_t err = hopper::tma_map_bf16_3d(&maps[0], qkv, 3 * HD, L, B, kAtD, kAtRows);
  if (err == cudaSuccess) err = hopper::tma_map_bf16_3d(&maps[1], dout, HD, L, B, kAtD, kAtRows);
  if (err == cudaSuccess) err = hopper::tma_map_bf16_3d(&maps[2], dqkv, 3 * HD, L, B, kAtD, kAtRows);
  if (err == cudaSuccess) err = hopper::tma_map_bf16_3d(&maps[3], out, HD, L, B, kAtD, kAtRows);
  if (err != cudaSuccess) return (int)err;
  const int nt = (L + kAtRows - 1) / kAtRows;
  decltype(&fused_attention_bwd_kernel<1>) kernels[] = {
      fused_attention_bwd_kernel<1>, fused_attention_bwd_kernel<2>, fused_attention_bwd_kernel<3>,
      fused_attention_bwd_kernel<4>};
  return (int)launch(kernels[nt - 1], dim3(H, B), dim3(bwd_warpgroups(nt) * 128),
                     AttnBwdSmem(nt).total, (cudaStream_t)stream, maps[0], maps[1], maps[2],
                     maps[3], (const bf16*)qkv, (const float*)lse, (const bf16*)gq,
                     (const bf16*)gk, (const bf16*)cos_t, (const bf16*)sin_t, (float*)dgq,
                     (float*)dgk, L, H, scale);
}
