// Fused per-head RMS norm + RoPE + softmax attention for Hopper, forward (K9)
// and backward (K10), straight off the packed qkv projection, at head dims
// D 32, 64 and 128.
//
// Replaces the Pallas TPU kernels of osu_dreamer_tpu/ops/fused_attention.py:
// `_fwd_kernel` (launched by `_fwd_impl`) and `_bwd_kernel` (launched by
// `_vjp_bwd`). On the main path they are the denoiser's attention in training:
// qkv bf16 (128, 152, 3 x 16 x 64), gammas (64,), 8 layers per step; K9 also
// answers inference at latent lengths <= 256. A denoiser of 8 x 128 or
// 32 x 32 heads (the same H D) runs them at D 128 or 32.
//
// What bounds them on the H100: per (batch row, head) a few L x D rows come
// in and go out, and the products over them are 2 L^2 D multiply-adds each
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
// Head dims: every tile is 64 bf16 columns (128 bytes) wide with 128-byte
// swizzle, and a head's 64-row tile is kCG such tiles side by side (AtCfg):
// one at D 64, two at D 128 (column groups, the rotary pair (j, j + 64) in
// the same chunk of the two), and one at D 32, loaded through a 4-D tensor
// map (D, 3H, L, B) whose 64-column box zero-fills columns 32..63 and whose
// stores leave them unwritten (hopper.cuh `tma_map_heads`): the D-32 head
// runs the D-64 code with zero columns in its N = 64 products. Q K^T takes
// D / 16 k-steps; a product with N = D is one m64n64 chain per column group.
//
// Common to both (hopper.cuh holds the primitives):
// - one CTA per (head, batch row), one consumer warpgroup per 64-row tile
//   (the forward) or per 64-key tile (the backward at D <= 64); the head's
//   rows come in by TMA with 128-byte swizzle: rows past L are zero-filled
//   inside batch row b, never read from b + 1, and the output stores clip
//   at L;
// - the q/k rows are normalised and rotated in place in the swizzled tiles,
//   each row once a CTA (four threads a row at D 64 and 128, two at 32; the
//   rotary pair (j, j + D/2) sits in chunks c and c + D/16 of one row under
//   any swizzle), then fenced to the async proxy: f32 1/rms, bf16(x / rms),
//   bf16(* gamma), bf16 rotary products and sums, the plain version's
//   rounding order;
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
// K10 (backward) at D 32 and 64, NT tiles, NW = NT consumer warpgroups (2
// at NT = 4, in two passes of two key tiles), warpgroup w owns key tile kt:
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
//
// K10 at D 128: a head's Q, K, V and dO at L 256 alone are 256 KB, past a
// block's 227 KB, and the dK, dV and dQ accumulators of one warpgroup would
// pass 255 registers, so the backward is two launches of two warpgroups a
// CTA (one CTA an SM at 255 registers), each warpgroup owning a tile and
// the CTA holding the rows they both sweep resident:
// - `fused_attention_bwd_kv_kernel`, one CTA per (two key tiles, head,
//   batch row): their K and V tiles and every Q and dO tile of the head;
//   per query tile S^T, dP^T, then dV += P^T dO_j and dK += dS^T Q_j as
//   above (two 64-column accumulators each); delta from dO in shared memory
//   and O read from global memory; dV and dK (norm + RoPE backward) leave
//   through the spent V and K tiles;
// - `fused_attention_bwd_q_kernel`, one CTA per (two query tiles, head,
//   batch row): their Q and dO tiles and every K and V tile; per key tile
//   it forms S, dP, P and dS again (the recompute that replaces the shared
//   dS^T tiles) and dQ += dS K_t with dS from registers and K MN-major; dQ
//   leaves through the spent dO tile;
// - at odd NT the last CTA's second tile lies past the head: it loads as
//   zeros, its P and dS are 0, its stores clip and it writes no partial;
// - the gamma gradients as one f32 partial per (tile, batch, head), summed
//   by the wrapper in a fixed order.
#include "common.cuh"
#include "hopper.cuh"

namespace odt {

using namespace hopper;

namespace {

constexpr int kAtRows = 64;                                    // rows of a tile
constexpr uint32_t kAtBox = kAtRows * 64 * sizeof(bf16);       // 8 KB, one swizzled 64 x 64 box
constexpr int kAtMaxTiles = 4;                                 // L <= 256
constexpr float kAtNeg = -1e30f;
constexpr float kAtLog2e = 1.4426950408889634f;

// the layout at head dim D: kCG 64-column boxes a 64-row tile (D 32 pads to
// one), kTile bytes; four threads a row in the norm (two at D 32), each
// kCPT chunks of 8 columns of either rotary half
template <int D>
struct AtCfg {
  static_assert(D == 32 || D == 64 || D == 128, "head dims 32, 64 and 128");
  static constexpr int kCG = D < 64 ? 1 : D / 64;
  static constexpr uint32_t kTile = kCG * kAtBox;
  static constexpr int kKSteps = D / 16;
  static constexpr int kTPR = D < 64 ? 2 : 4;
  static constexpr int kCPT = D / 16 / kTPR;
};

// byte offset of bf16 element (row, col) of a head's 64-row tile
__device__ __forceinline__ uint32_t at_off(int row, int col) {
  return (col / 64) * kAtBox + swizzle128(row, col % 64);
}

// a descriptor k-step offset (16-byte units) of k16 step kk of a K-major
// operand: 32 bytes a step inside a box, the next box kAtBox bytes on
__device__ __forceinline__ uint64_t at_kstep(int kk) {
  return (kk / 4) * (kAtBox >> 4) + 2 * (kk % 4);
}

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

template <int N>
__device__ __forceinline__ void fence_acc(float (&r)[N][32]) {
#pragma unroll
  for (int c = 0; c < N; ++c) fence_regs(r[c]);
}

// Normalise and rotate in place the 64 ntiles rows of `tiles` (ntiles
// consecutive 64-row tiles of kTile bytes: row p of the span is row p % 64
// of tile p / 64; the span starts at position row0 of the head) in the
// plain version's rounding order: f32 1/rms over the row, bf16(x / rms),
// bf16(* gamma), then bf16 rotary products and sums. kTPR neighbouring
// threads share a row: thread u holds the 8-column chunks u + kTPR i of the
// first rotary half and their partners D/16 chunks on. Positions past L are
// zero (TMA fill) and stay so. The forward and the backward both call this,
// so the backward's rotated rows are bit-identical to the forward's.
// inv_out (may be null) receives each valid row's 1/rms at its row in the span.
template <int D>
__device__ __forceinline__ void norm_rope_tiles(unsigned char* tiles, int ntiles, int row0, int L,
                                                const bf16* __restrict__ gamma,
                                                const bf16* __restrict__ cos_t,
                                                const bf16* __restrict__ sin_t, float* inv_out) {
  using Cfg = AtCfg<D>;
  constexpr int TPR = Cfg::kTPR, CPT = Cfg::kCPT, HALF = D / 2;
  const int nthreads = blockDim.x, work = ntiles * kAtRows * TPR;
  for (int base = 0; base < work; base += nthreads) {
    const int idx = base + threadIdx.x;
    const int row = idx / TPR, u = idx % TPR, pos = row0 + row;
    const bool ok = idx < work && pos < L;
    unsigned char* tile = tiles + (row / kAtRows) * Cfg::kTile;
    const int r = row % kAtRows;
    float x1[8 * CPT], x2[8 * CPT];
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int col = 8 * (u + TPR * i);
      uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
      if (ok) {
        lo = *reinterpret_cast<const uint4*>(tile + at_off(r, col));
        hi = *reinterpret_cast<const uint4*>(tile + at_off(r, col + HALF));
      }
      const uint32_t lw[4] = {lo.x, lo.y, lo.z, lo.w}, hw[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float2 a = at_unpack(lw[w]), b = at_unpack(hw[w]);
        x1[8 * i + 2 * w] = a.x;
        x1[8 * i + 2 * w + 1] = a.y;
        x2[8 * i + 2 * w] = b.x;
        x2[8 * i + 2 * w + 1] = b.y;
      }
    }
    float ss = 0.f;
#pragma unroll
    for (int e = 0; e < 8 * CPT; ++e) ss += x1[e] * x1[e] + x2[e] * x2[e];
    ss += __shfl_xor_sync(0xffffffffu, ss, 1);
    if (TPR == 4) ss += __shfl_xor_sync(0xffffffffu, ss, 2);
    if (!ok) continue;
    const float inv = 1.f / sqrtf(ss / D + 1e-6f);
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int col = 8 * (u + TPR * i);
      const uint4 gl = __ldg(reinterpret_cast<const uint4*>(gamma + col));
      const uint4 gh = __ldg(reinterpret_cast<const uint4*>(gamma + col + HALF));
      const uint4 cv = __ldg(reinterpret_cast<const uint4*>(cos_t + pos * HALF + col));
      const uint4 sv = __ldg(reinterpret_cast<const uint4*>(sin_t + pos * HALF + col));
      const uint32_t g1w[4] = {gl.x, gl.y, gl.z, gl.w}, g2w[4] = {gh.x, gh.y, gh.z, gh.w};
      const uint32_t cw[4] = {cv.x, cv.y, cv.z, cv.w}, sw[4] = {sv.x, sv.y, sv.z, sv.w};
      uint32_t o1[4], o2[4];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float2 g1 = at_unpack(g1w[w]), g2 = at_unpack(g2w[w]);
        const float2 c = at_unpack(cw[w]), s = at_unpack(sw[w]);
        float r1[2], r2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float ge1 = e ? g1.y : g1.x, ge2 = e ? g2.y : g2.x;
          const float ce = e ? c.y : c.x, se = e ? s.y : s.x;
          const float n1 = bfr(bfr(x1[8 * i + 2 * w + e] * inv) * ge1);
          const float n2 = bfr(bfr(x2[8 * i + 2 * w + e] * inv) * ge2);
          r1[e] = bfr(n1 * ce) - bfr(n2 * se);
          r2[e] = bfr(n1 * se) + bfr(n2 * ce);
        }
        o1[w] = at_pack(r1[0], r1[1]);
        o2[w] = at_pack(r2[0], r2[1]);
      }
      *reinterpret_cast<uint4*>(tile + at_off(r, col)) =
          make_uint4(o1[0], o1[1], o1[2], o1[3]);
      *reinterpret_cast<uint4*>(tile + at_off(r, col + HALF)) =
          make_uint4(o2[0], o2[1], o2[2], o2[3]);
    }
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
__host__ __device__ constexpr size_t fwd_smem(int nt, uint32_t tile) {
  return 3 * (size_t)nt * tile + 64 + 1024;
}

// CTAs an SM: two up to three tiles (L <= 192) at D <= 64, 80 registers a
// thread at three warpgroups; at D 128 as many as the shared memory holds
__host__ __device__ constexpr int fwd_min_blocks(int nt, int d) {
  return d < 128 ? (nt == 1 ? 4 : nt == 2 ? 3 : nt == 3 ? 2 : 1) : (nt == 1 ? 4 : nt == 2 ? 2 : 1);
}

}  // namespace

template <int NT, int D>
__global__ void __launch_bounds__(NT * 128, fwd_min_blocks(NT, D))
fused_attention_fwd_kernel(const __grid_constant__ CUtensorMap tm_qkv,
                           const __grid_constant__ CUtensorMap tm_out,
                           const bf16* __restrict__ gq, const bf16* __restrict__ gk,
                           const bf16* __restrict__ cos_t, const bf16* __restrict__ sin_t,
                           float* __restrict__ lse, int L, int H, float scale) {
  using Cfg = AtCfg<D>;
  constexpr int kCG = Cfg::kCG;
  constexpr uint32_t kTile = Cfg::kTile;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = at_smem_base(smem_raw);
  unsigned char* qs = smem;
  unsigned char* ks = qs + NT * kTile;
  unsigned char* vs = ks + NT * kTile;
  uint64_t* bar = reinterpret_cast<uint64_t*>(vs + NT * kTile);
  const int h = blockIdx.x, b = blockIdx.y;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, lane = tid % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(bar, 3 * NT * kTile);
    for (int t = 0; t < NT; ++t)
      for (int c = 0; c < kCG; ++c) {
        tma_load_head<D>(qs + t * kTile + c * kAtBox, &tm_qkv, bar, h, c, t * kAtRows, b);
        tma_load_head<D>(ks + t * kTile + c * kAtBox, &tm_qkv, bar, H + h, c, t * kAtRows, b);
        tma_load_head<D>(vs + t * kTile + c * kAtBox, &tm_qkv, bar, 2 * H + h, c, t * kAtRows,
                         b);
      }
  }
  mbar_wait(bar, 0);
  norm_rope_tiles<D>(qs, NT, 0, L, gq, cos_t, sin_t, nullptr);
  norm_rope_tiles<D>(ks, NT, 0, L, gk, cos_t, sin_t, nullptr);
  fence_proxy_async();
  __syncthreads();

  // warpgroup wg: query rows 64 wg + r0 and + 8 (even and odd pairs of the
  // accumulators)
  const int r0 = (tid / 32) * 16 + lane / 4;
  unsigned char* qtile = qs + wg * kTile;
  const uint64_t qdesc = wgmma_desc(qtile, 16, 1024);
  const float c2 = scale * kAtLog2e;  // logits to log2 units

  // sweep 1: each row's maximum m (of the raw logits) and sum l of
  // exp((s - m) scale), online over the key tiles; this thread's share of l
  float m0 = kAtNeg, m1 = kAtNeg, l0 = 0.f, l1 = 0.f;
  for (int t = 0; t < NT; ++t) {
    float sc[32];
    const uint64_t kdesc = wgmma_desc(ks + t * kTile, 16, 1024);
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Cfg::kKSteps; ++kk)
      wgmma_m64n64k16_ss(sc, qdesc + at_kstep(kk), kdesc + at_kstep(kk), kk);
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
  // time, and O += P V (one m64n64 chain a column group)
  const float il0 = 1.f / l0, il1 = 1.f / l1, b0 = -m0 * c2, b1 = -m1 * c2;
  float o[kCG][32];
#pragma unroll
  for (int c = 0; c < kCG; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  for (int t = 0; t < NT; ++t) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int lim = L - t * kAtRows - hf * 32;  // valid keys of this half
      if (lim <= 0) continue;                     // wholly past L (the same in the whole CTA)
      float sc[16];
      uint32_t p[8];
      const unsigned char* khalf = ks + t * kTile + hf * (kAtBox / 2);
      const uint64_t kdesc = wgmma_desc(khalf, 16, 1024);
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < Cfg::kKSteps; ++kk)
        wgmma_m64n32k16_ss(sc, qdesc + at_kstep(kk), kdesc + at_kstep(kk), kk);
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
      fence_acc(o);
      fence_regs(p);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < kCG; ++c) {
        const uint64_t vdesc =
            wgmma_desc(vs + t * kTile + c * kAtBox + hf * (kAtBox / 2), 1024, 1024);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
          wgmma_m64n64k16_rs_bt(o[c], a, vdesc + 128 * kk, 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(o);
      fence_regs(p);
    }
  }

  // epilogue: O in bf16 into the spent Q tile (swizzled), one TMA store a
  // column group; lse
  at_wg_barrier(wg);
#pragma unroll
  for (int c = 0; c < kCG; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j * 8 + (lane % 4) * 2;
      *reinterpret_cast<uint32_t*>(qtile + c * kAtBox + swizzle128(r0, col)) =
          at_pack(o[c][4 * j], o[c][4 * j + 1]);
      *reinterpret_cast<uint32_t*>(qtile + c * kAtBox + swizzle128(r0 + 8, col)) =
          at_pack(o[c][4 * j + 2], o[c][4 * j + 3]);
    }
  fence_proxy_async();
  at_wg_barrier(wg);
  if (tid == 0) {
    for (int c = 0; c < kCG; ++c)
      tma_store_head<D>(&tm_out, qtile + c * kAtBox, h, c, wg * kAtRows, b);
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

// Shared memory of the backward at NT tiles and D <= 64 (offsets from the
// aligned base): Q, K, V, dO (NT tiles each), the dS^T tiles of one pass
// (NW x NT), the per-row lse (log2 units), delta, 1/rms of q and k (f32),
// the per-warp gamma partials (q, k), one mbarrier; + 1024 to align
struct AttnBwdSmem {
  size_t q = 0, k = 0, v = 0, dO = 0, ds = 0, lse = 0, delta = 0, invq = 0, invk = 0, dg = 0,
         bar = 0, total = 0;
  __host__ __device__ constexpr AttnBwdSmem(int nt, int d) {
    const size_t tiles = (size_t)nt * kAtBox;
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
    bar = dg + 2 * bwd_warpgroups(nt) * 4 * d * sizeof(float);
    total = bar + 64 + 1024;
  }
};

// The 64 x D f32 gradient `acc` of rotated rows tile * 64 + [0, 64) (this
// thread's rows r0 and r0 + 8, as kCG wgmma accumulators of 64 columns)
// back through the inverse rotation and the gamma-scaled RMS norm in f32,
// into dx in bf16 written swizzled into `stage` (kCG boxes); the raw rows x
// (row stride `stride`) come from global memory, inv_s holds the tile's
// 1/rms by row. The gamma gradient of the thread's D / 4 columns
// (8 J + 2 (lane % 4) + e, held at 2 J + e) accumulates in dg.
template <int D>
__device__ __forceinline__ void norm_rope_bwd_tile(const float (&acc)[AtCfg<D>::kCG][32], int tile,
                                                   int r0, int lane, int L,
                                                   const bf16* __restrict__ x, size_t stride,
                                                   const float* inv_s,
                                                   const bf16* __restrict__ gamma,
                                                   const bf16* __restrict__ cos_t,
                                                   const bf16* __restrict__ sin_t,
                                                   unsigned char* stage, float (&dg)[D / 4]) {
  constexpr int HALF = D / 2, NJ = D / 16;  // chunks of 8 columns in a rotary half
  const int cq = 2 * (lane % 4);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + 8 * hr, pos = tile * kAtRows + row;
    const bool ok = pos < L;
    const float iv = ok ? inv_s[row] : 0.f;
    float gh[D / 4], xv[D / 4];
    float msum = 0.f;
#pragma unroll
    for (int J = 0; J < NJ; ++J) {
      const int c = 8 * J + cq, J2 = J + NJ;
      float2 cs = make_float2(0.f, 0.f), sn = cs, x1 = cs, x2 = cs;
      if (ok) {
        cs = at_ld2(cos_t + pos * HALF + c);
        sn = at_ld2(sin_t + pos * HALF + c);
        x1 = at_ld2(x + pos * stride + c);
        x2 = at_ld2(x + pos * stride + c + HALF);
      }
      const float2 g1 = at_ld2(gamma + c), g2 = at_ld2(gamma + c + HALF);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float d1 = acc[J / 8][4 * (J % 8) + 2 * hr + e];
        const float d2 = acc[J2 / 8][4 * (J2 % 8) + 2 * hr + e];
        const float ce = e ? cs.y : cs.x, se = e ? sn.y : sn.x;
        const float xa = e ? x1.y : x1.x, xb = e ? x2.y : x2.x;
        const float gn1 = d1 * ce + d2 * se, gn2 = d2 * ce - d1 * se;
        dg[2 * J + e] += gn1 * xa * iv;
        dg[2 * J2 + e] += gn2 * xb * iv;
        const float gh1 = gn1 * (e ? g1.y : g1.x), gh2 = gn2 * (e ? g2.y : g2.x);
        msum += gh1 * xa + gh2 * xb;
        gh[2 * J + e] = gh1;
        gh[2 * J2 + e] = gh2;
        xv[2 * J + e] = xa;
        xv[2 * J2 + e] = xb;
      }
    }
    const float i3m = iv * iv * iv * (at_quad_sum(msum) / D);
#pragma unroll
    for (int J = 0; J < D / 8; ++J)
      *reinterpret_cast<uint32_t*>(stage + at_off(row, 8 * J + cq)) =
          at_pack(gh[2 * J] * iv - xv[2 * J] * i3m, gh[2 * J + 1] * iv - xv[2 * J + 1] * i3m);
  }
}

// the warp's sum of each thread's D / 4 gamma-gradient columns, added by
// lanes 0..3 to this warp's row of partials (in program order: deterministic)
template <int D>
__device__ __forceinline__ void add_gamma_partials(float (&dg)[D / 4], float* slot, int lane) {
#pragma unroll
  for (int i = 0; i < D / 4; ++i) {
    float v = dg[i];
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    v += __shfl_xor_sync(0xffffffffu, v, 16);
    if (lane < 4) slot[8 * (i / 2) + 2 * lane + i % 2] += v;
    dg[i] = 0.f;
  }
}

// stage (kCG boxes written swizzled by warpgroup wg, fenced) -> TMA stores
// of head `head`; the stage may be written again once this returns
template <int D>
__device__ __forceinline__ void store_tile(const CUtensorMap* map, unsigned char* stage, int head,
                                           int row, int b, int wg, int tid) {
  fence_proxy_async();
  at_wg_barrier(wg);
  if (tid == 0) {
    for (int c = 0; c < AtCfg<D>::kCG; ++c)
      tma_store_head<D>(map, stage + c * kAtBox, head, c, row, b);
    tma_store_commit_and_wait();
  }
  at_wg_barrier(wg);
}

// an accumulator (kCG x 64 columns) in bf16 into a stage, swizzled
template <int D>
__device__ __forceinline__ void stage_acc(const float (&acc)[AtCfg<D>::kCG][32],
                                          unsigned char* stage, int r0, int lane) {
#pragma unroll
  for (int c = 0; c < AtCfg<D>::kCG; ++c)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = jj * 8 + (lane % 4) * 2;
      *reinterpret_cast<uint32_t*>(stage + c * kAtBox + swizzle128(r0, col)) =
          at_pack(acc[c][4 * jj], acc[c][4 * jj + 1]);
      *reinterpret_cast<uint32_t*>(stage + c * kAtBox + swizzle128(r0 + 8, col)) =
          at_pack(acc[c][4 * jj + 2], acc[c][4 * jj + 3]);
    }
}

}  // namespace

template <int NT, int D>
__global__ void __launch_bounds__(bwd_warpgroups(NT) * 128, 1)
fused_attention_bwd_kernel(const __grid_constant__ CUtensorMap tm_qkv,
                           const __grid_constant__ CUtensorMap tm_do,
                           const __grid_constant__ CUtensorMap tm_dqkv,
                           const __grid_constant__ CUtensorMap tm_o,
                           const bf16* __restrict__ qkv, const float* __restrict__ lse, const bf16* __restrict__ gq,
                           const bf16* __restrict__ gk, const bf16* __restrict__ cos_t,
                           const bf16* __restrict__ sin_t, float* __restrict__ dgq,
                           float* __restrict__ dgk, int L, int H, float scale) {
  static_assert(D <= 64, "the one-launch backward holds one box a tile");
  constexpr int NW = bwd_warpgroups(NT), NP = NT / NW, QT = NT / NW;
  constexpr AttnBwdSmem lay(NT, D);
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
  float* dg_s = reinterpret_cast<float*>(smem + lay.dg);  // [2][NW * 4 warps][D]
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + lay.bar);

  const int h = blockIdx.x, b = blockIdx.y, HD = H * D;
  const size_t row3 = 3 * (size_t)HD;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, lane = tid % 32;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  for (int i = threadIdx.x; i < 2 * NW * 4 * D; i += blockDim.x) dg_s[i] = 0.f;
  __syncthreads();
  if (threadIdx.x == 0) {
    // O (for delta only) into the dS^T tiles, which phase A writes later
    mbar_arrive_expect_tx(bar, 5 * NT * kAtBox);
    for (int t = 0; t < NT; ++t) {
      tma_load_head<D>(qs + t * kAtBox, &tm_qkv, bar, h, 0, t * kAtRows, b);
      tma_load_head<D>(ks + t * kAtBox, &tm_qkv, bar, H + h, 0, t * kAtRows, b);
      tma_load_head<D>(vs + t * kAtBox, &tm_qkv, bar, 2 * H + h, 0, t * kAtRows, b);
      tma_load_head<D>(dos + t * kAtBox, &tm_do, bar, h, 0, t * kAtRows, b);
      tma_load_head<D>(dss + t * kAtBox, &tm_o, bar, h, 0, t * kAtRows, b);
    }
  }
  // lse in log2 units; +inf past L, so that a padded query's P is 0
  for (int q = threadIdx.x; q < NT * kAtRows; q += blockDim.x)
    lse_s[q] = q < L ? lse[((size_t)b * H + h) * L + q] * kAtLog2e : INFINITY;
  mbar_wait(bar, 0);
  // delta = rowsum(dO O): eight threads a row, 16 bytes of each (rows past
  // L, and at D 32 the padded columns, are zero in both)
  for (int base = 0; base < NT * kAtRows * 8; base += blockDim.x) {
    const int idx = base + threadIdx.x;
    const int r = idx / 8, ch = idx % 8;
    float d = 0.f;
    if (idx < NT * kAtRows * 8) {
      const uint32_t at = (r / kAtRows) * kAtBox + swizzle128(r % kAtRows, ch * 8);
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
  norm_rope_tiles<D>(qs, NT, 0, L, gq, cos_t, sin_t, invq_s);
  norm_rope_tiles<D>(ks, NT, 0, L, gk, cos_t, sin_t, invk_s);
  fence_proxy_async();
  __syncthreads();

  const int r0 = (tid / 32) * 16 + lane / 4;  // this thread's rows r0, r0 + 8 of a tile
  const float c2 = scale * kAtLog2e;
  // a softmax over one key is constant: its logits' gradient is exactly 0,
  // not the f32 rounding of dP - delta summed in two orders
  const float ds_scale = L > 1 ? scale : 0.f;
  float* dgq_slot = dg_s + (0 * NW * 4 + warp) * D;
  float* dgk_slot = dg_s + (1 * NW * 4 + warp) * D;
  float dg[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) dg[i] = 0.f;
  float dq[QT][1][32];

#pragma unroll 1
  for (int pass = 0; pass < NP; ++pass) {
    // ---- phase A: key tile kt; dK, dV over every query tile ----
    const int kt = pass * NW + wg;
    const uint64_t kdesc = wgmma_desc(ks + kt * kAtBox, 16, 1024);
    const uint64_t vdesc = wgmma_desc(vs + kt * kAtBox, 16, 1024);
    float dk[1][32], dv[1][32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[0][i] = dv[0][i] = 0.f;
    const bool key0 = kt * kAtRows + r0 < L, key1 = kt * kAtRows + r0 + 8 < L;
#pragma unroll 1
    for (int j = 0; j < NT; ++j) {
      float s[32], dp[32];
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      const uint64_t qdesc = wgmma_desc(qs + j * kAtBox, 16, 1024);
      const uint64_t odesc = wgmma_desc(dos + j * kAtBox, 16, 1024);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) wgmma_m64n64k16_ss(s, kdesc + 2 * kk, qdesc + 2 * kk, kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) wgmma_m64n64k16_ss(dp, vdesc + 2 * kk, odesc + 2 * kk, kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      // P^T = exp(S^T scale - lse) (0 for keys past L), dS^T = P^T (dP^T - delta) scale
      uint32_t pa[16], da[16];
      unsigned char* slot = dss + (wg * NT + j) * kAtBox;
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
      const uint64_t ot = wgmma_desc(dos + j * kAtBox, 1024, 1024);
      const uint64_t qt = wgmma_desc(qs + j * kAtBox, 1024, 1024);
      fence_regs(dv[0]);
      fence_regs(dk[0]);
      fence_regs(pa);
      fence_regs(da);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
        wgmma_m64n64k16_rs_bt(dv[0], a, ot + 128 * kk, 1);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t a[4] = {da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3]};
        wgmma_m64n64k16_rs_bt(dk[0], a, qt + 128 * kk, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv[0]);
      fence_regs(dk[0]);
      fence_regs(pa);
      fence_regs(da);
    }
    fence_proxy_async();  // this warpgroup's dS^T tiles, for phase B's wgmma

    // dV: straight to bf16, staged in the (spent, this warpgroup's) V tile
    unsigned char* stage = vs + kt * kAtBox;
    at_wg_barrier(wg);
    stage_acc<D>(dv, stage, r0, lane);
    store_tile<D>(&tm_dqkv, stage, 2 * H + h, kt * kAtRows, b, wg, tid);
    // dK: the norm + RoPE backward, staged in the same tile
    norm_rope_bwd_tile<D>(dk, kt, r0, lane, L, qkv + (size_t)b * L * row3 + HD + h * D, row3,
                          invk_s + kt * kAtRows, gk, cos_t, sin_t, stage, dg);
    add_gamma_partials<D>(dg, dgk_slot, lane);
    store_tile<D>(&tm_dqkv, stage, H + h, kt * kAtRows, b, wg, tid);
    __syncthreads();  // every dS^T tile of this pass is written

    // ---- phase B: dQ_j += sum over this pass's key tiles of dS_j K ----
#pragma unroll
    for (int qi = 0; qi < QT; ++qi) {
      const int j = wg + qi * NW;
      fence_regs(dq[qi][0]);
      wgmma_fence();
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const uint64_t ad = wgmma_desc(dss + (w * NT + j) * kAtBox, 1024, 1024);
        const uint64_t bd = wgmma_desc(ks + (pass * NW + w) * kAtBox, 1024, 1024);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n64k16_ss_tt(dq[qi][0], ad + 128 * kk, bd + 128 * kk, (pass | w | kk) != 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq[qi][0]);
    }
    if (pass + 1 < NP) __syncthreads();  // the dS^T tiles are read before the next pass
  }

  // dQ: the norm + RoPE backward, staged in the spent dO tile of query tile j
#pragma unroll
  for (int qi = 0; qi < QT; ++qi) {
    const int j = wg + qi * NW;
    unsigned char* stage = dos + j * kAtBox;
    norm_rope_bwd_tile<D>(dq[qi], j, r0, lane, L, qkv + (size_t)b * L * row3 + h * D, row3,
                          invq_s + j * kAtRows, gq, cos_t, sin_t, stage, dg);
    add_gamma_partials<D>(dg, dgq_slot, lane);
    store_tile<D>(&tm_dqkv, stage, h, j * kAtRows, b, wg, tid);
  }

  // gamma partials of this (batch, head): the warps' rows summed in order
  __syncthreads();
  if (threadIdx.x < 2 * D) {
    const int which = threadIdx.x / D, d = threadIdx.x % D;
    float s = 0.f;
    for (int w = 0; w < NW * 4; ++w) s += dg_s[(which * NW * 4 + w) * D + d];
    (which ? dgk : dgq)[((size_t)b * H + h) * D + d] = s;
  }
}

static_assert(AttnBwdSmem(kAtMaxTiles - 1, 64).total <= kMaxSmem &&
                  AttnBwdSmem(kAtMaxTiles, 64).total <= kMaxSmem,
              "the backward's tiles exceed a block's shared memory");

// ------------------------------------------------- backward at head dim 128 --

namespace {

constexpr int kW = 128;                         // the head dim of the two-launch backward
constexpr uint32_t kWTile = AtCfg<kW>::kTile;   // 16 KB, one 64-row tile of a head
constexpr int kWGroups = 2;                     // warpgroups a CTA, one own tile each

// Shared memory of either D-128 launch at NT tiles: its own tiles (K then V,
// or Q then dO; kWGroups each, consecutive), the NT tiles of each of the two
// it sweeps, lse and delta of the rows it needs (NT tiles of query rows, or
// its own), the 1/rms of its own rows, the per-warp gamma partials, one
// mbarrier; + 1024 to align
struct WideBwdSmem {
  size_t own = 0, sweep = 0, lse = 0, delta = 0, inv = 0, dg = 0, bar = 0, total = 0;
  __host__ __device__ constexpr WideBwdSmem(int nt, int lse_rows) {
    sweep = own + 2 * kWGroups * (size_t)kWTile;
    lse = sweep + 2 * (size_t)nt * kWTile;
    delta = lse + lse_rows * sizeof(float);
    inv = delta + lse_rows * sizeof(float);
    dg = inv + kWGroups * kAtRows * sizeof(float);
    bar = dg + 4 * kWGroups * kW * sizeof(float);
    total = bar + 64 + 1024;
  }
};

// delta = rowsum(dO O) of `rows` query rows from row0: dO from its swizzled
// tiles, O (bf16 (L, H*128) of this batch row) from global memory; sixteen
// threads a row, 8 columns each; 0 past L
__device__ __forceinline__ void wide_delta(const unsigned char* dos, int rows, int row0, int L,
                                           const bf16* __restrict__ o, size_t stride,
                                           float* delta_s) {
  for (int base = 0; base < rows * 16; base += blockDim.x) {
    const int idx = base + threadIdx.x;
    const int r = idx / 16, ch = idx % 16;
    float d = 0.f;
    if (idx < rows * 16 && row0 + r < L) {
      const uint4 dv = *reinterpret_cast<const uint4*>(
          dos + (r / kAtRows) * kWTile + at_off(r % kAtRows, ch * 8));
      const uint4 ov = __ldg(reinterpret_cast<const uint4*>(o + (row0 + r) * stride + ch * 8));
      const uint32_t ow[4] = {ov.x, ov.y, ov.z, ov.w}, dw[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 a = at_unpack(ow[i]), c = at_unpack(dw[i]);
        d += a.x * c.x + a.y * c.y;
      }
    }
#pragma unroll
    for (int m = 1; m < 16; m <<= 1) d += __shfl_xor_sync(0xffffffffu, d, m);
    if (ch == 0 && idx < rows * 16) delta_s[r] = d;
  }
}

// each warpgroup's four warps' gamma partials summed in order into the
// (tile0 + warpgroup, b, h) row of out (NT, B, H, 128); a warpgroup whose
// tile lies past the head (odd NT) writes nothing
__device__ __forceinline__ void wide_gamma_out(const float* dg_s, float* __restrict__ out,
                                               int tile0, int nt, int b, int nb, int h, int H) {
  __syncthreads();
  const int wg = threadIdx.x / kW, d = threadIdx.x % kW;
  if (tile0 + wg < nt) {
    float s = 0.f;
    for (int w = 0; w < 4; ++w) s += dg_s[(4 * wg + w) * kW + d];
    out[(((size_t)(tile0 + wg) * nb + b) * H + h) * kW + d] = s;
  }
}

}  // namespace

// dK and dV of key tiles 2 blockIdx.x + warpgroup; gamma partials dgk (NT,
// B, H, 128). At odd NT the last CTA's second warpgroup owns a tile past the
// head: its rows load as zeros, its P and dS are 0 and its stores clip.
template <int NT>
__global__ void __launch_bounds__(kWGroups * 128, 1)
fused_attention_bwd_kv_kernel(const __grid_constant__ CUtensorMap tm_qkv,
                              const __grid_constant__ CUtensorMap tm_do,
                              const __grid_constant__ CUtensorMap tm_dqkv,
                              const bf16* __restrict__ qkv, const bf16* __restrict__ out,
                              const float* __restrict__ lse, const bf16* __restrict__ gq,
                              const bf16* __restrict__ gk, const bf16* __restrict__ cos_t,
                              const bf16* __restrict__ sin_t, float* __restrict__ dgk, int L,
                              int H, float scale) {
  constexpr WideBwdSmem lay(NT, NT * kAtRows);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = at_smem_base(smem_raw);
  unsigned char* ks = smem + lay.own;          // kWGroups K tiles
  unsigned char* vs = ks + kWGroups * kWTile;  // kWGroups V tiles
  unsigned char* qs = smem + lay.sweep;
  unsigned char* dos = qs + NT * kWTile;
  float* lse_s = reinterpret_cast<float*>(smem + lay.lse);
  float* delta_s = reinterpret_cast<float*>(smem + lay.delta);
  float* invk_s = reinterpret_cast<float*>(smem + lay.inv);
  float* dg_s = reinterpret_cast<float*>(smem + lay.dg);  // [8 warps][128]
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + lay.bar);

  const int kt0 = blockIdx.x * kWGroups, h = blockIdx.y, b = blockIdx.z, HD = H * kW;
  const size_t row3 = 3 * (size_t)HD;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, lane = tid % 32;
  const int warp = threadIdx.x / 32, kt = kt0 + wg;

  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  for (int i = threadIdx.x; i < 4 * kWGroups * kW; i += blockDim.x) dg_s[i] = 0.f;
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(bar, (2 * kWGroups + 2 * NT) * kWTile);
    for (int c = 0; c < 2; ++c) {
      for (int w = 0; w < kWGroups; ++w) {
        tma_load_head<kW>(ks + w * kWTile + c * kAtBox, &tm_qkv, bar, H + h, c,
                          (kt0 + w) * kAtRows, b);
        tma_load_head<kW>(vs + w * kWTile + c * kAtBox, &tm_qkv, bar, 2 * H + h, c,
                          (kt0 + w) * kAtRows, b);
      }
      for (int t = 0; t < NT; ++t) {
        tma_load_head<kW>(qs + t * kWTile + c * kAtBox, &tm_qkv, bar, h, c, t * kAtRows, b);
        tma_load_head<kW>(dos + t * kWTile + c * kAtBox, &tm_do, bar, h, c, t * kAtRows, b);
      }
    }
  }
  for (int q = threadIdx.x; q < NT * kAtRows; q += blockDim.x)
    lse_s[q] = q < L ? lse[((size_t)b * H + h) * L + q] * kAtLog2e : INFINITY;
  mbar_wait(bar, 0);
  wide_delta(dos, NT * kAtRows, 0, L, out + (size_t)b * L * HD + h * kW, HD, delta_s);
  norm_rope_tiles<kW>(qs, NT, 0, L, gq, cos_t, sin_t, nullptr);
  norm_rope_tiles<kW>(ks, kWGroups, kt0 * kAtRows, L, gk, cos_t, sin_t, invk_s);
  fence_proxy_async();
  __syncthreads();

  // warpgroup wg: key tile kt, this thread's keys r0, r0 + 8 of it
  unsigned char* kt_tile = ks + wg * kWTile;
  unsigned char* vt_tile = vs + wg * kWTile;
  const int r0 = (tid / 32) * 16 + lane / 4;
  const float c2 = scale * kAtLog2e;
  const float ds_scale = L > 1 ? scale : 0.f;
  const uint64_t kdesc = wgmma_desc(kt_tile, 16, 1024);
  const uint64_t vdesc = wgmma_desc(vt_tile, 16, 1024);
  const bool key0 = kt * kAtRows + r0 < L, key1 = kt * kAtRows + r0 + 8 < L;
  float dk[2][32], dv[2][32];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[c][i] = dv[c][i] = 0.f;

#pragma unroll 1
  for (int j = 0; j < NT; ++j) {
    uint32_t pa[16], da[16];
    {
      float s[32], dp[32];
      const uint64_t qdesc = wgmma_desc(qs + j * kWTile, 16, 1024);
      const uint64_t odesc = wgmma_desc(dos + j * kWTile, 16, 1024);
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kW / 16; ++kk)
        wgmma_m64n64k16_ss(s, kdesc + at_kstep(kk), qdesc + at_kstep(kk), kk);
#pragma unroll
      for (int kk = 0; kk < kW / 16; ++kk)
        wgmma_m64n64k16_ss(dp, vdesc + at_kstep(kk), odesc + at_kstep(kk), kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int q = j * kAtRows + jj * 8 + (lane % 4) * 2;
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
      }
    }
    // dV += P^T dO_j, dK += dS^T Q_j, one chain a column group
    fence_acc(dv);
    fence_acc(dk);
    fence_regs(pa);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const uint64_t ot = wgmma_desc(dos + j * kWTile + c * kAtBox, 1024, 1024);
      const uint64_t qt = wgmma_desc(qs + j * kWTile + c * kAtBox, 1024, 1024);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
        wgmma_m64n64k16_rs_bt(dv[c], a, ot + 128 * kk, 1);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t a[4] = {da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3]};
        wgmma_m64n64k16_rs_bt(dk[c], a, qt + 128 * kk, 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dv);
    fence_acc(dk);
    fence_regs(pa);
    fence_regs(da);
  }

  // dV straight to bf16 through the spent V tile; dK through the norm +
  // RoPE backward and the spent K tile
  float dg[kW / 4];
#pragma unroll
  for (int i = 0; i < kW / 4; ++i) dg[i] = 0.f;
  at_wg_barrier(wg);
  stage_acc<kW>(dv, vt_tile, r0, lane);
  store_tile<kW>(&tm_dqkv, vt_tile, 2 * H + h, kt * kAtRows, b, wg, tid);
  norm_rope_bwd_tile<kW>(dk, kt, r0, lane, L, qkv + (size_t)b * L * row3 + HD + h * kW, row3,
                         invk_s + wg * kAtRows, gk, cos_t, sin_t, kt_tile, dg);
  add_gamma_partials<kW>(dg, dg_s + warp * kW, lane);
  store_tile<kW>(&tm_dqkv, kt_tile, H + h, kt * kAtRows, b, wg, tid);
  wide_gamma_out(dg_s, dgk, kt0, NT, b, gridDim.z, h, H);
}

// dQ of query tiles 2 blockIdx.x + warpgroup; gamma partials dgq (NT, B,
// H, 128); a tile past the head (odd NT) as in the dK/dV launch
template <int NT>
__global__ void __launch_bounds__(kWGroups * 128, 1)
fused_attention_bwd_q_kernel(const __grid_constant__ CUtensorMap tm_qkv,
                             const __grid_constant__ CUtensorMap tm_do,
                             const __grid_constant__ CUtensorMap tm_dqkv,
                             const bf16* __restrict__ qkv, const bf16* __restrict__ out,
                             const float* __restrict__ lse, const bf16* __restrict__ gq,
                             const bf16* __restrict__ gk, const bf16* __restrict__ cos_t,
                             const bf16* __restrict__ sin_t, float* __restrict__ dgq, int L,
                             int H, float scale) {
  constexpr WideBwdSmem lay(NT, kWGroups * kAtRows);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = at_smem_base(smem_raw);
  unsigned char* qs = smem + lay.own;           // kWGroups Q tiles
  unsigned char* dos = qs + kWGroups * kWTile;  // kWGroups dO tiles
  unsigned char* ks = smem + lay.sweep;
  unsigned char* vs = ks + NT * kWTile;
  float* lse_s = reinterpret_cast<float*>(smem + lay.lse);
  float* delta_s = reinterpret_cast<float*>(smem + lay.delta);
  float* invq_s = reinterpret_cast<float*>(smem + lay.inv);
  float* dg_s = reinterpret_cast<float*>(smem + lay.dg);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + lay.bar);

  const int j0 = blockIdx.x * kWGroups, h = blockIdx.y, b = blockIdx.z, HD = H * kW;
  const size_t row3 = 3 * (size_t)HD;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, lane = tid % 32;
  const int warp = threadIdx.x / 32, j = j0 + wg;

  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  for (int i = threadIdx.x; i < 4 * kWGroups * kW; i += blockDim.x) dg_s[i] = 0.f;
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(bar, (2 * kWGroups + 2 * NT) * kWTile);
    for (int c = 0; c < 2; ++c) {
      for (int w = 0; w < kWGroups; ++w) {
        tma_load_head<kW>(qs + w * kWTile + c * kAtBox, &tm_qkv, bar, h, c,
                          (j0 + w) * kAtRows, b);
        tma_load_head<kW>(dos + w * kWTile + c * kAtBox, &tm_do, bar, h, c,
                          (j0 + w) * kAtRows, b);
      }
      for (int t = 0; t < NT; ++t) {
        tma_load_head<kW>(ks + t * kWTile + c * kAtBox, &tm_qkv, bar, H + h, c, t * kAtRows, b);
        tma_load_head<kW>(vs + t * kWTile + c * kAtBox, &tm_qkv, bar, 2 * H + h, c,
                          t * kAtRows, b);
      }
    }
  }
  for (int r = threadIdx.x; r < kWGroups * kAtRows; r += blockDim.x) {
    const int q = j0 * kAtRows + r;
    lse_s[r] = q < L ? lse[((size_t)b * H + h) * L + q] * kAtLog2e : INFINITY;
  }
  mbar_wait(bar, 0);
  wide_delta(dos, kWGroups * kAtRows, j0 * kAtRows, L, out + (size_t)b * L * HD + h * kW, HD,
             delta_s);
  norm_rope_tiles<kW>(qs, kWGroups, j0 * kAtRows, L, gq, cos_t, sin_t, invq_s);
  norm_rope_tiles<kW>(ks, NT, 0, L, gk, cos_t, sin_t, nullptr);
  fence_proxy_async();
  __syncthreads();

  // warpgroup wg: query tile j, this thread's queries r0, r0 + 8 of it
  unsigned char* q_tile = qs + wg * kWTile;
  unsigned char* do_tile = dos + wg * kWTile;
  const int r0 = (tid / 32) * 16 + lane / 4;
  const float c2 = scale * kAtLog2e;
  const float ds_scale = L > 1 ? scale : 0.f;
  const uint64_t qdesc = wgmma_desc(q_tile, 16, 1024);
  const uint64_t odesc = wgmma_desc(do_tile, 16, 1024);
  const int rw = wg * kAtRows + r0;
  const float la = lse_s[rw], lb = lse_s[rw + 8], da0 = delta_s[rw], da1 = delta_s[rw + 8];
  float dq[2][32];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[c][i] = 0.f;

#pragma unroll 1
  for (int t = 0; t < NT; ++t) {
    uint32_t da[16];
    {
      float s[32], dp[32];
      const uint64_t kdesc = wgmma_desc(ks + t * kWTile, 16, 1024);
      const uint64_t vdesc = wgmma_desc(vs + t * kWTile, 16, 1024);
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kW / 16; ++kk)
        wgmma_m64n64k16_ss(s, qdesc + at_kstep(kk), kdesc + at_kstep(kk), kk);
#pragma unroll
      for (int kk = 0; kk < kW / 16; ++kk)
        wgmma_m64n64k16_ss(dp, odesc + at_kstep(kk), vdesc + at_kstep(kk), kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      // P = exp(S scale - lse) (0 past L: keys masked here, queries by lse
      // = +inf), dS = P (dP - delta) scale, in the A-operand layout
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int key = t * kAtRows + jj * 8 + (lane % 4) * 2;
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = key + (e % 2) < L;
          const float p = ok ? at_ex2(fmaf(s[4 * jj + e], c2, -(e < 2 ? la : lb))) : 0.f;
          ds[e] = p * (dp[4 * jj + e] - (e < 2 ? da0 : da1)) * ds_scale;
        }
        da[2 * jj] = at_pack(ds[0], ds[1]);
        da[2 * jj + 1] = at_pack(ds[2], ds[3]);
      }
    }
    // dQ += dS K_t: A from registers, K MN-major, one chain a column group
    fence_acc(dq);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const uint64_t kt_desc = wgmma_desc(ks + t * kWTile + c * kAtBox, 1024, 1024);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t a[4] = {da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3]};
        wgmma_m64n64k16_rs_bt(dq[c], a, kt_desc + 128 * kk, 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dq);
    fence_regs(da);
  }

  // dQ through the norm + RoPE backward and the spent dO tile
  float dg[kW / 4];
#pragma unroll
  for (int i = 0; i < kW / 4; ++i) dg[i] = 0.f;
  at_wg_barrier(wg);
  norm_rope_bwd_tile<kW>(dq, j, r0, lane, L, qkv + (size_t)b * L * row3 + h * kW, row3,
                         invq_s + wg * kAtRows, gq, cos_t, sin_t, do_tile, dg);
  add_gamma_partials<kW>(dg, dg_s + warp * kW, lane);
  store_tile<kW>(&tm_dqkv, do_tile, h, j * kAtRows, b, wg, tid);
  wide_gamma_out(dg_s, dgq, j0, NT, b, gridDim.z, h, H);
}

static_assert(WideBwdSmem(kAtMaxTiles, kAtMaxTiles * kAtRows).total <= kMaxSmem &&
                  WideBwdSmem(kAtMaxTiles, kWGroups * kAtRows).total <= kMaxSmem,
              "the D-128 backward's tiles exceed a block's shared memory");

// ------------------------------------------------------------------- host --

namespace {

template <int D, int NT>
int fwd_launch(const CUtensorMap* maps, const void* gq, const void* gk, const void* cos_t,
               const void* sin_t, void* lse, int B, int L, int H, float scale, void* stream) {
  return (int)launch(fused_attention_fwd_kernel<NT, D>, dim3(H, B), dim3(NT * 128),
                     fwd_smem(NT, AtCfg<D>::kTile), (cudaStream_t)stream, maps[0], maps[1],
                     (const bf16*)gq, (const bf16*)gk, (const bf16*)cos_t, (const bf16*)sin_t,
                     (float*)lse, L, H, scale);
}

template <int D>
int fwd_dispatch(const CUtensorMap* maps, int nt, const void* gq, const void* gk,
                 const void* cos_t, const void* sin_t, void* lse, int B, int L, int H, float scale,
                 void* stream) {
  switch (nt) {
    case 1: return fwd_launch<D, 1>(maps, gq, gk, cos_t, sin_t, lse, B, L, H, scale, stream);
    case 2: return fwd_launch<D, 2>(maps, gq, gk, cos_t, sin_t, lse, B, L, H, scale, stream);
    case 3: return fwd_launch<D, 3>(maps, gq, gk, cos_t, sin_t, lse, B, L, H, scale, stream);
    default: return fwd_launch<D, 4>(maps, gq, gk, cos_t, sin_t, lse, B, L, H, scale, stream);
  }
}

template <int D, int NT>
int bwd_launch(const CUtensorMap* maps, const void* qkv, const void* lse, const void* gq,
               const void* gk, const void* cos_t, const void* sin_t, void* dgq, void* dgk, int B,
               int L, int H, float scale, void* stream) {
  return (int)launch(fused_attention_bwd_kernel<NT, D>, dim3(H, B),
                     dim3(bwd_warpgroups(NT) * 128), AttnBwdSmem(NT, D).total,
                     (cudaStream_t)stream, maps[0], maps[1], maps[2], maps[3], (const bf16*)qkv,
                     (const float*)lse, (const bf16*)gq, (const bf16*)gk, (const bf16*)cos_t,
                     (const bf16*)sin_t, (float*)dgq, (float*)dgk, L, H, scale);
}

template <int D>
int bwd_dispatch(const CUtensorMap* maps, int nt, const void* qkv, const void* lse,
                 const void* gq, const void* gk, const void* cos_t, const void* sin_t, void* dgq,
                 void* dgk, int B, int L, int H, float scale, void* stream) {
  switch (nt) {
    case 1: return bwd_launch<D, 1>(maps, qkv, lse, gq, gk, cos_t, sin_t, dgq, dgk, B, L, H, scale, stream);
    case 2: return bwd_launch<D, 2>(maps, qkv, lse, gq, gk, cos_t, sin_t, dgq, dgk, B, L, H, scale, stream);
    case 3: return bwd_launch<D, 3>(maps, qkv, lse, gq, gk, cos_t, sin_t, dgq, dgk, B, L, H, scale, stream);
    default: return bwd_launch<D, 4>(maps, qkv, lse, gq, gk, cos_t, sin_t, dgq, dgk, B, L, H, scale, stream);
  }
}

template <int NT>
int wide_bwd_launch(const CUtensorMap* maps, const void* qkv, const void* out, const void* lse,
                    const void* gq, const void* gk, const void* cos_t, const void* sin_t,
                    void* dgq, void* dgk, int B, int L, int H, float scale, void* stream) {
  const dim3 grid((NT + kWGroups - 1) / kWGroups, H, B), block(kWGroups * 128);
  int err = (int)launch(fused_attention_bwd_kv_kernel<NT>, grid, block,
                        WideBwdSmem(NT, NT * kAtRows).total, (cudaStream_t)stream, maps[0],
                        maps[1], maps[2], (const bf16*)qkv, (const bf16*)out, (const float*)lse,
                        (const bf16*)gq, (const bf16*)gk, (const bf16*)cos_t, (const bf16*)sin_t,
                        (float*)dgk, L, H, scale);
  if (err != 0) return err;
  return (int)launch(fused_attention_bwd_q_kernel<NT>, grid, block,
                     WideBwdSmem(NT, kWGroups * kAtRows).total, (cudaStream_t)stream, maps[0],
                     maps[1],
                     maps[2], (const bf16*)qkv, (const bf16*)out, (const float*)lse,
                     (const bf16*)gq, (const bf16*)gk, (const bf16*)cos_t, (const bf16*)sin_t,
                     (float*)dgq, L, H, scale);
}

}  // namespace

}  // namespace odt

// lse may be null: the forward then writes only out (no gradient will be taken)
extern "C" int odt_fused_attention_fwd(const void* qkv, const void* gq, const void* gk,
                                       const void* cos_t, const void* sin_t, void* out, void* lse,
                                       int B, int L, int H, int D, float scale, void* stream) {
  using namespace odt;
  if (L < 1 || L > kAtMaxTiles * kAtRows) return (int)cudaErrorInvalidValue;
  if (D != 32 && D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[2];
  cudaError_t err = hopper::tma_map_heads(&maps[0], qkv, D, 3 * (uint64_t)H, L, B, kAtRows);
  if (err == cudaSuccess) err = hopper::tma_map_heads(&maps[1], out, D, H, L, B, kAtRows);
  if (err != cudaSuccess) return (int)err;
  const int nt = (L + kAtRows - 1) / kAtRows;
  switch (D) {
    case 32: return fwd_dispatch<32>(maps, nt, gq, gk, cos_t, sin_t, lse, B, L, H, scale, stream);
    case 64: return fwd_dispatch<64>(maps, nt, gq, gk, cos_t, sin_t, lse, B, L, H, scale, stream);
    default: return fwd_dispatch<128>(maps, nt, gq, gk, cos_t, sin_t, lse, B, L, H, scale, stream);
  }
}

// dgq and dgk hold one (B, H, D) f32 partial at D 32 and 64, and
// ceil(L / 64) of them at D 128 (one per tile); the caller sums them
extern "C" int odt_fused_attention_bwd(const void* qkv, const void* dout, const void* out,
                                       const void* lse, const void* gq, const void* gk,
                                       const void* cos_t, const void* sin_t, void* dqkv,
                                       void* dgq, void* dgk, int B, int L, int H, int D,
                                       float scale, void* stream) {
  using namespace odt;
  if (L < 1 || L > kAtMaxTiles * kAtRows) return (int)cudaErrorInvalidValue;
  if (D != 32 && D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  cudaError_t err = hopper::tma_map_heads(&maps[0], qkv, D, 3 * (uint64_t)H, L, B, kAtRows);
  if (err == cudaSuccess) err = hopper::tma_map_heads(&maps[1], dout, D, H, L, B, kAtRows);
  if (err == cudaSuccess)
    err = hopper::tma_map_heads(&maps[2], dqkv, D, 3 * (uint64_t)H, L, B, kAtRows);
  if (err == cudaSuccess) err = hopper::tma_map_heads(&maps[3], out, D, H, L, B, kAtRows);
  if (err != cudaSuccess) return (int)err;
  const int nt = (L + kAtRows - 1) / kAtRows;
  if (D == 128) {
    switch (nt) {
      case 1: return wide_bwd_launch<1>(maps, qkv, out, lse, gq, gk, cos_t, sin_t, dgq, dgk, B, L, H, scale, stream);
      case 2: return wide_bwd_launch<2>(maps, qkv, out, lse, gq, gk, cos_t, sin_t, dgq, dgk, B, L, H, scale, stream);
      case 3: return wide_bwd_launch<3>(maps, qkv, out, lse, gq, gk, cos_t, sin_t, dgq, dgk, B, L, H, scale, stream);
      default: return wide_bwd_launch<4>(maps, qkv, out, lse, gq, gk, cos_t, sin_t, dgq, dgk, B, L, H, scale, stream);
    }
  }
  if (D == 32)
    return bwd_dispatch<32>(maps, nt, qkv, lse, gq, gk, cos_t, sin_t, dgq, dgk, B, L, H, scale,
                            stream);
  return bwd_dispatch<64>(maps, nt, qkv, lse, gq, gk, cos_t, sin_t, dgq, dgk, B, L, H, scale,
                          stream);
}
