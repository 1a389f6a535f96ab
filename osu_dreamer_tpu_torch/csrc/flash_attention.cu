// Flash attention forward for Hopper over q/k/v that are already normed and
// rotated.
//
// Replaces both Pallas TPU kernels of osu_dreamer_tpu/ops/long_attention.py:
// `_fwd_kernel` (k/v resident in VMEM, L <= 2048) and `_blocked_kernel`
// (online softmax over 512-wide k-blocks, longer L). The resident variant
// exists only for the TPU's VMEM budget; here one online-softmax kernel serves
// every L. Inputs (B, L, H, D) bf16, output packed (B, L, H*D) bf16, at head
// dims D 32, 64 and 128 (one template each). The
// numerics are `_blocked_kernel`'s: f32 logits and softmax, unnormalised
// probabilities rounded to bf16 for P @ V with an f32 accumulator, one
// division by the running denominator at the end, ragged keys masked to
// -1e30.
//
// What bounds it on the H100: 4 L^2 D operations per (batch row, head), on
// the tensor cores, against 4 L D x 2 bytes of q, k, v and out; at the
// sampler's L = 759 that is 380 operations a byte, above the card's ~295, so
// it is bound by operations. The exponentials (L^2 per head, on the 16-wide
// MUFU) cost about as much issue time as the two products at head dim 64,
// twice as much at 32 (twice the heads at the same H D).
// What the design does (hopper.cuh holds the primitives):
// - one CTA per (192 queries, head, batch row): three consumer warpgroups of
//   64 query rows each, and one producer warp; at 109 registers a thread
//   (D 64) one CTA fits an SM;
// - every tile is 64 bf16 columns (128 bytes) wide, a head D / 64 tiles side
//   by side (kCG column groups): q, k, v and out are 3-D tensor maps
//   (H*D, L, B) with 128-byte swizzle at D 64 and 128; at D 32 a 4-D map
//   (D, H, L, B) whose 64-column box zero-fills columns 32..63 on a load and
//   leaves them unwritten on the store, so the D-32 head runs the D-64
//   tile code with half its P V columns zero; rows past L are zero-filled
//   inside batch row b, never read from row b + 1, and the output store
//   clips at L;
// - the producer keeps a ring of kFaStages 64-key K/V tiles in flight with
//   TMA, on full / empty mbarriers; Q is loaded once;
// - S = Q K^T and O += P V run on wgmma (bf16 in, f32 accumulate): Q and K
//   K-major from shared memory (D / 16 k-steps, four a column group), P
//   from registers (the S accumulator rounded to bf16 is the A-operand
//   layout), V MN-major with the transpose bit, one m64n64 chain and one
//   64-column accumulator per column group (two at D 128);
//   each warpgroup issues tile t's S together with tile t-1's P V, so its
//   softmax of tile t runs while the tensor cores finish P V;
// - the softmax stays in registers: a row is shared by the four threads of a
//   quad (two shuffles), one FFMA and one ex2 per probability with
//   scale * log2(e) folded in, the mask only in the last, ragged key tile; O
//   is rescaled in registers;
// - the epilogue scales by 1 / l, writes bf16 into the warpgroup's (spent) Q
//   tile in the swizzled layout and stores it with one TMA store.
#include "common.cuh"
#include "hopper.cuh"

namespace odt {

using namespace hopper;

constexpr int kFaRows = 64;      // query rows per consumer warpgroup
constexpr int kFaConsumers = 3;  // consumer warpgroups per CTA
constexpr int kFaBQ = kFaRows * kFaConsumers;
constexpr int kFaBK = 64;        // keys per K/V tile
constexpr int kFaStages = 4;
constexpr int kFaThreads = kFaConsumers * 128 + 32;
constexpr int kFaNS = kFaBK / 2;  // S accumulator registers a thread
constexpr float kFaNeg = -1e30f;
constexpr uint32_t kFaBox = 64 * 64 * sizeof(bf16);  // one swizzled 64 x 64 tile
static_assert(kFaBK == 64 && kFaRows == 64,
              "one 64 x 64 box and m64n64 wgmmas serve every tile");

// the layout at head dim D: kCG 64-column groups a head (D 32 pads to one)
template <int D>
struct FaCfg {
  static_assert(D == 32 || D == 64 || D == 128, "head dims 32, 64 and 128");
  static constexpr int kCG = D < 64 ? 1 : D / 64;
  static constexpr int kKSteps = D / 16;                // k16 steps of Q K^T
  static constexpr uint32_t kQBytes = kCG * kFaBox;     // one warpgroup's Q (or O)
  static constexpr uint32_t kKVBytes = kCG * kFaBox;    // one K or V tile
  static constexpr size_t kQOff = 0;
  static constexpr size_t kKOff = kQOff + kFaConsumers * kQBytes;
  static constexpr size_t kVOff = kKOff + kFaStages * kKVBytes;
  static constexpr size_t kBarOff = kVOff + kFaStages * kKVBytes;
  // + 1024 so the base can be rounded up to the swizzle atom
  static constexpr size_t kSmem = kBarOff + (2 * kFaStages + 1) * sizeof(uint64_t) + 1024;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the MUFU unit alone (a denormal result flushes to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// a barrier over the 128 threads of consumer warpgroup wg (ids 1, 2, 3)
__device__ __forceinline__ void warpgroup_barrier(int wg) {
  static_assert(kFaConsumers <= 3, "one named barrier per consumer warpgroup");
  if (wg == 0) named_barrier<1, 128>();
  else if (wg == 1) named_barrier<2, 128>();
  else named_barrier<3, 128>();
}

// S = Q K^T (64 x 64) into sc: both K-major, k16 steps 32 bytes apart inside
// a column group, the next group kFaBox bytes on (in 16-byte units)
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[kFaNS], uint64_t qdesc, const void* ktile) {
  const uint64_t kdesc = wgmma_desc(ktile, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < FaCfg<D>::kKSteps; ++kk) {
    const uint64_t at = (kk / 4) * (kFaBox >> 4) + 2 * (kk % 4);
    wgmma_m64n64k16_ss(sc, qdesc + at, kdesc + at, kk);
  }
  wgmma_commit();
}

// O += P V: P from registers, V MN-major (transpose bit), k16 steps 16 rows
// = 2048 bytes apart; SBO is the 1024-byte stride of 8-key groups (LBO,
// the stride of 64-column groups, is never used: each column group of V is
// its own 64 x 64 tile and its own m64n64 chain into o[c])
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[FaCfg<D>::kCG][32],
                                         const uint32_t (&p)[kFaNS / 2], const void* vtile) {
#pragma unroll
  for (int c = 0; c < FaCfg<D>::kCG; ++c) {
    const uint64_t vdesc =
        wgmma_desc(static_cast<const unsigned char*>(vtile) + c * kFaBox, 1024, 1024);
#pragma unroll
    for (int kk = 0; kk < kFaBK / 16; ++kk) {
      const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
      wgmma_m64n64k16_rs_bt(o[c], a, vdesc + 128 * kk, 1);
    }
  }
  wgmma_commit();
}

template <int D>
__device__ __forceinline__ void fence_o(float (&o)[FaCfg<D>::kCG][32]) {
#pragma unroll
  for (int c = 0; c < FaCfg<D>::kCG; ++c) fence_regs(o[c]);
}

// the online softmax of key tile t over this thread's rows r0 (even pairs
// of sc) and r0 + 8 (odd pairs): keys past L in the last tile are masked to
// -1e30, m0 / m1 are the running maxima of the raw logits q.k, and sc
// becomes the unnormalised probabilities exp2((s - m) * scale * log2(e)),
// one FFMA and one ex2 each. Returns each row's rescale factor for the
// earlier tiles (0 on the first) and this thread's share of the row sums.
struct RowStep {
  float a0, a1, s0, s1;
};

__device__ __forceinline__ RowStep softmax_tile(float (&sc)[kFaNS], float& m0, float& m1, int t,
                                                int ntiles, int L, int lane, float scale_log2) {
  if (t == ntiles - 1 && L % kFaBK) {
    const int lim = L - t * kFaBK;
#pragma unroll
    for (int i = 0; i < kFaNS; ++i)
      if ((i / 4) * 8 + (lane % 4) * 2 + (i % 2) >= lim) sc[i] = kFaNeg;
  }
  float mx0 = kFaNeg, mx1 = kFaNeg;
#pragma unroll
  for (int j = 0; j < kFaNS / 4; ++j) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  mx0 = fmaxf(m0, quad_max(mx0));
  mx1 = fmaxf(m1, quad_max(mx1));
  RowStep r{ex2((m0 - mx0) * scale_log2), ex2((m1 - mx1) * scale_log2), 0.f, 0.f};
  m0 = mx0;
  m1 = mx1;
  const float b0 = -m0 * scale_log2, b1 = -m1 * scale_log2;
#pragma unroll
  for (int j = 0; j < kFaNS / 4; ++j) {
    sc[4 * j] = ex2(fmaf(sc[4 * j], scale_log2, b0));
    sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], scale_log2, b0));
    sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], scale_log2, b1));
    sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], scale_log2, b1));
    r.s0 += sc[4 * j] + sc[4 * j + 1];
    r.s1 += sc[4 * j + 2] + sc[4 * j + 3];
  }
  return r;
}

// P in bf16 for the product, in the A-operand layout (the accumulator's)
__device__ __forceinline__ void pack_p(uint32_t (&p)[kFaNS / 2], const float (&sc)[kFaNS]) {
#pragma unroll
  for (int j = 0; j < kFaNS / 2; ++j) p[j] = pack_bf16(sc[2 * j], sc[2 * j + 1]);
}

template <int D>
__global__ void __launch_bounds__(kFaThreads, 1)
flash_attention_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_o, int L, float scale_log2) {
  using Cfg = FaCfg<D>;
  constexpr int kCG = Cfg::kCG;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Cfg::kBarOff);
  uint64_t* empty = full + kFaStages;
  uint64_t* qbar = empty + kFaStages;

  const int q0 = blockIdx.x * kFaBQ, h = blockIdx.y, b = blockIdx.z;
  const int ntiles = (L + kFaBK - 1) / kFaBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kFaStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kFaConsumers * 4);  // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kFaConsumers) {
    // producer: one thread issues every load (a zero-filled box counts its
    // full bytes)
    if (threadIdx.x % 32 == 0) {
      mbar_arrive_expect_tx(qbar, kFaConsumers * Cfg::kQBytes);
      for (int w = 0; w < kFaConsumers; ++w)
        for (int c = 0; c < kCG; ++c)
          tma_load_head<D>(smem + Cfg::kQOff + w * Cfg::kQBytes + c * kFaBox, &tm_q, qbar, h, c,
                           q0 + w * kFaRows, b);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % kFaStages;
        if (t >= kFaStages) mbar_wait(&empty[s], (t / kFaStages - 1) & 1);
        mbar_arrive_expect_tx(&full[s], 2 * Cfg::kKVBytes);
        for (int c = 0; c < kCG; ++c) {
          tma_load_head<D>(smem + Cfg::kKOff + s * Cfg::kKVBytes + c * kFaBox, &tm_k, &full[s],
                           h, c, t * kFaBK, b);
          tma_load_head<D>(smem + Cfg::kVOff + s * Cfg::kKVBytes + c * kFaBox, &tm_v, &full[s],
                           h, c, t * kFaBK, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows q0 + 64 wg + [0, 64)
  const int tid = threadIdx.x % 128, lane = tid % 32;
  const int r0 = (tid / 32) * 16 + lane / 4;  // this thread's rows: r0 and r0 + 8
  unsigned char* qtile = smem + Cfg::kQOff + wg * Cfg::kQBytes;
  const uint64_t qdesc = wgmma_desc(qtile, 16, 1024);
  auto ktile = [&](int t) { return smem + Cfg::kKOff + (t % kFaStages) * Cfg::kKVBytes; };
  auto vtile = [&](int t) { return smem + Cfg::kVOff + (t % kFaStages) * Cfg::kKVBytes; };

  float o[kCG][32], sc[kFaNS];
  uint32_t p[kFaNS / 2];
#pragma unroll
  for (int c = 0; c < kCG; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
#pragma unroll
  for (int i = 0; i < kFaNS; ++i) sc[i] = 0.f;
  float m0 = kFaNeg, m1 = kFaNeg;  // running maxima of the raw logits of rows r0, r0 + 8

  mbar_wait(qbar, 0);
  mbar_wait(&full[0], 0);
  fence_regs(sc);
  wgmma_fence();
  issue_qk<D>(sc, qdesc, ktile(0));
  wgmma_wait<0>();
  fence_regs(sc);
  RowStep rs = softmax_tile(sc, m0, m1, 0, ntiles, L, lane, scale_log2);
  float l0 = rs.s0, l1 = rs.s1;  // this thread's share of the row sums
  pack_p(p, sc);

  for (int t = 1; t < ntiles; ++t) {
    mbar_wait(&full[t % kFaStages], (t / kFaStages) & 1);
    fence_regs(sc);
    fence_o<D>(o);
    fence_regs(p);
    wgmma_fence();
    issue_qk<D>(sc, qdesc, ktile(t));
    issue_pv<D>(o, p, vtile(t - 1));
    wgmma_wait<1>();  // S of tile t is done, P V of tile t-1 may still run
    fence_regs(sc);
    rs = softmax_tile(sc, m0, m1, t, ntiles, L, lane, scale_log2);
    wgmma_wait<0>();
    fence_o<D>(o);
    fence_regs(p);
    __syncwarp();  // this warp no longer reads stage t-1
    if (lane == 0) mbar_arrive(&empty[(t - 1) % kFaStages]);
    l0 = l0 * rs.a0 + rs.s0;
    l1 = l1 * rs.a1 + rs.s1;
#pragma unroll
    for (int c = 0; c < kCG; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[c][4 * j] *= rs.a0;
        o[c][4 * j + 1] *= rs.a0;
        o[c][4 * j + 2] *= rs.a1;
        o[c][4 * j + 3] *= rs.a1;
      }
    pack_p(p, sc);
  }
  fence_o<D>(o);
  fence_regs(p);
  wgmma_fence();
  issue_pv<D>(o, p, vtile(ntiles - 1));
  wgmma_wait<0>();
  fence_o<D>(o);
  fence_regs(p);

  // epilogue: O / l in bf16 into the Q tile (swizzled) once every warp of
  // the warpgroup is past its last product, then one TMA store a column group
  const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);
  warpgroup_barrier(wg);
#pragma unroll
  for (int c = 0; c < kCG; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j * 8 + (lane % 4) * 2;
      *reinterpret_cast<uint32_t*>(qtile + c * kFaBox + swizzle128(r0, col)) =
          pack_bf16(o[c][4 * j] * inv0, o[c][4 * j + 1] * inv0);
      *reinterpret_cast<uint32_t*>(qtile + c * kFaBox + swizzle128(r0 + 8, col)) =
          pack_bf16(o[c][4 * j + 2] * inv1, o[c][4 * j + 3] * inv1);
    }
  fence_proxy_async();
  warpgroup_barrier(wg);
  if (tid == 0) {
    for (int c = 0; c < kCG; ++c)
      tma_store_head<D>(&tm_o, qtile + c * kFaBox, h, c, q0 + wg * kFaRows, b);
    tma_store_commit_and_wait();
  }
}

template <int D>
int flash_attention_launch(const void* q, const void* k, const void* v, void* out, int B, int L,
                           int H, float scale, void* stream) {
  CUtensorMap maps[4];
  const void* bases[4] = {q, k, v, out};
  for (int i = 0; i < 4; ++i) {
    cudaError_t err = hopper::tma_map_heads(&maps[i], bases[i], D, H, L, B, kFaBK);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((L + kFaBQ - 1) / kFaBQ, H, B);
  return (int)launch(flash_attention_fwd_kernel<D>, grid, dim3(kFaThreads), FaCfg<D>::kSmem,
                     (cudaStream_t)stream, maps[0], maps[1], maps[2], maps[3], L,
                     scale * 1.4426950408889634f);
}

}  // namespace odt

extern "C" int odt_flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                       int B, int L, int H, int D, float scale, void* stream) {
  using namespace odt;
  switch (D) {
    case 32: return flash_attention_launch<32>(q, k, v, out, B, L, H, scale, stream);
    case 64: return flash_attention_launch<64>(q, k, v, out, B, L, H, scale, stream);
    case 128: return flash_attention_launch<128>(q, k, v, out, B, L, H, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
