// The long attention backward for Hopper at padded head dims up to 128: one
// pass over each (batch row, head) that forms S and dP once per (query
// tile, key tile).
//
// Replaces no Pallas kernel. It is the training counterpart of K7/K8
// (osu_dreamer_tpu/ops/long_attention.py `_fwd_kernel`, `_blocked_kernel`)
// past the JAX fused-attention gate, where the JAX package differentiates
// its Pallas forward with XLA (long_attention.py `_vjp_bwd`, the vjp of
// `_xla_reference`): the shipped 16 x 64 heads trained at L 320. Past
// Dp 128 attention_stream.cu's `odt_attention_stream_bwd` (a delta pass,
// then K10's streamed dK/dV and dQ launches) still runs.
//
// What bounds it on the H100: 10 L^2 D operations per (batch row, head) on
// the tensor cores (S^T, dP^T, dV, dK, dQ) against q, k, v, out, dO and lse
// read and dq, dk, dv written once in bf16: at L 320 and D 64 about 90
// operations a byte, below the card's ~295, so bytes; at L 2500 (about 700
// a byte) operations.
//
// Design. A work item is a block of 128 key rows of one (batch row, head),
// its K and V held in shared memory. Two consumer warpgroups each own 64 of
// those keys end to end (FA3's split: nothing of P^T crosses between
// warpgroups), and the producer warpgroup's first warp streams each query
// tile's Q, dO, lse and delta through a ring. For each query tile a
// consumer forms S^T = K Q^T and dP^T = V dO^T once, P^T = exp(S^T scale -
// lse) and dS^T = P^T (dP^T - delta) scale (each rounded once to bf16),
// accumulates dV += P^T dO and dK += dS^T Q in registers, stores dS^T in
// shared memory and forms the tile's dQ partial from it: 10 L^2 D units of
// products, K and V read once. At Dp <= 64 (one 64-column box) the partial
// is dS K over the warpgroup's own keys, and the S^T / dV products overlap
// the elementwise work. At two boxes dK and dV take 128 registers, so S^T
// and dP^T are formed for 32 queries at a time (n 32), and each consumer
// forms its own box of dS K over all 128 keys from both dS^T tiles (one
// barrier of the two a tile). dK and dV leave in bf16 into dqkv.
// dQ. The block's part of a query tile goes through shared memory in f32
// (at one box the second consumer adds the first's partial to its own, at
// two each consumer writes its box) to one thread of the producer
// warpgroup, which, once the tile's counter reads kb (every lower key
// block has added its part), stores it (block 0) or adds it at L2 (the
// middle blocks) with one TMA bulk copy, waits for that to complete and
// advances the counter. One block at a time adds to a tile, in key-block
// order, and no float atomics run unordered: a rerun is bit-identical. The
// last block reads the accumulator back (a bulk load), and two warps of the
// producer warpgroup add its part and write dQ in bf16 into dqkv. Items come in bands of `grid` (batch row, head) pairs
// with the key block slowest, so that where a band is full one CTA takes
// every block of its pair in turn; the grid is no larger than the CTAs the
// card holds at once (one an SM), so a block only ever waits on a lower
// block of its pair, which an item claimed earlier holds.
// Why 128 key rows an item: Q, dO, lse and delta are streamed once per 128
// keys, not per 64, and each query tile's accumulator is passed ceil(L /
// 128) times. At L 320 the third item holds 64 keys, and its second
// warpgroup computes on zero-filled rows.
// Every product contracts over whole 64-column boxes (TMA zero-fills the
// box past Dp) and runs at n 64 or 32 throughout, so no wgmma is issued
// under a branch.
// The delta pass (delta = rowsum(dO O), dO copied padded where Dp != D, the
// counters zeroed) stays a launch of its own: every key block of a (batch
// row, head) reads each query tile's delta, so computing it at a tile's
// first use would need a second cross-CTA handover.
#include "attention_rows.cuh"
#include "common.cuh"
#include "hopper.cuh"

namespace odt {

using namespace hopper;

namespace {

constexpr int kLbRows = 64;                               // rows of a box; keys a consumer owns
constexpr uint32_t kLbBox = kLbRows * 64 * sizeof(bf16);  // 8 KB, one swizzled 64 x 64 box
constexpr int kLbConsumers = 2;                           // consumer warpgroups a CTA
constexpr int kLbItemRows = kLbConsumers * kLbRows;       // key rows a work item
constexpr int kLbThreads = (kLbConsumers + 1) * 128;
constexpr int kLbWriters = 2;  // warps of the producer warpgroup that write the last block's dQ
constexpr int kLbMaxStages = 4;
// shared memory for tiles and ring: a block's, less the base's alignment
// and room for the barriers
constexpr uint32_t kLbCap = (uint32_t)kMaxSmem - 1024 - 256;
constexpr float kLbLog2e = 1.4426950408889634f;

constexpr int lb_min(int a, int b) { return a < b ? a : b; }

// The plan at NB boxes a head (Dp <= 64: 1, else 2): an item's K and V
// (two copies where the rest still fits beside them, so the next item's
// load lands while this one runs), the consumers' dS^T tiles (two sets at
// two boxes, where each consumer reads the other's), one query tile's dQ
// part in f32, the image of its accumulator (two buffers where they fit: at
// one box the second consumer adds the first's partial to its own there;
// at two each consumer writes its box), a tile's accumulator read back (the
// last key block), then a ring of stages of a query tile's Q and dO, and
// its lse and delta
template <int NB>
struct LbPlan {
  static constexpr uint32_t kTile = NB * kLbBox;                     // 64 rows of a head
  static constexpr uint32_t kHeld = 2 * kLbConsumers * kTile;        // K and V of an item
  static constexpr uint32_t kDs = NB * kLbConsumers * kLbBox;        // the dS^T tiles
  static constexpr uint32_t kDq = NB * 32 * 128 * 4;                 // a tile's dQ part, f32
  static constexpr uint32_t kAcc = kDq;                              // its accumulator
  static constexpr uint32_t kStage = 2 * kTile;                      // Q and dO
  static constexpr uint32_t kRows = 2 * kLbRows * 4;                 // lse and delta
  static constexpr uint32_t kFixed = kDs + kAcc;
  static constexpr int kHold =
      kLbCap >= 2 * kHeld + kFixed + 2 * kDq + 2 * (kStage + kRows) ? 2 : 1;
  static constexpr int kDqBufs =
      kLbCap >= kHold * kHeld + kFixed + 2 * kDq + 2 * (kStage + kRows) ? 2 : 1;
  static constexpr int kStages = lb_min(
      kLbMaxStages, (int)((kLbCap - kHold * kHeld - kFixed - kDqBufs * kDq) / (kStage + kRows)));
  static constexpr uint32_t kDsOff = kHold * kHeld;
  static constexpr uint32_t kDqOff = kDsOff + kDs;
  static constexpr uint32_t kAccOff = kDqOff + kDqBufs * kDq;
  static constexpr uint32_t kRingOff = kAccOff + kAcc;
  static constexpr uint32_t kRowsOff = kRingOff + kStages * kStage;
  static constexpr uint32_t kBarOff = kRowsOff + kStages * kRows;
  static constexpr size_t kSmem = kBarOff + (2 * kStages + 13) * sizeof(uint64_t) + 1024;
  static_assert(kStages >= 2 && kSmem <= kMaxSmem, "K, V, dS^T, the dQ partials and two stages fit");
  // registers the producer warpgroup hands the consumers (setmaxnreg): a
  // consumer holds dK and dV (2 NB accumulators of 32), S^T and dP^T (two of
  // 32 at one box; a half tile's two of 16 at two), P^T or dS^T in bf16
  // and its addresses
  static constexpr int kProducerRegs = NB == 1 ? 64 : 40;
  static constexpr int kConsumerRegs = NB == 1 ? 216 : 232;
  // the writing warps' float4s in flight a thread
  static constexpr int kUnroll = NB == 1 ? 4 : 2;
  static_assert(kProducerRegs * 128 + kConsumerRegs * kLbConsumers * 128 <= 65536, "registers");
};

// a wait that traps (a launch error) instead of hanging when a phase never
// completes: every wait here is met within microseconds unless the
// kernel is at fault
__device__ __forceinline__ void lb_wait(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 33)) __trap();
  }
}

__device__ __forceinline__ int lb_ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void lb_st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// until the counter reads `want` (the lower key block has added its part)
__device__ __forceinline__ void lb_wait_count(const int* p, int want) {
  const long long t0 = clock64();
  while (lb_ld_acquire(p) != want) {
    if (clock64() - t0 > (1ll << 33)) __trap();
    __nanosleep(32);
  }
}

// ---- one-thread bulk copies between shared and global memory (TMA) ----

// `bytes` of global memory into shared memory, counted on `bar`
__device__ __forceinline__ void lb_bulk_load(void* dst, const void* src, uint32_t bytes,
                                             uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// shared memory into global memory, stored (`add` false) or added element by
// element at L2 (`add` true); committed as one bulk group
__device__ __forceinline__ void lb_bulk_store(void* dst, const void* src, uint32_t bytes,
                                              bool add) {
  if (add)
    asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;" ::
                     "l"(dst), "r"(smem_u32(src)), "r"(bytes)
                 : "memory");
  else
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
                 "r"(smem_u32(src)), "r"(bytes)
                 : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// order this thread's generic-proxy global accesses with its bulk copies
__device__ __forceinline__ void lb_fence_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

// The work item `item` -> (key block kb, batch row x head bh). Items come in
// bands of `grid` (batch row, head) pairs, key block slowest within a band:
// where a band is full, the CTA that takes its pair's block 0 takes every
// block of it in turn, so its dQ accumulator passes from block to block
// inside one CTA; a band of fewer pairs (the last, or all when the pairs are
// fewer than the CTAs) spreads each pair's blocks over several. Either way
// block kb of a pair comes grid or `pairs` items after block kb - 1.
__device__ __forceinline__ void lb_item(int item, int nkb, int BH, int grid, int& kb, int& bh) {
  const int band = item / (nkb * grid), first = band * grid;
  const int pairs = min(grid, BH - first), r = item - band * nkb * grid;
  kb = r / pairs;
  bh = first + r % pairs;
}

__device__ __forceinline__ float4 lb_add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// a 64-row tile of NB boxes (box c: columns 64 c.. of head h, rows row..,
// batch row b) through a 4-D (Dp, H, L, B) map
template <int NB>
__device__ __forceinline__ void load_tile(unsigned char* dst, const CUtensorMap* map,
                                          uint64_t* bar, int h, int row, int b) {
#pragma unroll
  for (int c = 0; c < NB; ++c) tma_load_4d(dst + c * kLbBox, map, bar, 64 * c, h, row, b);
}

// acc = A B^T over the NB boxes of two 64-row tiles (both K-major); issued
// and committed
template <int NB>
__device__ __forceinline__ void issue_abt(float (&acc)[32], const unsigned char* a,
                                          const unsigned char* b) {
  const uint64_t ad = wgmma_desc(a, 16, 1024), bd = wgmma_desc(b, 16, 1024);
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t at = c * (kLbBox >> 4) + 2 * kk;
      wgmma_m64n64k16_ss(acc, ad + at, bd + at, (c | kk) ? 1 : 0);
    }
  wgmma_commit();
}

// acc[c] += A B_c for the NB boxes of a 64-row tile (A 64 x 64 bf16 pairs
// in the accumulator's layout, from registers; box c read MN-major, its rows
// the reduced dimension); issued and committed
template <int NB>
__device__ __forceinline__ void issue_rs(float (&acc)[NB][32], const uint32_t (&a)[16],
                                         const unsigned char* b) {
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    const uint64_t bd = wgmma_desc(b + c * kLbBox, 1024, 1024);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t ak[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3]};
      wgmma_m64n64k16_rs_bt(acc[c], ak, bd + 128 * kk, 1);
    }
  }
  wgmma_commit();
}

// dq (+)= dS K_c: A a dS^T tile (keys rows, queries columns: MN-major), B
// a box of a K tile MN-major; issued, not committed
__device__ __forceinline__ void issue_dq(float (&dq)[32], const unsigned char* ds,
                                         const unsigned char* kbox, bool accumulate) {
  const uint64_t ad = wgmma_desc(ds, 1024, 1024), bd = wgmma_desc(kbox, 1024, 1024);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n64k16_ss_tt(dq, ad + 128 * kk, bd + 128 * kk, (accumulate || kk) ? 1 : 0);
}

// acc = A B^T over the NB boxes of two 64-row tiles (both K-major), B's rows
// 32 hq .. 32 hq + 31 only (n 32); issued and committed
template <int NB>
__device__ __forceinline__ void issue_abt_half(float (&acc)[16], const unsigned char* a,
                                               const unsigned char* b, int hq) {
  const uint64_t ad = wgmma_desc(a, 16, 1024), bd = wgmma_desc(b + hq * 32 * 128, 16, 1024);
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t at = c * (kLbBox >> 4) + 2 * kk;
      wgmma_m64n32k16_ss(acc, ad + at, bd + at, (c | kk) ? 1 : 0);
    }
  wgmma_commit();
}

// acc[c] += A B_c over the reduced rows 32 hq .. 32 hq + 31 of box c (A the
// 64 x 32 bf16 pairs of an n 32 accumulator, from registers; B MN-major);
// issued and committed
template <int NB>
__device__ __forceinline__ void issue_rs_half(float (&acc)[NB][32], const uint32_t (&a)[8],
                                              const unsigned char* b, int hq) {
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    const uint64_t bd = wgmma_desc(b + c * kLbBox, 1024, 1024);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint32_t ak[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3]};
      wgmma_m64n64k16_rs_bt(acc[c], ak, bd + 128 * (2 * hq + kk), 1);
    }
  }
  wgmma_commit();
}

// P^T = exp(S^T scale - lse) in place over an accumulator of N / 4 column
// steps whose first query is q0 (rs: the stage's lse x log2 e, +inf past
// L); 0 for keys past L
template <int N>
__device__ __forceinline__ void p_tile(float (&x)[N], const float* rs, int q0, bool key0,
                                       bool key1, int lane, float c2) {
#pragma unroll
  for (int jj = 0; jj < N / 4; ++jj) {
    const float2 l = *reinterpret_cast<const float2*>(rs + q0 + 8 * jj + 2 * (lane % 4));
    x[4 * jj] = key0 ? st_ex2(fmaf(x[4 * jj], c2, -l.x)) : 0.f;
    x[4 * jj + 1] = key0 ? st_ex2(fmaf(x[4 * jj + 1], c2, -l.y)) : 0.f;
    x[4 * jj + 2] = key1 ? st_ex2(fmaf(x[4 * jj + 2], c2, -l.x)) : 0.f;
    x[4 * jj + 3] = key1 ? st_ex2(fmaf(x[4 * jj + 3], c2, -l.y)) : 0.f;
  }
}

// dS^T = P^T (dP^T - delta) scale in place over dP^T (dl: the stage's delta)
template <int N>
__device__ __forceinline__ void ds_tile(float (&dp)[N], const float (&p)[N], const float* dl,
                                        int q0, int lane, float ds_scale) {
#pragma unroll
  for (int jj = 0; jj < N / 4; ++jj) {
    const float2 d = *reinterpret_cast<const float2*>(dl + q0 + 8 * jj + 2 * (lane % 4));
    dp[4 * jj] = p[4 * jj] * (dp[4 * jj] - d.x) * ds_scale;
    dp[4 * jj + 1] = p[4 * jj + 1] * (dp[4 * jj + 1] - d.y) * ds_scale;
    dp[4 * jj + 2] = p[4 * jj + 2] * (dp[4 * jj + 2] - d.x) * ds_scale;
    dp[4 * jj + 3] = p[4 * jj + 3] * (dp[4 * jj + 3] - d.y) * ds_scale;
  }
}

// dS^T's bf16 pairs (NP of them: 64 or 32 queries from q0) into a swizzled
// 64 x 64 tile, keys rows and queries columns
template <int NP>
__device__ __forceinline__ void store_ds(unsigned char* tile, const uint32_t (&a)[NP], int r0,
                                         int q0, int lane) {
#pragma unroll
  for (int jj = 0; jj < NP / 2; ++jj) {
    const int col = q0 + jj * 8 + (lane % 4) * 2;
    *reinterpret_cast<uint32_t*>(tile + swizzle128(r0, col)) = a[2 * jj];
    *reinterpret_cast<uint32_t*>(tile + swizzle128(r0 + 8, col)) = a[2 * jj + 1];
  }
}

// the bf16 pairs of the A operand from an accumulator's f32 values
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 2], const float (&x)[N]) {
#pragma unroll
  for (int j = 0; j < N / 2; ++j) a[j] = st_pack(x[2 * j], x[2 * j + 1]);
}

}  // namespace

// dq, dk, dv (bf16, into dqkv's q, k and v columns) of work items of 128 key
// rows (block kb of head h, batch row b; kb fastest). A CTA an SM takes
// items blockIdx.x, + gridDim.x, ...; the Q/dO ring runs on across items.
// Warpgroups 0 and 1 consume, warpgroup 2 produces: its first warp loads
// (one lane issues the TMA loads, the warp stages lse and delta), its other
// three add the dQ partials.
template <int NB>
__global__ void __launch_bounds__(kLbThreads, 1)
long_attention_bwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dq_acc, int* __restrict__ counters,
                          bf16* __restrict__ dqkv, int L, int H, int De, int items,
                          float scale) {
  using P = LbPlan<NB>;
  constexpr int S = P::kStages;
  constexpr int kPart = 8 * 128;      // float4s of a warpgroup's 64 x 64 f32 dQ partial
  constexpr int kImage = NB * kPart;  // float4s of a tile's dQ part: its accumulator's image
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = st_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::kBarOff);
  uint64_t* empty = full + S;
  uint64_t* kvfull = empty + S;  // kHold each: the copies of K and V
  uint64_t* kvempty = kvfull + 2;
  uint64_t* dqfull = kvempty + 2;  // kDqBufs each: the dQ partials' buffers
  uint64_t* dqempty = dqfull + 2;
  uint64_t* dqsum = dqempty + 2;  // a buffer's image seen by the writing warps
  uint64_t* dqacc = dqsum + 2;    // the accumulator read back (the last key block)
  uint64_t* dqhalf = dqacc + 1;   // one box: the first consumer's partial written
  float* rows = reinterpret_cast<float*>(smem + P::kRowsOff);  // a stage's lse x log2 e, delta
  float4* parts = reinterpret_cast<float4*>(smem + P::kDqOff);
  float4* accs = reinterpret_cast<float4*>(smem + P::kAccOff);  // the accumulator read back
  auto qtile = [&](int s) { return smem + P::kRingOff + s * P::kStage; };
  auto dotile = [&](int s) { return smem + P::kRingOff + s * P::kStage + P::kTile; };
  const int nq = (L + kLbRows - 1) / kLbRows, nkb = (L + kLbItemRows - 1) / kLbItemRows;
  const int BH = items / nkb;  // (batch row, head) pairs
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA lane's, and each lane's once it staged its rows
      mbar_init(&empty[s], 4 * kLbConsumers);  // one arrival per consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&kvfull[i], 1);
      mbar_init(&kvempty[i], 4 * kLbConsumers);
      mbar_init(&dqfull[i], 4 * kLbConsumers);
      mbar_init(&dqempty[i], kLbWriters + 1);  // the writing warps and the bulk thread
      mbar_init(&dqsum[i], kLbWriters);
      mbar_init(&dqhalf[i], 4);
    }
    mbar_init(dqacc, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kLbConsumers) {
    setmaxnreg_dec<P::kProducerRegs>();
    const int warp = threadIdx.x % 128 / 32;
    if (warp == 0) {
      // the loads; g counts the query tiles of every item so far. Each
      // lane stages two queries' lse (x log2 e, +inf past L) and delta (0
      // past L), fetched a tile ahead so the loads fly while the ring waits
      float nl[2], nd[2];
      auto fetch = [&](int bh, int j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = j * kLbRows + e * 32 + lane;
          nl[e] = q < L ? lse[(size_t)bh * L + q] * kLbLog2e : INFINITY;
          nd[e] = q < L ? delta[(size_t)bh * L + q] : 0.f;
        }
      };
      int kb, bh;
      if ((int)blockIdx.x < items) {
        lb_item(blockIdx.x, nkb, BH, gridDim.x, kb, bh);
        fetch(bh, 0);
      }
      int g = 0, n = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
        lb_item(item, nkb, BH, gridDim.x, kb, bh);
        const int h = bh % H, b = bh / H;
        const int hc = n % P::kHold;  // the copy of K and V
        if (lane == 0) {
          if (n >= P::kHold) lb_wait(&kvempty[hc], (n / P::kHold - 1) & 1);
          mbar_arrive_expect_tx(&kvfull[hc], P::kHeld);
          unsigned char* kv = smem + hc * P::kHeld;
          for (int w = 0; w < kLbConsumers; ++w) {
            const int row = kb * kLbItemRows + w * kLbRows;
            load_tile<NB>(kv + w * P::kTile, &tm_k, &kvfull[hc], h, row, b);
            load_tile<NB>(kv + (kLbConsumers + w) * P::kTile, &tm_v, &kvfull[hc], h, row, b);
          }
        }
        for (int j = 0; j < nq; ++j, ++g) {
          const int s = g % S;
          if (lane == 0 && g >= S) lb_wait(&empty[s], (g / S - 1) & 1);
          __syncwarp();
          float* rs = rows + s * 2 * kLbRows;
          rs[lane] = nl[0];
          rs[32 + lane] = nl[1];
          rs[kLbRows + lane] = nd[0];
          rs[kLbRows + 32 + lane] = nd[1];
          mbar_arrive(&full[s]);
          if (lane == 0) {
            mbar_arrive_expect_tx(&full[s], P::kStage);
            load_tile<NB>(qtile(s), &tm_q, &full[s], h, j * kLbRows, b);
            load_tile<NB>(dotile(s), &tm_do, &full[s], h, j * kLbRows, b);
          }
          if (j + 1 < nq) {
            fetch(bh, j + 1);
          } else if (item + (int)gridDim.x < items) {
            int kb1, bh1;
            lb_item(item + gridDim.x, nkb, BH, gridDim.x, kb1, bh1);
            fetch(bh1, 0);
          }
        }
      }
    } else if (warp <= kLbWriters) {
      // the writing warps: from the last key block, a query tile's image
      // added to the accumulator the bulk thread read back and written in
      // bf16 into dqkv (with one key block, the image alone)
      const int wt = threadIdx.x % 128 - 32;
      constexpr int kStep = kLbWriters * 32 * P::kUnroll;
      static_assert(kPart % kStep == 0, "whole steps");
      int gd = 0, nl = 0;  // tiles seen, tiles of a last block read back
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        int kb, bh;
        lb_item(item, nkb, BH, gridDim.x, kb, bh);
        const int h = bh % H, b = bh / H;
        const bool last = kb == nkb - 1;
        for (int j = 0; j < nq; ++j, ++gd) {
          const int buf = gd % P::kDqBufs;
          const float4* img = parts + buf * kImage;
          lb_wait(&dqfull[buf], (gd / P::kDqBufs) & 1);
          if (nkb > 1) warp_arrive(&dqsum[buf], lane);
          if (!last) {
            warp_arrive(&dqempty[buf], lane);
            continue;
          }
          if (kb > 0) lb_wait(dqacc, nl++ & 1);
          // dQ = accumulator (none at one key block) + this block's image.
          // Float4 u holds accumulator registers 4 jj .. 4 jj + 3 of box c
          // (jj, c from u / 128) of consumer thread u % 128: rows r, r + 8,
          // columns col, col + 1. This thread's u alternate between consumer
          // threads wt and wt + 64, whose rows are r and r + 32
          const size_t ld = (size_t)3 * H * De;
          const int r = (wt / 32) * 16 + (wt % 32) / 4, q = j * kLbRows + r;
          bf16* rowp = dqkv + ((size_t)b * L + q) * ld + (size_t)h * De + 2 * (wt % 4);
          const bool live[2][2] = {{q < L, q + 8 < L}, {q + 32 < L, q + 40 < L}};
          for (int u0 = wt; u0 < kImage; u0 += kStep) {
            float4 x[P::kUnroll];
#pragma unroll
            for (int i = 0; i < P::kUnroll; ++i) {
              const int u = u0 + i * kLbWriters * 32;
              x[i] = kb > 0 ? lb_add4(accs[u], img[u]) : img[u];
            }
#pragma unroll
            for (int i = 0; i < P::kUnroll; ++i) {
              const int u = u0 + i * kLbWriters * 32, col = 64 * (u / kPart) + 8 * (u / 128 % 8);
              if (col + 2 * (wt % 4) >= De) continue;
              bf16* at = rowp + (i % 2) * 32 * ld + col;
              if (live[i % 2][0])
                *reinterpret_cast<__nv_bfloat162*>(at) = __floats2bfloat162_rn(x[i].x, x[i].y);
              if (live[i % 2][1])
                *reinterpret_cast<__nv_bfloat162*>(at + 8 * ld) =
                    __floats2bfloat162_rn(x[i].z, x[i].w);
            }
          }
          warp_arrive(&dqempty[buf], lane);
        }
      }
    } else if (lane == 0) {
      // the bulk thread: once a tile's image is ready and the counter reads
      // kb (every lower key block has added its part), the image is stored
      // (block 0) or added at L2 (the middle blocks) into the accumulator,
      // the counter advanced once that is complete; the last block's
      // accumulator is read back for the writing warps. One key block at a
      // time adds to a tile, in key-block order: a rerun is bit-identical.
      constexpr uint32_t kBytes = kImage * sizeof(float4);
      int gd = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        int kb, bh;
        lb_item(item, nkb, BH, gridDim.x, kb, bh);
        const bool last = kb == nkb - 1;
        for (int j = 0; j < nq; ++j, ++gd) {
          const int buf = gd % P::kDqBufs;
          const float4* img = parts + buf * kImage;
          int* cnt = counters + (size_t)bh * nq + j;
          float4* acc = reinterpret_cast<float4*>(dq_acc) + ((size_t)bh * nq + j) * kImage;
          if (nkb == 1) {  // one key block: the writing warps write dQ
            lb_wait(&dqfull[buf], (gd / P::kDqBufs) & 1);
            mbar_arrive(&dqempty[buf]);
            continue;
          }
          // the image is ready, and the writing warps are past the last
          // read-back (so its buffer is free)
          lb_wait(&dqsum[buf], (gd / P::kDqBufs) & 1);
          if (kb > 0) lb_wait_count(cnt, kb);
          lb_fence_global();
          if (last) {
            mbar_arrive_expect_tx(dqacc, kBytes);
            lb_bulk_load(accs, acc, kBytes, dqacc);
            mbar_arrive(&dqempty[buf]);
            continue;
          }
          lb_bulk_store(acc, img, kBytes, kb > 0);
          tma_store_wait_read();  // the image read: the consumers may refill the buffer
          mbar_arrive(&dqempty[buf]);
          asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
          lb_fence_global();
          lb_st_release(cnt, kb + 1);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<P::kConsumerRegs>();

  const int tid = threadIdx.x % 128;
  const int r0 = (tid / 32) * 16 + lane / 4;  // this thread's keys r0, r0 + 8 of the warpgroup's
  const float c2 = scale * kLbLog2e;          // logits to log2 units
  // a softmax over one key is constant: its logits' gradient is exactly 0
  const float ds_scale = L > 1 ? scale : 0.f;
  const size_t HDe = (size_t)H * De;
  // this warpgroup's dS^T tile (of the set of query tile g at two boxes)
  auto dst_of = [&](int set, int w) { return smem + P::kDsOff + (set * kLbConsumers + w) * kLbBox; };
  float dk[NB][32], dv[NB][32];
  // one box: S^T then P^T, dP^T then dS^T, then the dQ partial; two
  // boxes: sd[0] the dQ partial
  float sd[2][32];
  uint32_t pd[16];  // P^T, then dS^T, in bf16 (one box)
#pragma unroll
  for (int i = 0; i < 32; ++i) sd[0][i] = sd[1][i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) pd[i] = 0u;
  int g = 0, n = 0;  // query tiles consumed (all items), items
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    int kb, bh;
    lb_item(item, nkb, BH, gridDim.x, kb, bh);
    const int h = bh % H, b = bh / H;
    const int key = kb * kLbItemRows + wg * kLbRows + r0;
    const bool key0 = key < L, key1 = key + 8 < L;
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) dk[c][i] = dv[c][i] = 0.f;
    const int hc = n % P::kHold;
    const unsigned char* kv = smem + hc * P::kHeld;  // K of the item's two halves, then V
    const unsigned char* kt = kv + wg * P::kTile;
    const unsigned char* vt = kv + (kLbConsumers + wg) * P::kTile;
    lb_wait(&kvfull[hc], (n / P::kHold) & 1);

    for (int j = 0; j < nq; ++j, ++g) {
      const int s = g % S;
      const float* rs = rows + s * 2 * kLbRows;
      lb_wait(&full[s], (g / S) & 1);
      if constexpr (NB == 1) {
        // S^T = K Q_j^T and dP^T = V dO_j^T
        fence_regs(sd[0]);
        fence_regs(sd[1]);
        fence_acc<NB>(dk);
        fence_acc<NB>(dv);
        wgmma_fence();
        issue_abt<NB>(sd[0], kt, qtile(s));
        issue_abt<NB>(sd[1], vt, dotile(s));
        wgmma_wait<1>();
        fence_regs(sd[0]);
        // P^T = exp(S^T scale - lse): 0 for keys past L (queries past L
        // have lse = +inf); dV += P^T dO_j, issued while dS^T is formed
        p_tile<32>(sd[0], rs, 0, key0, key1, lane, c2);
        pack_a<32>(pd, sd[0]);
        fence_regs(pd);
        fence_acc<NB>(dv);
        wgmma_fence();
        issue_rs<NB>(dv, pd, dotile(s));
        wgmma_wait<1>();  // dP^T is done, dV may still run
        fence_regs(sd[1]);
        // dS^T = P^T (dP^T - delta) scale, packed once dV has read P^T, into
        // this warpgroup's tile (keys rows, queries columns), the A operand
        // of its dQ partial
        ds_tile<32>(sd[1], sd[0], rs + kLbRows, 0, lane, ds_scale);
        wgmma_wait<0>();
        fence_acc<NB>(dv);
        fence_regs(pd);
        pack_a<32>(pd, sd[1]);
        unsigned char* dst = dst_of(0, wg);
        store_ds<16>(dst, pd, r0, 0, lane);
        fence_proxy_async();
        asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
        // dK += dS^T Q_j, and the dQ partial dS K over this warpgroup's keys
        // into sd[0] (S^T and dP^T are spent)
        fence_regs(pd);
        fence_regs(sd[0]);
        fence_acc<NB>(dk);
        wgmma_fence();
        issue_rs<NB>(dk, pd, qtile(s));
        issue_dq(sd[0], dst, kt, false);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sd[0]);
        fence_acc<NB>(dk);
        fence_regs(pd);
      } else {
        // two boxes: dK and dV take 128 registers, so S^T and dP^T are
        // formed for 32 queries at a time (n 32; each once), and the
        // products of a half are done before the next half takes their
        // registers. Then this warpgroup's box of dS K over the item's 128
        // keys, from both consumers' dS^T tiles (two sets: the other
        // warpgroup may still read the last tile's)
        const int set = g & 1;
        unsigned char* dst = dst_of(set, wg);
#pragma unroll
        for (int hq = 0; hq < 2; ++hq) {
          float sh[16], dph[16];  // this half's S^T then P^T, dP^T then dS^T
          uint32_t ph[8], dh[8];  // P^T and dS^T in bf16
#pragma unroll
          for (int i = 0; i < 16; ++i) sh[i] = dph[i] = 0.f;
          fence_acc<NB>(dk);
          fence_acc<NB>(dv);
          wgmma_fence();
          issue_abt_half<NB>(sh, kt, qtile(s), hq);
          issue_abt_half<NB>(dph, vt, dotile(s), hq);
          wgmma_wait<0>();
          fence_regs(sh);
          fence_regs(dph);
          p_tile<16>(sh, rs, 32 * hq, key0, key1, lane, c2);
          ds_tile<16>(dph, sh, rs + kLbRows, 32 * hq, lane, ds_scale);
          pack_a<16>(ph, sh);
          pack_a<16>(dh, dph);
          store_ds<8>(dst, dh, r0, 32 * hq, lane);
          fence_regs(ph);
          fence_regs(dh);
          fence_acc<NB>(dv);
          fence_acc<NB>(dk);
          wgmma_fence();
          issue_rs_half<NB>(dv, ph, dotile(s), hq);
          issue_rs_half<NB>(dk, dh, qtile(s), hq);
          wgmma_wait<0>();
          fence_acc<NB>(dv);
          fence_acc<NB>(dk);
          fence_regs(ph);
          fence_regs(dh);
        }
        fence_proxy_async();
        named_barrier<1, kLbConsumers * 128>();
#pragma unroll
        for (int i = 0; i < 32; ++i) sd[0][i] = 0.f;  // no value carried in from the last tile
        fence_regs(sd[0]);
        wgmma_fence();
        issue_dq(sd[0], dst_of(set, 0), kv + wg * kLbBox, false);
        issue_dq(sd[0], dst_of(set, 1), kv + P::kTile + wg * kLbBox, true);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sd[0]);
      }
      warp_arrive(&empty[s], lane);                        // Q_j, dO_j, lse and delta read
      if (j == nq - 1) warp_arrive(&kvempty[hc], lane);    // K and V read for the last time
      // the dQ part into the tile's image, thread-major in f32: at one box
      // the first consumer writes its partial, the second adds its own to
      // it; at two each writes its box
      float4 xq[8];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        xq[jj] = make_float4(sd[0][4 * jj], sd[0][4 * jj + 1], sd[0][4 * jj + 2], sd[0][4 * jj + 3]);
      const int buf = g % P::kDqBufs;
      if (g >= P::kDqBufs) lb_wait(&dqempty[buf], (g / P::kDqBufs - 1) & 1);
      float4* out = parts + buf * kImage + (NB == 1 ? 0 : wg) * kPart;
      const bool adds = NB == 1 && wg == 1;
      if (adds) lb_wait(&dqhalf[buf], (g / P::kDqBufs) & 1);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        out[jj * 128 + tid] = adds ? lb_add4(out[jj * 128 + tid], xq[jj]) : xq[jj];
      fence_proxy_async();  // the image is read next by a bulk copy
      if (NB == 1 && wg == 0) warp_arrive(&dqhalf[buf], lane);
      warp_arrive(&dqfull[buf], lane);
    }

    const int row = b * L + key, end = b * L + L;  // flattened rows: this thread's, the batch row's end
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      store_bf16(dk[c], dqkv + HDe + (size_t)h * De, row, end, 3 * HDe, De, 64 * c, lane);
      store_bf16(dv[c], dqkv + 2 * HDe + (size_t)h * De, row, end, 3 * HDe, De, 64 * c, lane);
    }
  }
}

namespace {

template <int NB>
int bwd_launch(const CUtensorMap* maps, const void* lse, const void* delta, void* dq_acc,
               void* counters, void* dqkv, int B, int L, int H, int De, float scale,
               cudaStream_t stream) {
  const int items = (L + kLbItemRows - 1) / kLbItemRows * H * B;
  const int sms = device_sms();
  // at most one CTA an SM, all resident at once: a key block waits on lower
  // blocks of its (batch row, head), which earlier-claimed items hold
  const int grid = sms > 0 && items > sms ? sms : items;
  return (int)launch(long_attention_bwd_kernel<NB>, dim3(grid), dim3(kLbThreads),
                     LbPlan<NB>::kSmem, stream, maps[0], maps[1], maps[2], maps[3],
                     (const float*)lse, (const float*)delta, (float*)dq_acc, (int*)counters,
                     (bf16*)dqkv, L, H, De, items, scale);
}

}  // namespace

}  // namespace odt

// The long attention backward at Dp <= 128: q, k, v (B, L, H, Dp) bf16 as
// the streamed forward read them (zero past D), out and dout (B, L, H D)
// bf16, lse (B, H, L) f32 from that forward. The delta pass into delta (B,
// H, L) f32 (and dO padded into rdo (B, L, H, Dp) unless rdo is null, which
// needs Dp == D; counters (B H ceil(L / 64) int32) zeroed), then the one
// pass into dqkv (B, L, 3 H De) bf16, De = D rounded up to even: dq, dk and
// dv in its q, k and v columns (column pairs; a column past an odd D holds
// 0). dq_acc (B H ceil(L / 64) 64 Dp64 f32, Dp64 = Dp rounded up to 64) is
// the dQ accumulator's scratch.
extern "C" int odt_long_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* out, const void* dout, const void* lse,
                                      void* delta, void* rdo, void* dq_acc, void* counters,
                                      void* dqkv, int B, int L, int H, int D, int Dp, float scale,
                                      void* stream) {
  using namespace odt;
  const cudaStream_t st = (cudaStream_t)stream;
  if (B < 1 || L < 1 || H < 1 || D < 1 || Dp < D || Dp % 8 || Dp > 2 * 64 ||
      (rdo == nullptr && Dp != D))
    return (int)cudaErrorInvalidValue;
  const int ncount = B * H * ((L + kLbRows - 1) / kLbRows);
  const int err = delta_launch(dout, out, rdo, delta, counters, ncount, B, L, H, D, Dp, st);
  if (err != 0) return err;
  CUtensorMap maps[4];
  const void* bases[4] = {q, k, v, rdo != nullptr ? rdo : dout};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t e = stream_map(&maps[i], bases[i], Dp, H, L, B);
    if (e != cudaSuccess) return (int)e;
  }
  const int De = D + (D & 1);
  if (Dp <= 64)
    return bwd_launch<1>(maps, lse, delta, dq_acc, counters, dqkv, B, L, H, De, scale, st);
  return bwd_launch<2>(maps, lse, delta, dq_acc, counters, dqkv, B, L, H, De, scale, st);
}
