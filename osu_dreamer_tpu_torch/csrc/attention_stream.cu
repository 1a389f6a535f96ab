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
// The long attention backward (odt_attention_stream_bwd) is the training
// counterpart of K7/K8 past the JAX fused-attention gate, where the JAX
// package differentiates its Pallas forward with an XLA backward
// (long_attention.py `_vjp_bwd`): the shipped 16 x 64 heads at L 320. It is
// K10's dK/dV and dQ launches on q, k and v as the forward read them,
// after a delta pass of its own and with no post pass. Ahead of it, and of
// K7, the long route normalises and rotates q and k with K9's prep pass at
// Dp = D (odt_qk_prep, which also copies v), and takes their gradients
// back with K10's post pass on the long backward's bf16 gradients
// (odt_qk_post, which also copies dv into packed dqkv).
//
// What bounds them on the H100: 4 L^2 D operations per (batch row, head)
// in the forward, 10 L^2 D in the backward, on the tensor cores, against a
// few L D rows of bf16 (the backward also writes and reads f32 gradients
// of the rotated q and k): at L 320 and D 96 about 100 operations a byte,
// below the card's ~295, so bound by bytes at the training lengths; K7 at
// L 759 and K8 at L 2500 (about 380 and 1,250 a byte) by operations, as
// everything is past L ~ 1000. What kept them from either bound was how
// often the products ran (S re-formed for every output box), how long the
// tensor cores waited (each box's product waited on before the next was
// issued), zero columns in the products, and the prep and post passes
// (55 % of K10 at 8 x 96 L320 before this design); the design below
// removes the first three at D <= 256 and cuts the passes' waits.
//
// The layout: every operand of the products is a (B, L, heads, Dp) bf16
// array with Dp = D rounded up to 8 (TMA's 16-byte stride rule), read in
// 64 x 64 boxes through a 4-D tensor map (Dp, heads, L, B) with 128-byte
// swizzle: columns past Dp and rows past L are zero-filled on the load, so
// a box never reads the next head or batch row. K7 reads q, k and v as they
// are where D % 8 == 0 (the wrapper pads them otherwise). For K9/K10 a prep
// pass normalises and rotates q and k in the plain version's rounding order
// into padded arrays (v and dO are read in place from qkv and the gradient
// where Dp == D, copied padded otherwise), so the rotary pair (j, j + D/2)
// never has to meet inside a box at any D; the backward runs the same pass
// again, so its rq/rk are the forward's bit for bit, and the forward saves
// only lse.
//
// A head has nbox = ceil(Dp / 64) boxes. At nbox <= 4 (D <= 256) a CTA
// holds a whole head's width of its own rows in shared memory and all of
// its output columns in registers, so S (and dP) is formed once per tile
// pair in each launch; the products of the last box contract over
// ceil(w / 16) k-steps (w = Dp - 64 (nbox - 1) its columns), and a product
// whose output is the last box runs at n 32 where w <= 32 (D 96: S on 6
// k-steps, not 8; P V at n 96, not 128). Every CTA is a producer warpgroup
// (one thread issues the TMA loads; setmaxnreg lowers its registers and
// raises the consumers') and consumer warpgroups of 64 rows each, and is
// persistent: one CTA an SM takes work items blockIdx.x, + gridDim.x, ...;
// the ring of stages runs on across items, and the held tiles (Q; K and V;
// Q and dO) have two copies wherever two stages still fit beside them, so
// the next item's load lands while this item's last products and its
// epilogue run.
// - forward `attention_stream_fwd_kernel<NB, NC>` (K7/K8, K9's core): an
//   item is 64 NC query rows of a head (NC = 3 at NB <= 3, P V's A operand
//   from a shared tile at NB 3 for the registers; 2 at NB 4). Each stage is
//   a key tile's K and V boxes on their own full / empty barriers. Each
//   warpgroup issues tile t's S chain (all boxes, one commit) together with
//   tile t-1's P V, waits for S alone (`wgmma_wait<1>`), runs the online
//   softmax (f32 logits, running maxima, probabilities ex2((s - m) scale
//   log2 e) rounded to bf16 unnormalised) while P V runs, frees K(t) once
//   S(t) is done and V(t-1) once P V(t-1) is; one division by the row sum
//   at the end; lse = m scale + ln l for the backward; O stored from
//   registers, columns past D and rows past L skipped. S is formed once per
//   (query tile, key tile). At B4 L759 8 x 96 the items are 4 x 32 = 128
//   CTAs on 132 SMs (one wave; 128-row items would make 192, 1.45 waves);
//   at D 256 (two warpgroups, for the registers of O) 192 items, 1.45
//   waves. Where 64-row CTAs fill at most one wave the grid is set by one
//   CTA's time: NC = 1 and S, softmax and P V in turn (measured faster than
//   the overlap, which needs another warpgroup to fill the softmax's gaps),
//   and at NB 4 the wide kernel's CTAs of two output boxes;
// - backward dK/dV `attention_stream_bwd_kv_kernel<NB>`: an item is a key
//   tile, its whole dK and dV; K and V held, the ring carries each query
//   tile's Q and dO. Two consumer warpgroups share the tile: the first forms
//   S^T = K Q_j^T, P^T = exp(S^T scale - lse_j) and dV += P^T dO_j; the
//   second dP^T = V dO_j^T, dS^T = P^T (dP^T - delta_j) scale (P^T handed
//   over in f32 through a double-buffered shared tile, so dS^T rounds as
//   before) and dK += dS^T Q_j. Each issues tile j's S^T (dP^T) with tile
//   j-1's output product; lse and delta of tile j are loaded before its
//   products are issued. dV leaves in bf16 straight into dqkv;
// - backward dQ `attention_stream_bwd_q_kernel<NB>`: an item is 2 x 64
//   query rows (64 at NB 4, for the registers), Q and dO held, a ring of
//   (K_t, V_t) stages; per key tile S and dP as one group issued with
//   dS(t-1) K_{t-1}, then dS = P (dP - delta) scale.
//   S and dP are formed twice per (query tile, key tile) in all, once in
//   each launch: at D 96 1,344 L^2 units of products per (row, head) in
//   the backward (2 x 2 x 192 for S and dP, 3 x 192 for dV, dK, dQ),
//   against 2,816 when each 64-column output box formed them.
// At nbox > 4 (D > 256) neither a head's width of rows nor its outputs fit
// one CTA: the `_wide_` kernels stream both sides box by box through a ring
// of stages (every box's product issued behind the last, `wgmma_wait<1>`
// freeing the stage before; P V at n 64): the forward splits its output
// boxes over ceil(nbox / 3) CTAs a query tile (S formed that many times:
// twice at D 384; two consumer warpgroups sharing each K box; one query
// tile and two boxes a CTA where those fill at most a wave), the backward
// launches one CTA per (tile, output box) (S and dP formed nbox times in
// each launch).
// dQ and dK leave as f32 (B, L, H, Dp) arrays; a post pass takes them back
// through the inverse rotation and the gamma-scaled RMS norm in f32 (1/rms
// recomputed) into dqkv, and one f32 gamma partial per (64-row chunk, head,
// column) that the wrapper sums in a fixed order: no float atomics, a rerun
// is bit-identical. At L = 1 dS is exactly 0.
#include "attention_rows.cuh"
#include "common.cuh"
#include "hopper.cuh"

namespace odt {

using namespace hopper;

namespace {

constexpr int kStRows = 64;                               // rows of a box
constexpr uint32_t kStBox = kStRows * 64 * sizeof(bf16);  // 8 KB, one swizzled 64 x 64 box
constexpr int kStMaxStages = 4;
// shared memory for tiles and ring: a block's, less the base's alignment
// and room for the barriers
constexpr uint32_t kStTileCap = (uint32_t)kMaxSmem - 1024 - 256;
constexpr int kStPrepWarps = 8;                           // warps a block of the prep pass
constexpr int kStChunk = 32;                              // rows a block of the post pass
constexpr float kStNeg = -1e30f;
constexpr float kStLog2e = 1.4426950408889634f;
// the wide kernels (nbox > 4): consumer warpgroups and a producer warp (or
// warpgroup), a ring of kStWideStages stages of kStWideNB boxes, at most
// kStWideNB output boxes a forward CTA
constexpr int kStWideNB = 3;
constexpr int kStWideStages = 4;
constexpr int kStThreads = 128 + 32;
constexpr uint32_t kStWideStage = kStWideNB * kStBox;
constexpr size_t kStWideSmem = kStWideStages * (size_t)kStWideStage +
                               2 * kStWideStages * sizeof(uint64_t) + 1024;

constexpr int st_min(int a, int b) { return a < b ? a : b; }

// the copies of a persistent CTA's held tiles (`held` bytes each) beside a
// ring of stages of `stage` bytes and `fixed` other bytes: two (the next
// work item's load lands while this one runs) where at least two stages
// still fit, else one
constexpr int held_copies(uint32_t held, uint32_t stage, uint32_t fixed) {
  return kStTileCap >= 2 * held + fixed + 2 * stage ? 2 : 1;
}
// the ring's stages beside them, at most kStMaxStages
constexpr int ring_stages(uint32_t held, uint32_t stage, uint32_t fixed) {
  return st_min(kStMaxStages,
                (int)((kStTileCap - held_copies(held, stage, fixed) * held - fixed) / stage));
}


__device__ __forceinline__ float st_quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float st_quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// d[0..15] (the 64 x 32 accumulator, the first 32 columns of a 64-column
// one: the same register layout) += A B, A from registers (as
// wgmma_m64n64k16_rs_bt), B 16 rows of 32 columns of a box read MN-major
__device__ __forceinline__ void wgmma_m64n32k16_rs_bt(float (&d)[32], const uint32_t (&a)[4],
                                                      uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// d[0..15] += A B, A (64 x 16) K-major and B (16 rows of 32 columns of a
// box, MN-major) from shared memory
__device__ __forceinline__ void wgmma_m64n32k16_ss_bt(float (&d)[32], uint64_t desc_a,
                                                      uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
      ", %16, %17, p, 1, 1, 0, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// acc (+)= A B^T over the NB boxes of two 64-row tiles (box c at + c kStBox,
// both K-major), the last box on `klast` k16 steps (its columns past Dp
// are zero); issued, not committed
template <int NB>
__device__ __forceinline__ void issue_s(float (&acc)[32], const unsigned char* a,
                                        const unsigned char* b, int klast) {
  const uint64_t ad = wgmma_desc(a, 16, 1024), bd = wgmma_desc(b, 16, 1024);
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t at = c * (kStBox >> 4) + 2 * kk;
      if (c < NB - 1 || kk == 0 || kk < klast)  // klast >= 1: the first step always runs
        wgmma_m64n64k16_ss(acc, ad + at, bd + at, (c | kk) ? 1 : 0);
    }
}

// acc[c] += A B_c for the NB boxes of a 64-row tile (A 64 x 64 bf16 pairs in
// the accumulator's layout, from registers; B_c box c read MN-major, its
// rows the reduced dimension); the last box at n 32 when `narrow`; issued
// and committed
template <int NB>
__device__ __forceinline__ void issue_pv(float (&acc)[NB][32], const uint32_t (&a)[16],
                                         const unsigned char* b, bool narrow) {
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    const uint64_t bd = wgmma_desc(b + c * kStBox, 1024, 1024);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t ak[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3]};
      if (c == NB - 1 && narrow)
        wgmma_m64n32k16_rs_bt(acc[c], ak, bd + 128 * kk, 1);
      else
        wgmma_m64n64k16_rs_bt(acc[c], ak, bd + 128 * kk, 1);
    }
  }
  wgmma_commit();
}

// acc[c] += A B_c as issue_pv, A (64 x 64 bf16) from a swizzled shared
// tile (K-major) instead of registers; issued and committed
template <int NB>
__device__ __forceinline__ void issue_pv_smem(float (&acc)[NB][32], const unsigned char* a,
                                              const unsigned char* b, bool narrow) {
  const uint64_t ad = wgmma_desc(a, 16, 1024);
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    const uint64_t bd = wgmma_desc(b + c * kStBox, 1024, 1024);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (c == NB - 1 && narrow)
        wgmma_m64n32k16_ss_bt(acc[c], ad + 2 * kk, bd + 128 * kk, 1);
      else
        wgmma_m64n64k16_ss_bt(acc[c], ad + 2 * kk, bd + 128 * kk, 1);
    }
  }
  wgmma_commit();
}

// an accumulator's values in bf16 into this warpgroup's swizzled 64 x 64
// tile (the A operand of issue_pv_smem), visible to the next wgmma once
// every thread of the warpgroup is past it (one barrier a warpgroup)
__device__ __forceinline__ void store_a(unsigned char* tile, const float (&x)[32], int r0,
                                        int lane, int wg) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = j * 8 + (lane % 4) * 2;
    *reinterpret_cast<uint32_t*>(tile + swizzle128(r0, col)) = st_pack(x[4 * j], x[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(tile + swizzle128(r0 + 8, col)) =
        st_pack(x[4 * j + 2], x[4 * j + 3]);
  }
  fence_proxy_async();
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}

// the bf16 pairs of the A operand from an accumulator's f32 values
__device__ __forceinline__ void pack_a(uint32_t (&a)[16], const float (&x)[32]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) a[j] = st_pack(x[2 * j], x[2 * j + 1]);
}

// the online softmax of one key tile over this thread's rows r0 (even pairs
// of sc) and r0 + 8 (odd pairs), in place: keys at or past `lim` (the
// tile's valid keys) masked to -1e30, the running maxima m0 / m1 of the raw
// logits updated, sc becomes the unnormalised probabilities
// ex2((s - m) scale log2 e); -> the earlier tiles' rescale factors and this
// thread's share of the tile's row sums
struct StRow {
  float a0, a1, s0, s1;
};

__device__ __forceinline__ StRow st_softmax(float (&sc)[32], float& m0, float& m1, int lim,
                                            int lane, float c2) {
  if (lim < kStRows) {
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
  StRow r{st_ex2((m0 - mx0) * c2), st_ex2((m1 - mx1) * c2), 0.f, 0.f};
  m0 = mx0;
  m1 = mx1;
  const float b0 = -m0 * c2, b1 = -m1 * c2;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    sc[4 * j] = st_ex2(fmaf(sc[4 * j], c2, b0));
    sc[4 * j + 1] = st_ex2(fmaf(sc[4 * j + 1], c2, b0));
    sc[4 * j + 2] = st_ex2(fmaf(sc[4 * j + 2], c2, b1));
    sc[4 * j + 3] = st_ex2(fmaf(sc[4 * j + 3], c2, b1));
    r.s0 += sc[4 * j] + sc[4 * j + 1];
    r.s1 += sc[4 * j + 2] + sc[4 * j + 3];
  }
  return r;
}

// the running sums and O rescaled by a tile's factors
template <int NB>
__device__ __forceinline__ void st_rescale(float (&o)[NB][32], float& l0, float& l1,
                                           const StRow& r) {
  l0 = l0 * r.a0 + r.s0;
  l1 = l1 * r.a1 + r.s1;
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[c][4 * j] *= r.a0;
      o[c][4 * j + 1] *= r.a0;
      o[c][4 * j + 2] *= r.a1;
      o[c][4 * j + 3] *= r.a1;
    }
}

// O / l in bf16 straight to the (B, L, H D) output (columns c0 * 64.. of
// head h, rows past L and columns past D skipped), and lse (may be null)
template <int NB>
__device__ __forceinline__ void st_store_out(const float (&o)[NB][32], float l0, float l1,
                                             float m0, float m1, bf16* __restrict__ out,
                                             float* __restrict__ lse, int q0, int L, int H,
                                             int h, int b, int D, int c0, int nb, float scale,
                                             int lane) {
  l0 = st_quad_sum(l0);
  l1 = st_quad_sum(l1);
  const float inv[2] = {1.f / l0, 1.f / l1};
  const bool pairs = D % 2 == 0;  // an even head dim: each pair 4-byte aligned
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int q = q0 + 8 * hr;
    if (q >= L) continue;
    bf16* row = out + ((size_t)((size_t)b * L + q) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      if (c >= nb) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = (c0 + c) * 64 + j * 8 + (lane % 4) * 2;
        const float x = o[c][4 * j + 2 * hr] * inv[hr], y = o[c][4 * j + 2 * hr + 1] * inv[hr];
        if (pairs && col + 1 < D) {
          *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(x, y);
        } else {
          if (col < D) row[col] = __float2bfloat16(x);
          if (col + 1 < D) row[col + 1] = __float2bfloat16(y);
        }
      }
    }
  }
  if (lse != nullptr && c0 == 0 && lane % 4 == 0) {
    float* lrow = lse + ((size_t)b * H + h) * L;
    if (q0 < L) lrow[q0] = m0 * scale + logf(l0);
    if (q0 + 8 < L) lrow[q0 + 8] = m1 * scale + logf(l1);
  }
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

// box c (columns 64 c ..) of head h, rows row.., batch row b
__device__ __forceinline__ void load_box(void* dst, const CUtensorMap* map, uint64_t* bar, int c,
                                         int h, int row, int b) {
  tma_load_4d(dst, map, bar, 64 * c, h, row, b);
}

// a 64-row tile of NB boxes
template <int NB>
__device__ __forceinline__ void load_tile(unsigned char* dst, const CUtensorMap* map,
                                          uint64_t* bar, int h, int row, int b) {
#pragma unroll
  for (int c = 0; c < NB; ++c) load_box(dst + c * kStBox, map, bar, c, h, row, b);
}

// the last box's k16 steps and whether a product into it runs at n 32
__device__ __forceinline__ int last_ksteps(int Dp, int nbox) {
  return (Dp - 64 * (nbox - 1) + 15) / 16;
}
__device__ __forceinline__ bool last_narrow(int Dp, int nbox) {
  return Dp - 64 * (nbox - 1) <= 32;
}

}  // namespace

// ------------------------------------------------------------------ forward --

// the most consumer warpgroups a forward CTA at NB boxes a head: three
// while the registers of O and S (and at NB 1-2 P; at NB 3 P goes through
// shared memory) fit the 160 a thread three get, else two
constexpr int fwd_consumers(int nb) { return nb <= 3 ? 3 : 2; }

// the forward's plan at NB boxes a head and NC consumer warpgroups of 64
// query rows (NC 1 where 64-row CTAs fill at most one wave): their Q
// tiles, then a ring of kStages stages of a key tile's K and V; with more
// than one consumer the producer warpgroup hands its registers over
template <int NB, int NC>
struct StFwd {
  static constexpr int kNC = NC;
  static constexpr int kThreads = (kNC + 1) * 128;
  static constexpr int kProducerRegs = kNC == 3 ? 32 : 40;
  static constexpr int kConsumerRegs = kNC == 3 ? 160 : kNC == 2 ? 232 : 0;
  // P V's A operand from shared memory (a 64 x 64 tile a warpgroup) where
  // O, S and P would pass the registers
  static constexpr bool kPSmem = NB == 3 && kNC == 3;
  static constexpr uint32_t kTile = NB * kStBox;
  static constexpr uint32_t kHeld = kNC * kTile;  // the warpgroups' Q tiles
  static constexpr uint32_t kPBytes = kPSmem ? kNC * kStBox : 0;
  static constexpr int kHold = held_copies(kHeld, 2 * kTile, kPBytes);
  static constexpr uint32_t kPOff = kHold * kHeld;
  static constexpr uint32_t kRingOff = kPOff + kPBytes;
  static constexpr int kStages = ring_stages(kHeld, 2 * kTile, kPBytes);
  static constexpr uint32_t kBarOff = kRingOff + kStages * 2 * kTile;
  static constexpr size_t kSmem = kBarOff + (4 * kStages + 4) * sizeof(uint64_t) + 1024;
  static_assert(kStages >= 2 && kSmem <= kMaxSmem, "Q tiles and two stages fit");
  static_assert(kProducerRegs * 128 + kConsumerRegs * kNC * 128 <= 65536, "registers");
};

// O (and lse, may be null) of work items of 64 NC query rows (group qg of
// head h, batch row b; qg fastest), the head's nbox = NB boxes. A CTA an
// SM takes items blockIdx.x, + gridDim.x, ...: the K/V ring runs on across
// items and the next item's Q loads once this item's last S is done, so an
// item's last products and its epilogue overlap the next one's loads.
template <int NB, int NC>
__global__ void __launch_bounds__(StFwd<NB, NC>::kThreads, 1)
attention_stream_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ out,
                            float* __restrict__ lse, int B, int L, int H, int D, int Dp,
                            float scale) {
  using P = StFwd<NB, NC>;
  constexpr int S = P::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = st_smem(smem_raw);
  uint64_t* full_k = reinterpret_cast<uint64_t*>(smem + P::kBarOff);
  uint64_t* full_v = full_k + S;
  uint64_t* empty_k = full_v + S;
  uint64_t* empty_v = empty_k + S;
  uint64_t* qfull = empty_v + S;  // kHold each: the copies of the Q tiles
  uint64_t* qempty = qfull + 2;
  auto ktile = [&](int s) { return smem + P::kRingOff + s * 2 * P::kTile; };
  auto vtile = [&](int s) { return smem + P::kRingOff + s * 2 * P::kTile + P::kTile; };
  const int ntiles = (L + kStRows - 1) / kStRows;
  const int nq = (L + NC * kStRows - 1) / (NC * kStRows), items = nq * H * B;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], NC * 4);  // one arrival per consumer warp
      mbar_init(&empty_v[s], NC * 4);
    }
    for (int i = 0; i < P::kHold; ++i) {
      mbar_init(&qfull[i], 1);
      mbar_init(&qempty[i], NC * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == NC) {
    // producer: one thread issues every load (a zero-filled box counts its
    // full bytes); g counts the key tiles of every item so far
    if constexpr (NC > 1) setmaxnreg_dec<P::kProducerRegs>();
    if (threadIdx.x % 128 == 0) {
      int g = 0, n = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
        const int q0 = item % nq * NC * kStRows, h = item / nq % H, b = item / (nq * H);
        const int hc = n % P::kHold;  // the copy of the Q tiles
        if (n >= P::kHold) mbar_wait(&qempty[hc], (n / P::kHold - 1) & 1);
        mbar_arrive_expect_tx(&qfull[hc], NC * P::kTile);
        for (int w = 0; w < NC; ++w)
          load_tile<NB>(smem + hc * P::kHeld + w * P::kTile, &tm_q, &qfull[hc], h,
                        q0 + w * kStRows, b);
        for (int t = 0; t < ntiles; ++t, ++g) {
          const int s = g % S;
          if (g >= S) mbar_wait(&empty_k[s], (g / S - 1) & 1);
          mbar_arrive_expect_tx(&full_k[s], P::kTile);
          load_tile<NB>(ktile(s), &tm_k, &full_k[s], h, t * kStRows, b);
          if (g >= S) mbar_wait(&empty_v[s], (g / S - 1) & 1);
          mbar_arrive_expect_tx(&full_v[s], P::kTile);
          load_tile<NB>(vtile(s), &tm_v, &full_v[s], h, t * kStRows, b);
        }
      }
    }
    return;
  }
  if constexpr (NC > 1) setmaxnreg_inc<P::kConsumerRegs>();

  const int tid = threadIdx.x % 128, lane = tid % 32;
  const int r0 = (tid / 32) * 16 + lane / 4;  // this thread's rows r0, r0 + 8 of the warpgroup's
  const float c2 = scale * kStLog2e;  // logits to log2 units
  const int klast = last_ksteps(Dp, NB);
  const bool narrow = last_narrow(Dp, NB);
  unsigned char* ptile = smem + P::kPOff + wg * kStBox;  // P of this warpgroup (kPSmem)
  float o[NB][32], sc[32];
  uint32_t p[P::kPSmem ? 1 : 16];
  // P in bf16 for P V: in registers, or in this warpgroup's shared tile
  auto put_p = [&]() {
    if constexpr (P::kPSmem)
      store_a(ptile, sc, r0, lane, wg);
    else
      pack_a(p, sc);
  };
  auto pv = [&](const unsigned char* v) {
    if constexpr (P::kPSmem)
      issue_pv_smem<NB>(o, ptile, v, narrow);
    else
      issue_pv<NB>(o, p, v, narrow);
  };
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  int g = 0, n = 0;  // key tiles consumed (all items), items done
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const int q0 = item % nq * NC * kStRows, h = item / nq % H, b = item / (nq * H);
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
    float m0 = kStNeg, m1 = kStNeg, l0 = 0.f, l1 = 0.f;  // running maxima, this thread's sums
    const int hc = n % P::kHold;
    const unsigned char* qtile = smem + hc * P::kHeld + wg * P::kTile;
    mbar_wait(&qfull[hc], (n / P::kHold) & 1);
    mbar_wait(&full_k[g % S], (g / S) & 1);
    fence_regs(sc);
    fence_acc<NB>(o);
    wgmma_fence();
    issue_s<NB>(sc, qtile, ktile(g % S), klast);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    warp_arrive(&empty_k[g % S], lane);
    if (ntiles == 1) warp_arrive(&qempty[hc], lane);
    StRow rs = st_softmax(sc, m0, m1, L, lane, c2);
    st_rescale<NB>(o, l0, l1, rs);
    put_p();

    // one warpgroup alone (a one-wave grid): S, softmax and P V in turn,
    // each chain waited on once (measured faster than the overlap, which
    // needs another warpgroup's products to fill the softmax's gaps)
    for (int t = 1; NC == 1 && t <= ntiles; ++t) {
      const int gp = g + t - 1, sp = gp % S;
      mbar_wait(&full_v[sp], (gp / S) & 1);
      fence_acc<NB>(o);
      fence_regs(p);
      wgmma_fence();
      pv(vtile(sp));
      wgmma_wait<0>();
      fence_acc<NB>(o);
      fence_regs(p);
      warp_arrive(&empty_v[sp], lane);
      if (t == ntiles) break;  // the last P V (measured faster here than after the loop)
      const int gt = g + t, s = gt % S;
      mbar_wait(&full_k[s], (gt / S) & 1);
      fence_regs(sc);
      wgmma_fence();
      issue_s<NB>(sc, qtile, ktile(s), klast);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      warp_arrive(&empty_k[s], lane);
      if (t == ntiles - 1) warp_arrive(&qempty[hc], lane);
      rs = st_softmax(sc, m0, m1, L - t * kStRows, lane, c2);
      st_rescale<NB>(o, l0, l1, rs);
      put_p();
    }
    // more warpgroups: tile t's S issued with tile t-1's P V
    for (int t = 1; NC > 1 && t < ntiles; ++t) {
      const int gt = g + t, s = gt % S, sp = (gt - 1) % S;
      mbar_wait(&full_k[s], (gt / S) & 1);
      mbar_wait(&full_v[sp], ((gt - 1) / S) & 1);
      fence_regs(sc);
      fence_acc<NB>(o);
      fence_regs(p);
      wgmma_fence();
      issue_s<NB>(sc, qtile, ktile(s), klast);
      wgmma_commit();
      pv(vtile(sp));
      wgmma_wait<1>();  // S of tile t is done, P V of tile t-1 may still run
      fence_regs(sc);
      warp_arrive(&empty_k[s], lane);
      if (t == ntiles - 1) warp_arrive(&qempty[hc], lane);  // Q's last product is done
      rs = st_softmax(sc, m0, m1, L - t * kStRows, lane, c2);
      wgmma_wait<0>();
      fence_acc<NB>(o);
      fence_regs(p);
      warp_arrive(&empty_v[sp], lane);
      st_rescale<NB>(o, l0, l1, rs);
      put_p();
    }
    if constexpr (NC > 1) {
      const int gl = g + ntiles - 1, sl = gl % S;
      mbar_wait(&full_v[sl], (gl / S) & 1);
      fence_acc<NB>(o);
      fence_regs(p);
      wgmma_fence();
      pv(vtile(sl));
      wgmma_wait<0>();
      fence_acc<NB>(o);
      fence_regs(p);
      warp_arrive(&empty_v[sl], lane);
    }
    g += ntiles;

    st_store_out<NB>(o, l0, l1, m0, m1, out, lse, q0 + wg * kStRows + r0, L, H, h, b, D, 0, NB,
                     scale, lane);
  }
}

// ------------------------------------------------------------- backward --

// the dK/dV launch's plan at NB boxes a head: a P^T warpgroup and a dS^T
// warpgroup over one key tile (its K and V held), two f32 exchange tiles,
// then a ring of kStages stages of a query tile's Q and dO
template <int NB>
struct StKv {
  static constexpr int kThreads = 3 * 128;
  static constexpr uint32_t kTile = NB * kStBox;
  static constexpr uint32_t kXch = 32 * 128 * sizeof(float);  // one f32 P^T tile, thread-major
  static constexpr uint32_t kHeld = 2 * kTile;                 // K and V
  static constexpr int kHold = held_copies(kHeld, 2 * kTile, 2 * kXch);
  static constexpr uint32_t kXOff = kHold * kHeld;
  static constexpr uint32_t kRingOff = kXOff + 2 * kXch;
  static constexpr int kStages = ring_stages(kHeld, 2 * kTile, 2 * kXch);
  static constexpr uint32_t kBarOff = kRingOff + kStages * 2 * kTile;
  static constexpr size_t kSmem = kBarOff + (2 * kStages + 8) * sizeof(uint64_t) + 1024;
  static_assert(kStages >= 2 && kSmem <= kMaxSmem, "K, V, the exchange and two stages fit");
};

// dK (f32, the gradient of the rotated k) and dV (bf16, into its columns
// of dqkv) of work items of one key tile (tile kt of head h, batch row b;
// kt fastest), all NB boxes. A CTA an SM takes items blockIdx.x, +
// gridDim.x, ...: the Q/dO ring runs on across items and the next item's K
// and V load once this item's last S^T and dP^T are done, so an item's last
// products and its epilogue overlap the next one's loads.
template <int NB>
__global__ void __launch_bounds__(StKv<NB>::kThreads, 1)
attention_stream_bwd_kv_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_do,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               float* __restrict__ dk, bf16* __restrict__ dqkv, int B, int L,
                               int H, int D, int Dp, float scale) {
  using P = StKv<NB>;
  constexpr int S = P::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = st_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::kBarOff);
  uint64_t* empty = full + S;
  uint64_t* kvfull = empty + S;  // kHold each: the copies of K and V
  uint64_t* kvempty = kvfull + 2;
  uint64_t* xfull = kvempty + 2;  // two: the exchange tiles
  uint64_t* xfree = xfull + 2;
  float* xch = reinterpret_cast<float*>(smem + P::kXOff);
  auto qtile = [&](int s) { return smem + P::kRingOff + s * 2 * P::kTile; };
  auto dotile = [&](int s) { return smem + P::kRingOff + s * 2 * P::kTile + P::kTile; };
  const int ntiles = (L + kStRows - 1) / kStRows, items = ntiles * H * B;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    for (int i = 0; i < P::kHold; ++i) {
      mbar_init(&kvfull[i], 1);
      mbar_init(&kvempty[i], 8);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&xfull[i], 4);  // one arrival per warp of the handing or the taking warpgroup
      mbar_init(&xfree[i], 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (threadIdx.x % 128 == 0) {
      int g = 0, n = 0;  // query tiles loaded (all items), items
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
        const int kt = item % ntiles, h = item / ntiles % H, b = item / (ntiles * H);
        const int hc = n % P::kHold;  // the copy of K and V
        if (n >= P::kHold) mbar_wait(&kvempty[hc], (n / P::kHold - 1) & 1);
        mbar_arrive_expect_tx(&kvfull[hc], 2 * P::kTile);
        load_tile<NB>(smem + hc * P::kHeld, &tm_k, &kvfull[hc], h, kt * kStRows, b);
        load_tile<NB>(smem + hc * P::kHeld + P::kTile, &tm_v, &kvfull[hc], h, kt * kStRows, b);
        for (int j = 0; j < ntiles; ++j, ++g) {
          const int s = g % S;
          if (g >= S) mbar_wait(&empty[s], (g / S - 1) & 1);
          mbar_arrive_expect_tx(&full[s], 2 * P::kTile);
          load_tile<NB>(qtile(s), &tm_q, &full[s], h, j * kStRows, b);
          load_tile<NB>(dotile(s), &tm_do, &full[s], h, j * kStRows, b);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<232>();

  const int tid = threadIdx.x % 128, lane = tid % 32;
  const int r0 = (tid / 32) * 16 + lane / 4;  // this thread's keys r0, r0 + 8 of the tile
  const int klast = last_ksteps(Dp, NB);
  const bool narrow = last_narrow(Dp, NB);
  const float c2 = scale * kStLog2e;
  // a softmax over one key is constant: its logits' gradient is exactly 0
  const float ds_scale = L > 1 ? scale : 0.f;
  const float pad = wg == 0 ? INFINITY : 0.f, mul = wg == 0 ? kStLog2e : 1.f;
  const size_t HD = (size_t)H * D;
  float acc[NB][32], x[32];  // dV or dK; S^T then P^T, or dP^T then dS^T
  uint32_t a[16] = {};       // P^T or dS^T in bf16
  // the swept tile's lse (x log2 e, +inf past L) or delta (0 past L) at
  // this thread's 16 queries, loaded before the tile's products are issued
  float pre[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) x[i] = 0.f;
  int g = 0, n = 0;  // query tiles consumed (all items), items
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const int kt = item % ntiles, h = item / ntiles % H, b = item / (ntiles * H);
    const float* rowv = (wg == 0 ? lse : delta) + ((size_t)b * H + h) * L;
    const bool key0 = kt * kStRows + r0 < L, key1 = kt * kStRows + r0 + 8 < L;
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
    const int hc = n % P::kHold;
    const unsigned char* ktile = smem + hc * P::kHeld;
    const unsigned char* vtile = ktile + P::kTile;
    mbar_wait(&kvfull[hc], (n / P::kHold) & 1);

    // query tile j's lse (x log2 e, +inf past L) or delta (0 past L) at this
    // thread's 16 queries, loaded before the tile's products are issued
    auto prefetch = [&](int j) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int q = j * kStRows + (i / 2) * 8 + (lane % 4) * 2 + i % 2;
        pre[i] = q < L ? rowv[q] * mul : pad;
      }
    };
    // warpgroup 0: S^T = K Q_j^T; warpgroup 1: dP^T = V dO_j^T
    auto issue_sj = [&](int s) {
      fence_regs(x);
      fence_acc<NB>(acc);
      fence_regs(a);
      wgmma_fence();
      issue_s<NB>(x, wg == 0 ? ktile : vtile, wg == 0 ? qtile(s) : dotile(s), klast);
      wgmma_commit();
    };
    // P^T = exp(S^T scale - lse) (0 for keys past L; queries past L have
    // lse = +inf), handed over in f32; dS^T = P^T (dP^T - delta) scale.
    // (A branch-free form, both warpgroups writing and one named barrier a
    // tile, keeps ptxas from serialising around these branches (C7514) but
    // measured 17 % slower at 8 x 96 L320.)
    auto elementwise = [&](int j, int gj) {
      fence_regs(x);
      if (j == ntiles - 1) warp_arrive(&kvempty[hc], lane);  // K and V read for the last time
      float* xt = xch + (gj & 1) * 32 * 128;
      if (wg == 0) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool key = e < 2 ? key0 : key1;
            x[4 * jj + e] = key ? st_ex2(fmaf(x[4 * jj + e], c2, -pre[2 * jj + e % 2])) : 0.f;
          }
        if (gj >= 2) mbar_wait(&xfree[gj & 1], ((gj >> 1) - 1) & 1);
#pragma unroll
        for (int i = 0; i < 32; ++i) xt[i * 128 + tid] = x[i];
        warp_arrive(&xfull[gj & 1], lane);
      } else {
        mbar_wait(&xfull[gj & 1], (gj >> 1) & 1);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            x[4 * jj + e] =
                xt[(4 * jj + e) * 128 + tid] * (x[4 * jj + e] - pre[2 * jj + e % 2]) * ds_scale;
        warp_arrive(&xfree[gj & 1], lane);
      }
    };

    prefetch(0);
    mbar_wait(&full[g % S], (g / S) & 1);
    issue_sj(g % S);
    wgmma_wait<0>();
    elementwise(0, g);
    pack_a(a, x);
    for (int j = 1; j < ntiles; ++j) {
      // tile j's S^T (dP^T) behind tile j-1's dV += P^T dO_{j-1} (dK +=
      // dS^T Q_{j-1})
      const int gj = g + j, s = gj % S, sp = (gj - 1) % S;
      prefetch(j);
      mbar_wait(&full[s], (gj / S) & 1);
      issue_sj(s);
      issue_pv<NB>(acc, a, wg == 0 ? dotile(sp) : qtile(sp), narrow);
      wgmma_wait<1>();
      elementwise(j, gj);
      wgmma_wait<0>();
      fence_acc<NB>(acc);
      fence_regs(a);
      warp_arrive(&empty[sp], lane);
      pack_a(a, x);
    }
    const int gl = g + ntiles - 1, sl = gl % S;
    fence_acc<NB>(acc);
    fence_regs(a);
    wgmma_fence();
    issue_pv<NB>(acc, a, wg == 0 ? dotile(sl) : qtile(sl), narrow);
    wgmma_wait<0>();
    fence_acc<NB>(acc);
    fence_regs(a);
    warp_arrive(&empty[sl], lane);
    g += ntiles;

    const int row = b * L + kt * kStRows + r0;
    const int rows = b * L + L;  // this batch row's end in the flattened rows
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      if (wg == 0)
        store_bf16(acc[c], dqkv + 2 * HD + (size_t)h * D, row, rows, 3 * HD, D, 64 * c, lane);
      else
        store_f32(acc[c], dk, row, rows, H, h, Dp, 64 * c, lane);
    }
  }
}

// the dQ launch's plan at NB boxes a head: kNC warpgroups of 64 query rows
// (two while the registers of dQ, S and dP allow), their Q and dO tiles,
// then a ring of kStages stages of a key tile's K and V
template <int NB>
struct StQ {
  static constexpr int kNC = NB <= 3 ? 2 : 1;
  static constexpr int kThreads = (kNC + 1) * 128;
  // registers handed from the producer to two consumer warpgroups; one
  // consumer keeps the launch's 255
  static constexpr uint32_t kTile = NB * kStBox;
  static constexpr uint32_t kDoOff = kNC * kTile;      // in a copy: Q tiles, then dO tiles
  static constexpr uint32_t kHeld = 2 * kNC * kTile;
  static constexpr int kHold = held_copies(kHeld, 2 * kTile, 0);
  static constexpr uint32_t kRingOff = kHold * kHeld;
  static constexpr int kStages = ring_stages(kHeld, 2 * kTile, 0);
  static constexpr uint32_t kBarOff = kRingOff + kStages * 2 * kTile;
  static constexpr size_t kSmem = kBarOff + (2 * kStages + 4) * sizeof(uint64_t) + 1024;
  static_assert(kStages >= 2 && kSmem <= kMaxSmem, "Q, dO and two stages fit");
};

// dQ (f32, the gradient of the rotated q) of work items of 64 kNC query
// rows (group qg of head h, batch row b; qg fastest); persistent as the
// dK/dV launch: the K/V ring runs on across items and the next item's Q and
// dO load once this item's last S and dP are done
template <int NB>
__global__ void __launch_bounds__(StQ<NB>::kThreads, 1)
attention_stream_bwd_q_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              float* __restrict__ dq, int B, int L, int H, int Dp, float scale) {
  using P = StQ<NB>;
  constexpr int S = P::kStages, NC = P::kNC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = st_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::kBarOff);
  uint64_t* empty = full + S;
  uint64_t* qfull = empty + S;  // kHold each: the copies of Q and dO
  uint64_t* qempty = qfull + 2;
  auto ktile = [&](int s) { return smem + P::kRingOff + s * 2 * P::kTile; };
  auto vtile = [&](int s) { return smem + P::kRingOff + s * 2 * P::kTile + P::kTile; };
  const int ntiles = (L + kStRows - 1) / kStRows, nq = (ntiles + NC - 1) / NC;
  const int items = nq * H * B;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC * 4);  // one arrival per consumer warp
    }
    for (int i = 0; i < P::kHold; ++i) {
      mbar_init(&qfull[i], 1);
      mbar_init(&qempty[i], NC * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == NC) {
    if constexpr (NC == 2) setmaxnreg_dec<40>();
    if (threadIdx.x % 128 == 0) {
      int g = 0, n = 0;  // key tiles loaded (all items), items
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
        const int q0 = item % nq * NC * kStRows, h = item / nq % H, b = item / (nq * H);
        const int hc = n % P::kHold;  // the copy of Q and dO
        if (n >= P::kHold) mbar_wait(&qempty[hc], (n / P::kHold - 1) & 1);
        mbar_arrive_expect_tx(&qfull[hc], 2 * NC * P::kTile);
        unsigned char* held = smem + hc * P::kHeld;
        for (int w = 0; w < NC; ++w) {
          load_tile<NB>(held + w * P::kTile, &tm_q, &qfull[hc], h, q0 + w * kStRows, b);
          load_tile<NB>(held + P::kDoOff + w * P::kTile, &tm_do, &qfull[hc], h, q0 + w * kStRows,
                        b);
        }
        for (int t = 0; t < ntiles; ++t, ++g) {
          const int s = g % S;
          if (g >= S) mbar_wait(&empty[s], (g / S - 1) & 1);
          mbar_arrive_expect_tx(&full[s], 2 * P::kTile);
          load_tile<NB>(ktile(s), &tm_k, &full[s], h, t * kStRows, b);
          load_tile<NB>(vtile(s), &tm_v, &full[s], h, t * kStRows, b);
        }
      }
    }
    return;
  }
  if constexpr (NC == 2) setmaxnreg_inc<232>();

  const int tid = threadIdx.x % 128, lane = tid % 32;
  const int r0 = (tid / 32) * 16 + lane / 4;  // this thread's queries r0, r0 + 8 of the warpgroup's
  const int klast = last_ksteps(Dp, NB);
  const bool narrow = last_narrow(Dp, NB);
  const float c2 = scale * kStLog2e;
  const float ds_scale = L > 1 ? scale : 0.f;
  float sa[32], dpa[32], dqa[NB][32];
  uint32_t dsa[16] = {};
#pragma unroll
  for (int i = 0; i < 32; ++i) sa[i] = dpa[i] = 0.f;
  int g = 0, n = 0;  // key tiles consumed (all items), items
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const int q0 = item % nq * NC * kStRows, h = item / nq % H, b = item / (nq * H);
    const int qa = q0 + wg * kStRows + r0, qb = qa + 8;
    const float* lse_r = lse + ((size_t)b * H + h) * L;
    const float* delta_r = delta + ((size_t)b * H + h) * L;
    const float la = qa < L ? lse_r[qa] * kStLog2e : INFINITY;
    const float lb = qb < L ? lse_r[qb] * kStLog2e : INFINITY;
    const float d0 = qa < L ? delta_r[qa] : 0.f, d1 = qb < L ? delta_r[qb] : 0.f;
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) dqa[c][i] = 0.f;
    const int hc = n % P::kHold;
    const unsigned char* qtile = smem + hc * P::kHeld + wg * P::kTile;
    const unsigned char* dotile = smem + hc * P::kHeld + P::kDoOff + wg * P::kTile;
    mbar_wait(&qfull[hc], (n / P::kHold) & 1);

    // S = Q K_t^T and dP = dO V_t^T, one group
    auto issue_sdp = [&](int s) {
      fence_regs(sa);
      fence_regs(dpa);
      fence_acc<NB>(dqa);
      fence_regs(dsa);
      wgmma_fence();
      issue_s<NB>(sa, qtile, ktile(s), klast);
      issue_s<NB>(dpa, dotile, vtile(s), klast);
      wgmma_commit();
    };
    // P = exp(S scale - lse) (0 for keys past L), dS = P (dP - delta) scale
    auto elementwise = [&](int t) {
      fence_regs(sa);
      fence_regs(dpa);
      if (t == ntiles - 1) warp_arrive(&qempty[hc], lane);  // Q and dO read for the last time
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int key = t * kStRows + jj * 8 + (lane % 4) * 2;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = key + (e % 2) < L;
          const float p = ok ? st_ex2(fmaf(sa[4 * jj + e], c2, -(e < 2 ? la : lb))) : 0.f;
          sa[4 * jj + e] = p * (dpa[4 * jj + e] - (e < 2 ? d0 : d1)) * ds_scale;
        }
      }
    };

    mbar_wait(&full[g % S], (g / S) & 1);
    issue_sdp(g % S);
    wgmma_wait<0>();
    elementwise(0);
    pack_a(dsa, sa);
    for (int t = 1; t < ntiles; ++t) {
      // tile t's S and dP behind dQ += dS_{t-1} K_{t-1}
      const int gt = g + t, s = gt % S, sp = (gt - 1) % S;
      mbar_wait(&full[s], (gt / S) & 1);
      issue_sdp(s);
      issue_pv<NB>(dqa, dsa, ktile(sp), narrow);
      wgmma_wait<1>();
      elementwise(t);
      wgmma_wait<0>();
      fence_acc<NB>(dqa);
      fence_regs(dsa);
      warp_arrive(&empty[sp], lane);
      pack_a(dsa, sa);
    }
    const int gl = g + ntiles - 1, sl = gl % S;
    fence_acc<NB>(dqa);
    fence_regs(dsa);
    wgmma_fence();
    issue_pv<NB>(dqa, dsa, ktile(sl), narrow);
    wgmma_wait<0>();
    fence_acc<NB>(dqa);
    fence_regs(dsa);
    warp_arrive(&empty[sl], lane);
    g += ntiles;
#pragma unroll
    for (int c = 0; c < NB; ++c)
      store_f32(dqa[c], dq, b * L + qa, b * L + L, H, h, Dp, 64 * c, lane);
  }
}

// ------------------------------------------------ the wide kernels (nbox > 4) --

namespace {

// the wide kernels' ring of kStWideStages stages of kStWideNB boxes: the
// producer's count of stages armed (`head`), the consumers' of stages
// waited for (`head`) and freed (`tail`)
struct Ring {
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  int head, tail;
  __device__ __forceinline__ unsigned char* slot(int s, int i) const {
    return base + s * kStWideStage + i * kStBox;
  }
};

// the ring at the aligned base of the dynamic shared memory, its barriers
// initialised for `warps` consumer warps (every thread of the CTA calls
// this)
__device__ __forceinline__ Ring ring_init(unsigned char* raw, int warps) {
  Ring r;
  r.base = st_smem(raw);
  r.full = reinterpret_cast<uint64_t*>(r.base + kStWideStages * kStWideStage);
  r.empty = r.full + kStWideStages;
  r.head = r.tail = 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStWideStages; ++s) {
      mbar_init(&r.full[s], 1);
      mbar_init(&r.empty[s], warps);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  return r;
}

// producer: the next stage once its consumers freed it, armed for `boxes`
// boxes (a zero-filled box counts its full bytes); -> its index
__device__ __forceinline__ int ring_produce(Ring& r, int boxes) {
  const int s = r.head % kStWideStages;
  if (r.head >= kStWideStages) mbar_wait(&r.empty[s], (r.head / kStWideStages - 1) & 1);
  mbar_arrive_expect_tx(&r.full[s], boxes * kStBox);
  ++r.head;
  return s;
}

__device__ __forceinline__ void wide_load(Ring& r, int s, int i, const CUtensorMap* map, int c,
                                          int h, int row, int b) {
  load_box(r.slot(s, i), map, &r.full[s], c, h, row, b);
}

// consumer: wait for the next stage -> its index
__device__ __forceinline__ int ring_wait(Ring& r) {
  const int s = r.head % kStWideStages;
  mbar_wait(&r.full[s], (r.head / kStWideStages) & 1);
  ++r.head;
  return s;
}

// consumer: free the stages waited for, all but the `keep` newest (each
// committed product group reads one stage, so after wgmma_wait<keep> only
// the newest `keep` may still be read)
__device__ __forceinline__ void ring_free(Ring& r, int lane, int keep) {
  while (r.tail < r.head - keep) {
    warp_arrive(&r.empty[r.tail % kStWideStages], lane);
    ++r.tail;
  }
}

// acc = sum over the head's nbox boxes of A_c B_c^T, one stage (A box c in
// slot `a`, B box c in slot `b`) each, every box's product committed behind
// the last without waiting for it; the group before each is awaited
// (wgmma_wait<1>) and its stage freed. The caller waits for the last group.
__device__ __forceinline__ void wide_chain(Ring& r, float (&acc)[32], int nbox, int klast,
                                           int lane, int a = 0, int b = 1) {
  auto box = [&](int c, int ks) {
    const int s = ring_wait(r);
    fence_regs(acc);
    const uint64_t ad = wgmma_desc(r.slot(s, a), 16, 1024), bd = wgmma_desc(r.slot(s, b), 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      if (kk == 0 || kk < ks) wgmma_m64n64k16_ss(acc, ad + 2 * kk, bd + 2 * kk, (c | kk) ? 1 : 0);
    wgmma_commit();
    wgmma_wait<1>();
    ring_free(r, lane, 1);
  };
  for (int c = 0; c < nbox - 1; ++c) box(c, 4);
  box(nbox - 1, klast);
}

// acc += A B with B one box of a stage read MN-major (n 64 always: a
// choice of n at run time is a branch around the wgmma, which serialises
// them); issued, not committed
__device__ __forceinline__ void wide_pv(float (&acc)[32], const uint32_t (&a)[16], const void* b) {
  const uint64_t bd = wgmma_desc(b, 1024, 1024);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t ak[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3]};
    wgmma_m64n64k16_rs_bt(acc, ak, bd + 128 * kk, 1);
  }
}

}  // namespace

// O (and lse) of NC query tiles NC (blockIdx.x / ncs).., output boxes NB
// (blockIdx.x % ncs) .. of them; lse (may be null) written by the first
// box's CTA. NC consumer warpgroups (64 query rows each) share each stage
// of (their Q boxes, a K box) and of V boxes; the loads come from a
// producer warp, or at NC 2 a producer warpgroup that hands its registers
// over (ptxas shares the registers out by whole warpgroups)
template <int NC, int NB>
__global__ void __launch_bounds__(NC == 1 ? kStThreads : (NC + 1) * 128, 1)
attention_stream_wide_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                                 const __grid_constant__ CUtensorMap tm_k,
                                 const __grid_constant__ CUtensorMap tm_v,
                                 bf16* __restrict__ out, float* __restrict__ lse, int L, int H,
                                 int D, int Dp, int ncs, float scale) {
  static_assert(NC + 1 <= kStWideNB && NB <= kStWideNB, "a stage holds NC Q boxes and a K box");
  extern __shared__ unsigned char smem_raw[];
  Ring ring = ring_init(smem_raw, NC * 4);
  const int qt = blockIdx.x / ncs * NC, cs = blockIdx.x % ncs, h = blockIdx.y, b = blockIdx.z;
  const int nbox = (Dp + 63) / 64, c0 = cs * NB, nb = min(NB, nbox - c0);
  const int ntiles = (L + kStRows - 1) / kStRows;
  const int wg = threadIdx.x / 128;

  if (wg == NC) {
    if constexpr (NC > 1) setmaxnreg_dec<40>();
    if (threadIdx.x == NC * 128) {
      for (int t = 0; t < ntiles; ++t) {
        for (int c = 0; c < nbox; ++c) {
          const int s = ring_produce(ring, NC + 1);
          for (int w = 0; w < NC; ++w) wide_load(ring, s, w, &tm_q, c, h, (qt + w) * kStRows, b);
          wide_load(ring, s, NC, &tm_k, c, h, t * kStRows, b);
        }
        const int s = ring_produce(ring, nb);
        for (int c = 0; c < nb; ++c) wide_load(ring, s, c, &tm_v, c0 + c, h, t * kStRows, b);
      }
    }
    return;
  }
  if constexpr (NC > 1) setmaxnreg_inc<232>();

  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x % 128 / 32) * 16 + lane / 4;  // this thread's rows r0, r0 + 8
  const float c2 = scale * kStLog2e;
  const int klast = last_ksteps(Dp, nbox);
  float o[NB][32], sc[32];
  uint32_t p[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m0 = kStNeg, m1 = kStNeg, l0 = 0.f, l1 = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    // S behind tile t-1's P V (its stage freed by the chain's first wait)
    wide_chain(ring, sc, nbox, klast, lane, wg, NC);
    wgmma_wait<0>();
    fence_regs(sc);
    fence_acc<NB>(o);
    fence_regs(p);
    ring_free(ring, lane, 0);
    const StRow rs = st_softmax(sc, m0, m1, L - t * kStRows, lane, c2);
    st_rescale<NB>(o, l0, l1, rs);
    pack_a(p, sc);
    const int s = ring_wait(ring);
    fence_acc<NB>(o);
    fence_regs(p);
    wgmma_fence();
    // every box's product, also past the head's last box (nb < NB: stale
    // slots, products never stored), so that no wgmma waits on a branch
#pragma unroll
    for (int c = 0; c < NB; ++c) wide_pv(o[c], p, ring.slot(s, c));
    wgmma_commit();
    if constexpr (NC == 1) {  // one warpgroup: P V waited on, not run behind the next S
      wgmma_wait<0>();
      fence_acc<NB>(o);
      fence_regs(p);
      ring_free(ring, lane, 0);
    }
  }
  wgmma_wait<0>();
  fence_acc<NB>(o);
  fence_regs(p);
  ring_free(ring, lane, 0);
  st_store_out<NB>(o, l0, l1, m0, m1, out, lse, (qt + wg) * kStRows + r0, L, H, h, b, D, c0, nb,
                   scale, lane);
}

// dK (f32) and dV (bf16, into dqkv) of key tile blockIdx.x / nbox, output
// box blockIdx.x % nbox
__global__ void __launch_bounds__(kStThreads, 1)
attention_stream_wide_bwd_kv_kernel(const __grid_constant__ CUtensorMap tm_q,
                                    const __grid_constant__ CUtensorMap tm_k,
                                    const __grid_constant__ CUtensorMap tm_v,
                                    const __grid_constant__ CUtensorMap tm_do,
                                    const float* __restrict__ lse,
                                    const float* __restrict__ delta, float* __restrict__ dk,
                                    bf16* __restrict__ dqkv, int L, int H, int D, int Dp,
                                    float scale) {
  extern __shared__ unsigned char smem_raw[];
  Ring ring = ring_init(smem_raw, 4);
  const int nbox = (Dp + 63) / 64;
  const int kt = blockIdx.x / nbox, c0 = blockIdx.x % nbox, h = blockIdx.y, b = blockIdx.z;
  const int ntiles = (L + kStRows - 1) / kStRows;

  if (threadIdx.x >= 128) {
    if (threadIdx.x == 128) {
      for (int j = 0; j < ntiles; ++j) {
        for (int c = 0; c < nbox; ++c) {
          const int s = ring_produce(ring, 2);
          wide_load(ring, s, 0, &tm_k, c, h, kt * kStRows, b);
          wide_load(ring, s, 1, &tm_q, c, h, j * kStRows, b);
        }
        for (int c = 0; c < nbox; ++c) {
          const int s = ring_produce(ring, 2);
          wide_load(ring, s, 0, &tm_v, c, h, kt * kStRows, b);
          wide_load(ring, s, 1, &tm_do, c, h, j * kStRows, b);
        }
        const int s = ring_produce(ring, 2);
        wide_load(ring, s, 0, &tm_do, c0, h, j * kStRows, b);
        wide_load(ring, s, 1, &tm_q, c0, h, j * kStRows, b);
      }
    }
    return;
  }

  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * 16 + lane / 4;  // this thread's keys r0, r0 + 8 of the tile
  const float c2 = scale * kStLog2e;
  const float ds_scale = L > 1 ? scale : 0.f;
  const int klast = last_ksteps(Dp, nbox);
  const bool key0 = kt * kStRows + r0 < L, key1 = kt * kStRows + r0 + 8 < L;
  const float* lse_r = lse + ((size_t)b * H + h) * L;
  const float* delta_r = delta + ((size_t)b * H + h) * L;
  float st[32], dpt[32], dka[32], dva[32];
  uint32_t pa[16], da[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) st[i] = dpt[i] = dka[i] = dva[i] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    wide_chain(ring, st, nbox, klast, lane);   // S^T = K Q_j^T, behind the last outputs
    wide_chain(ring, dpt, nbox, klast, lane);  // dP^T = V dO_j^T
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);
    fence_regs(dka);
    fence_regs(dva);
    ring_free(ring, lane, 0);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int q = j * kStRows + jj * 8 + (lane % 4) * 2;
      const float la = q < L ? lse_r[q] * kStLog2e : INFINITY;
      const float lb = q + 1 < L ? lse_r[q + 1] * kStLog2e : INFINITY;
      const float d0 = q < L ? delta_r[q] : 0.f, d1 = q + 1 < L ? delta_r[q + 1] : 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool key = e < 2 ? key0 : key1;
        st[4 * jj + e] = key ? st_ex2(fmaf(st[4 * jj + e], c2, -(e % 2 ? lb : la))) : 0.f;
        dpt[4 * jj + e] = st[4 * jj + e] * (dpt[4 * jj + e] - (e % 2 ? d1 : d0)) * ds_scale;
      }
    }
    pack_a(pa, st);
    pack_a(da, dpt);
    const int s = ring_wait(ring);
    fence_regs(dka);
    fence_regs(dva);
    fence_regs(pa);
    fence_regs(da);
    wgmma_fence();
    wide_pv(dva, pa, ring.slot(s, 0));  // dV += P^T dO_j
    wide_pv(dka, da, ring.slot(s, 1));  // dK += dS^T Q_j
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(dka);
  fence_regs(dva);
  ring_free(ring, lane, 0);
  const int row = b * L + kt * kStRows + r0;
  const int rows = b * L + L;  // this batch row's end in the flattened rows
  const size_t HD = (size_t)H * D;
  store_bf16(dva, dqkv + 2 * HD + (size_t)h * D, row, rows, 3 * HD, D, c0 * 64, lane);
  store_f32(dka, dk, row, rows, H, h, Dp, c0 * 64, lane);
}

// dQ of query tile blockIdx.x / nbox, output box blockIdx.x % nbox
__global__ void __launch_bounds__(kStThreads, 2)
attention_stream_wide_bwd_q_kernel(const __grid_constant__ CUtensorMap tm_q,
                                   const __grid_constant__ CUtensorMap tm_k,
                                   const __grid_constant__ CUtensorMap tm_v,
                                   const __grid_constant__ CUtensorMap tm_do,
                                   const float* __restrict__ lse,
                                   const float* __restrict__ delta, float* __restrict__ dq,
                                   int L, int H, int Dp, float scale) {
  extern __shared__ unsigned char smem_raw[];
  Ring ring = ring_init(smem_raw, 4);
  const int nbox = (Dp + 63) / 64;
  const int qt = blockIdx.x / nbox, c0 = blockIdx.x % nbox, h = blockIdx.y, b = blockIdx.z;
  const int ntiles = (L + kStRows - 1) / kStRows;

  if (threadIdx.x >= 128) {
    if (threadIdx.x == 128) {
      for (int t = 0; t < ntiles; ++t) {
        for (int c = 0; c < nbox; ++c) {
          const int s = ring_produce(ring, 2);
          wide_load(ring, s, 0, &tm_q, c, h, qt * kStRows, b);
          wide_load(ring, s, 1, &tm_k, c, h, t * kStRows, b);
        }
        for (int c = 0; c < nbox; ++c) {
          const int s = ring_produce(ring, 2);
          wide_load(ring, s, 0, &tm_do, c, h, qt * kStRows, b);
          wide_load(ring, s, 1, &tm_v, c, h, t * kStRows, b);
        }
        const int s = ring_produce(ring, 1);
        wide_load(ring, s, 0, &tm_k, c0, h, t * kStRows, b);
      }
    }
    return;
  }

  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * 16 + lane / 4;  // this thread's queries r0, r0 + 8
  const float c2 = scale * kStLog2e;
  const float ds_scale = L > 1 ? scale : 0.f;
  const int klast = last_ksteps(Dp, nbox);
  const int qa = qt * kStRows + r0, qb = qa + 8;
  const float* lse_r = lse + ((size_t)b * H + h) * L;
  const float* delta_r = delta + ((size_t)b * H + h) * L;
  const float la = qa < L ? lse_r[qa] * kStLog2e : INFINITY;
  const float lb = qb < L ? lse_r[qb] * kStLog2e : INFINITY;
  const float d0 = qa < L ? delta_r[qa] : 0.f, d1 = qb < L ? delta_r[qb] : 0.f;
  float sa[32], dpa[32], dqa[32];
  uint32_t dsa[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) sa[i] = dpa[i] = dqa[i] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    wide_chain(ring, sa, nbox, klast, lane);   // S = Q K_t^T, behind the last dQ product
    wide_chain(ring, dpa, nbox, klast, lane);  // dP = dO V_t^T
    wgmma_wait<0>();
    fence_regs(sa);
    fence_regs(dpa);
    fence_regs(dqa);
    ring_free(ring, lane, 0);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int key = t * kStRows + jj * 8 + (lane % 4) * 2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = key + (e % 2) < L;
        const float p = ok ? st_ex2(fmaf(sa[4 * jj + e], c2, -(e < 2 ? la : lb))) : 0.f;
        sa[4 * jj + e] = p * (dpa[4 * jj + e] - (e < 2 ? d0 : d1)) * ds_scale;
      }
    }
    pack_a(dsa, sa);
    const int s = ring_wait(ring);
    fence_regs(dqa);
    fence_regs(dsa);
    wgmma_fence();
    wide_pv(dqa, dsa, ring.slot(s, 0));  // dQ += dS K_t
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(dqa);
  ring_free(ring, lane, 0);
  store_f32(dqa, dq, b * L + qa, b * L + L, H, h, Dp, c0 * 64, lane);
}

// -------------------------------------------------------- prep and post --
//
// Both are bound by the loads in flight, not by their bytes. So a lane
// loads V values at a time (16 bytes at V 8, V the widest of 8, 4, 2, 1
// that divides D/2 and every stride and base, `vec_width`) at the rotary
// pair halves j and j + D/2, and a (row, head) takes a group of only as
// many lanes as it has vectors (`vec_lanes`, at most a warp), so a warp
// holds 32 / G rows' loads in flight at once. The prep pass sums the
// squares of q and k (and the dO O products) in one sweep, then writes from
// the registers it read; the post pass sweeps each row once for its sums,
// then writes its own vector. The rounding is the plain version's; a row's
// squares are summed in one order for a shape (each lane's vectors in
// turn, then the group's tree), and the forward and the backward run the
// same prep pass on the same qkv, so the backward's rq/rk are the
// forward's bit for bit.

namespace {

constexpr int kStPostWarps = 8;  // warps a block of the post pass

// the post pass's gradients dq, dk, dv: element (r, h, j) of gradient i
// at r row[i] + h head[i] + j
struct PostStrides {
  long long row[3], head[3];
};

template <int V>
struct alignas(2 * V) Pack {
  bf16 v[V];
};

template <int V>
__device__ __forceinline__ void load(const bf16* __restrict__ p, float (&out)[V]) {
  const Pack<V> pk = *reinterpret_cast<const Pack<V>*>(p);
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = __bfloat162float(pk.v[i]);
}

// f32 gradients (K10's dQ and dK launches) in 16-byte loads where V allows
template <int V>
__device__ __forceinline__ void load(const float* __restrict__ p, float (&out)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + i);
      out[i] = f.x, out[i + 1] = f.y, out[i + 2] = f.z, out[i + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = p[i];
  }
}

template <int V>
__device__ __forceinline__ void store(bf16* __restrict__ p, const float (&in)[V]) {
  Pack<V> pk;
#pragma unroll
  for (int i = 0; i < V; ++i) pk.v[i] = __float2bfloat16(in[i]);
  *reinterpret_cast<Pack<V>*>(p) = pk;
}

template <int V>
__device__ __forceinline__ void copy(const bf16* __restrict__ x, bf16* __restrict__ y) {
  *reinterpret_cast<Pack<V>*>(y) = *reinterpret_cast<const Pack<V>*>(x);
}

// a row of D values into Dp columns, zero past D, by the g lanes of a
// group, V at a time to D
template <int V>
__device__ __forceinline__ void copy_row(const bf16* __restrict__ x, bf16* __restrict__ y, int D,
                                         int Dp, int li, int g) {
  for (int c = li; c < D / V; c += g) copy<V>(x + c * V, y + c * V);
  for (int j = D + li; j < Dp; j += g) y[j] = __float2bfloat16(0.f);
}

__device__ __forceinline__ float inv_rms(float ss, int D) { return 1.f / sqrtf(ss / D + 1e-6f); }

// a row's vectors at the pair halves (x1 at j, x2 at j + D/2), widened to f32
template <int V>
struct Halves {
  float a[V], b[V];
  template <typename T>
  __device__ __forceinline__ void read(const T* __restrict__ x, int half) {
    load<V>(x, a);
    load<V>(x + half, b);
  }
  __device__ __forceinline__ float squares() const {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) s += a[i] * a[i] + b[i] * b[i];
    return s;
  }
  __device__ __forceinline__ float dot(const Halves& o) const {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) s += a[i] * o.a[i] + b[i] * o.b[i];
    return s;
  }
};

// the normalised, scaled and rotated halves of x into y in the plain
// version's rounding order: bf16(x / rms), bf16(* gamma), then bf16 rotary
// products and their bf16 sums
template <int V>
__device__ __forceinline__ void norm_rope(const Halves<V>& x, float inv, const bf16* __restrict__ g,
                                          const float (&c)[V], const float (&s)[V], int half,
                                          bf16* __restrict__ y) {
  Halves<V> gg;
  float y1[V], y2[V];
  gg.read(g, half);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float n1 = bfr(bfr(x.a[i] * inv) * gg.a[i]), n2 = bfr(bfr(x.b[i] * inv) * gg.b[i]);
    y1[i] = bfr(n1 * c[i]) - bfr(n2 * s[i]);
    y2[i] = bfr(n1 * s[i]) + bfr(n2 * c[i]);
  }
  store<V>(y, y1);
  store<V>(y + half, y2);
}

// the gradient of the gamma-scaled normalised pair halves: the rotated
// rows' gradient d taken back through the rotation
template <int V>
__device__ __forceinline__ void unrotate(const Halves<V>& d, const float (&c)[V],
                                         const float (&s)[V], Halves<V>& gn) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    gn.a[i] = d.a[i] * c[i] + d.b[i] * s[i];
    gn.b[i] = d.b[i] * c[i] - d.a[i] * s[i];
  }
}

}  // namespace

// A group of G lanes (`vec_lanes`) a (row, head) of the (B L) rows: q
// and k normalised and rotated into the padded (B L, H, Dp) arrays rq, rk,
// v copied into rv where given (the kernels read v from qkv where Dp == D);
// with dout (the backward): delta = rowsum(dO O) into (B, H, L) and, where
// rdo is given, dO copied padded. A lane's first vector stays in registers
// between the sums and the output; further ones (D / 2 > G V) are read
// again (from L1).
template <int V>
__global__ void __launch_bounds__(kStPrepWarps * 32)
attention_prep_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ gq,
                      const bf16* __restrict__ gk, const bf16* __restrict__ cos_t,
                      const bf16* __restrict__ sin_t, bf16* __restrict__ rq,
                      bf16* __restrict__ rk, bf16* __restrict__ rv,
                      const bf16* __restrict__ dout, const bf16* __restrict__ o,
                      bf16* __restrict__ rdo, float* __restrict__ delta, int BL, int L, int H,
                      int D, int Dp, int G) {
  const int lane = threadIdx.x % 32, li = lane % G, half = D / 2, nv = half / V;
  const size_t units = (size_t)BL * H;
  const size_t first = ((size_t)blockIdx.x * kStPrepWarps + threadIdx.x / 32) * (32 / G);
  if (first >= units) return;  // the whole warp: no lane is left for the shuffles
  const size_t unit = first + lane / G;
  const bool live = unit < units;  // a tail group computes the last unit again and stores nothing
  const size_t u = live ? unit : units - 1;
  const int row = (int)(u / H), h = (int)(u % H), pos = row % L;
  const size_t HD = (size_t)H * D, dst = u * Dp;
  const bf16* xq = qkv + (size_t)row * 3 * HD + (size_t)h * D;
  const bf16* xk = xq + HD;
  const bf16* g = dout == nullptr ? nullptr : dout + (size_t)row * HD + (size_t)h * D;
  const bf16* oo = dout == nullptr ? nullptr : o + (size_t)row * HD + (size_t)h * D;
  Halves<V> hq, hk;
  float sq = 0.f, sk = 0.f, d = 0.f;
  for (int c = li; c < nv; c += G) {
    Halves<V> eq, ek;
    eq.read(xq + c * V, half);
    ek.read(xk + c * V, half);
    sq += eq.squares();
    sk += ek.squares();
    if (c == li) {
      hq = eq;
      hk = ek;
    }
    if (g != nullptr) {
      Halves<V> eg, eo;
      eg.read(g + c * V, half);
      eo.read(oo + c * V, half);
      d += eg.dot(eo);
    }
  }
  const float iq = inv_rms(group_sum(sq, G), D), ik = inv_rms(group_sum(sk, G), D);
  if (g != nullptr) d = group_sum(d, G);
  if (!live) return;
  const bf16* cr = cos_t + (size_t)pos * half;
  const bf16* sr = sin_t + (size_t)pos * half;
  for (int c = li; c < nv; c += G) {
    float cs[V], sn[V];
    load<V>(cr + c * V, cs);
    load<V>(sr + c * V, sn);
    if (c != li) {
      hq.read(xq + c * V, half);
      hk.read(xk + c * V, half);
    }
    norm_rope<V>(hq, iq, gq + c * V, cs, sn, half, rq + dst + c * V);
    norm_rope<V>(hk, ik, gk + c * V, cs, sn, half, rk + dst + c * V);
  }
  for (int j = D + li; j < Dp; j += G) rq[dst + j] = rk[dst + j] = __float2bfloat16(0.f);
  if (rv != nullptr) copy_row<V>(xq + 2 * HD, rv + dst, D, Dp, li, G);
  if (g != nullptr) {
    if (li == 0) delta[((size_t)(row / L) * H + h) * L + pos] = d;
    if (rdo != nullptr) copy_row<V>(g, rdo + dst, D, Dp, li, G);
  }
}

// One block of kStPostWarps warps a (chunk of kStChunk rows, column block
// of G vectors), its warps taking the chunk's (row, head) units 32 / G at a
// time (a group of G lanes a unit, lane li at vector G blockIdx.y + li): a
// unit's squares and sum of gh x (gh the gradient of the gamma-scaled
// normalised row) over the whole row, then its gradients dq and dk of the
// rotated rows (T: f32 from K10's launches, bf16 from the long attention
// backward) back through the inverse rotation and the gamma-scaled RMS
// norm in f32 into dqkv's q and k columns (bf16) at the lane's vector, and,
// where dv is given, its columns copied into dqkv's v columns; the lane's
// gamma gradients summed over its units, then the groups of a warp
// (shuffles) and the warps in order into one f32 partial a chunk:
// dg[chunk][q or k][column]. Past G = 32 vectors (D > 512 at V 8) each
// column block sweeps the whole rows again for their sums.
template <typename T, int V>
__global__ void __launch_bounds__(kStPostWarps * 32)
attention_post_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ gq,
                      const bf16* __restrict__ gk, const bf16* __restrict__ cos_t,
                      const bf16* __restrict__ sin_t, const T* __restrict__ dq,
                      const T* __restrict__ dk, const bf16* __restrict__ dv, PostStrides st,
                      bf16* __restrict__ dqkv, float* __restrict__ dg, int BL, int L, int H,
                      int D, int G) {
  __shared__ float red[kStPostWarps][2][2][32 * V];  // (warp, q or k, pair half, lane's vector)
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, li = lane % G, per = 32 / G;
  const int half = D / 2, nv = half / V;
  const int own = blockIdx.y * G + li;  // the lane's vector
  const bool mine = own < nv;
  const int row0 = blockIdx.x * kStChunk;
  const int units = min(kStChunk, BL - row0) * H;
  const size_t HD = (size_t)H * D;
  const bf16* gam[2] = {gq, gk};
  const T* grad[2] = {dq, dk};
  Halves<V> gm[2];          // the lane's gains
  float acc[2][2][V] = {};  // its gain gradients: (q or k, pair half, element)
  if (mine) {
#pragma unroll
    for (int t = 0; t < 2; ++t) gm[t].read(gam[t] + own * V, half);
  }
  for (int u0 = warp * per; u0 < units; u0 += kStPostWarps * per) {
    const int uu = u0 + lane / G;
    const bool live = uu < units;
    const int ur = live ? uu : units - 1;
    const int row = row0 + ur / H, h = ur % H, pos = row % L;
    const bf16* cr = cos_t + (size_t)pos * half;
    const bf16* sr = sin_t + (size_t)pos * half;
    const bf16* x[2];
    const T* d[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      x[t] = qkv + (size_t)row * 3 * HD + t * HD + (size_t)h * D;
      d[t] = grad[t] + row * st.row[t] + h * st.head[t];
    }
    // the lane's own vector: raw halves, the normalised rows' gradients
    Halves<V> xo[2], gn[2];
    float ss[2] = {0.f, 0.f}, m[2] = {0.f, 0.f};
    if (mine) {
      float cs[V], sn[V];
      load<V>(cr + own * V, cs);
      load<V>(sr + own * V, sn);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        Halves<V> dd;
        xo[t].read(x[t] + own * V, half);
        dd.read(d[t] + own * V, half);
        unrotate<V>(dd, cs, sn, gn[t]);
        ss[t] = xo[t].squares();
#pragma unroll
        for (int i = 0; i < V; ++i)
          m[t] += gn[t].a[i] * gm[t].a[i] * xo[t].a[i] + gn[t].b[i] * gm[t].b[i] * xo[t].b[i];
      }
    }
    // the rest of the row, where it spans more than one column block
    for (int c = li; c < nv; c += G) {
      if (c == own) continue;
      float c2[V], s2[V];
      load<V>(cr + c * V, c2);
      load<V>(sr + c * V, s2);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        Halves<V> xe, de, ge, ne;
        xe.read(x[t] + c * V, half);
        de.read(d[t] + c * V, half);
        ge.read(gam[t] + c * V, half);
        unrotate<V>(de, c2, s2, ne);
        ss[t] += xe.squares();
#pragma unroll
        for (int i = 0; i < V; ++i)
          m[t] += ne.a[i] * ge.a[i] * xe.a[i] + ne.b[i] * ge.b[i] * xe.b[i];
      }
    }
    float iv[2], i3m[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      iv[t] = inv_rms(group_sum(ss[t], G), D);
      i3m[t] = iv[t] * iv[t] * iv[t] * (group_sum(m[t], G) / D);
    }
    if (!live || !mine) continue;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      float y1[V], y2[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        acc[t][0][i] += gn[t].a[i] * xo[t].a[i] * iv[t];
        acc[t][1][i] += gn[t].b[i] * xo[t].b[i] * iv[t];
        y1[i] = gn[t].a[i] * gm[t].a[i] * iv[t] - xo[t].a[i] * i3m[t];
        y2[i] = gn[t].b[i] * gm[t].b[i] * iv[t] - xo[t].b[i] * i3m[t];
      }
      bf16* y = dqkv + (size_t)row * 3 * HD + t * HD + (size_t)h * D + own * V;
      store<V>(y, y1);
      store<V>(y + half, y2);
    }
    if (dv == nullptr) continue;
    const bf16* gv = dv + row * st.row[2] + h * st.head[2] + own * V;
    bf16* yv = dqkv + (size_t)row * 3 * HD + 2 * HD + (size_t)h * D + own * V;
    copy<V>(gv, yv);
    copy<V>(gv + half, yv + half);
  }
  // the groups of a warp, then the warps in order
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float s = acc[t][e][i];
        for (int o = G; o < 32; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane < G) red[warp][t][e][lane * V + i] = s;
      }
  __syncthreads();
  for (int idx = threadIdx.x; idx < 2 * 2 * G * V; idx += kStPostWarps * 32) {
    const int t = idx / (2 * G * V), e = idx / (G * V) % 2, w = idx % (G * V);
    const int col = blockIdx.y * G * V + w;  // the column inside the pair half
    if (col >= half) continue;
    float s = 0.f;
    for (int wp = 0; wp < kStPostWarps; ++wp) s += red[wp][t][e][w];
    dg[((size_t)blockIdx.x * 2 + t) * D + e * half + col] = s;
  }
}

// ------------------------------------------------------------------- host --

namespace {

// v's map: rv, or the v columns of qkv where rv is null (Dp == D)
cudaError_t v_map(CUtensorMap* map, const void* qkv, const void* rv, int D, int Dp, int H, int L,
                  int B) {
  if (rv != nullptr) return stream_map(map, rv, Dp, H, L, B);
  return stream_map_rows(map, static_cast<const bf16*>(qkv) + 2 * (size_t)H * D, D, H, L, B,
                         3 * (size_t)H * D);
}

// whether CTAs of one 64-row warpgroup each fill at most one wave of the
// card: then a CTA a tile (more SMs at work), else the most warpgroups a
// CTA (K and V shared by more rows, fewer waves)
bool one_wave(int ctas) { return ctas <= device_sms(); }

// persistent CTAs, one an SM: as many as the items, at most the SMs
int persistent_ctas(int items) {
  const int sms = device_sms();
  return sms > 0 && items > sms ? sms : items;
}

template <int NB, int NC>
int fwd_launch_nc(const CUtensorMap* maps, void* out, void* lse, int B, int L, int H, int D,
                  int Dp, float scale, cudaStream_t stream) {
  using P = StFwd<NB, NC>;
  const int rows = NC * kStRows, items = (L + rows - 1) / rows * H * B;
  return (int)launch(attention_stream_fwd_kernel<NB, NC>, dim3(persistent_ctas(items)),
                     dim3(P::kThreads), P::kSmem, stream, maps[0], maps[1], maps[2], (bf16*)out,
                     (float*)lse, B, L, H, D, Dp, scale);
}

// the wide forward: CTAs of kStWideNB output boxes and two query tiles;
// where CTAs of one query tile and two boxes (the more CTAs) fill at most a
// wave, those
int wide_fwd_launch(const CUtensorMap* maps, void* out, void* lse, int B, int L, int H, int D,
                    int Dp, float scale, cudaStream_t stream) {
  const int nbox = (Dp + 63) / 64, ntiles = (L + kStRows - 1) / kStRows;
  const int ncs2 = (nbox + 1) / 2, ncs = (nbox + kStWideNB - 1) / kStWideNB;
  if (one_wave(ntiles * ncs2 * H * B))
    return (int)launch(attention_stream_wide_fwd_kernel<1, 2>, dim3(ntiles * ncs2, H, B),
                       dim3(kStThreads), kStWideSmem, stream, maps[0], maps[1], maps[2],
                       (bf16*)out, (float*)lse, L, H, D, Dp, ncs2, scale);
  return (int)launch(attention_stream_wide_fwd_kernel<2, kStWideNB>,
                     dim3((ntiles + 1) / 2 * ncs, H, B), dim3(3 * 128), kStWideSmem, stream,
                     maps[0], maps[1], maps[2], (bf16*)out, (float*)lse, L, H, D, Dp, ncs,
                     scale);
}

template <int NB>
int fwd_launch(const CUtensorMap* maps, void* out, void* lse, int B, int L, int H, int D, int Dp,
               float scale, cudaStream_t stream) {
  const int tiles = (L + kStRows - 1) / kStRows * H * B;
  // at four boxes a grid this small is set by one CTA's time: two CTAs of
  // two output boxes each (S formed twice) finish sooner
  if (NB == 4 && one_wave(2 * tiles))
    return wide_fwd_launch(maps, out, lse, B, L, H, D, Dp, scale, stream);
  if (one_wave(tiles)) return fwd_launch_nc<NB, 1>(maps, out, lse, B, L, H, D, Dp, scale, stream);
  return fwd_launch_nc<NB, fwd_consumers(NB)>(maps, out, lse, B, L, H, D, Dp, scale, stream);
}

// the forward over the maps of q, k, v (padded to Dp columns): a head's
// boxes in one CTA to D 256, else split over CTAs of kStWideNB output boxes
int stream_fwd(const CUtensorMap* maps, void* out, void* lse, int B, int L, int H, int D, int Dp,
               float scale, cudaStream_t stream) {
  switch ((Dp + 63) / 64) {
    case 1: return fwd_launch<1>(maps, out, lse, B, L, H, D, Dp, scale, stream);
    case 2: return fwd_launch<2>(maps, out, lse, B, L, H, D, Dp, scale, stream);
    case 3: return fwd_launch<3>(maps, out, lse, B, L, H, D, Dp, scale, stream);
    case 4: return fwd_launch<4>(maps, out, lse, B, L, H, D, Dp, scale, stream);
    default: return wide_fwd_launch(maps, out, lse, B, L, H, D, Dp, scale, stream);
  }
}

template <int NB>
int bwd_launch(const CUtensorMap* maps, const void* lse, const void* delta, void* dq, void* dk,
               void* dqkv, int B, int L, int H, int D, int Dp, float scale, cudaStream_t stream) {
  const int ntiles = (L + kStRows - 1) / kStRows;
  int err = (int)launch(attention_stream_bwd_kv_kernel<NB>, dim3(persistent_ctas(ntiles * H * B)),
                        dim3(StKv<NB>::kThreads), StKv<NB>::kSmem, stream, maps[0], maps[1],
                        maps[2], maps[3], (const float*)lse, (const float*)delta, (float*)dk,
                        (bf16*)dqkv, B, L, H, D, Dp, scale);
  if (err != 0) return err;
  constexpr int nc = StQ<NB>::kNC;
  return (int)launch(attention_stream_bwd_q_kernel<NB>,
                     dim3(persistent_ctas((ntiles + nc - 1) / nc * H * B)),
                     dim3(StQ<NB>::kThreads), StQ<NB>::kSmem, stream, maps[0], maps[1], maps[2],
                     maps[3], (const float*)lse, (const float*)delta, (float*)dq, B, L, H, Dp,
                     scale);
}

// the dK/dV and dQ launches over padded (B, L, H, Dp) rows
int stream_bwd(const CUtensorMap* maps, const void* lse, const void* delta, void* dq, void* dk,
               void* dqkv, int B, int L, int H, int D, int Dp, float scale,
               cudaStream_t stream) {
  switch ((Dp + 63) / 64) {
    case 1: return bwd_launch<1>(maps, lse, delta, dq, dk, dqkv, B, L, H, D, Dp, scale, stream);
    case 2: return bwd_launch<2>(maps, lse, delta, dq, dk, dqkv, B, L, H, D, Dp, scale, stream);
    case 3: return bwd_launch<3>(maps, lse, delta, dq, dk, dqkv, B, L, H, D, Dp, scale, stream);
    case 4: return bwd_launch<4>(maps, lse, delta, dq, dk, dqkv, B, L, H, D, Dp, scale, stream);
    default: break;
  }
  const int nbox = (Dp + 63) / 64, ntiles = (L + kStRows - 1) / kStRows;
  const dim3 grid(ntiles * nbox, H, B);
  int err = (int)launch(attention_stream_wide_bwd_kv_kernel, grid, dim3(kStThreads),
                        kStWideSmem, stream, maps[0], maps[1], maps[2], maps[3],
                        (const float*)lse, (const float*)delta, (float*)dk, (bf16*)dqkv, L, H, D,
                        Dp, scale);
  if (err != 0) return err;
  return (int)launch(attention_stream_wide_bwd_q_kernel, grid, dim3(kStThreads), kStWideSmem,
                     stream, maps[0], maps[1], maps[2], maps[3], (const float*)lse,
                     (const float*)delta, (float*)dq, L, H, Dp, scale);
}

// lanes a (row, head) in the prep and post passes: its vectors rounded up
// to a power of two, at most a warp
int vec_lanes(int vectors) {
  int g = 1;
  while (g < 32 && g < vectors) g *= 2;
  return g;
}

// the widest of 8, 4, 2, 1 elements dividing D / 2 and every stride (in
// elements), with every bf16 base aligned to that many elements and every
// f32 base (read 4 at a time from 4 up) to 16 bytes or one element
int vec_width(int half, const long long* strides, int nstrides, const void* const* bases,
              int nbases, const void* const* fbases, int nfbases) {
  int v = 8;
  for (; v > 1; v /= 2) {
    bool ok = half % v == 0;
    for (int i = 0; ok && i < nstrides; ++i) ok = strides[i] % v == 0;
    for (int i = 0; ok && i < nbases; ++i) ok = (size_t)bases[i] % (2 * v) == 0;
    for (int i = 0; ok && i < nfbases; ++i) ok = (size_t)fbases[i] % (v >= 4 ? 16 : 4) == 0;
    if (ok) break;
  }
  return v;
}

template <int V>
int prep_launch_v(const void* qkv, const void* gq, const void* gk, const void* cos_t,
                  const void* sin_t, void* rq, void* rk, void* rv, const void* dout,
                  const void* o, void* rdo, void* delta, int B, int L, int H, int D, int Dp,
                  cudaStream_t stream) {
  const int G = vec_lanes(D / 2 / V);
  const size_t units = (size_t)B * L * H, per_block = (size_t)kStPrepWarps * (32 / G);
  const dim3 grid((unsigned)((units + per_block - 1) / per_block));
  return (int)launch(attention_prep_kernel<V>, grid, dim3(kStPrepWarps * 32), 0, stream,
                     (const bf16*)qkv, (const bf16*)gq, (const bf16*)gk, (const bf16*)cos_t,
                     (const bf16*)sin_t, (bf16*)rq, (bf16*)rk, (bf16*)rv, (const bf16*)dout,
                     (const bf16*)o, (bf16*)rdo, (float*)delta, B * L, L, H, D, Dp, G);
}

// the prep pass; its width and lanes follow from the shape and the bases,
// which the forward and the backward share but for dO and O (as aligned)
int prep_launch(const void* qkv, const void* gq, const void* gk, const void* cos_t,
                const void* sin_t, void* rq, void* rk, void* rv, const void* dout,
                const void* o, void* rdo, void* delta, int B, int L, int H, int D, int Dp,
                cudaStream_t stream) {
  const long long dp = Dp;
  const void* bases[] = {qkv, gq, gk, cos_t, sin_t, rq, rk, rv, dout, o, rdo};
  switch (vec_width(D / 2, &dp, 1, bases, 11, nullptr, 0)) {
    case 8:
      return prep_launch_v<8>(qkv, gq, gk, cos_t, sin_t, rq, rk, rv, dout, o, rdo, delta, B, L,
                              H, D, Dp, stream);
    case 4:
      return prep_launch_v<4>(qkv, gq, gk, cos_t, sin_t, rq, rk, rv, dout, o, rdo, delta, B, L,
                              H, D, Dp, stream);
    case 2:
      return prep_launch_v<2>(qkv, gq, gk, cos_t, sin_t, rq, rk, rv, dout, o, rdo, delta, B, L,
                              H, D, Dp, stream);
    default:
      return prep_launch_v<1>(qkv, gq, gk, cos_t, sin_t, rq, rk, rv, dout, o, rdo, delta, B, L,
                              H, D, Dp, stream);
  }
}

template <typename T, int V>
int post_launch_v(const T* dq, const T* dk, const bf16* dv, PostStrides strides, const void* qkv,
                  const void* gq, const void* gk, const void* cos_t, const void* sin_t,
                  void* dqkv, void* dg, int B, int L, int H, int D, cudaStream_t stream) {
  const int nv = D / 2 / V, G = vec_lanes(nv);
  const dim3 grid((unsigned)((B * L + kStChunk - 1) / kStChunk), (unsigned)((nv + G - 1) / G));
  return (int)launch(attention_post_kernel<T, V>, grid, dim3(kStPostWarps * 32), 0, stream,
                     (const bf16*)qkv, (const bf16*)gq, (const bf16*)gk, (const bf16*)cos_t,
                     (const bf16*)sin_t, dq, dk, dv, strides, (bf16*)dqkv, (float*)dg, B * L, L,
                     H, D, G);
}

// the post pass into dqkv's q and k columns (and v's, where dv is given)
// and the gamma partials dg (ceil(B L / kStChunk), 2, D) f32
template <typename T>
int post_launch(const T* dq, const T* dk, const bf16* dv, PostStrides strides, const void* qkv,
                const void* gq, const void* gk, const void* cos_t, const void* sin_t, void* dqkv,
                void* dg, int B, int L, int H, int D, cudaStream_t stream) {
  constexpr bool f32 = sizeof(T) == 4;
  const long long s[] = {strides.row[0], strides.row[1], strides.row[2],
                         strides.head[0], strides.head[1], strides.head[2]};
  const void* bases[] = {qkv, gq, gk, cos_t, sin_t, dv, dqkv, f32 ? nullptr : dq,
                         f32 ? nullptr : dk};
  const void* fbases[] = {dq, dk};
  switch (vec_width(D / 2, s, 6, bases, 9, fbases, f32 ? 2 : 0)) {
    case 8:
      return post_launch_v<T, 8>(dq, dk, dv, strides, qkv, gq, gk, cos_t, sin_t, dqkv, dg, B, L,
                                 H, D, stream);
    case 4:
      return post_launch_v<T, 4>(dq, dk, dv, strides, qkv, gq, gk, cos_t, sin_t, dqkv, dg, B, L,
                                 H, D, stream);
    case 2:
      return post_launch_v<T, 2>(dq, dk, dv, strides, qkv, gq, gk, cos_t, sin_t, dqkv, dg, B, L,
                                 H, D, stream);
    default:
      return post_launch_v<T, 1>(dq, dk, dv, strides, qkv, gq, gk, cos_t, sin_t, dqkv, dg, B, L,
                                 H, D, stream);
  }
}

}  // namespace

}  // namespace odt

// K7/K8 at a head dim without its own instantiation: q, k, v (B, L, H, Dp)
// bf16 (Dp = D rounded up to 8, zero past D), out (B, L, H D); lse may be null
extern "C" int odt_attention_stream_fwd(const void* q, const void* k, const void* v, void* out,
                                        void* lse, int B, int L, int H, int D, int Dp,
                                        float scale, void* stream) {
  using namespace odt;
  if (B < 1 || L < 1 || H < 1 || D < 1 || Dp < D || Dp % 8) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[3];
  const void* bases[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err = stream_map(&maps[i], bases[i], Dp, H, L, B);
    if (err != cudaSuccess) return (int)err;
  }
  return stream_fwd(maps, out, lse, B, L, H, D, Dp, scale, (cudaStream_t)stream);
}

// K9 streamed: the prep pass into rq, rk and (unless rv is null, which
// needs Dp == D: v is then read from qkv) rv (B, L, H, Dp) bf16 scratch,
// then the forward; lse may be null (no gradient will be taken)
extern "C" int odt_fused_attention_stream_fwd(const void* qkv, const void* gq, const void* gk,
                                              const void* cos_t, const void* sin_t, void* rq,
                                              void* rk, void* rv, void* out, void* lse, int B,
                                              int L, int H, int D, int Dp, float scale,
                                              void* stream) {
  using namespace odt;
  if (B < 1 || L < 1 || H < 1 || D < 2 || D % 2 || Dp < D || Dp % 8 ||
      (rv == nullptr && Dp != D))
    return (int)cudaErrorInvalidValue;
  const int err = prep_launch(qkv, gq, gk, cos_t, sin_t, rq, rk, rv, nullptr, nullptr, nullptr,
                              nullptr, B, L, H, D, Dp, (cudaStream_t)stream);
  if (err != 0) return err;
  CUtensorMap maps[3];
  cudaError_t e = stream_map(&maps[0], rq, Dp, H, L, B);
  if (e == cudaSuccess) e = stream_map(&maps[1], rk, Dp, H, L, B);
  if (e == cudaSuccess) e = v_map(&maps[2], qkv, rv, D, Dp, H, L, B);
  if (e != cudaSuccess) return (int)e;
  return stream_fwd(maps, out, lse, B, L, H, D, Dp, scale, (cudaStream_t)stream);
}

// K10 streamed: the prep pass (rq, rk, rv as K9's, delta (B, H, L) f32,
// and dO padded into rdo unless rdo is null, which needs Dp == D), the dK/dV
// launch into dk (B, L, H, Dp) f32 scratch and dV's columns of dqkv, the dQ
// launch into dq (the same as dk), and the post pass into dqkv's q and k
// columns and the gamma partials dg (ceil(B L / 32), 2 D) f32: q's D
// columns, then k's
extern "C" int odt_fused_attention_stream_bwd(
    const void* qkv, const void* dout, const void* out, const void* lse, const void* gq,
    const void* gk, const void* cos_t, const void* sin_t, void* rq, void* rk, void* rv, void* rdo,
    void* delta, void* dq, void* dk, void* dqkv, void* dg, int B, int L, int H, int D, int Dp,
    float scale, void* stream) {
  using namespace odt;
  const cudaStream_t st = (cudaStream_t)stream;
  if (B < 1 || L < 1 || H < 1 || D < 2 || D % 2 || Dp < D || Dp % 8 ||
      ((rdo == nullptr || rv == nullptr) && Dp != D))
    return (int)cudaErrorInvalidValue;
  int err = prep_launch(qkv, gq, gk, cos_t, sin_t, rq, rk, rv, dout, out, rdo, delta, B, L, H, D,
                        Dp, st);
  if (err != 0) return err;
  CUtensorMap maps[4];
  cudaError_t e = stream_map(&maps[0], rq, Dp, H, L, B);
  if (e == cudaSuccess) e = stream_map(&maps[1], rk, Dp, H, L, B);
  if (e == cudaSuccess) e = v_map(&maps[2], qkv, rv, D, Dp, H, L, B);
  if (e == cudaSuccess) e = stream_map(&maps[3], rdo != nullptr ? rdo : dout, Dp, H, L, B);
  if (e != cudaSuccess) return (int)e;
  err = stream_bwd(maps, lse, delta, dq, dk, dqkv, B, L, H, D, Dp, scale, st);
  if (err != 0) return err;
  const long long row = (long long)H * Dp;
  return post_launch((const float*)dq, (const float*)dk, nullptr, {{row, row, 0}, {Dp, Dp, 0}},
                     qkv, gq, gk, cos_t, sin_t, dqkv, dg, B, L, H, D, st);
}

// The long attention backward (the training counterpart of K7/K8, whose q
// and k arrive normalised and rotated: no prep pass and no post pass): q,
// k, v (B, L, H, Dp) bf16 as the streamed forward read them (zero past D),
// out and dout (B, L, H D) bf16, lse (B, H, L) f32 from that forward. The
// delta pass into delta (B, H, L) f32 and dO padded into rdo (B, L, H, Dp)
// unless rdo is null, which needs Dp == D; the dK/dV launch into dk (B, L,
// H, Dp) f32 scratch and dV (bf16) into the v columns of dqkv (B, L, 3 H De,
// De = D rounded up to even: the launch stores column pairs; its q and k
// columns and a column past an odd D are not written); the dQ launch into
// dq (as dk)
extern "C" int odt_attention_stream_bwd(const void* q, const void* k, const void* v,
                                        const void* out, const void* dout, const void* lse,
                                        void* delta, void* rdo, void* dq, void* dk, void* dqkv,
                                        int B, int L, int H, int D, int Dp, float scale,
                                        void* stream) {
  using namespace odt;
  const cudaStream_t st = (cudaStream_t)stream;
  if (B < 1 || L < 1 || H < 1 || D < 1 || Dp < D || Dp % 8 || (rdo == nullptr && Dp != D))
    return (int)cudaErrorInvalidValue;
  const int err = delta_launch(dout, out, rdo, delta, nullptr, 0, B, L, H, D, Dp, st);
  if (err != 0) return err;
  CUtensorMap maps[4];
  const void* bases[4] = {q, k, v, rdo != nullptr ? rdo : dout};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t e = stream_map(&maps[i], bases[i], Dp, H, L, B);
    if (e != cudaSuccess) return (int)e;
  }
  return stream_bwd(maps, lse, delta, dq, dk, dqkv, B, L, H, D + (D & 1), Dp, scale, st);
}

// The long route's q/k norm and RoPE ahead of K7 (ops/norm_rope.py), the
// JAX package's `rope(rms_norm(q, q_gamma))` and `rope(rms_norm(k,
// k_gamma))` before `long_flash_attention`, which XLA fuses: K9's prep pass
// at Dp = D, qkv (B, L, 3 H D) bf16 -> q, k and v's copy (B, L, H, D) bf16
extern "C" int odt_qk_prep(const void* qkv, const void* gq, const void* gk, const void* cos_t,
                           const void* sin_t, void* q, void* k, void* v, int B, int L, int H,
                           int D, void* stream) {
  using namespace odt;
  if (B < 1 || L < 1 || H < 1 || D < 2 || D % 2) return (int)cudaErrorInvalidValue;
  return prep_launch(qkv, gq, gk, cos_t, sin_t, q, k, v, nullptr, nullptr, nullptr, nullptr, B, L,
                     H, D, D, (cudaStream_t)stream);
}

// Its backward: K10's post pass on dq, dk, dv (B, L, H, D) bf16 whose
// element (b, l, h, j) lies at (b L + l) row + h head + j (strides in
// elements, one pair each) -> dqkv (B, L, 3 H D) bf16, v's columns copied,
// and the gamma partials dg (ceil(B L / 32), 2, D) f32 (q's, then k's)
extern "C" int odt_qk_post(const void* qkv, const void* gq, const void* gk, const void* cos_t,
                           const void* sin_t, const void* dq, const void* dk, const void* dv,
                           long long dq_row, long long dq_head, long long dk_row,
                           long long dk_head, long long dv_row, long long dv_head, void* dqkv,
                           void* dg, int B, int L, int H, int D, void* stream) {
  using namespace odt;
  if (B < 1 || L < 1 || H < 1 || D < 2 || D % 2) return (int)cudaErrorInvalidValue;
  return post_launch((const bf16*)dq, (const bf16*)dk, (const bf16*)dv,
                     {{dq_row, dk_row, dv_row}, {dq_head, dk_head, dv_head}}, qkv, gq, gk, cos_t,
                     sin_t, dqkv, dg, B, L, H, D, (cudaStream_t)stream);
}
