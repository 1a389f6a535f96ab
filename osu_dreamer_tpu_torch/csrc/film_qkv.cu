// Fused RMS norm + FiLM + add + packed qkv projection for Hopper: the forward
// (K11) and its backward (K12).
//
// Replaces the Pallas TPU kernels osu_dreamer_tpu/ops/film_qkv.py
// `_fwd_kernel` (launched by `_fwd_impl`, film_qkv.py:122) and `_bwd_kernel`
// (launched by `_bwd_impl`, film_qkv.py:235). Per position of x (B, L, C):
//
//   y   = rms(x) * (1 + scale) + shift + add    f32 statistics, each op bf16
//   out = y W + b                               W (C, F), F = 3 x heads x 64
//
// On the main path (the denoiser with OSU_DREAMER_FUSED_PROLOGUE=1) it is the
// qkv prologue of every backbone layer: C 512 (or 384), F 3072, at B128 L152
// in training and B4 L759 in inference.
//
// Forward (film_qkv_fwd_kernel, TMA + wgmma). Rows are flat over B L, as in
// ffn_core.cuh: a row looks up its batch row's (1 + scale, shift). Work items
// are (row tile, 128-column group); each persistent CTA (one an SM) takes
// whole tiles, then a share of one tile's column groups, so it builds y at
// most once more than its whole tiles (at B4 L759: 5.5 CTAs a tile, one
// build each; at B128 L152: one whole tile and a share of one of the 20
// left over, two builds) and the slowest CTA is not left with extra builds.
// A row tile is 128 rows, two consumer warpgroups of 64,
// while y (128 x C bf16) fits beside the ring (C <= 512), else 64 rows and
// one warpgroup (C 640 to 1024). A producer thread issues every TMA load
// through one ring of 16 KB stages: at a new tile the first add boxes (64
// columns each, as many as the ring holds) while the last tile's products
// run, x straight into the y tiles (128-byte swizzle, the A operand layout)
// once those products are done with them, the remaining add boxes, then per
// item the W tiles (64 rows x 128 columns, read MN-major from W (C, F) as it
// is). The consumers take 1/rms of each row
// from the x tiles (a warp a row, summed in fq_row's order), then turn x
// into y in place box by box with fq_vec, the arithmetic K12 recomputes y
// with (so the two agree bit for bit); the products run on wgmma (m64n64,
// A = y K-major, B = W MN-major, f32 accumulate over C); the epilogue rounds
// to bf16, adds the bias in bf16 (as the plain version and flax's Dense do;
// the Pallas kernel adds it in f32 and rounds once, within one ulp of this)
// and leaves by TMA stores through two 64 x 64 tiles a warpgroup, rows past
// B L outside the map. Rebuilding y per column group would re-read x and
// add (256 KB a 128-row tile at C 512) for every 128 columns. Multicasting
// W over 2-CTA clusters (CTAs on two row tiles in lockstep) measured slower:
// the W stream is not what limits it.
//
// Backward (K12): a y pass, the row pass (film_qkv_bwd_kernel, TMA + wgmma),
// dW on csrc/gemm_tn.cuh, two fixed-order reductions. Per row the Pallas
// kernel recomputes y, forms dy = g W^T, writes dadd = dy and
// dx = inv dxn - inv^3 x mean_C(dxn x) with dxn = dy (1 + scale), and sums
// dy (dshift) and dy xn (dscale) per batch row and g (db) over all rows; it
// carries those sums and dW = y^T g across its ordered grid. Hopper blocks
// run in no order and the gradients must repeat bit for bit, so there are no
// float atomics: partial sums go to scratch and are summed in index order.
//
// - y pass (fq_y_kernel): a warp a row, fq_row's order and fq_vec, so the y
//   K11 multiplies is the y written here bit for bit; it also writes 1/rms
//   of the row. A pass of its own keeps the row recompute (latency-bound
//   loads of x and add, at 60 MB about 18 us at the training shape) off the
//   consumers of the row pass, at the price of reading x once more there.
// - row pass: dy = g W^T on wgmma, g (B L, F) as wgmma's K-major A operand
//   and W (C, F) as stored, the K-major B operand of W^T. Rows are flat over
//   B L in tiles of 128 (two consumer warpgroups of 64 rows). dy of 64 rows x
//   C columns in f32 takes C / 2 registers a thread of a warpgroup, so a CTA
//   holds at most 256 columns (four 64-column boxes, 128 accumulator
//   registers): the ceil(C / 256) CTAs of a tile form a cluster and split
//   its columns (fqb_cluster, fqb_boxes: C 384 two CTAs of 3 boxes, C 512
//   two of 4, C 640 three of 4, C 1024 four of 4; where the last CTA's
//   boxes run past C the TMA fills W with zeros and those columns are not
//   written). Each CTA streams its W columns once per 128-row tile (at
//   64-row tiles the W pass from L2 gives the tensor cores too few
//   operations a byte). One producer thread issues, per 64 columns of F, a
//   128 x 64 g box and the CTA's W boxes into one ring stage, and after a
//   tile's last such stage its x boxes and the scale rows of its first 8
//   batch rows. The consumers run one m64 n(64 nb) k16 product a k16 step
//   (n256 at C 512), release the previous stage, and meanwhile sum the g
//   box's columns for db (each CTA of the cluster every n-th box of F, a
//   reduce-scatter over the row lanes), so g is read for db from shared
//   memory. The g tile is not multicast: a cluster's CTAs take the same
//   tile at the same time and the second read hits L2. Persistent clusters
//   (as many as the device holds at once) walk tiles cid, cid + P, ...
//   Epilogue, per thread two rows and 16 columns a box, x and scale read
//   from the tile's x and scale boxes: dadd = bf16(dy) and each row's
//   partial sum of dxn x over the CTA's columns; the row sums go to every
//   CTA of the cluster (st.shared::cluster and a release-arrive on each
//   one's mbarrier, the exchange buffers alternating by tile so that a
//   peer's next write never meets a read), each CTA adds the n partials in
//   rank order, so all of them use the same mean; then dx. dadd and dx
//   leave box by box through a staging tile in coalesced 16-byte stores.
//   The film sums are split at batch-row boundaries (a tile, even a warp's
//   16 rows, may hold rows of several batch rows): each warp sums its rows
//   of each batch row it meets into one partial per (warp, batch row), a
//   reduce-scatter over its 8 row lanes; fq_film_reduce_kernel sums each
//   batch row's partials in warp order, fq_reduce_kernel db's half tiles in
//   eight fixed runs.
//
// What bounds them on the H100: at B128 L152 C512 F3072 the forward's product
// is 61.2 GFLOP against 162 MB of inputs and outputs (62 us vs 48 us: compute);
// the backward's row pass 61.2 GFLOP against about 220 MB (62 us vs 66 us)
// and dW another 61.2 GFLOP over 140 MB. The forward's W (3 MB) streams
// from L2 once per row tile (152 x 3 MB at B128 L152), about as many bytes a
// second as the tensor cores' rate asks; the backward's row pass the same.
// The row pass takes about 0.18 ms there (NVIDIA H100 80GB HBM3, 700 W,
// tools/step_profile.py): per 128-row tile about 75k cycles of products,
// fed at about 38 bytes a cycle an SM (the ring, not the tensor cores, sets
// it; the db sums add about 14k), and 45k of epilogue. Three choices keep
// the epilogue and the ring from stalling: the shared-memory base is aligned
// by an offset, since a round trip through an integer turns every shared
// access into a generic one; the scale's fallback load is predicated in
// PTX, since a load issued speculatively after the cluster's acquire,
// which empties L1, costs an L2 round trip a value; and the consumers sum
// db, since producer warps doing it held each stage until their slowest.
#include "gemm_tn.cuh"

namespace odt {

// ---- y, shared by K11 and K12 (K12 recomputes K11's y bit for bit) ----

// s += x^2 over one 16-byte vector of 8 bf16 x values, in order
__device__ __forceinline__ void fq_sumsq8(const int4 raw, float& s) {
  const bf16* p = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const float v = __bfloat162float(p[q]);
    s += v * v;
  }
}

// 1 / rms of a row from its sum of squares
__device__ __forceinline__ float fq_inv(float s, int C) { return rsqrtf(s / C + 1e-6f); }

// 8 values of y = bf16(bf16(bf16(bf16(x inv) bf16(1 + sc)) + sh) + add)
__device__ __forceinline__ int4 fq_vec(const int4 xr, const int4 ar, const int4 sr, const int4 hr,
                                       float inv) {
  const bf16 *x = reinterpret_cast<const bf16*>(&xr), *a = reinterpret_cast<const bf16*>(&ar),
             *sc = reinterpret_cast<const bf16*>(&sr), *sh = reinterpret_cast<const bf16*>(&hr);
  int4 packed;
  bf16* o = reinterpret_cast<bf16*>(&packed);
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    float y = bfr(bfr(__bfloat162float(x[q]) * inv) * bfr(1.f + __bfloat162float(sc[q])));
    y = bfr(y + __bfloat162float(sh[q]));
    o[q] = __float2bfloat16(y + __bfloat162float(a[q]));
  }
  return packed;
}

// One row's y, computed by one warp from global memory (K12): lane owns the
// 8-column vectors lane + 32 j, summed in that order (K11 sums its shared
// tiles in the same order) -> inv.
template <int MaxV>
__device__ __forceinline__ float fq_row(const bf16* xr, const bf16* ar, const bf16* sc,
                                        const bf16* sh, int C, bf16* yr) {
  const int lane = threadIdx.x & 31, nv = C / 8;
  int4 xv[MaxV];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < MaxV; ++j) {
    const int v = lane + 32 * j;
    if (v >= nv) break;
    xv[j] = *reinterpret_cast<const int4*>(xr + v * 8);
    fq_sumsq8(xv[j], s);
  }
  const float inv = fq_inv(warp_sum(s), C);
#pragma unroll
  for (int j = 0; j < MaxV; ++j) {
    const int v = lane + 32 * j;
    if (v >= nv) break;
    *reinterpret_cast<int4*>(yr + v * 8) =
        fq_vec(xv[j], *reinterpret_cast<const int4*>(ar + v * 8),
               *reinterpret_cast<const int4*>(sc + v * 8), *reinterpret_cast<const int4*>(sh + v * 8), inv);
  }
  return inv;
}

// ------------------------------------------------------------- forward ----

constexpr int kFqfCols = 128;                  // output columns a work item
constexpr uint32_t kFqfTile = 64 * 64 * 2;     // a 64 x 64 bf16 128-byte-swizzled tile
constexpr uint32_t kFqfStage = 2 * kFqfTile;   // a ring stage: W (64 rows x 128 columns) or an add box
constexpr int kFqfMaxStages = 8;

// byte offsets from the 1024-aligned base: the y tiles (C / 64 x NWG), the
// ring, the epilogue tiles (two a warpgroup), 1/rms of the tile's rows, the
// barriers
struct FqfLayout {
  size_t ring, epi, rinv, bars, total;
  __host__ __device__ FqfLayout(int C, int nwg, int stages) {
    ring = (size_t)(C / 64) * nwg * kFqfTile;
    epi = ring + (size_t)stages * kFqfStage;
    rinv = epi + (size_t)nwg * 2 * kFqfTile;
    bars = rinv + (size_t)64 * nwg * sizeof(float);
    total = bars + (2 * kFqfMaxStages + 2) * sizeof(uint64_t) + 1024;  // + slack to align the base
  }
};

// consumer warpgroups of 64 rows: two while a 128-row y fits beside the ring
// (C <= 512), else one (ops/film_qkv.py fwd_plan mirrors it)
inline int fqf_warpgroups(int C) { return C <= 512 ? 2 : 1; }

inline int fqf_stages(int C, int nwg) {
  const size_t fixed = FqfLayout(C, nwg, 0).total;
  if (fixed > kMaxSmem) return 0;
  const size_t n = (kMaxSmem - fixed) / kFqfStage;
  return (int)(n < kFqfMaxStages ? n : kFqfMaxStages);
}

struct FqfArgs {
  const bf16* scale;  // (B, C)
  const bf16* shift;  // (B, C)
  const bf16* bias;   // (F)
  bf16* y_out;        // (B L, C) or null: a test hook, the y tiles as built
  int BL, L, C, F, stages;
};

__device__ __forceinline__ uint32_t fqf_pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int NWG>
__device__ __forceinline__ void fqf_consumers_sync() {
  hopper::named_barrier<1, NWG * 128>();
}

__device__ __forceinline__ void fqf_wg_sync(int wg) {
  if (wg == 0) hopper::named_barrier<2, 128>();
  else hopper::named_barrier<3, 128>();
}

template <int NWG>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
film_qkv_fwd_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_add,
                    const __grid_constant__ CUtensorMap tm_w, const __grid_constant__ CUtensorMap tm_out,
                    const FqfArgs a) {
  using namespace hopper;
  constexpr int kRows = 64 * NWG;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const FqfLayout lay(a.C, NWG, a.stages);
  unsigned char* ys = smem;
  unsigned char* ring = smem + lay.ring;
  float* rinv = reinterpret_cast<float*>(smem + lay.rinv);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* empty = full + kFqfMaxStages;
  uint64_t* xfull = empty + kFqfMaxStages;
  uint64_t* yfree = xfull + 1;
  const int kt = a.C / 64, ngrp = a.F / kFqfCols, nst = a.stages;
  // the CTA's work items (row tile, 128-column group): ntiles / G whole
  // tiles [a0, a1), then [c0, c1), its share of one of the R tiles left
  // over, whose column groups the CTAs of that tile split (with G >= ntiles
  // that share is all the CTA does). Consecutive items share their row tile
  // and its y, and a CTA builds y at most once more than its whole tiles.
  const int ntiles = (a.BL + kRows - 1) / kRows, G = gridDim.x, b = blockIdx.x;
  const int whole = ntiles / G, R = ntiles - G * whole;
  const int a0 = b * whole * ngrp, a1 = a0 + whole * ngrp;
  int c0 = 0, c1 = 0;
  if (R > 0) {
    const int t = (int)((long long)b * R / G);
    const int b0 = (int)(((long long)t * G + R - 1) / R);
    const int n = (int)(((long long)(t + 1) * G + R - 1) / R) - b0;
    c0 = (G * whole + t) * ngrp + (b - b0) * ngrp / n;
    c1 = (G * whole + t) * ngrp + (b - b0 + 1) * ngrp / n;
  }
  const int nitems = a1 - a0 + c1 - c0;
  auto item_at = [&](int k) { return k < a1 - a0 ? a0 + k : c0 + k - (a1 - a0); };
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < nst; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], NWG * 4);  // one arrival per consumer warp
    }
    mbar_init(xfull, 1);
    mbar_init(yfree, NWG * 4);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == NWG) {
    // producer warpgroup: one thread issues every load, in the order consumed
    setmaxnreg_dec<40>();
    if (threadIdx.x % 128 == 0) {
      int it = 0, tiles = 0, prev = -1;
      auto stage = [&](uint32_t bytes) {
        const int st = it % nst;
        if (it >= nst) mbar_wait(&empty[st], (it / nst - 1) & 1);
        mbar_arrive_expect_tx(&full[st], bytes);
        ++it;
        return ring + (size_t)st * kFqfStage;
      };
      auto bar = [&]() { return &full[(it - 1) % nst]; };
      for (int k = 0; k < nitems; ++k) {
        const int item = item_at(k), tile = item / ngrp, grp = item % ngrp;
        if (tile != prev) {
          // the first add boxes through the ring while the last tile's
          // products run (as many as the ring holds: a stage beyond that
          // frees only once the consumers have x), then x straight into the
          // y tiles once those products are done with them, then the rest
          const int pre = kt < nst ? kt : nst;
          auto add_box = [&](int c) {
            unsigned char* dst = stage(kRows * 128);
            tma_load_3d(dst, &tm_add, bar(), c * 64, tile * kRows, 0);
          };
          for (int c = 0; c < pre; ++c) add_box(c);
          if (tiles > 0) mbar_wait(yfree, (tiles - 1) & 1);
          mbar_arrive_expect_tx(xfull, (uint32_t)kt * kRows * 128);
          for (int c = 0; c < kt; ++c)
            tma_load_3d(ys + (size_t)c * NWG * kFqfTile, &tm_x, xfull, c * 64, tile * kRows, 0);
          for (int c = pre; c < kt; ++c) add_box(c);
          ++tiles;
          prev = tile;
        }
        // W rows 64 c.. of the group's 128 columns, MN-major
        for (int c = 0; c < kt; ++c) {
          unsigned char* dst = stage(kFqfStage);
          tma_load_3d(dst, &tm_w, bar(), grp * kFqfCols, c * 64, 0);
          tma_load_3d(dst + kFqfTile, &tm_w, bar(), grp * kFqfCols + 64, c * 64, 0);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<NWG == 2 ? 232 : 240>();

  const int tid = threadIdx.x % 128, lane = tid % 32, cwarp = threadIdx.x / 32;
  const int r0 = (tid / 32) * 16 + lane / 4;  // this thread's rows of the warpgroup: r0, r0 + 8
  int it = 0, tiles = 0, prev = -1;
  auto wait_full = [&]() {
    const int st = it % nst;
    mbar_wait(&full[st], (it / nst) & 1);
    return ring + (size_t)st * kFqfStage;
  };
  auto release = [&](int item) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[item % nst]);
  };

  for (int k = 0; k < nitems; ++k) {
    const int item = item_at(k), tile = item / ngrp, grp = item % ngrp, row0 = tile * kRows;
    if (tile != prev) {
      mbar_wait(xfull, tiles & 1);
      // 1 / rms of each row (a warp a row, four rows at a time) from its x
      // tiles, each summed in fq_row's order: lane l takes the 8-column
      // vectors l + 32 j
      for (int e0 = cwarp * 4; e0 < kRows; e0 += NWG * 16) {
        float s[4] = {0.f, 0.f, 0.f, 0.f};
        for (int v = lane; v < kt * 8; v += 32) {
          const unsigned char* col = ys + (size_t)(v / 8) * NWG * kFqfTile;
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int e = e0 + r;
            fq_sumsq8(*reinterpret_cast<const int4*>(col + (size_t)(e / 64) * kFqfTile +
                                                     swizzle128(e % 64, (v % 8) * 8)),
                      s[r]);
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float t = warp_sum(s[r]);
          if (lane == 0) rinv[e0 + r] = fq_inv(t, a.C);
        }
      }
      fqf_consumers_sync<NWG>();
      // y in place of x, one add box (64 columns) at a time; the box and the
      // tiles share their 128-byte swizzle. Rows past B L stay zero.
      constexpr int kPer = kRows * 8 / (NWG * 128);  // 16-byte chunks a thread, a box
      for (int c = 0; c < kt; ++c, ++it) {
        const unsigned char* box = wait_full();
        int4 xv[kPer], av[kPer], sv[kPer], hv[kPer];
#pragma unroll
        for (int k = 0; k < kPer; ++k) {  // every load first, then the arithmetic
          const int idx = threadIdx.x + k * NWG * 128, e = idx / 8, g = row0 + e;
          const uint32_t off = (e / 64) * kFqfTile + swizzle128(e % 64, (idx % 8) * 8);
          xv[k] = *reinterpret_cast<const int4*>(ys + (size_t)c * NWG * kFqfTile + off);
          av[k] = *reinterpret_cast<const int4*>(box + off);
          const size_t fb = (size_t)(g < a.BL ? g / a.L : 0) * a.C + c * 64 + (idx % 8) * 8;
          sv[k] = __ldg(reinterpret_cast<const int4*>(a.scale + fb));
          hv[k] = __ldg(reinterpret_cast<const int4*>(a.shift + fb));
        }
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          const int idx = threadIdx.x + k * NWG * 128, e = idx / 8, g = row0 + e;
          const uint32_t off = (e / 64) * kFqfTile + swizzle128(e % 64, (idx % 8) * 8);
          int4 y = make_int4(0, 0, 0, 0);  // rows past B L stay zero
          if (g < a.BL) {
            y = fq_vec(xv[k], av[k], sv[k], hv[k], rinv[e]);
            if (a.y_out != nullptr)
              *reinterpret_cast<int4*>(a.y_out + (size_t)g * a.C + c * 64 + (idx % 8) * 8) = y;
          }
          *reinterpret_cast<int4*>(ys + (size_t)c * NWG * kFqfTile + off) = y;
        }
        release(it);
      }
      fence_proxy_async();  // y, written by threads, is read by wgmma
      fqf_consumers_sync<NWG>();
      ++tiles;
      prev = tile;
    }

    // the item's bias, loaded while the products run: columns 8 j + 2 q, + 1
    // of each 64-column half h
    float2 bias[2][8];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        bias[h][j] = __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(
            a.bias + grp * kFqfCols + h * 64 + j * 8 + (lane % 4) * 2)));

    // out tile = y W over C, 64 rows of W (one stage) a step, two 64-column
    // accumulators with W MN-major
    float acc0[32], acc1[32];
    for (int c = 0; c < kt; ++c, ++it) {
      unsigned char* w = wait_full();
      const uint64_t ad = wgmma_desc(ys + (size_t)(c * NWG + wg) * kFqfTile, 16, 1024);
      const uint64_t bd0 = wgmma_desc(w, 1024, 1024);
      const uint64_t bd1 = wgmma_desc(w + kFqfTile, 1024, 1024);
      fence_regs(acc0);
      fence_regs(acc1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_m64n64k16_ss_bt(acc0, ad + 2 * kk, bd0 + 128 * kk, (c | kk) != 0);
        wgmma_m64n64k16_ss_bt(acc1, ad + 2 * kk, bd1 + 128 * kk, (c | kk) != 0);
      }
      wgmma_commit();
      if (c > 0) {
        wgmma_wait<1>();
        fence_regs(acc0);
        fence_regs(acc1);
        release(it - 1);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc0);
    fence_regs(acc1);
    release(it - 1);
    if (k + 1 >= nitems || item_at(k + 1) / ngrp != tile) {  // the producer may load the next x
      __syncwarp();
      if (lane == 0) mbar_arrive(yfree);
    }

    // epilogue: bf16(bf16(y W) + b) into this warpgroup's two tiles once the
    // last item's stores have read them, then TMA stores (rows past B L
    // fall outside the map)
    unsigned char* epi = smem + lay.epi + (size_t)wg * 2 * kFqfTile;
    if (tid == 0) tma_store_wait_read();
    fqf_wg_sync(wg);
    auto put = [&](const float (&acc)[32], int h) {
      unsigned char* t = epi + h * kFqfTile;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = j * 8 + (lane % 4) * 2;
        *reinterpret_cast<uint32_t*>(t + swizzle128(r0, col)) =
            fqf_pack(bfr(acc[4 * j]) + bias[h][j].x, bfr(acc[4 * j + 1]) + bias[h][j].y);
        *reinterpret_cast<uint32_t*>(t + swizzle128(r0 + 8, col)) =
            fqf_pack(bfr(acc[4 * j + 2]) + bias[h][j].x, bfr(acc[4 * j + 3]) + bias[h][j].y);
      }
    };
    put(acc0, 0);
    put(acc1, 1);
    fence_proxy_async();
    fqf_wg_sync(wg);
    if (tid == 0) {
      tma_store_3d(&tm_out, epi, grp * kFqfCols, row0 + wg * 64, 0);
      tma_store_3d(&tm_out, epi + kFqfTile, grp * kFqfCols + 64, row0 + wg * 64, 0);
      tma_store_commit();
    }
  }
  if (tid == 0) tma_store_wait_read();
}

// ------------------------------------------------------------ backward ----

// the y K11 multiplies and 1 / rms of each row: a warp a row (fq_row)
__global__ void __launch_bounds__(256)
fq_y_kernel(const bf16* __restrict__ x, const bf16* __restrict__ add, const bf16* __restrict__ scale,
            const bf16* __restrict__ shift, bf16* __restrict__ y, float* __restrict__ rinv, int BL,
            int L, int C) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= BL) return;
  const size_t p = (size_t)row * C, b = (size_t)(row / L) * C;
  const float inv = fq_row<4>(x + p, add + p, scale + b, shift + b, C, y + p);
  if (threadIdx.x % 32 == 0) rinv[row] = inv;
}

constexpr int kFqbRows = 128;                   // rows a tile: two consumer warpgroups of 64
constexpr int kFqbMaxBoxes = 4;                 // 64-column boxes of dy a CTA (128 registers)
constexpr int kFqbMaxCluster = 4;               // CTAs a tile (C 1024)
constexpr uint32_t kFqbTile = 64 * 64 * 2;      // a 64 x 64 bf16 128-byte-swizzled tile
constexpr int kFqbMaxStages = 8;
constexpr int kFqbWarps = 8;                    // consumer warps
constexpr int kFqbScaleRows = 8;                // batch rows of scale a tile brings (a 1 KB box)

// the CTAs of a tile's cluster and the 64-column boxes of dy each holds
// (ops/film_qkv.py bwd_plan mirrors them)
inline int fqb_cluster(int C) { return (C / 64 + kFqbMaxBoxes - 1) / kFqbMaxBoxes; }
inline int fqb_boxes(int C) { return (C / 64 + fqb_cluster(C) - 1) / fqb_cluster(C); }

// batch rows the 16 flat rows of a consumer warp can meet: ceil(15 / L) + 1
inline int fqb_segments(int L) { return (14 + L) / L + 1; }

// byte offsets from the 1024-aligned base: the ring (a stage: the 128-row g
// box, then nb W boxes; after a tile's products, its x boxes), the output
// staging tile (two 64 x 64 halves, one a warpgroup), the exchanged row sums
// (two buffers x the cluster's CTAs x 128 rows), the barriers
struct FqbLayout {
  size_t stage, out, xch, bars, total;
  __host__ __device__ FqbLayout(int nb, int stages) {
    stage = (size_t)(2 + nb) * kFqbTile;
    out = (size_t)stages * stage;
    xch = out + 2 * kFqbTile;
    bars = xch + (size_t)2 * kFqbMaxCluster * kFqbRows * sizeof(float);
    total = bars + (2 * kFqbMaxStages + 2) * sizeof(uint64_t) + 1024;  // + slack to align the base
  }
};

inline int fqb_stages(int nb) {
  const size_t fixed = FqbLayout(nb, 0).total;
  if (fixed > kMaxSmem) return 0;
  const size_t n = (kMaxSmem - fixed) / FqbLayout(nb, 0).stage;
  return (int)(n < kFqbMaxStages ? n : kFqbMaxStages);
}

struct FqbArgs {
  const bf16* scale;  // (B, C)
  bf16* dx;           // (B L, C)
  bf16* dadd;         // (B L, C)
  const float* rinv;  // (B L): 1 / rms of each row, from the y pass
  float* part_film;   // (8 tiles, S, 2C): [dscale | dshift] of each (warp, batch row of its rows)
  float* part_db;     // (2 tiles, F): column sums of g, each half tile
  float* dyp;         // (B L, C) f32: dy itself, where the row pass stops there (PART)
  int BL, L, C, F, S, n, stages;
};

// the bf16 pair at p where `on`, else zeros: a predicated load the compiler
// cannot issue speculatively (after the cluster's acquire, which empties L1,
// an unneeded load of the scale costs an L2 round trip a value)
__device__ __forceinline__ __nv_bfloat162 fqb_ld2_if(const bf16* p, bool on) {
  uint32_t v = 0;
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n @q ld.global.nc.b32 %0, [%1];\n}"
      : "+r"(v)
      : "l"(p), "r"((int)on));
  return *reinterpret_cast<__nv_bfloat162*>(&v);
}

// v summed over the lanes that differ in lane bit `mask`, half of v kept:
// the lane with the bit set keeps the upper half. v[0, N / 2) holds the
// kept half's sums (a fixed pairing, so reruns are bit-identical).
template <int N>
__device__ __forceinline__ void fqb_halve(float (&v)[N], int mask) {
  const bool up = threadIdx.x & mask;
#pragma unroll
  for (int k = 0; k < N / 2; ++k) {
    const float keep = up ? v[k + N / 2] : v[k], send = up ? v[k] : v[k + N / 2];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
  }
}

// dy (64 rows x NB 64 columns) += A B over one k16 step: one product of N 64 NB
template <int NB>
__device__ __forceinline__ void fqb_mma(float (&d)[NB * 32], uint64_t a, uint64_t b, int scale) {
  if constexpr (NB == 4) hopper::wgmma_m64n256k16_ss(d, a, b, scale);
  else if constexpr (NB == 3) hopper::wgmma_m64n192k16_ss(d, a, b, scale);
  else if constexpr (NB == 2) hopper::wgmma_m64n128k16_ss(d, a, b, scale);
  else hopper::wgmma_m64n64k16_ss(d, a, b, scale);
}

// PART (the TP form's phase 0): dy leaves in f32 to a.dyp after the
// products, with no x boxes loaded and no epilogue
template <int NB, bool PART>
__global__ void __launch_bounds__(384, 1)
film_qkv_bwd_kernel(const __grid_constant__ CUtensorMap tm_g, const __grid_constant__ CUtensorMap tm_w,
                    const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_s,
                    const FqbArgs a) {
  using namespace hopper;
  // a tile's x boxes (128 rows x 64 columns, 16 KB) ride the ring after its
  // products, kXper to a stage, in kE stages; the last of them also brings
  // the scale of the tile's first kFqbScaleRows batch rows (NB 1 KB boxes,
  // at kSOff)
  constexpr int kXper = NB == 2 ? 1 : (2 + NB) / 2, kE = (NB + kXper - 1) / kXper;
  constexpr int kSOff = (NB - (kE - 1) * kXper) * 2 * kFqbTile;
  static_assert(kSOff + NB * kFqbScaleRows * 128 <= (2 + NB) * kFqbTile, "scale boxes fit");
  // the base aligned to 1024 by an offset, not through an integer, so that
  // the compiler keeps every pointer below in the shared space (ld.shared /
  // st.shared; a generic access to shared memory is several times slower)
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const FqbLayout lay(NB, a.stages);
  float* xch = reinterpret_cast<float*>(smem + lay.xch);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* empty = full + kFqbMaxStages;
  uint64_t* xfull = empty + kFqbMaxStages;  // two: the exchange buffers
  const uint32_t rank = cluster_rank();
  const int n = a.n, cid = blockIdx.x / n, P = gridDim.x / n, nst = a.stages;
  const int ntiles = (a.BL + kFqbRows - 1) / kFqbRows, nks = a.F / 64;
  const int c0 = (int)rank * NB * 64;  // the CTA's first column of dy
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < nst; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kFqbWarps);  // one arrival per consumer warp
    }
    mbar_init(&xfull[0], n * kFqbWarps);  // every consumer warp of every CTA of the cluster
    mbar_init(&xfull[1], n * kFqbWarps);
    mbar_fence_init();
  }
  cluster_sync();  // the peers' barriers exist before any arrival from this CTA

  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      // one thread issues every load, in the order consumed
      int it = 0;
      auto stage = [&](uint32_t bytes) {
        const int st = it % nst;
        if (it >= nst) mbar_wait(&empty[st], (it / nst - 1) & 1);
        mbar_arrive_expect_tx(&full[st], bytes);
        ++it;
        return st;
      };
      for (int tile = cid; tile < ntiles; tile += P) {
        for (int ks = 0; ks < nks; ++ks) {
          const int st = stage((2 + NB) * kFqbTile);
          unsigned char* dst = smem + (size_t)st * lay.stage;
          tma_load_3d(dst, &tm_g, &full[st], ks * 64, tile * kFqbRows, 0);
#pragma unroll
          for (int j = 0; j < NB; ++j)
            tma_load_3d(dst + (2 + j) * kFqbTile, &tm_w, &full[st], ks * 64, c0 + j * 64, 0);
        }
        // the x boxes inside C, then the scale boxes (none in PART)
        for (int e = 0; e < (PART ? 0 : kE); ++e) {
          int real = 0;
          for (int j = e * kXper; j < min(NB, (e + 1) * kXper); ++j) real += c0 + 64 * j < a.C;
          const int boxes = (c0 + 64 * NB <= a.C ? NB : (a.C - c0) / 64);
          const int st = stage(real * 2 * kFqbTile + (e == kE - 1 ? boxes * kFqbScaleRows * 128 : 0));
          unsigned char* dst = smem + (size_t)st * lay.stage;
          for (int j = e * kXper; j < min(NB, (e + 1) * kXper); ++j)
            if (c0 + 64 * j < a.C)
              tma_load_3d(dst + (j - e * kXper) * 2 * kFqbTile, &tm_x, &full[st], c0 + 64 * j,
                          tile * kFqbRows, 0);
          if (e == kE - 1)
            for (int j = 0; j < boxes; ++j)
              tma_load_3d(dst + kSOff + j * kFqbScaleRows * 128, &tm_s, &full[st], c0 + 64 * j,
                          tile * kFqbRows / a.L, 0);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<232>();

  const int tid = threadIdx.x % 128, lane = tid % 32, cw = threadIdx.x / 32;
  const int r0 = 16 * (cw % 4) + lane / 4;  // this thread's rows of its warpgroup: r0, r0 + 8
  const int cq = 2 * (lane % 4);            // and its columns of each 8-column group: cq, cq + 1
  unsigned char* ob = smem + lay.out + wg * kFqbTile;  // this warpgroup's output staging
  int it = 0, tc = 0;
  for (int tile = cid; tile < ntiles; tile += P, ++tc) {
    // ---- dy (64 rows x NB 64 columns a warpgroup) = g W^T over F: one
    // m64 n(64 NB) k16 product a k16 step, W's NB boxes as one K-major B
    float acc[NB * 32];
    for (int ks = 0; ks < nks; ++ks, ++it) {
      const int st = it % nst;
      mbar_wait(&full[st], (it / nst) & 1);
      const unsigned char* stg = smem + (size_t)st * lay.stage;
      const uint64_t ad = wgmma_desc(stg + wg * kFqbTile, 16, 1024);
      const uint64_t bd = wgmma_desc(stg + 2 * kFqbTile, 16, 1024);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fqb_mma<NB>(acc, ad + 2 * kk, bd + 2 * kk, (ks | kk) != 0);
      wgmma_commit();
      if (ks > 0) {
        wgmma_wait<1>();
        fence_regs(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(it - 1) % nst]);
      }
      // db while the products run (after the last stage's release, so that
      // it does not hold the ring): this CTA sums every n-th g box of F,
      // each warpgroup its 64 rows, warp wq columns 16 wq.. (lane: 8
      // columns, rows lane / 2 + 16 i), then over the 16 row lanes (a
      // reduce-scatter); one partial a (tile, warpgroup)
      if (ks % n == (int)rank) {
        const unsigned char* gt = stg + wg * kFqbTile;
        const int v = 2 * (cw % 4) + lane % 2, rg = lane / 2;
        float s8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = rg + 16 * i;
          const int4 raw = *reinterpret_cast<const int4*>(gt + r * 128 + (((v ^ r) & 7) << 4));
          const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 f = __bfloat1622float2(e[q]);
            s8[2 * q] += f.x;
            s8[2 * q + 1] += f.y;
          }
        }
        fqb_halve(s8, 2);  // lane bits 1, 2, 3 each halve the 8 sums, bit 4 adds
        fqb_halve(reinterpret_cast<float(&)[4]>(s8), 4);
        fqb_halve(reinterpret_cast<float(&)[2]>(s8), 8);
        s8[0] += __shfl_xor_sync(0xffffffffu, s8[0], 16);
        if (lane < 16)  // column 8 v + 4 bit1 + 2 bit2 + bit3
          a.part_db[((size_t)tile * 2 + wg) * a.F + ks * 64 + v * 8 + 4 * ((lane >> 1) & 1) +
                    2 * ((lane >> 2) & 1) + ((lane >> 3) & 1)] = s8[0];
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[(it - 1) % nst]);
    if constexpr (PART) {
      // dy in f32 at the thread's rows and column pairs (32-byte row segments)
      const int ra = tile * kFqbRows + 64 * wg + r0, rb = ra + 8;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        if (c0 + 64 * j >= a.C) continue;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int col = c0 + 64 * j + 8 * q + cq;
          if (ra < a.BL)
            *reinterpret_cast<float2*>(a.dyp + (size_t)ra * a.C + col) =
                make_float2(acc[32 * j + 4 * q], acc[32 * j + 4 * q + 1]);
          if (rb < a.BL)
            *reinterpret_cast<float2*>(a.dyp + (size_t)rb * a.C + col) =
                make_float2(acc[32 * j + 4 * q + 2], acc[32 * j + 4 * q + 3]);
        }
      }
      continue;
    }
    // the tile's x boxes
    const int xst = it % nst;  // the x stages: xst, xst + 1, .. (mod nst)
#pragma unroll
    for (int e = 0; e < kE; ++e, ++it) mbar_wait(&full[it % nst], (it / nst) & 1);
    auto xstage = [&](int e) { return smem + (size_t)((xst + e) % nst) * lay.stage; };

    // ---- epilogue. thread t holds acc[32 j + 4 q + e] at row r0 + 8 (e / 2)
    // of its warpgroup, column c0 + 64 j + 8 q + cq + e % 2; x comes from
    // the swizzled x boxes at the same place, dadd and dx leave through the
    // staging tile
    const int row0 = tile * kFqbRows;
    const int ra = row0 + 64 * wg + r0, rb = ra + 8;
    const bool va = ra < a.BL, vb = rb < a.BL;
    const int ba = va ? ra / a.L : -1, bb = vb ? rb / a.L : -1;
    const bf16* sa = a.scale + (size_t)(va ? ba : 0) * a.C;
    const bf16* sb = a.scale + (size_t)(vb ? bb : 0) * a.C;
    const float ia = va ? a.rinv[ra] : 0.f, ib = vb ? a.rinv[rb] : 0.f;
    // the batch rows of this warp's 16 rows (warp-uniform; none past B L)
    const int w0 = row0 + 16 * cw, w1 = min(a.BL - 1, w0 + 15);
    const int wb0 = w0 / a.L, wb1 = w0 < a.BL ? w1 / a.L : wb0 - 1;
    float* film = a.part_film + ((size_t)tile * kFqbWarps + cw) * a.S * 2 * a.C;
    // x and scale at the thread's rows ra, rb (h 0, 1) and columns c0 + 64 j
    // + 8 q + cq, + 1, read where they are used: x from the swizzled x box;
    // the scale from the scale boxes, or from global memory for a warp with
    // rows past the tile's first kFqbScaleRows batch rows
    const int b0 = row0 / a.L;  // the first batch row of the tile
    const int sra = va ? ba - b0 : 0, srb = vb ? bb - b0 : 0;
    const bool slow = __any_sync(0xffffffffu, sra >= kFqbScaleRows || srb >= kFqbScaleRows);
    const unsigned char* scl = xstage(kE - 1) + kSOff;
    auto xpair = [&](int j, int q, int h) {
      const unsigned char* xt = xstage(j / kXper) + (j % kXper) * 2 * kFqbTile + wg * kFqbTile;
      return __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(xt + swizzle128(r0 + 8 * h, 8 * q + cq)));
    };
    auto spair = [&](int j, int q, int h) {
      const __nv_bfloat162 g = fqb_ld2_if((h ? sb : sa) + c0 + 64 * j + 8 * q + cq, slow);
      const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
          scl + j * kFqbScaleRows * 128 +
          swizzle128(min(h ? srb : sra, kFqbScaleRows - 1), 8 * q + cq));
      return __bfloat1622float2(slow ? g : v);
    };
    // box j of dadd or dx (two values a row): into the staging tile, then
    // rows of 16-byte chunks to global memory (8 threads a 128-byte row)
    auto store_box = [&](bf16* out, int j, auto value) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float2 va2 = value(q, 0), vb2 = value(q, 1);
        *reinterpret_cast<__nv_bfloat162*>(ob + swizzle128(r0, 8 * q + cq)) =
            __floats2bfloat162_rn(va2.x, va2.y);
        *reinterpret_cast<__nv_bfloat162*>(ob + swizzle128(r0 + 8, 8 * q + cq)) =
            __floats2bfloat162_rn(vb2.x, vb2.y);
      }
      fqf_wg_sync(wg);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = tid / 8 + 16 * i, row = row0 + 64 * wg + r;
        const int4 chunk = *reinterpret_cast<const int4*>(ob + swizzle128(r, (tid % 8) * 8));
        if (row < a.BL)
          *reinterpret_cast<int4*>(out + (size_t)row * a.C + c0 + 64 * j + (tid % 8) * 8) = chunk;
      }
      fqf_wg_sync(wg);  // the staging tile is read before the next box writes it
    };
    // 16 film sums (index 2 q + e: column 8 q + cq + e) over the 8 row lanes
    // (lane bits 2, 3, 4), a reduce-scatter; the lane stores its two at
    // column 8 (k0 / 2) + cq, k0 = 8 bit2 + 4 bit3 + 2 bit4
    auto film_store = [&](float (&v)[16], float* dst) {
      fqb_halve(v, 4);
      fqb_halve(reinterpret_cast<float(&)[8]>(v), 8);
      fqb_halve(reinterpret_cast<float(&)[4]>(v), 16);
      const int k0 = 8 * ((lane >> 2) & 1) + 4 * ((lane >> 3) & 1) + 2 * ((lane >> 4) & 1);
      *reinterpret_cast<float2*>(dst + 8 * (k0 / 2) + cq) = make_float2(v[0], v[1]);
    };

    // pass 1: dadd = dy; each row's partial sum of dxn x over this CTA's
    // columns; the warp's film sums, one partial per batch row of its rows
    float pa = 0.f, pb = 0.f;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (c0 + 64 * j >= a.C) continue;  // a box past C (zero W rows)
      store_box(a.dadd, j, [&](int q, int h) {
        return make_float2(acc[32 * j + 4 * q + 2 * h], acc[32 * j + 4 * q + 2 * h + 1]);
      });
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float* d = &acc[32 * j + 4 * q];
        const float2 x0 = xpair(j, q, 0), s0 = spair(j, q, 0);
        const float2 x1 = xpair(j, q, 1), s1 = spair(j, q, 1);
        pa += d[0] * (1.f + s0.x) * x0.x;
        pa += d[1] * (1.f + s0.y) * x0.y;
        pb += d[2] * (1.f + s1.x) * x1.x;
        pb += d[3] * (1.f + s1.y) * x1.y;
      }
      for (int b = wb0; b <= wb1; ++b) {
        const bool ua = ba == b, ub = bb == b;
        float* dst = film + (size_t)(b - wb0) * 2 * a.C + c0 + 64 * j;
        float v[16];
#pragma unroll
        for (int q = 0; q < 8; ++q) {  // dshift: dy
          const float* d = &acc[32 * j + 4 * q];
          v[2 * q] = (ua ? d[0] : 0.f) + (ub ? d[2] : 0.f);
          v[2 * q + 1] = (ua ? d[1] : 0.f) + (ub ? d[3] : 0.f);
        }
        film_store(v, dst + a.C);
#pragma unroll
        for (int q = 0; q < 8; ++q) {  // dscale: dy xn, xn = x / rms in f32
          const float* d = &acc[32 * j + 4 * q];
          const float2 x0 = xpair(j, q, 0), x1 = xpair(j, q, 1);
          v[2 * q] = (ua ? d[0] * (x0.x * ia) : 0.f) + (ub ? d[2] * (x1.x * ib) : 0.f);
          v[2 * q + 1] = (ua ? d[1] * (x0.y * ia) : 0.f) + (ub ? d[3] * (x1.y * ib) : 0.f);
        }
        film_store(v, dst);
      }
    }
    pa += __shfl_xor_sync(0xffffffffu, pa, 1);
    pa += __shfl_xor_sync(0xffffffffu, pa, 2);
    pb += __shfl_xor_sync(0xffffffffu, pb, 1);
    pb += __shfl_xor_sync(0xffffffffu, pb, 2);

    // the warp's 16 row partials to every CTA of the cluster (lane k to CTA
    // k), xch[buf][rank][16 cw..]; then this CTA's n partials in rank order
    const int buf = tc & 1;
    float v[16];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[e] = __shfl_sync(0xffffffffu, pa, 4 * e);
      v[e + 8] = __shfl_sync(0xffffffffu, pb, 4 * e);
    }
    if (lane < n) {
      const uint32_t dst =
          cluster_addr(xch + ((size_t)buf * kFqbMaxCluster + rank) * kFqbRows + 16 * cw, lane);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        st_cluster_v4(dst + 16 * k, v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
      mbar_arrive_cluster(cluster_addr(&xfull[buf], lane));
    }
    mbar_wait_cluster(&xfull[buf], (tc >> 1) & 1);
    float ma = 0.f, mb = 0.f;
    for (int k = 0; k < n; ++k) {
      ma += xch[((size_t)buf * kFqbMaxCluster + k) * kFqbRows + 64 * wg + r0];
      mb += xch[((size_t)buf * kFqbMaxCluster + k) * kFqbRows + 64 * wg + r0 + 8];
    }
    ma /= a.C;
    mb /= a.C;

    // pass 2: dx = inv dxn - inv^3 x mean(dxn x)
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (c0 + 64 * j >= a.C) continue;
      store_box(a.dx, j, [&](int q, int h) {
        const float* d = &acc[32 * j + 4 * q + 2 * h];
        const float2 x = xpair(j, q, h), sc = spair(j, q, h);
        const float inv = h ? ib : ia, m = h ? mb : ma;
        const float n0 = d[0] * (1.f + sc.x), n1 = d[1] * (1.f + sc.y);
        return make_float2(inv * n0 - inv * inv * inv * x.x * m, inv * n1 - inv * inv * inv * x.y * m);
      });
    }
    // the x boxes are read
    __syncwarp();
#pragma unroll
    for (int e = kE; e > 0; --e)
      if (lane == 0) mbar_arrive(&empty[(it - e) % nst]);
  }
}

// film[b][i] = the sum of the warps' partials of batch row b, in order of
// (tile, warp): a warp's 16 rows hold partial b - (its first row) / L
__global__ void __launch_bounds__(256)
fq_film_reduce_kernel(const float* __restrict__ part, int L, int S, int n,
                      float* __restrict__ out) {
  const int i = blockIdx.x * 256 + threadIdx.x, b = blockIdx.y;
  if (i >= n) return;
  const long long r0 = (long long)b * L, r1 = r0 + L - 1;
  float acc = 0.f;
  for (long long w = r0 / 16; w <= r1 / 16; ++w) {  // warps of 16 rows, flat
    const long long first = 16 * w;
    acc += part[(size_t)(w * S + (b - first / L)) * n + i];
  }
  out[(size_t)b * n + i] = acc;
}

// out[i] = sum over t < T of part[t][i]: eight runs of t, each summed in
// order by a thread, then the eight in order (a block: 32 columns x 8 runs)
__global__ void __launch_bounds__(256)
fq_reduce_kernel(const float* __restrict__ part, int T, int n, float* __restrict__ out) {
  __shared__ float runs[8][32];
  const int c = threadIdx.x % 32, r = threadIdx.x / 32, i = blockIdx.x * 32 + c;
  float acc = 0.f;
  if (i < n)
    for (int t = r * T / 8; t < (r + 1) * T / 8; ++t) acc += part[(size_t)t * n + i];
  runs[r][c] = acc;
  __syncthreads();
  if (r == 0 && i < n) {
    acc = runs[0][c];
    for (int k = 1; k < 8; ++k) acc += runs[k][c];
    out[i] = acc;
  }
}

// the row pass on persistent clusters, as many as the device holds at once
// (queried once a kernel and cluster width)
template <int NB, bool PART>
cudaError_t fqb_launch(const CUtensorMap& mg, const CUtensorMap& mw, const CUtensorMap& mx,
                       const CUtensorMap& ms, const FqbArgs& a, int ntiles, cudaStream_t s) {
  const auto kernel = film_qkv_bwd_kernel<NB, PART>;
  const size_t smem = FqbLayout(NB, a.stages).total;
  static int held[kFqbMaxCluster + 1] = {};
  if (held[a.n] == 0) held[a.n] = hopper::max_active_clusters(kernel, dim3(384), a.n, smem);
  if (held[a.n] < 1) return cudaErrorInvalidConfiguration;
  const int clusters = ntiles < held[a.n] ? ntiles : held[a.n];
  return hopper::launch_cluster(kernel, dim3(clusters * a.n), dim3(384), a.n, smem, s, mg, mw, mx,
                                ms, a);
}

template <bool PART>
cudaError_t fqb_row_pass(const CUtensorMap& mg, const CUtensorMap& mw, const CUtensorMap& mx,
                         const CUtensorMap& ms, const FqbArgs& a, int nb, int ntiles,
                         cudaStream_t s) {
  switch (nb) {
    case 1: return fqb_launch<1, PART>(mg, mw, mx, ms, a, ntiles, s);
    case 2: return fqb_launch<2, PART>(mg, mw, mx, ms, a, ntiles, s);
    case 3: return fqb_launch<3, PART>(mg, mw, mx, ms, a, ntiles, s);
    default: return fqb_launch<4, PART>(mg, mw, mx, ms, a, ntiles, s);
  }
}

// ---- K12's TP form (a rank's slice of the qkv columns) ----
//
// Every term after dy = g W^T is linear in dy, so the form splits there:
// phase 0 runs the y pass and the row pass on the slice (film_qkv_bwd_kernel
// <NB, true>: dy leaves in f32, no epilogue), and the slice's dW and db;
// the model group sums the dy planes; phase 1 (fq_tp_rows_kernel) runs the
// row pass's epilogue on the sum: dadd = dy, dx = inv dxn - inv^3 x
// mean_C(dxn x) with dxn = dy (1 + scale), and per CTA the partial sums of
// dshift = dy and dscale = dy x inv over its rows, summed in order by
// fq_tp_film_kernel. A CTA takes kFqtRows rows of one batch row, a warp a
// row at a time, a lane 4 columns of every 128. At B128 L152 C512 and a
// rank's 1536 columns (8 of 16 x 64 heads) the form's two products (dy
// and dW) are 61.2 GFLOP (0.0619 ms), and the f32 dy plane it writes and
// reads again (40 MB each way) makes bytes its bound (0.0675 ms); both
// phases took 0.2615 ms by graph replay (chip_smoke.py phase 1e; NVIDIA
// H100 80GB HBM3, 700 W). K11 needs no TP form of its own: its inputs are
// replicated and its output columns the rank's, so it runs unchanged on
// the rank's columns.

constexpr int kFqtRows = 32;

template <int MaxV>
__global__ void __launch_bounds__(256)
fq_tp_rows_kernel(const float* __restrict__ dy, const bf16* __restrict__ x,
                  const bf16* __restrict__ scale, const float* __restrict__ rinv,
                  bf16* __restrict__ dx, bf16* __restrict__ dadd, float* __restrict__ part, int L,
                  int C) {
  extern __shared__ float red[];  // (8 warps, 2C): each warp's [dscale | dshift]
  const int b = blockIdx.y, t0 = blockIdx.x * kFqtRows, warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32, nv = C / 4, t1 = min(L, t0 + kFqtRows);
  float4 s1[MaxV], ds[MaxV], dh[MaxV];
#pragma unroll
  for (int j = 0; j < MaxV; ++j) {
    const int v = lane + 32 * j;
    ds[j] = dh[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (v < nv) {
      const bf16* sc = scale + (size_t)b * C + 4 * v;
      s1[j] = make_float4(1.f + ldf(sc), 1.f + ldf(sc + 1), 1.f + ldf(sc + 2), 1.f + ldf(sc + 3));
    }
  }
  for (int t = t0 + warp; t < t1; t += 8) {
    const size_t row = (size_t)b * L + t;
    const float inv = rinv[row];
    float4 d[MaxV], xv[MaxV];
    float pm = 0.f;
#pragma unroll
    for (int j = 0; j < MaxV; ++j) {
      const int v = lane + 32 * j;
      if (v >= nv) break;
      d[j] = *reinterpret_cast<const float4*>(dy + row * C + 4 * v);
      const uint2 raw = *reinterpret_cast<const uint2*>(x + row * C + 4 * v);
      const float2 x01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
      const float2 x23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
      xv[j] = make_float4(x01.x, x01.y, x23.x, x23.y);
      pm += d[j].x * s1[j].x * xv[j].x;
      pm += d[j].y * s1[j].y * xv[j].y;
      pm += d[j].z * s1[j].z * xv[j].z;
      pm += d[j].w * s1[j].w * xv[j].w;
    }
    const float m = warp_sum(pm) / C, i3 = inv * inv * inv;
#pragma unroll
    for (int j = 0; j < MaxV; ++j) {
      const int v = lane + 32 * j;
      if (v >= nv) break;
      const float4 e = d[j], xe = xv[j], se = s1[j];
      __nv_bfloat162 o[2] = {__floats2bfloat162_rn(e.x, e.y), __floats2bfloat162_rn(e.z, e.w)};
      *reinterpret_cast<uint2*>(dadd + row * C + 4 * v) = *reinterpret_cast<const uint2*>(o);
      o[0] = __floats2bfloat162_rn(inv * (e.x * se.x) - i3 * xe.x * m,
                                   inv * (e.y * se.y) - i3 * xe.y * m);
      o[1] = __floats2bfloat162_rn(inv * (e.z * se.z) - i3 * xe.z * m,
                                   inv * (e.w * se.w) - i3 * xe.w * m);
      *reinterpret_cast<uint2*>(dx + row * C + 4 * v) = *reinterpret_cast<const uint2*>(o);
      dh[j].x += e.x;
      dh[j].y += e.y;
      dh[j].z += e.z;
      dh[j].w += e.w;
      ds[j].x += e.x * (xe.x * inv);
      ds[j].y += e.y * (xe.y * inv);
      ds[j].z += e.z * (xe.z * inv);
      ds[j].w += e.w * (xe.w * inv);
    }
  }
#pragma unroll
  for (int j = 0; j < MaxV; ++j) {
    const int v = lane + 32 * j;
    if (v >= nv) break;
    *reinterpret_cast<float4*>(red + (size_t)warp * 2 * C + 4 * v) = ds[j];
    *reinterpret_cast<float4*>(red + (size_t)warp * 2 * C + C + 4 * v) = dh[j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * C; i += 256) {
    float acc = 0.f;
    for (int w = 0; w < 8; ++w) acc += red[w * 2 * C + i];
    part[((size_t)b * gridDim.x + blockIdx.x) * 2 * C + i] = acc;
  }
}

// film[b][i] = the sum of batch row b's nch CTA partials, in order
__global__ void __launch_bounds__(256)
fq_tp_film_kernel(const float* __restrict__ part, int nch, int n, float* __restrict__ out) {
  const int i = blockIdx.x * 256 + threadIdx.x, b = blockIdx.y;
  if (i >= n) return;
  float acc = 0.f;
  for (int k = 0; k < nch; ++k) acc += part[((size_t)b * nch + k) * n + i];
  out[(size_t)b * n + i] = acc;
}

}  // namespace odt

// x, add (B, L, C), scale, shift (B, C), w (C, F), bias (F) bf16 -> out
// (B, L, F) bf16; y_out (B L, C) bf16 or null (a test hook: y as built).
// Every base 16-byte aligned (TMA and 16-byte loads).
extern "C" int odt_film_qkv_fwd(const void* x, const void* scale, const void* shift,
                                const void* add, const void* w, const void* bias, void* out,
                                void* y_out, int B, int L, int C, int F, void* stream) {
  using namespace odt;
  if (B < 1 || L < 1 || C < 64 || C % 64 || C > 1024 || F < kFqfCols || F % kFqfCols)
    return (int)cudaErrorInvalidValue;
  const int nwg = fqf_warpgroups(C), rows = 64 * nwg, BL = B * L, stages = fqf_stages(C, nwg);
  const int sms = device_sms();
  if (stages < 2) return (int)cudaErrorInvalidValue;
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  CUtensorMap mx, ma, mw, mo;
  cudaError_t err = hopper::tma_map_bf16_3d(&mx, x, C, BL, 1, 64, rows);
  if (err == cudaSuccess) err = hopper::tma_map_bf16_3d(&ma, add, C, BL, 1, 64, rows);
  if (err == cudaSuccess) err = hopper::tma_map_bf16_3d(&mw, w, F, C, 1, 64, 64);
  if (err == cudaSuccess) err = hopper::tma_map_bf16_3d(&mo, out, F, BL, 1, 64, 64);
  if (err != cudaSuccess) return (int)err;
  const int items = (BL + rows - 1) / rows * (F / kFqfCols);
  const FqfArgs args{(const bf16*)scale, (const bf16*)shift, (const bf16*)bias, (bf16*)y_out,
                     BL, L, C, F, stages};
  const size_t smem = FqfLayout(C, nwg, stages).total;
  const dim3 grid(items < sms ? items : sms), block((nwg + 1) * 128);
  cudaStream_t s = (cudaStream_t)stream;
  return nwg == 2 ? (int)launch(film_qkv_fwd_kernel<2>, grid, block, smem, s, mx, ma, mw, mo, args)
                  : (int)launch(film_qkv_fwd_kernel<1>, grid, block, smem, s, mx, ma, mw, mo, args);
}

// g (B, L, F) bf16 is the output gradient. -> dx, dadd (B, L, C) bf16; dw
// (C, F), db (F) and film (B, 2C) = [dscale | dshift] f32. Scratch: y_s
// (B L, C) bf16, rinv (B L), part_film, part_db (2 tiles, F)
// and part_w (S_w, C, F) f32, tiles = ceil(B L / 128), S = fqb_segments(L):
// part_film (8 tiles, S, 2C) holds a partial per (consumer warp, batch row of
// its 16 rows).
// Every base 16-byte aligned (TMA and 16-byte loads).
extern "C" int odt_film_qkv_bwd(const void* x, const void* scale, const void* shift,
                                const void* add, const void* w, const void* g, void* dx,
                                void* dadd, void* y_s, void* rinv, void* part_film, void* part_db,
                                void* part_w, void* dw, void* db, void* film, int B, int L, int C,
                                int F, int S, void* stream) {
  using namespace odt;
  if (B < 1 || L < 1 || C < 64 || C % 64 || C > 1024 || F < 128 || F % 128 || S < 1)
    return (int)cudaErrorInvalidValue;
  const int BL = B * L, ntiles = (BL + kFqbRows - 1) / kFqbRows;
  const int n = fqb_cluster(C), nb = fqb_boxes(C), stages = fqb_stages(nb);
  if (stages < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  fq_y_kernel<<<(BL + 7) / 8, 256, 0, s>>>((const bf16*)x, (const bf16*)add, (const bf16*)scale,
                                           (const bf16*)shift, (bf16*)y_s, (float*)rinv, BL, L, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap mg, mw, mx, ms;
  err = hopper::tma_map_bf16_3d(&mg, g, F, BL, 1, 64, kFqbRows);
  if (err == cudaSuccess) err = hopper::tma_map_bf16_3d(&mw, w, F, C, 1, 64, 64);
  if (err == cudaSuccess) err = hopper::tma_map_bf16_3d(&mx, x, C, BL, 1, 64, kFqbRows);
  if (err == cudaSuccess) err = hopper::tma_map_bf16_3d(&ms, scale, C, B, 1, 64, kFqbScaleRows);
  if (err != cudaSuccess) return (int)err;
  const FqbArgs args{(const bf16*)scale, (bf16*)dx, (bf16*)dadd, (const float*)rinv,
                     (float*)part_film, (float*)part_db, nullptr,
                     BL, L, C, F, fqb_segments(L), n, stages};
  err = fqb_row_pass<false>(mg, mw, mx, ms, args, nb, ntiles, s);
  if (err != cudaSuccess) return (int)err;
  err = gemm_tn_splitk((const bf16*)y_s, C, (const bf16*)g, F, BL, C, F, S, (float*)part_w,
                       (float*)dw, s);
  if (err != cudaSuccess) return (int)err;
  fq_film_reduce_kernel<<<dim3((2 * C + 255) / 256, B), 256, 0, s>>>(
      (const float*)part_film, L, fqb_segments(L), 2 * C, (float*)film);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fq_reduce_kernel<<<(F + 31) / 32, 256, 0, s>>>((const float*)part_db, 2 * ntiles, F,
                                                  (float*)db);
  return (int)cudaGetLastError();
}

// K12's TP form on a rank's slice: w (C, F) and g (B, L, F) hold the rank's
// qkv columns. phase 0: the y pass (y_s, rinv), the row pass's products to
// dyp (B L, C) f32 (this rank's partial dy, which the model group sums),
// and the slice's dw (C, F) and db (F) f32 (scratch part_w, part_db as
// odt_film_qkv_bwd's); phase 1, on the summed dyp and phase 0's rinv: dx,
// dadd (B, L, C) bf16 and film (B, 2C) = [dscale | dshift] f32 (scratch
// part_film (B, ceil(L / 32), 2C)). Phase 1 reads only x, scale, rinv and
// dyp of the other arguments.
extern "C" int odt_film_qkv_bwd_tp(const void* x, const void* scale, const void* shift,
                                   const void* add, const void* w, const void* g, void* dx,
                                   void* dadd, void* y_s, void* rinv, void* dyp, void* part_film,
                                   void* part_db, void* part_w, void* dw, void* db, void* film,
                                   int B, int L, int C, int F, int S, int phase, void* stream) {
  using namespace odt;
  if (B < 1 || L < 1 || C < 64 || C % 64 || C > 1024 || F < 128 || F % 128 || S < 1 ||
      (phase != 0 && phase != 1))
    return (int)cudaErrorInvalidValue;
  const int BL = B * L;
  cudaStream_t s = (cudaStream_t)stream;
  if (phase == 1) {
    const dim3 grid((L + kFqtRows - 1) / kFqtRows, B);
    const size_t smem = (size_t)8 * 2 * C * sizeof(float);
    auto rows = [&](auto kernel) {
      return launch(kernel, grid, dim3(256), smem, s, (const float*)dyp, (const bf16*)x,
                    (const bf16*)scale, (const float*)rinv, (bf16*)dx, (bf16*)dadd,
                    (float*)part_film, L, C);
    };
    cudaError_t err = C <= 512 ? rows(fq_tp_rows_kernel<4>) : rows(fq_tp_rows_kernel<8>);
    if (err != cudaSuccess) return (int)err;
    fq_tp_film_kernel<<<dim3((2 * C + 255) / 256, B), 256, 0, s>>>((const float*)part_film,
                                                                   grid.x, 2 * C, (float*)film);
    return (int)cudaGetLastError();
  }
  const int ntiles = (BL + kFqbRows - 1) / kFqbRows;
  const int n = fqb_cluster(C), nb = fqb_boxes(C), stages = fqb_stages(nb);
  if (stages < 2) return (int)cudaErrorInvalidValue;
  fq_y_kernel<<<(BL + 7) / 8, 256, 0, s>>>((const bf16*)x, (const bf16*)add, (const bf16*)scale,
                                           (const bf16*)shift, (bf16*)y_s, (float*)rinv, BL, L, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap mg, mw, mx, ms;
  err = hopper::tma_map_bf16_3d(&mg, g, F, BL, 1, 64, kFqbRows);
  if (err == cudaSuccess) err = hopper::tma_map_bf16_3d(&mw, w, F, C, 1, 64, 64);
  if (err == cudaSuccess) err = hopper::tma_map_bf16_3d(&mx, x, C, BL, 1, 64, kFqbRows);
  if (err == cudaSuccess) err = hopper::tma_map_bf16_3d(&ms, scale, C, B, 1, 64, kFqbScaleRows);
  if (err != cudaSuccess) return (int)err;
  const FqbArgs args{(const bf16*)scale, nullptr, nullptr, (const float*)rinv, nullptr,
                     (float*)part_db, (float*)dyp, BL, L, C, F, fqb_segments(L), n, stages};
  err = fqb_row_pass<true>(mg, mw, mx, ms, args, nb, ntiles, s);
  if (err != cudaSuccess) return (int)err;
  err = gemm_tn_splitk((const bf16*)y_s, C, (const bf16*)g, F, BL, C, F, S, (float*)part_w,
                       (float*)dw, s);
  if (err != cudaSuccess) return (int)err;
  fq_reduce_kernel<<<(F + 31) / 32, 256, 0, s>>>((const float*)part_db, 2 * ntiles, F,
                                                  (float*)db);
  return (int)cudaGetLastError();
}
