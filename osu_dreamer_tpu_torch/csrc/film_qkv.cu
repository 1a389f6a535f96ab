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
// Backward (film_qkv_bwd_kernel, then a split-K product and two reductions).
// The Pallas kernel keeps dW (C x F f32), db and the per-batch-row dscale and
// dshift in accumulators across its ordered grid. Hopper blocks run in no
// order, and the gradients must repeat bit for bit, so there are no float
// atomics. One block owns 64 rows of ONE batch row, so it reads its (1 +
// scale, shift) row once and its film partial sums never mix batch rows;
// rows past L are neither read as data nor written. The row kernel
// recomputes y with fq_row (written to a bf16 scratch), forms
// dy = g W^T (g staged through shared memory in 64-column chunks with
// cp.async, two buffers; W fragments from L2; each warp owns up to four
// 16-column tiles of dy for all 64 rows), then per row writes dadd = dy, and
// dx = inv dxn - inv^3 x mean(dxn x) with dxn = dy (1 + scale), and per block
// the column sums of dy (dshift) and dy xn (dscale, with xn in f32 as the
// Pallas kernel takes it) and of g (db). dW = y^T g is csrc/gemm_tn.cuh's
// split-K tensor-core product, and the block partials are summed in index
// order by a small kernel. Past C 512 (up to 1024, every width the JAX
// `_prologue_ok` admits) the row kernel takes 32 rows a block and a warp up
// to 8 dy column tiles (FqBwdWide), so its f32 dy rows fit shared memory.
//
// What bounds them on the H100: at B128 L152 C512 F3072 the forward's product
// is 61.2 GFLOP against 162 MB of inputs and outputs (62 us vs 48 us: compute)
// and the backward's two products 122.4 GFLOP against 209 MB (124 us vs 62
// us). The forward's W (3 MB) streams from L2 once per row tile (152 x 3 MB
// at B128 L152), about as many bytes a second as the tensor cores' rate
// asks; the backward's row kernel still reads its W fragments from L2 into
// mma.sync by every block.
#include "gemm_tn.cuh"

namespace odt {

constexpr int kFqWarps = 8;
constexpr int kFqThreads = kFqWarps * 32;
constexpr int kFqChunk = 64;                  // g columns per staged chunk (backward)
constexpr int kFqLdg = kFqChunk + 8;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  const int bytes = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

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

// the backward's shape: rows per block, dy column tiles per warp (C <= 16 x
// 8 x MaxCT) and 16-byte vectors per lane and row (C <= 256 MaxV). 64 rows
// up to C 512; wider (to C 1024, as far as the JAX feasibility reaches) 32
// rows, so that the f32 dy rows and the warps' partial sums fit shared memory
template <int Rows, int MaxCT, int MaxV>
struct FqBwdShape {
  static constexpr int kRows = Rows, kRT = Rows / 16, kMaxCT = MaxCT, kMaxV = MaxV;
};
using FqBwdNarrow = FqBwdShape<64, 4, 2>;
using FqBwdWide = FqBwdShape<32, 8, 4>;

struct FqBwdSmem {
  size_t gbuf, dys, part, rows, total;
  __host__ __device__ FqBwdSmem(int C, int R) {
    gbuf = 0;
    dys = align128((size_t)2 * R * kFqLdg * sizeof(bf16));
    part = dys + align128((size_t)R * C * sizeof(float));
    rows = part + align128((size_t)kFqWarps * 2 * C * sizeof(float));
    total = rows + R * sizeof(float);
  }
};

template <class Sh>
__global__ void __launch_bounds__(kFqThreads)
film_qkv_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ scale,
                    const bf16* __restrict__ shift, const bf16* __restrict__ add,
                    const bf16* __restrict__ w, const bf16* __restrict__ g,
                    bf16* __restrict__ dx, bf16* __restrict__ dadd, bf16* __restrict__ y_s,
                    float* __restrict__ part_film, float* __restrict__ part_db, int L, int C,
                    int F) {
  constexpr int kFqRows = Sh::kRows, kFqRT = Sh::kRT, kFqMaxCT = Sh::kMaxCT, kFqMaxV = Sh::kMaxV;
  extern __shared__ __align__(128) unsigned char smem[];
  const FqBwdSmem lay(C, kFqRows);
  bf16* gbuf = reinterpret_cast<bf16*>(smem + lay.gbuf);
  float* dys = reinterpret_cast<float*>(smem + lay.dys);
  float* ps = reinterpret_cast<float*>(smem + lay.part);
  float* rowinv = reinterpret_cast<float*>(smem + lay.rows);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t0 = blockIdx.x * kFqRows, b = blockIdx.y;
  const int blk = b * gridDim.x + blockIdx.x;
  const int rows = min(kFqRows, L - t0), rt = (rows + 15) / 16;
  const int nv = C / 8;
  const bf16* sc = scale + (size_t)b * C;
  const bf16* sh = shift + (size_t)b * C;

  // g chunk f0.. of this block's rows into buffer buf (rows past L zero)
  auto load_chunk = [&](int buf, int f0) {
    for (int idx = threadIdx.x; idx < kFqRows * (kFqChunk / 8); idx += kFqThreads) {
      const int e = idx / (kFqChunk / 8), v = (idx % (kFqChunk / 8)) * 8;
      const bool ok = e < rows;
      const bf16* src = g + ((size_t)b * L + t0 + (ok ? e : 0)) * F + f0 + v;
      cp_async16(gbuf + (buf * kFqRows + e) * kFqLdg + v, src, ok);
    }
    cp_async_commit();
  };
  load_chunk(0, 0);

  // ---- recompute y (to the scratch for dW = y^T g) and each row's 1 / rms
  for (int e = warp; e < rows; e += kFqWarps) {
    const size_t p = (size_t)b * L + t0 + e;
    const float inv = fq_row<kFqMaxV>(x + p * C, add + p * C, sc, sh, C, y_s + p * C);
    if (lane == 0) rowinv[e] = inv;
  }

  // ---- dy = g W^T: warp owns the column tiles warp + 8 ci, all row fragments
  const int nct = C / 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> fy[kFqMaxCT][kFqRT];
#pragma unroll
  for (int ci = 0; ci < kFqMaxCT; ++ci)
#pragma unroll
    for (int i = 0; i < kFqRT; ++i) wmma::fill_fragment(fy[ci][i], 0.f);
  const int nch = F / kFqChunk;
  for (int ch = 0; ch < nch; ++ch) {
    if (ch + 1 < nch) {
      load_chunk((ch + 1) & 1, (ch + 1) * kFqChunk);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* gb = gbuf + (ch & 1) * kFqRows * kFqLdg;
#pragma unroll
    for (int kk = 0; kk < kFqChunk; kk += 16) {
      const int f = ch * kFqChunk + kk;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw[kFqMaxCT];
#pragma unroll
      for (int ci = 0; ci < kFqMaxCT; ++ci) {
        const int ct = warp + ci * kFqWarps;
        if (ct < nct) wmma::load_matrix_sync(bw[ci], w + (size_t)ct * 16 * F + f, F);
      }
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[kFqRT];
#pragma unroll
      for (int i = 0; i < kFqRT; ++i)
        if (i < rt) wmma::load_matrix_sync(a[i], gb + i * 16 * kFqLdg + kk, kFqLdg);
#pragma unroll
      for (int ci = 0; ci < kFqMaxCT; ++ci) {
        if (warp + ci * kFqWarps >= nct) break;
#pragma unroll
        for (int i = 0; i < kFqRT; ++i)
          if (i < rt) wmma::mma_sync(fy[ci][i], a[i], bw[ci], fy[ci][i]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
#pragma unroll
  for (int ci = 0; ci < kFqMaxCT; ++ci) {
    const int ct = warp + ci * kFqWarps;
    if (ct >= nct) break;
#pragma unroll
    for (int i = 0; i < kFqRT; ++i)
      if (i < rt) wmma::store_matrix_sync(dys + i * 16 * C + ct * 16, fy[ci][i], C,
                                          wmma::mem_row_major);
  }
  __syncthreads();

  // ---- per row (one warp): dadd, dx and the column partials of dscale, dshift
  float psc[kFqMaxV][8] = {}, psh[kFqMaxV][8] = {};
  for (int e = warp; e < rows; e += kFqWarps) {
    const size_t p = (size_t)b * L + t0 + e;
    const float inv = rowinv[e];
    float xv[kFqMaxV][8], dxn[kFqMaxV][8], sm = 0.f;
#pragma unroll
    for (int j = 0; j < kFqMaxV; ++j) {
      const int v = lane + 32 * j;
      if (v >= nv) break;
      const int4 rx = *reinterpret_cast<const int4*>(x + p * C + v * 8);
      const int4 rs = *reinterpret_cast<const int4*>(sc + v * 8);
      const bf16 *xb = reinterpret_cast<const bf16*>(&rx), *sb = reinterpret_cast<const bf16*>(&rs);
      const float4 d0 = *reinterpret_cast<const float4*>(dys + e * C + v * 8);
      const float4 d1 = *reinterpret_cast<const float4*>(dys + e * C + v * 8 + 4);
      const float d[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
      int4 packed;
      bf16* o = reinterpret_cast<bf16*>(&packed);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        xv[j][q] = __bfloat162float(xb[q]);
        psh[j][q] += d[q];
        psc[j][q] += d[q] * (xv[j][q] * inv);
        dxn[j][q] = d[q] * (1.f + __bfloat162float(sb[q]));
        sm += dxn[j][q] * xv[j][q];
        o[q] = __float2bfloat16(d[q]);
      }
      *reinterpret_cast<int4*>(dadd + p * C + v * 8) = packed;
    }
    const float m = warp_sum(sm) / C;
#pragma unroll
    for (int j = 0; j < kFqMaxV; ++j) {
      const int v = lane + 32 * j;
      if (v >= nv) break;
      int4 packed;
      bf16* o = reinterpret_cast<bf16*>(&packed);
#pragma unroll
      for (int q = 0; q < 8; ++q)
        o[q] = __float2bfloat16(inv * dxn[j][q] - inv * inv * inv * xv[j][q] * m);
      *reinterpret_cast<int4*>(dx + p * C + v * 8) = packed;
    }
  }
#pragma unroll
  for (int j = 0; j < kFqMaxV; ++j) {
    const int v = lane + 32 * j;
    if (v >= nv) break;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      ps[warp * 2 * C + v * 8 + q] = psc[j][q];
      ps[warp * 2 * C + C + v * 8 + q] = psh[j][q];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < 2 * C; idx += kFqThreads) {
    float acc = 0.f;
    for (int wi = 0; wi < kFqWarps; ++wi) acc += ps[wi * 2 * C + idx];
    part_film[(size_t)blk * 2 * C + idx] = acc;
  }
  // ---- the column sums of g over the block's rows (db)
  for (int f = threadIdx.x; f < F; f += kFqThreads) {
    float acc = 0.f;
    for (int e = 0; e < rows; ++e) acc += ldf(g + ((size_t)b * L + t0 + e) * F + f);
    part_db[(size_t)blk * F + f] = acc;
  }
}

// out[b][i] = sum over t < T of part[b][t][i], in order of t
__global__ void __launch_bounds__(256)
fq_reduce_kernel(const float* __restrict__ part, int T, int n, float* __restrict__ out) {
  const int i = blockIdx.x * 256 + threadIdx.x, b = blockIdx.y;
  if (i >= n) return;
  float acc = 0.f;
  for (int t = 0; t < T; ++t) acc += part[((size_t)b * T + t) * n + i];
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
// (B L, C) bf16, part_film (blocks, 2C), part_db (blocks, F) and part_w
// (S, C, F) f32, blocks = B ceil(L / 64).
extern "C" int odt_film_qkv_bwd(const void* x, const void* scale, const void* shift,
                                const void* add, const void* w, const void* g, void* dx,
                                void* dadd, void* y_s, void* part_film, void* part_db,
                                void* part_w, void* dw, void* db, void* film, int B, int L, int C,
                                int F, int S, void* stream) {
  using namespace odt;
  if (B < 1 || L < 1 || C % 64 || C > 1024 || F % kFqChunk || S < 1)
    return (int)cudaErrorInvalidValue;
  // the rows per block follow C (ops/film_qkv.py bwd_rows)
  const int rows = C <= 512 ? FqBwdNarrow::kRows : FqBwdWide::kRows;
  const FqBwdSmem lay(C, rows);
  const int nT = (L + rows - 1) / rows;
  cudaStream_t s = (cudaStream_t)stream;
  auto row_pass = [&](auto kernel) {
    return launch(kernel, dim3(nT, B), dim3(kFqThreads), lay.total, s, (const bf16*)x,
                  (const bf16*)scale, (const bf16*)shift, (const bf16*)add, (const bf16*)w,
                  (const bf16*)g, (bf16*)dx, (bf16*)dadd, (bf16*)y_s, (float*)part_film,
                  (float*)part_db, L, C, F);
  };
  cudaError_t err = C <= 512 ? row_pass(film_qkv_bwd_kernel<FqBwdNarrow>)
                             : row_pass(film_qkv_bwd_kernel<FqBwdWide>);
  if (err != cudaSuccess) return (int)err;
  err = gemm_tn_splitk((const bf16*)y_s, C, (const bf16*)g, F, B * L, C, F, S, (float*)part_w,
                       (float*)dw, s);
  if (err != cudaSuccess) return (int)err;
  fq_reduce_kernel<<<dim3((2 * C + 255) / 256, B), 256, 0, s>>>((const float*)part_film, nT,
                                                                 2 * C, (float*)film);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fq_reduce_kernel<<<dim3((F + 255) / 256, 1), 256, 0, s>>>((const float*)part_db, B * nT, F,
                                                             (float*)db);
  return (int)cudaGetLastError();
}
