// The gated conv-FFN core for Hopper, shared by the SwiGLU forward (K4,
// swiglu.cu) and the film-layer forward (K2, film_layer.cu):
//
//   y   = depthwise conv (2r+1 taps, zero padding inside each batch row)
//   v,g = y W_vg + b_vg          h = v * silu(g)           (f32)
//   o   = (h W_out) / rms(h) + b_out                       (f32 sums of squares)
//
// (K2 adds a pre-norm + FiLM before the conv and a block norm + gated
// residual after it.) What bounds it on the H100: 3 C H multiply-adds a
// position on the tensor cores against 4 C bytes in and out, 1,300-4,000
// operations a byte at the shipped widths, so the tensor cores; the design
// keeps them fed:
// - one CTA owns 64 NWG consecutive rows of the flattened (B L) positions
//   (NWG = 2 consumer warpgroups of 64 rows; one past C 512) and one
//   producer warpgroup, which hands its registers to the consumers
//   (setmaxnreg: 40 for the producer, 232 or 240 for a consumer thread).
//   Rows are flat so that short batch rows still fill 128-row tiles; the
//   conv masks the taps that cross a batch row (a select, so a NaN in a
//   neighbouring row never leaks in). CTAs are persistent over the row
//   tiles, and keep the per-column vectors (biases, conv taps, gains) in
//   shared memory. C is any multiple of 16: its 64-column boxes past C read
//   as zeros (TMA fills them), the conv writes zero y there, and the stores
//   and the epilogue stop at C;
// - one producer thread keeps a ring of as many 18 KB stages as shared
//   memory holds (up to 8) in flight with TMA on full / empty mbarriers:
//   first the x window (64 columns x rows + 2r halo a stage, zero-filled
//   outside the tensor), then per hidden chunk of 64 the W_vg tiles (v and
//   g of all 64 hidden columns for 64 input channels, 16 KB; at 256 output
//   columns one 32-column half a stage) and the W_out tiles (64 hidden x 128
//   output columns, 16 KB). Every weight tile is read once per row tile and
//   used by all its rows, and the producer runs ahead into the next tile;
// - the conv output y lands in shared memory in the 128-byte swizzled
//   layout, the A operand of the first product (K2 first applies its
//   pre-norm + FiLM in place to each x box, with 1/rms(x) from the boxes);
// - the hidden dimension is streamed: per chunk, v | g = y W_vg on wgmma
//   (two 32-column halves, m64n64, both operands from shared memory), the
//   gate and the row sums of squares in registers, then o += h W_out with h
//   straight from registers (m64n128, the accumulator layout is the A
//   operand layout), left running while the next chunk's v | g product is
//   issued. 1/rms scales o at the end (a per-row factor commutes with the
//   product), so the full hidden row is never held;
// - a warpgroup holds a 64 x NC output slab (NC 128 or 256 columns: 64 or
//   128 registers a thread). Wider C splits its columns across CTAs
//   (gridDim.y), recomputing v | g per column group; where the row tiles
//   alone do not fill the card the hidden chunks split across CTAs too
//   (gridDim.z). Either split leaves f32 partial outputs and sums of
//   squares in a workspace, summed in a fixed order by ffn_reduce_kernel,
//   which also runs the epilogue; with one CTA per row tile the epilogue
//   runs in registers and the output leaves by TMA stores.
//
// Weight layout (ops/swiglu.py ``packed_ffn_weights``, cached per weight
// version, and read by the backward core of ffn_bwd_core.cuh too): W_vg^T
// (2 Hp, C) bf16, v rows then g rows, and W_out^T (C, Hp) bf16, both K-major
// with H zero-padded to Hp (a multiple of 64); b_vg (2 Hp) f32 (bf16-rounded
// values); b_out (C) bf16. Padded hidden columns give v = 0, so h = 0 there.
//
// The backward core runs this kernel as its first pass (``ystore``): the
// partial outputs and sums of squares always leave through the workspace,
// no reduction follows, and the y tiles are stored (TMA) for the weight
// gradient.
//
// Tensor parallelism (the TP forms of K4 and K2, ops/swiglu.py
// ``swiglu_tp``): a rank holds a slice of the hidden units, whole units of
// both v and g and the matching rows of W_out. Its core runs in ``partial``
// mode (K2's in ``ystore`` mode, whose y the backward reads): the slice's
// f32 partial h W_out and sums of squares always leave through the
// workspace, tp_fold sums the plan's hidden slices into one plane, the
// caller all-reduces that plane over the model group, and
// ffn_finish runs the reduction kernel on the sums with Hm, the whole
// hidden width, for the mean of 1 / rms(h), and b_out added once. H and Hp
// stay the slice's extent.
#pragma once

#include <string.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace odt {

using namespace hopper;

constexpr int kFcMaxStages = 8;
// a stage holds an x box of up to 64 NWG + 2 r <= 136 rows x 128 bytes, or
// one weight item (16 KB); a multiple of the 1024-byte swizzle atom
constexpr uint32_t kFcStageBytes = 18 * 1024;
constexpr uint32_t kFcTileBytes = 64 * 64 * 2;  // a 64 x 64 bf16 swizzled tile
constexpr int kFcMaxRadius = 4;
constexpr float kFcEps = 1e-6f;

struct FfnArgs {
  const bf16* x;      // (B L, C)
  const bf16* dww;    // (K, C)
  const bf16* dwb;    // (C)
  const float* bvg;   // (2 Hp)
  const bf16* bout;   // (C); null in the backward's first pass, which adds no bias
  const bf16* scale;  // (B, C), K2 only
  const bf16* shift;  // (B, C), K2 only
  const bf16* gate;   // (B, C), K2 only
  const bf16* g1;     // (C), K2 only
  const bf16* g2;     // (C), K2 only
  float* ws;          // (S, B L, C) partial outputs, null when one CTA owns a row tile
  float* ss;          // (S, B L) partial sums of squares
  int BL, L, C, H, Hp, K, S;
  int Hm;      // the hidden width 1 / rms(h) averages over: the whole H of a TP slice (0: H)
  int stages;  // ring stages
  int xres;    // K2 keeps its tile's x rows in shared memory for the residual
  int nwg;     // consumer warpgroups a CTA (64 rows each); 0: by C
  int ystore;  // the backward's first pass: y leaves through the output map
  int partial;  // a TP slice: the partials stay in the workspace, no reduction follows
};

// the width of the RMS mean over the hidden units
__host__ __device__ inline int ffn_mean_h(int H, int Hm) { return Hm > 0 ? Hm : H; }

// the per-column vectors a CTA keeps in shared memory: b_v and b_g of its
// hidden slice (nloc chunks, f32), b_out (f32), the conv taps and bias, K2's
// gains (bf16)
__host__ __device__ inline size_t fc_params_bytes(int C, int K, int nloc, bool film) {
  const size_t n = (size_t)2 * nloc * 64 * 4 + (size_t)C * 4 + (size_t)K * C * 2 + (size_t)C * 2 +
                   (film ? (size_t)2 * C * 2 : 0);
  return (n + 1023) & ~size_t(1023);
}

// byte offsets from the 1024-aligned base: y tiles, ring, K2's residual x
// rows, vectors, 1/rms of the window's rows, barriers
struct FcLayout {
  size_t ring, xres, params, rinv, bars, total;
  __host__ __device__ FcLayout(int C, int K, int nloc, bool film, int nwg, int stages,
                              bool keep_x) {
    ring = (size_t)((C + 63) / 64) * nwg * kFcTileBytes;
    xres = ring + (size_t)stages * kFcStageBytes;  // K2: the tile's x rows, for the residual
    params = xres + (film && keep_x ? (size_t)64 * nwg * C * sizeof(bf16) : 0);
    rinv = params + fc_params_bytes(C, K, nloc, film);
    bars = rinv + 1024;
    total = bars + 2 * kFcMaxStages * sizeof(uint64_t) + 1024;  // + slack to align the base
  }
};

// as many stages as fit (ops/swiglu.py fwd_stages mirrors it at nloc = Hp / 64
// without the residual rows)
inline int ffn_stages(int C, int K, int nloc, bool film, int nwg, bool keep_x) {
  const size_t fixed = FcLayout(C, K, nloc, film, nwg, 0, keep_x).total;
  if (fixed > kMaxSmem) return 0;
  const size_t n = (kMaxSmem - fixed) / kFcStageBytes;
  return (int)(n < kFcMaxStages ? n : kFcMaxStages);
}

__device__ __forceinline__ uint32_t fc_pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float fc_quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 16-byte chunk cc (8 columns) of row e of a 128-byte-swizzled tile
__device__ __forceinline__ uint32_t fc_chunk(int e, int cc) { return e * 128 + (((cc ^ e) & 7) << 4); }

template <int NWG>
__device__ __forceinline__ void fc_consumers_sync() {
  named_barrier<1, NWG * 128>();
}

__device__ __forceinline__ void fc_wg_sync(int wg) {
  if (wg == 0) named_barrier<2, 128>();
  else named_barrier<3, 128>();
}

// K2's pre-norm + FiLM, in place on x box c of the window: rows in the
// tensor become bf16(bf16(x / rms(x) * g1 * (1 + scale)) + shift); the conv
// masks every row outside the output row's batch row afterwards
template <int NWG>
__device__ void fc_film_box(unsigned char* xs, int c, const float* rinv, const bf16* g1,
                            bf16* xres, const FfnArgs& a, int row0, int r) {
  const int E = 64 * NWG + 2 * r;
  constexpr int kIters = ((64 * NWG + 2 * kFcMaxRadius) * 8 + NWG * 128 - 1) / (NWG * 128);
#pragma unroll
  for (int n = 0; n < kIters; ++n) {
    const int idx = threadIdx.x + n * NWG * 128;
    const int e = idx / 8, cc = idx % 8, g = row0 - r + e;
    const int col = c * 64 + cc * 8;
    if (idx >= E * 8 || g < 0 || g >= a.BL || col >= a.C) continue;  // past C the box stays 0
    const size_t fb = (size_t)(g / a.L) * a.C + col;
    uint4* p = reinterpret_cast<uint4*>(xs + fc_chunk(e, cc));
    uint4 v = *p;
    if (xres != nullptr && e >= r && e < r + 64 * NWG)  // the tile's own rows, for the residual
      *reinterpret_cast<uint4*>(xres + (size_t)(e - r) * a.C + col) = v;
    const uint4 sv = *reinterpret_cast<const uint4*>(a.scale + fb);
    const uint4 hv = *reinterpret_cast<const uint4*>(a.shift + fb);
    const uint4 gv = *reinterpret_cast<const uint4*>(g1 + col);
    bf16* h = reinterpret_cast<bf16*>(&v);
    const bf16 *sc = reinterpret_cast<const bf16*>(&sv), *sh = reinterpret_cast<const bf16*>(&hv),
               *gg = reinterpret_cast<const bf16*>(&gv);
    const float inv = rinv[e];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float a1 = __bfloat162float(gg[i]) * (1.f + __bfloat162float(sc[i]));
      h[i] = __float2bfloat16(bfr(__bfloat162float(h[i]) * inv * a1) + __bfloat162float(sh[i]));
    }
    *p = v;
  }
}

// y for x box c: the plain version's order, ((x0 w0 + x1 w1) + ...) + bias,
// in bf16 pairs (each step rounded once); taps outside the output row's
// batch row read zero, and y past column C is zero. Written into y tile (c,
// warpgroup of the row), swizzled.
template <int NWG>
__device__ void fc_conv_box(const unsigned char* xs, int c, unsigned char* ys, const bf16* dww,
                            const bf16* dwb, const FfnArgs& a, int row0, int r) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {  // 64 NWG rows x 8 chunks over NWG x 128 threads
    const int idx = threadIdx.x + n * NWG * 128;
    const int t = idx / 8, cc = idx % 8, col = c * 64 + cc * 8;
    const int pos = (row0 + t) % a.L;
    unsigned char* dst = ys + (size_t)(c * NWG + t / 64) * kFcTileBytes + fc_chunk(t % 64, cc);
    if (col >= a.C) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    __nv_bfloat162 acc[4];
    for (int k = 0; k < a.K; ++k) {
      const int p = pos + k - r;
      uint4 xv = make_uint4(0u, 0u, 0u, 0u);
      if (p >= 0 && p < a.L) xv = *reinterpret_cast<const uint4*>(xs + fc_chunk(t + k, cc));
      const uint4 wv = *reinterpret_cast<const uint4*>(dww + (size_t)k * a.C + col);
      const __nv_bfloat162* xh = reinterpret_cast<const __nv_bfloat162*>(&xv);
      const __nv_bfloat162* wh = reinterpret_cast<const __nv_bfloat162*>(&wv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 m = __hmul2(xh[i], wh[i]);
        acc[i] = k == 0 ? m : __hadd2(acc[i], m);
      }
    }
    const uint4 bv = *reinterpret_cast<const uint4*>(dwb + col);
    const __nv_bfloat162* bh = reinterpret_cast<const __nv_bfloat162*>(&bv);
    uint4 out;
    __nv_bfloat162* oh = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
    for (int i = 0; i < 4; ++i) oh[i] = __hadd2(acc[i], bh[i]);
    *reinterpret_cast<uint4*>(dst) = out;
  }
}

// YS: the backward's first pass (``ystore``), a separate instantiation so
// that the forward's kernels carry none of its code
template <bool FILM, int NWG, int NC, bool YS>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
ffn_core_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_wvg,
                const __grid_constant__ CUtensorMap tm_wout, const __grid_constant__ CUtensorMap tm_out,
                const FfnArgs a) {
  constexpr int kRows = 64 * NWG;
  constexpr int kNQ = NC / 128;
  // at 256 output columns the v | g product runs in two 32-column halves of
  // 8 KB stages (one 32-register accumulator), else both halves in one
  // 16 KB stage
  constexpr bool kHalves = kNQ == 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int C = a.C, r = a.K / 2, kt = (C + 63) / 64, nst = a.stages;
  const int n0 = blockIdx.y * NC, s = blockIdx.z, ntiles = (a.BL + kRows - 1) / kRows;
  const int nch = a.Hp / 64;
  const int j0 = s * nch / a.S, j1 = (s + 1) * nch / a.S;
  const int nloc = (nch + a.S - 1) / a.S;
  const FcLayout lay(C, a.K, nloc, FILM, NWG, nst, a.xres);
  unsigned char* ys = smem;
  unsigned char* ring = smem + lay.ring;
  bf16* xres = reinterpret_cast<bf16*>(smem + lay.xres);
  float* sbv = reinterpret_cast<float*>(smem + lay.params);  // b_v of the slice
  float* sbg = sbv + nloc * 64;                              // b_g of the slice
  float* sbout = sbg + nloc * 64;
  bf16* sdww = reinterpret_cast<bf16*>(sbout + C);
  bf16* sdwb = sdww + a.K * C;
  bf16* sg1 = sdwb + C;
  bf16* sg2 = sg1 + C;
  float* rinv = reinterpret_cast<float*>(smem + lay.rinv);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* empty = full + kFcMaxStages;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < nst; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], NWG * 4);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == NWG) {
    // producer warpgroup: one thread issues every load, in the order consumed
    setmaxnreg_dec<40>();
    if (threadIdx.x % 128 == 0) {
      int it = 0;
      auto stage = [&](uint32_t bytes) {
        const int st = it % nst;
        if (it >= nst) mbar_wait(&empty[st], (it / nst - 1) & 1);
        mbar_arrive_expect_tx(&full[st], bytes);
        ++it;
        return ring + (size_t)st * kFcStageBytes;
      };
      auto bar = [&]() { return &full[(it - 1) % nst]; };
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        for (int c = 0; c < kt; ++c) {
          unsigned char* dst = stage(64 * (kRows + 2 * r) * 2);
          tma_load_3d(dst, &tm_x, bar(), c * 64, tile * kRows - r, 0);
        }
        for (int j = j0; j < j1; ++j) {
          // v | g of hidden columns j 64 + [0, 32) and [32, 64), 64 channels a stage
          if (kHalves) {
            for (int h = 0; h < 2; ++h)
              for (int k = 0; k < kt; ++k) {
                unsigned char* dst = stage(kFcTileBytes);
                tma_load_3d(dst, &tm_wvg, bar(), k * 64, j * 64 + h * 32, 0);
                tma_load_3d(dst + kFcTileBytes / 2, &tm_wvg, bar(), k * 64, a.Hp + j * 64 + h * 32, 0);
              }
          } else {
            for (int k = 0; k < kt; ++k) {
              unsigned char* dst = stage(2 * kFcTileBytes);
              for (int h = 0; h < 2; ++h) {
                tma_load_3d(dst + h * kFcTileBytes, &tm_wvg, bar(), k * 64, j * 64 + h * 32, 0);
                tma_load_3d(dst + h * kFcTileBytes + kFcTileBytes / 2, &tm_wvg, bar(), k * 64,
                            a.Hp + j * 64 + h * 32, 0);
              }
            }
          }
          for (int q = 0; q < kNQ; ++q) {
            unsigned char* dst = stage(2 * kFcTileBytes);
            tma_load_3d(dst, &tm_wout, bar(), j * 64, n0 + q * 128, 0);
            tma_load_3d(dst + kFcTileBytes, &tm_wout, bar(), j * 64, n0 + q * 128 + 64, 0);
          }
        }
      }
    }
    return;
  }
  setmaxnreg_inc<NWG == 2 ? 232 : 240>();

  const int tid = threadIdx.x % 128, lane = tid % 32;
  const int r0 = (tid / 32) * 16 + lane / 4;  // this thread's rows of the warpgroup: r0, r0 + 8
  int it = 0;
  auto wait_full = [&]() {
    const int st = it % nst;
    mbar_wait(&full[st], (it / nst) & 1);
    return ring + (size_t)st * kFcStageBytes;
  };
  auto release = [&](int item) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[item % nst]);
  };

  // the CTA's vectors into shared memory while the first loads fly
  for (int i = threadIdx.x; i < nloc * 64; i += NWG * 128) {
    const bool in = j0 * 64 + i < j1 * 64;
    sbv[i] = in ? a.bvg[j0 * 64 + i] : 0.f;
    sbg[i] = in ? a.bvg[a.Hp + j0 * 64 + i] : 0.f;
  }
  for (int i = threadIdx.x; i < C; i += NWG * 128) sbout[i] = a.bout ? ldf(a.bout + i) : 0.f;
  for (int i = threadIdx.x; i < (a.K + (FILM ? 3 : 1)) * C / 8; i += NWG * 128) {
    const int row = i / (C / 8), v = (i % (C / 8)) * 8;
    const bf16* src = row < a.K ? a.dww + (size_t)row * C : row == a.K ? a.dwb : row == a.K + 1 ? a.g1 : a.g2;
    *reinterpret_cast<uint4*>(sdww + (size_t)row * C + v) = *reinterpret_cast<const uint4*>(src + v);
  }

  fc_consumers_sync<NWG>();

  // the CTA's row tiles, persistent: the producer runs ahead into the next
  // tile's x window and weights
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int row0 = tile * kRows;
    if (FILM) {
      // 1 / rms(x) of every row of the window, one warp a row: from the x
      // boxes once they all sit in the ring, else from global memory
      const int E = kRows + 2 * r;
      const bool resident = kt <= nst;
      if (resident)
        for (int c = 0; c < kt; ++c) mbar_wait(&full[(it + c) % nst], ((it + c) / nst) & 1);
      if (resident) {
        // one thread a row, from the boxes in the ring
        for (int e = threadIdx.x; e < E; e += NWG * 128) {
          float sum = 0.f;
          for (int c = 0; c < kt; ++c) {
            const unsigned char* box = ring + (size_t)((it + c) % nst) * kFcStageBytes;
#pragma unroll
            for (int cc = 0; cc < 8; ++cc) {
              const uint4 v = *reinterpret_cast<const uint4*>(box + fc_chunk(e, cc));
              const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const float2 f = __bfloat1622float2(h[i]);
                sum += f.x * f.x + f.y * f.y;
              }
            }
          }
          rinv[e] = rsqrtf(sum / C + kFcEps);
        }
      } else {
        // one warp a row, from global memory
        for (int e = threadIdx.x / 32; e < E; e += NWG * 4) {
          const int g = row0 - r + e;
          float sum = 0.f;
          if (g >= 0 && g < a.BL)
            for (int c = lane; c < C; c += 32) {
              const float v = ldf(a.x + (size_t)g * C + c);
              sum += v * v;
            }
          sum = warp_sum(sum);
          if (lane == 0) rinv[e] = rsqrtf(sum / C + kFcEps);
        }
      }
      fc_consumers_sync<NWG>();
    }

    // the conv, x box by x box, into y
    for (int c = 0; c < kt; ++c, ++it) {
      unsigned char* xs = wait_full();
      if (FILM) {
        fc_film_box<NWG>(xs, c, rinv, sg1, a.xres ? xres : nullptr, a, row0, r);
        fc_consumers_sync<NWG>();
      }
      fc_conv_box<NWG>(xs, c, ys, sdww, sdwb, a, row0, r);
      if (FILM) fence_proxy_async();  // the next TMA write of this stage follows our stores
      release(it);
    }
    fence_proxy_async();  // y, written by threads, is read by wgmma
    fc_consumers_sync<NWG>();
    if (YS && blockIdx.y == 0 && blockIdx.z == 0 && threadIdx.x % 128 == 0) {
      // the backward's y: this warpgroup's tiles, read before the next conv
      for (int c = 0; c < kt; ++c)
        tma_store_3d(&tm_out, ys + (size_t)(c * NWG + wg) * kFcTileBytes, c * 64, row0 + wg * 64, 0);
      tma_store_commit_and_wait();
    }

    float o[kNQ][64];
#pragma unroll
    for (int q = 0; q < kNQ; ++q)
#pragma unroll
      for (int i = 0; i < 64; ++i) o[q][i] = 0.f;
    float acc0[32], acc1[32];  // v | g of the chunk's hidden columns [0, 32) and [32, 64)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.f;
    uint32_t hp[16];
    float ss0 = 0.f, ss1 = 0.f;
    // ring index of the first of the kNQ W_out items a running product still
    // reads (one output group only: at two the registers do not allow it)
    int pending = -1;

    for (int j = j0; j < j1; ++j) {
      // h = v * silu(g) in f32, its squares summed per row, packed to bf16 in
      // the A-operand layout of the second product (accumulator columns
      // [0, 32) are v, [32, 64) g)
      auto gate = [&](const float (&acc)[32], int h) {
#pragma unroll
        for (int i = 0; i < 16; i += 2) {
          const int col = (j - j0) * 64 + h * 32 + (i / 4) * 8 + (lane % 4) * 2;
          const float2 bv = *reinterpret_cast<const float2*>(sbv + col);
          const float2 bg = *reinterpret_cast<const float2*>(sbg + col);
          const float g0 = acc[i + 16] + bg.x, g1 = acc[i + 17] + bg.y;
          const float h0 = __fdividef((acc[i] + bv.x) * g0, 1.f + __expf(-g0));
          const float h1 = __fdividef((acc[i + 1] + bv.y) * g1, 1.f + __expf(-g1));
          if (i % 4 == 0) ss0 += h0 * h0 + h1 * h1;
          else ss1 += h0 * h0 + h1 * h1;
          hp[8 * h + i / 2] = fc_pack(h0, h1);
        }
      };
      if (kHalves) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          for (int k = 0; k < kt; ++k, ++it) {
            unsigned char* w = wait_full();
            const uint64_t ad = wgmma_desc(ys + (size_t)(k * NWG + wg) * kFcTileBytes, 16, 1024);
            const uint64_t bd = wgmma_desc(w, 16, 1024);
            fence_regs(acc0);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_m64n64k16_ss(acc0, ad + 2 * kk, bd + 2 * kk, (k | kk) != 0);
            wgmma_commit();
            if (k > 0) {
              wgmma_wait<1>();
              fence_regs(acc0);
              release(it - 1);
            }
          }
          wgmma_wait<0>();
          fence_regs(acc0);
          release(it - 1);
          gate(acc0, h);
        }
      } else {
        for (int k = 0; k < kt; ++k, ++it) {
          unsigned char* w = wait_full();
          const uint64_t ad = wgmma_desc(ys + (size_t)(k * NWG + wg) * kFcTileBytes, 16, 1024);
          const uint64_t bd = wgmma_desc(w, 16, 1024);
          fence_regs(acc0);
          fence_regs(acc1);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_ss(acc0, ad + 2 * kk, bd + 2 * kk, (k | kk) != 0);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_m64n64k16_ss(acc1, ad + 2 * kk, bd + kFcTileBytes / 16 + 2 * kk, (k | kk) != 0);
          wgmma_commit();
          if (k > 0 || pending >= 0) {
            // all but this group are done: the previous k step, or the last
            // chunk's output product
            wgmma_wait<1>();
            fence_regs(acc0);
            fence_regs(acc1);
            if (k > 0) {
              release(it - 1);
            } else {
              fence_regs(o[0]);
              fence_regs(hp);
              release(pending);
              pending = -1;
            }
          }
        }
        wgmma_wait<0>();
        fence_regs(acc0);
        fence_regs(acc1);
        release(it - 1);
        gate(acc0, 0);
        gate(acc1, 1);
      }
      // o += h W_out over this chunk's 64 hidden columns, 128 output columns a
      // stage; with one output group it runs on into the next chunk's v | g
      const int first = it;
#pragma unroll
      for (int q = 0; q < kNQ; ++q, ++it) {
        unsigned char* w = wait_full();
        const uint64_t bd = wgmma_desc(w, 16, 1024);
        fence_regs(o[q]);
        fence_regs(hp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_m64n128k16_rs(o[q], &hp[4 * kk], bd + 2 * kk, 1);
        wgmma_commit();
      }
      if (kNQ == 1) {
        pending = first;
      } else {
        wgmma_wait<0>();
        fence_regs(hp);
#pragma unroll
        for (int q = 0; q < kNQ; ++q) {
          fence_regs(o[q]);
          release(first + q);
        }
      }
    }
    if (pending >= 0) {
      wgmma_wait<0>();
      fence_regs(hp);
      fence_regs(o[0]);
      release(pending);
    }

    const float tot0 = fc_quad_sum(ss0), tot1 = fc_quad_sum(ss1);
    const int gr0 = row0 + wg * 64 + r0, gr1 = gr0 + 8;
    if (a.ws != nullptr) {
      // partial output and sums of squares of this hidden slice
      float* ws = a.ws + (size_t)s * a.BL * C;
#pragma unroll
      for (int q = 0; q < kNQ; ++q)
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) {
          const int col = n0 + q * 128 + jj * 8 + (lane % 4) * 2;
          if (col >= C) continue;
          if (gr0 < a.BL)
            *reinterpret_cast<float2*>(ws + (size_t)gr0 * C + col) = make_float2(o[q][4 * jj], o[q][4 * jj + 1]);
          if (gr1 < a.BL)
            *reinterpret_cast<float2*>(ws + (size_t)gr1 * C + col) =
                make_float2(o[q][4 * jj + 2], o[q][4 * jj + 3]);
        }
      if (blockIdx.y == 0 && lane % 4 == 0) {
        if (gr0 < a.BL) a.ss[(size_t)s * a.BL + gr0] = tot0;
        if (gr1 < a.BL) a.ss[(size_t)s * a.BL + gr1] = tot1;
      }
      fc_consumers_sync<NWG>();  // both warpgroups are past y before the next conv
      continue;
    }

    // the epilogue in registers: this CTA holds the rows' whole output
    const float hm = (float)ffn_mean_h(a.H, a.Hm);
    const float inv0 = rsqrtf(tot0 / hm + kFcEps), inv1 = rsqrtf(tot1 / hm + kFcEps);
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int q = 0; q < kNQ; ++q)
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int col = n0 + q * 128 + jj * 8 + (lane % 4) * 2;
        const float2 bo = col < C ? *reinterpret_cast<const float2*>(sbout + col) : make_float2(0.f, 0.f);
        o[q][4 * jj] = o[q][4 * jj] * inv0 + bo.x;
        o[q][4 * jj + 1] = o[q][4 * jj + 1] * inv0 + bo.y;
        o[q][4 * jj + 2] = o[q][4 * jj + 2] * inv1 + bo.x;
        o[q][4 * jj + 3] = o[q][4 * jj + 3] * inv1 + bo.y;
        s0 += o[q][4 * jj] * o[q][4 * jj] + o[q][4 * jj + 1] * o[q][4 * jj + 1];
        s1 += o[q][4 * jj + 2] * o[q][4 * jj + 2] + o[q][4 * jj + 3] * o[q][4 * jj + 3];
      }
    if (FILM) {
      // block norm (f32 statistics over the C columns; columns past C are 0)
      // and the gated residual, x and the gate read as bf16 pairs
      const float n0v = rsqrtf(fc_quad_sum(s0) / C + kFcEps);
      const float n1v = rsqrtf(fc_quad_sum(s1) / C + kFcEps);
      const bool ok0 = gr0 < a.BL, ok1 = gr1 < a.BL;
      const size_t gb0 = (size_t)(ok0 ? gr0 / a.L : 0) * C, gb1 = (size_t)(ok1 ? gr1 / a.L : 0) * C;
      // x of rows gr0, gr1: the tile's rows kept in shared memory, or global
      const bf16* xr0 = a.xres ? xres + (size_t)(wg * 64 + r0) * C : a.x + (size_t)gr0 * C;
      const bf16* xr1 = xr0 + (size_t)8 * C;
#pragma unroll
      for (int q = 0; q < kNQ; ++q)
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) {
          const int col = n0 + q * 128 + jj * 8 + (lane % 4) * 2;
          if (col >= C) continue;
          const float2 g2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sg2 + col));
          if (ok0) {
            const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xr0 + col));
            const float2 gt = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.gate + gb0 + col));
            o[q][4 * jj] = bfr(x.x + bfr(o[q][4 * jj] * n0v * g2.x * (1.f + gt.x)));
            o[q][4 * jj + 1] = bfr(x.y + bfr(o[q][4 * jj + 1] * n0v * g2.y * (1.f + gt.y)));
          }
          if (ok1) {
            const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xr1 + col));
            const float2 gt = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.gate + gb1 + col));
            o[q][4 * jj + 2] = bfr(x.x + bfr(o[q][4 * jj + 2] * n1v * g2.x * (1.f + gt.x)));
            o[q][4 * jj + 3] = bfr(x.y + bfr(o[q][4 * jj + 3] * n1v * g2.y * (1.f + gt.y)));
          }
        }
    }
    // bf16 into this warpgroup's (spent) y tiles, swizzled, then TMA stores
    fc_wg_sync(wg);
#pragma unroll
    for (int q = 0; q < kNQ; ++q)
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int cl = q * 128 + jj * 8 + (lane % 4) * 2;  // column within the CTA's group
        if (n0 + cl >= C) continue;
        unsigned char* tile = ys + (size_t)((cl / 64) * NWG + wg) * kFcTileBytes;
        *reinterpret_cast<uint32_t*>(tile + swizzle128(r0, cl % 64)) = fc_pack(o[q][4 * jj], o[q][4 * jj + 1]);
        *reinterpret_cast<uint32_t*>(tile + swizzle128(r0 + 8, cl % 64)) =
            fc_pack(o[q][4 * jj + 2], o[q][4 * jj + 3]);
      }
    fence_proxy_async();
    fc_wg_sync(wg);
    if (tid == 0) {
      for (int t = 0; t < NC / 64 && n0 + t * 64 < C; ++t)
        tma_store_3d(&tm_out, ys + (size_t)(t * NWG + wg) * kFcTileBytes, n0 + t * 64, row0 + wg * 64, 0);
      tma_store_commit_and_wait();
    }
    // the stores have read y before the next tile's conv writes it
    fc_consumers_sync<NWG>();
  }
}

// the epilogue where the output was split across CTAs: per row (one warp),
// the partials summed in slice order, scaled by 1 / rms(h), biased; K2 then
// its block norm and gated residual
template <bool FILM>
__global__ void __launch_bounds__(256) ffn_reduce_kernel(const FfnArgs a, bf16* __restrict__ out) {
  const int g = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (g >= a.BL) return;
  const int C = a.C;
  const size_t plane = (size_t)a.BL * C;
  float tot = 0.f;
  for (int s = 0; s < a.S; ++s) tot += a.ss[(size_t)s * a.BL + g];
  const float inv = rsqrtf(tot / ffn_mean_h(a.H, a.Hm) + kFcEps);
  auto value = [&](int c) {
    float acc = 0.f;
    for (int s = 0; s < a.S; ++s) acc += a.ws[s * plane + (size_t)g * C + c];
    return acc * inv + ldf(a.bout + c);
  };
  bf16* orow = out + (size_t)g * C;
  if (!FILM) {
    for (int c = lane; c < C; c += 32) orow[c] = __float2bfloat16(value(c));
    return;
  }
  float s2 = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float v = value(c);
    s2 += v * v;
  }
  const float n2 = rsqrtf(warp_sum(s2) / C + kFcEps);
  const size_t fb = (size_t)(g / a.L) * C;
  for (int c = lane; c < C; c += 32) {
    const float b2 = ldf(a.g2 + c) * (1.f + ldf(a.gate + fb + c));
    orow[c] = __float2bfloat16(ldf(a.x + (size_t)g * C + c) + bfr(value(c) * n2 * b2));
  }
}

// the weights' tensor maps (W_vg^T in 64 x 32 boxes, W_out^T in 64 x 64),
// encoded once per packed weight version into `maps` (two CUtensorMap)
inline int ffn_weight_maps(const void* wvgT, const void* woutT, int C, int Hp, void* maps) {
  CUtensorMap m[2];
  cudaError_t err = hopper::tma_map_bf16_3d(&m[0], wvgT, C, 2 * (uint64_t)Hp, 1, 64, 32);
  if (err == cudaSuccess) err = hopper::tma_map_bf16_3d(&m[1], woutT, Hp, C, 1, 64, 64);
  if (err == cudaSuccess) memcpy(maps, m, sizeof(m));
  return (int)err;
}

// launch the core (and the reduction where the output is split) on `stream`;
// nc the output columns of a CTA (128 or 256), a.S the hidden slices. With
// a.ystore (the backward's first pass) `out` is where y goes, and the
// partials stay in the workspace.
template <bool FILM>
int ffn_forward(FfnArgs a, const void* wmaps, void* out, int nc, cudaStream_t stream) {
  const int nwg = a.nwg ? a.nwg : a.C <= 512 ? 2 : 1, rows = 64 * nwg, r = a.K / 2;
  const int groups = (a.C + nc - 1) / nc;
  const bool split = groups > 1 || a.S > 1;
  const bool keep = a.ystore || a.partial;  // the partials stay in the workspace
  if (a.K % 2 == 0 || r > kFcMaxRadius || a.C % 16 || a.Hp % 64 || a.Hp < a.H || a.S < 1 ||
      a.S > a.Hp / 64 || (nc != 128 && nc != 256) || (split || keep) != (a.ws != nullptr) ||
      a.BL < 1 || nwg < 1 || nwg > 2 || (nwg == 2 && a.C > 512) || a.Hm < 0)
    return (int)cudaErrorInvalidValue;
  const int nloc = (a.Hp / 64 + a.S - 1) / a.S;
  // K2 keeps its rows' x for the residual where that leaves 4 stages
  a.xres = FILM && a.ws == nullptr && ffn_stages(a.C, a.K, nloc, FILM, nwg, true) >= 4;
  a.stages = ffn_stages(a.C, a.K, nloc, FILM, nwg, a.xres);
  if (a.stages < 2) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  memcpy(&maps[1], wmaps, 2 * sizeof(CUtensorMap));
  cudaError_t err = hopper::tma_map_bf16_3d(&maps[0], a.x, a.C, a.BL, 1, 64, rows + 2 * r);
  if (err == cudaSuccess) err = hopper::tma_map_bf16_3d(&maps[3], out, a.C, a.BL, 1, 64, 64);
  if (err != cudaSuccess) return (int)err;
  // persistent CTAs: as many row-tile walkers as fill the SMs beside the
  // column groups and hidden slices
  const int sms = device_sms();
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  const int ntiles = (a.BL + rows - 1) / rows;
  const int walkers = sms / (groups * a.S) > 1 ? sms / (groups * a.S) : 1;
  const dim3 grid(ntiles < walkers ? ntiles : walkers, groups, a.S);
  const size_t smem = FcLayout(a.C, a.K, nloc, FILM, nwg, a.stages, a.xres).total;
  const dim3 block((nwg + 1) * 128);
  if constexpr (FILM) {
    if (nc != 128) return (int)cudaErrorInvalidValue;  // K2 keeps 128 output columns a CTA
  }
  auto run = [&](auto kernel) {
    return launch(kernel, grid, block, smem, stream, maps[0], maps[1], maps[2], maps[3], a);
  };
  auto pick = [&](auto ys) {
    constexpr bool YS = decltype(ys)::value;
    if (!FILM && nwg == 2 && nc == 256) return run(ffn_core_kernel<FILM, 2, FILM ? 128 : 256, YS>);
    if (nwg == 2) return run(ffn_core_kernel<FILM, 2, 128, YS>);
    if (!FILM && nc == 256) return run(ffn_core_kernel<FILM, 1, FILM ? 128 : 256, YS>);
    return run(ffn_core_kernel<FILM, 1, 128, YS>);
  };
  if constexpr (FILM)  // only K3's backward runs the first pass
    err = a.ystore ? pick(std::true_type{}) : pick(std::false_type{});
  else
    err = a.ystore ? cudaErrorInvalidValue : pick(std::false_type{});
  if (err != cudaSuccess || a.ws == nullptr || keep) return (int)err;
  return (int)launch(ffn_reduce_kernel<FILM>, dim3((a.BL + 7) / 8), dim3(256), 0, stream, a,
                     (bf16*)out);
}

// a TP slice's finish, after the model group's all-reduce of its workspace:
// the reduction kernel over the summed partials (a.S slices), 1 / rms with
// the whole hidden width a.Hm, b_out once; K2 then its block norm and gated
// residual (x, gate, g2)
template <bool FILM>
int ffn_finish(const FfnArgs& a, void* out, cudaStream_t stream) {
  if (a.ws == nullptr || a.ss == nullptr || a.bout == nullptr || a.BL < 1 || a.C < 1 ||
      a.S < 1 || a.Hm < 1 || (FILM && (a.x == nullptr || a.gate == nullptr || a.g2 == nullptr)))
    return (int)cudaErrorInvalidValue;
  return (int)launch(ffn_reduce_kernel<FILM>, dim3((a.BL + 7) / 8), dim3(256), 0, stream, a,
                     (bf16*)out);
}

// A TP slice's S per-slice f32 planes of n values summed in slice order into
// one, dst[i] = src[i] + src[n + i] + ..., so the model group all-reduces a
// single plane whatever the plan's hidden slices.
static __global__ void __launch_bounds__(256)
tp_fold_kernel(const float* __restrict__ src, int S, size_t n, float* __restrict__ dst) {
  for (size_t i = (size_t)blockIdx.x * 256 + threadIdx.x; i < n; i += (size_t)gridDim.x * 256) {
    float acc = 0.f;
    for (int s = 0; s < S; ++s) acc += src[(size_t)s * n + i];
    dst[i] = acc;
  }
}

inline cudaError_t tp_fold(const float* src, int S, size_t n, float* dst, cudaStream_t stream) {
  if (src == nullptr || dst == nullptr || S < 1) return cudaErrorInvalidValue;
  const size_t blocks = (n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096;
  return launch(tp_fold_kernel, dim3((unsigned)blocks), dim3(256), 0, stream, src, S, n, dst);
}

// a TP form's forward workspace (a.S slices of ws, then of ss) summed into
// one plane: sum = [ws (B L, C) | ss (B L)]
inline int tp_fold_workspace(const FfnArgs& a, float* sum, cudaStream_t stream) {
  const size_t plane = (size_t)a.BL * a.C;
  cudaError_t e = tp_fold(a.ws, a.S, plane, sum, stream);
  if (e == cudaSuccess) e = tp_fold(a.ss, a.S, (size_t)a.BL, sum + plane, stream);
  return (int)e;
}

}  // namespace odt
