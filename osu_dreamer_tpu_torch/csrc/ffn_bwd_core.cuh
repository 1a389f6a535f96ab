// The gated conv-FFN backward core for Hopper, shared by the film-layer
// backward (K3, film_layer_bwd.cu) and the SwiGLU backward (K6 and K5,
// swiglu_bwd.cu). The forward, per position (ffn_core.cuh):
//
//   y   = depthwise conv (K2: of h1 = the pre-norm + FiLM of x)
//   v,g = y W_vg + b_vg     s = v silu(g)     n = 1 / rms_H(s)
//   o   = n s W_out + b_out     (K2 then: out = x + rms_C(o) g2 (1 + gate) o)
//
// and back, with do the gradient of o (K6: the output gradient; K3: the
// block norm's backward of it):
//
//   dhn = do W_out^T    ds = n dhn - n^3 m s,  m = mean_H(dhn s)
//   dv = ds silu(g)     dg = ds v silu'(g)     dY = [dv|dg] W_vg^T
//   dh1 = the transposed conv of dY (K3 then the FiLM and pre-norm backward)
//
// What bounds it on the H100: per row 8 C H multiply-adds on the tensor
// cores (v|g twice, o, dhn, dY), 900-3,600 operations a byte of x, the
// output gradient and dx at the shipped widths (C 128, 512), so the tensor
// cores, provided the hidden activations (rows x 2H) stay out of device
// memory except dvg and hn, which the weight gradients need anyway. The
// design:
//
// - pass A gives each row the sums n and m need, so that pass B forms every
//   hidden activation once: neither a second pass over dhn nor the linear
//   split of dvg (n P - n^3 m Q, two dY accumulators a thread) is needed,
//   and dvg is rounded to bf16 once. K3 needs o for its block norm, and
//   m = mean_H(dhn s) = (1/H) sum_C do (s W_out) with s W_out the
//   forward's own unnormalised product: so K3's pass A is the forward core
//   itself (ffn_core.cuh in its `ystore` mode: flat rows, TMA weight ring,
//   v|g on wgmma, the gate in registers, o += s W_out with s from
//   registers; the f32 partial o and sums of squares go to a workspace, y
//   to device memory for the weight gradient and pass B). K6 and K5 know do
//   (the output gradient) up front: bwd_conv_kernel writes y, and pass A is
//   pass B's kernel in its statistics mode (v|g and dhn, then the sums of
//   s^2 and dhn s a row; 3 C H multiply-adds a row, where the forward core
//   would take 5 at C 512).
// - bwd_mid_kernel, one warp a row: the partials summed in a fixed order,
//   n; K3's o, its block-norm backward (do, written bf16, and its
//   per-column sums) and m = (1/H) do . (s W_out); K6's m = (1/H) sum dhn s;
//   each row leaves (n, n^3 m).
// - pass B (ffn_bwd_grad_kernel) streams the hidden dimension once more in
//   chunks of 64, every hidden activation formed once a row: per chunk
//   v|g = y W_vg (m64n64, both from shared memory) and dhn = do W_out^T
//   (m64n64, W_out^T's tile read MN-major with the transpose bit) on the
//   same weight stage, ds, dv, dg in registers straight from the
//   accumulators, then dY += dvg W_vg^T with dvg from registers (the
//   accumulator layout is the A operand's) and W_vg's tile read MN-major.
//   y and do of the CTA's rows are loaded once (TMA) and stay in shared
//   memory; the weights come through a TMA ring as in the forward (W_vg
//   twice a chunk: for v|g and for dY). dvg and hn leave bf16, the vg-bias
//   sums as per-warpgroup partials, dY as an f32 partial per hidden slice.
//   Register budget a consumer thread: dY 32 a 64-column tile, v|g 32 a
//   32-column half, dhn 32, dvg packed 16 a half.
//   A warpgroup holds up to 128 dY columns (two tiles, 64; both halves of
//   v|g) and the CTA's warpgroups take 64 rows each; wider C up to 384
//   runs 128-column groups across CTAs (gridDim.y), each forming v|g and
//   dhn again; the slice's vg biases sit in shared memory. Past C 384 (the
//   paired mode, up to C 512) the CTA's two consumer warpgroups share one
//   64-row tile: each
//   forms one 32-column half of every chunk's v|g (dhn whole, 1 C H more a
//   row than once), holds half of the dY column tiles (up to four, 128
//   registers; ptxas spills about 300 bytes a thread at C 512), and hands
//   its half of dvg to the other through a swizzled shared tile, the A
//   operand of the other's dY product (its own half stays in registers):
//   6 C H a row, every dY column formed in one CTA; the biases come
//   through L1, so that the ring keeps three stages at C 512. What bounds
//   the paired mode there is the weight stream: every 64-row tile reads
//   W_vg twice and W_out once from L2, 320 KB a hidden chunk (a cluster
//   sharing the stream by TMA multicast is the next step). At C 640 the y
//   and do tiles (160 KB) leave no room for the exchange: column groups
//   again. (The paired mode measured slower than the column groups at
//   C 256 and 384 on an H100 80GB HBM3 at 700 W: K3 0.4225 vs 0.3657 and
//   0.6817 vs 0.6304 ms, K5 1.0877 vs 1.0555.)
// - the finish, over `frows` rows of one batch row a CTA (K3 32, K6 80,
//   48 past C 512): the dY partials summed in order, the transposed conv,
//   K3's FiLM and pre-norm backward to dx (K6: dx is the transposed conv),
//   and the column partials (conv taps and bias; K3's FiLM vectors and g1;
//   K6's out bias). K3's (bwd_finish_film_kernel) holds the dY and x windows
//   in shared memory, element-parallel but for the pre-norm's row sums;
//   K6's (bwd_finish_plain_kernel) runs one thread a column pair down the
//   rows with the windows in registers.
// - Flat (B L) rows of 64 a warpgroup, one or two consumer warpgroups a
//   CTA; at the short levels the hidden dimension also splits across CTAs
//   (``bwd_plan``, ops/swiglu.py), so that the grid fills the card. Every
//   sum over rows is a fixed-order partial: no float atomics, two runs give
//   bit-identical gradients.
// - The weights are the forward's pack (ops/swiglu.py ``packed_ffn_weights``):
//   W_vg^T (2 Hp, C) and W_out^T (C, Hp), their tensor maps encoded once.
// - Tensor parallelism (the TP forms of K6 and K3): a rank's slice of the
//   hidden units runs the phases one at a time (``phases``). The forward's
//   all-reduced f32 s W_out and sums of squares are the residuals that give
//   n and m over the whole hidden width (Hm): K3's pass A is skipped (its y
//   is the TP forward's), and K6 skips its statistics pass, taking
//   m = (1/H) do . (s W_out) in bwd_mid_kernel as K3 does. Pass B runs on
//   the slice; its SB dY partials are summed into one plane (tp_fold), which
//   the caller all-reduces over the model group before the finish (SB 1), so
//   the transposed conv and every column sum see the whole dY and agree on
//   every rank.
#pragma once

#include "ffn_core.cuh"

namespace odt {

constexpr uint32_t kBgStageBytes = 24 * 1024;  // W_vg's two 64-row tiles and one W_out^T tile
constexpr int kBgMaxStages = 6;
constexpr int kBgCols = 128;    // dY columns a CTA holds, one warpgroup a row tile
constexpr int kBpFrom = 384;    // the paired mode runs past this C (below, the column groups
                                // measured faster on an H100)...
constexpr int kBpCols = 512;    // ...up to this: two warpgroups, four dY tiles each
constexpr int kBmRows = 32;    // rows of one batch row a CTA: the statistics, K3's finish
constexpr int kBmMaxCQ = 20;    // C / 32 up to 640
constexpr int kBfMaxK = 9;

struct BwdArgs {
  const bf16* x;      // (B L, C)
  const bf16* go;     // (B L, C) the output gradient
  const bf16* scale;  // (B, C), K3 only
  const bf16* shift;
  const bf16* gate;
  const bf16* g1;     // (C), K3 only
  const bf16* g2;
  const bf16* dww;    // (K, C)
  const bf16* dwb;    // (C)
  const float* bvg;   // (2 Hp)
  const bf16* bout;   // (C)
  float* ws;          // (SA, B L, C) K3's pass A: partial s W_out
  float* ss;          // (SA, B L) pass A's partial sums of s^2; K6 then (SA, B L) of dhn s
  bf16* y;            // (B L, C) the conv output
  bf16* dout;         // (B L, C) K3: the gradient of o (K6 reads go)
  float* rows;        // (B L, 2): n and n^3 m
  float* mid;         // K3 (B, ceil(L / 32), 3, C): dgate, dg2, dbout partials
  bf16* dvg;          // (B L, 2 Hp)
  bf16* hn;           // (B L, Hp)
  float* dbvg;        // (tiles x nwg, 2 Hp) partials
  float* dy;          // (SB, B L, C) partial dY
  float* fin;         // (B, ceil(L / frows), slots, C) the finish's column partials
  bf16* dx;           // (B L, C)
  int B, L, BL, C, H, Hp, K, SA, SB, nwg, frows;
  int Hm;  // the hidden width of n's and m's means: the whole H of a TP slice (0: H)
};

// the phases of ffn_backward: pass A (K3: the forward core; K6: the conv and,
// without the forward's residuals, the statistics pass), the row statistics,
// pass B, the finish
constexpr int kBwdPassA = 1, kBwdRows = 2, kBwdPassB = 4, kBwdFinish = 8, kBwdAll = 15;

// ---- the row statistics (and K3's block-norm backward) ----

template <bool FILM, int CQ>  // C = 32 CQ: lane owns columns lane + 32 q
__global__ void __launch_bounds__(256) bwd_mid_kernel(const BwdArgs a) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y, t0 = blockIdx.x * kBmRows;
  constexpr int C = 32 * CQ;
  __shared__ float red[FILM ? 3 * C : 1];
  float pg[CQ], p2[CQ], pbo[CQ];
#pragma unroll
  for (int q = 0; q < CQ; ++q) pg[q] = p2[q] = pbo[q] = 0.f;
  for (int i = warp; i < kBmRows; i += 8) {
    const int pos = t0 + i;
    if (pos >= a.L) break;
    const size_t p = (size_t)b * a.L + pos;
    float ss = 0.f;
    for (int s = 0; s < a.SA; ++s) ss += a.ss[(size_t)s * a.BL + p];
    const float hm = (float)ffn_mean_h(a.H, a.Hm);
    const float n = rsqrtf(ss / hm + kFcEps);
    float md = 0.f;
    if (FILM) {
      float oa[CQ];  // s W_out of this row, summed over the hidden slices in order
#pragma unroll
      for (int q = 0; q < CQ; ++q) {
        float acc = 0.f;
        for (int s = 0; s < a.SA; ++s) acc += a.ws[((size_t)s * a.BL + p) * C + lane + 32 * q];
        oa[q] = acc;
      }
      // K2's epilogue, out = x + bf16(o n2 g2 (1 + gate)), differentiated in f32
      float o[CQ], don[CQ], s2 = 0.f, sm = 0.f;
#pragma unroll
      for (int q = 0; q < CQ; ++q) {
        o[q] = oa[q] * n + ldf(a.bout + lane + 32 * q);
        s2 += o[q] * o[q];
      }
      const float n2 = rsqrtf(warp_sum(s2) / C + kFcEps);
#pragma unroll
      for (int q = 0; q < CQ; ++q) {
        const int c = lane + 32 * q;
        const float gf = ldf(a.go + p * C + c), gt = ldf(a.gate + (size_t)b * C + c);
        const float g2 = ldf(a.g2 + c);
        pg[q] += gf * o[q] * n2 * g2;
        p2[q] += gf * (1.f + gt) * o[q] * n2;
        don[q] = gf * (1.f + gt) * g2;
        sm += don[q] * o[q];
      }
      const float mm = warp_sum(sm) / C;
#pragma unroll
      for (int q = 0; q < CQ; ++q) {
        const bf16 d = __float2bfloat16(n2 * don[q] - n2 * n2 * n2 * o[q] * mm);
        a.dout[p * C + lane + 32 * q] = d;
        pbo[q] += __bfloat162float(d);
        md += __bfloat162float(d) * oa[q];
      }
      md = warp_sum(md);
    } else if (a.ws != nullptr) {
      // the forward's summed s W_out: sum_H dhn s = do . (s W_out)
#pragma unroll
      for (int q = 0; q < CQ; ++q) {
        const int c = lane + 32 * q;
        float acc = 0.f;
        for (int s = 0; s < a.SA; ++s) acc += a.ws[((size_t)s * a.BL + p) * C + c];
        md += ldf(a.go + p * C + c) * acc;
      }
      md = warp_sum(md);
    } else {
      for (int s = 0; s < a.SA; ++s) md += a.ss[((size_t)a.SA + s) * a.BL + p];  // sum dhn s
    }
    const float m = md / hm;
    if (lane == 0) *reinterpret_cast<float2*>(a.rows + 2 * p) = make_float2(n, n * n * n * m);
  }
  if (!FILM) return;
  // the block's column sums, warp by warp in warp order
  for (int w = 0; w < 8; ++w) {
    if (warp == w) {
#pragma unroll
      for (int q = 0; q < CQ; ++q) {
        float* r = red + lane + 32 * q;
        r[0] = (w ? r[0] : 0.f) + pg[q];
        r[C] = (w ? r[C] : 0.f) + p2[q];
        r[2 * C] = (w ? r[2 * C] : 0.f) + pbo[q];
      }
    }
    __syncthreads();
  }
  float* out = a.mid + ((size_t)b * gridDim.x + blockIdx.x) * 3 * C;
  for (int i = threadIdx.x; i < 3 * C; i += 256) out[i] = red[i];
}

// ---- pass B ----

// byte offsets from the 1024-aligned base: y tiles, do tiles (rw row
// warpgroups), ring, the paired mode's two dvg halves, the slice's b_v and
// b_g (nloc chunks; the paired mode reads them through L1, its shared
// memory goes to the ring), the vg-bias column sums of each consumer
// warpgroup, barriers
struct BgLayout {
  size_t dos, ring, xch, params, red, bars, total;
  __host__ __device__ BgLayout(int C, int rw, int pair, int nloc, int stages) {
    dos = (size_t)((C + 63) / 64) * rw * kFcTileBytes;
    ring = 2 * dos;
    xch = ring + (size_t)stages * kBgStageBytes;
    params = xch + (size_t)pair * 2 * kFcTileBytes;
    red = params + (size_t)(1 - pair) * 2 * nloc * 64 * 4;
    bars = red + (size_t)(rw + pair) * 2 * 4 * 128 * 4;
    total = bars + (2 * kBgMaxStages + 1) * sizeof(uint64_t) + 1024;  // + slack to align the base
  }
};

// as many stages as fit (ops/swiglu.py bwd_stages mirrors it)
inline int bwd_stages(int C, int rw, int pair, int nloc) {
  const size_t fixed = BgLayout(C, rw, pair, nloc, 0).total;
  if (fixed > kMaxSmem) return 0;
  const size_t n = (kMaxSmem - fixed) / kBgStageBytes;
  return (int)(n < kBgMaxStages ? n : kBgMaxStages);
}

// STATS: K6's pass A, the same products without dY (per row the sums of s^2
// and dhn s over the CTA's hidden slice, a.SA slices). PAIR: pass B past
// C 384, two consumer warpgroups on one 64-row tile splitting the hidden
// chunks' halves and the dY column tiles between them (the note above).
template <int NWG, bool STATS, bool PAIR>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
ffn_bwd_grad_kernel(const __grid_constant__ CUtensorMap tm_y, const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_wvg,
                    const __grid_constant__ CUtensorMap tm_wout, const BwdArgs a, const int nst) {
  static_assert(!PAIR || (NWG == 2 && !STATS), "the paired mode is pass B's, on two warpgroups");
  constexpr int RW = PAIR ? 1 : NWG, kRows = 64 * RW;  // RW: warpgroups of their own 64 rows
  constexpr int NQ = PAIR ? kBpCols / 128 : kBgCols / 64;  // the dY column tiles a warpgroup holds
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int C = a.C, kt = (C + 63) / 64, row0 = blockIdx.x * kRows, gy = blockIdx.y;
  // PAIR: warpgroup 0 holds dY tiles [0, half), warpgroup 1 [half, kt);
  // else the CTA's column group gy, tiles [NQ gy, NQ gy + nqy)
  const int half = (kt + 1) / 2;
  const int nqy = STATS ? 0 : kt - NQ * gy < NQ ? kt - NQ * gy : NQ;
  const int s = blockIdx.z, nch = a.Hp / 64, S = STATS ? a.SA : a.SB;
  const int j0 = s * nch / S, j1 = (s + 1) * nch / S, nloc = (nch + S - 1) / S;
  const BgLayout lay(C, RW, PAIR, nloc, nst);
  unsigned char* ys = smem;
  unsigned char* dos = smem + lay.dos;
  unsigned char* ring = smem + lay.ring;
  unsigned char* xch = smem + lay.xch;
  float* sbv = reinterpret_cast<float*>(smem + lay.params);
  float* sbg = sbv + nloc * 64;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* empty = full + kBgMaxStages;
  uint64_t* res = empty + kBgMaxStages;
  const int wg = threadIdx.x / 128;
  float* red = reinterpret_cast<float*>(smem + lay.red) + wg * 2 * 4 * 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < nst; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], NWG * 4);  // one arrival per consumer warp
    }
    mbar_init(res, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == NWG) {
    // producer: the CTA's y and do tiles once, then per hidden chunk the W_vg
    // and W_out^T tiles of every 64 input channels (v|g and dhn), then W_vg's
    // tiles of the CTA's dY columns (dY; PAIR: the two warpgroups' in turn)
    setmaxnreg_dec<40>();
    if (threadIdx.x % 128 == 0) {
      mbar_arrive_expect_tx(res, 2 * kt * RW * kFcTileBytes);
      for (int c = 0; c < kt; ++c)
        for (int w = 0; w < RW; ++w) {
          tma_load_3d(ys + (size_t)(c * RW + w) * kFcTileBytes, &tm_y, res, c * 64, row0 + 64 * w, 0);
          tma_load_3d(dos + (size_t)(c * RW + w) * kFcTileBytes, &tm_do, res, c * 64, row0 + 64 * w, 0);
        }
      int it = 0;
      auto stage = [&](uint32_t bytes) {
        const int st = it % nst;
        if (it >= nst) mbar_wait(&empty[st], (it / nst - 1) & 1);
        mbar_arrive_expect_tx(&full[st], bytes);
        ++it;
        return ring + (size_t)st * kBgStageBytes;
      };
      auto bar = [&]() { return &full[(it - 1) % nst]; };
      // v | g of hidden columns j 64 + h 32 + [0, 32) for channels k 64..
      auto wvg_tile = [&](unsigned char* dst, int j, int k, int h) {
        tma_load_3d(dst, &tm_wvg, bar(), k * 64, j * 64 + h * 32, 0);
        tma_load_3d(dst + kFcTileBytes / 2, &tm_wvg, bar(), k * 64, a.Hp + j * 64 + h * 32, 0);
      };
      auto dy_tile = [&](int j, int q) {
        unsigned char* dst = stage(2 * kFcTileBytes);
        wvg_tile(dst, j, q, 0);
        wvg_tile(dst + kFcTileBytes, j, q, 1);
      };
      for (int j = j0; j < j1; ++j) {
        for (int k = 0; k < kt; ++k) {
          unsigned char* dst = stage(3 * kFcTileBytes);
          wvg_tile(dst, j, k, 0);
          wvg_tile(dst + kFcTileBytes, j, k, 1);
          tma_load_3d(dst + 2 * kFcTileBytes, &tm_wout, bar(), j * 64, k * 64, 0);
        }
        if (PAIR) {
          for (int i = 0; i < half; ++i) {
            dy_tile(j, i);
            if (half + i < kt) dy_tile(j, half + i);
          }
        } else {
          for (int q = 0; q < nqy; ++q) dy_tile(j, NQ * gy + q);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<NWG == 2 ? 232 : 240>();

  const int tid = threadIdx.x % 128, lane = tid % 32, warp = tid / 32;
  const int r0 = warp * 16 + lane / 4;  // this thread's rows of the warpgroup: r0, r0 + 8
  const int gr0 = row0 + (PAIR ? 0 : wg * 64) + r0, gr1 = gr0 + 8;
  int it = 0;
  auto wait_full = [&]() {
    const int st = it % nst;
    mbar_wait(&full[st], (it / nst) & 1);
    return ring + (size_t)st * kBgStageBytes;
  };
  auto release = [&](int item) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[item % nst]);
  };

  if constexpr (!PAIR) {
    for (int i = threadIdx.x; i < nloc * 64; i += NWG * 128) {
      const bool in = j0 * 64 + i < j1 * 64;
      sbv[i] = in ? a.bvg[j0 * 64 + i] : 0.f;
      sbg[i] = in ? a.bvg[a.Hp + j0 * 64 + i] : 0.f;
    }
  }
  // b_v (g = 0) or b_g (g = 1) of hidden columns hc, hc + 1
  auto bias = [&](int hc, int g) -> float2 {
    if constexpr (PAIR) return __ldg(reinterpret_cast<const float2*>(a.bvg + g * a.Hp + hc));
    else return *reinterpret_cast<const float2*>((g ? sbg : sbv) + hc - j0 * 64);
  };
  // (n, n^3 m) of the thread's rows; zero past the rows, so that their
  // ds, dvg and dY are zero
  const float2 st0 = gr0 < a.BL ? *reinterpret_cast<const float2*>(a.rows + 2 * gr0) : make_float2(0.f, 0.f);
  const float2 st1 = gr1 < a.BL ? *reinterpret_cast<const float2*>(a.rows + 2 * gr1) : make_float2(0.f, 0.f);
  if constexpr (!PAIR) fc_consumers_sync<NWG>();
  mbar_wait(res, 0);

  const bool lead = PAIR || gy == 0;  // column group 0 writes dvg, hn and the vg-bias sums
  const int nq = PAIR ? (wg ? kt - half : half) : nqy;  // this warpgroup's dY tiles
  const int q0 = PAIR ? wg * half : NQ * gy;            // and the first of them
  float ss0 = 0.f, ss1 = 0.f, sd0 = 0.f, sd1 = 0.f;  // STATS: the sums of the thread's rows
  float dy[NQ][32];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int i = 0; i < 32; ++i) dy[q][i] = 0.f;
  const uint64_t ydesc = wgmma_desc(ys + (size_t)(PAIR ? 0 : wg) * kFcTileBytes, 16, 1024);
  const uint64_t odesc = wgmma_desc(dos + (size_t)(PAIR ? 0 : wg) * kFcTileBytes, 16, 1024);
  // the other warpgroup's dvg half, K-major, as the A operand
  const uint64_t xdesc = wgmma_desc(xch + (size_t)(1 - wg) * kFcTileBytes, 16, 1024);
  constexpr uint64_t kTileStep = (uint64_t)RW * kFcTileBytes / 16;  // next 64 channels
  constexpr uint64_t kHalf = kFcTileBytes / 16;                      // the W stage's second half

  for (int j = j0; j < j1; ++j) {
    // ds, dv, dg in place of v, g of hidden half h (accumulator columns
    // [0, 32) v, [32, 64) g); packed bf16 in the A-operand layout of dY's
    // product (k16 step kk: pk[4 kk .. 4 kk + 3]); the lead group stores
    // dvg and hn
    auto gate = [&](float (&acc)[32], const float (&dhn)[32], uint32_t (&pk)[16], int h) {
#pragma unroll
      for (int i = 0; i < 16; i += 2) {
        const int hc = j * 64 + h * 32 + (i / 4) * 8 + (lane % 4) * 2;
        const float2 bv = bias(hc, 0), bg = bias(hc, 1), st = (i & 2) ? st1 : st0;
        const int gr = (i & 2) ? gr1 : gr0;
        float hv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = acc[i + e] + (e ? bv.y : bv.x), g = acc[i + e + 16] + (e ? bg.y : bg.x);
          const float sig = __fdividef(1.f, 1.f + __expf(-g)), sil = g * sig, sv = v * sil;
          const float ds = st.x * dhn[16 * h + i + e] - st.y * sv;
          acc[i + e] = ds * sil;
          acc[i + e + 16] = ds * v * sig * (1.f + g * (1.f - sig));
          hv[e] = st.x * sv;
        }
        if (lead && gr < a.BL)  // hn of the row, a bf16 pair
          *reinterpret_cast<uint32_t*>(a.hn + (size_t)gr * a.Hp + hc) = fc_pack(hv[0], hv[1]);
      }
#pragma unroll
      for (int m = 0; m < 16; ++m) pk[m] = fc_pack(acc[2 * m], acc[2 * m + 1]);
      if (!lead) return;
      // dvg of the thread's rows, bf16 pairs
#pragma unroll
      for (int i = 0; i < 16; i += 2) {
        const int hc = j * 64 + h * 32 + (i / 4) * 8 + (lane % 4) * 2;
        const int gr = (i & 2) ? gr1 : gr0;
        if (gr >= a.BL) continue;
        *reinterpret_cast<uint32_t*>(a.dvg + (size_t)gr * 2 * a.Hp + hc) = pk[i / 2];
        *reinterpret_cast<uint32_t*>(a.dvg + (size_t)gr * 2 * a.Hp + a.Hp + hc) = pk[8 + i / 2];
      }
    };
    // the vg-bias sums of half h's 64 columns (32 v, 32 g) over the
    // warpgroup's rows (bf16 dvg, as the weight gradient reads it), in a
    // fixed order: the thread's two rows, the 8 lanes of a column (a
    // reduce-scatter: each step halves the values a lane holds), then the 4
    // warps (colsum_write, once the halves sit in the buffer)
    float* buf = red + ((j - j0) & 1) * 4 * 128;
    auto colsum_half = [&](const uint32_t (&pk)[16], int h) {
      float v16[16];  // index vg 8 + jj 2 + e: vg 0 v, 1 g
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int vg = 0; vg < 2; ++vg) {
          // the two rows' bf16 pairs (low half: the even column)
          const uint32_t lo = pk[8 * vg + 2 * jj], hi = pk[8 * vg + 2 * jj + 1];
          v16[8 * vg + 2 * jj] = __uint_as_float(lo << 16) + __uint_as_float(hi << 16);
          v16[8 * vg + 2 * jj + 1] = __uint_as_float(lo & 0xffff0000u) + __uint_as_float(hi & 0xffff0000u);
        }
      const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
      float v8[8], v4[4], v2[2];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v8[i] = (b4 ? v16[8 + i] : v16[i]) + __shfl_xor_sync(0xffffffffu, b4 ? v16[i] : v16[8 + i], 16);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v4[i] = (b3 ? v8[4 + i] : v8[i]) + __shfl_xor_sync(0xffffffffu, b3 ? v8[i] : v8[4 + i], 8);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        v2[i] = (b2 ? v4[2 + i] : v4[i]) + __shfl_xor_sync(0xffffffffu, b2 ? v4[i] : v4[2 + i], 4);
      // v2[e]: vg = b4, jj = 2 b3 + b2
#pragma unroll
      for (int e = 0; e < 2; ++e)
        buf[warp * 128 + (b4 ? 64 : 0) + h * 32 + ((b3 ? 2 : 0) + (b2 ? 1 : 0)) * 8 + (lane % 4) * 2 + e] = v2[e];
    };
    // the buffer's columns of this warpgroup's halves (PAIR: its own half)
    auto colsum_write = [&]() {
      fc_wg_sync(wg);
      if (PAIR && (tid % 64) / 32 != wg) return;
      const float sum = ((buf[tid] + buf[128 + tid]) + buf[256 + tid]) + buf[384 + tid];
      const int col = tid < 64 ? j * 64 + tid : a.Hp + j * 64 + tid - 64;
      a.dbvg[((size_t)blockIdx.x * RW + (PAIR ? 0 : wg)) * 2 * a.Hp + col] = sum;
    };
    // v | g (acc0: hidden columns [0, 32), acc1: [32, 64); PAIR: acc0 the
    // warpgroup's half) and dhn of the chunk's 64 columns
    float acc0[32], acc1[32], dhn[32];
    const uint64_t hsel = PAIR ? wg * kHalf : 0;
    for (int k = 0; k < kt; ++k, ++it) {
      unsigned char* w = wait_full();
      const uint64_t ad = ydesc + k * kTileStep, od = odesc + k * kTileStep;
      const uint64_t bd = wgmma_desc(w, 16, 1024) + hsel;
      const uint64_t wd = wgmma_desc(w + 2 * kFcTileBytes, 1024, 1024);
      fence_regs(acc0);
      if constexpr (!PAIR) fence_regs(acc1);
      fence_regs(dhn);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_ss(acc0, ad + 2 * kk, bd + 2 * kk, (k | kk) != 0);
      if constexpr (!PAIR) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n64k16_ss(acc1, ad + 2 * kk, bd + kHalf + 2 * kk, (k | kk) != 0);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_ss_bt(dhn, od + 2 * kk, wd + 128 * kk, (k | kk) != 0);
      wgmma_commit();
      if (k > 0) {
        wgmma_wait<1>();
        fence_regs(acc0);
        if constexpr (!PAIR) fence_regs(acc1);
        fence_regs(dhn);
        release(it - 1);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc0);
    if constexpr (!PAIR) fence_regs(acc1);
    fence_regs(dhn);
    release(it - 1);

    if constexpr (STATS) {
      auto sums = [&](const float (&acc)[32], int h) {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int col = (j - j0) * 64 + h * 32 + (i / 4) * 8 + (lane % 4) * 2 + i % 2;
          const float v = acc[i] + sbv[col], g = acc[i + 16] + sbg[col];
          const float sv = __fdividef(v * g, 1.f + __expf(-g));
          if (i & 2) {
            ss1 += sv * sv;
            sd1 += dhn[16 * h + i] * sv;
          } else {
            ss0 += sv * sv;
            sd0 += dhn[16 * h + i] * sv;
          }
        }
      };
      sums(acc0, 0);
      sums(acc1, 1);
    } else if constexpr (PAIR) {
      uint32_t pk[16];
      gate(acc0, dhn, pk, wg);
      colsum_half(pk, wg);
      colsum_write();
      // this half of dvg into xch[wg], K-major and swizzled as a TMA tile,
      // once the other warpgroup's products of the last chunk have read it
      fc_consumers_sync<2>();
      unsigned char* mine = xch + (size_t)wg * kFcTileBytes;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = jj * 8 + (lane % 4) * 2;
        *reinterpret_cast<uint32_t*>(mine + swizzle128(r0, col)) = pk[2 * jj];
        *reinterpret_cast<uint32_t*>(mine + swizzle128(r0 + 8, col)) = pk[2 * jj + 1];
      }
      fence_proxy_async();
      fc_consumers_sync<2>();
      // the dY stages in the producer's order, warpgroup 0's and 1's in
      // turn; each takes its own (its half of dvg from registers, the
      // other's from xch) and passes the other's on. A warpgroup holds one
      // stage at a time: at C 512 the ring has three, and a warpgroup
      // holding two (its product left running) would leave the producer
      // none to fill ahead (1.1346 against 0.9665 ms at B128 L152 C512 on
      // an H100 80GB HBM3 at 700 W)
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        if (i >= half) break;
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          if (w * half + i >= kt) continue;
          unsigned char* wt = wait_full();
          if (w == wg) {
            const uint64_t bo = wgmma_desc(wt, 1024, 1024) + wg * kHalf;
            const uint64_t bx = wgmma_desc(wt, 1024, 1024) + (1 - wg) * kHalf;
            fence_regs(pk);
            fence_regs(dy[i]);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const uint32_t a0[4] = {pk[4 * kk], pk[4 * kk + 1], pk[4 * kk + 2], pk[4 * kk + 3]};
              wgmma_m64n64k16_rs_bt(dy[i], a0, bo + 128 * kk, 1);
            }
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_ss_bt(dy[i], xdesc + 2 * kk, bx + 128 * kk, 1);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(pk);
            fence_regs(dy[i]);
          }
          release(it);
          ++it;
        }
      }
    } else {
      uint32_t pk0[16], pk1[16];
      gate(acc0, dhn, pk0, 0);
      gate(acc1, dhn, pk1, 1);
      // both halves' products into each dY tile, one stage a tile
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        if (q >= nqy) break;
        unsigned char* w = wait_full();
        ++it;
        const uint64_t b0 = wgmma_desc(w, 1024, 1024), b1 = b0 + kHalf;
        fence_regs(pk0);
        fence_regs(pk1);
        fence_regs(dy[q]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t a0[4] = {pk0[4 * kk], pk0[4 * kk + 1], pk0[4 * kk + 2], pk0[4 * kk + 3]};
          wgmma_m64n64k16_rs_bt(dy[q], a0, b0 + 128 * kk, 1);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t a1[4] = {pk1[4 * kk], pk1[4 * kk + 1], pk1[4 * kk + 2], pk1[4 * kk + 3]};
          wgmma_m64n64k16_rs_bt(dy[q], a1, b1 + 128 * kk, 1);
        }
        wgmma_commit();
      }
      if (lead) {
        colsum_half(pk0, 0);
        colsum_half(pk1, 1);
        colsum_write();
      }
      wgmma_wait<0>();
      fence_regs(pk0);
      fence_regs(pk1);
#pragma unroll
      for (int q = 0; q < NQ; ++q) fence_regs(dy[q]);
#pragma unroll
      for (int q = 0; q < NQ; ++q)
        if (q < nqy) release(it - nqy + q);
    }
  }

  if constexpr (STATS) {
    // the rows' sums over this slice: the quad of a row, in a fixed order
    ss0 = fc_quad_sum(ss0);
    ss1 = fc_quad_sum(ss1);
    sd0 = fc_quad_sum(sd0);
    sd1 = fc_quad_sum(sd1);
    if (lane % 4 == 0) {
      if (gr0 < a.BL) {
        a.ss[(size_t)s * a.BL + gr0] = ss0;
        a.ss[((size_t)a.SA + s) * a.BL + gr0] = sd0;
      }
      if (gr1 < a.BL) {
        a.ss[(size_t)s * a.BL + gr1] = ss1;
        a.ss[((size_t)a.SA + s) * a.BL + gr1] = sd1;
      }
    }
    return;
  }
  // this hidden slice's dY of the warpgroup's columns
  float* dst = a.dy + (size_t)s * a.BL * C;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    if (q >= nq) break;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = (q0 + q) * 64 + jj * 8 + (lane % 4) * 2;
      if (col >= C) continue;
      if (gr0 < a.BL)
        *reinterpret_cast<float2*>(dst + (size_t)gr0 * C + col) = make_float2(dy[q][4 * jj], dy[q][4 * jj + 1]);
      if (gr1 < a.BL)
        *reinterpret_cast<float2*>(dst + (size_t)gr1 * C + col) =
            make_float2(dy[q][4 * jj + 2], dy[q][4 * jj + 3]);
    }
  }
}

// ---- the finish: transposed conv, K3's FiLM and pre-norm backward ----

// K6's y: the depthwise conv of x over the flat rows, in the forward
// core's arithmetic (bf16 pairs, each step rounded; a tap across a batch
// row selects zero), 8 columns a thread
static __global__ void __launch_bounds__(256) bwd_conv_kernel(const BwdArgs a) {
  const int C = a.C, r = a.K / 2, c8 = C / 8;
  for (size_t idx = (size_t)blockIdx.x * 256 + threadIdx.x; idx < (size_t)a.BL * c8;
       idx += (size_t)gridDim.x * 256) {
    const size_t g = idx / c8;
    const int col = (int)(idx % c8) * 8, pos = (int)(g % a.L);
    __nv_bfloat162 acc[4];
    for (int k = 0; k < a.K; ++k) {
      uint4 xv = make_uint4(0u, 0u, 0u, 0u);
      if (pos + k - r >= 0 && pos + k - r < a.L)
        xv = *reinterpret_cast<const uint4*>(a.x + (g + k - r) * C + col);
      const uint4 wv = *reinterpret_cast<const uint4*>(a.dww + (size_t)k * C + col);
      const __nv_bfloat162* xh = reinterpret_cast<const __nv_bfloat162*>(&xv);
      const __nv_bfloat162* wh = reinterpret_cast<const __nv_bfloat162*>(&wv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 m = __hmul2(xh[i], wh[i]);
        acc[i] = k == 0 ? m : __hadd2(acc[i], m);
      }
    }
    const uint4 bv = *reinterpret_cast<const uint4*>(a.dwb + col);
    const __nv_bfloat162* bh = reinterpret_cast<const __nv_bfloat162*>(&bv);
    uint4 out;
    __nv_bfloat162* oh = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
    for (int i = 0; i < 4; ++i) oh[i] = __hadd2(acc[i], bh[i]);
    *reinterpret_cast<uint4*>(a.y + g * C + col) = out;
  }
}

// slots of fin: K3 dshift, dscale, dg1, d dw_bias, the conv taps (4 + K);
// K6 d dw_bias, d out_bias (the output gradient's column sums), the conv
// taps (2 + K)

// K3's finish, shared memory: the dY and x windows (rows + 2r, C), dh1 of
// the rows, the per-column constants, 1 / rms(x) of the window, mean(dxn x)
// of the rows, the column partials of the thread groups; f32 (K6's finish
// keeps its windows in registers)
__host__ __device__ inline size_t finish_smem(int C, int K, int rows) {
  const int E = rows + 2 * (K / 2), groups = C < 256 ? 256 / C : 1;
  return ((size_t)2 * E * C + (size_t)rows * C + (size_t)(4 + K) * C + E + rows +
          (size_t)groups * (4 + K) * C) * sizeof(float);
}

// K3's finish: one CTA a window of `frows` rows of one batch row; the
// element-wise phases over all 256 threads from shared memory, the row
// reductions one warp a row
template <int K>
__global__ void __launch_bounds__(256) bwd_finish_film_kernel(const BwdArgs a) {
  extern __shared__ float fsm[];
  constexpr int r = K / 2, kSlots = 4 + K;
  const int C = a.C, R = a.frows, E = R + 2 * r;
  const int b = blockIdx.y, t0 = blockIdx.x * R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int T = a.L - t0 < R ? a.L - t0 : R;  // the CTA's rows
  const size_t base = (size_t)b * a.L;
  float* dys = fsm;                        // (E, C) dY at positions t0 - r + e
  float* xs = dys + (size_t)E * C;         // (E, C) x there
  float* dh1 = xs + (size_t)E * C;         // (R, C)
  float* cst = dh1 + (size_t)R * C;        // (4 + K, C) a1 = g1 (1 + scale), shift, g1, 1 + scale, taps
  float* n1s = cst + (size_t)kSlots * C;   // (E) 1 / rms(x), 0 outside [0, L)
  float* mrow = n1s + E;                   // (R) mean(dxn x)
  float* red = mrow + R;                   // (groups, 4 + K, C)

  for (int c = threadIdx.x; c < C; c += 256) {
    const float g1 = ldf(a.g1 + c), s1 = 1.f + ldf(a.scale + (size_t)b * C + c);
    cst[c] = g1 * s1;
    cst[C + c] = ldf(a.shift + (size_t)b * C + c);
    cst[2 * C + c] = g1;
    cst[3 * C + c] = s1;
#pragma unroll
    for (int k = 0; k < K; ++k) cst[(4 + k) * C + c] = ldf(a.dww + k * C + c);
  }
  // dY (summed over the hidden slices in order) and x of the window, zero
  // outside [0, L)
  for (int idx = threadIdx.x; idx < E * (C / 4); idx += 256) {
    const int e = idx / (C / 4), c = (idx % (C / 4)) * 4, pos = t0 - r + e;
    float4 d = make_float4(0.f, 0.f, 0.f, 0.f);
    if (pos >= 0 && pos < a.L)
      for (int s = 0; s < a.SB; ++s) {
        const float4 v = *reinterpret_cast<const float4*>(a.dy + ((size_t)s * a.BL + base + pos) * C + c);
        d.x += v.x;
        d.y += v.y;
        d.z += v.z;
        d.w += v.w;
      }
    *reinterpret_cast<float4*>(dys + (size_t)e * C + c) = d;
  }
  for (int idx = threadIdx.x; idx < E * (C / 8); idx += 256) {
    const int e = idx / (C / 8), c = (idx % (C / 8)) * 8, pos = t0 - r + e;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (pos >= 0 && pos < a.L) v = *reinterpret_cast<const uint4*>(a.x + (base + pos) * C + c);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float2*>(xs + (size_t)e * C + c + 2 * i) = __bfloat1622float2(h[i]);
  }
  __syncthreads();
  for (int e = warp; e < E; e += 8) {
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += xs[(size_t)e * C + c] * xs[(size_t)e * C + c];
    s = warp_sum(s);
    const int pos = t0 - r + e;
    if (lane == 0) n1s[e] = pos >= 0 && pos < a.L ? rsqrtf(s / C + kFcEps) : 0.f;
  }
  // dh1 = the transposed conv of dY
  for (int idx = threadIdx.x; idx < T * C; idx += 256) {
    const int i = idx / C, c = idx % C;
    float d = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) d += dys[(size_t)(i + 2 * r - k) * C + c] * cst[(4 + k) * C + c];
    dh1[idx] = d;
  }
  __syncthreads();
  // the pre-norm's row reduction mean(dxn x), dxn = dh1 g1 (1 + scale)
  for (int i = warp; i < T; i += 8) {
    float sm = 0.f;
    for (int c = lane; c < C; c += 32) sm += dh1[(size_t)i * C + c] * cst[c] * xs[(size_t)(i + r) * C + c];
    sm = warp_sum(sm);
    if (lane == 0) mrow[i] = sm / C;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < T * C; idx += 256) {
    const int i = idx / C, c = idx % C;
    const float n1 = n1s[i + r], xv = xs[(size_t)(i + r) * C + c];
    const size_t p = (base + t0 + i) * C + c;
    a.dx[p] = __float2bfloat16(ldf(a.go + p) + n1 * dh1[idx] * cst[c] - n1 * n1 * n1 * xv * mrow[i]);
  }

  // the column partials: `groups` groups of threads a column, group g over
  // rows g, g + groups, ..; the groups summed in order
  const int groups = C < 256 ? 256 / C : 1, width = C < 256 ? C : 256;
  const int g = threadIdx.x / width;
  for (int c = threadIdx.x % width; g < groups && c < C; c += 256) {
    float tap[K], db = 0.f, f0 = 0.f, f1 = 0.f, f2 = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) tap[k] = 0.f;
    const float a1 = cst[c], sh = cst[C + c], g1 = cst[2 * C + c], s1 = cst[3 * C + c];
    for (int i = g; i < T; i += groups) {
      const float d = dys[(size_t)(i + r) * C + c], dh = dh1[(size_t)i * C + c];
      const float xn = xs[(size_t)(i + r) * C + c] * n1s[i + r];
      db += d;
      f0 += dh;             // dshift
      f1 += dh * xn * g1;   // dscale
      f2 += dh * xn * s1;   // dg1
#pragma unroll
      for (int k = 0; k < K; ++k) {
        // h1 at window row i + k (K2's rounding), zero outside [0, L)
        const float n = n1s[i + k];
        const float h1 = n > 0.f ? bfr(bfr(xs[(size_t)(i + k) * C + c] * n * a1) + sh) : 0.f;
        tap[k] += d * h1;
      }
    }
    float* mine = red + (size_t)g * kSlots * C + c;
    mine[0] = f0;
    mine[C] = f1;
    mine[2 * C] = f2;
    mine[3 * C] = db;
#pragma unroll
    for (int k = 0; k < K; ++k) mine[(4 + k) * C] = tap[k];
  }
  __syncthreads();
  float* out = a.fin + ((size_t)b * gridDim.x + blockIdx.x) * kSlots * C;
  for (int idx = threadIdx.x; idx < kSlots * C; idx += 256) {
    float sum = 0.f;
    for (int q = 0; q < groups; ++q) sum += red[(size_t)q * kSlots * C + idx];
    out[idx] = sum;
  }
}

// K6's finish: one thread two columns over a window of `frows` rows of one
// batch row, the dY and x rows the transposed conv and the taps need in
// register windows (each row read once); no shared memory
template <int K>
__global__ void __launch_bounds__(256) bwd_finish_plain_kernel(const BwdArgs a) {
  constexpr int r = K / 2, kSlots = 2 + K;
  const int C = a.C, R = a.frows, b = blockIdx.y, t0 = blockIdx.x * R;
  const int c = blockIdx.z * 512 + 2 * threadIdx.x;
  if (c >= C) return;
  const int T = a.L - t0 < R ? a.L - t0 : R;
  const size_t base = (size_t)b * a.L;
  float2 w[K], dwin[K], xwin[K], tap[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    w[k] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.dww + k * C + c));
    dwin[k] = xwin[k] = tap[k] = make_float2(0.f, 0.f);
  }
  float2 db = make_float2(0.f, 0.f), dbo = make_float2(0.f, 0.f);
  // the newest row q enters the windows: dwin[j], xwin[j] hold row q - (K - 1) + j;
  // the centre row p = q - r is finished once q reaches t0 + r
  for (int q = t0 - r; q < t0 + T + r; ++q) {
#pragma unroll
    for (int k = 0; k + 1 < K; ++k) {
      dwin[k] = dwin[k + 1];
      xwin[k] = xwin[k + 1];
    }
    float2 d = make_float2(0.f, 0.f), xv = make_float2(0.f, 0.f);
    if (q >= 0 && q < a.L) {
      for (int s = 0; s < a.SB; ++s) {
        const float2 v = *reinterpret_cast<const float2*>(a.dy + ((size_t)s * a.BL + base + q) * C + c);
        d.x += v.x;
        d.y += v.y;
      }
      xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.x + (base + q) * C + c));
    }
    dwin[K - 1] = d;
    xwin[K - 1] = xv;
    const int p = q - r;
    if (p < t0) continue;
    // dx[p] = sum_k dY[p - k + r] w_k; the taps pair dY[p] with x[p + k - r]
    float2 dx = make_float2(0.f, 0.f);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      dx.x += dwin[K - 1 - k].x * w[k].x;
      dx.y += dwin[K - 1 - k].y * w[k].y;
    }
    *reinterpret_cast<__nv_bfloat162*>(a.dx + (base + p) * C + c) = __floats2bfloat162_rn(dx.x, dx.y);
    const float2 dc = dwin[K - 1 - r];
    db.x += dc.x;
    db.y += dc.y;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      tap[k].x += dc.x * xwin[k].x;
      tap[k].y += dc.y * xwin[k].y;
    }
    const float2 gv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.go + (base + p) * C + c));
    dbo.x += gv.x;
    dbo.y += gv.y;
  }
  float* out = a.fin + ((size_t)b * gridDim.x + blockIdx.x) * kSlots * C + c;
  *reinterpret_cast<float2*>(out) = db;
  *reinterpret_cast<float2*>(out + C) = dbo;
#pragma unroll
  for (int k = 0; k < K; ++k) *reinterpret_cast<float2*>(out + (2 + k) * C) = tap[k];
}

// Launch the backward on `stream`: pass A (K3: the forward core; K6: the
// conv and pass B's kernel in its statistics mode), the row statistics,
// pass B, the finish, those of `phases`. wmaps: the pack's two weight tensor
// maps. With a.ws set K6 reads the forward's residuals in place of its
// statistics pass (the TP form).
template <bool FILM>
int ffn_backward(BwdArgs a, const void* wmaps, cudaStream_t stream, int phases = kBwdAll) {
  const int r = a.K / 2, nch = a.Hp / 64;
  // pass B pairs two warpgroups on a row tile past C 384 to 512 (the plan
  // then gives one row warpgroup a CTA)
  const bool pair = a.C > kBpFrom && a.C <= kBpCols;
  if (a.K % 2 == 0 || a.K > kBfMaxK || r > kFcMaxRadius || a.C % 32 || a.C > 32 * kBmMaxCQ ||
      a.Hp % 64 || a.Hp < a.H || a.H < 1 || a.BL != a.B * a.L || a.BL < 1 || a.SA < 1 ||
      a.SA > nch || a.SB < 1 || a.SB > nch || a.nwg < 1 || a.nwg > 2 || a.frows < 1 ||
      (pair && a.nwg != 1) || (FILM && finish_smem(a.C, a.K, a.frows) > kMaxSmem) ||
      a.Hm < 0 || phases < 1 || phases > kBwdAll)
    return (int)cudaErrorInvalidValue;
  const bool stats = !FILM && a.ws == nullptr;  // K6's statistics pass
  const int nloc_a = (nch + a.SA - 1) / a.SA, nloc_b = (nch + a.SB - 1) / a.SB;
  const int nst_a = bwd_stages(a.C, a.nwg, 0, nloc_a), nst = bwd_stages(a.C, a.nwg, pair, nloc_b);
  if (((phases & kBwdPassB) && nst < 2) || ((phases & kBwdPassA) && stats && nst_a < 2))
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  memcpy(&maps[2], wmaps, 2 * sizeof(CUtensorMap));
  cudaError_t e = hopper::tma_map_bf16_3d(&maps[0], a.y, a.C, a.BL, 1, 64, 64);
  if (e == cudaSuccess)
    e = hopper::tma_map_bf16_3d(&maps[1], FILM ? (const void*)a.dout : (const void*)a.go, a.C, a.BL,
                                1, 64, 64);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (a.BL + 64 * a.nwg - 1) / (64 * a.nwg), sms = device_sms();
  auto grad = [&](auto stats, auto paired, dim3 grid, int stages) {
    constexpr bool S = decltype(stats)::value, P = decltype(paired)::value;
    const size_t smem = BgLayout(a.C, a.nwg, P, S ? nloc_a : nloc_b, stages).total;
    if constexpr (P)
      return launch(ffn_bwd_grad_kernel<2, false, true>, grid, dim3(384), smem, stream, maps[0],
                    maps[1], maps[2], maps[3], a, stages);
    else
      return a.nwg == 2 ? launch(ffn_bwd_grad_kernel<2, S, false>, grid, dim3(384), smem, stream,
                                 maps[0], maps[1], maps[2], maps[3], a, stages)
                        : launch(ffn_bwd_grad_kernel<1, S, false>, grid, dim3(256), smem, stream,
                                 maps[0], maps[1], maps[2], maps[3], a, stages);
  };
  if (phases & kBwdPassA) {
    if constexpr (FILM) {
      // pass A: s W_out and the sums of squares, y stored
      FfnArgs f{};
      f.x = a.x;
      f.dww = a.dww;
      f.dwb = a.dwb;
      f.bvg = a.bvg;
      f.scale = a.scale;
      f.shift = a.shift;
      f.gate = a.gate;
      f.g1 = a.g1;
      f.g2 = a.g2;
      f.ws = a.ws;
      f.ss = a.ss;
      f.BL = a.BL;
      f.L = a.L;
      f.C = a.C;
      f.H = a.H;
      f.Hp = a.Hp;
      f.K = a.K;
      f.S = a.SA;
      f.nwg = a.nwg;
      f.ystore = 1;
      const int err = ffn_forward<true>(f, wmaps, a.y, 128, stream);
      if (err != 0) return err;
    } else {
      // y, then pass A: the sums of s^2 and dhn s
      const size_t n8 = (size_t)a.BL * (a.C / 8);
      const size_t blocks = (n8 + 255) / 256 < (size_t)sms * 8 ? (n8 + 255) / 256 : (size_t)sms * 8;
      bwd_conv_kernel<<<(unsigned)blocks, 256, 0, stream>>>(a);
      e = cudaGetLastError();
      if (e == cudaSuccess && stats)
        e = grad(std::true_type{}, std::false_type{}, dim3(tiles, 1, a.SA), nst_a);
      if (e != cudaSuccess) return (int)e;
    }
  }
  if (phases & kBwdRows) {
    // the row statistics (K3 at its five widths)
    const dim3 rgrid((a.L + kBmRows - 1) / kBmRows, a.B);
#define ODT_MID(n) \
    case n: bwd_mid_kernel<FILM, n><<<rgrid, 256, 0, stream>>>(a); break;
    if constexpr (FILM) {
      switch (a.C / 32) {
        ODT_MID(1) ODT_MID(2) ODT_MID(4) ODT_MID(8) ODT_MID(12)
        default: return (int)cudaErrorInvalidValue;
      }
    } else {
      switch (a.C / 32) {
        ODT_MID(1) ODT_MID(2) ODT_MID(3) ODT_MID(4) ODT_MID(5) ODT_MID(6) ODT_MID(7) ODT_MID(8)
        ODT_MID(9) ODT_MID(10) ODT_MID(11) ODT_MID(12) ODT_MID(13) ODT_MID(14) ODT_MID(15)
        ODT_MID(16) ODT_MID(17) ODT_MID(18) ODT_MID(19) ODT_MID(20)
        default: return (int)cudaErrorInvalidValue;
      }
    }
#undef ODT_MID
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  // pass B
  if (phases & kBwdPassB) {
    if (pair)
      e = grad(std::false_type{}, std::true_type{}, dim3(tiles, 1, a.SB), nst);
    else
      e = grad(std::false_type{}, std::false_type{}, dim3(tiles, (a.C + kBgCols - 1) / kBgCols, a.SB),
               nst);
    if (e != cudaSuccess) return (int)e;
  }
  if (!(phases & kBwdFinish)) return 0;
  // the finish
  const dim3 fgrid((a.L + a.frows - 1) / a.frows, a.B, FILM ? 1 : (a.C + 511) / 512);
  auto fin = [&](auto taps) {
    constexpr int K = decltype(taps)::value;
    if constexpr (FILM)
      return (int)launch(bwd_finish_film_kernel<K>, fgrid, dim3(256), finish_smem(a.C, K, a.frows),
                         stream, a);
    else
      return (int)launch(bwd_finish_plain_kernel<K>, fgrid, dim3(256), 0, stream, a);
  };
  switch (a.K) {
    case 1: return fin(std::integral_constant<int, 1>{});
    case 3: return fin(std::integral_constant<int, 3>{});
    case 5: return fin(std::integral_constant<int, 5>{});
    case 7: return fin(std::integral_constant<int, 7>{});
    case 9: return fin(std::integral_constant<int, 9>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace odt
