// SwiGLU conv-FFN backward for Hopper: the partial backward (K6) and the
// full backward (K5), one row kernel for both.
//
// K6 replaces the Pallas TPU kernel osu_dreamer_tpu/ops/swiglu.py
// `_partial_bwd_kernel` (launched by `_fused_swiglu_partial_bwd_impl`,
// swiglu.py:492). On the main path it is the backward of the denoiser FFN in
// training: x and the output gradient bf16 (128, 152, 512), H = 1365 (padded
// to 1376), K = 5, 8 layers per step.
//
// K5 (odt_swiglu_bwd_full) replaces `_bwd_kernel` (launched by
// `_fused_swiglu_bwd_impl`, swiglu.py:313), the backward that keeps every
// weight gradient in on-chip accumulators and that the JAX dispatch takes
// wherever its footprint fits (`bwd_kernel_feasible`: a denoiser of width
// 384 or less, e.g. C 384, H 1024). Blocks on Hopper run in no order and the
// gradients must repeat bit for bit, so K5 is K6's row pass in a second mode
// followed, in the same call, by the two weight products on the tensor cores
// (csrc/gemm_tn.cuh, split-K, summed in index order): the row kernel writes
// y, hn and the output gradient of its core rows (zero on the halo and past
// L) into block-major bf16 scratch whose rows line up with the per-block dvg
// scratch it writes anyway, so dW_vg = y^T dvg and dW_out = hn^T go run over
// blocks x 80 rows (a multiple of 16) with H padded to 16; the small
// gradients' per-block partials are summed by the same fixed-order kernel.
// Bound at B128 L152 C384 H1024: 122.4 GFLOP of products against 45 MB in
// and out, so compute (124 us at the bf16 tensor-core peak).
//
// The rest of this note is the row pass both share.
//
// Per block of core rows (with a conv halo of r rows on each side) it
// recomputes the depthwise conv y (bf16, the forward's rounding), then
// vg = y W_vg + b (f32), s = v silu(g) and its RMS over H (f32), and goes
// back: dhn = go W_out^T, ds = n dhn - n^3 s mean(dhn s),
// dv = ds silu(g), dg = ds v silu'(g), dY = [dv|dg] W_vg^T, and the
// transposed conv dx = sum_k dY[. - k + r] w_k. It writes dx, and dvg, hn and
// y for the two big weight products dW_vg = y^T dvg and dW_out = hn^T go,
// which stay torch matmuls over all B*L rows, as the JAX package leaves
// them to XLA (swiglu.py:540-543). The small gradients (conv taps, conv
// bias, vg bias, out bias) leave as one f32 partial per block, summed by the
// wrapper in a fixed order, so the result is deterministic.
//
// What bounds it on the H100: per row, three (C x H) products (vg, dhn, dY:
// 6.3 MFLOP at C = 512), on the tensor cores, and the weights (W_vg 2.8 MB,
// W_out 1.4 MB, bf16) that every block reads from L2. The (rows, 2H) hidden
// activations never fit shared memory (80 x 2752 f32 would be 880 KB), so the
// design makes two passes over 16-wide column tiles of H: pass 1 recomputes
// v, g and dhn and keeps only the two row sums of the RMS backward; pass 2
// recomputes them again and writes dvg, tile by tile, to a per-block scratch
// in global memory (it stays in L2); a third phase reads it back for
// dY = dvg W_vg^T, each warp owning 64 columns of dY in registers, and
// finishes its columns (dx, the conv-tap and bias partials) itself. W_vg is
// read three times per block and W_out twice, so a block takes as many rows
// as shared memory allows: 80 (76 core rows at r = 2, two blocks per 152-row
// sequence); only y, the output gradient rows and small per-warp tiles live
// there (about 213 KB at C = 512; x is read from L2 for the conv). Past C
// 512 (K6 at C 640, where the JAX partial backward still fits) a block takes
// 48 rows and a warp 80 columns of dY (SbWide). The
// weight fragments stream from L2 straight into registers, the next
// k-step's in flight while this one's products run. A first design on
// wmma/mma.sync; staging the weights in shared memory (TMA, wgmma) is later
// work.
#include "ffn_tile.cuh"
#include "gemm_tn.cuh"

namespace odt {

constexpr int kSbWarps = kFfnWarps;  // 8
constexpr int kSbMaxK = 9;

// the kernel's shape: E extended rows per block (core rows + 2r halo) and
// CT dY column tiles per warp (C <= 16 * 8 * CT). 80 rows up to C 512; at C
// 640 (K6 only) 48 rows, so that the two row buffers fit shared memory and
// the 5 x 3 dY fragments a warp's registers
template <int E, int CT>
struct SbShape {
  static constexpr int kE = E;
  static constexpr int kRT = E / 16;                          // row fragments
  static constexpr int kCT = CT;
  static constexpr int kScr = (kRT > 3 ? kRT : 3) * 256;      // f32 per warp: 3 tiles, or E x 16
};
using SbNarrow = SbShape<80, 4>;
using SbWide = SbShape<48, 5>;

struct SwigluBwdSmem {
  int lda;
  size_t ys, gos, scratch, stats, rows, total;
  __host__ __device__ SwigluBwdSmem(int C, int E, int scr) {
    lda = C + 8;  // bf16 rows
    ys = 0;
    gos = ys + align128((size_t)E * lda * sizeof(bf16));
    scratch = gos + align128((size_t)E * lda * sizeof(bf16));
    stats = scratch + align128((size_t)kSbWarps * scr * sizeof(float));
    rows = stats + align128((size_t)kSbWarps * E * 2 * sizeof(float));
    total = rows + 2 * E * sizeof(float);
  }
};

template <class Sh>
__global__ void __launch_bounds__(kFfnThreads)
swiglu_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ go,
                  const bf16* __restrict__ dww, const bf16* __restrict__ dwb,
                  const bf16* __restrict__ wvg, const bf16* __restrict__ bvg,
                  const bf16* __restrict__ wout, bf16* __restrict__ dx, bf16* __restrict__ dvg,
                  bf16* __restrict__ hn, bf16* __restrict__ y, float* __restrict__ ddw_part,
                  float* __restrict__ ddwb_part, float* __restrict__ dbvg_part,
                  float* __restrict__ dbout_part, bf16* __restrict__ dvg_scratch,
                  bf16* __restrict__ y_s, bf16* __restrict__ hn_s, bf16* __restrict__ go_s, int L,
                  int C, int H, int Hp, int K) {
  // K5 passes y_s, hn_s and go_s (block-major, kSbE rows a block) instead of
  // dvg, hn and y
  const bool full = y_s != nullptr;
  constexpr int kSbE = Sh::kE, kSbRT = Sh::kRT, kSbCT = Sh::kCT, kSbScr = Sh::kScr;
  extern __shared__ __align__(128) unsigned char smem[];
  const SwigluBwdSmem lay(C, kSbE, kSbScr);
  const int lda = lay.lda;
  bf16* ys = reinterpret_cast<bf16*>(smem + lay.ys);
  bf16* gos = reinterpret_cast<bf16*>(smem + lay.gos);
  float* stats = reinterpret_cast<float*>(smem + lay.stats);
  float* rown = reinterpret_cast<float*>(smem + lay.rows);
  float* rowm = rown + kSbE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* scr = reinterpret_cast<float*>(smem + lay.scratch) + warp * kSbScr;

  const int r = K / 2, T = kSbE - 2 * r;
  const int t0 = blockIdx.x * T, b = blockIdx.y;
  const int blk = b * gridDim.x + blockIdx.x;
  const int nTiles = Hp / 16, ldd = 2 * Hp;
  bf16* dvs = dvg_scratch + (size_t)blk * kSbE * ldd;  // this block's (kSbE, 2Hp) dvg
  // extended row e is position t0 - r + e (16 bytes a thread; C is a
  // multiple of 32)
  const int cv = C / 8;
  for (int idx = threadIdx.x; idx < kSbE * cv; idx += blockDim.x) {
    const int e = idx / cv, c = (idx % cv) * 8, pos = t0 - r + e;
    int4 v = make_int4(0, 0, 0, 0);
    if (pos >= 0 && pos < L) v = *reinterpret_cast<const int4*>(go + ((size_t)b * L + pos) * C + c);
    *reinterpret_cast<int4*>(gos + e * lda + c) = v;
  }
  // y, the depthwise conv of x (zero outside [0, L)) read from L2, in the
  // plain version's order: ((x0*w0 + x1*w1) + ...) + bias, each op rounded
  // to bf16 as csrc/ffn_tile.cuh ffn_dwconv rounds it
  for (int idx = threadIdx.x; idx < kSbE * C; idx += blockDim.x) {
    const int e = idx / C, c = idx % C, p0 = t0 - 2 * r + e;
    const bf16* xc = x + (size_t)b * L * C + c;
    float acc = 0.f;
    for (int k = 0; k < K; ++k) {
      const int p = p0 + k;
      const float xv = (p >= 0 && p < L) ? ldf(xc + (size_t)p * C) : 0.f;
      const float prod = bfr(xv * ldf(dww + k * C + c));
      acc = k == 0 ? prod : bfr(acc + prod);
    }
    ys[e * lda + c] = __float2bfloat16(acc + ldf(dwb + c));
  }
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> fv[kSbRT], fg[kSbRT], fd[kSbRT];
  const int er = lane >> 1, ec = (lane & 1) * 8;  // pass 1: a lane pair per row

  // ---- pass 1: per-row sums of s^2 and dhn * s over H
  float sq[kSbRT] = {}, dot[kSbRT] = {};
  for (int j = warp; j < nTiles; j += kSbWarps) {
    ffn_hidden_tile<kSbRT>(ys, gos, lda, wvg, wout, C, Hp, j, fv, fg, fd);
#pragma unroll
    for (int i = 0; i < kSbRT; ++i) {
      wmma::store_matrix_sync(scr, fv[i], 16, wmma::mem_row_major);
      wmma::store_matrix_sync(scr + 256, fg[i], 16, wmma::mem_row_major);
      wmma::store_matrix_sync(scr + 512, fd[i], 16, wmma::mem_row_major);
      __syncwarp();
      float s2 = 0.f, sd = 0.f;
      for (int q = 0; q < 8; ++q) {
        const int e = er * 16 + ec + q, col = j * 16 + ec + q;
        const float v = scr[e] + ldf(bvg + col), gg = scr[256 + e] + ldf(bvg + Hp + col);
        const float s = v * (gg / (1.f + expf(-gg)));
        s2 += s * s;
        sd += scr[512 + e] * s;
      }
      sq[i] += s2 + __shfl_xor_sync(0xffffffffu, s2, 1);
      dot[i] += sd + __shfl_xor_sync(0xffffffffu, sd, 1);
      __syncwarp();
    }
  }
  if ((lane & 1) == 0) {
#pragma unroll
    for (int i = 0; i < kSbRT; ++i) {
      stats[(warp * kSbE + i * 16 + er) * 2] = sq[i];
      stats[(warp * kSbE + i * 16 + er) * 2 + 1] = dot[i];
    }
  }
  __syncthreads();
  if (threadIdx.x < kSbE) {
    float s2 = 0.f, sd = 0.f;
    for (int w = 0; w < kSbWarps; ++w) {
      s2 += stats[(w * kSbE + threadIdx.x) * 2];
      sd += stats[(w * kSbE + threadIdx.x) * 2 + 1];
    }
    rown[threadIdx.x] = 1.f / sqrtf(s2 / H + 1e-6f);
    rowm[threadIdx.x] = sd / H;
  }
  __syncthreads();

  // ---- pass 2: dvg tile by tile into the block's scratch (and the outputs)
  for (int j = warp; j < nTiles; j += kSbWarps) {
    ffn_hidden_tile<kSbRT>(ys, gos, lda, wvg, wout, C, Hp, j, fv, fg, fd);
    // lane owns column j*16 + (lane & 15) of both halves; its vg-bias partial
    // sums that column over the core rows it visits
    float sv = 0.f, sg = 0.f;
#pragma unroll
    for (int i = 0; i < kSbRT; ++i) {
      wmma::store_matrix_sync(scr, fv[i], 16, wmma::mem_row_major);
      wmma::store_matrix_sync(scr + 256, fg[i], 16, wmma::mem_row_major);
      wmma::store_matrix_sync(scr + 512, fd[i], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = i * 16 + (e >> 4), c = e & 15, col = j * 16 + c;
        const float v = scr[e] + ldf(bvg + col), gg = scr[256 + e] + ldf(bvg + Hp + col);
        const float sig = 1.f / (1.f + expf(-gg)), sil = gg * sig, s = v * sil;
        const float n = rown[row];
        const float ds = n * scr[512 + e] - n * n * n * s * rowm[row];
        const bf16 dv = __float2bfloat16(ds * sil);
        const bf16 dg = __float2bfloat16(ds * v * (sig * (1.f + gg * (1.f - sig))));
        dvs[row * ldd + col] = dv;
        dvs[row * ldd + Hp + col] = dg;
        const int pos = t0 - r + row;
        const bool core = row >= r && row < r + T && pos < L;
        if (core) {
          sv += __bfloat162float(dv);
          sg += __bfloat162float(dg);
        }
        if (full) {
          hn_s[((size_t)blk * kSbE + row) * Hp + col] = __float2bfloat16(core ? s * n : 0.f);
        } else if (core && col < H) {
          const size_t p = (size_t)b * L + pos;
          hn[p * H + col] = __float2bfloat16(s * n);
          dvg[p * 2 * H + col] = dv;
          dvg[p * 2 * H + H + col] = dg;
        }
      }
      __syncwarp();
    }
    sv += __shfl_xor_sync(0xffffffffu, sv, 16);
    sg += __shfl_xor_sync(0xffffffffu, sg, 16);
    const int c = lane & 15;
    dbvg_part[(size_t)blk * ldd + (lane < 16 ? j * 16 + c : Hp + j * 16 + c)] =
        lane < 16 ? sv : sg;
  }
  if (full) {  // the weight products' left and right operands of the core rows
    const int4 zero = make_int4(0, 0, 0, 0);
    const size_t row0 = (size_t)blk * kSbE;
    for (int idx = threadIdx.x; idx < kSbE * cv; idx += blockDim.x) {
      const int e = idx / cv, c = (idx % cv) * 8;
      const bool keep = e >= r && e < r + T && t0 - r + e < L;
      const size_t o = (row0 + e) * C + c;
      *reinterpret_cast<int4*>(y_s + o) = keep ? *reinterpret_cast<const int4*>(ys + e * lda + c) : zero;
      *reinterpret_cast<int4*>(go_s + o) = keep ? *reinterpret_cast<const int4*>(gos + e * lda + c) : zero;
    }
  }
  __syncthreads();  // the block's dvg scratch is complete (and visible to it)

  // ---- dY = dvg W_vg^T: each warp owns the column tiles warp + 8 ci
  const int nct = C / 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> fy[kSbCT][kSbRT];
#pragma unroll
  for (int ci = 0; ci < kSbCT; ++ci)
#pragma unroll
    for (int i = 0; i < kSbRT; ++i) wmma::fill_fragment(fy[ci][i], 0.f);
  for (int kk = 0; kk < ldd; kk += 16) {
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw[kSbCT];
#pragma unroll
    for (int ci = 0; ci < kSbCT; ++ci) {
      const int ct = warp + ci * kSbWarps;
      if (ct < nct) wmma::load_matrix_sync(bw[ci], wvg + (size_t)ct * 16 * ldd + kk, ldd);
    }
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[kSbRT];
#pragma unroll
    for (int i = 0; i < kSbRT; ++i) wmma::load_matrix_sync(a[i], dvs + i * 16 * ldd + kk, ldd);
#pragma unroll
    for (int ci = 0; ci < kSbCT; ++ci) {
      if (warp + ci * kSbWarps >= nct) break;
#pragma unroll
      for (int i = 0; i < kSbRT; ++i) wmma::mma_sync(fy[ci][i], a[i], bw[ci], fy[ci][i]);
    }
  }

  // ---- per column tile: dx, y, and the small gradients over the core rows.
  // Lane owns column (lane & 15) and every other core row, starting at
  // lane >> 4; the two lanes of a column combine their sums at the end.
#pragma unroll
  for (int ci = 0; ci < kSbCT; ++ci) {
    const int ct = warp + ci * kSbWarps;
    if (ct >= nct) break;
#pragma unroll
    for (int i = 0; i < kSbRT; ++i)
      wmma::store_matrix_sync(scr + i * 256, fy[ci][i], 16, wmma::mem_row_major);
    __syncwarp();
    const int c = ct * 16 + (lane & 15);
    const float* dY = scr + (lane & 15);  // dY[e] of this column is dY[e * 16]
    float tap[kSbMaxK] = {};
    float sw = 0.f, so = 0.f;
    for (int i = lane >> 4; i < T; i += 2) {
      const int e = r + i, pos = t0 + i;
      if (pos >= L) break;
      const size_t p = ((size_t)b * L + pos) * C + c;
      float acc = 0.f;
      for (int k = 0; k < K; ++k) acc += dY[(e + r - k) * 16] * ldf(dww + k * C + c);
      dx[p] = __float2bfloat16(acc);
      if (!full) y[p] = ys[e * lda + c];
      const float d = dY[e * 16];
      sw += d;
      so += ldf(gos + e * lda + c);
      for (int k = 0; k < K; ++k) {
        const int src = pos + k - r;
        if (src >= 0 && src < L) tap[k] += d * ldf(x + ((size_t)b * L + src) * C + c);
      }
    }
    for (int k = 0; k < K; ++k) tap[k] += __shfl_xor_sync(0xffffffffu, tap[k], 16);
    sw += __shfl_xor_sync(0xffffffffu, sw, 16);
    so += __shfl_xor_sync(0xffffffffu, so, 16);
    if (lane < 16) {
      for (int k = 0; k < K; ++k) ddw_part[((size_t)blk * K + k) * C + c] = tap[k];
      ddwb_part[(size_t)blk * C + c] = sw;
      dbout_part[(size_t)blk * C + c] = so;
    }
    __syncwarp();
  }
}

}  // namespace odt

extern "C" int odt_swiglu_bwd(const void* x, const void* go, const void* dww, const void* dwb,
                              const void* wvg, const void* bvg, const void* wout, void* dx,
                              void* dvg, void* hn, void* y, void* ddw_part, void* ddwb_part,
                              void* dbvg_part, void* dbout_part, void* dvg_scratch, int B, int L,
                              int C, int H, int Hp, int K, void* stream) {
  using namespace odt;
  auto go_k6 = [&](auto shape) {
    using Sh = decltype(shape);
    if (K > kSbMaxK || K % 2 == 0 || Sh::kE - 2 * (K / 2) <= 0 || C % 32 ||
        C > 16 * kSbWarps * Sh::kCT || Hp % 16)
      return (int)cudaErrorInvalidValue;
    const SwigluBwdSmem lay(C, Sh::kE, Sh::kScr);
    const int T = Sh::kE - 2 * (K / 2);
    dim3 grid((L + T - 1) / T, B);
    return (int)launch(swiglu_bwd_kernel<Sh>, grid, dim3(kFfnThreads), lay.total,
                       (cudaStream_t)stream, (const bf16*)x, (const bf16*)go, (const bf16*)dww,
                       (const bf16*)dwb, (const bf16*)wvg, (const bf16*)bvg, (const bf16*)wout,
                       (bf16*)dx, (bf16*)dvg, (bf16*)hn, (bf16*)y, (float*)ddw_part,
                       (float*)ddwb_part, (float*)dbvg_part, (float*)dbout_part,
                       (bf16*)dvg_scratch, (bf16*)nullptr, (bf16*)nullptr, (bf16*)nullptr, L, C, H,
                       Hp, K);
  };
  // the rows per block follow C (ops/swiglu.py bwd_rows)
  return C <= 512 ? go_k6(SbNarrow{}) : go_k6(SbWide{});
}

// K5. The row kernel's outputs as K6's, minus dvg/hn/y; the scratch dvg_s
// (R, 2 Hp), y_s, go_s (R, C), hn_s (R, Hp) bf16 with R = blocks x 80; the
// split-K partials pvg (S_vg, C, 2 Hp), pout (S_out, Hp, C) f32. -> dx, the
// per-block partials, and their sums ddw (K, C), ddwb (C), dbvg (2 Hp), dbout
// (C), dwvg (C, 2 Hp), dwout (Hp, C) f32 in the padded layout.
extern "C" int odt_swiglu_bwd_full(const void* x, const void* go, const void* dww, const void* dwb,
                                   const void* wvg, const void* bvg, const void* wout, void* dx,
                                   void* ddw_part, void* ddwb_part, void* dbvg_part,
                                   void* dbout_part, void* dvg_s, void* y_s, void* hn_s,
                                   void* go_s, void* pvg, void* pout, void* ddw, void* ddwb,
                                   void* dbvg, void* dbout, void* dwvg, void* dwout, int B, int L,
                                   int C, int H, int Hp, int K, int S_vg, int S_out,
                                   void* stream) {
  using namespace odt;
  using Sh = SbNarrow;
  if (K > kSbMaxK || K % 2 == 0 || Sh::kE - 2 * (K / 2) <= 0 || C % 32 ||
      C > 16 * kSbWarps * Sh::kCT || Hp % 16 || H > Hp || H < 1)
    return (int)cudaErrorInvalidValue;
  const SwigluBwdSmem lay(C, Sh::kE, Sh::kScr);
  const int T = Sh::kE - 2 * (K / 2);
  dim3 grid((L + T - 1) / T, B);
  const int nblk = grid.x * grid.y, R = nblk * Sh::kE;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = launch(
      swiglu_bwd_kernel<Sh>, grid, dim3(kFfnThreads), lay.total, s, (const bf16*)x, (const bf16*)go,
      (const bf16*)dww, (const bf16*)dwb, (const bf16*)wvg, (const bf16*)bvg, (const bf16*)wout,
      (bf16*)dx, (bf16*)nullptr, (bf16*)nullptr, (bf16*)nullptr, (float*)ddw_part,
      (float*)ddwb_part, (float*)dbvg_part, (float*)dbout_part, (bf16*)dvg_s, (bf16*)y_s,
      (bf16*)hn_s, (bf16*)go_s, L, C, H, Hp, K);
  if (err != cudaSuccess) return (int)err;
  err = gemm_tn_splitk((const bf16*)y_s, C, (const bf16*)dvg_s, 2 * Hp, R, C, 2 * Hp, S_vg,
                       (float*)pvg, (float*)dwvg, s);
  if (err != cudaSuccess) return (int)err;
  err = gemm_tn_splitk((const bf16*)hn_s, Hp, (const bf16*)go_s, C, R, Hp, C, S_out, (float*)pout,
                       (float*)dwout, s);
  if (err != cudaSuccess) return (int)err;
  const struct { const void* part; void* out; size_t n; } sums[] = {
      {ddw_part, ddw, (size_t)K * C}, {ddwb_part, ddwb, (size_t)C},
      {dbvg_part, dbvg, (size_t)2 * Hp}, {dbout_part, dbout, (size_t)C}};
  for (const auto& t : sums) {
    splitk_reduce_kernel<><<<(unsigned)((t.n + 255) / 256), 256, 0, s>>>(
        (const float*)t.part, nblk, t.n, (float*)t.out);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
