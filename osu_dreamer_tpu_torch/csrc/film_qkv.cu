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
// in training and B4 L759 in inference. One block owns 64 rows of ONE batch
// row, so it reads its (1 + scale, shift) row once and its film partial sums
// never mix batch rows; rows past L are neither read as data nor written.
//
// Forward (film_qkv_fwd_kernel). Each warp builds y for its rows (x and add
// read as 16-byte vectors, the f32 mean of squares by a warp reduction, y
// rounded where film_qkv_plain rounds) into shared memory (64 x C bf16, 66 KB
// at C 512), then the block walks its share of F in 128-column tiles: each
// warp owns 16 columns, the W fragments stream from L2 (the next k-step's in
// flight while this one's products run) and multiply the y tile on the tensor
// cores (wmma, bf16 in, f32 accumulate). The product is rounded to bf16 and
// then the bias added in bf16, as the plain version (and flax's Dense) do; the
// Pallas kernel adds the bias in f32 and rounds once, within one ulp of this.
// Short inputs (inference: 48 row tiles) split F over blockIdx.z so that the
// card has about two blocks per SM.
//
// Backward (film_qkv_bwd_kernel, then a split-K product and two reductions).
// The Pallas kernel keeps dW (C x F f32), db and the per-batch-row dscale and
// dshift in accumulators across its ordered grid. Hopper blocks run in no
// order, and the gradients must repeat bit for bit, so there are no float
// atomics: the row kernel recomputes y (written to a bf16 scratch), forms
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
// us). Both are tensor-core work here on mma.sync, with W (3 MB) read from L2
// by every 64-row block; staging W with TMA and wgmma over larger row tiles
// is later work.
#include "gemm_tn.cuh"

namespace odt {

constexpr int kFqRows = 64;                   // rows per block
constexpr int kFqRT = kFqRows / 16;           // row fragments
constexpr int kFqWarps = 8;
constexpr int kFqThreads = kFqWarps * 32;
constexpr int kFqMaxV = 4;                    // 16-byte vectors per lane and row: C <= 1024
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

// One row's y, computed by one warp: lane owns the 8-column vectors lane + 32 j.
// bf16(bf16(bf16(bf16(x inv) bf16(1 + sc)) + sh) + add), inv from the f32 mean
// of squares; -> inv. x values stay in xv for the caller.
template <int MaxV>
__device__ __forceinline__ float fq_row(const bf16* xr, const bf16* ar, const bf16* sc,
                                        const bf16* sh, int C, bf16* yr, float (&xv)[MaxV][8]) {
  const int lane = threadIdx.x & 31, nv = C / 8;
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < MaxV; ++j) {
    const int v = lane + 32 * j;
    if (v >= nv) break;
    const int4 raw = *reinterpret_cast<const int4*>(xr + v * 8);
    const bf16* p = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      xv[j][q] = __bfloat162float(p[q]);
      s += xv[j][q] * xv[j][q];
    }
  }
  const float inv = rsqrtf(warp_sum(s) / C + 1e-6f);
#pragma unroll
  for (int j = 0; j < MaxV; ++j) {
    const int v = lane + 32 * j;
    if (v >= nv) break;
    const int4 ra = *reinterpret_cast<const int4*>(ar + v * 8);
    const int4 rs = *reinterpret_cast<const int4*>(sc + v * 8);
    const int4 rh = *reinterpret_cast<const int4*>(sh + v * 8);
    const bf16 *a = reinterpret_cast<const bf16*>(&ra), *scv = reinterpret_cast<const bf16*>(&rs),
               *shv = reinterpret_cast<const bf16*>(&rh);
    int4 packed;
    bf16* o = reinterpret_cast<bf16*>(&packed);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      float y = bfr(bfr(xv[j][q] * inv) * bfr(1.f + __bfloat162float(scv[q])));
      y = bfr(y + __bfloat162float(shv[q]));
      o[q] = __float2bfloat16(y + __bfloat162float(a[q]));
    }
    *reinterpret_cast<int4*>(yr + v * 8) = packed;
  }
  return inv;
}

// ------------------------------------------------------------- forward ----

struct FqFwdSmem {
  int lda;
  size_t ys, scratch, total;
  __host__ __device__ FqFwdSmem(int C) {
    lda = C + 8;
    ys = 0;
    scratch = align128((size_t)kFqRows * lda * sizeof(bf16));
    total = scratch + (size_t)kFqWarps * kFqRT * 256 * sizeof(float);
  }
};

__global__ void __launch_bounds__(kFqThreads)
film_qkv_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ scale,
                    const bf16* __restrict__ shift, const bf16* __restrict__ add,
                    const bf16* __restrict__ w, const bf16* __restrict__ bias,
                    bf16* __restrict__ out, int L, int C, int F, int cols_per_group) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FqFwdSmem lay(C);
  const int lda = lay.lda;
  bf16* ys = reinterpret_cast<bf16*>(smem + lay.ys);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* scr = reinterpret_cast<float*>(smem + lay.scratch) + warp * kFqRT * 256;
  const int t0 = blockIdx.x * kFqRows, b = blockIdx.y;
  const int rows = min(kFqRows, L - t0), rt = (rows + 15) / 16;

  for (int e = warp; e < kFqRows; e += kFqWarps) {
    bf16* yr = ys + e * lda;
    if (e < rows) {
      const size_t p = (size_t)b * L + t0 + e;
      float xv[kFqMaxV][8];
      fq_row(x + p * C, add + p * C, scale + (size_t)b * C, shift + (size_t)b * C, C, yr, xv);
    } else {
      for (int v = lane; v < C / 8; v += 32)
        *reinterpret_cast<int4*>(yr + v * 8) = make_int4(0, 0, 0, 0);
    }
  }
  __syncthreads();

  const int n_end = min(F, (int)(blockIdx.z + 1) * cols_per_group);
  for (int n0 = blockIdx.z * cols_per_group; n0 < n_end; n0 += 128) {
    const int col = n0 + warp * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFqRT];
#pragma unroll
    for (int i = 0; i < kFqRT; ++i) wmma::fill_fragment(acc[i], 0.f);
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b0, b1;
    auto step = [&](const auto& bw, int k) {
#pragma unroll
      for (int i = 0; i < kFqRT; ++i) {
        if (i >= rt) break;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, ys + i * 16 * lda + k, lda);
        wmma::mma_sync(acc[i], a, bw, acc[i]);
      }
    };
    wmma::load_matrix_sync(b0, w + col, F);
    for (int k = 0; k < C; k += 32) {  // C is a multiple of 64
      wmma::load_matrix_sync(b1, w + (size_t)(k + 16) * F + col, F);
      step(b0, k);
      if (k + 32 < C) wmma::load_matrix_sync(b0, w + (size_t)(k + 32) * F + col, F);
      step(b1, k + 16);
    }
#pragma unroll
    for (int i = 0; i < kFqRT; ++i) {
      if (i >= rt) break;
      wmma::store_matrix_sync(scr + i * 256, acc[i], 16, wmma::mem_row_major);
    }
    __syncwarp();
    // a lane pair per row of each fragment, 8 columns each: one 16-byte store
    const int r = lane >> 1, c0 = (lane & 1) * 8;
    for (int i = 0; i < rt; ++i) {
      const int e = i * 16 + r;
      if (e >= rows) break;
      int4 packed;
      bf16* o = reinterpret_cast<bf16*>(&packed);
#pragma unroll
      for (int q = 0; q < 8; ++q)
        o[q] = __float2bfloat16(bfr(scr[i * 256 + r * 16 + c0 + q]) + ldf(bias + col + c0 + q));
      *reinterpret_cast<int4*>(out + ((size_t)b * L + t0 + e) * F + col + c0) = packed;
    }
    __syncwarp();
  }
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
    float xv[kFqMaxV][8];
    const float inv = fq_row(x + p * C, add + p * C, sc, sh, C, y_s + p * C, xv);
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
// (B, L, F) bf16; blockIdx.z splits F into `groups` column groups.
extern "C" int odt_film_qkv_fwd(const void* x, const void* scale, const void* shift,
                                const void* add, const void* w, const void* bias, void* out,
                                int B, int L, int C, int F, int groups, void* stream) {
  using namespace odt;
  if (B < 1 || L < 1 || C % 64 || C > 8 * 32 * kFqMaxV || F % 128 || groups < 1)
    return (int)cudaErrorInvalidValue;
  const FqFwdSmem lay(C);
  const int cols = (F / 128 + groups - 1) / groups * 128;
  dim3 grid((L + kFqRows - 1) / kFqRows, B, (F + cols - 1) / cols);
  return (int)launch(film_qkv_fwd_kernel, grid, dim3(kFqThreads), lay.total, (cudaStream_t)stream,
                     (const bf16*)x, (const bf16*)scale, (const bf16*)shift, (const bf16*)add,
                     (const bf16*)w, (const bf16*)bias, (bf16*)out, L, C, F, cols);
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
