// FiLM-modulated SwiGLU residual layer, backward, for Hopper (K3).
//
// Replaces the Pallas TPU kernel osu_dreamer_tpu/ops/film_layer.py
// `_bwd_kernel` (launched by `_fused_film_layer_bwd_impl`). The forward
// (csrc/film_layer.cu, K2) is, per position,
//
//   h1  = rms(x) * g1 * (1 + scale) + shift,  zero outside [0, L)
//   y   = dwconv(h1);  [v|g] = y W_vg + b_vg;  s = v * silu(g)
//   hn  = rms_H(s);    o = hn W_out + b_out
//   out = x + rms(o) * g2 * (1 + gate)
//
// and this kernel returns dx and all eleven parameter / FiLM gradients. On the
// main path it is every FilmStack layer of latent training (fit-latent):
// bf16 (64, L, 128), H = 341 (padded to 352), K = 5, at L = 1026 / 342 / 114
// / 38, 88 layers per step.
//
// Design. One block owns kFbE = 64 extended rows (T = 64 - 2r core rows plus
// an r-row halo each side, the rows whose dY the transposed conv of the core
// needs) of one batch row; 32 rows at C 256 and 16 at C 384, the widest
// width the JAX package fuses (fb_rows), so that the row buffers fit shared
// memory. It recomputes the forward there from x alone: h1 on E + 2r rows, y, s and hn (bf16, rounded where the plain version
// rounds), o. Then, all in shared memory except dvg:
//   block norm backward   do = n2 don - n2^3 o mean(don o), don = go (1+gate) g2
//   pass 1 over 16-wide hidden tiles: dhn = do W_out^T and the row sum of dhn s
//   pass 2: ds = n dhn - n^3 s mean(dhn s); dv = ds silu(g);
//           dg = ds v sig (1 + g (1 - sig)); dvg (bf16) to a per-block scratch
//   dY = dvg W_vg^T (each warp owns 16-column tiles of C)
//   dh1 = transposed conv of dY at the core rows, then the FiLM and pre-norm
//   backward to dx = go + n1 dxn - n1^3 x mean(dxn x).
// Rows outside [0, L) read a zero output gradient, so their do, dvg and dY are
// zero and the transposed conv pulls nothing from them; core rows past L are
// skipped before any sum (the ragged last tile, and L = 38 where one block
// holds the whole sequence). H's padded columns have v = 0 and W_out rows of
// zero, so their s, dhn and dvg are exactly zero.
//
// Sums over rows (blocks run in no order): every per-column sum (the FiLM
// grads per batch row, g1, g2, the conv taps and bias, both biases) leaves as
// one f32 partial per block, the warps adding theirs in place in warp order;
// the wrapper sums the blocks' partials.
// The two weight products dW_vg = y^T dvg (C x 2H) and dW_out = hn^T do
// (H x C), which the Pallas kernel forms in its own body, are a second and
// third kernel here (csrc/gemm_tn.cuh): the row kernel writes y, hn and do of
// its core rows (zero elsewhere) and dvg of all its rows as bf16 scratch, and
// a split-K tensor-core product over row chunks reduces its partials in a
// fixed order. No float atomics: two runs give bit-identical gradients.
//
// What bounds it on the H100: per row about 3.5 (C x 2H) products' worth of
// recompute and backward (vg twice more for the two passes, dhn twice, dY,
// o), some 60 MFLOP per 64-row block at C = 128, on the tensor cores with
// the weights (W_vg 180 KB, W_out 90 KB bf16) read from L2 by every block; the
// hidden activations (64 x 704) stay out of device memory except dvg, which
// the weight product needs anyway. A first design on wmma/mma.sync, 195 KB of
// shared memory, one block per SM; staging the weights with TMA and wgmma is
// later work.
#include "ffn_tile.cuh"
#include "gemm_tn.cuh"

namespace odt {

constexpr int kFbWarps = kFfnWarps;
constexpr int kFbMaxK = 9;
constexpr int kFbScr = 768;        // f32 per warp: three 16 x 16 tiles

// extended rows per block: 64 up to C 128; the JAX package also fuses C 256
// and 384, where 32 and 16 rows keep the row buffers in shared memory
__host__ __device__ constexpr int fb_rows(int C) { return C <= 128 ? 64 : C <= 256 ? 32 : 16; }

// slots of a block's partial row (C floats each; the conv taps take K, the
// vg bias 2 Hp at the end)
enum { kDsc = 0, kDsh, kDgate, kDg1, kDg2, kDdwb, kDbout, kDdw };

struct FilmBwdSmem {
  int lda, ldh, nsum;
  size_t h1, ys, hs, fs, dos, scratch, part, rows, total;
  __host__ __device__ FilmBwdSmem(int C, int Hp, int K) {
    const int r = K / 2, kFbE = fb_rows(C);
    lda = C + 8;
    ldh = Hp + 8;
    nsum = 4 + K;  // per-warp column sums of the last phase
    h1 = 0;
    ys = h1 + align128((size_t)(kFbE + 2 * r) * lda * sizeof(bf16));
    hs = ys + align128((size_t)kFbE * lda * sizeof(bf16));
    fs = hs + align128((size_t)kFbE * ldh * sizeof(bf16));
    dos = fs + align128((size_t)kFbE * C * sizeof(float));
    scratch = dos + align128((size_t)kFbE * lda * sizeof(bf16));
    part = scratch + align128((size_t)kFbWarps * kFbScr * sizeof(float));
    // the column partials, summed warp by warp in place (and pass 1's per-warp row sums)
    const size_t np = (size_t)nsum * C > (size_t)kFbWarps * kFbE ? (size_t)nsum * C
                                                                  : (size_t)kFbWarps * kFbE;
    rows = part + align128(np * sizeof(float));
    total = rows + (size_t)(3 * kFbE + 2 * r) * sizeof(float);
  }
};

template <int CQ>  // C = 32 CQ: each lane owns columns lane + 32 q
__global__ void __launch_bounds__(kFfnThreads)
film_layer_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ go,
                      const bf16* __restrict__ scale, const bf16* __restrict__ shift,
                      const bf16* __restrict__ gate, const bf16* __restrict__ g1,
                      const bf16* __restrict__ g2, const bf16* __restrict__ dww,
                      const bf16* __restrict__ dwb, const bf16* __restrict__ wvg,
                      const bf16* __restrict__ bvg, const bf16* __restrict__ wout,
                      const bf16* __restrict__ bout, bf16* __restrict__ dx,
                      float* __restrict__ part, bf16* __restrict__ y_s, bf16* __restrict__ hn_s,
                      bf16* __restrict__ do_s, bf16* __restrict__ dvg_s, int L, int H, int Hp,
                      int K) {
  constexpr int C = CQ * 32;
  constexpr int kFbE = fb_rows(C);                 // extended rows per block
  constexpr int kFbRT = kFbE / 16;                 // row fragments
  constexpr int kFbMaxCT = CQ <= 8 ? 2 : CQ / 4;   // dY column tiles per warp
  extern __shared__ __align__(128) unsigned char smem[];
  const FilmBwdSmem lay(C, Hp, K);
  const int lda = lay.lda, ldh = lay.ldh, nsum = lay.nsum;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = K / 2, T = kFbE - 2 * r;
  bf16* h1 = reinterpret_cast<bf16*>(smem + lay.h1);
  bf16* ys = reinterpret_cast<bf16*>(smem + lay.ys);
  bf16* hs = reinterpret_cast<bf16*>(smem + lay.hs);
  float* fs = reinterpret_cast<float*>(smem + lay.fs);
  bf16* dos = reinterpret_cast<bf16*>(smem + lay.dos);
  float* scr = reinterpret_cast<float*>(smem + lay.scratch) + warp * kFbScr;
  float* ps = reinterpret_cast<float*>(smem + lay.part);
  float* n1s = reinterpret_cast<float*>(smem + lay.rows);  // kFbE + 2r rows of h1
  float* rown = n1s + kFbE + 2 * r;
  float* rowm = rown + kFbE;

  const int t0 = blockIdx.x * T, b = blockIdx.y;
  const int blk = b * gridDim.x + blockIdx.x;
  const int ldd = 2 * Hp, nTiles = Hp / 16;
  float* pb = part + (size_t)blk * ((7 + K) * C + 2 * Hp);
  const bf16* xb = x + (size_t)b * L * C;
  const bf16* gob = go + (size_t)b * L * C;
  const bf16* sc = scale + (size_t)b * C;
  const bf16* sh = shift + (size_t)b * C;
  const bf16* gt = gate + (size_t)b * C;
  bf16* dvs = dvg_s + (size_t)blk * kFbE * ldd;  // this block's (kFbE, 2Hp) dvg

  // ---- h1 on the kFbE + 2r rows at t0 - 2r.. (K2's rounding), zero outside
  // [0, L) after the FiLM shift
  for (int e = warp; e < kFbE + 2 * r; e += kFbWarps) {
    const int pos = t0 - 2 * r + e;
    bf16* row = h1 + e * lda;
    if (pos < 0 || pos >= L) {
#pragma unroll
      for (int q = 0; q < CQ; ++q) row[lane + 32 * q] = __float2bfloat16(0.f);
      if (lane == 0) n1s[e] = 0.f;
      continue;
    }
    float xv[CQ], s = 0.f;
#pragma unroll
    for (int q = 0; q < CQ; ++q) {
      xv[q] = ldf(xb + (size_t)pos * C + lane + 32 * q);
      s += xv[q] * xv[q];
    }
    const float inv = rsqrtf(warp_sum(s) / C + 1e-6f);
#pragma unroll
    for (int q = 0; q < CQ; ++q) {
      const int c = lane + 32 * q;
      const float n = bfr(bfr(xv[q] * inv) * ldf(g1 + c));
      row[c] = __float2bfloat16(bfr(n * bfr(1.f + ldf(sc + c))) + ldf(sh + c));
    }
    if (lane == 0) n1s[e] = inv;
  }
  __syncthreads();
  // ---- forward recompute on the kFbE rows at t0 - r..: y, s, hn, o
  ffn_dwconv<kFbE>(h1, lda, dww, dwb, K, C, ys);
  __syncthreads();
  ffn_gate<kFbE>(ys, lda, C, wvg, bvg, Hp, hs, ldh, scr);
  __syncthreads();
  for (int e = warp; e < kFbE; e += kFbWarps) {  // hs <- hn, rown <- 1 / rms_H(s)
    bf16* row = hs + e * ldh;
    float s = 0.f;
    for (int c = lane; c < H; c += 32) {
      const float h = ldf(row + c);
      s += h * h;
    }
    const float inv = rsqrtf(warp_sum(s) / H + 1e-6f);
    for (int c = lane; c < H; c += 32) row[c] = __float2bfloat16(ldf(row + c) * inv);
    if (lane == 0) rown[e] = inv;
  }
  __syncthreads();
  ffn_out<kFbE>(hs, ldh, Hp, wout, bout, C, scr, [&](int t, int c, float v) { fs[t * C + c] = v; });
  __syncthreads();

  // ---- block norm and gated residual backward, one warp per row -> do
  {
    float pg[CQ] = {}, p2[CQ] = {}, pbo[CQ] = {};
    for (int e = warp; e < kFbE; e += kFbWarps) {
      const int pos = t0 - r + e;
      const bool valid = pos >= 0 && pos < L;
      const bool core = valid && e >= r && e < r + T;
      float o[CQ], don[CQ], s2 = 0.f, sm = 0.f;
#pragma unroll
      for (int q = 0; q < CQ; ++q) {
        o[q] = fs[e * C + lane + 32 * q];
        s2 += o[q] * o[q];
      }
      const float n2 = rsqrtf(warp_sum(s2) / C + 1e-6f);
#pragma unroll
      for (int q = 0; q < CQ; ++q) {
        const int c = lane + 32 * q;
        const float gf = valid ? ldf(gob + (size_t)pos * C + c) : 0.f;
        const float on = bfr(o[q] * n2), h2 = bfr(on * ldf(g2 + c));
        const float dh2 = gf * bfr(1.f + ldf(gt + c));
        don[q] = dh2 * ldf(g2 + c);
        sm += don[q] * o[q];
        if (core) {
          pg[q] += gf * h2;
          p2[q] += dh2 * on;
        }
      }
      const float m = warp_sum(sm) / C;
#pragma unroll
      for (int q = 0; q < CQ; ++q) {
        const float d = n2 * don[q] - n2 * n2 * n2 * o[q] * m;
        dos[e * lda + lane + 32 * q] = __float2bfloat16(d);
        if (core) pbo[q] += d;
      }
    }
    // summed warp by warp, in warp order (a fixed order: reruns are
    // bit-identical)
    for (int w = 0; w < kFbWarps; ++w) {
      if (warp == w) {
#pragma unroll
        for (int q = 0; q < CQ; ++q) {
          const int c = lane + 32 * q;
          ps[0 * C + c] = (w ? ps[0 * C + c] : 0.f) + pg[q];
          ps[1 * C + c] = (w ? ps[1 * C + c] : 0.f) + p2[q];
          ps[2 * C + c] = (w ? ps[2 * C + c] : 0.f) + pbo[q];
        }
      }
      __syncthreads();
    }
  }
  for (int idx = threadIdx.x; idx < 3 * C; idx += blockDim.x) {
    const int q = idx / C, c = idx % C;
    const int slot = q == 0 ? kDgate : (q == 1 ? kDg2 : kDbout);
    pb[slot * C + c] = ps[q * C + c];
  }
  __syncthreads();

  // ---- pass 1: per-row mean over H of dhn * s
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> fv[kFbRT], fg[kFbRT], fd[kFbRT];
  {
    const int er = lane >> 1, ec = (lane & 1) * 8;  // a lane pair per row
    float dot[kFbRT] = {};
    for (int j = warp; j < nTiles; j += kFbWarps) {
      ffn_hidden_tile<kFbRT>(ys, dos, lda, wvg, wout, C, Hp, j, fv, fg, fd);
#pragma unroll
      for (int i = 0; i < kFbRT; ++i) {
        wmma::store_matrix_sync(scr, fv[i], 16, wmma::mem_row_major);
        wmma::store_matrix_sync(scr + 256, fg[i], 16, wmma::mem_row_major);
        wmma::store_matrix_sync(scr + 512, fd[i], 16, wmma::mem_row_major);
        __syncwarp();
        float sd = 0.f;
        for (int q = 0; q < 8; ++q) {
          const int e = er * 16 + ec + q, col = j * 16 + ec + q;
          const float v = bfr(bfr(scr[e]) + ldf(bvg + col));
          const float g = bfr(bfr(scr[256 + e]) + ldf(bvg + Hp + col));
          const float s = bfr(v * bfr(g / (1.f + expf(-g))));
          sd += scr[512 + e] * s;
        }
        dot[i] += sd + __shfl_xor_sync(0xffffffffu, sd, 1);
        __syncwarp();
      }
    }
    if ((lane & 1) == 0) {
#pragma unroll
      for (int i = 0; i < kFbRT; ++i) ps[warp * kFbE + i * 16 + er] = dot[i];
    }
  }
  __syncthreads();
  if (threadIdx.x < kFbE) {
    float sd = 0.f;
    for (int w = 0; w < kFbWarps; ++w) sd += ps[w * kFbE + threadIdx.x];
    rowm[threadIdx.x] = sd / H;
  }
  __syncthreads();

  // ---- pass 2: dvg tile by tile into the block's scratch, the vg-bias partial
  for (int j = warp; j < nTiles; j += kFbWarps) {
    ffn_hidden_tile<kFbRT>(ys, dos, lda, wvg, wout, C, Hp, j, fv, fg, fd);
    // lane owns column j*16 + (lane & 15) of both halves
    float sv = 0.f, sg = 0.f;
#pragma unroll
    for (int i = 0; i < kFbRT; ++i) {
      wmma::store_matrix_sync(scr, fv[i], 16, wmma::mem_row_major);
      wmma::store_matrix_sync(scr + 256, fg[i], 16, wmma::mem_row_major);
      wmma::store_matrix_sync(scr + 512, fd[i], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = i * 16 + (e >> 4), col = j * 16 + (e & 15);
        const float v = bfr(bfr(scr[e]) + ldf(bvg + col));
        const float g = bfr(bfr(scr[256 + e]) + ldf(bvg + Hp + col));
        const float sig = 1.f / (1.f + expf(-g)), sil = bfr(g / (1.f + expf(-g)));
        const float s = bfr(v * sil), n = rown[row];
        const float ds = n * scr[512 + e] - n * n * n * s * rowm[row];
        const bf16 dv = __float2bfloat16(ds * sil);
        const bf16 dg = __float2bfloat16(ds * v * (sig * (1.f + g * (1.f - sig))));
        dvs[row * ldd + col] = dv;
        dvs[row * ldd + Hp + col] = dg;
        const int pos = t0 - r + row;
        if (row >= r && row < r + T && pos < L) {
          sv += __bfloat162float(dv);
          sg += __bfloat162float(dg);
        }
      }
      __syncwarp();
    }
    sv += __shfl_xor_sync(0xffffffffu, sv, 16);
    sg += __shfl_xor_sync(0xffffffffu, sg, 16);
    const int c = j * 16 + (lane & 15);
    pb[(7 + K) * C + (lane < 16 ? c : Hp + c)] = lane < 16 ? sv : sg;
  }
  // the weight products' left operands: y, hn and do of the core rows (zero
  // on the halo and past L), 16 bytes a thread
  {
    const int4 zero = make_int4(0, 0, 0, 0);
    const size_t row0 = (size_t)blk * kFbE;
    for (int idx = threadIdx.x; idx < kFbE * (C / 8); idx += blockDim.x) {
      const int e = idx / (C / 8), c = (idx % (C / 8)) * 8;
      const bool keep = e >= r && e < r + T && t0 - r + e < L;
      const size_t o = (row0 + e) * C + c;
      *reinterpret_cast<int4*>(y_s + o) = keep ? *reinterpret_cast<const int4*>(ys + e * lda + c) : zero;
      *reinterpret_cast<int4*>(do_s + o) = keep ? *reinterpret_cast<const int4*>(dos + e * lda + c) : zero;
    }
    for (int idx = threadIdx.x; idx < kFbE * (Hp / 8); idx += blockDim.x) {
      const int e = idx / (Hp / 8), c = (idx % (Hp / 8)) * 8;
      const bool keep = e >= r && e < r + T && t0 - r + e < L;
      *reinterpret_cast<int4*>(hn_s + (row0 + e) * Hp + c) =
          keep ? *reinterpret_cast<const int4*>(hs + e * ldh + c) : zero;
    }
  }
  __syncthreads();  // the block's dvg scratch is complete (and visible to it)

  // ---- dY = dvg W_vg^T into fs (f32), each warp owning column tiles warp + 8 ci
  {
    constexpr int nct = C / 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> fy[kFbMaxCT][kFbRT];
#pragma unroll
    for (int ci = 0; ci < kFbMaxCT; ++ci)
#pragma unroll
      for (int i = 0; i < kFbRT; ++i) wmma::fill_fragment(fy[ci][i], 0.f);
    for (int kk = 0; kk < ldd; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw[kFbMaxCT];
#pragma unroll
      for (int ci = 0; ci < kFbMaxCT; ++ci) {
        const int ct = warp + ci * kFbWarps;
        if (ct < nct) wmma::load_matrix_sync(bw[ci], wvg + (size_t)ct * 16 * ldd + kk, ldd);
      }
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[kFbRT];
#pragma unroll
      for (int i = 0; i < kFbRT; ++i) wmma::load_matrix_sync(a[i], dvs + i * 16 * ldd + kk, ldd);
#pragma unroll
      for (int ci = 0; ci < kFbMaxCT; ++ci) {
        if (warp + ci * kFbWarps >= nct) break;
#pragma unroll
        for (int i = 0; i < kFbRT; ++i) wmma::mma_sync(fy[ci][i], a[i], bw[ci], fy[ci][i]);
      }
    }
#pragma unroll
    for (int ci = 0; ci < kFbMaxCT; ++ci) {
      const int ct = warp + ci * kFbWarps;
      if (ct >= nct) break;
#pragma unroll
      for (int i = 0; i < kFbRT; ++i)
        wmma::store_matrix_sync(fs + i * 16 * C + ct * 16, fy[ci][i], C, wmma::mem_row_major);
    }
  }
  __syncthreads();

  // ---- core rows: dh1 (transposed conv), FiLM and pre-norm backward -> dx,
  // and the column partials
  {
    float psh[CQ] = {}, psc[CQ] = {}, pg1[CQ] = {}, pdb[CQ] = {}, ptap[kFbMaxK][CQ] = {};
    for (int i = warp; i < T; i += kFbWarps) {
      const int pos = t0 + i;
      if (pos >= L) break;
      const float n1 = n1s[i + 2 * r];
      float xv[CQ], dxn[CQ], sm = 0.f;
#pragma unroll
      for (int q = 0; q < CQ; ++q) {
        const int c = lane + 32 * q;
        float d = 0.f;
        for (int k = 0; k < K; ++k) d += fs[(i - k + 2 * r) * C + c] * ldf(dww + k * C + c);
        xv[q] = ldf(xb + (size_t)pos * C + c);
        const float xn = bfr(xv[q] * n1), a = bfr(xn * ldf(g1 + c));
        psh[q] += d;
        psc[q] += d * a;
        const float da = d * bfr(1.f + ldf(sc + c));
        pg1[q] += da * xn;
        dxn[q] = da * ldf(g1 + c);
        sm += dxn[q] * xv[q];
        const float dy = fs[(i + r) * C + c];
        pdb[q] += dy;
#pragma unroll
        for (int k = 0; k < kFbMaxK; ++k)
          if (k < K) ptap[k][q] += dy * ldf(h1 + (i + k + r) * lda + c);
      }
      const float m = warp_sum(sm) / C;
#pragma unroll
      for (int q = 0; q < CQ; ++q) {
        const size_t p = (size_t)pos * C + lane + 32 * q;
        dx[(size_t)b * L * C + p] =
            __float2bfloat16(ldf(gob + p) + n1 * dxn[q] - n1 * n1 * n1 * xv[q] * m);
      }
    }
    __syncthreads();  // pass 1's row sums are read; the region takes the partials
    for (int w = 0; w < kFbWarps; ++w) {
      if (warp == w) {
#pragma unroll
        for (int q = 0; q < CQ; ++q) {
          float* p = ps + lane + 32 * q;  // warp 0 writes, the others add in order
          p[0 * C] = (w ? p[0 * C] : 0.f) + psh[q];
          p[1 * C] = (w ? p[1 * C] : 0.f) + psc[q];
          p[2 * C] = (w ? p[2 * C] : 0.f) + pg1[q];
          p[3 * C] = (w ? p[3 * C] : 0.f) + pdb[q];
#pragma unroll
          for (int k = 0; k < kFbMaxK; ++k)
            if (k < K) p[(4 + k) * C] = (w ? p[(4 + k) * C] : 0.f) + ptap[k][q];
        }
      }
      __syncthreads();
    }
  }
  for (int idx = threadIdx.x; idx < nsum * C; idx += blockDim.x) {
    const int q = idx / C, c = idx % C;
    const int slot = q == 0 ? kDsh : q == 1 ? kDsc : q == 2 ? kDg1 : q == 3 ? kDdwb : kDdw + q - 4;
    pb[slot * C + c] = ps[q * C + c];
  }
}

template <int CQ>
cudaError_t launch_film_layer_bwd(dim3 grid, size_t smem, cudaStream_t stream, const bf16* x,
                                  const bf16* go, const bf16* scale, const bf16* shift,
                                  const bf16* gate, const bf16* g1, const bf16* g2,
                                  const bf16* dww, const bf16* dwb, const bf16* wvg,
                                  const bf16* bvg, const bf16* wout, const bf16* bout, bf16* dx,
                                  float* part, bf16* y_s, bf16* hn_s, bf16* do_s, bf16* dvg_s,
                                  int L, int H, int Hp, int K) {
  return launch(film_layer_bwd_kernel<CQ>, grid, dim3(kFfnThreads), smem, stream, x, go, scale,
                shift, gate, g1, g2, dww, dwb, wvg, bvg, wout, bout, dx, part, y_s, hn_s, do_s,
                dvg_s, L, H, Hp, K);
}

}  // namespace odt

// dx (B, L, C) bf16; part (B, ceil(L / T), (7 + K) C + 2 Hp) f32, the
// per-block column sums in the slot order of the enum above; the scratch
// y_s, do_s (R, C), hn_s (R, Hp), dvg_s (R, 2 Hp) bf16 with R = blocks x 64;
// pvg (S_vg, C, 2 Hp) and pout (S_out, Hp, C) f32 split-K partials; dwvg
// (C, 2 Hp) and dwout (Hp, C) f32 in the padded layout.
extern "C" int odt_film_layer_bwd(const void* x, const void* go, const void* scale,
                                  const void* shift, const void* gate, const void* g1,
                                  const void* g2, const void* dww, const void* dwb,
                                  const void* wvg, const void* bvg, const void* wout,
                                  const void* bout, void* dx, void* part, void* y_s, void* hn_s,
                                  void* do_s, void* dvg_s, void* pvg, void* pout, void* dwvg,
                                  void* dwout, int B, int L, int C, int H, int Hp, int K,
                                  int S_vg, int S_out, void* stream) {
  using namespace odt;
  const int E = fb_rows(C);
  if (K > kFbMaxK || K % 2 == 0 || E - 2 * (K / 2) <= 0 || Hp % 16 || H > Hp || H < 1)
    return (int)cudaErrorInvalidValue;
  const FilmBwdSmem lay(C, Hp, K);
  const int T = E - 2 * (K / 2);
  dim3 grid((L + T - 1) / T, B);
  cudaStream_t s = (cudaStream_t)stream;
  auto args = [&](auto fn) {
    return fn(grid, lay.total, s, (const bf16*)x, (const bf16*)go, (const bf16*)scale,
              (const bf16*)shift, (const bf16*)gate, (const bf16*)g1, (const bf16*)g2,
              (const bf16*)dww, (const bf16*)dwb, (const bf16*)wvg, (const bf16*)bvg,
              (const bf16*)wout, (const bf16*)bout, (bf16*)dx, (float*)part, (bf16*)y_s,
              (bf16*)hn_s, (bf16*)do_s, (bf16*)dvg_s, L, H, Hp, K);
  };
  cudaError_t err;
  switch (C) {
    case 32: err = args(launch_film_layer_bwd<1>); break;
    case 64: err = args(launch_film_layer_bwd<2>); break;
    case 128: err = args(launch_film_layer_bwd<4>); break;
    case 256: err = args(launch_film_layer_bwd<8>); break;
    case 384: err = args(launch_film_layer_bwd<12>); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const int R = grid.x * grid.y * E;
  err = gemm_tn_splitk((const bf16*)y_s, C, (const bf16*)dvg_s, 2 * Hp, R, C, 2 * Hp, S_vg,
                       (float*)pvg, (float*)dwvg, s);
  if (err != cudaSuccess) return (int)err;
  return (int)gemm_tn_splitk((const bf16*)hn_s, Hp, (const bf16*)do_s, C, R, Hp, C, S_out,
                             (float*)pout, (float*)dwout, s);
}
