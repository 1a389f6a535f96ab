// Resonator-bank recurrence for Hopper: (S, K, 98) frames -> (S, K, 72, 2)
// complex states at frame boundaries, f32 throughout.
//
// Replaces the Pallas TPU kernel osu_dreamer_tpu/ops/resonator.py `_kernel`
// (launched by `resonate_frames_pallas`). Per frame k and bin f the state obeys
// y_k = A_f y_{k-1} + c_k with c_k = frames[k] @ W (the frame's contribution)
// and A_f = b_f^98 (see osu_dreamer_tpu/audio/spectrogram.py).
//
// What bounds it on the H100: 98 x 144 multiply-adds a frame on the f32 CUDA
// cores (the product stays f32: no TF32) against 392 bytes of frame read and
// 576 bytes of state written, about 29 FLOP a byte, so the f32 rate (0.0176
// ms at S2 K20480 against 0.0118 ms of bytes).
//
// Design: ONE pass, one launch (after a memset of the status words). The
// TPU kernel carries the state from tile to tile through scratch, relying on
// its grid running in order; blocks on Hopper run in no order. Here:
// - persistent CTAs of 256 threads, one an SM, stage W (98 x 144 f32, 56
//   KB) once and take 128-frame chunks by an integer ticket; the next chunk's
//   frames load by cp.async while the current chunk finishes;
// - the contribution product: a thread owns 8 frames x 9 columns (c + 16 j),
//   72 accumulators, so each value it reads from shared memory feeds 8 or 9
//   multiply-adds (W's columns are read without repeats inside a warp); the
//   products go to shared memory over the spent frames;
// - the chunk's own states: a thread owns 4 frames (a segment) x 9 bins
//   (bg + 8 j) and scans them in registers from a zero state; segment
//   aggregates combine by a shuffle scan inside the warp (4 segments) and a
//   fixed-order Horner over the warps before it, giving z, the states the
//   chunk would have from a zero state, and its aggregate (z at its last
//   frame), which it publishes (integer flag, release/acquire; no float
//   atomics). The last of a group's 16 chunks to publish (an integer count)
//   folds the group's aggregate (a Horner over its 16 chunk aggregates, in
//   order) and publishes it, so no aggregate waits on another;
// - the carry into chunk c of group g is A^(128 p) H + I, H the Horner over
//   the aggregates of groups 0..g-1 (A^2048), I over the chunks 16 g..c-1
//   (A^128): a fixed function of (song, chunk), so reruns are bit-identical
//   whatever the schedule. A CTA applies it (out = z + A^(k+1) carry at
//   frame k of the chunk) only after the product of its next chunk, holding
//   z in registers meanwhile: by then the chunks before it have published,
//   so a chunk seldom waits, and it never waits before publishing. A CTA only
//   waits on chunks with lower tickets, which running CTAs hold and publish
//   before they wait (no deadlock); a wait that never ends traps;
// - each frame is read once and each state written once (16 MB in, 23.6 MB
//   out at S2 K20480); the aggregates are 576 bytes a chunk of 128 frames.
// Powers of A come from f64 on the host (ops/resonator.py `_host_tables`).
#include "common.cuh"

namespace odt {

constexpr int kHop = 98;
constexpr int kBins = 72;
constexpr int kCols = 2 * kBins;                     // [re | im]
constexpr int kSegRows = 4;                          // frames a thread scans in registers
constexpr int kSegs = 32;                            // segments a chunk
constexpr int kChunk = kSegs * kSegRows;             // 128 frames a chunk
constexpr int kBinGroups = 8;                        // a thread's bins in the scan: bg + 8 j
constexpr int kBinsPerThread = kBins / kBinGroups;   // 9
constexpr int kResThreads = kSegs * kBinGroups;      // 256
constexpr int kResBlocks = 1;                        // CTAs an SM
constexpr int kSegsPerWarp = 32 / kBinGroups;        // 4
constexpr int kPRows = 8;                            // frames a thread owns in the product
constexpr int kPColGroups = kResThreads * kPRows / kChunk;  // 16: a thread's columns c + 16 j
constexpr int kPCols = kCols / kPColGroups;          // 9
constexpr int kCsLd = kCols + 2;                     // the products' row stride (conflict-free)
constexpr int kGroup = 16;                           // chunks a group aggregate covers (< kStaged)
constexpr int kStaged = 32;                          // aggregates staged in shared memory at a time
// rows of the power table (kPowRows, 72) complex: A^k for k <= kChunk,
// A^(kChunk p) for p < kGroup, A^(kChunk kGroup)
constexpr int kPowFrame = 0;
constexpr int kPowChunk = kPowFrame + kChunk + 1;
constexpr int kPowGroup = kPowChunk + kGroup;
constexpr int kPowRows = kPowGroup + 1;
// shared memory: W, one chunk's frames or (after the product) its
// contributions, the staged aggregates (the warps' aggregates before them),
// the carry into the chunk being finished, two flags
constexpr int kXcFloats = kChunk * (kCsLd > kHop ? kCsLd : kHop);
constexpr size_t kResSmem = (size_t)kHop * kCols * 4 + (size_t)kXcFloats * 4 +
                            (size_t)kStaged * kBins * 8 + kBins * 8 + 16;

__device__ __forceinline__ float2 cmad(float2 a, float2 b, float2 c) {  // a b + c
  return make_float2(fmaf(a.x, b.x, fmaf(-a.y, b.y, c.x)), fmaf(a.x, b.y, fmaf(a.y, b.x, c.y)));
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ int atom_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;" : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// 8 bytes global -> shared; zero-filled (nothing read) when !valid
__device__ __forceinline__ void res_cp_async8(void* smem, const void* gmem, bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 8 : 0));
}

__global__ void __launch_bounds__(kResThreads, kResBlocks)
resonate_kernel(const float* __restrict__ frames, const float* __restrict__ w,
                const float2* __restrict__ pw, float2* __restrict__ out,
                float2* __restrict__ agg, float2* __restrict__ gagg, int* __restrict__ status,
                int S, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ws = reinterpret_cast<float*>(smem);                      // (kHop, kCols)
  float* Xs = Ws + kHop * kCols;                                   // (kChunk, kHop) frames, then
  float* Cs = Xs;                                                  // (kChunk, kCsLd) contributions
  float2* staged = reinterpret_cast<float2*>(Xs + kXcFloats);      // (kStaged, kBins)
  float2* wagg = staged;                                           // (warps, kBins), before staging
  float2* carry = staged + kStaged * kBins;                        // (kBins) into the chunk finished
  int* flags = reinterpret_cast<int*>(carry + kBins);              // next ticket; "last of a group"

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int bg = tid % kBinGroups, seg = tid / kBinGroups;
  const int nch = (K + kChunk - 1) / kChunk, ngr = nch / kGroup, total = S * nch;
  int* ticket = status;
  int* cflag = status + 1;        // (S, nch): chunk aggregate published
  int* gflag = cflag + S * nch;   // (S, ngr): group aggregate published
  int* gcount = gflag + S * ngr;  // (S, ngr): a group's chunk aggregates published
  auto pow_of = [&](int row, int j) { return __ldg(pw + row * kBins + bg + kBinGroups * j); };

  auto load = [&](int t) {  // chunk t's frames into Xs, zero past the song
    const int s = t / nch, k0 = (t % nch) * kChunk;
    const int nv = min(kChunk, K - k0) * (kHop / 2);
    const float2* src = reinterpret_cast<const float2*>(frames + ((size_t)s * K + k0) * kHop);
    for (int i = tid; i < kChunk * kHop / 2; i += kResThreads)
      res_cp_async8(Xs + 2 * i, src + (i < nv ? i : 0), i < nv);
    asm volatile("cp.async.commit_group;\n" ::);
  };

  // n1 + n2 <= kStaged published complex rows into `staged` (n1 from the
  // first list, then n2 from the second): thread t waits on row t % kStaged's
  // flag and loads a quarter of it, so every row's flag and data make one
  // round trip together
  auto stage_rows = [&](const int* f1, const float2* r1, int n1, const int* f2, const float2* r2,
                        int n2) {
    const int e = tid % kStaged;
    if (e < n1 + n2) {
      const int* flag = e < n1 ? f1 + e : f2 + (e - n1);
      const float2* src = e < n1 ? r1 + (size_t)e * kBins : r2 + (size_t)(e - n1) * kBins;
      // a predecessor publishes within microseconds; one that never does is
      // a fault, and the kernel traps (a launch error) rather than hang
      for (int spins = 0; ld_acquire(flag) == 0; ++spins) {
        if (spins > (1 << 24)) __trap();
        __nanosleep(32);
      }
      for (int v = tid / kStaged; v < kBins; v += kResThreads / kStaged)
        staged[e * kBins + v] = __ldcg(src + v);
    }
    __syncthreads();
  };
  // acc = mult acc + row for staged rows [e0, e1), in order (thread < kBins, bin tid)
  auto fold = [&](int e0, int e1, float2 mult, float2& acc) {
    if (tid < kBins)
      for (int e = e0; e < e1; ++e) acc = cmad(mult, acc, staged[e * kBins + tid]);
  };

  // the carry into chunk t, then its states: out = z + A^(k+1) carry
  auto finish = [&](int t, const float2 (&z)[kSegRows][kBinsPerThread]) {
    const int s = t / nch, c = t % nch, g = c / kGroup, p = c % kGroup;
    float2 in_group = make_float2(0.f, 0.f), prior = make_float2(0.f, 0.f);
    const float2 achunk = tid < kBins ? __ldg(pw + (kPowChunk + 1) * kBins + tid) : in_group;
    const float2 agroup = tid < kBins ? __ldg(pw + kPowGroup * kBins + tid) : prior;
    const int* gf = gflag + s * ngr;
    const float2* ga = gagg + (size_t)s * ngr * kBins;
    const int first = min(g, kStaged - p);  // the group's chunks and the first groups together
    if (p + first > 0) {
      stage_rows(cflag + s * nch + g * kGroup, agg + ((size_t)s * nch + g * kGroup) * kBins, p, gf,
                 ga, first);
      fold(0, p, achunk, in_group);
      fold(p, p + first, agroup, prior);
      __syncthreads();
    }
    for (int base = first; base < g; base += kStaged) {
      const int m = min(kStaged, g - base);
      stage_rows(gf + base, ga + (size_t)base * kBins, m, gf, ga, 0);
      fold(0, m, agroup, prior);
      __syncthreads();
    }
    if (tid < kBins) carry[tid] = cmad(__ldg(pw + (kPowChunk + p) * kBins + tid), prior, in_group);
    __syncthreads();
    const int k0 = c * kChunk, nvalid = min(kChunk, K - k0);
#pragma unroll
    for (int j = 0; j < kBinsPerThread; ++j) {
      const int f = bg + kBinGroups * j;
      const float2 cf = carry[f];
#pragma unroll
      for (int i = 0; i < kSegRows; ++i) {
        const int r = seg * kSegRows + i;
        if (r < nvalid)
          out[((size_t)s * K + k0 + r) * kBins + f] = cmad(pow_of(kPowFrame + r + 1, j), cf, z[i][j]);
      }
    }
  };

  for (int i = tid; i < kHop * kCols / 4; i += kResThreads)
    reinterpret_cast<float4*>(Ws)[i] = reinterpret_cast<const float4*>(w)[i];
  if (tid == 0) flags[0] = atomicAdd(ticket, 1);
  __syncthreads();
  int cur = flags[0], prev = -1;
  if (cur < total) load(cur);
  float2 zp[kSegRows][kBinsPerThread];  // the states of chunk `prev` from a zero state

  while (cur < total) {
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();  // the chunk's frames (and W) are in; flags[0] was read
    if (tid == 0) flags[0] = atomicAdd(ticket, 1);  // the next chunk, read after the next barrier

    // ---- contributions: frames pr.. pr + 7 x columns pc + 16 j, h in order
    const int pc = tid % kPColGroups, pr = tid / kPColGroups * kPRows;
    float acc[kPRows][kPCols];
#pragma unroll
    for (int i = 0; i < kPRows; ++i)
#pragma unroll
      for (int j = 0; j < kPCols; ++j) acc[i][j] = 0.f;
#pragma unroll 2
    for (int h = 0; h < kHop; ++h) {
      float x[kPRows], wv[kPCols];
#pragma unroll
      for (int i = 0; i < kPRows; ++i) x[i] = Xs[(pr + i) * kHop + h];
#pragma unroll
      for (int j = 0; j < kPCols; ++j) wv[j] = Ws[h * kCols + pc + kPColGroups * j];
#pragma unroll
      for (int i = 0; i < kPRows; ++i)
#pragma unroll
        for (int j = 0; j < kPCols; ++j) acc[i][j] = fmaf(x[i], wv[j], acc[i][j]);
    }
    __syncthreads();  // the frames are spent: the contributions go over them
#pragma unroll
    for (int i = 0; i < kPRows; ++i)
#pragma unroll
      for (int j = 0; j < kPCols; ++j) Cs[(pr + i) * kCsLd + pc + kPColGroups * j] = acc[i][j];
    __syncthreads();
    float2 y[kSegRows][kBinsPerThread];  // the segment's contributions, then its states
#pragma unroll
    for (int i = 0; i < kSegRows; ++i)
#pragma unroll
      for (int j = 0; j < kBinsPerThread; ++j) {
        const float* row = Cs + (seg * kSegRows + i) * kCsLd + bg + kBinGroups * j;
        y[i][j] = make_float2(row[0], row[kBins]);
      }
    __syncthreads();  // the contributions are read; flags[0] holds the next chunk
    const int nxt = flags[0];
    if (nxt < total) load(nxt);

    const int s = cur / nch, c = cur % nch, g = c / kGroup;
    // ---- the segment's scan from a zero state: y_i = A y_{i-1} + c_i
#pragma unroll
    for (int j = 0; j < kBinsPerThread; ++j) {
      const float2 a1 = pow_of(kPowFrame + 1, j);
#pragma unroll
      for (int i = 1; i < kSegRows; ++i) y[i][j] = cmad(a1, y[i - 1][j], y[i][j]);
    }
    // ---- segment aggregates: inclusive scan over the warp's 4 segments
    // (lanes 8 apart), then the exclusive value of each
    float2 incl[kBinsPerThread], excl[kBinsPerThread];
#pragma unroll
    for (int j = 0; j < kBinsPerThread; ++j) incl[j] = y[kSegRows - 1][j];
#pragma unroll
    for (int d = 1; d < kSegsPerWarp; d *= 2) {
#pragma unroll
      for (int j = 0; j < kBinsPerThread; ++j) {
        const float2 b = make_float2(__shfl_up_sync(0xffffffffu, incl[j].x, kBinGroups * d),
                                     __shfl_up_sync(0xffffffffu, incl[j].y, kBinGroups * d));
        if (lane >= kBinGroups * d) incl[j] = cmad(pow_of(kPowFrame + kSegRows * d, j), b, incl[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kBinsPerThread; ++j) {
      const float2 b = make_float2(__shfl_up_sync(0xffffffffu, incl[j].x, kBinGroups),
                                   __shfl_up_sync(0xffffffffu, incl[j].y, kBinGroups));
      excl[j] = lane >= kBinGroups ? b : make_float2(0.f, 0.f);
    }
    if (lane >= 32 - kBinGroups)
#pragma unroll
      for (int j = 0; j < kBinsPerThread; ++j) wagg[warp * kBins + bg + kBinGroups * j] = incl[j];
    __syncthreads();
    // the state entering the segment from the chunk start (a Horner over the
    // warps before this one, then the segments before it in the warp), then
    // z_i = y_i + A^(i+1) of it
#pragma unroll
    for (int j = 0; j < kBinsPerThread; ++j) {
      const float2 aw = pow_of(kPowFrame + kSegRows * kSegsPerWarp, j);
      float2 cw = make_float2(0.f, 0.f);
      for (int v = 0; v < warp; ++v) cw = cmad(aw, cw, wagg[v * kBins + bg + kBinGroups * j]);
      const float2 e = cmad(pow_of(kPowFrame + kSegRows * (seg % kSegsPerWarp), j), cw, excl[j]);
#pragma unroll
      for (int i = 0; i < kSegRows; ++i) y[i][j] = cmad(pow_of(kPowFrame + i + 1, j), e, y[i][j]);
    }
    // ---- publish the chunk's aggregate, z at its last frame
    if (seg == kSegs - 1)
#pragma unroll
      for (int j = 0; j < kBinsPerThread; ++j)
        agg[((size_t)s * nch + c) * kBins + bg + kBinGroups * j] = y[kSegRows - 1][j];
    __syncthreads();
    if (tid == 0) {  // the barrier orders the CTA's stores before the fence and the flag
      __threadfence();
      st_release(cflag + s * nch + c, 1);
      flags[1] = g < ngr && atom_add_acq_rel(gcount + s * ngr + g, 1) == kGroup - 1;
    }
    __syncthreads();
    if (flags[1]) {  // the group's last chunk to publish folds the group's aggregate
      if (tid < kBins) {
        const float2 achunk = __ldg(pw + (kPowChunk + 1) * kBins + tid);
        const float2* ra = agg + ((size_t)s * nch + g * kGroup) * kBins + tid;
        float2 acc_g = make_float2(0.f, 0.f);
        for (int i = 0; i < kGroup; ++i) acc_g = cmad(achunk, acc_g, __ldcg(ra + (size_t)i * kBins));
        gagg[((size_t)s * ngr + g) * kBins + tid] = acc_g;
      }
      __syncthreads();
      if (tid == 0) {
        __threadfence();
        st_release(gflag + s * ngr + g, 1);
      }
    }

    // ---- the last chunk's states, now that the chunks before it have published
    if (prev >= 0) finish(prev, zp);
#pragma unroll
    for (int i = 0; i < kSegRows; ++i)
#pragma unroll
      for (int j = 0; j < kBinsPerThread; ++j) zp[i][j] = y[i][j];
    prev = cur;
    cur = nxt;
  }
  if (prev >= 0) finish(prev, zp);
}

}  // namespace odt

// frames (S, K, 98) f32 -> out (S, K, 72, 2) f32. w: (98, 144) [re | im];
// pw: powers (kPowRows, 72, 2); scratch: agg (S, ceil(K / 128), 72, 2), gagg
// (S, ceil(K / 128) / 16, 72, 2) f32, status (1 + S (chunks + 2 groups))
// int32, zeroed here on the stream before the launch.
extern "C" int odt_resonate(const void* frames, const void* w, const void* pw, void* out,
                            void* agg, void* gagg, void* status, int S, int K, void* stream) {
  using namespace odt;
  if (S < 1 || K < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int nch = (K + kChunk - 1) / kChunk, ngr = nch / kGroup, sms = device_sms();
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  cudaError_t err =
      cudaMemsetAsync(status, 0, (size_t)(1 + S * (nch + 2 * ngr)) * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  const int total = S * nch, grid = total < kResBlocks * sms ? total : kResBlocks * sms;
  return (int)launch(resonate_kernel, dim3(grid), dim3(kResThreads), kResSmem, st,
                     (const float*)frames, (const float*)w, (const float2*)pw, (float2*)out,
                     (float2*)agg, (float2*)gagg, (int*)status, S, K);
}
