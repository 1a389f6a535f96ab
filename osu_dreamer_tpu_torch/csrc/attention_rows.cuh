// Helpers shared by the streamed attention kernels (attention_stream.cu)
// and the one-pass long attention backward (long_attention_bwd.cu), both of
// which read (B, L, H, Dp) bf16 rows in 64 x 64 boxes through TMA: the
// shared base's alignment, bf16 packing, the MUFU exp, warp arrivals,
// accumulator stores, the row tensor map, and the backward's delta pass.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace odt {

namespace {

// the dynamic shared memory base rounded up to the 1024-byte swizzle atom
// by an offset, not through an integer, so that every pointer derived from
// it stays in the shared space (ld.shared / st.shared)
__device__ __forceinline__ unsigned char* st_smem(unsigned char* raw) {
  return raw + ((1024u - (hopper::smem_u32(raw) & 1023u)) & 1023u);
}

__device__ __forceinline__ uint32_t st_pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the MUFU unit alone (a denormal result flushes to 0, -inf gives 0)
__device__ __forceinline__ float st_ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// one warp's arrival on a barrier once all its lanes are done
__device__ __forceinline__ void warp_arrive(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) hopper::mbar_arrive(bar);
}

template <int NB>
__device__ __forceinline__ void fence_acc(float (&acc)[NB][32]) {
#pragma unroll
  for (int c = 0; c < NB; ++c) hopper::fence_regs(acc[c]);
}

// an accumulator's two rows (r, r + 8 of the box) into rows of a bf16
// array `ld` elements apart at columns col0.. (an even count `width` of
// them, each pair 4-byte aligned), skipping rows past `rows`
__device__ __forceinline__ void store_bf16(const float (&acc)[32], bf16* __restrict__ dst,
                                           int row, int rows, size_t ld, int width, int col0,
                                           int lane) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (row + 8 * hr >= rows) continue;
    bf16* p = dst + (size_t)(row + 8 * hr) * ld;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + j * 8 + (lane % 4) * 2;
      if (col < width)
        *reinterpret_cast<__nv_bfloat162*>(p + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
    }
  }
}

// the sum over an aligned group of g lanes (a power of two)
__device__ __forceinline__ float group_sum(float v, int g) {
  for (int o = g >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// a row of D values into Dp columns, zero past D, by the g lanes of a group
__device__ __forceinline__ void copy_row(const bf16* __restrict__ x, bf16* __restrict__ y, int D,
                                         int Dp, int li, int g) {
  for (int j = li; j < Dp; j += g) y[j] = __float2bfloat16(j < D ? ldf(x + j) : 0.f);
}

constexpr int kDeltaWarps = 4;  // warps a block of the delta pass

// The long attention backward's row pass (q and k arrive normalised and
// rotated, so no norm and no RoPE): a group of G lanes (`delta_lanes`) a
// (row, head) of the (B L) rows, delta = rowsum(dO O) in f32 into (B, H, L)
// and, where rdo is given, dO copied padded to Dp columns; the grid's first
// `ncount` threads zero `counters` (the one pass's dQ counters; none for the
// two launches). Rows are read 8 bf16 (16 bytes) a lane where D % 8 == 0,
// else one value at a time.
__global__ void __launch_bounds__(kDeltaWarps * 32)
attention_delta_kernel(const bf16* __restrict__ dout, const bf16* __restrict__ o,
                       bf16* __restrict__ rdo, float* __restrict__ delta,
                       int* __restrict__ counters, int ncount, int BL, int L, int H, int D,
                       int Dp, int G) {
  const size_t gtid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (gtid < (size_t)ncount) counters[gtid] = 0;
  const int lane = threadIdx.x % 32, li = lane % G;
  const size_t units = (size_t)BL * H;
  const size_t first = ((size_t)blockIdx.x * kDeltaWarps + threadIdx.x / 32) * (32 / G);
  if (first >= units) return;  // whole warps only: the group sums shuffle over all 32 lanes
  const size_t unit = first + lane / G;
  const bool live = unit < units;  // a tail group computes the last unit again and stores nothing
  const size_t u = min(unit, units - 1);
  const bf16* g = dout + u * D;
  const bf16* oo = o + u * D;
  float d = 0.f;
  if (D % 8 == 0) {
    for (int j = li * 8; j < D; j += G * 8) {
      const uint4 a = *reinterpret_cast<const uint4*>(g + j);
      const uint4 b = *reinterpret_cast<const uint4*>(oo + j);
      const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 fa = __bfloat1622float2(pa[e]), fb = __bfloat1622float2(pb[e]);
        d += fa.x * fb.x + fa.y * fb.y;
      }
    }
  } else {
    for (int j = li; j < D; j += G) d += ldf(g + j) * ldf(oo + j);
  }
  d = group_sum(d, G);
  if (!live) return;
  const int row = (int)(u / H), h = (int)(u % H);
  if (li == 0) delta[((size_t)(row / L) * H + h) * L + row % L] = d;
  if (rdo != nullptr) copy_row(g, rdo + u * Dp, D, Dp, li, G);
}

// the delta pass's lanes a (row, head): about 8 values a lane (16-byte
// loads) where D % 8 == 0, else 4, as a power of two up to a warp
int delta_lanes(int D) {
  const int per = D % 8 == 0 ? 8 : 4;
  int g = 1;
  while (g < 32 && g * per < D) g *= 2;
  return g;
}

// the delta pass over (B, L, H D) dout and out (see attention_delta_kernel)
int delta_launch(const void* dout, const void* out, void* rdo, void* delta, void* counters,
                 int ncount, int B, int L, int H, int D, int Dp, cudaStream_t stream) {
  const int lanes = delta_lanes(D);
  const size_t warps = ((size_t)B * L * H * lanes + 31) / 32;
  return (int)launch(attention_delta_kernel,
                     dim3((unsigned)((warps + kDeltaWarps - 1) / kDeltaWarps)),
                     dim3(kDeltaWarps * 32), 0, stream, (const bf16*)dout, (const bf16*)out,
                     (bf16*)rdo, (float*)delta, (int*)counters, ncount, B * L, L, H, D, Dp,
                     lanes);
}

// the 4-D tensor map (D, H, L, B) of the heads at `base` whose rows lie
// `row` elements apart, in 64 x 64 boxes with 128-byte swizzle: a (B, L,
// H, D) array (row H D), or v inside the packed qkv rows (row 3 H D).
// Columns past D and rows past L load as zeros
cudaError_t stream_map_rows(CUtensorMap* map, const void* base, int D, int H, int L, int B,
                            size_t row) {
  hopper::EncodeTiledFn encode = hopper::encode_tiled_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, row * 2, (cuuint64_t)L * row * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult res =
      encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
             box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the tensor map of a (B, L, H, Dp) bf16 array
cudaError_t stream_map(CUtensorMap* map, const void* base, int Dp, int H, int L, int B) {
  return stream_map_rows(map, base, Dp, H, L, B, (size_t)H * Dp);
}

}  // namespace

}  // namespace odt
