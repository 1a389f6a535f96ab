// Helpers shared by the port's hand-written sm_90a kernels.
//
// Every kernel here is bound through a plain C entry point (loaded with
// ctypes by osu_dreamer_tpu_torch/ops/_build.py). An entry point launches on
// the stream it is given, never synchronises, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace odt {

using bf16 = __nv_bfloat16;

// Shared memory a block may use on Hopper (232,448 bytes, opt-in above 48 KB).
constexpr size_t kMaxSmem = 232448;

// Round an f32 value through bf16. The kernels apply it wherever the plain
// PyTorch version rounds a bf16 intermediate, so the two agree to within the
// rounding of the matrix products' accumulation order.
__device__ __forceinline__ float bfr(float x) { return __bfloat162float(__float2bfloat16(x)); }

__device__ __forceinline__ float ldf(const bf16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The current device's streaming multiprocessors (queried once; 0 on error).
// Persistent grids and hidden splits are sized from it.
inline int device_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 0;
  }
  return sms;
}

// Opt a kernel in to `smem` bytes of dynamic shared memory and launch it.
template <class Kernel, class... Args>
cudaError_t launch(Kernel kernel, dim3 grid, dim3 block, size_t smem, cudaStream_t stream,
                   Args... args) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, block, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace odt
