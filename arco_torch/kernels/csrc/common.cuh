// Device helpers of the port's kernels (infonce.cu).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace arco {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Eight bf16 values of one 16-byte load, widened to f32.
__device__ __forceinline__ void unpack8(const uint4& v, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float2 p = __bfloat1622float2(h[t]);
    f[2 * t] = p.x;
    f[2 * t + 1] = p.y;
  }
}

}  // namespace arco
