// Device helpers of the port's kernels (infonce.cu, pool_sims.cu).

#pragma once

#include <cuda_runtime.h>

namespace arco {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace arco
