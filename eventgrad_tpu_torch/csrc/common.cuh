// Shared pieces of the elementwise gossip-tail kernels.
//
// Every kernel here is one grid-stride pass over a flat float32 arena
// holding all ranks ([R * n] elements in ONE launch). When every pointer
// is 16-byte aligned the body runs on float4 vectors and a scalar loop
// finishes the ragged tail; otherwise the whole range runs scalar.
// Arithmetic uses the round-to-nearest intrinsics (__fadd_rn, __fmul_rn,
// __fsub_rn), which nvcc never contracts into an FMA, and the files are
// also built with -fmad=false: each kernel is bitwise its plain PyTorch
// version.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace eg {

constexpr int kThreads = 256;
// resident blocks per SM the grid aims for: enough to cover load latency
// on a memory-bound stream, few enough that each thread loops a while
constexpr int kBlocksPerSm = 8;

inline int grid_for(int64_t work) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  int64_t want = (work + kThreads - 1) / kThreads;
  int64_t cap = (int64_t)sms * kBlocksPerSm;
  if (want > cap) want = cap;
  return want < 1 ? 1 : (int)want;
}

__device__ __forceinline__ float lane(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__device__ __forceinline__ void set_lane(float4& v, int j, float x) {
  if (j == 0) v.x = x;
  else if (j == 1) v.y = x;
  else if (j == 2) v.z = x;
  else v.w = x;
}

__device__ __forceinline__ float4 ld4(const float* p, int64_t i4) {
  return reinterpret_cast<const float4*>(p)[i4];
}

__device__ __forceinline__ void st4(float* p, int64_t i4, const float4& v) {
  reinterpret_cast<float4*>(p)[i4] = v;
}

}  // namespace eg
