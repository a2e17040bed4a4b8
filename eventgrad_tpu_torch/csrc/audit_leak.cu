// The auditor's seeded unregistered kernel: o = x * 2 over a float32
// buffer.
//
// Replaces the TPU kernel eventgrad_tpu/analysis/audit.py:_leak_kernel,
// the pallas_call inside oracle_unregistered_kernel that proves the
// trace auditor refuses an opaque kernel with no declared rank layout.
// Its port is the operator eg::leak_kernel
// (eventgrad_tpu_torch/analysis/audit.py), deliberately absent from the
// kernel registry; no training path launches it.
//
// Bound on the card: bytes, 8 B/elem (read x, write o). The body is the
// elementwise kernels' float4 grid-stride loop; the 4-wide path is taken
// when both pointers are 16-byte aligned, and __fmul_rn keeps the product
// bitwise torch's x * 2.0.
#include "common.cuh"

namespace {

__global__ void leak_x2_kernel(const float* __restrict__ x,
                               float* __restrict__ o, int64_t n, int vec) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n / 4;
    for (int64_t i = tid; i < n4; i += stride) {
      float4 a = eg::ld4(x, i), b;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        eg::set_lane(b, j, __fmul_rn(eg::lane(a, j), 2.0f));
      eg::st4(o, i, b);
    }
    done = n4 * 4;
  }
  for (int64_t i = done + tid; i < n; i += stride) o[i] = __fmul_rn(x[i], 2.0f);
}

}  // namespace

extern "C" int eg_leak_x2(const float* x, float* o, int64_t n,
                          cudaStream_t stream) {
  if (n <= 0) return 0;
  const int vec = ((uintptr_t)x % 16 == 0) && ((uintptr_t)o % 16 == 0);
  const int64_t work = vec ? n / 4 + 1 : n;
  leak_x2_kernel<<<eg::grid_for(work), eg::kThreads, 0, stream>>>(x, o, n,
                                                                   vec);
  return (int)cudaGetLastError();
}
