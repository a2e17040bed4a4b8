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
// Bound on the card: bytes, 8 B/elem (read x, write o). The grid covers
// the buffer once, one float4 a thread when both pointers are 16-byte
// aligned (the first threads also take the scalar tail), else one float
// a thread; __fmul_rn keeps the product bitwise torch's x * 2.0. On the
// H100 at 8 x 17,444,682 floats this loop ran at torch.mul's time, where
// the elementwise kernels' grid-stride loop (common.cuh: 8 blocks an SM,
// one float4 a trip) ran 6% slower, and four float4 a thread or
// streaming hints moved nothing (PERF.md, kernel 9; chip_smoke.py's
// phase_leak_kernel times it beside torch.mul).
#include "common.cuh"

namespace {

__global__ void leak_x2_kernel(const float* __restrict__ x,
                               float* __restrict__ o, int64_t n, int vec) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (!vec) {
    if (i < n) o[i] = __fmul_rn(x[i], 2.0f);
    return;
  }
  const int64_t n4 = n / 4;
  if (i < n4) {
    float4 a = eg::ld4(x, i), b;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      eg::set_lane(b, j, __fmul_rn(eg::lane(a, j), 2.0f));
    eg::st4(o, i, b);
  }
  if (n4 * 4 + i < n) o[n4 * 4 + i] = __fmul_rn(x[n4 * 4 + i], 2.0f);
}

}  // namespace

extern "C" int eg_leak_x2(const float* x, float* o, int64_t n,
                          cudaStream_t stream) {
  if (n <= 0) return 0;
  const int vec = ((uintptr_t)x % 16 == 0) && ((uintptr_t)o % 16 == 0);
  const int64_t threads = vec ? (n / 4 > 0 ? n / 4 : 1) : n;
  const int64_t blocks = (threads + eg::kThreads - 1) / eg::kThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  leak_x2_kernel<<<(unsigned)blocks, eg::kThreads, 0, stream>>>(x, o, n,
                                                                vec);
  return (int)cudaGetLastError();
}
