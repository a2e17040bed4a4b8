// Masked-wire builder: out = where(fire > 0, flat, 0) over the flat arena.
//
// Replaces the TPU kernel eventgrad_tpu/ops/event_engine.py:_mask_kernel
// (launched by _masked_wire_pallas with scale_exp=None). The int8
// variant, _mask_quant_kernel, is ported in csrc/mask_quant.cu.
//
// Bound on the card: bytes. Per element it reads flat and the
// per-position fire bit (f32) and writes out: 12 B/elem, about 1.67 GB
// for the flagship Ring(8) ResNet-18 step (8 x 17,444,682 elements),
// i.e. about 0.50 ms at 3.35 TB/s. The design streams float4 vectors in
// one grid-stride launch over all ranks; carrying the fire bits as f32
// per position is what the TPU kernel took and costs a third of the
// bytes (bits or a per-leaf lookup is later work).
#include "common.cuh"

namespace {

__global__ void masked_wire_kernel(const float* __restrict__ flat,
                                   const float* __restrict__ fire,
                                   float* __restrict__ out, int64_t n,
                                   int vec) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n / 4;
    for (int64_t i = tid; i < n4; i += stride) {
      float4 f = eg::ld4(flat, i), b = eg::ld4(fire, i), o;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        eg::set_lane(o, j, eg::lane(b, j) > 0.f ? eg::lane(f, j) : 0.f);
      eg::st4(out, i, o);
    }
    done = n4 * 4;
  }
  for (int64_t i = done + tid; i < n; i += stride)
    out[i] = fire[i] > 0.f ? flat[i] : 0.f;
}

}  // namespace

extern "C" int eg_masked_wire(const float* flat, const float* fire, float* out,
                              int64_t n, int vec, void* stream) {
  if (n <= 0) return 0;
  const int64_t work = vec ? n / 4 + 1 : n;
  masked_wire_kernel<<<eg::grid_for(work), eg::kThreads, 0,
                       (cudaStream_t)stream>>>(flat, fire, out, n, vec);
  return (int)cudaGetLastError();
}

// --- the pitched (bucket) form -----------------------------------------
//
// out[b] = where(fire[b] > 0, flat[a], 0) over one bucket: `flat` is the
// [rows, ld] parameter arena read in place at columns [off, off + cols),
// `fire` and `out` the bucket's contiguous [rows, cols] arrays (common.cuh
// "the pitched forms"). Same bytes per element as the contiguous form.

namespace {

struct MaskBody {
  const float* flat;
  const float* fire;
  float* out;

  template <int W>
  __device__ __forceinline__ void at(int64_t a, int64_t b) const {
    const eg::Vec<float, W> f = eg::ldv<W>(flat + a), k = eg::ldv<W>(fire + b);
    eg::Vec<float, W> o;
#pragma unroll
    for (int q = 0; q < W; ++q) o.v[q] = k.v[q] > 0.f ? f.v[q] : 0.f;
    eg::stv<W>(out + b, o);
  }
};

__global__ void masked_wire_pitched_kernel(MaskBody body, eg::Pitch g,
                                           int vec) {
  eg::pitched_row(g, vec, body);
}

}  // namespace

extern "C" int eg_masked_wire_pitched(const float* flat, const float* fire,
                                      float* out, int64_t rows, int64_t cols,
                                      int64_t ld, int64_t off, int vec,
                                      void* stream) {
  const eg::Pitch g = {rows, cols, ld, off};
  if (!eg::pitch_ok(g)) return (int)cudaErrorInvalidValue;
  if (cols == 0) return 0;
  masked_wire_pitched_kernel<<<eg::grid_pitched(rows, cols), eg::kThreads, 0,
                               (cudaStream_t)stream>>>(
      MaskBody{flat, fire, out}, g, vec);
  return (int)cudaGetLastError();
}
