// int8 masked-wire builder over the flat arena:
//
//   out = clip(round_half_even(where(fire > 0, flat, 0) / scale), -127, 127)
//
// emitted as f32 (the caller casts to int8 at the ship site, as the JAX
// step does). Replaces the TPU kernel
// eventgrad_tpu/ops/event_engine.py:_mask_quant_kernel (launched by
// _masked_wire_pallas with a scale_exp). The division is __fdiv_rn (IEEE,
// never a reciprocal multiply), the rounding rintf (half to even, as
// torch.round and jnp.round), and the clip a pair of compares that keeps
// a NaN, as torch.clamp and jnp.clip do; the sign of a zero survives.
//
// Bound on the card: bytes. Per element it reads flat, the per-position
// fire bit and the per-position scale (f32 each) and writes out (f32):
// 16 B/elem, about 2.23 GB for the flagship Ring(8) ResNet-18 step
// (8 x 17,444,682 elements), i.e. about 0.67 ms at 3.35 TB/s. The design
// is the masked-wire kernel's: one grid-stride float4 stream over all
// ranks. The per-position f32 fire bits and scales are half the bytes
// (a per-leaf lookup, and an int8 output, are later work).
#include "common.cuh"

namespace {

__device__ __forceinline__ float quant(float f, float b, float s) {
  const float q = rintf(__fdiv_rn(b > 0.f ? f : 0.f, s));
  return q < -127.f ? -127.f : (q > 127.f ? 127.f : q);
}

__global__ void mask_quant_kernel(const float* __restrict__ flat,
                                  const float* __restrict__ fire,
                                  const float* __restrict__ scale,
                                  float* __restrict__ out, int64_t n,
                                  int vec) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n / 4;
    for (int64_t i = tid; i < n4; i += stride) {
      const float4 f = eg::ld4(flat, i), b = eg::ld4(fire, i),
                   s = eg::ld4(scale, i);
      float4 o;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        eg::set_lane(o, j, quant(eg::lane(f, j), eg::lane(b, j),
                                 eg::lane(s, j)));
      eg::st4(out, i, o);
    }
    done = n4 * 4;
  }
  for (int64_t i = done + tid; i < n; i += stride)
    out[i] = quant(flat[i], fire[i], scale[i]);
}

}  // namespace

extern "C" int eg_mask_quant(const float* flat, const float* fire,
                             const float* scale, float* out, int64_t n,
                             int vec, void* stream) {
  if (n <= 0) return 0;
  const int64_t work = vec ? n / 4 + 1 : n;
  mask_quant_kernel<<<eg::grid_for(work), eg::kThreads, 0,
                      (cudaStream_t)stream>>>(flat, fire, scale, out, n, vec);
  return (int)cudaGetLastError();
}

// --- the pitched (bucket) form -----------------------------------------
//
// The int8 masked wire of one bucket: `flat` is the [rows, ld] parameter
// arena read in place at columns [off, off + cols); `fire`, `scale` and
// `out` are the bucket's contiguous [rows, cols] arrays (common.cuh "the
// pitched forms"). Same bytes per element as the contiguous form.

namespace {

struct QuantBody {
  const float* flat;
  const float* fire;
  const float* scale;
  float* out;

  template <int W>
  __device__ __forceinline__ void at(int64_t a, int64_t b) const {
    const eg::Vec<float, W> f = eg::ldv<W>(flat + a), k = eg::ldv<W>(fire + b),
                            s = eg::ldv<W>(scale + b);
    eg::Vec<float, W> o;
#pragma unroll
    for (int q = 0; q < W; ++q) o.v[q] = quant(f.v[q], k.v[q], s.v[q]);
    eg::stv<W>(out + b, o);
  }
};

__global__ void mask_quant_pitched_kernel(QuantBody body, eg::Pitch g,
                                          int vec) {
  eg::pitched_row(g, vec, body);
}

}  // namespace

extern "C" int eg_mask_quant_pitched(const float* flat, const float* fire,
                                     const float* scale, float* out,
                                     int64_t rows, int64_t cols, int64_t ld,
                                     int64_t off, int vec, void* stream) {
  const eg::Pitch g = {rows, cols, ld, off};
  if (!eg::pitch_ok(g)) return (int)cudaErrorInvalidValue;
  if (cols == 0) return 0;
  mask_quant_pitched_kernel<<<eg::grid_pitched(rows, cols), eg::kThreads, 0,
                              (cudaStream_t)stream>>>(
      QuantBody{flat, fire, scale, out}, g, vec);
  return (int)cudaGetLastError();
}
