// Fused gossip-mix + momentum-SGD over the flat arena (the D-PSGD tail).
//
// Replaces the TPU kernel eventgrad_tpu/ops/fused_update.py:_kernel
// (launched by _fused_leaf, entry fused_mix_sgd). Per element, in the
// JAX kernel's order:
//
//   mixed = (p + buf_sum) * w
//   t'    = mom * t + g
//   p'    = mixed - lr * t'
//
// Bound on the card: bytes. It reads p, buf_sum, g, t and writes p', t':
// 24 B/elem, about 3.35 GB for the flagship Ring(8) ResNet-18 step
// (8 x 17,444,682 elements), i.e. about 1.00 ms at 3.35 TB/s. One
// grid-stride float4 stream over all ranks. The neighbor sum is formed
// outside, as in the JAX step (folding it in, reading the neighbor
// buffers directly, is later work).
//
// The gated form (D-PSGD under drops, death and freeze) takes one
// per-row operand, w_rows (f32 [R]: the mix weight 1/(1 + n_alive) of
// each rank, whose gated edges the caller already left out of buf_sum):
// mixed = (p + buf_sum) * w_r. It runs over the [R, n] arena one grid
// row per rank (the pitched layout at offset 0), each block reading its
// row's weight once; with w_r = w it is bitwise the ungated form.
#include "common.cuh"

namespace {

__device__ __forceinline__ void sgd_elem(float p, float b, float g, float t,
                                         float lr, float mom, float w,
                                         float& po, float& to) {
  const float mixed = __fmul_rn(__fadd_rn(p, b), w);
  const float tr = __fadd_rn(__fmul_rn(mom, t), g);
  po = __fsub_rn(mixed, __fmul_rn(lr, tr));
  to = tr;
}

__global__ void mix_sgd_kernel(const float* __restrict__ p,
                               const float* __restrict__ b,
                               const float* __restrict__ g,
                               const float* __restrict__ t,
                               float* __restrict__ p_out,
                               float* __restrict__ t_out, int64_t n, float lr,
                               float mom, float w, int vec) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n / 4;
    for (int64_t i = tid; i < n4; i += stride) {
      const float4 pv = eg::ld4(p, i), bv = eg::ld4(b, i), gv = eg::ld4(g, i),
                   tv = eg::ld4(t, i);
      float4 pov, tov;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float po, to;
        sgd_elem(eg::lane(pv, q), eg::lane(bv, q), eg::lane(gv, q),
                 eg::lane(tv, q), lr, mom, w, po, to);
        eg::set_lane(pov, q, po);
        eg::set_lane(tov, q, to);
      }
      eg::st4(p_out, i, pov);
      eg::st4(t_out, i, tov);
    }
    done = n4 * 4;
  }
  for (int64_t i = done + tid; i < n; i += stride)
    sgd_elem(p[i], b[i], g[i], t[i], lr, mom, w, p_out[i], t_out[i]);
}

// the gated form's body: row r's elements at a = b = r * cols + j
struct SgdBody {
  const float* p;
  const float* b;
  const float* g;
  const float* t;
  float* p_out;
  float* t_out;
  float lr, mom, w;

  template <int W>
  __device__ __forceinline__ void at(int64_t a, int64_t) const {
    const eg::Vec<float, W> pv = eg::ldv<W>(p + a), bv = eg::ldv<W>(b + a),
                            gv = eg::ldv<W>(g + a), tv = eg::ldv<W>(t + a);
    eg::Vec<float, W> pov, tov;
#pragma unroll
    for (int q = 0; q < W; ++q)
      sgd_elem(pv.v[q], bv.v[q], gv.v[q], tv.v[q], lr, mom, w, pov.v[q],
               tov.v[q]);
    eg::stv<W>(p_out + a, pov);
    eg::stv<W>(t_out + a, tov);
  }
};

__global__ void mix_sgd_rows_kernel(SgdBody body, const float* w_rows,
                                    eg::Pitch pg, int vec) {
  body.w = w_rows[blockIdx.y];  // once per block, before the row
  eg::pitched_row(pg, vec, body);
}

}  // namespace

// n elements in all; with w_rows (the gated form) they are rows rows of
// n / rows, row r mixed with weight w_rows[r] (w unused), else one flat
// stream mixed with w.
extern "C" int eg_mix_sgd(const float* p, const float* b, const float* g,
                          const float* t, float* p_out, float* t_out,
                          int64_t n, float lr, float mom, float w,
                          int64_t rows, const float* w_rows, int vec,
                          void* stream) {
  if (n <= 0) return 0;
  if (w_rows) {
    if (rows < 1 || n % rows) return (int)cudaErrorInvalidValue;
    const eg::Pitch pg = {rows, n / rows, n / rows, 0};
    if (!eg::pitch_ok(pg)) return (int)cudaErrorInvalidValue;
    mix_sgd_rows_kernel<<<eg::grid_pitched(pg.rows, pg.cols), eg::kThreads,
                          0, (cudaStream_t)stream>>>(
        SgdBody{p, b, g, t, p_out, t_out, lr, mom, w}, w_rows, pg, vec);
    return (int)cudaGetLastError();
  }
  const int64_t work = vec ? n / 4 + 1 : n;
  mix_sgd_kernel<<<eg::grid_for(work), eg::kThreads, 0,
                   (cudaStream_t)stream>>>(p, b, g, t, p_out, t_out, n, lr,
                                           mom, w, vec);
  return (int)cudaGetLastError();
}
