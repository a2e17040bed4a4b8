// FlashAttention-2 backward, dQ: the score tiles are rebuilt from
// (q, k, lse) and never reach device memory.
//
// Replaces the TPU kernel eventgrad_tpu/ops/attention.py:_dq_kernel
// (launched by _run_bwd). Per (batch, head, 64-row Q tile), over the K/V
// tiles kj:
//
//   s  = (q * scale) k_j^T, invalid entries masked
//   p  = exp(s - lse) * valid
//   dp = dO v_j^T
//   ds = p * (dp - delta) * scale
//   dQ += ds k_j
//
// delta = rowsum(dO * O) - dlse comes in precomputed, as on the TPU. The
// K sweep that was the TPU grid's sequential last dimension is the loop
// inside the block; dQ accumulates in registers. s and dp share one loop
// over the head dimension. A causal block without offsets stops at the
// diagonal tile; with offsets every tile is visited and the mask
// decides.
//
// Bound on the card: operations for float32 inputs (three products of
// 2*T*T*D flops per (batch, head), halved when causal), bytes for
// bfloat16. This first version runs float32 FMAs from shared memory for
// both types, as the forward does.
#include "flash_common.cuh"

namespace {

using namespace egf;

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    const int* __restrict__ offs, Strides st, Shape s,
                    float scale) {
  extern __shared__ __align__(16) float smem[];
  float* q_t = smem;                           // [DMAX][68], q * scale
  float* do_t = q_t + trans_floats(DMAX);      // [DMAX][68]
  float* k_t = do_t + trans_floats(DMAX);      // [DMAX][68]
  float* v_t = k_t + trans_floats(DMAX);       // [DMAX][68]
  float* k_r = v_t + trans_floats(DMAX);       // [64][DMAX+8]
  float* ds_s = k_r + rows_floats(DMAX);       // [64][68]

  using C = Cols<DMAX>;
  const int nt = (s.t + kTile - 1) / kTile;
  const int qi = nt - 1 - (int)(blockIdx.x % nt);
  const int bh = blockIdx.x / nt;
  const int b = bh / s.h, hh = bh % s.h;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  int q_off, k_off;
  load_offsets(offs, s, b, q_off, k_off);
  const T* qp = q + b * st.v[0] + hh * st.v[2];
  const T* kp = k + b * st.v[3] + hh * st.v[5];
  const T* vp = v + b * st.v[6] + hh * st.v[8];
  const T* dop = dout + b * st.v[9] + hh * st.v[11];

  load_tile<T, DMAX, true, false>(qp, st.v[1], qi * kTile, s.t, s.d, scale,
                                  q_t, nullptr);
  load_tile<T, DMAX, true, false>(dop, st.v[10], qi * kTile, s.t, s.d, 1.f,
                                  do_t, nullptr);

  float lse_r[4], delta_r[4], acc[4][C::CW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = qi * kTile + ty * 4 + i;
    lse_r[i] = row < s.t ? lse[(int64_t)bh * s.t + row] : 0.f;
    delta_r[i] = row < s.t ? delta[(int64_t)bh * s.t + row] : 0.f;
#pragma unroll
    for (int c = 0; c < C::CW; ++c) acc[i][c] = 0.f;
  }

  const int k_end = (s.causal && offs == nullptr) ? qi : nt - 1;
  for (int kj = 0; kj <= k_end; ++kj) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, DMAX, true, true>(kp, st.v[4], kj * kTile, s.t, s.d, 1.f,
                                   k_t, k_r);
    load_tile<T, DMAX, true, false>(vp, st.v[7], kj * kTile, s.t, s.d, 1.f,
                                    v_t, nullptr);
    __syncthreads();

    float sc[4][4] = {}, dp[4][4] = {};
    mma_tt2(q_t, k_t, do_t, v_t, s.d, ty, tx, sc, dp);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = qi * kTile + ty * 4 + i;
      float ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = valid_at(qpos, kj * kTile + tx * 4 + j, s.t, s.causal,
                                 q_off, k_off);
        const float p = ok ? expf(sc[i][j] - lse_r[i]) : 0.f;
        ds[j] = p * (dp[i][j] - delta_r[i]) * scale;
      }
      *reinterpret_cast<float4*>(ds_s + (ty * 4 + i) * kLdT + tx * 4) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();
    mma_pn<DMAX>(ds_s, k_r, ty, tx, acc);
  }
  write_patch<T, DMAX>(dq, s, b, hh, qi * kTile, ty, tx, acc);
}

template <typename T, int DMAX>
cudaError_t run(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dq,
                const int* offs, const Strides& st, const Shape& s,
                void* stream) {
  constexpr size_t bytes =
      sizeof(float) * (4 * trans_floats(DMAX) + rows_floats(DMAX) +
                       score_floats());
  const int64_t nt = (s.t + kTile - 1) / kTile;
  return launch_kernel(flash_dq_kernel<T, DMAX>, nt * s.b * s.h, bytes,
                       stream, (const T*)q, (const T*)k, (const T*)v,
                       (const T*)dout, lse, delta, (T*)dq, offs, st, s,
                       softmax_scale(s.d));
}

}  // namespace

// q, k, v, dout: [B, T, H, D] read through `strides` (batch, time, head
// of each, in that order); lse, delta: contiguous f32 [B, H, T]; dq:
// contiguous [B, T, H, D]; offs: int32 [n_off, 2] on the device, or NULL;
// dtype 0 = float32, 1 = bfloat16.
extern "C" int eg_flash_dq(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, void* dq, const int* offs,
                           const int64_t* strides, int b, int t, int h, int d,
                           int n_off, int per, int causal, int dtype,
                           void* stream) {
  const Shape s{b, t, h, d, n_off, per, causal};
  if (!shape_ok(s, offs)) return (int)cudaErrorInvalidValue;
  const Strides st = strides_from(strides, 4);
  return (int)EGF_DISPATCH(dtype, d, run, q, k, v, dout, lse, delta, dq, offs,
                           st, s, stream);
}
