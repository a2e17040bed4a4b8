// FlashAttention-2 forward: out = softmax(q k^T / sqrt(D) + mask) v and
// the row logsumexp, with the scores kept on chip.
//
// Replaces the TPU kernel eventgrad_tpu/ops/attention.py:_fwd_kernel
// (launched by _run_fwd; entries flash_attention, flash_attention_lse).
// Per (batch, head, 64-row Q tile), over the K/V tiles kj:
//
//   s      = (q * scale) k_j^T, invalid entries set to -1e30
//   m'     = max(m, rowmax(s));  p = exp(s - m') * valid
//   l      = l * exp(m - m') + rowsum(p)
//   acc    = acc * exp(m - m') + p v_j
//   out    = acc / max(l, 1e-30);  lse = m + log(max(l, 1e-30))
//
// valid = (kpos < T) and, when causal, (q_off + qpos >= k_off + kpos). A
// fully masked row ends with out = 0 and lse near -1e30, never NaN.
//
// What the TPU kernel's grid did in sequence (the K sweep as the last
// grid dimension, m/l/acc carried in scratch) is the loop inside the
// block here; m, l and acc live in registers. A causal block without
// offsets stops its sweep at the diagonal tile; with offsets the
// diagonal depends on the data, so every tile is visited and the mask
// decides. The heaviest blocks come first in the grid (the last Q tile
// sweeps the most K tiles).
//
// Bound on the card: operations for float32 inputs (two products of
// 2*T*T*D flops per (batch, head), halved when causal, against the
// float32 FMA rate), bytes for bfloat16 inputs (q, k, v read and out
// written once against the tensor-core rate). This first version runs
// every product as float32 FMAs from shared memory for both types; it
// uses no tensor cores, no asynchronous copies and no double buffering.
#include "flash_common.cuh"

namespace {

using namespace egf;

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, const int* __restrict__ offs,
                     Strides st, Shape s, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* q_t = smem;                          // [DMAX][68], q * scale
  float* k_t = q_t + trans_floats(DMAX);      // [DMAX][68]
  float* v_r = k_t + trans_floats(DMAX);      // [64][DMAX+8]
  float* p_s = v_r + rows_floats(DMAX);       // [64][68]

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

  load_tile<T, DMAX, true, false>(qp, st.v[1], qi * kTile, s.t, s.d, scale,
                                  q_t, nullptr);

  float m[4], l[4], acc[4][C::CW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C::CW; ++c) acc[i][c] = 0.f;
  }

  const int k_end = (s.causal && offs == nullptr) ? qi : nt - 1;
  for (int kj = 0; kj <= k_end; ++kj) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, DMAX, true, false>(kp, st.v[4], kj * kTile, s.t, s.d, 1.f,
                                    k_t, nullptr);
    load_tile<T, DMAX, false, true>(vp, st.v[7], kj * kTile, s.t, s.d, 1.f,
                                    nullptr, v_r);
    __syncthreads();

    float sc[4][4] = {};
    mma_tt(q_t, k_t, s.d, ty, tx, sc);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = qi * kTile + ty * 4 + i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ok[j] = valid_at(qpos, kj * kTile + tx * 4 + j, s.t, s.causal, q_off,
                         k_off);
        sc[i][j] = ok[j] ? sc[i][j] : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float p[4], sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = ok[j] ? expf(sc[i][j] - m_new) : 0.f;  // masked p is exactly 0
        sum += p[j];
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < C::CW; ++c) acc[i][c] *= corr;
      *reinterpret_cast<float4*>(p_s + (ty * 4 + i) * kLdT + tx * 4) =
          make_float4(p[0], p[1], p[2], p[3]);
    }
    __syncthreads();
    mma_pn<DMAX>(p_s, v_r, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float l_safe = fmaxf(l[i], kLFloor);
#pragma unroll
    for (int c = 0; c < C::CW; ++c) acc[i][c] = acc[i][c] / l_safe;
    const int row = qi * kTile + ty * 4 + i;
    if (tx == 0 && row < s.t)
      lse[(int64_t)bh * s.t + row] = m[i] + logf(l_safe);
  }
  write_patch<T, DMAX>(out, s, b, hh, qi * kTile, ty, tx, acc);
}

template <typename T, int DMAX>
cudaError_t run(const void* q, const void* k, const void* v, void* out,
                float* lse, const int* offs, const Strides& st,
                const Shape& s, void* stream) {
  constexpr size_t bytes =
      sizeof(float) * (2 * trans_floats(DMAX) + rows_floats(DMAX) +
                       score_floats());
  const int64_t nt = (s.t + kTile - 1) / kTile;
  return launch_kernel(flash_fwd_kernel<T, DMAX>, nt * s.b * s.h, bytes,
                       stream, (const T*)q, (const T*)k, (const T*)v, (T*)out,
                       lse, offs, st, s, softmax_scale(s.d));
}

}  // namespace

// q, k, v: [B, T, H, D] read through `strides` (batch, time, head of q,
// then k, then v; head dimension contiguous); out: contiguous
// [B, T, H, D]; lse: contiguous f32 [B, H, T]; offs: int32 [n_off, 2] on
// the device, or NULL; dtype 0 = float32, 1 = bfloat16.
extern "C" int eg_flash_fwd(const void* q, const void* k, const void* v,
                            void* out, float* lse, const int* offs,
                            const int64_t* strides, int b, int t, int h, int d,
                            int n_off, int per, int causal, int dtype,
                            void* stream) {
  const Shape s{b, t, h, d, n_off, per, causal};
  if (!shape_ok(s, offs)) return (int)cudaErrorInvalidValue;
  const Strides st = strides_from(strides, 3);
  return (int)EGF_DISPATCH(dtype, d, run, q, k, v, out, lse, offs, st, s,
                           stream);
}
