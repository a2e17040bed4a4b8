// FlashAttention-2 backward, dK and dV: the score tiles are rebuilt from
// (q, k, lse) and never reach device memory.
//
// Replaces the TPU kernel eventgrad_tpu/ops/attention.py:_dkv_kernel
// (launched by _run_bwd). Per (batch, head, 64-row K/V tile), over the Q
// tiles qi:
//
//   s  = scale * (q_i k^T), invalid entries masked
//   p  = exp(s - lse) * valid
//   dV += p^T dO_i
//   dp = dO_i v^T
//   ds = p * (dp - delta) * scale
//   dK += ds^T q_i
//
// The Q sweep that was the TPU grid's sequential last dimension is the
// loop inside the block; dK and dV accumulate in registers, the K and V
// tiles stay in shared memory for the whole sweep. A causal block
// without offsets starts its sweep at the diagonal tile (earlier Q tiles
// see none of these keys); with offsets every tile is visited and the
// mask decides. Query rows past T are staged as zeros and masked, so
// they add nothing.
//
// Bound on the card: operations for float32 inputs (four products of
// 2*T*T*D flops per (batch, head), halved when causal), bytes for
// bfloat16. This first version runs float32 FMAs from shared memory for
// both types. dV and dK accumulate transposed (dV^T = dO^T p, dK^T =
// q^T ds), so both products read the same transposed q and dO tiles as
// the score products and nothing is staged twice: six tiles, 104 KB at
// D = 64, two blocks per SM.
#include "flash_common.cuh"

namespace {

using namespace egf;

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, const int* __restrict__ offs,
                     Strides st, Shape s, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* k_t = smem;                           // [DMAX][68]
  float* v_t = k_t + trans_floats(DMAX);       // [DMAX][68]
  float* q_t = v_t + trans_floats(DMAX);       // [DMAX][68]
  float* do_t = q_t + trans_floats(DMAX);      // [DMAX][68]
  float* p_s = do_t + trans_floats(DMAX);      // [64][68]
  float* ds_s = p_s + score_floats();          // [64][68]

  constexpr int RPT = DMAX / 16;  // head elements per thread
  const int nt = (s.t + kTile - 1) / kTile;
  const int kj = (int)(blockIdx.x % nt);  // the first K tile sweeps the most
  const int bh = blockIdx.x / nt;
  const int b = bh / s.h, hh = bh % s.h;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  int q_off, k_off;
  load_offsets(offs, s, b, q_off, k_off);
  const T* qp = q + b * st.v[0] + hh * st.v[2];
  const T* kp = k + b * st.v[3] + hh * st.v[5];
  const T* vp = v + b * st.v[6] + hh * st.v[8];
  const T* dop = dout + b * st.v[9] + hh * st.v[11];

  load_tile<T, DMAX, true, false>(kp, st.v[4], kj * kTile, s.t, s.d, 1.f,
                                  k_t, nullptr);
  load_tile<T, DMAX, true, false>(vp, st.v[7], kj * kTile, s.t, s.d, 1.f,
                                  v_t, nullptr);

  float acc_k[RPT][4] = {}, acc_v[RPT][4] = {};  // dK^T, dV^T patches

  const int q_begin = (s.causal && offs == nullptr) ? kj : 0;
  for (int qi = q_begin; qi < nt; ++qi) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, DMAX, true, false>(qp, st.v[1], qi * kTile, s.t, s.d, 1.f,
                                    q_t, nullptr);
    load_tile<T, DMAX, true, false>(dop, st.v[10], qi * kTile, s.t, s.d, 1.f,
                                    do_t, nullptr);
    __syncthreads();

    // score rows are Q rows (ty), score columns are K rows (tx)
    float sc[4][4] = {}, dp[4][4] = {};
    mma_tt2(q_t, k_t, do_t, v_t, s.d, ty, tx, sc, dp);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = qi * kTile + ty * 4 + i;
      const bool row_ok = qpos < s.t;
      const float lse_i = row_ok ? lse[(int64_t)bh * s.t + qpos] : 0.f;
      const float delta_i = row_ok ? delta[(int64_t)bh * s.t + qpos] : 0.f;
      float p[4], ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = row_ok && valid_at(qpos, kj * kTile + tx * 4 + j, s.t,
                                           s.causal, q_off, k_off);
        p[j] = ok ? expf(scale * sc[i][j] - lse_i) : 0.f;
        ds[j] = p[j] * (dp[i][j] - delta_i) * scale;
      }
      *reinterpret_cast<float4*>(p_s + (ty * 4 + i) * kLdT + tx * 4) =
          make_float4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<float4*>(ds_s + (ty * 4 + i) * kLdT + tx * 4) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();
    // reduce over the Q rows of the tile, into the transposed patches
    mma_ts<RPT>(do_t, p_s, ty, tx, acc_v);
    mma_ts<RPT>(q_t, ds_s, ty, tx, acc_k);
  }
  write_patch_t<T, RPT>(dk, s, b, hh, kj * kTile, ty, tx, acc_k);
  write_patch_t<T, RPT>(dv, s, b, hh, kj * kTile, ty, tx, acc_v);
}

template <typename T, int DMAX>
cudaError_t run(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dk, void* dv,
                const int* offs, const Strides& st, const Shape& s,
                void* stream) {
  constexpr size_t bytes =
      sizeof(float) * (4 * trans_floats(DMAX) + 2 * score_floats());
  const int64_t nt = (s.t + kTile - 1) / kTile;
  return launch_kernel(flash_dkv_kernel<T, DMAX>, nt * s.b * s.h, bytes,
                       stream, (const T*)q, (const T*)k, (const T*)v,
                       (const T*)dout, lse, delta, (T*)dk, (T*)dv, offs, st, s,
                       softmax_scale(s.d));
}

}  // namespace

// q, k, v, dout: [B, T, H, D] read through `strides` (batch, time, head
// of each, in that order); lse, delta: contiguous f32 [B, H, T]; dk, dv:
// contiguous [B, T, H, D]; offs: int32 [n_off, 2] on the device, or NULL;
// dtype 0 = float32, 1 = bfloat16.
extern "C" int eg_flash_dkv(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dk, void* dv,
                            const int* offs, const int64_t* strides, int b,
                            int t, int h, int d, int n_off, int per,
                            int causal, int dtype, void* stream) {
  const Shape s{b, t, h, d, n_off, per, causal};
  if (!shape_ok(s, offs)) return (int)cudaErrorInvalidValue;
  const Strides st = strides_from(strides, 4);
  return (int)EGF_DISPATCH(dtype, d, run, q, k, v, dout, lse, delta, dk, dv,
                           offs, st, s, stream);
}
