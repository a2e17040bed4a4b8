// FlashAttention-2 backward, dK and dV: the score tiles are rebuilt from
// (q, k, lse) and never reach device memory.
//
// Replaces the TPU kernel eventgrad_tpu/ops/attention.py:_dkv_kernel
// (launched by _run_bwd). Per (batch, head, 64-row K/V tile), over the Q
// tiles qi, in the transposed orientation (rows are keys):
//
//   s^T  = scale * (k q_i^T), invalid entries masked
//   p^T  = exp(s^T - lse_i) * valid
//   dV  += p^T dO_i
//   dp^T = v dO_i^T
//   ds^T = p^T * (dp^T - delta_i) * scale
//   dK  += ds^T q_i
//
// The Q sweep that was the TPU grid's sequential last dimension is the
// loop inside the block. Four warps each own 16 keys: their score tiles
// come out of the products (flash_mma.cuh: mma.sync on bf16, 3xTF32 on
// float32) already transposed, so p^T and ds^T are the left operands of
// the dV and dK products straight from their accumulators, and nothing
// of p or ds goes through shared memory. dK and dV accumulate in
// registers; the K and V tiles stay in shared memory for the whole
// sweep. Q, dO, lse and delta tiles come through cp.async in a two-stage
// ring: tile i + 1 loads while tile i is computed, one barrier per tile.
//
// At DMAX = 128 one warp cannot hold it all: dK and dV of 16 keys take
// 16 x 128 x 2 / 32 = 128 accumulator registers a thread, beside the 64
// of s^T and dp^T (and the hi/lo operand splits of float32). So the D
// axis is split between warps: eight warps, two to each 16 keys, and
// each warp of a pair owns one 64-column half of dK and dV (64
// accumulator registers, as at DMAX = 64). Both warps of a pair compute
// s^T and dp^T over the full D, which repeats two of the four products,
// and no score crosses shared memory: each warp keeps feeding p^T and
// ds^T from its own accumulators. Every dK/dV element is still summed
// by one warp in the same order as without the split.
//
// A causal block sweeps only the Q tiles that can hold a valid entry for
// one of its keys: from the tile of query k_off - q_off + (first key of
// the tile) on, the diagonal tile without offsets, none for a ring hop
// that lies wholly in the future. A skipped tile would have added
// exactly 0 (its p and ds are 0). Query rows past T are staged as zeros
// and masked. The heaviest blocks (the first K tiles of every (batch,
// head), which sweep the most) come first in the grid, then the next
// heaviest, so the tail of the launch holds the short sweeps.
//
// Bound on the card: operations at the main shape (four products of
// 2*T*T*D flops per (batch, head), halved when causal: the tensor cores'
// bf16 rate, or three TF32 products each for float32), against q, k, v,
// dO, lse, delta read and dK, dV written once.
#include "flash_mma.cuh"

namespace {

using namespace egf;

// Warps sharing one 16-key row block, each owning DMAX / split of the
// dK/dV columns
template <int DMAX>
__host__ __device__ constexpr int dkv_split() {
  return DMAX > 64 ? 2 : 1;
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kBlock * dkv_split<DMAX>())
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, const int* __restrict__ offs,
                     Strides st, Shape s, float scale, int vec) {
  using M = Tc<T>;
  using G = Tile<T, DMAX>;
  constexpr int kSplit = dkv_split<DMAX>();
  constexpr int kThreads = kBlock * kSplit;
  constexpr int kLd = G::kLd;
  constexpr int kNs = kRows / 8;        // n8 tiles of a score row block
  constexpr int kNo = DMAX / 8 / kSplit;  // n8 tiles of a warp's dK/dV
  constexpr int kKd = DMAX / M::kK;     // k steps over the head dimension
  constexpr int kKq = kRows / M::kK;    // k steps over the Q tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);  // [64][kLd]
  T* v_s = k_s + G::kElems;
  T* q_s = v_s + G::kElems;                 // two stages
  T* do_s = q_s + 2 * G::kElems;            // two stages
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * G::kElems);  // 2 x 64
  float* dl_s = lse_s + 2 * kRows;                                // 2 x 64

  const int nt = (s.t + kRows - 1) / kRows;
  const int bhn = s.b * s.h;
  const int kj = (int)(blockIdx.x / bhn);
  const int bh = (int)(blockIdx.x % bhn);
  const int b = bh / s.h, hh = bh % s.h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int kw = warp / kSplit;  // this warp's block of 16 keys
  const int col0 = (warp % kSplit) * (DMAX / kSplit);  // its dK/dV columns

  int q_off, k_off;
  load_offsets(offs, s, b, q_off, k_off);
  const T* qp = q + b * st.v[0] + hh * st.v[2];
  const T* kp = k + b * st.v[3] + hh * st.v[5];
  const T* vp = v + b * st.v[6] + hh * st.v[8];
  const T* dop = dout + b * st.v[9] + hh * st.v[11];
  const float* lse_p = lse + (int64_t)bh * s.t;
  const float* dl_p = delta + (int64_t)bh * s.t;

  // the first Q tile with a query that may see some key of this K tile
  int q_begin = 0;
  if (s.causal) {
    const int first_query = k_off - q_off + kj * kRows;
    q_begin = first_query <= 0 ? 0 : min(nt, first_query / kRows);
  }

  auto load_q_tile = [&](int qi, int stage) {
    load_tile_async<T, DMAX, kThreads>(q_s + stage * G::kElems, qp, st.v[1],
                                       qi * kRows, s.t, s.d, vec);
    load_tile_async<T, DMAX, kThreads>(do_s + stage * G::kElems, dop,
                                       st.v[10], qi * kRows, s.t, s.d, vec);
    load_vec_async(lse_s + stage * kRows, lse_p, qi * kRows, s.t);
    load_vec_async(dl_s + stage * kRows, dl_p, qi * kRows, s.t);
  };
  if (q_begin < nt) {
    load_tile_async<T, DMAX, kThreads>(k_s, kp, st.v[4], kj * kRows, s.t,
                                       s.d, vec);
    load_tile_async<T, DMAX, kThreads>(v_s, vp, st.v[7], kj * kRows, s.t,
                                       s.d, vec);
    load_q_tile(q_begin, 0);
  }
  cp_async_commit();

  const int key0 = kj * kRows + kw * 16;  // this warp's first key
  const float c = scale * kLog2e;
  float acc_k[kNo][4], acc_v[kNo][4];
#pragma unroll
  for (int n = 0; n < kNo; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  for (int qi = q_begin; qi < nt; ++qi) {
    const int cur = (qi - q_begin) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile qi is in; every warp is done with tile qi - 1
    if (qi + 1 < nt) load_q_tile(qi + 1, cur ^ 1);
    cp_async_commit();
    const T* qs = q_s + cur * G::kElems;
    const T* dos = do_s + cur * G::kElems;
    const float* lse_t = lse_s + cur * kRows;
    const float* dl_t = dl_s + cur * kRows;

    // s^T = k q^T and dp^T = v dO^T over the full D: rows are this
    // warp's 16 keys, columns the 64 queries of the tile
    float sc[kNs][4], dp[kNs][4];
#pragma unroll
    for (int n = 0; n < kNs; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < kKd; ++kc) {
      const typename M::A ka = M::load_a(k_s, kLd, kw * 16, kc * M::kK, lane);
      const typename M::A va = M::load_a(v_s, kLd, kw * 16, kc * M::kK, lane);
#pragma unroll
      for (int n = 0; n < kNs; n += 2) {
        typename M::B b0, b1;
        M::load_bt2(b0, b1, qs, kLd, n * 8, kc * M::kK, lane);
        M::mma(sc[n], ka, b0);
        M::mma(sc[n + 1], ka, b1);
        M::load_bt2(b0, b1, dos, kLd, n * 8, kc * M::kK, lane);
        M::mma(dp[n], va, b0);
        M::mma(dp[n + 1], va, b1);
      }
    }

    // p^T and ds^T in place; lane holds keys g (e < 2) and g + 8 (e >= 2),
    // queries 8n + 2tq + (e & 1). p = 2^(c s - log2(e) lse), c = scale *
    // log2(e); a masked score is -inf, so its p and ds are exactly 0.
    // Only tiles that cross the causal diagonal or the end of T are masked.
    const int qrow0 = qi * kRows;
    const bool full = qrow0 + kRows <= s.t && key0 + 16 <= s.t &&
                      (!s.causal || q_off + qrow0 >= k_off + key0 + 15);
    if (!full) {
#pragma unroll
      for (int n = 0; n < kNs; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qpos = qrow0 + n * 8 + 2 * tq + (e & 1);
          if (qpos >= s.t || !valid_at(qpos, key0 + g + 8 * (e >> 1), s.t,
                                       s.causal, q_off, k_off))
            sc[n][e] = -INFINITY;
        }
    }
#pragma unroll
    for (int n = 0; n < kNs; ++n)
#pragma unroll
      for (int j2 = 0; j2 < 2; ++j2) {
        const int col = n * 8 + 2 * tq + j2;
        const float lse_c = lse_t[col] * kLog2e, dl = dl_t[col];
#pragma unroll
        for (int e = j2; e < 4; e += 2) {
          const float p = fast_exp2(fmaf(sc[n][e], c, -lse_c));
          sc[n][e] = p;
          dp[n][e] = p * (dp[n][e] - dl) * scale;
        }
      }

    // dV += p^T dO and dK += ds^T q in this warp's columns, reducing
    // over the tile's queries
#pragma unroll
    for (int kc = 0; kc < kKq; ++kc) {
      const typename M::A pa = M::from_acc(sc, kc);
      const typename M::A da = M::from_acc(dp, kc);
#pragma unroll
      for (int n = 0; n < kNo; n += 2) {
        typename M::B b0, b1;
        M::load_b2(b0, b1, dos, kLd, kc * M::kK, col0 + n * 8, lane);
        M::mma(acc_v[n], pa, b0);
        M::mma(acc_v[n + 1], pa, b1);
        M::load_b2(b0, b1, qs, kLd, kc * M::kK, col0 + n * 8, lane);
        M::mma(acc_k[n], da, b0);
        M::mma(acc_k[n + 1], da, b1);
      }
    }
  }
  cp_async_wait_all();  // nothing left in flight when the block exits

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = key0 + g + 8 * i;
    if (row >= s.t) continue;
    const int64_t at = (((int64_t)b * s.t + row) * s.h + hh) * s.d;
#pragma unroll
    for (int n = 0; n < kNo; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = col0 + n * 8 + 2 * tq + c;
        if (col < s.d) {
          store(dk + at + col, acc_k[n][2 * i + c]);
          store(dv + at + col, acc_v[n][2 * i + c]);
        }
      }
  }
}

template <typename T, int DMAX>
cudaError_t run(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dk, void* dv,
                const int* offs, const Strides& st, const Shape& s,
                void* stream) {
  // k, v, 2 x q, 2 x dO, 2 x (lse, delta)
  constexpr size_t bytes =
      6 * Tile<T, DMAX>::kBytes + 4 * kRows * sizeof(float);
  const void* ptrs[4] = {q, k, v, dout};
  const int vec = rows_aligned16(ptrs, st, 4, sizeof(T));
  const int64_t nt = (s.t + kRows - 1) / kRows;
  constexpr int threads = kBlock * dkv_split<DMAX>();
  return launch_kernel<threads>(flash_dkv_kernel<T, DMAX>, nt * s.b * s.h,
                                bytes, stream, (const T*)q, (const T*)k,
                                (const T*)v, (const T*)dout, lse, delta,
                                (T*)dk, (T*)dv, offs, st, s,
                                softmax_scale(s.d), vec);
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
