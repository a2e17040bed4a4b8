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
// This file holds the mma.sync form and the C entry point, which picks
// the form by shape (flash_base.cuh's flash_form): bfloat16 at D = 64,
// 128 and 256 on TMA-readable rows runs flash_dkv_wgmma.cu, float32 at
// D = 256 flash_dkv_whole.cu, everything else the kernel below.
//
// Head widths above 128 (WIDE, flash_mma.cuh): a block owns one
// 128-column chunk of dK and dV, split between its warp pairs as at
// DMAX = 128. For each Q tile it streams (k, v, q, dO) chunks through
// s^T and dp^T (k and v are re-read per Q tile: they no longer fit
// beside the ring), and with the last chunk the q and dO tiles of its
// columns, lse and delta. s^T and dp^T are rebuilt by both warps of a
// pair and once per output chunk: at D = 256 the work is 2 x 2 x (k q^T
// + v dO^T) + p^T dO + ds^T q, ten products of the width where four
// would do (DMAX = 128: six). float32 keeps one stage (203,264 bytes
// with the column tiles, lse and delta), bfloat16 two (174,592). ptxas
// (the H100 build of chip_smoke.py): float32 254 registers with 8 bytes
// of spill stores and 16 of spill loads, bfloat16 244 registers and no
// spills.
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

// Stages of the copy ring: DMAX <= 128 double-buffers (q, dO, lse,
// delta) (k and v stay resident); wide, a stage is (k, v, q, dO) chunks,
// two where they fit beside the q and dO tiles of this block's dK/dV
// columns and lse and delta (bfloat16), else one (float32)
template <typename T, int DMAX, bool WIDE>
__host__ __device__ constexpr int dkv_slots() {
  return WIDE ? ring_slots(4 * Tile<T, DMAX>::kBytes,
                           2 * Tile<T, DMAX>::kBytes + 2 * kRows * 4)
              : 2;
}

template <typename T, int DMAX, bool WIDE>
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
  constexpr int kE = G::kElems;
  constexpr int kSlots = dkv_slots<T, DMAX, WIDE>();
  constexpr int kNs = kRows / 8;        // n8 tiles of a score row block
  constexpr int kNo = DMAX / 8 / kSplit;  // n8 tiles of a warp's dK/dV
  constexpr int kKd = DMAX / M::kK;     // k steps over a head-dim chunk
  constexpr int kKq = kRows / M::kK;    // k steps over the Q tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // DMAX <= 128: k, v [64][kLd], then two stages of q, two of dO, then
  // two of (lse, delta) [64] each. Wide: kSlots stages of (k, v, q, dO)
  // chunks, then the q and dO tiles of this block's dK/dV columns, then
  // lse and delta of the Q tile
  T* const smem = reinterpret_cast<T*>(smem_raw);
  T* const ring = WIDE ? smem : smem + 2 * kE;  // the stages
  float* const vecs = reinterpret_cast<float*>(
      WIDE ? ring + (4 * kSlots + 2) * kE : ring + 4 * kE);

  // wide: ceil(d / 128) chunks of the head dimension, this block's dK/dV
  // chunk innermost in the grid
  const int nch = WIDE ? (s.d + DMAX - 1) / DMAX : 1;
  const int oc = WIDE ? (int)(blockIdx.x % nch) : 0;
  const unsigned blk = WIDE ? blockIdx.x / nch : blockIdx.x;
  const int nt = (s.t + kRows - 1) / kRows;
  const int bhn = s.b * s.h;
  const int kj = (int)(blk / bhn);
  const int bh = (int)(blk % bhn);
  const int b = bh / s.h, hh = bh % s.h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int kw = warp / kSplit;  // this warp's block of 16 keys
  const int col0 = (warp % kSplit) * (DMAX / kSplit);  // its dK/dV columns
  const int c_out = oc * DMAX + col0;  // ... of the head dimension

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

  // DMAX <= 128: k and v stay, (q, dO, lse, delta) tiles come through
  // the two-stage ring
  T* const k_s = smem;
  T* const v_s = smem + kE;
  T* const q_s = ring;                        // two stages
  T* const do_s = ring + 2 * kE;              // two stages
  float* const lse_s = vecs;                  // 2 x 64
  float* const dl_s = vecs + 2 * kRows;       // 2 x 64
  auto load_q_tile = [&](int qi, int stage) {
    load_tile_async<T, DMAX, kThreads>(q_s + stage * kE, qp, st.v[1],
                                       qi * kRows, s.t, s.d, vec);
    load_tile_async<T, DMAX, kThreads>(do_s + stage * kE, dop, st.v[10],
                                       qi * kRows, s.t, s.d, vec);
    load_vec_async(lse_s + stage * kRows, lse_p, qi * kRows, s.t);
    load_vec_async(dl_s + stage * kRows, dl_p, qi * kRows, s.t);
  };
  // wide: step i is Q tile q_begin + i / nch, head-dimension chunk i %
  // nch, in stage i % kSlots as (k, v, q, dO) chunks; the q and dO tiles
  // of this block's dK/dV columns, lse and delta come with the last
  // chunk. With one stage each step loads after the last is computed.
  T* const q_out = ring + 4 * kSlots * kE;
  T* const do_out = q_out + kE;
  const int n_steps = (nt - q_begin) * nch;
  auto stage = [&](int step) {
    const int qi = q_begin + step / nch, dc = step % nch;
    T* const base = ring + 4 * (kSlots == 2 ? step & 1 : 0) * kE;
    load_tile_async<T, DMAX, kThreads>(base, kp, st.v[4], kj * kRows, s.t,
                                       s.d, vec, dc * DMAX);
    load_tile_async<T, DMAX, kThreads>(base + kE, vp, st.v[7], kj * kRows,
                                       s.t, s.d, vec, dc * DMAX);
    load_tile_async<T, DMAX, kThreads>(base + 2 * kE, qp, st.v[1],
                                       qi * kRows, s.t, s.d, vec, dc * DMAX);
    load_tile_async<T, DMAX, kThreads>(base + 3 * kE, dop, st.v[10],
                                       qi * kRows, s.t, s.d, vec, dc * DMAX);
    if (dc == nch - 1) {
      load_tile_async<T, DMAX, kThreads>(q_out, qp, st.v[1], qi * kRows, s.t,
                                         s.d, vec, oc * DMAX);
      load_tile_async<T, DMAX, kThreads>(do_out, dop, st.v[10], qi * kRows,
                                         s.t, s.d, vec, oc * DMAX);
      load_vec_async(vecs, lse_p, qi * kRows, s.t);
      load_vec_async(vecs + kRows, dl_p, qi * kRows, s.t);
    }
  };
  if constexpr (!WIDE) {
    if (q_begin < nt) {
      load_tile_async<T, DMAX, kThreads>(k_s, kp, st.v[4], kj * kRows, s.t,
                                         s.d, vec);
      load_tile_async<T, DMAX, kThreads>(v_s, vp, st.v[7], kj * kRows, s.t,
                                         s.d, vec);
      load_q_tile(q_begin, 0);
    }
  } else if (n_steps > 0) {
    stage(0);
  }
  cp_async_commit();

  const int key0 = kj * kRows + kw * 16;  // this warp's first key
  const float c = scale * kLog2e;
  float acc_k[kNo][4], acc_v[kNo][4];
#pragma unroll
  for (int n = 0; n < kNo; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  // s^T += k q^T and dp^T += v dO^T over one tile's DMAX columns (the
  // whole D, or one chunk): rows are this warp's 16 keys, columns the 64
  // queries of the tile
  auto products = [&](float (&sc)[kNs][4], float (&dp)[kNs][4],
                      const T* ks, const T* vs, const T* qs, const T* dos) {
#pragma unroll
    for (int kc = 0; kc < kKd; ++kc) {
      const typename M::A ka = M::load_a(ks, kLd, kw * 16, kc * M::kK, lane);
      const typename M::A va = M::load_a(vs, kLd, kw * 16, kc * M::kK, lane);
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
  };

  // Q tile qi's s^T and dp^T done: p^T and ds^T in place; lane holds
  // keys g (e < 2) and g + 8 (e >= 2), queries 8n + 2tq + (e & 1). p =
  // 2^(c s - log2(e) lse), c = scale * log2(e); a masked score is -inf,
  // so its p and ds are exactly 0. Only tiles that cross the causal
  // diagonal or the end of T are masked. Then dV += p^T dO and dK +=
  // ds^T q in this warp's columns (of the tiles qs, dos of the block's
  // columns), reducing over the tile's queries.
  auto p_ds_acc = [&](float (&sc)[kNs][4], float (&dp)[kNs][4], int qi,
                      const float* lse_t, const float* dl_t, const T* qs,
                      const T* dos) {
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
  };

  if constexpr (!WIDE) {
    for (int qi = q_begin; qi < nt; ++qi) {
      const int cur = (qi - q_begin) & 1;
      cp_async_wait_all();
      __syncthreads();  // tile qi is in; every warp is done with qi - 1
      if (qi + 1 < nt) load_q_tile(qi + 1, cur ^ 1);
      cp_async_commit();
      const T* qs = q_s + cur * kE;
      const T* dos = do_s + cur * kE;
      float sc[kNs][4], dp[kNs][4];
#pragma unroll
      for (int n = 0; n < kNs; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
      products(sc, dp, k_s, v_s, qs, dos);
      p_ds_acc(sc, dp, qi, lse_s + cur * kRows, dl_s + cur * kRows, qs, dos);
    }
  } else {
    float sc[kNs][4], dp[kNs][4];
    for (int step = 0; step < n_steps; ++step) {
      const int qi = q_begin + step / nch, dc = step % nch;
      cp_async_wait_all();
      __syncthreads();  // step is in; every warp is done with step - 1
      if (kSlots == 2 && step + 1 < n_steps) stage(step + 1);
      cp_async_commit();
      const T* base = ring + 4 * (kSlots == 2 ? step & 1 : 0) * kE;
      if (dc == 0) {
#pragma unroll
        for (int n = 0; n < kNs; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
      }
      products(sc, dp, base, base + kE, base + 2 * kE, base + 3 * kE);
      if (dc == nch - 1)
        p_ds_acc(sc, dp, qi, vecs, vecs + kRows, q_out, do_out);
      if (kSlots == 1 && step + 1 < n_steps) {
        __syncthreads();  // every warp is done with this stage
        stage(step + 1);
        cp_async_commit();
      }
    }
  }
  cp_async_wait_all();  // nothing left in flight when the block exits

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = key0 + g + 8 * i;
    if (row >= s.t) continue;
    const int64_t at = (((int64_t)b * s.t + row) * s.h + hh) * s.d + c_out;
#pragma unroll
    for (int n = 0; n < kNo; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = n * 8 + 2 * tq + c;
        if (c_out + col < s.d) {
          store(dk + at + col, acc_k[n][2 * i + c]);
          store(dv + at + col, acc_v[n][2 * i + c]);
        }
      }
  }
}

// Dynamic shared memory: k, v + two stages of (q, dO) and of (lse,
// delta), or, wide, the stages of (k, v, q, dO) chunks, the q and dO
// tiles of the dK/dV columns, and lse and delta
template <typename T, int DMAX, bool WIDE>
constexpr size_t dkv_smem_bytes() {
  return (WIDE ? 4 * dkv_slots<T, DMAX, WIDE>() + 2 : 6) *
             (size_t)Tile<T, DMAX>::kBytes +
         (WIDE ? 2 : 4) * kRows * sizeof(float);
}

template <typename T, int DMAX, bool WIDE>
cudaError_t run(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dk, void* dv,
                const int* offs, const Strides& st, const Shape& s,
                void* stream) {
  constexpr size_t bytes = dkv_smem_bytes<T, DMAX, WIDE>();
  static_assert(bytes <= kSmemMax, "the stages fit a block");
  const void* ptrs[4] = {q, k, v, dout};
  const int vec = rows_aligned16(ptrs, st, 4, sizeof(T));
  const int64_t nt = (s.t + kRows - 1) / kRows;
  const int64_t nch = WIDE ? (s.d + DMAX - 1) / DMAX : 1;
  constexpr int threads = kBlock * dkv_split<DMAX>();
  return launch_kernel<threads>(flash_dkv_kernel<T, DMAX, WIDE>,
                                nt * s.b * s.h * nch, bytes, stream,
                                (const T*)q, (const T*)k, (const T*)v,
                                (const T*)dout, lse, delta, (T*)dk, (T*)dv,
                                offs, st, s, softmax_scale(s.d), vec);
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
  const void* ptrs[4] = {q, k, v, dout};
  switch (flash_form(dtype, d, ptrs, strides, 4)) {
    case kFormWgmma:
      return (int)dkv_wgmma(q, k, v, dout, lse, delta, dk, dv, offs, strides,
                            s, stream);
    case kFormWhole:
      return (int)dkv_whole(q, k, v, dout, lse, delta, dk, dv, offs, strides,
                            s, stream);
    default:
      break;
  }
  const Strides st = strides_from(strides, 4);
  return (int)EGF_DISPATCH(dtype, d, run, q, k, v, dout, lse, delta, dk, dv,
                           offs, st, s, stream);
}
