// FlashAttention-2 backward, dQ: the score tiles are rebuilt from
// (q, k, lse) and never reach device memory. This file is the mma.sync
// form and the C entry, which picks the form by shape before the launch
// (flash_base.cuh's flash_form).
//
// Replaces the TPU kernel eventgrad_tpu/ops/attention.py:_dq_kernel
// (launched by _run_bwd). Per (batch, head, 64-row Q tile), over the K/V
// tiles kj:
//
//   s  = scale * (q k_j^T), invalid entries masked
//   p  = exp(s - lse) * valid
//   dp = dO v_j^T
//   ds = p * (dp - delta) * scale
//   dQ += ds k_j
//
// delta = rowsum(dO * O) - dlse comes in precomputed, as on the TPU. The
// K sweep that was the TPU grid's sequential last dimension is the loop
// inside the block. Four warps each own 16 query rows of a 64-row Q
// tile; s, dp and dQ live in registers (flash_mma.cuh: mma.sync on bf16,
// 3xTF32 on float32), and ds feeds the ds k product from its
// accumulators, against the same K tile the first product read
// transposed, without touching shared memory. The q and dO tiles stay in
// shared memory for the whole sweep; K and V tiles come through cp.async
// in a two-stage ring: tile j + 1 loads while tile j is computed, one
// barrier per tile. lse (times log2(e)) and delta of a lane's two rows
// are read once into registers, and p = 2^(c s - log2(e) lse), c =
// scale * log2(e), one FFMA and one MUFU.EX2 per score.
//
// float32 at DMAX = 128: one warp would hold dQ's 64 accumulator
// registers a thread beside the 64 of s and dp and the hi/lo operand
// splits, and spills (255 registers, 104 bytes of stack). So each 16
// query rows go to two warps (eight a block), and each warp of a pair
// sweeps one 32-key half of every K tile: s and dp of 16 x 32 (32
// registers), ds k over its 32 keys into a dQ partial over the full D.
// No product is repeated. After the sweep the pair's partials meet in
// shared memory (the K/V ring, free by then) and one warp of the pair
// adds and stores them: a dQ element sums its two halves' keys
// separately, then adds the two sums. bfloat16 spills at most 8 bytes at
// DMAX = 128 (168 registers) and ran slower split on the H100 (1.09 ->
// 1.41 ms at B32 x T1024 x H16 x D128), so it keeps one warp to 16 rows.
//
// A causal block sweeps only the K tiles that can hold a valid entry for
// one of its rows: up to the tile of key q_off - k_off + (last row of
// the tile), the diagonal tile without offsets, none for a ring hop that
// lies wholly in the future, whose dQ rows are written as zeros. A
// skipped tile would have added exactly 0 (its p and ds are 0). The
// heaviest blocks (the last Q tiles of every (batch, head), which sweep
// the most) come first in the grid, then the next heaviest, so the tail
// of the launch holds the short sweeps.
//
// Head widths above 128 (WIDE, flash_mma.cuh): a block owns one
// 128-column chunk of dQ. For each K tile it streams (q, dO, k, v)
// chunks through the scores s and dp, and with the last chunk the k
// tile of its columns for ds k; the key split of the float32 warp pairs
// is DMAX = 128's. s and dp are rebuilt once per output chunk: at D =
// 256 the work would be 2 x (q k^T + dO v^T) + ds k, five products of
// the width where three do, so D = 256 runs the wgmma form in bfloat16
// on TMA-readable rows (flash_dq_wgmma.cu) and the whole form in float32
// (flash_dq_whole.cu), which build each score tile once; the wide form
// serves the other widths above 128 and misaligned bfloat16 rows. A
// stage of four chunk tiles is 135,168 bytes in float32, so float32
// keeps one stage (168,960 bytes with the k tile; each chunk loads after
// the last is computed) and bfloat16 two (156,672). ptxas (the H100 build of chip_smoke.py): 255 registers in
// float32, 248 in bfloat16, no spills.
//
// Bound on the card: operations at the main shape (three products of
// 2*T*T*D flops per (batch, head), halved when causal: the tensor cores'
// bf16 rate, or three TF32 products each for float32), against q, k, v,
// dO, lse, delta read and dQ written once.
#include "flash_mma.cuh"

namespace {

using namespace egf;

// Warps sharing one 16-row block of queries, each sweeping kRows / split
// keys of every K tile
template <typename T, int DMAX>
__host__ __device__ constexpr int dq_split() {
  return sizeof(T) == 4 && DMAX > 64 ? 2 : 1;
}

// Stages of the copy ring: DMAX <= 128 double-buffers K/V (q and dO stay
// resident); wide, a stage is (q, dO, k, v) chunks, two where they fit
// beside the k tile of this block's dQ columns (bfloat16), else one
// (float32)
template <typename T, int DMAX, bool WIDE>
__host__ __device__ constexpr int dq_slots() {
  return WIDE ? ring_slots(4 * Tile<T, DMAX>::kBytes, Tile<T, DMAX>::kBytes)
              : 2;
}

template <typename T, int DMAX, bool WIDE>
__global__ void __launch_bounds__(kBlock * dq_split<T, DMAX>())
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    const int* __restrict__ offs, Strides st, Shape s,
                    float scale, int vec) {
  using M = Tc<T>;
  using G = Tile<T, DMAX>;
  constexpr int kSplit = dq_split<T, DMAX>();
  constexpr int kThreads = kBlock * kSplit;
  constexpr int kKeys = kRows / kSplit;  // keys of a K tile per warp
  constexpr int kLd = G::kLd;
  constexpr int kE = G::kElems;
  constexpr int kSlots = dq_slots<T, DMAX, WIDE>();
  constexpr int kNs = kKeys / 8;        // n8 tiles of a warp's score block
  constexpr int kNo = DMAX / 8;         // n8 tiles of a dQ row block
  constexpr int kKd = DMAX / M::kK;     // k steps over a head-dim chunk
  constexpr int kKs = kKeys / M::kK;    // k steps over a warp's keys
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // DMAX <= 128: q, dO [64][kLd], then two stages of k, then two of v.
  // Wide: kSlots stages of (q, dO, k, v) chunks, then the k tile of this
  // block's dQ columns
  T* const smem = reinterpret_cast<T*>(smem_raw);
  T* const ring = WIDE ? smem : smem + 2 * kE;  // the stages

  // wide: ceil(d / 128) chunks of the head dimension, this block's dQ
  // chunk innermost in the grid
  const int nch = WIDE ? (s.d + DMAX - 1) / DMAX : 1;
  const int oc = WIDE ? (int)(blockIdx.x % nch) : 0;
  const unsigned blk = WIDE ? blockIdx.x / nch : blockIdx.x;
  const int c_out = oc * DMAX;  // this block's first dQ column
  const int nt = (s.t + kRows - 1) / kRows;
  const int bhn = s.b * s.h;
  const int qi = nt - 1 - (int)(blk / bhn);
  const int bh = (int)(blk % bhn);
  const int b = bh / s.h, hh = bh % s.h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int qw = warp / kSplit;                 // this warp's 16 queries
  const int kofs = (warp % kSplit) * kKeys;     // its keys of a K tile

  int q_off, k_off;
  load_offsets(offs, s, b, q_off, k_off);
  const T* qp = q + b * st.v[0] + hh * st.v[2];
  const T* kp = k + b * st.v[3] + hh * st.v[5];
  const T* vp = v + b * st.v[6] + hh * st.v[8];
  const T* dop = dout + b * st.v[9] + hh * st.v[11];

  // the last K tile with a key that some row of this Q tile may see
  int k_end = nt - 1;
  if (s.causal) {
    const int last_key = q_off - k_off + qi * kRows + kRows - 1;
    k_end = last_key < 0 ? -1 : min(k_end, last_key / kRows);
  }

  // DMAX <= 128: q and dO stay, K and V tiles come through the two-stage
  // ring
  T* const q_s = smem;
  T* const do_s = smem + kE;
  T* const k_s = ring;           // two stages
  T* const v_s = ring + 2 * kE;  // two stages
  // wide: step i is K tile i / nch, head-dimension chunk i % nch, in
  // stage i % kSlots as (q, dO, k, v) chunks; the k tile of this block's
  // dQ columns comes with the last chunk. With one stage each step loads
  // after the last is computed.
  T* const k_out = ring + 4 * kSlots * kE;
  const int n_steps = (k_end + 1) * nch;
  auto stage = [&](int step) {
    const int kj = step / nch, dc = step % nch;
    T* const base = ring + 4 * (kSlots == 2 ? step & 1 : 0) * kE;
    load_tile_async<T, DMAX, kThreads>(base, qp, st.v[1], qi * kRows, s.t,
                                       s.d, vec, dc * DMAX);
    load_tile_async<T, DMAX, kThreads>(base + kE, dop, st.v[10], qi * kRows,
                                       s.t, s.d, vec, dc * DMAX);
    load_tile_async<T, DMAX, kThreads>(base + 2 * kE, kp, st.v[4],
                                       kj * kRows, s.t, s.d, vec, dc * DMAX);
    load_tile_async<T, DMAX, kThreads>(base + 3 * kE, vp, st.v[7],
                                       kj * kRows, s.t, s.d, vec, dc * DMAX);
    if (dc == nch - 1)
      load_tile_async<T, DMAX, kThreads>(k_out, kp, st.v[4], kj * kRows,
                                         s.t, s.d, vec, c_out);
  };
  if constexpr (!WIDE) {
    if (k_end >= 0) {
      load_tile_async<T, DMAX, kThreads>(q_s, qp, st.v[1], qi * kRows, s.t,
                                         s.d, vec);
      load_tile_async<T, DMAX, kThreads>(do_s, dop, st.v[10], qi * kRows,
                                         s.t, s.d, vec);
      load_tile_async<T, DMAX, kThreads>(k_s, kp, st.v[4], 0, s.t, s.d, vec);
      load_tile_async<T, DMAX, kThreads>(v_s, vp, st.v[7], 0, s.t, s.d, vec);
    }
  } else if (n_steps > 0) {
    stage(0);
  }
  cp_async_commit();

  const int row0 = qi * kRows + qw * 16;  // this warp's first query row
  // rows g and g + 8: log2(e) lse and delta (0 past t, where nothing is
  // written)
  float lse_c[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    const bool in = k_end >= 0 && row < s.t;
    lse_c[i] = in ? lse[(int64_t)bh * s.t + row] * kLog2e : 0.f;
    dl[i] = in ? delta[(int64_t)bh * s.t + row] : 0.f;
  }
  float acc[kNo][4];
#pragma unroll
  for (int n = 0; n < kNo; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float c = scale * kLog2e;

  // s += q k^T and dp += dO v^T over one tile's DMAX columns (the whole
  // D, or one chunk): rows are this warp's 16 queries, columns its keys
  // of the tile
  auto products = [&](float (&sc)[kNs][4], float (&dp)[kNs][4],
                      const T* qs, const T* dos, const T* ks, const T* vs) {
#pragma unroll
    for (int kc = 0; kc < kKd; ++kc) {
      const typename M::A qa = M::load_a(qs, kLd, qw * 16, kc * M::kK, lane);
      const typename M::A da = M::load_a(dos, kLd, qw * 16, kc * M::kK,
                                         lane);
#pragma unroll
      for (int n = 0; n < kNs; n += 2) {
        typename M::B b0, b1;
        M::load_bt2(b0, b1, ks, kLd, kofs + n * 8, kc * M::kK, lane);
        M::mma(sc[n], qa, b0);
        M::mma(sc[n + 1], qa, b1);
        M::load_bt2(b0, b1, vs, kLd, kofs + n * 8, kc * M::kK, lane);
        M::mma(dp[n], da, b0);
        M::mma(dp[n + 1], da, b1);
      }
    }
  };

  // K tile kj's s and dp done: ds in place of dp; lane holds rows g (e <
  // 2) and g + 8 (e >= 2), keys 8n + 2tq + (e & 1). A masked score is
  // -inf, so its p and ds are exactly 0. Only tiles that cross the causal
  // diagonal or the end of T are masked. Then dQ += ds k, reducing over
  // this warp's keys, k (the tile of this block's dQ columns) read by
  // rows.
  auto ds_dq = [&](float (&sc)[kNs][4], float (&dp)[kNs][4], int kj,
                   const T* ks) {
    const int key0 = kj * kRows;
    const bool full = key0 + kRows <= s.t &&
                      (!s.causal || q_off + row0 >= k_off + key0 + kRows - 1);
    if (!full) {
#pragma unroll
      for (int n = 0; n < kNs; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!valid_at(row0 + g + 8 * (e >> 1),
                        key0 + kofs + n * 8 + 2 * tq + (e & 1), s.t,
                        s.causal, q_off, k_off))
            sc[n][e] = -INFINITY;
    }
#pragma unroll
    for (int n = 0; n < kNs; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(fmaf(sc[n][e], c, -lse_c[e >> 1]));
        dp[n][e] = p * (dp[n][e] - dl[e >> 1]) * scale;
      }
#pragma unroll
    for (int kc = 0; kc < kKs; ++kc) {
      const typename M::A a = M::from_acc(dp, kc);
#pragma unroll
      for (int n = 0; n < kNo; n += 2) {
        typename M::B b0, b1;
        M::load_b2(b0, b1, ks, kLd, kofs + kc * M::kK, n * 8, lane);
        M::mma(acc[n], a, b0);
        M::mma(acc[n + 1], a, b1);
      }
    }
  };

  if constexpr (!WIDE) {
    for (int kj = 0; kj <= k_end; ++kj) {
      cp_async_wait_all();
      __syncthreads();  // tile kj is in; every warp is done with kj - 1
      if (kj < k_end) {
        const int nxt = (kj + 1) & 1;
        load_tile_async<T, DMAX, kThreads>(k_s + nxt * kE, kp, st.v[4],
                                           (kj + 1) * kRows, s.t, s.d, vec);
        load_tile_async<T, DMAX, kThreads>(v_s + nxt * kE, vp, st.v[7],
                                           (kj + 1) * kRows, s.t, s.d, vec);
      }
      cp_async_commit();
      const T* ks = k_s + (kj & 1) * kE;
      float sc[kNs][4], dp[kNs][4];
#pragma unroll
      for (int n = 0; n < kNs; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
      products(sc, dp, q_s, do_s, ks, v_s + (kj & 1) * kE);
      ds_dq(sc, dp, kj, ks);
    }
  } else {
    float sc[kNs][4], dp[kNs][4];
    for (int step = 0; step < n_steps; ++step) {
      const int kj = step / nch, dc = step % nch;
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
      if (dc == nch - 1) ds_dq(sc, dp, kj, k_out);
      if (kSlots == 1 && step + 1 < n_steps) {
        __syncthreads();  // every warp is done with this stage
        stage(step + 1);
        cp_async_commit();
      }
    }
  }
  cp_async_wait_all();  // nothing left in flight when the block exits

  if constexpr (kSplit > 1) {
    // the second warp of each pair hands its partial to the first through
    // the copy ring, lane-minor so that a warp's 32 lanes hit 32 banks
    static_assert(kSplit == 2, "warp pairs");
    static_assert(4 * G::kBytes >= kBlock / 32 * kNo * 4 * 32 * 4,
                  "the partials fit the copy ring");
    float* part = reinterpret_cast<float*>(ring) + qw * (kNo * 4 * 32);
    __syncthreads();  // every warp is done with the last stage
    if (kofs != 0) {
#pragma unroll
      for (int n = 0; n < kNo; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[(n * 4 + e) * 32 + lane] = acc[n][e];
    }
    __syncthreads();
    if (kofs != 0) return;
#pragma unroll
    for (int n = 0; n < kNo; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += part[(n * 4 + e) * 32 + lane];
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    if (row >= s.t) continue;
    T* dst = dq + (((int64_t)b * s.t + row) * s.h + hh) * s.d + c_out;
#pragma unroll
    for (int n = 0; n < kNo; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = n * 8 + 2 * tq + j;
        if (c_out + col < s.d) store(dst + col, acc[n][2 * i + j]);
      }
  }
}

// Dynamic shared memory: q, dO + two stages of (k, v), or, wide, the
// stages of (q, dO, k, v) chunks and the k tile of the dQ columns
template <typename T, int DMAX, bool WIDE>
constexpr size_t dq_smem_bytes() {
  return (WIDE ? 4 * dq_slots<T, DMAX, WIDE>() + 1 : 6) *
         (size_t)Tile<T, DMAX>::kBytes;
}

template <typename T, int DMAX, bool WIDE>
cudaError_t run(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dq,
                const int* offs, const Strides& st, const Shape& s,
                void* stream) {
  constexpr size_t bytes = dq_smem_bytes<T, DMAX, WIDE>();
  static_assert(bytes <= kSmemMax, "the stages fit a block");
  const void* ptrs[4] = {q, k, v, dout};
  const int vec = rows_aligned16(ptrs, st, 4, sizeof(T));
  const int64_t nt = (s.t + kRows - 1) / kRows;
  const int64_t nch = WIDE ? (s.d + DMAX - 1) / DMAX : 1;
  constexpr int threads = kBlock * dq_split<T, DMAX>();
  return launch_kernel<threads>(flash_dq_kernel<T, DMAX, WIDE>,
                                nt * s.b * s.h * nch, bytes, stream,
                                (const T*)q, (const T*)k, (const T*)v,
                                (const T*)dout, lse, delta, (T*)dq, offs, st,
                                s, softmax_scale(s.d), vec);
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
  const void* ptrs[4] = {q, k, v, dout};
  switch (flash_form(dtype, d, ptrs, strides, 4)) {
    case kFormWgmma:
      return (int)dq_wgmma(q, k, v, dout, lse, delta, dq, offs, strides, s,
                           stream);
    case kFormWhole:
      return (int)dq_whole(q, k, v, dout, lse, delta, dq, offs, strides, s,
                           stream);
    default:
      break;
  }
  const Strides st = strides_from(strides, 4);
  return (int)EGF_DISPATCH(dtype, d, run, q, k, v, dout, lse, delta, dq, offs,
                           st, s, stream);
}
