// FlashAttention-2 forward: out = softmax(q k^T / sqrt(D) + mask) v and
// the row logsumexp, with the scores kept on chip.
//
// Replaces the TPU kernel eventgrad_tpu/ops/attention.py:_fwd_kernel
// (launched by _run_fwd; entries flash_attention, flash_attention_lse).
// Per (batch, head, 64-row Q tile), over the K/V tiles kj:
//
//   s      = scale * (q k_j^T), invalid entries masked
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
// block here. Four warps each own 16 query rows of a 64-row Q tile; the
// scores, p, m, l and acc live in registers (flash_mma.cuh: mma.sync on
// bf16, 3xTF32 on float32), and p feeds the p v product from its
// accumulators without touching shared memory. The scale multiplies the
// float32 scores, so a D whose 1/sqrt(D) is not a power of two loses
// nothing to a rounded q; the softmax runs in base 2 (one FFMA and one
// MUFU.EX2 per score). K and V tiles come through cp.async in a
// two-stage ring: tile j + 1 loads while tile j is computed, one barrier
// per tile.
//
// float32 at DMAX = 128: the output block alone takes 64 accumulator
// registers a thread (254 registers in all), and 168,960 bytes of shared
// memory leave one block of 4 warps on an SM. So each 16 query rows go
// to two warps (eight a block), and each warp of a pair sweeps one 32-key
// half of every K/V tile with its own online softmax (m, l, acc). No
// product is repeated. After the sweep the pair's states meet in shared
// memory (the K/V ring, free by then) and one warp of the pair merges
// them, as ring attention merges two hops: m = max(m_a, m_b), each side
// rescaled by 2^(c (m_side - m)). On the H100 that took the float32
// forward at B32 x T1024 x H16 x D128 from 4.87 to 3.28 ms; bfloat16,
// whose smaller tiles already fit two blocks an SM, gained nothing from
// it (1.01 -> 1.05 ms) and keeps one warp to 16 rows.
//
// A causal block sweeps only the K tiles that can hold a valid entry for
// one of its rows: up to the tile of key q_off - k_off + (last row of
// the tile), the diagonal tile without offsets, none for a ring hop that
// lies wholly in the future. A skipped tile would have left m, l and acc
// bitwise as they were (its p is exactly 0). The heaviest blocks (the
// last Q tiles of every (batch, head), which sweep the most) come first
// in the grid, then the next heaviest, so the tail of the launch holds
// the short sweeps.
//
// This file holds the mma.sync form and the C entry point, which picks
// the form by shape (flash_base.cuh's flash_form): bfloat16 at D = 64,
// 128 and 256 on TMA-readable rows runs flash_fwd_wgmma.cu, float32 at
// D = 256 flash_fwd_whole.cu, everything else the kernel below.
//
// Head widths above 128 (WIDE, flash_mma.cuh): a block owns one
// 128-column chunk of out. For each K tile it streams q and k through
// two shared-memory stages chunk by chunk into the scores (q is re-read
// per K tile: it no longer fits beside the ring), and with the last
// chunk the v tile of its columns; the key split of the float32 warp
// pairs and their merge are DMAX = 128's. The scores are rebuilt once
// per output chunk, so at D = 256 the work is 2 x (q k^T) + p v, three
// products of the width where two would do. Every block computes the
// same m and l (the same scores, summed in the same order); the block
// of chunk 0 writes lse. Shared memory two stages of (q, k, v): 202,752
// bytes in float32, 104,448 in bfloat16. ptxas (nvcc 12.9, sm_90a, the
// H100 build of chip_smoke.py): 212 registers float32, 172 bfloat16, no
// spills.
//
// Bound on the card: operations at the main shape (two products of
// 2*T*T*D flops per (batch, head), halved when causal: the tensor cores'
// bf16 rate, or three TF32 products each for float32), against q, k, v
// read and out, lse written once.
#include "flash_mma.cuh"

namespace {

using namespace egf;

// Warps sharing one 16-row block of queries, each sweeping kRows / split
// keys of every K/V tile
template <typename T, int DMAX>
__host__ __device__ constexpr int fwd_split() {
  return sizeof(T) == 4 && DMAX > 64 ? 2 : 1;
}

template <typename T, int DMAX, bool WIDE>
__global__ void __launch_bounds__(kBlock * fwd_split<T, DMAX>())
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, const int* __restrict__ offs,
                     Strides st, Shape s, float scale, int vec) {
  using M = Tc<T>;
  using G = Tile<T, DMAX>;
  constexpr int kSplit = fwd_split<T, DMAX>();
  constexpr int kThreads = kBlock * kSplit;
  constexpr int kKeys = kRows / kSplit;  // keys of a K/V tile per warp
  constexpr int kLd = G::kLd;
  constexpr int kE = G::kElems;
  constexpr int kNs = kKeys / 8;        // n8 tiles of a warp's score block
  constexpr int kNo = DMAX / 8;         // n8 tiles of an output row block
  constexpr int kKq = DMAX / M::kK;     // k steps of q k^T (one chunk)
  constexpr int kKp = kKeys / M::kK;    // k steps of p v
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // DMAX <= 128: q [64][kLd], then two stages of k, then two of v. Wide:
  // two stages of (q chunk, k chunk, v chunk of this block's columns)
  T* const smem = reinterpret_cast<T*>(smem_raw);
  T* const ring = WIDE ? smem : smem + kE;  // the stages

  // wide: ceil(d / 128) chunks of the head dimension, this block's
  // output chunk innermost in the grid
  const int nch = WIDE ? (s.d + DMAX - 1) / DMAX : 1;
  const int oc = WIDE ? (int)(blockIdx.x % nch) : 0;
  const unsigned blk = WIDE ? blockIdx.x / nch : blockIdx.x;
  const int c_out = oc * DMAX;  // this block's first output column
  const int nt = (s.t + kRows - 1) / kRows;
  const int bhn = s.b * s.h;
  const int qi = nt - 1 - (int)(blk / bhn);
  const int bh = (int)(blk % bhn);
  const int b = bh / s.h, hh = bh % s.h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int qw = warp / kSplit;                 // this warp's 16 queries
  const int kofs = (warp % kSplit) * kKeys;     // its keys of a K/V tile

  int q_off, k_off;
  load_offsets(offs, s, b, q_off, k_off);
  const T* qp = q + b * st.v[0] + hh * st.v[2];
  const T* kp = k + b * st.v[3] + hh * st.v[5];
  const T* vp = v + b * st.v[6] + hh * st.v[8];

  // the last K tile with a key that some row of this Q tile may see
  int k_end = nt - 1;
  if (s.causal) {
    const int last_key = q_off - k_off + qi * kRows + kRows - 1;
    k_end = last_key < 0 ? -1 : min(k_end, last_key / kRows);
  }

  // DMAX <= 128: q stays, K and V tiles come through the two-stage ring
  T* const q_s = smem;
  T* const k_s = ring;           // two stages
  T* const v_s = ring + 2 * kE;  // two stages
  // wide: step i is K tile i / nch, head-dimension chunk i % nch, in
  // stage i & 1 as (q chunk, k chunk, and with the last chunk the v tile
  // of this block's columns)
  const int n_steps = (k_end + 1) * nch;
  auto stage = [&](int step) {
    const int kj = step / nch, dc = step % nch;
    T* const base = ring + 3 * (step & 1) * kE;
    load_tile_async<T, DMAX, kThreads>(base, qp, st.v[1], qi * kRows, s.t,
                                       s.d, vec, dc * DMAX);
    load_tile_async<T, DMAX, kThreads>(base + kE, kp, st.v[4], kj * kRows,
                                       s.t, s.d, vec, dc * DMAX);
    if (dc == nch - 1)
      load_tile_async<T, DMAX, kThreads>(base + 2 * kE, vp, st.v[7],
                                         kj * kRows, s.t, s.d, vec, c_out);
  };
  if constexpr (!WIDE) {
    load_tile_async<T, DMAX, kThreads>(q_s, qp, st.v[1], qi * kRows, s.t,
                                       s.d, vec);
    if (k_end >= 0) {
      load_tile_async<T, DMAX, kThreads>(k_s, kp, st.v[4], 0, s.t, s.d, vec);
      load_tile_async<T, DMAX, kThreads>(v_s, vp, st.v[7], 0, s.t, s.d, vec);
    }
  } else if (n_steps > 0) {
    stage(0);
  }
  cp_async_commit();

  const int row0 = qi * kRows + qw * 16;  // this warp's first query row
  // rows g and g + 8: the max of the unscaled scores (kNegInf while every
  // key so far was masked) and this lane's share of the row sum
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kNo][4];
#pragma unroll
  for (int n = 0; n < kNo; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float c = scale * kLog2e;

  // sc += q k^T over one tile's DMAX columns (the whole D, or one chunk)
  auto scores = [&](float (&sc)[kNs][4], const T* qs, const T* ks) {
#pragma unroll
    for (int kc = 0; kc < kKq; ++kc) {
      const typename M::A a = M::load_a(qs, kLd, qw * 16, kc * M::kK, lane);
#pragma unroll
      for (int n = 0; n < kNs; n += 2) {
        typename M::B b0, b1;
        M::load_bt2(b0, b1, ks, kLd, kofs + n * 8, kc * M::kK, lane);
        M::mma(sc[n], a, b0);
        M::mma(sc[n + 1], a, b1);
      }
    }
  };

  // K/V tile kj's scores done: mask, then the online softmax on the
  // unscaled scores in base 2: p = 2^(c s - c m), c = scale * log2(e), m
  // the row max of s. A masked score is -inf, so its p is exactly 0 and
  // it leaves m alone. Only tiles that cross the causal diagonal or the
  // end of T are masked. Then acc += p v, p from its accumulators.
  auto softmax_pv = [&](float (&sc)[kNs][4], int kj, const T* vs) {
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
    float mx[2] = {m[0], m[1]}, mc[2];
#pragma unroll
    for (int n = 0; n < kNs; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      const float corr = fast_exp2((m[i] - mx[i]) * c);
      m[i] = mx[i];
      mc[i] = mx[i] * c;
      l[i] *= corr;  // this lane's share of the row sum
#pragma unroll
      for (int n = 0; n < kNo; ++n) {
        acc[n][2 * i] *= corr;
        acc[n][2 * i + 1] *= corr;
      }
    }
#pragma unroll
    for (int n = 0; n < kNs; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[n][e] = fast_exp2(fmaf(sc[n][e], c, -mc[e >> 1]));
        l[e >> 1] += sc[n][e];
      }
#pragma unroll
    for (int kc = 0; kc < kKp; ++kc) {
      const typename M::A a = M::from_acc(sc, kc);
#pragma unroll
      for (int n = 0; n < kNo; n += 2) {
        typename M::B b0, b1;
        M::load_b2(b0, b1, vs, kLd, kofs + kc * M::kK, n * 8, lane);
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
      float sc[kNs][4];
#pragma unroll
      for (int n = 0; n < kNs; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
      scores(sc, q_s, k_s + (kj & 1) * kE);
      softmax_pv(sc, kj, v_s + (kj & 1) * kE);
    }
  } else {
    float sc[kNs][4];
    for (int step = 0; step < n_steps; ++step) {
      const int kj = step / nch, dc = step % nch;
      cp_async_wait_all();
      __syncthreads();  // step is in; every warp is done with step - 1
      if (step + 1 < n_steps) stage(step + 1);
      cp_async_commit();
      const T* base = ring + 3 * (step & 1) * kE;
      if (dc == 0) {
#pragma unroll
        for (int n = 0; n < kNs; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
      }
      scores(sc, base, base + kE);
      if (dc == nch - 1) softmax_pv(sc, kj, base + 2 * kE);
    }
  }
  cp_async_wait_all();  // nothing left in flight when the block exits

  if constexpr (kSplit > 1) {
    // the second warp of each pair hands its (m, l, acc) to the first
    // through the copy ring, lane-minor so that a warp's 32 lanes hit 32
    // banks; the first merges them
    static_assert(kSplit == 2, "warp pairs");
    constexpr int kPart = 4 + kNo * 4;  // floats a lane hands over
    static_assert(4 * G::kBytes >= kBlock / 32 * kPart * 32 * 4,
                  "the states fit the copy ring");
    float* part = reinterpret_cast<float*>(ring) + qw * (kPart * 32);
    __syncthreads();  // every warp is done with the last stage
    if (kofs != 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        part[i * 32 + lane] = m[i];
        part[(2 + i) * 32 + lane] = l[i];
      }
#pragma unroll
      for (int n = 0; n < kNo; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          part[(4 + n * 4 + e) * 32 + lane] = acc[n][e];
    }
    __syncthreads();
    if (kofs != 0) return;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float mo = part[i * 32 + lane];
      const float mn = fmaxf(m[i], mo);
      const float ca = fast_exp2((m[i] - mn) * c);
      const float cb = fast_exp2((mo - mn) * c);
      m[i] = mn;
      l[i] = l[i] * ca + part[(2 + i) * 32 + lane] * cb;
#pragma unroll
      for (int n = 0; n < kNo; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = 2 * i + j;
          acc[n][e] = acc[n][e] * ca + part[(4 + n * 4 + e) * 32 + lane] * cb;
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    const float l_safe = fmaxf(quad_sum(l[i]), kLFloor);
    if (row >= s.t) continue;
    // a fully masked row keeps m = -1e30 unscaled, as the plain version;
    // one block of the row writes its lse
    const float m_s = m[i] == kNegInf ? kNegInf : m[i] * scale;
    if (tq == 0 && oc == 0) lse[(int64_t)bh * s.t + row] = m_s + logf(l_safe);
    T* dst = out + (((int64_t)b * s.t + row) * s.h + hh) * s.d + c_out;
#pragma unroll
    for (int n = 0; n < kNo; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = n * 8 + 2 * tq + j;
        if (c_out + col < s.d) store(dst + col, acc[n][2 * i + j] / l_safe);
      }
  }
}

// Dynamic shared memory: q + two stages of (k, v), or, wide, two stages
// of (q, k, v) chunks
template <typename T, int DMAX, bool WIDE>
constexpr size_t fwd_smem_bytes() {
  return (WIDE ? 6 : 5) * (size_t)Tile<T, DMAX>::kBytes;
}

template <typename T, int DMAX, bool WIDE>
cudaError_t run(const void* q, const void* k, const void* v, void* out,
                float* lse, const int* offs, const Strides& st,
                const Shape& s, void* stream) {
  constexpr size_t bytes = fwd_smem_bytes<T, DMAX, WIDE>();
  static_assert(bytes <= kSmemMax, "the stages fit a block");
  const void* ptrs[3] = {q, k, v};
  const int vec = rows_aligned16(ptrs, st, 3, sizeof(T));
  const int64_t nt = (s.t + kRows - 1) / kRows;
  const int64_t nch = WIDE ? (s.d + DMAX - 1) / DMAX : 1;
  constexpr int threads = kBlock * fwd_split<T, DMAX>();
  return launch_kernel<threads>(flash_fwd_kernel<T, DMAX, WIDE>,
                                nt * s.b * s.h * nch, bytes, stream,
                                (const T*)q, (const T*)k, (const T*)v,
                                (T*)out, lse, offs, st, s, softmax_scale(s.d),
                                vec);
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
  const void* ptrs[3] = {q, k, v};
  switch (flash_form(dtype, d, ptrs, strides, 3)) {
    case kFormWgmma:
      return (int)fwd_wgmma(q, k, v, out, lse, offs, strides, s, stream);
    case kFormWhole:
      return (int)fwd_whole(q, k, v, out, lse, offs, strides, s, stream);
    default:
      break;
  }
  const Strides st = strides_from(strides, 3);
  return (int)EGF_DISPATCH(dtype, d, run, q, k, v, out, lse, offs, st, s,
                           stream);
}

// The form flash_form gives a forward (kernel 0), dQ (kernel 1) or
// dK/dV (kernel 2) launch on these pointers and strides (n = 3 or 4
// tensors), and the dynamic shared memory of that form's instantiation
// at d in *smem (0 for the mma.sync form, whose sizes are the kernels'
// own): the card's check of ops/flash_plan.py, the Python mirror.
extern "C" int eg_flash_form(int kernel, const void* const* ptrs,
                             const int64_t* strides, int d, int dtype,
                             int64_t* smem) {
  const int n = kernel == 0 ? 3 : 4;
  const int form = flash_form(dtype, d, ptrs, strides, n);
  size_t bytes = 0;
  if (form == kFormWgmma)
    bytes = kernel == 0   ? fwd_wgmma_smem(d)
            : kernel == 1 ? dq_wgmma_smem(d)
                          : dkv_wgmma_smem(d);
  else if (form == kFormWhole)
    bytes = kernel == 0   ? fwd_whole_smem(d)
            : kernel == 1 ? dq_whole_smem(d)
                          : dkv_whole_smem(d);
  *smem = (int64_t)bytes;
  return form;
}
