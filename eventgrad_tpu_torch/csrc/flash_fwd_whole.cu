// FlashAttention-2 forward in float32 at D = 256 with the scores of a
// tile built once: the whole form of flash_fwd.cu (flash_base.cuh's
// flash_form picks it), the same function: out = softmax(q k^T /
// sqrt(D) + mask) v and the row logsumexp.
//
// Replaces the TPU kernel eventgrad_tpu/ops/attention.py:_fwd_kernel (as
// flash_fwd.cu does; its note gives the recurrence, the masking and the
// causal tile skip, all kept here).
//
// Why not wgmma: for float32 (tf32) wgmma reads both operands K-major
// from shared memory, so v would need a transposed copy, and 3xTF32
// needs the big and small halves of every shared-memory operand as
// tiles of their own: q, k and v in two halves each do not fit 227 KB.
// So the products stay 3xTF32 on mma.sync (flash_mma.cuh), and the
// work is split so that none is repeated.
//
// A block owns 64 query rows and has 8 warps: warp w works on rows
// 16 (w % 4) .. + 15, and w / 4 picks its half. Per 64-key tile:
//
//   s = q k^T   each warp its 16 rows x its half's 32 keys over all 256
//               columns (the wide mma form rebuilds s once per
//               128-column output chunk: three products where two do);
//   softmax     the row maxima of the two halves meet in shared memory,
//               so both warps of a row block rescale by one m; each
//               writes its p to a [64][64] float32 tile;
//   o += p v    each warp its 16 rows x its half's 128 output columns,
//               p read back over all 64 keys.
//
// So s and p v are each computed once. After the sweep the two halves'
// row sums meet in shared memory (l = l_0 + l_1, the same in both
// warps). q stays for the whole sweep; k and v have one buffer each,
// refilled through cp.async as soon as every warp is done with it (k
// after the row maxima, v after p v), so tile j + 1's k loads during
// tile j's p v and its v during tile j + 1's q k^T. Four barriers a
// tile.
//
// Per 64 x 64 tile that is 6,144 mma.m16n8k8 (3,072 for s, 3,072 for
// p v; three each for 3xTF32), where the wide mma form issues 9,216 (s
// in both output chunks' blocks).
//
// Registers: o 64 a thread (16 rows x 128 columns over 32 lanes), s 16,
// the 3xTF32 operand halves. Shared memory: q, k, v [64][260] float32
// and p [64][68]: 217,600 bytes, one block an SM (ops/flash_plan.py).
// ptxas (the H100 build of chip_smoke.py, nvcc 12.9): 235 registers, no
// spills.
//
// Bound on the card: operations, two products of 2 T^2 D flops per
// (batch, head), halved when causal, as three TF32 products each; q, k,
// v read and out, lse written once.
#include "flash_mma.cuh"

namespace egf {
namespace {

constexpr int kThreads = 256;

template <int D>
struct FwdWholeLayout {
  static constexpr int kLd = Tile<float, D>::kLd;  // D + 4
  static constexpr int kTile = Tile<float, D>::kBytes;
  static constexpr int kLdP = kRows + 4;
  static constexpr int kOffK = kTile;
  static constexpr int kOffV = 2 * kTile;
  static constexpr int kOffP = 3 * kTile;
  static constexpr int kOffRed = kOffP + kRows * kLdP * 4;
  static constexpr size_t kBytes = kOffRed + 2 * kRows * 4;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_whole_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out, float* __restrict__ lse,
                           const int* __restrict__ offs, Strides st, Shape s,
                           float scale, int vec) {
  using M = Tc<float>;
  using L = FwdWholeLayout<D>;
  constexpr int kLd = L::kLd, kLdP = L::kLdP;
  constexpr int kNo = D / 2 / 8;  // n8 tiles of a warp's output columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* const q_s = reinterpret_cast<float*>(smem_raw);
  float* const k_s = reinterpret_cast<float*>(smem_raw + L::kOffK);
  float* const v_s = reinterpret_cast<float*>(smem_raw + L::kOffV);
  float* const p_s = reinterpret_cast<float*>(smem_raw + L::kOffP);
  float* const red = reinterpret_cast<float*>(smem_raw + L::kOffRed);

  const int nt = (s.t + kRows - 1) / kRows;
  const int bhn = s.b * s.h;
  const int qi = nt - 1 - (int)(blockIdx.x / bhn);  // heaviest first
  const int bh = (int)(blockIdx.x % bhn);
  const int b = bh / s.h, hh = bh % s.h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int rb = warp & 3, half = warp >> 2;
  const int kofs = half * 32;    // this warp's keys of a tile
  const int c0 = half * D / 2;   // ... and its output columns
  const int row0 = qi * kRows + rb * 16;
  // rows g and g + 8 of this warp's in the [2][64] exchange: its own
  // half's, and the other's
  float* const red_own = red + half * kRows + rb * 16 + g;
  const float* const red_other = red + (half ^ 1) * kRows + rb * 16 + g;

  int q_off, k_off;
  load_offsets(offs, s, b, q_off, k_off);
  const float* qp = q + b * st.v[0] + hh * st.v[2];
  const float* kp = k + b * st.v[3] + hh * st.v[5];
  const float* vp = v + b * st.v[6] + hh * st.v[8];
  int k_end = nt - 1;
  if (s.causal) {
    const int last_key = q_off - k_off + qi * kRows + kRows - 1;
    k_end = last_key < 0 ? -1 : min(k_end, last_key / kRows);
  }

  // groups in flight: (q, k 0), (v 0), then per tile (k j+1), (v j+1)
  load_tile_async<float, D, kThreads>(q_s, qp, st.v[1], qi * kRows, s.t, s.d,
                                      vec);
  if (k_end >= 0)
    load_tile_async<float, D, kThreads>(k_s, kp, st.v[4], 0, s.t, s.d, vec);
  cp_async_commit();
  if (k_end >= 0)
    load_tile_async<float, D, kThreads>(v_s, vp, st.v[7], 0, s.t, s.d, vec);
  cp_async_commit();

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kNo][4];
#pragma unroll
  for (int n = 0; n < kNo; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float c = scale * kLog2e;

  for (int kj = 0; kj <= k_end; ++kj) {
    cp_async_wait_one();
    __syncthreads();  // k tile kj is in
    // s over all D columns, this warp's 16 rows x 32 keys
    float sc[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll 4
    for (int kc = 0; kc < D / M::kK; ++kc) {
      const M::A a = M::load_a(q_s, kLd, rb * 16, kc * M::kK, lane);
#pragma unroll
      for (int n = 0; n < 4; n += 2) {
        M::B b0, b1;
        M::load_bt2(b0, b1, k_s, kLd, kofs + n * 8, kc * M::kK, lane);
        M::mma(sc[n], a, b0);
        M::mma(sc[n + 1], a, b1);
      }
    }
    const int key0 = kj * kRows;
    const bool full = key0 + kRows <= s.t &&
                      (!s.causal || q_off + row0 >= k_off + key0 + kRows - 1);
    if (!full) {
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!valid_at(row0 + g + 8 * (e >> 1),
                        key0 + kofs + n * 8 + 2 * tq + (e & 1), s.t, s.causal,
                        q_off, k_off))
            sc[n][e] = -INFINITY;
    }
    float mx[2] = {m[0], m[1]}, mc[2];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
#pragma unroll
    for (int i = 0; i < 2; ++i) mx[i] = quad_max(mx[i]);
    if (tq == 0) red_own[0] = mx[0], red_own[8] = mx[1];
    __syncthreads();  // both halves' row maxima are in; k_s is free
    if (kj < k_end)
      load_tile_async<float, D, kThreads>(k_s, kp, st.v[4], (kj + 1) * kRows,
                                          s.t, s.d, vec);
    cp_async_commit();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float mn = fmaxf(mx[i], red_other[8 * i]);
      const float corr = fast_exp2((m[i] - mn) * c);
      m[i] = mn;
      mc[i] = mn * c;
      l[i] *= corr;  // this lane's share of its half's row sum
#pragma unroll
      for (int n = 0; n < kNo; ++n) {
        acc[n][2 * i] *= corr;
        acc[n][2 * i + 1] *= corr;
      }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[n][e] = fast_exp2(fmaf(sc[n][e], c, -mc[e >> 1]));
        l[e >> 1] += sc[n][e];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float2*>(p_s + (rb * 16 + g + 8 * i) * kLdP + kofs +
                                   n * 8 + 2 * tq) =
            make_float2(sc[n][2 * i], sc[n][2 * i + 1]);
    }
    cp_async_wait_one();
    __syncthreads();  // v tile kj and the whole p tile are in
    // o += p v over the tile's 64 keys, this warp's 128 columns; p's A
    // fragment in the k order of Tc<float>::from_acc (k index t: key
    // 2t, t + 4: key 2t + 1), which load_b2 reads v's rows in
#pragma unroll 2
    for (int kc = 0; kc < kRows / M::kK; ++kc) {
      const float* pr = p_s + (rb * 16 + g) * kLdP + kc * M::kK + 2 * tq;
      const float2 lo = *reinterpret_cast<const float2*>(pr);
      const float2 hi = *reinterpret_cast<const float2*>(pr + 8 * kLdP);
      const uint32_t r[4] = {__float_as_uint(lo.x), __float_as_uint(hi.x),
                             __float_as_uint(lo.y), __float_as_uint(hi.y)};
      M::A a;
      M::split(r, a.big, a.small);
#pragma unroll
      for (int n = 0; n < kNo; n += 2) {
        M::B b0, b1;
        M::load_b2(b0, b1, v_s, kLd, kc * M::kK, c0 + n * 8, lane);
        M::mma(acc[n], a, b0);
        M::mma(acc[n + 1], a, b1);
      }
    }
    __syncthreads();  // every warp is done with v_s and p_s
    if (kj < k_end)
      load_tile_async<float, D, kThreads>(v_s, vp, st.v[7], (kj + 1) * kRows,
                                          s.t, s.d, vec);
    cp_async_commit();
  }
  cp_async_wait_all();  // nothing left in flight when the block exits

  // the row sums of the two halves meet: l = l_0 + l_1 in both warps
  float lt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) lt[i] = quad_sum(l[i]);
  if (tq == 0) red_own[0] = lt[0], red_own[8] = lt[1];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    const float l_safe = fmaxf(lt[i] + red_other[8 * i], kLFloor);
    if (row >= s.t) continue;
    // a fully masked row keeps m = -1e30 unscaled, as the plain version
    const float m_s = m[i] == kNegInf ? kNegInf : m[i] * scale;
    if (tq == 0 && half == 0)
      lse[(int64_t)bh * s.t + row] = m_s + logf(l_safe);
    float* const dst = out + (((int64_t)b * s.t + row) * s.h + hh) * D + c0;
#pragma unroll
    for (int n = 0; n < kNo; ++n)
      *reinterpret_cast<float2*>(dst + n * 8 + 2 * tq) =
          make_float2(acc[n][2 * i] / l_safe, acc[n][2 * i + 1] / l_safe);
  }
}

}  // namespace

cudaError_t fwd_whole(const void* q, const void* k, const void* v, void* out,
                      float* lse, const int* offs, const int64_t* st,
                      const Shape& s, void* stream) {
  using L = FwdWholeLayout<256>;
  static_assert(L::kBytes <= kSmemMax, "the tiles fit a block");
  if (s.d != 256) return cudaErrorInvalidValue;
  const Strides sv = strides_from(st, 3);
  const void* ptrs[3] = {q, k, v};
  const int vec = rows_aligned16(ptrs, sv, 3, sizeof(float));
  const int64_t nt = (s.t + kRows - 1) / kRows;
  return launch_kernel<kThreads>(flash_fwd_whole_kernel<256>, nt * s.b * s.h,
                                 L::kBytes, stream, (const float*)q,
                                 (const float*)k, (const float*)v,
                                 (float*)out, lse, offs, sv, s,
                                 softmax_scale(s.d), vec);
}

size_t fwd_whole_smem(int d) {
  return d == 256 ? FwdWholeLayout<256>::kBytes : 0;
}

}  // namespace egf
