// FlashAttention-2 backward, dQ, in float32 at D = 256 with the score
// tiles built once: the whole form of flash_dq.cu (flash_base.cuh's
// flash_form picks it), the same function.
//
// Replaces the TPU kernel eventgrad_tpu/ops/attention.py:_dq_kernel (as
// flash_dq.cu does; its note gives the recurrence, the masking, the
// causal tile skip and the heaviest-first grid order, all kept here).
//
// Why not wgmma: flash_fwd_whole.cu's reason (tf32 wgmma wants every
// shared-memory operand K-major, and 3xTF32 wants each in two halves).
// The products stay 3xTF32 on mma.sync (flash_mma.cuh), split so that
// none is repeated.
//
// A block owns 64 query rows (q and dO [64][260] float32 stay for the
// whole sweep) and sweeps 32-key K/V tiles (k and v [32][260], one
// buffer each: 64-key tiles would not fit beside q and dO) with 8 warps:
// warp w works on queries 16 (w % 4) .. + 15. Per K tile:
//
//   scores  warps 0-3: s = q k^T; warps 4-7: dp = dO v^T; each over all
//           256 columns and the tile's 32 keys, so s and dp are built
//           once (the wide mma form computes both once per 128-column
//           chunk of dQ: five products where three do);
//   p, ds   warps 0-3 write p to a [64][36] tile; warps 4-7 read it back
//           at their own dp's positions and write ds = p (dp - delta)
//           scale over it;
//   dQ      warp w: dQ += ds k over columns 128 (w / 4) .. + 127, ds
//           read back over the tile's 32 keys.
//
// Each dQ element is summed by one warp over the keys in order, with no
// atomics. v is free once the scores are built, so tile j + 1's v loads
// while tile j's ds and ds k run; k loads after every warp is done with
// it (four barriers a tile). lse and delta of a warp's rows sit in
// registers for the whole sweep.
//
// Per 64 queries x 64 keys that is 9,216 mma.m16n8k8 (3,072 for each
// product, three each for 3xTF32), where the wide mma form issues 15,360.
//
// Registers: dQ 64 a thread (16 queries x 128 columns over 32 lanes), a
// score tile 16, the 3xTF32 operand halves. Shared memory: q, dO
// [64][260], k, v [32][260] float32 and the [64][36] p / ds tile:
// 208,896 bytes, one block an SM (ops/flash_plan.py). ptxas and the HMMA
// count: the build phase of chip_smoke.py.
//
// Bound on the card: operations, three products of 2 T^2 D flops per
// (batch, head), halved when causal, as three TF32 products each; q, k,
// v, dO, lse, delta read and dQ written once.
#include "flash_mma.cuh"

namespace egf {
namespace {

constexpr int kThreads = 256;
constexpr int kKeys = 32;  // keys of a K/V tile

template <int D>
struct DqWholeLayout {
  static constexpr int kLd = Tile<float, D>::kLd;     // D + 4
  static constexpr int kQT = Tile<float, D>::kBytes;  // a q (or dO) tile
  static constexpr int kKT = kKeys * kLd * 4;         // a k (or v) tile
  static constexpr int kLdS = kKeys + 4;
  static constexpr int kOffDo = kQT;
  static constexpr int kOffK = 2 * kQT;
  static constexpr int kOffV = kOffK + kKT;
  static constexpr int kOffS = kOffV + kKT;  // p, then ds
  static constexpr size_t kBytes = kOffS + kRows * kLdS * 4;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dq_whole_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dq,
                          const int* __restrict__ offs, Strides st, Shape s,
                          float scale, int vec) {
  using M = Tc<float>;
  using L = DqWholeLayout<D>;
  constexpr int kLd = L::kLd, kLdS = L::kLdS;
  constexpr int kNo = 128 / 8;  // n8 tiles of a warp's dQ columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* const q_s = reinterpret_cast<float*>(smem_raw);
  float* const do_s = reinterpret_cast<float*>(smem_raw + L::kOffDo);
  float* const k_s = reinterpret_cast<float*>(smem_raw + L::kOffK);
  float* const v_s = reinterpret_cast<float*>(smem_raw + L::kOffV);
  float* const ps_s = reinterpret_cast<float*>(smem_raw + L::kOffS);

  const int nt = (s.t + kRows - 1) / kRows;
  const int nk = (s.t + kKeys - 1) / kKeys;
  const int bhn = s.b * s.h;
  const int qi = nt - 1 - (int)(blockIdx.x / bhn);  // heaviest first
  const int bh = (int)(blockIdx.x % bhn);
  const int b = bh / s.h, hh = bh % s.h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int rb = warp & 3;            // this warp's 16 queries
  const bool is_s = warp < 4;         // s (warps 0-3) or dp (4-7)
  const int c0 = (warp >> 2) * 128;   // its dQ columns
  const int row0 = qi * kRows + rb * 16;  // this warp's first query

  int q_off, k_off;
  load_offsets(offs, s, b, q_off, k_off);
  const float* qp = q + b * st.v[0] + hh * st.v[2];
  const float* kp = k + b * st.v[3] + hh * st.v[5];
  const float* vp = v + b * st.v[6] + hh * st.v[8];
  const float* dop = dout + b * st.v[9] + hh * st.v[11];

  // the last K tile with a key that some row of this block may see
  int k_end = nk - 1;
  if (s.causal) {
    const int last_key = q_off - k_off + qi * kRows + kRows - 1;
    k_end = last_key < 0 ? -1 : min(k_end, last_key / kKeys);
  }
  if (k_end >= 0) {
    load_tile_async<float, D, kThreads>(q_s, qp, st.v[1], qi * kRows, s.t,
                                        s.d, vec);
    load_tile_async<float, D, kThreads>(do_s, dop, st.v[10], qi * kRows,
                                        s.t, s.d, vec);
    load_tile_async<float, D, kThreads, kKeys>(k_s, kp, st.v[4], 0, s.t, s.d,
                                               vec);
    load_tile_async<float, D, kThreads, kKeys>(v_s, vp, st.v[7], 0, s.t, s.d,
                                               vec);
  }
  cp_async_commit();

  // rows g and g + 8: log2(e) lse (warps 0-3) or delta (4-7), 0 past t
  const float* const rowv = (is_s ? lse : delta) + (int64_t)bh * s.t;
  float vr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    vr[i] = k_end >= 0 && row < s.t ? rowv[row] * (is_s ? kLog2e : 1.f)
                                    : 0.f;
  }
  const float c = scale * kLog2e;
  float acc[kNo][4];
#pragma unroll
  for (int n = 0; n < kNo; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float* const as = is_s ? q_s : do_s;  // the score product's A
  const float* const bs = is_s ? k_s : v_s;   // ... and B
  // this lane's rows g and g + 8 of its 16 queries in the p / ds tile
  float* const ps_row = ps_s + (rb * 16 + g) * kLdS;

  for (int kj = 0; kj <= k_end; ++kj) {
    cp_async_wait_all();
    __syncthreads();  // k and v of tile kj are in

    // s or dp over all D columns: rows this warp's 16 queries, columns
    // the tile's 32 keys
    float sc[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll 4
    for (int kc = 0; kc < D / M::kK; ++kc) {
      const M::A a = M::load_a(as, kLd, rb * 16, kc * M::kK, lane);
#pragma unroll
      for (int n = 0; n < 4; n += 2) {
        M::B b0, b1;
        M::load_bt2(b0, b1, bs, kLd, n * 8, kc * M::kK, lane);
        M::mma(sc[n], a, b0);
        M::mma(sc[n + 1], a, b1);
      }
    }

    if (is_s) {
      // p = 2^(c s - log2(e) lse); a masked score is -inf, so its p
      // (and the ds built from it) is exactly 0. Only tiles that cross
      // the causal diagonal or the end of T are masked.
      const int key0 = kj * kKeys;
      const bool full = key0 + kKeys <= s.t &&
                        (!s.causal || q_off + row0 >= k_off + key0 + kKeys - 1);
      if (!full) {
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!valid_at(row0 + g + 8 * (e >> 1),
                          key0 + n * 8 + 2 * tq + (e & 1), s.t, s.causal,
                          q_off, k_off))
              sc[n][e] = -INFINITY;
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<float2*>(ps_row + 8 * i * kLdS + n * 8 + 2 * tq) =
              make_float2(fast_exp2(fmaf(sc[n][2 * i], c, -vr[i])),
                          fast_exp2(fmaf(sc[n][2 * i + 1], c, -vr[i])));
    }
    __syncthreads();  // p is in; every warp is done with v
    if (kj < k_end)
      load_tile_async<float, D, kThreads, kKeys>(v_s, vp, st.v[7],
                                                 (kj + 1) * kKeys, s.t, s.d,
                                                 vec);
    cp_async_commit();
    if (!is_s) {
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float2* const at =
              reinterpret_cast<float2*>(ps_row + 8 * i * kLdS + n * 8 + 2 * tq);
          const float2 p = *at;
          *at = make_float2(p.x * (sc[n][2 * i] - vr[i]) * scale,
                            p.y * (sc[n][2 * i + 1] - vr[i]) * scale);
        }
    }
    __syncthreads();  // ds is in

    // dQ += ds k in this warp's 128 columns, reducing over the tile's 32
    // keys; ds's A fragments in the k order of Tc<float>::from_acc,
    // which load_b2 reads the rows in
#pragma unroll
    for (int kc = 0; kc < kKeys / M::kK; ++kc) {
      const int col = kc * M::kK + 2 * tq;
      const float2 lo = *reinterpret_cast<const float2*>(ps_row + col);
      const float2 hi =
          *reinterpret_cast<const float2*>(ps_row + 8 * kLdS + col);
      const uint32_t r[4] = {__float_as_uint(lo.x), __float_as_uint(hi.x),
                             __float_as_uint(lo.y), __float_as_uint(hi.y)};
      M::A a;
      M::split(r, a.big, a.small);
#pragma unroll
      for (int n = 0; n < kNo; n += 2) {
        M::B b0, b1;
        M::load_b2(b0, b1, k_s, kLd, kc * M::kK, c0 + n * 8, lane);
        M::mma(acc[n], a, b0);
        M::mma(acc[n + 1], a, b1);
      }
    }
    __syncthreads();  // every warp is done with k and ds
    if (kj < k_end)
      load_tile_async<float, D, kThreads, kKeys>(k_s, kp, st.v[4],
                                                 (kj + 1) * kKeys, s.t, s.d,
                                                 vec);
    cp_async_commit();
  }
  cp_async_wait_all();  // nothing left in flight when the block exits

  // rows of a hop wholly in the future are written as zeros
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    if (row >= s.t) continue;
    float* const at = dq + (((int64_t)b * s.t + row) * s.h + hh) * D + c0;
#pragma unroll
    for (int n = 0; n < kNo; ++n)
      *reinterpret_cast<float2*>(at + n * 8 + 2 * tq) =
          make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

}  // namespace

cudaError_t dq_whole(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dq, const int* offs, const int64_t* st,
                     const Shape& s, void* stream) {
  using L = DqWholeLayout<256>;
  static_assert(L::kBytes <= kSmemMax, "the tiles fit a block");
  if (s.d != 256) return cudaErrorInvalidValue;
  const Strides sv = strides_from(st, 4);
  const void* ptrs[4] = {q, k, v, dout};
  const int vec = rows_aligned16(ptrs, sv, 4, sizeof(float));
  const int64_t nt = (s.t + kRows - 1) / kRows;
  return launch_kernel<kThreads>(
      flash_dq_whole_kernel<256>, nt * s.b * s.h, L::kBytes, stream,
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      lse, delta, (float*)dq, offs, sv, s, softmax_scale(s.d), vec);
}

size_t dq_whole_smem(int d) {
  return d == 256 ? DqWholeLayout<256>::kBytes : 0;
}

}  // namespace egf
