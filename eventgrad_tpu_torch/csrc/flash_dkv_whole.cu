// FlashAttention-2 backward, dK and dV, in float32 at D = 256 with the
// score tiles built once: the whole form of flash_dkv.cu (flash_base.cuh's
// flash_form picks it), the same function.
//
// Replaces the TPU kernel eventgrad_tpu/ops/attention.py:_dkv_kernel (as
// flash_dkv.cu does; its note gives the recurrence in the transposed
// orientation, the masking and the causal tile skip, all kept here).
//
// Why not wgmma: flash_fwd_whole.cu's reason (tf32 wgmma wants every
// shared-memory operand K-major, and 3xTF32 wants each in two halves).
// The products stay 3xTF32 on mma.sync (flash_mma.cuh), split so that
// none is repeated.
//
// A block owns 32 keys (k and v [32][260] float32 stay for the whole
// sweep; 64 keys would not fit beside the [64][260] q and dO tiles) and
// has 8 warps: warp w works on keys 16 (w % 2) .. + 15 in role w / 2.
// Per 64-query tile:
//
//   scores      roles 0 and 1: s^T = k q^T over queries 0-31 and 32-63;
//               roles 2 and 3: dp^T = v dO^T likewise; each over all
//               256 columns, so s^T and dp^T are built once (the wide
//               mma form computes both in both warps of a pair and once
//               per 128-column chunk: ten products where four do);
//   p^T, ds^T   roles 0 and 1 write p^T to a [32][68] tile; roles 2 and 3
//               read it back at their own dp^T's positions and write
//               ds^T = p^T (dp^T - delta) scale beside it;
//   dV, dK      role r: dV += p^T dO and dK += ds^T q over columns
//               64 r .. 64 r + 63, p^T and ds^T read back over all 64
//               queries.
//
// Each dK/dV element is summed by one warp over the queries in order,
// with no atomics. q, dO, lse and delta have one buffer each: a tile
// loads after every warp is done with the last (four barriers a tile).
//
// Per 64 keys x 64 queries that is 12,288 mma.m16n8k8 (3,072 for each
// product, three each for 3xTF32), where the wide mma form issues 30,720.
//
// Registers: dK and dV 64 a thread (16 keys x 64 columns each over 32
// lanes), a score tile 16, the 3xTF32 operand halves. Shared memory:
// k, v [32][260], q, dO [64][260], p^T, ds^T [32][68] float32 and lse,
// delta [64]: 217,600 bytes, one block an SM (ops/flash_plan.py).
// ptxas (the H100 build of chip_smoke.py, nvcc 12.9): 232 registers, no
// spills.
//
// Bound on the card: operations, four products of 2 T^2 D flops per
// (batch, head), halved when causal, as three TF32 products each; q, k,
// v, dO, lse, delta read and dK, dV written once.
#include "flash_mma.cuh"

namespace egf {
namespace {

constexpr int kThreads = 256;
constexpr int kKeys = 32;  // keys of a block

template <int D>
struct DkvWholeLayout {
  static constexpr int kLd = Tile<float, D>::kLd;  // D + 4
  static constexpr int kKT = kKeys * kLd * 4;      // a k (or v) tile
  static constexpr int kQT = Tile<float, D>::kBytes;  // a q (or dO) tile
  static constexpr int kLdP = kRows + 4;
  static constexpr int kPT = kKeys * kLdP * 4;  // p^T (or ds^T)
  static constexpr int kOffV = kKT;
  static constexpr int kOffQ = 2 * kKT;
  static constexpr int kOffDo = kOffQ + kQT;
  static constexpr int kOffP = kOffDo + kQT;
  static constexpr int kOffDs = kOffP + kPT;
  static constexpr int kOffVec = kOffDs + kPT;
  static constexpr size_t kBytes = kOffVec + 2 * kRows * 4;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dkv_whole_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dk, float* __restrict__ dv,
                           const int* __restrict__ offs, Strides st, Shape s,
                           float scale, int vec) {
  using M = Tc<float>;
  using L = DkvWholeLayout<D>;
  constexpr int kLd = L::kLd, kLdP = L::kLdP;
  constexpr int kNo = 64 / 8;  // n8 tiles of a warp's dK/dV columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* const k_s = reinterpret_cast<float*>(smem_raw);
  float* const v_s = reinterpret_cast<float*>(smem_raw + L::kOffV);
  float* const q_s = reinterpret_cast<float*>(smem_raw + L::kOffQ);
  float* const do_s = reinterpret_cast<float*>(smem_raw + L::kOffDo);
  float* const pt_s = reinterpret_cast<float*>(smem_raw + L::kOffP);
  float* const ds_s = reinterpret_cast<float*>(smem_raw + L::kOffDs);
  float* const lse_s = reinterpret_cast<float*>(smem_raw + L::kOffVec);
  float* const dl_s = lse_s + kRows;

  const int nt = (s.t + kRows - 1) / kRows;
  const int bhn = s.b * s.h;
  const int kj = (int)(blockIdx.x / bhn);  // heaviest first
  const int bh = (int)(blockIdx.x % bhn);
  const int b = bh / s.h, hh = bh % s.h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int rb = warp & 1, role = warp >> 1;
  const bool is_s = role < 2;         // s^T (roles 0, 1) or dp^T (2, 3)
  const int qofs = (role & 1) * 32;   // the queries of its score block
  const int c0 = role * 64;           // its dK/dV columns
  const int key0 = kj * kKeys + rb * 16;  // this warp's first key

  int q_off, k_off;
  load_offsets(offs, s, b, q_off, k_off);
  const float* qp = q + b * st.v[0] + hh * st.v[2];
  const float* kp = k + b * st.v[3] + hh * st.v[5];
  const float* vp = v + b * st.v[6] + hh * st.v[8];
  const float* dop = dout + b * st.v[9] + hh * st.v[11];
  const float* lse_p = lse + (int64_t)bh * s.t;
  const float* dl_p = delta + (int64_t)bh * s.t;

  // the first Q tile with a query that may see some key of this block
  int q_begin = 0;
  if (s.causal) {
    const int first_query = k_off - q_off + kj * kKeys;
    q_begin = first_query <= 0 ? 0 : min(nt, first_query / kRows);
  }
  if (q_begin < nt) {  // k and v ride with the first Q tile's group
    load_tile_async<float, D, kThreads, kKeys>(k_s, kp, st.v[4], kj * kKeys,
                                               s.t, s.d, vec);
    load_tile_async<float, D, kThreads, kKeys>(v_s, vp, st.v[7], kj * kKeys,
                                               s.t, s.d, vec);
  }

  const float c = scale * kLog2e;
  float acc_k[kNo][4], acc_v[kNo][4];
#pragma unroll
  for (int n = 0; n < kNo; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;
  const float* const as = is_s ? k_s : v_s;   // the score product's A
  const float* const bs = is_s ? q_s : do_s;  // ... and B
  // this lane's rows g and g + 8 of its 16 keys in p^T and ds^T
  float* const pt_row = pt_s + (rb * 16 + g) * kLdP;
  float* const ds_row = ds_s + (rb * 16 + g) * kLdP;

  for (int qi = q_begin; qi < nt; ++qi) {
    const int qrow0 = qi * kRows;
    load_tile_async<float, D, kThreads>(q_s, qp, st.v[1], qrow0, s.t, s.d,
                                        vec);
    load_tile_async<float, D, kThreads>(do_s, dop, st.v[10], qrow0, s.t, s.d,
                                        vec);
    load_vec_async(lse_s, lse_p, qrow0, s.t);
    load_vec_async(dl_s, dl_p, qrow0, s.t);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();  // tile qi is in

    // s^T or dp^T over all D columns: rows this warp's 16 keys, columns
    // queries qofs .. qofs + 31 of the tile
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
        M::load_bt2(b0, b1, bs, kLd, qofs + n * 8, kc * M::kK, lane);
        M::mma(sc[n], a, b0);
        M::mma(sc[n + 1], a, b1);
      }
    }

    if (is_s) {
      // p^T = 2^(c s - log2(e) lse); a masked score is -inf, so its p
      // (and the ds built from it) is exactly 0. Only tiles that cross
      // the causal diagonal or the end of T are masked.
      const bool full = qrow0 + kRows <= s.t && key0 + 16 <= s.t &&
                        (!s.causal || q_off + qrow0 >= k_off + key0 + 15);
      if (!full) {
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qpos = qrow0 + qofs + n * 8 + 2 * tq + (e & 1);
            if (qpos >= s.t || !valid_at(qpos, key0 + g + 8 * (e >> 1), s.t,
                                         s.causal, q_off, k_off))
              sc[n][e] = -INFINITY;
          }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int col = qofs + n * 8 + 2 * tq;
        const float lc0 = lse_s[col] * kLog2e, lc1 = lse_s[col + 1] * kLog2e;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<float2*>(pt_row + 8 * i * kLdP + col) =
              make_float2(fast_exp2(fmaf(sc[n][2 * i], c, -lc0)),
                          fast_exp2(fmaf(sc[n][2 * i + 1], c, -lc1)));
      }
    }
    __syncthreads();  // p^T is in
    if (!is_s) {
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int col = qofs + n * 8 + 2 * tq;
        const float dl0 = dl_s[col], dl1 = dl_s[col + 1];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float2 p =
              *reinterpret_cast<const float2*>(pt_row + 8 * i * kLdP + col);
          *reinterpret_cast<float2*>(ds_row + 8 * i * kLdP + col) =
              make_float2(p.x * (sc[n][2 * i] - dl0) * scale,
                          p.y * (sc[n][2 * i + 1] - dl1) * scale);
        }
      }
    }
    __syncthreads();  // ds^T is in

    // dV += p^T dO and dK += ds^T q in this warp's 64 columns, reducing
    // over the tile's 64 queries; p^T's and ds^T's A fragments in the k
    // order of Tc<float>::from_acc, which load_b2 reads the rows in
#pragma unroll 2
    for (int kc = 0; kc < kRows / M::kK; ++kc) {
      const int col = kc * M::kK + 2 * tq;
      const float2 plo = *reinterpret_cast<const float2*>(pt_row + col);
      const float2 phi =
          *reinterpret_cast<const float2*>(pt_row + 8 * kLdP + col);
      const float2 dlo = *reinterpret_cast<const float2*>(ds_row + col);
      const float2 dhi =
          *reinterpret_cast<const float2*>(ds_row + 8 * kLdP + col);
      const uint32_t pr[4] = {__float_as_uint(plo.x), __float_as_uint(phi.x),
                              __float_as_uint(plo.y), __float_as_uint(phi.y)};
      const uint32_t dr[4] = {__float_as_uint(dlo.x), __float_as_uint(dhi.x),
                              __float_as_uint(dlo.y), __float_as_uint(dhi.y)};
      M::A pa, da;
      M::split(pr, pa.big, pa.small);
      M::split(dr, da.big, da.small);
#pragma unroll
      for (int n = 0; n < kNo; n += 2) {
        M::B b0, b1;
        M::load_b2(b0, b1, do_s, kLd, kc * M::kK, c0 + n * 8, lane);
        M::mma(acc_v[n], pa, b0);
        M::mma(acc_v[n + 1], pa, b1);
        M::load_b2(b0, b1, q_s, kLd, kc * M::kK, c0 + n * 8, lane);
        M::mma(acc_k[n], da, b0);
        M::mma(acc_k[n + 1], da, b1);
      }
    }
    __syncthreads();  // every warp is done with this tile
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = key0 + g + 8 * i;
    if (row >= s.t) continue;
    const int64_t at = (((int64_t)b * s.t + row) * s.h + hh) * D + c0;
#pragma unroll
    for (int n = 0; n < kNo; ++n) {
      *reinterpret_cast<float2*>(dk + at + n * 8 + 2 * tq) =
          make_float2(acc_k[n][2 * i], acc_k[n][2 * i + 1]);
      *reinterpret_cast<float2*>(dv + at + n * 8 + 2 * tq) =
          make_float2(acc_v[n][2 * i], acc_v[n][2 * i + 1]);
    }
  }
}

}  // namespace

cudaError_t dkv_whole(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dk, void* dv, const int* offs, const int64_t* st,
                      const Shape& s, void* stream) {
  using L = DkvWholeLayout<256>;
  static_assert(L::kBytes <= kSmemMax, "the tiles fit a block");
  if (s.d != 256) return cudaErrorInvalidValue;
  const Strides sv = strides_from(st, 4);
  const void* ptrs[4] = {q, k, v, dout};
  const int vec = rows_aligned16(ptrs, sv, 4, sizeof(float));
  const int64_t nk = (s.t + kKeys - 1) / kKeys;
  return launch_kernel<kThreads>(
      flash_dkv_whole_kernel<256>, nk * s.b * s.h, L::kBytes, stream,
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      lse, delta, (float*)dk, (float*)dv, offs, sv, s, softmax_scale(s.d),
      vec);
}

size_t dkv_whole_smem(int d) {
  return d == 256 ? DkvWholeLayout<256>::kBytes : 0;
}

}  // namespace egf
