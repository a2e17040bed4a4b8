// FlashAttention-2 backward, dK and dV, on Hopper's wgmma, bfloat16 at
// D = 64, 128 and 256: the wgmma form of flash_dkv.cu (flash_base.cuh's
// flash_form picks it), the same function.
//
// Replaces the TPU kernel eventgrad_tpu/ops/attention.py:_dkv_kernel (as
// flash_dkv.cu does; its note gives the recurrence in the transposed
// orientation, the masking and the causal tile skip, all kept here).
//
// A block owns 64 keys of one (batch, head) and has two warpgroups; the
// block's first thread also issues every TMA copy (flash_fwd_wgmma.cu
// says why no warp is set apart to produce). k and v arrive once and stay
// in shared memory for the whole sweep; the Q tiles' q and dO come
// through a ring of stages (4 at D = 64, 3 at 128, 2 at 256) with a
// "full" and an "empty" mbarrier each, refilled as in
// flash_fwd_wgmma.cu. The two warpgroups split the work by product, both
// over the same 64 keys:
//
//   warpgroup 0: s^T = k q^T (D / 16 wgmma m64n64k16, both operands
//                from shared memory), p^T, then dV += p^T dO (4 wgmma
//                m64nDk16, p^T from registers, dO MN-major);
//   warpgroup 1: dp^T = v dO^T (likewise), ds^T = p^T (dp^T - delta)
//                scale, then dK += ds^T q.
//
// p^T crosses from warpgroup 0 to warpgroup 1 through 16 KB of shared
// memory in accumulator order (register r of thread i at r * 128 + i:
// both score tiles have one layout, so each thread reads the p of its
// own dp), under two named barriers (1: p is in; 2: it has been read).
// Four products of width D per tile at every D: the mma form
// (flash_dkv.cu) computes s^T and dp^T in both warps of a pair and, in
// its wide form at D = 256, once per 128-column chunk of dK/dV: ten. Each dK/dV element is summed
// by one warpgroup in a fixed order, with no atomics.
//
// Registers: dV (or dK) takes D / 2 a thread (128 at D = 256), a score
// tile 32, its bf16 pairs 16, the tile's lse (or delta) 16. Shared
// memory: k and v 2 x 64 x D x 2 bytes, the stages 2 x 64 x D x 2 bytes
// each, the exchange and the barriers: 214,056 bytes at D = 256, 148,536
// at 128, 99,400 at 64 (ops/flash_plan.py). ptxas (the H100 build of
// chip_smoke.py, nvcc 12.9): 213 registers at D = 256, 150 at 128, 118
// at 64, no spills. Both warpgroups run one code path, whose SASS holds
// D / 16 + 4 HGMMA (20 at D = 256): a tile's four products are twice
// that many wgmma.
//
// Bound on the card: operations, four products of 2 T^2 D flops per
// (batch, head), halved when causal, at the bf16 tensor-core rate;
// against q, k, v, dO, lse, delta read and dK, dV written once.
#include "flash_sm90.cuh"

namespace egf {
namespace {

using namespace sm90;
using bf16 = __nv_bfloat16;

// two warpgroups; the first thread also issues the copies
constexpr int kThreads = 256;

template <int D>
struct DkvLayout {
  static constexpr int kN = 64;  // keys of a block, queries of a Q tile
  static constexpr int kSlabs = D / 64;
  static constexpr int kStages = D == 256 ? 2 : D == 128 ? 3 : 4;
  static constexpr int kTile = kN * D * 2;  // bytes of a [64, D] tile
  static constexpr int kSlab = kN * 128;    // ... of one column slab
  static constexpr int kOffV = kTile;
  static constexpr int kOffQ = 2 * kTile;                   // q stages
  static constexpr int kOffDo = kOffQ + kStages * kTile;    // dO stages
  static constexpr int kOffX = kOffDo + kStages * kTile;    // p exchange
  static constexpr int kOffBar = kOffX + 32 * 128 * 4;
  static constexpr int kBars = 1 + 2 * kStages;  // k, v; full; empty
  static constexpr size_t kBytes = 1024 + kOffBar + 8 * kBars;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           const int* __restrict__ offs, Shape s,
                           float scale) {
  using L = DkvLayout<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* const smem =
      smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  uint64_t* const kv_full = reinterpret_cast<uint64_t*>(smem + L::kOffBar);
  uint64_t* const full = kv_full + 1;
  uint64_t* const empty = full + L::kStages;

  const int nt = (s.t + L::kN - 1) / L::kN;
  const int bhn = s.b * s.h;
  const int kj = (int)(blockIdx.x / bhn);  // heaviest first
  const int bh = (int)(blockIdx.x % bhn);
  const int b = bh / s.h, hh = bh % s.h;
  int q_off, k_off;
  load_offsets(offs, s, b, q_off, k_off);
  // the first Q tile with a query that may see some key of this block
  int q_begin = 0;
  if (s.causal) {
    const int first_query = k_off - q_off + kj * L::kN;
    q_begin = first_query <= 0 ? 0 : min(nt, first_query / L::kN);
  }

  if (threadIdx.x == 0) {
    bar_init(kv_full, 1);
    for (int i = 0; i < L::kStages; ++i) {
      bar_init(full + i, 1);
      bar_init(empty + i, 256);
    }
    bar_fence_init();
  }
  __syncthreads();

  // Q tile q_begin + i's q and dO into stage i % kStages, by the block's
  // first thread
  const auto issue = [&](int i) {
    const int st = i % L::kStages, qi = q_begin + i;
    bar_expect(full + st, 2 * L::kTile);
    for (int c = 0; c < L::kSlabs; ++c) {
      tma_load(smem + L::kOffQ + st * L::kTile + c * L::kSlab, &tq, full + st,
               c * 64, hh, qi * L::kN, b);
      tma_load(smem + L::kOffDo + st * L::kTile + c * L::kSlab, &tdo,
               full + st, c * 64, hh, qi * L::kN, b);
    }
  };
  const bool leader = threadIdx.x == 0;
  const int n_tiles = nt - q_begin;
  if (leader && n_tiles > 0) {
    // k and v once, and the first Q tiles into every stage
    prefetch_map(&tq);
    prefetch_map(&tk);
    prefetch_map(&tv);
    prefetch_map(&tdo);
    bar_expect(kv_full, 2 * L::kTile);
    for (int c = 0; c < L::kSlabs; ++c) {
      tma_load(smem + c * L::kSlab, &tk, kv_full, c * 64, hh, kj * L::kN, b);
      tma_load(smem + L::kOffV + c * L::kSlab, &tv, kv_full, c * 64, hh,
               kj * L::kN, b);
    }
    for (int i = 0; i < L::kStages && i < n_tiles; ++i) issue(i);
  }

  const int cw = threadIdx.x / 128;  // 0: s^T, dV; 1: dp^T, dK
  const int tid = threadIdx.x % 128;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq4 = lane & 3;
  const int key0 = kj * L::kN + warp * 16;  // this warp's first key
  const float c = scale * kLog2e;
  // the A operand of the score product (k or v) and the row vector
  // (lse or delta) this warpgroup reads
  const unsigned char* const a_s = smem + (cw == 0 ? 0 : L::kOffV);
  const float* const vec = (cw == 0 ? lse : delta) + (int64_t)bh * s.t;
  float* const xch = reinterpret_cast<float*>(smem + L::kOffX);
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  if (q_begin < nt) bar_wait(kv_full, 0);

  for (int qi = q_begin; qi < nt; ++qi) {
    const int i = qi - q_begin, st = i % L::kStages;
    const uint32_t ph = (i / L::kStages) & 1;
    const unsigned char* const q_s = smem + L::kOffQ + st * L::kTile;
    const unsigned char* const do_s = smem + L::kOffDo + st * L::kTile;
    // the score product's B (q or dO) and the accumulate product's B
    // (dO or q)
    const unsigned char* const b_s = cw == 0 ? q_s : do_s;
    const unsigned char* const o_s = cw == 0 ? do_s : q_s;
    const int qrow0 = qi * L::kN;
    // lse (or delta) of this thread's 16 query columns, 8 j + 2 tq4 + e
    float vq[16];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qpos = qrow0 + 8 * j + 2 * tq4 + e;
        vq[2 * j + e] = qpos < s.t ? vec[qpos] : 0.f;
      }

    // s^T = k q^T or dp^T = v dO^T over all D columns: register r holds
    // key g + 8 ((r >> 1) & 1), query 8 (r >> 2) + 2 tq4 + (r & 1)
    float sc[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) sc[r] = 0.f;
    bar_wait(full + st, ph);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(sc,
                   desc(a_s + (kk >> 2) * L::kSlab + (kk & 3) * 32, 16,
                        1024),
                   desc(b_s + (kk >> 2) * L::kSlab + (kk & 3) * 32, 16,
                        1024),
                   kk > 0);
    wg_commit();
    // while the score product runs: once every thread has released
    // tile i - 1's stage, its next tile goes in
    if (leader && i >= 1 && i - 1 + L::kStages < n_tiles) {
      bar_wait(empty + (i - 1) % L::kStages, ((i - 1) / L::kStages) & 1);
      issue(i - 1 + L::kStages);
    }
    wg_wait<0>();
    fence_regs(sc);

    if (cw == 0) {
      // p = 2^(c s - log2(e) lse); a masked score is -inf, so its p
      // (and the ds built from it) is exactly 0. Only tiles that
      // cross the causal diagonal or the end of T are masked.
      const bool full_tile =
          qrow0 + L::kN <= s.t && key0 + 16 <= s.t &&
          (!s.causal || q_off + qrow0 >= k_off + key0 + 15);
      if (!full_tile) {
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          const int qpos = qrow0 + 8 * (r >> 2) + 2 * tq4 + (r & 1);
          if (qpos >= s.t ||
              !valid_at(qpos, key0 + g + 8 * ((r >> 1) & 1), s.t,
                        s.causal, q_off, k_off))
            sc[r] = -INFINITY;
        }
      }
#pragma unroll
      for (int r = 0; r < 32; ++r)
        sc[r] = fast_exp2(
            fmaf(sc[r], c, -(vq[2 * (r >> 2) + (r & 1)] * kLog2e)));
      if (i > 0) named_sync(2, 256);  // the last tile's p has been read
#pragma unroll
      for (int r = 0; r < 32; ++r) xch[r * 128 + tid] = sc[r];
      named_arrive(1, 256);
    } else {
      named_sync(1, 256);  // this tile's p is in
#pragma unroll
      for (int r = 0; r < 32; ++r)
        sc[r] = xch[r * 128 + tid] *
                (sc[r] - vq[2 * (r >> 2) + (r & 1)]) * scale;
      if (qi + 1 < nt) named_arrive(2, 256);
    }
    uint32_t pa[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) acc_to_a(pa[kc], sc, kc);

    // dV += p^T dO, or dK += ds^T q, reducing over the tile's queries
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      wgmma_rs<D>(acc, pa[kc], desc(o_s + kc * 2048, L::kSlab, 1024), 1);
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
    bar_arrive(empty + st);
  }

  bf16* const dst = cw == 0 ? dv : dk;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = key0 + g + 8 * i;
    if (row >= s.t) continue;
    bf16* const at = dst + (((int64_t)b * s.t + row) * s.h + hh) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(at + 8 * j + 2 * tq4) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  }
}

template <int D>
cudaError_t run(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dk, void* dv,
                const int* offs, const int64_t* st, const Shape& s,
                void* stream) {
  using L = DkvLayout<D>;
  static_assert(L::kBytes <= kSmemMax, "the stages fit a block");
  CUtensorMap mq, mk, mv, mdo;
  if (!make_map(&mq, q, s, st, L::kN) || !make_map(&mk, k, s, st + 3, L::kN) ||
      !make_map(&mv, v, s, st + 6, L::kN) ||
      !make_map(&mdo, dout, s, st + 9, L::kN))
    return cudaErrorInvalidValue;
  const int64_t nt = (s.t + L::kN - 1) / L::kN;
  return launch_kernel<kThreads>(flash_dkv_wgmma_kernel<D>, nt * s.b * s.h,
                                 L::kBytes, stream, mq, mk, mv, mdo, lse,
                                 delta, (bf16*)dk, (bf16*)dv, offs, s,
                                 softmax_scale(s.d));
}

}  // namespace

cudaError_t dkv_wgmma(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dk, void* dv, const int* offs, const int64_t* st,
                      const Shape& s, void* stream) {
  switch (s.d) {
    case 64:
      return run<64>(q, k, v, dout, lse, delta, dk, dv, offs, st, s, stream);
    case 128:
      return run<128>(q, k, v, dout, lse, delta, dk, dv, offs, st, s, stream);
    case 256:
      return run<256>(q, k, v, dout, lse, delta, dk, dv, offs, st, s, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

size_t dkv_wgmma_smem(int d) {
  return d == 64    ? DkvLayout<64>::kBytes
         : d == 128 ? DkvLayout<128>::kBytes
         : d == 256 ? DkvLayout<256>::kBytes
                    : 0;
}

}  // namespace egf
