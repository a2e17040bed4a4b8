// FlashAttention-2 backward, dQ, on Hopper's wgmma, bfloat16 at D = 64,
// 128 and 256: the wgmma form of flash_dq.cu (flash_base.cuh's
// flash_form picks it), the same function.
//
// Replaces the TPU kernel eventgrad_tpu/ops/attention.py:_dq_kernel (as
// flash_dq.cu does; its note gives the recurrence, the masking, the
// causal tile skip and the heaviest-first grid order, all kept here).
//
// A block has two warpgroups. q and dO of its query rows arrive once by
// TMA and stay in shared memory for the whole sweep; the 64-key K and V
// tiles come through a ring of stages (4 at D = 64, 3 at 128, 2 at 256)
// with a "full" and an "empty" mbarrier each, refilled as in
// flash_dkv_wgmma.cu (the forward's k/v tensor maps: 64 columns x 64
// rows a box, 128-byte swizzle). Three products of width D per tile, each
// built once: s = q k^T and dp = dO v^T (D / 16 wgmma m64n64k16 each,
// both operands from shared memory, K-major), then dQ += ds k (4 wgmma
// m64nDk16, ds = p (dp - delta) scale from registers, k from shared
// memory MN-major through the transpose flag). The wide mma form
// (flash_dq.cu) rebuilds s and dp once per 128-column output chunk, five
// products at D = 256. Each dQ element is summed by one warpgroup over the
// keys in order, with no atomics. Two layouts:
//
//   D = 64, 128: a block owns 128 query rows of one (batch, head), each
//     warpgroup 64 of them, and each warpgroup runs all three products
//     for its rows over the K/V tiles the two share (a warpgroup whose
//     rows see none of a causal tile's keys skips its products). Against
//     the split below at these widths (B32 x T1024, causal, H100) it ran
//     0.22-0.25 ms for 0.33-0.35 at H8 x D64 and 0.73-0.76 for 1.04-1.13
//     at H16 x D128: twice the rows for each K/V tile loaded, and no
//     exchange between the warpgroups;
//   D = 256: a block owns 64 query rows, and the warpgroups split the
//     work by product: warpgroup 0 builds s and p = 2^(c s - log2(e)
//     lse), warpgroup 1 dp, ds and dQ += ds k (128 rows' q and dO, 128
//     KB, would leave no room for two K/V stages of 64 KB). p crosses
//     through 16 KB of shared memory in accumulator order under two
//     named barriers (1: p is in; 2: it has been read), as p^T does in
//     flash_dkv_wgmma.cu; ds stays in warpgroup 1's registers as the A
//     operand of ds k, and warpgroup 0 builds the next tile's s while
//     warpgroup 1 runs this tile's ds k.
//
// The copies are issued by warpgroup 1's first thread: it releases a
// stage last, so its wait for the stage's "empty" phase is the shortest.
//
// Registers: dQ takes D / 2 a thread (128 at D = 256), each score tile
// 32, ds's bf16 pairs 16. Shared memory: q and dO 2 x rows x D x 2
// bytes, the stages 2 x 64 x D x 2 bytes each, at D = 256 the p
// exchange, and the barriers: 214,056 bytes at D = 256, 164,920 at 128,
// 99,400 at 64 (ops/flash_plan.py). ptxas (the H100 build of
// chip_smoke.py, nvcc 12.9): 214 registers at D = 256, 155 at 128, 122
// at 64, no spills. The SASS holds 20, 20 and 12 HGMMA: D / 16 for each
// score product a warpgroup issues, 4 for ds k.
//
// Bound on the card: operations, three products of 2 T^2 D flops per
// (batch, head), halved when causal, at the bf16 tensor-core rate;
// against q, k, v, dO, lse, delta read and dQ written once.
#include "flash_sm90.cuh"

namespace egf {
namespace {

using namespace sm90;
using bf16 = __nv_bfloat16;

// two warpgroups; warpgroup 1's first thread also issues the copies
constexpr int kThreads = 256;
constexpr int kLeader = 128;

template <int D>
struct DqLayout {
  static constexpr bool kSplit = D == 256;  // split by product (above)
  static constexpr int kM = kSplit ? 64 : 128;  // queries of a block
  static constexpr int kN = 64;                 // keys of a K tile
  static constexpr int kSlabs = D / 64;
  static constexpr int kStages = D == 256 ? 2 : D == 128 ? 3 : 4;
  static constexpr int kQ = kM * D * 2;     // bytes of the q (or dO) tile
  static constexpr int kKV = kN * D * 2;    // ... of a k (or v) tile
  static constexpr int kQSlab = kM * 128;   // ... of a q column slab
  static constexpr int kKVSlab = kN * 128;  // ... of a k or v slab
  static constexpr int kOffDo = kQ;
  static constexpr int kOffK = 2 * kQ;                  // k stages
  static constexpr int kOffV = kOffK + kStages * kKV;   // v stages
  static constexpr int kOffX = kOffV + kStages * kKV;   // p exchange
  static constexpr int kOffBar = kOffX + (kSplit ? 32 * 128 * 4 : 0);
  static constexpr int kBars = 1 + 2 * kStages;  // q and dO; full; empty
  // 1024 bytes of slack align the slabs to the swizzle's period
  static constexpr size_t kBytes = 1024 + kOffBar + 8 * kBars;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dq,
                          const int* __restrict__ offs, Shape s,
                          float scale) {
  using L = DqLayout<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* const smem =
      smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  uint64_t* const qdo_full = reinterpret_cast<uint64_t*>(smem + L::kOffBar);
  uint64_t* const full = qdo_full + 1;
  uint64_t* const empty = full + L::kStages;

  const int nq = (s.t + L::kM - 1) / L::kM;
  const int bhn = s.b * s.h;
  const int qi = nq - 1 - (int)(blockIdx.x / bhn);  // heaviest first
  const int bh = (int)(blockIdx.x % bhn);
  const int b = bh / s.h, hh = bh % s.h;
  int q_off, k_off;
  load_offsets(offs, s, b, q_off, k_off);
  // the last K tile with a key that some row of this block may see
  int k_end = (s.t + L::kN - 1) / L::kN - 1;
  if (s.causal) {
    const int last_key = q_off - k_off + qi * L::kM + L::kM - 1;
    k_end = last_key < 0 ? -1 : min(k_end, last_key / L::kN);
  }
  const int n_tiles = k_end + 1;

  const bool leader = threadIdx.x == kLeader;
  if (leader) {
    bar_init(qdo_full, 1);
    for (int i = 0; i < L::kStages; ++i) {
      bar_init(full + i, 1);
      bar_init(empty + i, 256);
    }
    bar_fence_init();
  }
  __syncthreads();

  // K and V tile kj into stage kj % kStages, by the leader
  const auto issue = [&](int kj) {
    const int st = kj % L::kStages;
    bar_expect(full + st, 2 * L::kKV);
    for (int c = 0; c < L::kSlabs; ++c) {
      tma_load(smem + L::kOffK + st * L::kKV + c * L::kKVSlab, &tk,
               full + st, c * 64, hh, kj * L::kN, b);
      tma_load(smem + L::kOffV + st * L::kKV + c * L::kKVSlab, &tv,
               full + st, c * 64, hh, kj * L::kN, b);
    }
  };
  if (leader && n_tiles > 0) {
    // q and dO once, and the first tiles into every stage
    prefetch_map(&tq);
    prefetch_map(&tk);
    prefetch_map(&tv);
    prefetch_map(&tdo);
    bar_expect(qdo_full, 2 * L::kQ);
    for (int c = 0; c < L::kSlabs; ++c) {
      tma_load(smem + c * L::kQSlab, &tq, qdo_full, c * 64, hh, qi * L::kM,
               b);
      tma_load(smem + L::kOffDo + c * L::kQSlab, &tdo, qdo_full, c * 64, hh,
               qi * L::kM, b);
    }
    for (int kj = 0; kj < L::kStages && kj < n_tiles; ++kj) issue(kj);
  }

  const int cw = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq4 = lane & 3;
  // this warpgroup's 64 rows of the block (split: both own all 64)
  const int wrow = L::kSplit ? 0 : cw * 64;
  const int row0 = qi * L::kM + wrow + warp * 16;  // warp's first query
  // this warpgroup's last K tile: split, the block's; otherwise one less
  // where a causal tile's keys all lie past its rows
  int k_last = k_end;
  if (!L::kSplit && s.causal) {
    const int last_key = q_off - k_off + qi * L::kM + wrow + 63;
    k_last = last_key < 0 ? -1 : min(k_end, last_key / L::kN);
  }
  const float c = scale * kLog2e;
  // rows g and g + 8: log2(e) lse and delta, 0 past t
  float lc[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    const bool in = n_tiles > 0 && row < s.t;
    lc[i] = in ? lse[(int64_t)bh * s.t + row] * kLog2e : 0.f;
    dl[i] = in ? delta[(int64_t)bh * s.t + row] : 0.f;
  }
  const unsigned char* const q_s = smem + wrow * 128;
  const unsigned char* const do_s = smem + L::kOffDo + wrow * 128;
  float* const xch = reinterpret_cast<float*>(smem + L::kOffX);
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  if (n_tiles > 0) bar_wait(qdo_full, 0);

  // mask a score tile (register r: query g + 8 ((r >> 1) & 1), key
  // 8 (r >> 2) + 2 tq4 + (r & 1)) and make it p = 2^(c s - log2(e) lse);
  // a masked score is -inf, so its p (and the ds built from it) is
  // exactly 0. Only tiles that cross the causal diagonal or the end of T
  // are masked.
  const auto softmax_p = [&](float (&sc)[32], int kj) {
    const int key0 = kj * L::kN;
    const bool full_tile =
        key0 + L::kN <= s.t &&
        (!s.causal || q_off + row0 >= k_off + key0 + L::kN - 1);
    if (!full_tile) {
#pragma unroll
      for (int r = 0; r < 32; ++r)
        if (!valid_at(row0 + g + 8 * ((r >> 1) & 1),
                      key0 + 8 * (r >> 2) + 2 * tq4 + (r & 1), s.t,
                      s.causal, q_off, k_off))
          sc[r] = -INFINITY;
    }
#pragma unroll
    for (int r = 0; r < 32; ++r)
      sc[r] = fast_exp2(fmaf(sc[r], c, -lc[(r >> 1) & 1]));
  };
  // dQ += ds k over the tile's keys, ds from registers
  const auto ds_k = [&](const float (&ds)[32], const unsigned char* k_s) {
    uint32_t pa[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) acc_to_a(pa[kc], ds, kc);
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      wgmma_rs<D>(acc, pa[kc], desc(k_s + kc * 2048, L::kKVSlab, 1024), 1);
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
  };
  // s += a b^T over all D columns, a from a q-like tile (kQSlab slabs),
  // b from a K/V stage
  const auto scores = [&](float (&sc)[32], const unsigned char* a,
                          const unsigned char* bt) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(sc,
                   desc(a + (kk >> 2) * L::kQSlab + (kk & 3) * 32, 16, 1024),
                   desc(bt + (kk >> 2) * L::kKVSlab + (kk & 3) * 32, 16,
                        1024),
                   kk > 0);
  };
  // while this tile's products run: once every thread has released tile
  // kj - 1's stage, its next tile goes in
  const auto refill = [&](int kj) {
    if (leader && kj >= 1 && kj - 1 + L::kStages < n_tiles) {
      bar_wait(empty + (kj - 1) % L::kStages, ((kj - 1) / L::kStages) & 1);
      issue(kj - 1 + L::kStages);
    }
  };

  for (int kj = 0; kj < n_tiles; ++kj) {
    const int st = kj % L::kStages;
    const uint32_t ph = (kj / L::kStages) & 1;
    const unsigned char* const k_s = smem + L::kOffK + st * L::kKV;
    const unsigned char* const v_s = smem + L::kOffV + st * L::kKV;
    bar_wait(full + st, ph);
    if constexpr (L::kSplit) {
      // warpgroup 0: s = q k^T; warpgroup 1: dp = dO v^T
      float sc[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) sc[r] = 0.f;
      wg_fence();
      scores(sc, cw == 0 ? q_s : do_s, cw == 0 ? k_s : v_s);
      wg_commit();
      refill(kj);
      wg_wait<0>();
      fence_regs(sc);
      if (cw == 0) {
        softmax_p(sc, kj);
        if (kj > 0) named_sync(2, 256);  // the last tile's p has been read
#pragma unroll
        for (int r = 0; r < 32; ++r) xch[r * 128 + tid] = sc[r];
        named_arrive(1, 256);
      } else {
        named_sync(1, 256);  // this tile's p is in
#pragma unroll
        for (int r = 0; r < 32; ++r)
          sc[r] = xch[r * 128 + tid] * (sc[r] - dl[(r >> 1) & 1]) * scale;
        if (kj + 1 < n_tiles) named_arrive(2, 256);
        ds_k(sc, k_s);
      }
    } else {
      // each warpgroup: s = q k^T and dp = dO v^T for its own rows
      const bool live = kj <= k_last;
      float sc[32], dp[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) sc[r] = dp[r] = 0.f;
      if (live) {
        wg_fence();
        scores(sc, q_s, k_s);
        scores(dp, do_s, v_s);
        wg_commit();
      }
      refill(kj);
      if (live) {
        wg_wait<0>();
        fence_regs(sc);
        fence_regs(dp);
        softmax_p(sc, kj);
#pragma unroll
        for (int r = 0; r < 32; ++r)
          sc[r] = sc[r] * (dp[r] - dl[(r >> 1) & 1]) * scale;
        ds_k(sc, k_s);
      }
    }
    bar_arrive(empty + st);
  }

  // rows of a hop wholly in the future are written as zeros; split, by
  // warpgroup 1, which holds dQ
  if (L::kSplit && cw == 0) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    if (row >= s.t) continue;
    bf16* const at = dq + (((int64_t)b * s.t + row) * s.h + hh) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(at + 8 * j + 2 * tq4) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  }
}

template <int D>
cudaError_t run(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dq,
                const int* offs, const int64_t* st, const Shape& s,
                void* stream) {
  using L = DqLayout<D>;
  static_assert(L::kBytes <= kSmemMax, "the stages fit a block");
  CUtensorMap mq, mk, mv, mdo;
  if (!make_map(&mq, q, s, st, L::kM) || !make_map(&mk, k, s, st + 3, L::kN) ||
      !make_map(&mv, v, s, st + 6, L::kN) ||
      !make_map(&mdo, dout, s, st + 9, L::kM))
    return cudaErrorInvalidValue;
  const int64_t nq = (s.t + L::kM - 1) / L::kM;
  return launch_kernel<kThreads>(flash_dq_wgmma_kernel<D>, nq * s.b * s.h,
                                 L::kBytes, stream, mq, mk, mv, mdo, lse,
                                 delta, (bf16*)dq, offs, s,
                                 softmax_scale(s.d));
}

}  // namespace

cudaError_t dq_wgmma(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dq, const int* offs, const int64_t* st,
                     const Shape& s, void* stream) {
  switch (s.d) {
    case 64:
      return run<64>(q, k, v, dout, lse, delta, dq, offs, st, s, stream);
    case 128:
      return run<128>(q, k, v, dout, lse, delta, dq, offs, st, s, stream);
    case 256:
      return run<256>(q, k, v, dout, lse, delta, dq, offs, st, s, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

size_t dq_wgmma_smem(int d) {
  return d == 64    ? DqLayout<64>::kBytes
         : d == 128 ? DqLayout<128>::kBytes
         : d == 256 ? DqLayout<256>::kBytes
                    : 0;
}

}  // namespace egf
