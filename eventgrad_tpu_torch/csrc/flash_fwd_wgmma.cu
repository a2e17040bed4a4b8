// FlashAttention-2 forward on Hopper's wgmma, bfloat16 at D = 64, 128
// and 256: the wgmma form of flash_fwd.cu (flash_base.cuh's flash_form
// picks it), the same function: out = softmax(q k^T / sqrt(D) + mask) v
// and the row logsumexp.
//
// Replaces the TPU kernel eventgrad_tpu/ops/attention.py:_fwd_kernel (as
// flash_fwd.cu does; its note gives the recurrence, the masking and the
// causal tile skip, all kept here).
//
// A block owns 128 query rows of one (batch, head) and has two
// warpgroups, each owning 64 of the rows; the block's first thread also
// issues every TMA copy. No warp is set apart to produce: with a
// producer warpgroup and setmaxnreg 40 / 232, or with a producer warp
// (288 threads), ptxas of nvcc 12.9 allocated every thread within 168
// registers (R0-R167 in the SASS) and spilled 568 bytes at D = 256;
// 256 threads may take 255. q arrives once and stays in shared memory
// for the whole sweep; 64-key K and V tiles come through a ring of
// stages (4 at D = 64, 3 at 128, 2 at 256), each stage with a "full"
// mbarrier per tile (the first thread's expected bytes, completed by
// TMA) and an "empty" one (every thread arrives once its products have
// read the stage; the first thread waits for it while its warpgroup's
// q k^T of the next tile runs, then refills the stage). Tiles land in
// the 128-byte swizzle as D / 64 column slabs (flash_sm90.cuh); rows
// past T arrive as zeros and are masked.
//
// Per K tile a warpgroup issues
//
//   s = q k^T   D / 16 wgmma m64n64k16, q and k from shared memory
//               (K-major), over all D columns at once;
//   o += p v    4 wgmma m64nDk16, p from registers (the accumulator
//               layout of s, rounded to bf16 pairs), v from shared memory
//               (MN-major through the transpose flag).
//
// Two products of width D per tile at every D: the wide mma form
// (flash_fwd.cu) rebuilds s once per 128-column output chunk, three
// products at D = 256. The
// online softmax (scale on the float32 scores, base 2, m / l / o in
// registers, the row max and sum over the 4 lanes of a quad) is the
// mma.sync form's, row for row.
//
// Registers: o takes D / 2 a thread (128 at D = 256), s 32, p's bf16
// pairs 16. Shared memory: q 128 x D x 2 bytes, the stages 2 x 64 x D x
// 2 bytes each, the barriers: 197,688 bytes at D = 256, 132,176 at 128,
// 83,048 at 64 (ops/flash_plan.py). ptxas (the H100 build of
// chip_smoke.py, nvcc 12.9): 189 registers at D = 256, 127 at 128, 92 at
// 64, no spills. The SASS holds D / 16 + 4 HGMMA (20 at D = 256): one
// per wgmma of a tile's two products.
//
// Bound on the card: operations, two products of 2 T^2 D flops per
// (batch, head), halved when causal, at the bf16 tensor-core rate;
// against q, k, v read and out, lse written once.
#include "flash_sm90.cuh"

namespace egf {
namespace {

using namespace sm90;
using bf16 = __nv_bfloat16;

// two warpgroups; the first thread also issues the copies
constexpr int kThreads = 256;

template <int D>
struct FwdLayout {
  static constexpr int kM = 128;  // query rows of a block
  static constexpr int kN = 64;   // keys of a K/V tile
  static constexpr int kSlabs = D / 64;
  static constexpr int kStages = D == 256 ? 2 : D == 128 ? 3 : 4;
  static constexpr int kQ = kM * D * 2;     // bytes of the q tile
  static constexpr int kKV = kN * D * 2;    // bytes of a k (or v) tile
  static constexpr int kQSlab = kM * 128;   // bytes of a q column slab
  static constexpr int kKVSlab = kN * 128;  // ... of a k or v slab
  static constexpr int kOffK = kQ;
  static constexpr int kOffV = kOffK + kStages * kKV;
  static constexpr int kOffBar = kOffV + kStages * kKV;
  static constexpr int kBars = 1 + 3 * kStages;  // q; k, v full; empty
  // 1024 bytes of slack align the slabs to the swizzle's period
  static constexpr size_t kBytes = 1024 + kOffBar + 8 * kBars;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           bf16* __restrict__ out, float* __restrict__ lse,
                           const int* __restrict__ offs, Shape s,
                           float scale) {
  using L = FwdLayout<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* const smem =
      smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  uint64_t* const q_full = reinterpret_cast<uint64_t*>(smem + L::kOffBar);
  uint64_t* const k_full = q_full + 1;
  uint64_t* const v_full = k_full + L::kStages;
  uint64_t* const empty = v_full + L::kStages;

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

  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    for (int i = 0; i < L::kStages; ++i) {
      bar_init(k_full + i, 1);
      bar_init(v_full + i, 1);
      bar_init(empty + i, 256);
    }
    bar_fence_init();
  }
  __syncthreads();

  // K and V tile kj into stage kj % kStages, by the block's first thread
  const auto issue = [&](int kj) {
    const int st = kj % L::kStages;
    unsigned char* const kd = smem + L::kOffK + st * L::kKV;
    unsigned char* const vd = smem + L::kOffV + st * L::kKV;
    bar_expect(k_full + st, L::kKV);
    for (int c = 0; c < L::kSlabs; ++c)
      tma_load(kd + c * L::kKVSlab, &tk, k_full + st, c * 64, hh, kj * L::kN,
               b);
    bar_expect(v_full + st, L::kKV);
    for (int c = 0; c < L::kSlabs; ++c)
      tma_load(vd + c * L::kKVSlab, &tv, v_full + st, c * 64, hh, kj * L::kN,
               b);
  };
  const bool leader = threadIdx.x == 0;
  if (leader && k_end >= 0) {
    // q once, and the first tiles into every stage
    prefetch_map(&tq);
    prefetch_map(&tk);
    prefetch_map(&tv);
    bar_expect(q_full, L::kQ);
    for (int c = 0; c < L::kSlabs; ++c)
      tma_load(smem + c * L::kQSlab, &tq, q_full, c * 64, hh, qi * L::kM, b);
    for (int kj = 0; kj < L::kStages && kj <= k_end; ++kj) issue(kj);
  }

  const int cw = threadIdx.x / 128;  // this warpgroup's 64 rows
  const int tid = threadIdx.x % 128;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq4 = lane & 3;
  const int row0 = qi * L::kM + cw * 64 + warp * 16;  // warp's first row
  const unsigned char* const q_s = smem + cw * 64 * 128;
  const float c = scale * kLog2e;
  // rows g and g + 8: the max of the unscaled scores (kNegInf while
  // every key so far was masked) and this lane's share of the row sum
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  if (k_end >= 0) bar_wait(q_full, 0);

  for (int kj = 0; kj <= k_end; ++kj) {
    const int st = kj % L::kStages;
    const uint32_t ph = (kj / L::kStages) & 1;
    const unsigned char* const k_s = smem + L::kOffK + st * L::kKV;
    const unsigned char* const v_s = smem + L::kOffV + st * L::kKV;
    // s = q k^T over all D columns: register r holds row g + 8 ((r >> 1)
    // & 1), key 8 (r >> 2) + 2 tq4 + (r & 1) of the tile
    float sc[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) sc[r] = 0.f;
    bar_wait(k_full + st, ph);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(sc,
                   desc(q_s + (kk >> 2) * L::kQSlab + (kk & 3) * 32, 16,
                        1024),
                   desc(k_s + (kk >> 2) * L::kKVSlab + (kk & 3) * 32, 16,
                        1024),
                   kk > 0);
    wg_commit();
    // while q k^T runs: once every thread has released tile kj - 1's
    // stage, its next tile goes in
    if (leader && kj >= 1 && kj - 1 + L::kStages <= k_end) {
      const int prev = kj - 1;
      bar_wait(empty + prev % L::kStages, (prev / L::kStages) & 1);
      issue(prev + L::kStages);
    }
    wg_wait<0>();
    fence_regs(sc);

    // mask, then the online softmax in base 2 (flash_fwd.cu): a masked
    // score is -inf, so its p is exactly 0 and it leaves m alone
    const int key0 = kj * L::kN;
    const bool full =
        key0 + L::kN <= s.t &&
        (!s.causal || q_off + row0 >= k_off + key0 + L::kN - 1);
    if (!full) {
#pragma unroll
      for (int r = 0; r < 32; ++r)
        if (!valid_at(row0 + g + 8 * ((r >> 1) & 1),
                      key0 + 8 * (r >> 2) + 2 * tq4 + (r & 1), s.t,
                      s.causal, q_off, k_off))
          sc[r] = -INFINITY;
    }
    float mx[2] = {m[0], m[1]}, mc[2];
#pragma unroll
    for (int r = 0; r < 32; ++r)
      mx[(r >> 1) & 1] = fmaxf(mx[(r >> 1) & 1], sc[r]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      const float corr = fast_exp2((m[i] - mx[i]) * c);
      m[i] = mx[i];
      mc[i] = mx[i] * c;
      l[i] *= corr;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 2 * i] *= corr;
        o[4 * j + 2 * i + 1] *= corr;
      }
    }
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      sc[r] = fast_exp2(fmaf(sc[r], c, -mc[(r >> 1) & 1]));
      l[(r >> 1) & 1] += sc[r];
    }
    uint32_t pa[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) acc_to_a(pa[kc], sc, kc);

    // o += p v
    bar_wait(v_full + st, ph);
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      wgmma_rs<D>(o, pa[kc], desc(v_s + kc * 2048, L::kKVSlab, 1024), 1);
    wg_commit();
    wg_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    bar_arrive(empty + st);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    const float l_safe = fmaxf(quad_sum(l[i]), kLFloor);
    if (row >= s.t) continue;
    // a fully masked row keeps m = -1e30 unscaled, as the plain version
    const float m_s = m[i] == kNegInf ? kNegInf : m[i] * scale;
    if (tq4 == 0) lse[(int64_t)bh * s.t + row] = m_s + logf(l_safe);
    bf16* const dst = out + (((int64_t)b * s.t + row) * s.h + hh) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + 2 * tq4) =
          __floats2bfloat162_rn(o[4 * j + 2 * i] / l_safe,
                                o[4 * j + 2 * i + 1] / l_safe);
  }
}

template <int D>
cudaError_t run(const void* q, const void* k, const void* v, void* out,
                float* lse, const int* offs, const int64_t* st,
                const Shape& s, void* stream) {
  using L = FwdLayout<D>;
  static_assert(L::kBytes <= kSmemMax, "the stages fit a block");
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, s, st, L::kM) || !make_map(&mk, k, s, st + 3, L::kN) ||
      !make_map(&mv, v, s, st + 6, L::kN))
    return cudaErrorInvalidValue;
  const int64_t nq = (s.t + L::kM - 1) / L::kM;
  return launch_kernel<kThreads>(flash_fwd_wgmma_kernel<D>, nq * s.b * s.h,
                                 L::kBytes, stream, mq, mk, mv, (bf16*)out,
                                 lse, offs, s, softmax_scale(s.d));
}

}  // namespace

cudaError_t fwd_wgmma(const void* q, const void* k, const void* v, void* out,
                      float* lse, const int* offs, const int64_t* st,
                      const Shape& s, void* stream) {
  switch (s.d) {
    case 64: return run<64>(q, k, v, out, lse, offs, st, s, stream);
    case 128: return run<128>(q, k, v, out, lse, offs, st, s, stream);
    case 256: return run<256>(q, k, v, out, lse, offs, st, s, stream);
    default: return cudaErrorInvalidValue;
  }
}

size_t fwd_wgmma_smem(int d) {
  return d == 64    ? FwdLayout<64>::kBytes
         : d == 128 ? FwdLayout<128>::kBytes
         : d == 256 ? FwdLayout<256>::kBytes
                    : 0;
}

}  // namespace egf
