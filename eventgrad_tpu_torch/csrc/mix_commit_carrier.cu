// Carrier-resident fused buffer-commit + gossip-mix + momentum-SGD over
// the flat arena.
//
// Replaces the TPU kernel
// eventgrad_tpu/ops/arena_update.py:_carrier_commit_kernel (launched by
// _fused_commit_carrier_flat, entry fused_mix_commit_carrier). It is the
// commit kernel (mix_commit.cu) with the receive buffers held in the wire
// carrier C (int8 or bf16). Per element and per neighbor i, in the JAX
// kernel's order:
//
//   buf_i' = where(keep_i > 0, cand_i, last_i)         (select on C)
//   v_i    = f32(mix_stale ? last_i : buf_i')  [* scale_i for int8]
//   acc    = p;  acc += v_i                            for each i
//   mixed  = acc * w
//   t'     = mom * t + g
//   p'     = mixed - lr * t'
//
// writing (p', t') in f32 and buf_0'..buf_{nb-1}' in C. scale_i is the
// per-position f32 dequant scale of the value the mix reads (int8 only;
// bf16's dequant is the exact upcast). The scales are truncated to 17
// significand bits upstream, so v_i is an exact product.
//
// Bound on the card: bytes. With nb = 2 and int8 carriers it reads p, g,
// t (12 B), two candidates (2 B), two keeps (8 B), two lasts (2 B) and
// two scales (8 B) and writes p', t' (8 B) and two buffers (2 B): 42
// B/elem, about 5.86 GB for the flagship Ring(8) ResNet-18 step (8 x
// 17,444,682 elements), i.e. about 1.75 ms at 3.35 TB/s; bf16 carriers
// move 40 B/elem (1.67 ms). The design is the commit kernel's single
// grid-stride stream over all ranks, four elements per thread (a float4
// of each f32 operand and one 4- or 8-byte load of each carrier), the
// neighbor pointers in a by-value struct, one instantiation per carrier
// type and neighbor count. The per-position f32 keeps and scales are 16
// of the 42 bytes (a per-leaf lookup is later work).
//
// The gated form (chaos on the carrier tail) takes two optional per-row
// operands, null when unused: w_rows (f32 [R], the mix weight 1/(1 +
// n_alive) per rank) and gate (u8 [R, nb]: 0 takes the edge out of the
// mix, which then adds +0.0f): acc += gate_i ? v_i : +0.0f, mixed = acc
// * w_r. It runs as the pitched body over the whole [R, n] arena, one
// grid row per rank, each block reading its row's operands once. The
// integrity riders and the nanstep poison never reach a carrier (the
// step refuses them, as the JAX step does).
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kMaxNb = 4;

struct Neighbors {
  const void* cand[kMaxNb];
  const float* keep[kMaxNb];
  const void* last[kMaxNb];
  const float* scale[kMaxNb];
  void* out[kMaxNb];
};

struct Scalars {
  float lr, mom, w;
  int mix_stale;
};

// four carrier values, loaded and stored as one aligned word
template <typename C>
struct alignas(4 * sizeof(C)) Pack4 {
  C v[4];
};

__device__ __forceinline__ float to_f32(int8_t q) { return (float)q; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 q) {
  return __bfloat162float(q);
}

template <typename C, bool S, int NB>
__device__ __forceinline__ void carrier_elem(float p, float g, float t,
                                             const C* c, const float* k,
                                             const C* l, const float* s,
                                             const Scalars& sc, float& po,
                                             float& to, C* bo) {
  float acc = p;
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const C nq = k[i] > 0.f ? c[i] : l[i];
    bo[i] = nq;
    float v = to_f32(sc.mix_stale ? l[i] : nq);
    if constexpr (S) v = __fmul_rn(v, s[i]);
    acc = __fadd_rn(acc, v);
  }
  const float mixed = __fmul_rn(acc, sc.w);
  const float tr = __fadd_rn(__fmul_rn(sc.mom, t), g);
  po = __fsub_rn(mixed, __fmul_rn(sc.lr, tr));
  to = tr;
}

// the gated form's per-row operands (null = unused)
struct Gates {
  const float* w_rows;
  const uint8_t* gate;
};

// one row's gated operands
struct RowOps {
  float w;
  bool on[kMaxNb];
};

__device__ __forceinline__ RowOps row_ops(const Gates& gt, int nb,
                                          const Scalars& sc, int64_t r) {
  RowOps o;
  o.w = gt.w_rows ? gt.w_rows[r] : sc.w;
#pragma unroll
  for (int i = 0; i < kMaxNb; ++i)
    o.on[i] = (gt.gate && i < nb) ? gt.gate[r * nb + i] != 0 : true;
  return o;
}

// the gated element: a closed gate adds +0.0f, the row's weight mixes
template <typename C, bool S, int NB>
__device__ __forceinline__ void carrier_elem_gated(
    float p, float g, float t, const C* c, const float* k, const C* l,
    const float* s, const Scalars& sc, const RowOps& o, float& po, float& to,
    C* bo) {
  float acc = p;
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const C nq = k[i] > 0.f ? c[i] : l[i];
    bo[i] = nq;
    float v = to_f32(sc.mix_stale ? l[i] : nq);
    if constexpr (S) v = __fmul_rn(v, s[i]);
    acc = __fadd_rn(acc, o.on[i] ? v : 0.0f);
  }
  const float mixed = __fmul_rn(acc, o.w);
  const float tr = __fadd_rn(__fmul_rn(sc.mom, t), g);
  po = __fsub_rn(mixed, __fmul_rn(sc.lr, tr));
  to = tr;
}

template <typename C, bool S, int NB>
__global__ void mix_commit_carrier_kernel(const float* __restrict__ p,
                                          const float* __restrict__ g,
                                          const float* __restrict__ t,
                                          Neighbors nbp,
                                          float* __restrict__ p_out,
                                          float* __restrict__ t_out,
                                          int64_t n, Scalars sc, int vec) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  C c[NB], l[NB], bo[NB];
  float k[NB], s[NB];
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n / 4;
    for (int64_t i = tid; i < n4; i += stride) {
      const float4 pv = eg::ld4(p, i), gv = eg::ld4(g, i), tv = eg::ld4(t, i);
      Pack4<C> cv[NB], lv[NB], bv[NB];
      float4 kv[NB], sv[NB], pov, tov;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        cv[j] = reinterpret_cast<const Pack4<C>*>(nbp.cand[j])[i];
        kv[j] = eg::ld4(nbp.keep[j], i);
        lv[j] = reinterpret_cast<const Pack4<C>*>(nbp.last[j])[i];
        if constexpr (S) sv[j] = eg::ld4(nbp.scale[j], i);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          c[j] = cv[j].v[q];
          k[j] = eg::lane(kv[j], q);
          l[j] = lv[j].v[q];
          if constexpr (S) s[j] = eg::lane(sv[j], q);
        }
        float po, to;
        carrier_elem<C, S, NB>(eg::lane(pv, q), eg::lane(gv, q),
                               eg::lane(tv, q), c, k, l, s, sc, po, to, bo);
        eg::set_lane(pov, q, po);
        eg::set_lane(tov, q, to);
#pragma unroll
        for (int j = 0; j < NB; ++j) bv[j].v[q] = bo[j];
      }
      eg::st4(p_out, i, pov);
      eg::st4(t_out, i, tov);
#pragma unroll
      for (int j = 0; j < NB; ++j)
        reinterpret_cast<Pack4<C>*>(nbp.out[j])[i] = bv[j];
    }
    done = n4 * 4;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      c[j] = static_cast<const C*>(nbp.cand[j])[i];
      k[j] = nbp.keep[j][i];
      l[j] = static_cast<const C*>(nbp.last[j])[i];
      if constexpr (S) s[j] = nbp.scale[j][i];
    }
    carrier_elem<C, S, NB>(p[i], g[i], t[i], c, k, l, s, sc, p_out[i],
                           t_out[i], bo);
#pragma unroll
    for (int j = 0; j < NB; ++j) static_cast<C*>(nbp.out[j])[i] = bo[j];
  }
}

template <typename C, bool S>
void launch(int nb, const float* p, const float* g, const float* t,
            const Neighbors& nbp, float* p_out, float* t_out, int64_t n,
            const Scalars& sc, int vec, cudaStream_t st) {
  const int grid = eg::grid_for(vec ? n / 4 + 1 : n);
  switch (nb) {
    case 1:
      mix_commit_carrier_kernel<C, S, 1><<<grid, eg::kThreads, 0, st>>>(
          p, g, t, nbp, p_out, t_out, n, sc, vec);
      break;
    case 2:
      mix_commit_carrier_kernel<C, S, 2><<<grid, eg::kThreads, 0, st>>>(
          p, g, t, nbp, p_out, t_out, n, sc, vec);
      break;
    case 3:
      mix_commit_carrier_kernel<C, S, 3><<<grid, eg::kThreads, 0, st>>>(
          p, g, t, nbp, p_out, t_out, n, sc, vec);
      break;
    default:
      mix_commit_carrier_kernel<C, S, 4><<<grid, eg::kThreads, 0, st>>>(
          p, g, t, nbp, p_out, t_out, n, sc, vec);
      break;
  }
}

}  // namespace

// cands/keeps/lasts/scales/bufs_out are host arrays of nb device
// pointers; scales is NULL for bf16. carrier: 0 = int8 (scales
// required), 1 = bf16 (no scales). Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for an unsupported combination).
extern "C" int eg_mix_commit_carrier(
    const float* p, const float* g, const float* t, const void* const* cands,
    const float* const* keeps, const void* const* lasts,
    const float* const* scales, float* p_out, float* t_out,
    void* const* bufs_out, int nb, int64_t n, float lr, float mom, float w,
    int mix_stale, int carrier, int vec, void* stream) {
  if (nb < 1 || nb > kMaxNb) return (int)cudaErrorInvalidValue;
  if ((carrier == 0) != (scales != nullptr)) return (int)cudaErrorInvalidValue;
  if (carrier != 0 && carrier != 1) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  Neighbors nbp = {};
  for (int i = 0; i < nb; ++i) {
    nbp.cand[i] = cands[i];
    nbp.keep[i] = keeps[i];
    nbp.last[i] = lasts[i];
    nbp.scale[i] = scales ? scales[i] : nullptr;
    nbp.out[i] = bufs_out[i];
  }
  const Scalars sc = {lr, mom, w, mix_stale};
  cudaStream_t st = (cudaStream_t)stream;
  if (carrier == 0)
    launch<int8_t, true>(nb, p, g, t, nbp, p_out, t_out, n, sc, vec, st);
  else
    launch<__nv_bfloat16, false>(nb, p, g, t, nbp, p_out, t_out, n, sc, vec,
                                 st);
  return (int)cudaGetLastError();
}

// --- the pitched (bucket) form -----------------------------------------
//
// The carrier commit + mix + SGD of one bucket: p, g, t are the [rows,
// ld] arenas read in place at columns [off, off + cols), p' and t' are
// written into the same columns of the output arenas; candidates,
// keeps, stale buffers, scales and committed buffers are the bucket's
// contiguous [rows, cols] arrays (common.cuh "the pitched forms"). Same
// arithmetic and bytes per element as the contiguous form.

namespace {

template <typename C, bool S, int NB>
struct CarrierBody {
  const float* p;
  const float* g;
  const float* t;
  Neighbors nbp;
  float* p_out;
  float* t_out;
  Scalars sc;
  Gates gt;
  // the gated form: set per block from gt
  bool gated;
  RowOps o;

  template <int W>
  __device__ __forceinline__ void at(int64_t a, int64_t b) const {
    const eg::Vec<float, W> pv = eg::ldv<W>(p + a), gv = eg::ldv<W>(g + a),
                            tv = eg::ldv<W>(t + a);
    eg::Vec<C, W> cv[NB], lv[NB], bv[NB];
    eg::Vec<float, W> kv[NB], sv[NB], pov, tov;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      cv[j] = eg::ldv<W>(static_cast<const C*>(nbp.cand[j]) + b);
      kv[j] = eg::ldv<W>(nbp.keep[j] + b);
      lv[j] = eg::ldv<W>(static_cast<const C*>(nbp.last[j]) + b);
      if constexpr (S) sv[j] = eg::ldv<W>(nbp.scale[j] + b);
    }
    C c[NB], l[NB], bo[NB];
    float k[NB], s[NB];
#pragma unroll
    for (int q = 0; q < W; ++q) {
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        c[j] = cv[j].v[q];
        k[j] = kv[j].v[q];
        l[j] = lv[j].v[q];
        if constexpr (S) s[j] = sv[j].v[q];
      }
      if (gated)
        carrier_elem_gated<C, S, NB>(pv.v[q], gv.v[q], tv.v[q], c, k, l, s,
                                     sc, o, pov.v[q], tov.v[q], bo);
      else
        carrier_elem<C, S, NB>(pv.v[q], gv.v[q], tv.v[q], c, k, l, s, sc,
                               pov.v[q], tov.v[q], bo);
#pragma unroll
      for (int j = 0; j < NB; ++j) bv[j].v[q] = bo[j];
    }
    eg::stv<W>(p_out + a, pov);
    eg::stv<W>(t_out + a, tov);
#pragma unroll
    for (int j = 0; j < NB; ++j)
      eg::stv<W>(static_cast<C*>(nbp.out[j]) + b, bv[j]);
  }
};

template <typename C, bool S, int NB>
__global__ void mix_commit_carrier_pitched_kernel(CarrierBody<C, S, NB> body,
                                                  eg::Pitch g, int vec) {
  // the gated form's row operands: read once per block, before the row
  body.gated = body.gt.w_rows || body.gt.gate;
  if (body.gated) body.o = row_ops(body.gt, NB, body.sc, blockIdx.y);
  eg::pitched_row(g, vec, body);
}

template <typename C, bool S, int NB>
CarrierBody<C, S, NB> carrier_body(const float* p, const float* g,
                                   const float* t, const Neighbors& nbp,
                                   float* p_out, float* t_out,
                                   const Scalars& sc, const Gates& gt) {
  CarrierBody<C, S, NB> b = {};
  b.p = p;
  b.g = g;
  b.t = t;
  b.nbp = nbp;
  b.p_out = p_out;
  b.t_out = t_out;
  b.sc = sc;
  b.gt = gt;
  return b;
}

template <typename C, bool S>
void launch_pitched(int nb, const float* p, const float* g, const float* t,
                    const Neighbors& nbp, float* p_out, float* t_out,
                    const eg::Pitch& pg, const Scalars& sc, const Gates& gt,
                    int vec, cudaStream_t st) {
  const dim3 grid = eg::grid_pitched(pg.rows, pg.cols);
  switch (nb) {
    case 1:
      mix_commit_carrier_pitched_kernel<C, S, 1><<<grid, eg::kThreads, 0, st>>>(
          carrier_body<C, S, 1>(p, g, t, nbp, p_out, t_out, sc, gt), pg,
          vec);
      break;
    case 2:
      mix_commit_carrier_pitched_kernel<C, S, 2><<<grid, eg::kThreads, 0, st>>>(
          carrier_body<C, S, 2>(p, g, t, nbp, p_out, t_out, sc, gt), pg,
          vec);
      break;
    case 3:
      mix_commit_carrier_pitched_kernel<C, S, 3><<<grid, eg::kThreads, 0, st>>>(
          carrier_body<C, S, 3>(p, g, t, nbp, p_out, t_out, sc, gt), pg,
          vec);
      break;
    default:
      mix_commit_carrier_pitched_kernel<C, S, 4><<<grid, eg::kThreads, 0, st>>>(
          carrier_body<C, S, 4>(p, g, t, nbp, p_out, t_out, sc, gt), pg,
          vec);
      break;
  }
}

}  // namespace

// As eg_mix_commit_carrier, over one bucket: p, g, t, p_out, t_out are
// [rows, ld] arenas (columns [off, off + cols) read and written), the
// per-neighbor arrays [rows, cols]. w_rows, gate: the gated form's
// per-row operands (each NULL when unused); the gated form over a whole
// [R, n] arena is this entry at off = 0, ld = cols = n.
extern "C" int eg_mix_commit_carrier_pitched(
    const float* p, const float* g, const float* t, const void* const* cands,
    const float* const* keeps, const void* const* lasts,
    const float* const* scales, float* p_out, float* t_out,
    void* const* bufs_out, int nb, int64_t rows, int64_t cols, int64_t ld,
    int64_t off, float lr, float mom, float w, int mix_stale, int carrier,
    const float* w_rows, const uint8_t* gate, int vec, void* stream) {
  const eg::Pitch pg = {rows, cols, ld, off};
  if (nb < 1 || nb > kMaxNb || !eg::pitch_ok(pg))
    return (int)cudaErrorInvalidValue;
  if ((carrier == 0) != (scales != nullptr)) return (int)cudaErrorInvalidValue;
  if (carrier != 0 && carrier != 1) return (int)cudaErrorInvalidValue;
  if (cols == 0) return 0;
  Neighbors nbp = {};
  for (int i = 0; i < nb; ++i) {
    nbp.cand[i] = cands[i];
    nbp.keep[i] = keeps[i];
    nbp.last[i] = lasts[i];
    nbp.scale[i] = scales ? scales[i] : nullptr;
    nbp.out[i] = bufs_out[i];
  }
  const Scalars sc = {lr, mom, w, mix_stale};
  const Gates gt = {w_rows, gate};
  cudaStream_t st = (cudaStream_t)stream;
  if (carrier == 0)
    launch_pitched<int8_t, true>(nb, p, g, t, nbp, p_out, t_out, pg, sc, gt,
                                 vec, st);
  else
    launch_pitched<__nv_bfloat16, false>(nb, p, g, t, nbp, p_out, t_out, pg,
                                         sc, gt, vec, st);
  return (int)cudaGetLastError();
}
