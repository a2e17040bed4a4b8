// Fused buffer-commit + gossip-mix + momentum-SGD over the flat arena.
//
// Replaces the TPU kernel eventgrad_tpu/ops/arena_update.py:_commit_kernel
// (launched by _fused_commit_flat, entry fused_mix_commit). Per element
// and per neighbor i, in the JAX kernel's order:
//
//   buf_i' = where(keep_i > 0, cand_i, last_i)        (the commit)
//   acc    = p;  acc += (mix_stale ? last_i : buf_i')  for each i
//   mixed  = acc * w
//   t'     = mom * t + g
//   p'     = mixed - lr * t'
//
// writing (p', t', buf_0'..buf_{nb-1}').
//
// The gated form (chaos and integrity on the fused tail) takes optional
// per-row operands, each a null pointer when unused: w_rows (f32 [R],
// the mix weight 1/(1 + n_alive) per rank), gate (u8 [R, nb]: 0 takes
// the edge out of the mix, which then adds +0.0f), poison (f32 [R], NaN
// or 1: the factor optax's poisoned tail puts on the update and the new
// trace) and quar (u8 [R], quarantine: p' = mixed, t' = t). In optax's
// order:
//
//   acc    = p;  acc += gate_i ? (mix_stale ? last_i : buf_i') : +0.0f
//   mixed  = acc * w_r
//   t'     = (mom * t + g) * poison_r
//   p'     = mixed - (lr * (mom * t + g)) * poison_r
//   quar_r:  p' = mixed, t' = t
//
// With every gate open, w_r = w and poison_r = 1 it is bitwise the
// ungated form (x * 1.0f is exact). It runs as the pitched body over the
// whole [R, n] arena, one grid row per rank, so each block reads its
// row's operands once, before the row's elements.
//
// Bound on the card: bytes. With nb = 2 it reads p, g, t and per
// neighbor cand, keep, last (9 f32 reads) and writes p', t' and two
// buffers (4 f32 writes): 52 B/elem, about 7.26 GB for the flagship
// Ring(8) ResNet-18 step (8 x 17,444,682 elements), i.e. about 2.17 ms
// at 3.35 TB/s. The design is one grid-stride float4 stream over all
// ranks with the neighbor pointers in a by-value struct; the per-position
// f32 keep bits are a quarter of the reads (bits, or a per-leaf lookup
// through the segment map, are later work).
#include "common.cuh"

namespace {

constexpr int kMaxNb = 4;

struct Neighbors {
  const float* cand[kMaxNb];
  const float* keep[kMaxNb];
  const float* last[kMaxNb];
  float* out[kMaxNb];
};

struct Scalars {
  float lr, mom, w;
  int mix_stale;
};

template <int NB>
__device__ __forceinline__ void commit_elem(float p, float g, float t,
                                            const float* c, const float* k,
                                            const float* l, const Scalars& s,
                                            float& po, float& to, float* bo) {
  float acc = p;
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const float nb = k[i] > 0.f ? c[i] : l[i];
    bo[i] = nb;
    acc = __fadd_rn(acc, s.mix_stale ? l[i] : nb);
  }
  const float mixed = __fmul_rn(acc, s.w);
  const float tr = __fadd_rn(__fmul_rn(s.mom, t), g);
  po = __fsub_rn(mixed, __fmul_rn(s.lr, tr));
  to = tr;
}

// the gated form's per-row operands (null = unused)
struct Gates {
  const float* w_rows;
  const uint8_t* gate;
  const float* poison;
  const uint8_t* quar;
};

// one row's gated operands
struct RowOps {
  float w, pz;
  bool q;
  bool on[kMaxNb];
};

__device__ __forceinline__ RowOps row_ops(const Gates& gt, int nb,
                                          const Scalars& s, int64_t r) {
  RowOps o;
  o.w = gt.w_rows ? gt.w_rows[r] : s.w;
  o.pz = gt.poison ? gt.poison[r] : 1.0f;
  o.q = gt.quar ? gt.quar[r] != 0 : false;
#pragma unroll
  for (int i = 0; i < kMaxNb; ++i)
    o.on[i] = (gt.gate && i < nb) ? gt.gate[r * nb + i] != 0 : true;
  return o;
}

// the gated element: a closed gate adds +0.0f (an accumulator of -0.0
// becomes +0.0, as where(False, b, 0) does); the poison factor and the
// quarantine select follow optax's tail
template <int NB>
__device__ __forceinline__ void commit_elem_gated(
    float p, float g, float t, const float* c, const float* k,
    const float* l, const Scalars& s, const RowOps& o, float& po, float& to,
    float* bo) {
  float acc = p;
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const float nb = k[i] > 0.f ? c[i] : l[i];
    bo[i] = nb;
    acc = __fadd_rn(acc, o.on[i] ? (s.mix_stale ? l[i] : nb) : 0.0f);
  }
  const float mixed = __fmul_rn(acc, o.w);
  const float tr = __fadd_rn(__fmul_rn(s.mom, t), g);
  const float upd = __fmul_rn(__fmul_rn(s.lr, tr), o.pz);
  po = o.q ? mixed : __fsub_rn(mixed, upd);
  to = o.q ? t : __fmul_rn(tr, o.pz);
}

template <int NB>
__global__ void mix_commit_kernel(const float* __restrict__ p,
                                  const float* __restrict__ g,
                                  const float* __restrict__ t, Neighbors nbp,
                                  float* __restrict__ p_out,
                                  float* __restrict__ t_out, int64_t n,
                                  Scalars s, int vec) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  float c[NB], k[NB], l[NB], bo[NB];
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n / 4;
    for (int64_t i = tid; i < n4; i += stride) {
      const float4 pv = eg::ld4(p, i), gv = eg::ld4(g, i), tv = eg::ld4(t, i);
      float4 cv[NB], kv[NB], lv[NB], bv[NB], pov, tov;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        cv[j] = eg::ld4(nbp.cand[j], i);
        kv[j] = eg::ld4(nbp.keep[j], i);
        lv[j] = eg::ld4(nbp.last[j], i);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          c[j] = eg::lane(cv[j], q);
          k[j] = eg::lane(kv[j], q);
          l[j] = eg::lane(lv[j], q);
        }
        float po, to;
        commit_elem<NB>(eg::lane(pv, q), eg::lane(gv, q), eg::lane(tv, q), c,
                        k, l, s, po, to, bo);
        eg::set_lane(pov, q, po);
        eg::set_lane(tov, q, to);
#pragma unroll
        for (int j = 0; j < NB; ++j) eg::set_lane(bv[j], q, bo[j]);
      }
      eg::st4(p_out, i, pov);
      eg::st4(t_out, i, tov);
#pragma unroll
      for (int j = 0; j < NB; ++j) eg::st4(nbp.out[j], i, bv[j]);
    }
    done = n4 * 4;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      c[j] = nbp.cand[j][i];
      k[j] = nbp.keep[j][i];
      l[j] = nbp.last[j][i];
    }
    commit_elem<NB>(p[i], g[i], t[i], c, k, l, s, p_out[i], t_out[i], bo);
#pragma unroll
    for (int j = 0; j < NB; ++j) nbp.out[j][i] = bo[j];
  }
}

template <int NB>
void launch(const float* p, const float* g, const float* t,
            const Neighbors& nbp, float* p_out, float* t_out, int64_t n,
            const Scalars& s, int vec, cudaStream_t stream) {
  const int64_t work = vec ? n / 4 + 1 : n;
  mix_commit_kernel<NB><<<eg::grid_for(work), eg::kThreads, 0, stream>>>(
      p, g, t, nbp, p_out, t_out, n, s, vec);
}

}  // namespace

// cands/keeps/lasts/bufs_out are host arrays of nb device pointers.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// an unsupported neighbor count).
extern "C" int eg_mix_commit(const float* p, const float* g, const float* t,
                             const float* const* cands,
                             const float* const* keeps,
                             const float* const* lasts, float* p_out,
                             float* t_out, float* const* bufs_out, int nb,
                             int64_t n, float lr, float mom, float w,
                             int mix_stale, int vec, void* stream) {
  if (nb < 1 || nb > kMaxNb) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  Neighbors nbp = {};
  for (int i = 0; i < nb; ++i) {
    nbp.cand[i] = cands[i];
    nbp.keep[i] = keeps[i];
    nbp.last[i] = lasts[i];
    nbp.out[i] = bufs_out[i];
  }
  const Scalars s = {lr, mom, w, mix_stale};
  cudaStream_t st = (cudaStream_t)stream;
  switch (nb) {
    case 1: launch<1>(p, g, t, nbp, p_out, t_out, n, s, vec, st); break;
    case 2: launch<2>(p, g, t, nbp, p_out, t_out, n, s, vec, st); break;
    case 3: launch<3>(p, g, t, nbp, p_out, t_out, n, s, vec, st); break;
    default: launch<4>(p, g, t, nbp, p_out, t_out, n, s, vec, st); break;
  }
  return (int)cudaGetLastError();
}

// --- the pitched (bucket) form -----------------------------------------
//
// The commit + mix + SGD of one bucket of the bucketed schedule: p, g, t
// are the [rows, ld] arenas read in place at columns [off, off + cols),
// and p', t' are written into the same columns of the [rows, ld] output
// arenas; the candidates, keeps, stale and committed buffers are the
// bucket's contiguous [rows, cols] arrays (common.cuh "the pitched
// forms"). Same arithmetic and bytes per element as the contiguous form.

namespace {

template <int NB>
struct CommitBody {
  const float* p;
  const float* g;
  const float* t;
  Neighbors nbp;
  float* p_out;
  float* t_out;
  Scalars s;
  Gates gt;
  // the gated form: set per block from gt
  bool gated;
  RowOps o;

  template <int W>
  __device__ __forceinline__ void at(int64_t a, int64_t b) const {
    const eg::Vec<float, W> pv = eg::ldv<W>(p + a), gv = eg::ldv<W>(g + a),
                            tv = eg::ldv<W>(t + a);
    eg::Vec<float, W> cv[NB], kv[NB], lv[NB], bv[NB], pov, tov;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      cv[j] = eg::ldv<W>(nbp.cand[j] + b);
      kv[j] = eg::ldv<W>(nbp.keep[j] + b);
      lv[j] = eg::ldv<W>(nbp.last[j] + b);
    }
    float c[NB], k[NB], l[NB], bo[NB];
#pragma unroll
    for (int q = 0; q < W; ++q) {
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        c[j] = cv[j].v[q];
        k[j] = kv[j].v[q];
        l[j] = lv[j].v[q];
      }
      if (gated)
        commit_elem_gated<NB>(pv.v[q], gv.v[q], tv.v[q], c, k, l, s, o,
                              pov.v[q], tov.v[q], bo);
      else
        commit_elem<NB>(pv.v[q], gv.v[q], tv.v[q], c, k, l, s, pov.v[q],
                        tov.v[q], bo);
#pragma unroll
      for (int j = 0; j < NB; ++j) bv[j].v[q] = bo[j];
    }
    eg::stv<W>(p_out + a, pov);
    eg::stv<W>(t_out + a, tov);
#pragma unroll
    for (int j = 0; j < NB; ++j) eg::stv<W>(nbp.out[j] + b, bv[j]);
  }
};

template <int NB>
__global__ void mix_commit_pitched_kernel(CommitBody<NB> body, eg::Pitch g,
                                          int vec) {
  // the gated form's row operands: read once per block, before the row
  body.gated = body.gt.w_rows || body.gt.gate || body.gt.poison ||
               body.gt.quar;
  if (body.gated) body.o = row_ops(body.gt, NB, body.s, blockIdx.y);
  eg::pitched_row(g, vec, body);
}

template <int NB>
void launch_pitched(const float* p, const float* g, const float* t,
                    const Neighbors& nbp, float* p_out, float* t_out,
                    const eg::Pitch& pg, const Scalars& s, const Gates& gt,
                    int vec, cudaStream_t stream) {
  CommitBody<NB> body = {};
  body.p = p;
  body.g = g;
  body.t = t;
  body.nbp = nbp;
  body.p_out = p_out;
  body.t_out = t_out;
  body.s = s;
  body.gt = gt;
  mix_commit_pitched_kernel<NB>
      <<<eg::grid_pitched(pg.rows, pg.cols), eg::kThreads, 0, stream>>>(
          body, pg, vec);
}

}  // namespace

// As eg_mix_commit, over one bucket: p, g, t, p_out, t_out are
// [rows, ld] arenas (columns [off, off + cols) read and written),
// cands/keeps/lasts/bufs_out host arrays of nb [rows, cols] device
// arrays. w_rows, gate, poison, quar: the gated form's per-row operands
// (each NULL when unused); the gated form over a whole [R, n] arena is
// this entry at off = 0, ld = cols = n.
extern "C" int eg_mix_commit_pitched(
    const float* p, const float* g, const float* t, const float* const* cands,
    const float* const* keeps, const float* const* lasts, float* p_out,
    float* t_out, float* const* bufs_out, int nb, int64_t rows, int64_t cols,
    int64_t ld, int64_t off, float lr, float mom, float w, int mix_stale,
    const float* w_rows, const uint8_t* gate, const float* poison,
    const uint8_t* quar, int vec, void* stream) {
  const eg::Pitch pg = {rows, cols, ld, off};
  if (nb < 1 || nb > kMaxNb || !eg::pitch_ok(pg))
    return (int)cudaErrorInvalidValue;
  if (cols == 0) return 0;
  Neighbors nbp = {};
  for (int i = 0; i < nb; ++i) {
    nbp.cand[i] = cands[i];
    nbp.keep[i] = keeps[i];
    nbp.last[i] = lasts[i];
    nbp.out[i] = bufs_out[i];
  }
  const Scalars s = {lr, mom, w, mix_stale};
  const Gates gt = {w_rows, gate, poison, quar};
  cudaStream_t st = (cudaStream_t)stream;
  switch (nb) {
    case 1: launch_pitched<1>(p, g, t, nbp, p_out, t_out, pg, s, gt, vec, st); break;
    case 2: launch_pitched<2>(p, g, t, nbp, p_out, t_out, pg, s, gt, vec, st); break;
    case 3: launch_pitched<3>(p, g, t, nbp, p_out, t_out, pg, s, gt, vec, st); break;
    default: launch_pitched<4>(p, g, t, nbp, p_out, t_out, pg, s, gt, vec, st); break;
  }
  return (int)cudaGetLastError();
}
