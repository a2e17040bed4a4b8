// What every flash-attention kernel shares, whatever its body: the shape
// and strides it is launched with, the per-rank causal offsets, the
// validity rule of a score, the dtype/head-width dispatch and the launch.
//
// Masking keeps the results finite: an invalid score's p is exactly 0
// and a row max starts at -1e30, so a fully masked row ends with out = 0
// and a finite lse.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace egf {

constexpr float kNegInf = -1e30f;
constexpr float kLFloor = 1e-30f;

// (batch, time, head) element strides of up to four [B, T, H, D] tensors
struct Strides {
  int64_t v[12];
};

struct Shape {
  int b, t, h, d;
  int n_off, per, causal;
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// The causal offsets of batch row b: entry (b / per) % n_off of the
// [n_off, 2] table, or (0, 0) without a table.
__device__ __forceinline__ void load_offsets(const int* offs, const Shape& s,
                                             int b, int& q_off, int& k_off) {
  q_off = k_off = 0;
  if (offs != nullptr) {
    const int oi = (b / s.per) % s.n_off;
    q_off = offs[2 * oi];
    k_off = offs[2 * oi + 1];
  }
}

__device__ __forceinline__ bool valid_at(int qpos, int kpos, int t, int causal,
                                         int q_off, int k_off) {
  return kpos < t && (!causal || q_off + qpos >= k_off + kpos);
}

// Call FN<T, DMAX, WIDE>(...) for the element type of `dtype` (0 =
// float32, 1 = bfloat16) and the head width d >= 1; cudaErrorInvalidValue
// for anything else. The instantiations and the widths each serves:
//
//   <T, 32, false>   d in [1, 32]
//   <T, 64, false>   d in [33, 64]
//   <T, 128, false>  d in [65, 128]
//   <T, 128, true>   every d > 128: the wide form, which streams the
//                    head dimension through the score products in
//                    chunks of 128 columns and gives each block one
//                    128-column chunk of the output (flash_mma.cuh)
//
// A d short of its instantiation's columns (or of the wide form's last
// chunk) runs on zero-filled columns (every tile load fills the columns
// at and past d with zeros, as the reference pads D to a multiple of its
// 128 lanes) and stores only its d columns.
#define EGF_DISPATCH_D(T, d, FN, ...)                                 \
  ((d) <= 32    ? FN<T, 32, false>(__VA_ARGS__)                       \
   : (d) <= 64  ? FN<T, 64, false>(__VA_ARGS__)                       \
   : (d) <= 128 ? FN<T, 128, false>(__VA_ARGS__)                      \
                : FN<T, 128, true>(__VA_ARGS__))
#define EGF_DISPATCH(dtype, d, FN, ...)                               \
  (((d) < 1 || ((dtype) != 0 && (dtype) != 1))                        \
       ? cudaErrorInvalidValue                                        \
   : (dtype) == 0 ? EGF_DISPATCH_D(float, d, FN, __VA_ARGS__)         \
                  : EGF_DISPATCH_D(__nv_bfloat16, d, FN, __VA_ARGS__))

// The forms a launch takes, chosen by shape before it (never by a retry
// after a failed launch), the same rule as ops/flash_plan.py's
// flash_form:
//
//   kFormWgmma  bfloat16 at D = 64, 128 or 256 with every q/k/v (and dO)
//               pointer 16-byte aligned and every (batch, time, head)
//               stride a positive multiple of 16 bytes, which TMA needs:
//               flash_fwd_wgmma.cu, flash_dq_wgmma.cu, flash_dkv_wgmma.cu
//               (wgmma fed by TMA through an mbarrier ring);
//   kFormWhole  float32 at D = 256: flash_fwd_whole.cu, flash_dq_whole.cu,
//               flash_dkv_whole.cu (3xTF32 on mma.sync, the scores of a
//               tile built once over all 256 columns and shared between
//               warps through shared memory);
//   kFormMma    everything else: the mma.sync kernels of EGF_DISPATCH
//               below.
enum Form { kFormMma = 0, kFormWgmma = 1, kFormWhole = 2 };

inline bool tma_ok(const void* const* ptrs, const int64_t* st, int n) {
  for (int i = 0; i < n; ++i) {
    if ((uintptr_t)ptrs[i] % 16) return false;
    for (int j = 0; j < 3; ++j)
      if (st[3 * i + j] <= 0 || (st[3 * i + j] * 2) % 16) return false;
  }
  return true;
}

// The form of a forward (n = 3: q, k, v) or dQ or dK/dV (n = 4: and
// dO) launch; `st` holds each tensor's (batch, time, head) element
// strides.
inline int flash_form(int dtype, int d, const void* const* ptrs,
                      const int64_t* st, int n) {
  if (dtype == 1 && (d == 64 || d == 128 || d == 256) && tma_ok(ptrs, st, n))
    return kFormWgmma;
  if (dtype == 0 && d == 256) return kFormWhole;
  return kFormMma;
}

// The launches of the other forms (their own files); `st` as above.
cudaError_t fwd_wgmma(const void* q, const void* k, const void* v, void* out,
                      float* lse, const int* offs, const int64_t* st,
                      const Shape& s, void* stream);
cudaError_t fwd_whole(const void* q, const void* k, const void* v, void* out,
                      float* lse, const int* offs, const int64_t* st,
                      const Shape& s, void* stream);
cudaError_t dq_wgmma(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dq, const int* offs, const int64_t* st,
                     const Shape& s, void* stream);
cudaError_t dq_whole(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dq, const int* offs, const int64_t* st,
                     const Shape& s, void* stream);
cudaError_t dkv_wgmma(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dk, void* dv, const int* offs, const int64_t* st,
                      const Shape& s, void* stream);
cudaError_t dkv_whole(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dk, void* dv, const int* offs, const int64_t* st,
                      const Shape& s, void* stream);
// Dynamic shared memory of each form's instantiation at head width d
// (0 where the form has none): ops/flash_plan.py's arithmetic.
size_t fwd_wgmma_smem(int d);
size_t fwd_whole_smem(int d);
size_t dq_wgmma_smem(int d);
size_t dq_whole_smem(int d);
size_t dkv_wgmma_smem(int d);
size_t dkv_whole_smem(int d);

// Opt a kernel into `bytes` of dynamic shared memory and launch it on
// `grid` blocks of THREADS threads; returns the launch's error.
template <int THREADS, typename K, typename... A>
inline cudaError_t launch_kernel(K kernel, int64_t grid, size_t bytes,
                                 void* stream, A... args) {
  if (grid < 1 || grid > 2147483647LL) return cudaErrorInvalidValue;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (rc != cudaSuccess) return rc;
  kernel<<<(unsigned)grid, THREADS, bytes, (cudaStream_t)stream>>>(args...);
  return cudaGetLastError();
}

inline Strides strides_from(const int64_t* host, int n_tensors) {
  Strides s{};
  for (int i = 0; i < 3 * n_tensors; ++i) s.v[i] = host[i];
  return s;
}

inline bool shape_ok(const Shape& s, const int* offs) {
  return s.b >= 1 && s.t >= 1 && s.h >= 1 && s.d >= 1 &&
         (offs == nullptr ? s.n_off == 0 : (s.n_off >= 1 && s.per >= 1));
}

// 1 / sqrt(D), rounded once from double as the plain version's is
inline float softmax_scale(int d) {
  return (float)(1.0 / sqrt((double)d));
}

}  // namespace egf
