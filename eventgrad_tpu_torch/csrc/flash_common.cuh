// Shared pieces of the three flash-attention kernels (flash_fwd.cu,
// flash_dq.cu, flash_dkv.cu).
//
// One thread block of 256 threads owns one 64-row tile (of Q in the
// forward and dQ kernels, of K/V in the dK/dV kernel) of one (batch,
// head) pair and sweeps the 64-row tiles of the other side in a loop.
// The threads form a 16 x 16 grid (ty, tx); each holds a 4 x 4 patch of
// the 64 x 64 score tile and a 4 x (DMAX/16) patch of the 64 x DMAX
// output tile in registers. Every product is plain float32 FMAs
// (`fmaf`, which stays fused under -fmad=false): inputs are converted to
// float32 as they are staged into shared memory, so float32 and
// bfloat16 inputs share one body and accumulate in float32.
//
// Tiles in shared memory come in two layouts:
//   transposed [DMAX][68]  — the operand of a product that reduces over
//       the head dimension: a thread reads its 4 rows as one float4;
//   rows       [64][DMAX+8] — the right operand of a product that
//       reduces over tile rows (p v, ds k): a thread reads its output
//       columns as one float2 or float4.
// The row strides (68 and DMAX+8 floats) keep both the staging stores
// and the float4 reads free of bank conflicts: a warp stages 4 rows x 8
// consecutive head elements at a time (4 full 32-byte sectors).
//
// The TPU kernels pad T to 128 rows and D to 128 lanes; here any T >= 1
// and any D <= DMAX run: rows past T and head elements past D are staged
// as zeros, keys past T are masked, and query rows past T are not
// written. Masking is finite (-1e30) with p forced to exactly 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace egf {

constexpr int kTile = 64;
constexpr int kThreads = 256;
constexpr int kLdT = kTile + 4;  // row stride of a transposed or score tile
constexpr float kNegInf = -1e30f;
constexpr float kLFloor = 1e-30f;

// floats in a row of a by-rows tile, and in each kind of tile
__host__ __device__ constexpr int ld_rows(int dmax) { return dmax + 8; }
__host__ __device__ constexpr int trans_floats(int dmax) {
  return dmax * kLdT;
}
__host__ __device__ constexpr int rows_floats(int dmax) {
  return kTile * ld_rows(dmax);
}
__host__ __device__ constexpr int score_floats() { return kTile * kLdT; }

// (batch, time, head) element strides of up to four [B, T, H, D] tensors
struct Strides {
  int64_t v[12];
};

struct Shape {
  int b, t, h, d;
  int n_off, per, causal;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
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

// Stage rows [row0, row0 + 64) of one (batch, head) slice (row stride
// `st` elements, head dimension contiguous) into shared memory as
// float32 times `mul`, transposed and/or by rows; zeros past t and d.
template <typename T, int DMAX, bool TRANS, bool ROWS>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          int64_t st, int row0, int t, int d,
                                          float mul, float* dst_t,
                                          float* dst_r) {
  constexpr int kIters = kTile * DMAX / kThreads;
  constexpr int kChunks = DMAX / 8;
#pragma unroll 4
  for (int it = 0; it < kIters; ++it) {
    const int e = it * kThreads + threadIdx.x;
    const int w = e >> 5;
    const int dd = (w % kChunks) * 8 + (e & 7);
    const int r = (w / kChunks) * 4 + ((e >> 3) & 3);
    const int row = row0 + r;
    float x = 0.f;
    if (row < t && dd < d) x = to_float(src[(int64_t)row * st + dd]) * mul;
    if constexpr (TRANS) dst_t[dd * kLdT + r] = x;
    if constexpr (ROWS) dst_r[r * ld_rows(DMAX) + dd] = x;
  }
}

__device__ __forceinline__ void unpack(const float4& v, float (&o)[4]) {
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}

// acc[i][j] += sum_dd a_t[dd][ty*4+i] * b_t[dd][tx*4+j]
__device__ __forceinline__ void mma_tt(const float* a_t, const float* b_t,
                                       int d, int ty, int tx,
                                       float (&acc)[4][4]) {
#pragma unroll 4
  for (int dd = 0; dd < d; ++dd) {
    float a[4], b[4];
    unpack(*reinterpret_cast<const float4*>(a_t + dd * kLdT + ty * 4), a);
    unpack(*reinterpret_cast<const float4*>(b_t + dd * kLdT + tx * 4), b);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// The same for two products sharing the loop: acc1 from (a1, b1), acc2
// from (a2, b2).
__device__ __forceinline__ void mma_tt2(const float* a1_t, const float* b1_t,
                                        const float* a2_t, const float* b2_t,
                                        int d, int ty, int tx,
                                        float (&acc1)[4][4],
                                        float (&acc2)[4][4]) {
#pragma unroll 2
  for (int dd = 0; dd < d; ++dd) {
    float a1[4], b1[4], a2[4], b2[4];
    unpack(*reinterpret_cast<const float4*>(a1_t + dd * kLdT + ty * 4), a1);
    unpack(*reinterpret_cast<const float4*>(b1_t + dd * kLdT + tx * 4), b1);
    unpack(*reinterpret_cast<const float4*>(a2_t + dd * kLdT + ty * 4), a2);
    unpack(*reinterpret_cast<const float4*>(b2_t + dd * kLdT + tx * 4), b2);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc1[i][j] = fmaf(a1[i], b1[j], acc1[i][j]);
        acc2[i][j] = fmaf(a2[i], b2[j], acc2[i][j]);
      }
  }
}

// A thread's DMAX/16 output columns: CW (2 or 4) consecutive columns
// starting at tx*CW, so that the 16 threads of a row read one contiguous
// run of a staged row, each as one float2 or float4.
template <int DMAX>
struct Cols {
  static constexpr int CW = DMAX / 16;
  static_assert(CW == 2 || CW == 4, "DMAX is 32 or 64");
  __device__ static __forceinline__ int col(int tx, int c) {
    return tx * CW + c;
  }
  // the thread's CW values of one staged row
  __device__ static __forceinline__ void load(const float* row, int tx,
                                              float (&o)[CW]) {
    const float* p = row + tx * CW;
    if constexpr (CW == 4) {
      unpack(*reinterpret_cast<const float4*>(p), o);
    } else {
      const float2 v = *reinterpret_cast<const float2*>(p);
      o[0] = v.x;
      o[1] = v.y;
    }
  }
};

// acc[i][c] += sum_kk p[ty*4+i][kk] * x_r[kk][col(c)]  (reduce over the
// score tile's columns)
template <int DMAX>
__device__ __forceinline__ void mma_pn(const float* p, const float* x_r,
                                       int ty, int tx,
                                       float (&acc)[4][DMAX / 16]) {
  using C = Cols<DMAX>;
#pragma unroll 2
  for (int kk = 0; kk < kTile; kk += 4) {
    float pv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      unpack(*reinterpret_cast<const float4*>(p + (ty * 4 + i) * kLdT + kk),
             pv[i]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float xv[C::CW];
      C::load(x_r + (kk + u) * ld_rows(DMAX), tx, xv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < C::CW; ++c)
          acc[i][c] = fmaf(pv[i][u], xv[c], acc[i][c]);
    }
  }
}

// acc[i][j] += sum_r a_t[ty*RPT+i][r] * p[r][tx*4+j]: a transposed
// output patch (rows = head elements, RPT = DMAX/16 per thread; columns
// = the score tile's columns), reducing over the score tile's rows. It
// is the dK/dV kernel's dV^T = dO^T p and dK^T = q^T ds, read from the
// transposed tiles that the score products already need.
template <int RPT>
__device__ __forceinline__ void mma_ts(const float* a_t, const float* p,
                                       int ty, int tx, float (&acc)[RPT][4]) {
#pragma unroll 2
  for (int r = 0; r < kTile; r += 4) {
    float av[RPT][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      unpack(*reinterpret_cast<const float4*>(a_t + (ty * RPT + i) * kLdT + r),
             av[i]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float pv[4];
      unpack(*reinterpret_cast<const float4*>(p + (r + u) * kLdT + tx * 4), pv);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i][u], pv[j], acc[i][j]);
    }
  }
}

// Write a thread's transposed RPT x 4 patch (head elements ty*RPT + i of
// rows row0 + tx*4 + j) into a contiguous [B, T, H, D] tensor; rows past
// t and head elements past d are not written.
template <typename T, int RPT>
__device__ __forceinline__ void write_patch_t(T* __restrict__ out,
                                              const Shape& s, int b, int hh,
                                              int row0, int ty, int tx,
                                              const float (&acc)[RPT][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int row = row0 + tx * 4 + j;
    if (row >= s.t) continue;
    T* dst = out + (((int64_t)b * s.t + row) * s.h + hh) * s.d;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int col = ty * RPT + i;
      if (col < s.d) store(dst + col, acc[i][j]);
    }
  }
}

// Write a thread's 4 x CW output patch (rows row0 + ty*4 + i) into a
// contiguous [B, T, H, D] tensor; rows past t and columns past d are not
// written.
template <typename T, int DMAX>
__device__ __forceinline__ void write_patch(T* __restrict__ out,
                                            const Shape& s, int b, int hh,
                                            int row0, int ty, int tx,
                                            const float (&acc)[4][DMAX / 16]) {
  using C = Cols<DMAX>;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= s.t) continue;
    T* dst = out + (((int64_t)b * s.t + row) * s.h + hh) * s.d;
#pragma unroll
    for (int c = 0; c < C::CW; ++c) {
      const int col = C::col(tx, c);
      if (col < s.d) store(dst + col, acc[i][c]);
    }
  }
}

// max / sum over the 16 threads (one half-warp) that share a score row
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o >= 1; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o >= 1; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Call FN<T, DMAX>(...) for the element type of `dtype` (0 = float32,
// 1 = bfloat16) and the smaller DMAX of {32, 64} holding d;
// cudaErrorInvalidValue for anything else. (DMAX = 128 is not
// instantiated yet: the tiles would fit, at one block per SM.)
#define EGF_DISPATCH(dtype, d, FN, ...)                               \
  (((d) < 1 || (d) > 64 || ((dtype) != 0 && (dtype) != 1))            \
       ? cudaErrorInvalidValue                                        \
   : (dtype) == 0 ? ((d) <= 32 ? FN<float, 32>(__VA_ARGS__)           \
                               : FN<float, 64>(__VA_ARGS__))          \
                  : ((d) <= 32 ? FN<__nv_bfloat16, 32>(__VA_ARGS__)   \
                               : FN<__nv_bfloat16, 64>(__VA_ARGS__)))

// Opt a kernel into `bytes` of dynamic shared memory and launch it on
// `grid` blocks; returns the launch's error.
template <typename K, typename... A>
inline cudaError_t launch_kernel(K kernel, int64_t grid, size_t bytes,
                                 void* stream, A... args) {
  if (grid < 1 || grid > 2147483647LL) return cudaErrorInvalidValue;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (rc != cudaSuccess) return rc;
  kernel<<<(unsigned)grid, kThreads, bytes, (cudaStream_t)stream>>>(args...);
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
