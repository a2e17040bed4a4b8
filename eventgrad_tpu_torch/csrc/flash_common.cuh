// The SIMT pieces of the dQ kernel (flash_dq.cu); the forward and dK/dV
// kernels run on the tensor cores (flash_mma.cuh).
//
// One thread block of 256 threads owns one 64-row Q tile of one (batch,
// head) pair and sweeps the 64-row K/V tiles in a loop. The threads form
// a 16 x 16 grid (ty, tx); each holds a 4 x 4 patch of the 64 x 64 score
// tile and a 4 x (DMAX/16) patch of the 64 x DMAX output tile in
// registers. Every product is plain float32 FMAs (`fmaf`, which stays
// fused under -fmad=false): inputs are converted to float32 as they are
// staged into shared memory, so float32 and bfloat16 inputs share one
// body and accumulate in float32.
//
// Tiles in shared memory come in two layouts:
//   transposed [DMAX][68]  — the operand of a product that reduces over
//       the head dimension: a thread reads its 4 rows as one float4;
//   rows       [64][DMAX+8] — the right operand of a product that
//       reduces over tile rows (ds k): a thread reads its output
//       columns as one float2 or float4.
// The row strides (68 and DMAX+8 floats) keep both the staging stores
// and the float4 reads free of bank conflicts: a warp stages 4 rows x 8
// consecutive head elements at a time (4 full 32-byte sectors).
//
// The TPU kernels pad T to 128 rows and D to 128 lanes; here any T >= 1
// and any D <= DMAX run: rows past T and head elements past D are staged
// as zeros, keys past T are masked, and query rows past T are not
// written.
#pragma once

#include "flash_base.cuh"

namespace egf {

constexpr int kTile = 64;
constexpr int kThreads = 256;
constexpr int kLdT = kTile + 4;  // row stride of a transposed or score tile

// floats in a row of a by-rows tile, and in each kind of tile
__host__ __device__ constexpr int ld_rows(int dmax) { return dmax + 8; }
__host__ __device__ constexpr int trans_floats(int dmax) {
  return dmax * kLdT;
}
__host__ __device__ constexpr int rows_floats(int dmax) {
  return kTile * ld_rows(dmax);
}
__host__ __device__ constexpr int score_floats() { return kTile * kLdT; }

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

// acc1[i][j] += sum_dd a1_t[dd][ty*4+i] * b1_t[dd][tx*4+j], and acc2
// the same from (a2_t, b2_t), in one loop over the head dimension.
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

}  // namespace egf
