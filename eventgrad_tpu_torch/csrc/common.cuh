// Shared pieces of the elementwise gossip-tail kernels.
//
// Every kernel here is one grid-stride pass over a flat float32 arena
// holding all ranks ([R * n] elements in ONE launch). When every pointer
// is 16-byte aligned the body runs on float4 vectors and a scalar loop
// finishes the ragged tail; otherwise the whole range runs scalar.
// Arithmetic uses the round-to-nearest intrinsics (__fadd_rn, __fmul_rn,
// __fsub_rn), which nvcc never contracts into an FMA, and the files are
// also built with -fmad=false: each kernel is bitwise its plain PyTorch
// version.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace eg {

constexpr int kThreads = 256;
// resident blocks per SM the grid aims for: enough to cover load latency
// on a memory-bound stream, few enough that each thread loops a while
constexpr int kBlocksPerSm = 8;

inline int grid_for(int64_t work) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  int64_t want = (work + kThreads - 1) / kThreads;
  int64_t cap = (int64_t)sms * kBlocksPerSm;
  if (want > cap) want = cap;
  return want < 1 ? 1 : (int)want;
}

__device__ __forceinline__ float lane(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__device__ __forceinline__ void set_lane(float4& v, int j, float x) {
  if (j == 0) v.x = x;
  else if (j == 1) v.y = x;
  else if (j == 2) v.z = x;
  else v.w = x;
}

__device__ __forceinline__ float4 ld4(const float* p, int64_t i4) {
  return reinterpret_cast<const float4*>(p)[i4];
}

__device__ __forceinline__ void st4(float* p, int64_t i4, const float4& v) {
  reinterpret_cast<float4*>(p)[i4] = v;
}

// --- the pitched (bucket) forms ---------------------------------------
//
// A bucket of the bucketed gossip schedule is the column range
// [off, off + cols) of the [rows, ld] arenas (parameters, gradients,
// momentum trace): a strided view once rows > 1. The pitched forms read
// and write those columns in place, and read and write the bucket's own
// operands (wire, keep bits, scales, receive buffers) as contiguous
// [rows, cols] arrays. In row r the arena element j sits at
// a = r * ld + off + j and the bucket element at b = r * cols + j.
struct Pitch {
  int64_t rows, cols, ld, off;
};

// W consecutive values loaded and stored as one aligned word
template <typename T, int W>
struct alignas(W * sizeof(T)) Vec {
  T v[W];
};

template <int W, typename T>
__device__ __forceinline__ Vec<T, W> ldv(const T* p) {
  return *reinterpret_cast<const Vec<T, W>*>(p);
}

template <int W, typename T>
__device__ __forceinline__ void stv(T* p, const Vec<T, W>& x) {
  *reinterpret_cast<Vec<T, W>*>(p) = x;
}

// Grid of a pitched launch: one grid row per bucket row, the columns
// split over blockIdx.x (about grid_for's total, shared by the rows).
inline dim3 grid_pitched(int64_t rows, int64_t cols) {
  int64_t per = grid_for(rows * (cols / 4 + 1)) / (rows > 0 ? rows : 1);
  const int64_t want = (cols / 4 + kThreads) / kThreads;
  if (per > want) per = want;
  return dim3(per < 1 ? 1 : (unsigned)per, (unsigned)rows);
}

// One pitched row: calls body.template at<W>(a, b) over the row's
// elements, W at a time where it can. Every base pointer is aligned for
// 4 of its elements (the launcher's `vec`), so a group is aligned
// wherever both a and b are multiples of W: the widest W in {4, 2, 1}
// with a = b (mod W) serves the row after a scalar head that aligns a;
// a scalar tail finishes it.
template <typename Body>
__device__ __forceinline__ void pitched_row(const Pitch& g, int vec,
                                            const Body& body) {
  const int64_t r = blockIdx.y;
  const int64_t a0 = r * g.ld + g.off, b0 = r * g.cols;
  const int64_t d = a0 - b0;
  const int w = !vec ? 1 : ((d & 3) == 0 ? 4 : ((d & 1) == 0 ? 2 : 1));
  int64_t h = (w - (a0 & (w - 1))) & (w - 1);
  if (h > g.cols) h = g.cols;
  const int64_t nv = (g.cols - h) / w;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t j = tid; j < h; j += stride) body.template at<1>(a0 + j, b0 + j);
  if (w == 4) {
    for (int64_t i = tid; i < nv; i += stride)
      body.template at<4>(a0 + h + 4 * i, b0 + h + 4 * i);
  } else if (w == 2) {
    for (int64_t i = tid; i < nv; i += stride)
      body.template at<2>(a0 + h + 2 * i, b0 + h + 2 * i);
  } else {
    for (int64_t i = tid; i < nv; i += stride)
      body.template at<1>(a0 + h + i, b0 + h + i);
  }
  for (int64_t j = h + nv * w + tid; j < g.cols; j += stride)
    body.template at<1>(a0 + j, b0 + j);
}

// Launcher-side check of a pitched geometry (rows fit grid.y, the
// bucket's columns fit the arena row).
inline bool pitch_ok(const Pitch& g) {
  return g.rows >= 1 && g.rows <= 65535 && g.cols >= 0 && g.off >= 0 &&
         g.off + g.cols <= g.ld;
}

}  // namespace eg
