// Tensor-core machinery of the flash-attention kernels (flash_fwd.cu,
// flash_dq.cu, flash_dkv.cu): asynchronous tile copies, fragment loads
// and warp-level matrix products for bfloat16 and float32 inputs.
//
// A block has 4 warps; a warp owns 16 rows of its block's 64-row tile
// and computes 16 x 64 score tiles with mma.sync, sums in float32 (the
// dK/dV kernel at DMAX = 128, and the float32 forward and dQ there, have
// 8 warps, two to each 16 rows). Tiles
// sit in shared memory by rows, [64][DMAX + 16 bytes]: the 16 bytes of
// padding keep every ldmatrix (8 rows of 16 bytes) and the float32
// path's paired scalar reads free of bank conflicts.
//
// Head widths above 128 run the wide form of each kernel (WIDE = true,
// DMAX = 128) wherever flash_base.cuh's flash_form keeps the mma.sync
// form: widths other than 256, and bfloat16 at 256 on rows TMA cannot
// read (bfloat16 at 256 otherwise runs the wgmma form, float32 the whole
// form, which build each score tile once). The tiles hold 128-column chunks of a row
// (`load_tile_async` takes the chunk's first column), the score products
// stream the head dimension through them chunk by chunk (0, 1, ... in
// order, summing each score in the order a whole-width product would),
// and each block owns one 128-column chunk of the output, whose
// accumulators are those of DMAX = 128. The scores are rebuilt once per
// output chunk: ceil(D / 128) times. The copy ring keeps two stages
// where they fit (`ring_slots`), else one.
//
// bfloat16 (Tc<__nv_bfloat16>): mma.m16n8k16 with bf16 operands; A and B
// come from shared memory through ldmatrix (ldmatrix.trans for a B stored
// [k][n]). A product whose left operand is a score tile (p v, ds k,
// p^T dO, ds^T q) takes it from the accumulators of the score product as
// they lie, rounded to bf16: two adjacent n8 accumulator tiles are one
// k16 A fragment. (The TPU kernel keeps p and ds in float32 for that
// product.)
//
// float32 (Tc<float>): 3xTF32 on mma.m16n8k8.tf32. Each operand x is
// split into big = tf32(x) and small = tf32(x - big), both rounded as
// cvt.rna.tf32.f32 rounds, and a product sums small*big + big*small +
// big*big in float32: about 22 significand bits per operand, where one
// TF32 product keeps 11. Every warp splits the fragments it loads. The
// rounding is an integer add and mask: on the H100 both kernels run
// about a fifth faster with it than with the cvt instruction. The
// float32 tiles go through ldmatrix as pairs of 16-bit halves (a 32-bit
// element stays whole). A score-tile left operand is read from its
// accumulator as it lies: registers (c0, c2, c1, c3) of an n8 tile are
// an A fragment whose k index t holds column 2t and k index t + 4 column
// 2t + 1, so the B rows are read in the same order (tile rows 2t and
// 2t + 1, two scalar reads).
#pragma once

#include "flash_base.cuh"

namespace egf {

constexpr int kRows = 64;    // rows of a tile
constexpr int kBlock = 128;  // 4 warps
constexpr float kLog2e = 1.4426950408889634f;
// the most dynamic shared memory a block may opt into on the H100
constexpr int kSmemMax = 232448;

// Stages of a copy ring whose stage takes `stage_bytes`, beside `extra`
// bytes: two (stage i + 1 loads while stage i is computed) where they
// fit, else one (each stage loads after the last is computed).
__host__ __device__ constexpr int ring_slots(int stage_bytes, int extra) {
  return 2 * stage_bytes + extra <= kSmemMax ? 2 : 1;
}

// --- PTX primitives ---------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, of which the first `src_bytes` are read and
// the rest zero-filled; both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared (zero-filled when src_bytes is 0)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// every committed group but the newest is in
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Four 8 x 8 matrices of 16-bit elements: lanes 8i..8i+7 give the row
// addresses of matrix i; lane l receives row l/4, elements 2(l%4) and
// 2(l%4)+1 of each (of its transpose with .trans).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b, m16n8k16, bf16 operands, f32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b, m16n8k8, tf32 operands, f32 sums
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 2^x, MUFU.EX2 (relative error about 2^-22; results below 2^-126 flush
// to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// --- end of PTX primitives --------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// cvt.rna.tf32.f32 for finite x: round to nearest, ties away from zero,
// to TF32 (low 13 bits zero), as an add and a mask on the bits
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// big = tf32(x), small = tf32(x - big)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// max / sum over the 4 lanes of a quad (the lanes sharing a score row)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// A shared-memory tile of 64 rows by DMAX elements.
template <typename T, int DMAX>
struct Tile {
  static constexpr int kLd = DMAX + 16 / (int)sizeof(T);  // row stride
  static constexpr int kElems = kRows * kLd;
  static constexpr int kBytes = kElems * (int)sizeof(T);
};

// Stage rows [row0, row0 + ROWS), columns [c0, c0 + DMAX) of one (batch,
// head) slice (row stride `st` elements, head dimension contiguous, c0 a
// multiple of DMAX below d) into a tile through cp.async; rows past t
// and elements past d are zero-filled. With `vec` every row starts
// 16-byte aligned and moves in 16-byte copies (the last one of a row cut
// at d). Otherwise float32 moves in 4-byte copies and bfloat16, which no
// cp.async size fits, by plain loads. The block's NT threads share the
// copies.
template <typename T, int DMAX, int NT = kBlock, int ROWS = kRows>
__device__ __forceinline__ void load_tile_async(T* dst,
                                                const T* __restrict__ src,
                                                int64_t st, int row0, int t,
                                                int d, bool vec, int c0 = 0) {
  constexpr int kLd = Tile<T, DMAX>::kLd;
  src += c0;
  d -= c0;
  if (vec) {
    constexpr int kPer = 16 / (int)sizeof(T);  // elements per copy
    constexpr int kCopies = DMAX / kPer;       // copies per row
    static_assert(ROWS * kCopies % NT == 0, "whole copies per thread");
#pragma unroll
    for (int i = 0; i < ROWS * kCopies / NT; ++i) {
      const int c = i * NT + (int)threadIdx.x;
      const int r = c / kCopies, e = (c % kCopies) * kPer;
      const int row = row0 + r;
      const bool ok = row < t && e < d;
      cp_async16(dst + r * kLd + e, ok ? src + (int64_t)row * st + e : src,
                 ok ? (int)sizeof(T) * min(kPer, d - e) : 0);
    }
    return;
  }
#pragma unroll 4
  for (int i = 0; i < ROWS * DMAX / NT; ++i) {
    const int c = i * NT + (int)threadIdx.x;
    const int r = c / DMAX, e = c % DMAX;
    const int row = row0 + r;
    const bool ok = row < t && e < d;
    const T* p = ok ? src + (int64_t)row * st + e : src;
    if constexpr (sizeof(T) == 4) {
      cp_async4(dst + r * kLd + e, p, ok ? 4 : 0);
    } else {
      dst[r * kLd + e] = ok ? *p : __float2bfloat16_rn(0.f);
    }
  }
}

// Stage entries [row0, row0 + 64) of a float32 row vector (lse, delta);
// zeros past t.
__device__ __forceinline__ void load_vec_async(float* dst,
                                               const float* __restrict__ src,
                                               int row0, int t) {
  if (threadIdx.x < kRows) {
    const int row = row0 + (int)threadIdx.x;
    cp_async4(dst + threadIdx.x, row < t ? src + row : src,
              row < t ? 4 : 0);
  }
}

// True when every row of the (batch, head) slices these strides and
// pointers describe starts 16-byte aligned.
inline bool rows_aligned16(const void* const* ptrs, const Strides& st, int n,
                           size_t esize) {
  for (int i = 0; i < n; ++i) {
    if ((uintptr_t)ptrs[i] % 16) return false;
    for (int j = 0; j < 3; ++j)
      if ((st.v[3 * i + j] * (int64_t)esize) % 16) return false;
  }
  return true;
}

// Warp-level products by input type. A is 16 rows x kK, B is kK x 8,
// C is 16 x 8 float32: lane l holds C rows l/4 and l/4 + 8, columns
// 2(l%4) and 2(l%4) + 1, as c[0], c[1] (first row) and c[2], c[3].
template <typename T>
struct Tc;

template <>
struct Tc<__nv_bfloat16> {
  using E = __nv_bfloat16;
  static constexpr int kK = 16;
  struct A {
    uint32_t x[4];
  };
  struct B {
    uint32_t x[2];
  };

  // rows [r0, r0 + 16), columns [k0, k0 + 16) of a row-major tile
  __device__ static __forceinline__ A load_a(const E* tile, int ld, int r0,
                                             int k0, int lane) {
    A a;
    ldmatrix_x4(a.x, tile + (r0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
    return a;
  }

  // B = tile^T for tile rows [n0, n0 + 16) (two n8 fragments), columns
  // [k0, k0 + 16): the tile holds B's columns as its rows
  __device__ static __forceinline__ void load_bt2(B& b0, B& b1, const E* tile,
                                                  int ld, int n0, int k0,
                                                  int lane) {
    uint32_t r[4];
    ldmatrix_x4(r, tile + (n0 + (lane >> 4) * 8 + (lane & 7)) * ld + k0 +
                       ((lane >> 3) & 1) * 8);
    b0.x[0] = r[0], b0.x[1] = r[1], b1.x[0] = r[2], b1.x[1] = r[3];
  }

  // B = tile rows [k0, k0 + 16), columns [n0, n0 + 16) (two n8 fragments)
  __device__ static __forceinline__ void load_b2(B& b0, B& b1, const E* tile,
                                                 int ld, int k0, int n0,
                                                 int lane) {
    uint32_t r[4];
    ldmatrix_x4_trans(r, tile + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld +
                             n0 + (lane >> 4) * 8);
    b0.x[0] = r[0], b0.x[1] = r[1], b1.x[0] = r[2], b1.x[1] = r[3];
  }

  // A = columns [16 kc, 16 kc + 16) of a 16 x 8N accumulator tile
  template <int N>
  __device__ static __forceinline__ A from_acc(const float (&c)[N][4],
                                               int kc) {
    A a;
    a.x[0] = pack_bf16(c[2 * kc][0], c[2 * kc][1]);
    a.x[1] = pack_bf16(c[2 * kc][2], c[2 * kc][3]);
    a.x[2] = pack_bf16(c[2 * kc + 1][0], c[2 * kc + 1][1]);
    a.x[3] = pack_bf16(c[2 * kc + 1][2], c[2 * kc + 1][3]);
    return a;
  }

  __device__ static __forceinline__ void mma(float (&c)[4], const A& a,
                                             const B& b) {
    mma_bf16(c, a.x, b.x);
  }
};

template <>
struct Tc<float> {
  using E = float;
  static constexpr int kK = 8;
  struct A {
    uint32_t big[4], small[4];
  };
  struct B {
    uint32_t big[2], small[2];
  };

  template <int N>
  __device__ static __forceinline__ void split(const uint32_t (&r)[N],
                                               uint32_t (&big)[N],
                                               uint32_t (&small)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) split_tf32(__uint_as_float(r[i]), big[i], small[i]);
  }

  __device__ static __forceinline__ A load_a(const E* tile, int ld, int r0,
                                             int k0, int lane) {
    uint32_t r[4];
    ldmatrix_x4(r, tile + (r0 + (lane & 15)) * ld + k0 + (lane >> 4) * 4);
    A a;
    split(r, a.big, a.small);
    return a;
  }

  __device__ static __forceinline__ void load_bt2(B& b0, B& b1, const E* tile,
                                                  int ld, int n0, int k0,
                                                  int lane) {
    uint32_t r[4];
    ldmatrix_x4(r, tile + (n0 + (lane >> 4) * 8 + (lane & 7)) * ld + k0 +
                       ((lane >> 3) & 1) * 4);
    const uint32_t r0[2] = {r[0], r[1]}, r1[2] = {r[2], r[3]};
    split(r0, b0.big, b0.small);
    split(r1, b1.big, b1.small);
  }

  // the B rows in the order of from_acc's k index: rows k0 + 2(l%4) and
  // k0 + 2(l%4) + 1, column n0 + l/4 (and n0 + 8 + l/4)
  __device__ static __forceinline__ void load_b2(B& b0, B& b1, const E* tile,
                                                 int ld, int k0, int n0,
                                                 int lane) {
    const E* p = tile + (k0 + 2 * (lane & 3)) * ld + n0 + (lane >> 2);
    const uint32_t r0[2] = {__float_as_uint(p[0]), __float_as_uint(p[ld])};
    const uint32_t r1[2] = {__float_as_uint(p[8]), __float_as_uint(p[ld + 8])};
    split(r0, b0.big, b0.small);
    split(r1, b1.big, b1.small);
  }

  // A = columns [8 kc, 8 kc + 8) of a 16 x 8N accumulator tile, k order
  // (0, 2, 4, 6, 1, 3, 5, 7): registers (c0, c2, c1, c3)
  template <int N>
  __device__ static __forceinline__ A from_acc(const float (&c)[N][4],
                                               int kc) {
    const uint32_t r[4] = {__float_as_uint(c[kc][0]), __float_as_uint(c[kc][2]),
                           __float_as_uint(c[kc][1]), __float_as_uint(c[kc][3])};
    A a;
    split(r, a.big, a.small);
    return a;
  }

  // small*big + big*small + big*big, the small terms first
  __device__ static __forceinline__ void mma(float (&c)[4], const A& a,
                                             const B& b) {
    mma_tf32(c, a.small, b.big);
    mma_tf32(c, a.big, b.small);
    mma_tf32(c, a.big, b.big);
  }
};

}  // namespace egf
