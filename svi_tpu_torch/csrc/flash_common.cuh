// Device helpers shared by the mma.sync flash-attention kernels: the f32
// forward (flash_fwd_f32.cu), the int8 forward at D = 64 (flash_fwd_q8.cu)
// and the split backward at D = 64 (flash_bwd.cu): warp reductions, bf16
// packing, the mma.sync m16n8k16 bf16 product, the 3xTF32 m16n8k8 product
// (also in flash_fwd_q8_sm90.cu's f32 P.V), and the tile loader that applies
// interleaved-pair RoPE as it fills shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace svi {

constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, s, n;  // element strides of a (B, S, N, D) view; D is contiguous
};

__device__ __forceinline__ float warp_max_xor(float x, int width) {
  for (int off = 1; off < width; off <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum_xor(float x, int width) {
  for (int off = 1; off < width; off <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16x16 row-major bf16) * b (16x8 col-major bf16), f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// f32 bits rounded to TF32 as cvt.rna.tf32.f32 rounds (to nearest, ties away
// from zero: half of the 13 dropped bits added to the magnitude, then
// cleared), in two integer operations instead of a conversion
__device__ __forceinline__ uint32_t tf32_rna(uint32_t bits) {
  return (bits + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo, each rounded to TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(__float_as_uint(x));
  lo = tf32_rna(__float_as_uint(x - __uint_as_float(hi)));
}

// d += a (16x8 row-major tf32) * b (8x8 col-major tf32), f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b in 3xTF32: the small cross terms first, then hi * hi
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

__device__ __forceinline__ void split4(const float (&x)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(x[i], hi[i], lo[i]);
}

// A fragment (16 rows x 16 columns, row-major) of a bf16 tile in shared
// memory with row stride ld, starting at row r0 and column c0.
__device__ __forceinline__ void load_a_frag(uint32_t (&a)[4], const __nv_bfloat16* tile, int ld,
                                            int r0, int c0) {
  const int lane = threadIdx.x % 32;
  const __nv_bfloat16* p = tile + (r0 + lane / 4) * ld + c0 + 2 * (lane % 4);
  a[0] = ld_u32(p);
  a[1] = ld_u32(p + 8 * ld);
  a[2] = ld_u32(p + 8);
  a[3] = ld_u32(p + 8 * ld + 8);
}

// Copy rows [row0, row0 + ROWS) of one head into shared memory (row stride
// D + 8), zero-filling rows at or beyond nrows; optionally rotate pairs
// (2i, 2i+1) by the angle of their row from (S, D/2) cos/sin tables, in f32
// with round-to-nearest products, rounded back to bf16.
template <int D, int ROWS, bool ROPE, int THREADS>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               long long row_stride, long long row0,
                                               long long nrows, const float* cos,
                                               const float* sin) {
  constexpr int LD = D + 8;
  constexpr int kVec = 8;  // 8 bf16 = 16 bytes
  constexpr int kPerRow = D / kVec;
  for (int idx = threadIdx.x; idx < ROWS * kPerRow; idx += THREADS) {
    const int r = idx / kPerRow;
    const int cv = idx % kPerRow;
    const long long gr = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < nrows) {
      val = *reinterpret_cast<const uint4*>(src + gr * row_stride + cv * kVec);
      if (ROPE) {
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
        const float* cp = cos + gr * (D / 2) + cv * (kVec / 2);
        const float* sp = sin + gr * (D / 2) + cv * (kVec / 2);
#pragma unroll
        for (int i = 0; i < kVec / 2; ++i) {
          const float x0 = __bfloat162float(e[2 * i]);
          const float x1 = __bfloat162float(e[2 * i + 1]);
          const float c = cp[i], s = sp[i];
          e[2 * i] = __float2bfloat16_rn(__fsub_rn(__fmul_rn(x0, c), __fmul_rn(x1, s)));
          e[2 * i + 1] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(x0, s), __fmul_rn(x1, c)));
        }
      }
    }
    *reinterpret_cast<uint4*>(dst + r * LD + cv * kVec) = val;
  }
}

}  // namespace svi
