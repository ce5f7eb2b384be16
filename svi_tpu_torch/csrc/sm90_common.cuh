// Hopper building blocks shared by the TMA + wgmma kernels
// (flash_fwd_sm90.cu, flash_bwd_sm90.cu, flash_bwd_split_sm90.cu), in inline
// PTX: mbarriers, 4-D TMA loads, stores and reduce-adds, wgmma shared-memory
// descriptors of 128-byte-swizzled tiles, wgmma fences and products, the
// backward's gradient finalize, and the host-side tensor-map encode found at
// run time through cudaGetDriverEntryPoint (no -lcuda).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// returns once the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 4-D map into shared memory, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// one box from shared memory into a 4-D map (rows out of bounds are skipped)
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// the same, adding the box to what the map's memory holds (f32 maps)
__device__ __forceinline__ void tma_reduce_add(const CUtensorMap* map, uint32_t src, int c0,
                                               int c1, int c2, int c3) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.4d.global.shared::cta.add.tile.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// contiguous bytes (a multiple of 16, both ends 16-byte aligned) into shared
// memory, completing on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle. lbo / sbo in bytes.
// K-major operands: sbo = 1024 between 8-row groups, lbo unused.
// MN-major operands: lbo = the stride between 64-element boxes along M or N,
// sbo = 1024 between groups of 8 rows along K.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 128 f32) += A (64 x 16 bf16, registers) * B (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
      "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64 f32) (+)= A (64 x 16, smem) * B (16 x 64, smem); TA / TB set the
// transpose bit of an MN-major A / B
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// s (64 x 64) = A B^T over a depth of 128: A and B are 64-row K-major tiles
// of 128 columns, each two 64-column boxes apart by a_box / b_box bytes
__device__ __forceinline__ void issue_scores(float (&s)[32], uint32_t a_rows, uint32_t a_box,
                                             uint32_t b_rows, uint32_t b_box) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_ss64<0, 0>(s, gmma_desc(a_rows + (kk / 4) * a_box + (kk % 4) * 32, 16, 1024),
                     gmma_desc(b_rows + (kk / 4) * b_box + (kk % 4) * 32, 16, 1024), kk > 0);
}

// acc (64 x 128) += A (64 x 64, registers, 16-deep slice kk in a[4kk .. 4kk +
// 3]) * B (64 x 128, an MN-major tile whose two 64-column boxes are b_box
// bytes apart)
__device__ __forceinline__ void issue_rs(float (&acc)[64], const uint32_t (&a)[16],
                                         uint32_t b_tile, uint32_t b_box) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t ak[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3]};
    wgmma_rs(acc, ak, gmma_desc(b_tile + kk * 16 * 128, b_box, 1024));
  }
}

// pins accumulator registers: nothing that reads them moves above this point
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// m64n64 accumulators rounded to bf16: those of column groups 2kk and 2kk + 1
// are the A fragment of the kk-th 16-deep step of a product that reduces
// over those 64 columns
__device__ __forceinline__ void pack_a(uint32_t (&a)[16], const float (&x)[32]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i] = pack_bf16(x[2 * i], x[2 * i + 1]);
}

// the pair (x0, x1) of an interleaved-pair RoPE rotated back by -theta
__device__ __forceinline__ void rotate_back(float& x0, float& x1, float c, float s) {
  const float y0 = x0 * c + x1 * s;
  x1 = x1 * c - x0 * s;
  x0 = y0;
}

// byte offset of 16-byte chunk `chunk` of row `row` in a 128-byte-swizzled
// box (128-byte rows, 1024-byte aligned)
__device__ __forceinline__ uint32_t swizzle128(int row, int chunk) {
  return row * 128u + (((chunk ^ row) & 7) << 4);
}

// out = bf16(rotate_back(scale * x32)), elementwise over the pairs of an f32
// (B, S, N, D) buffer; cos / sin: (>= S, D/2) f32, or null for no rotation
template <int D>
__global__ void finalize_grad_kernel(const float* x32, __nv_bfloat16* out, const float* cos,
                                     const float* sin, long long n_pairs, long long seq,
                                     int n_heads, float scale) {
  const long long pairs_per_row = (long long)n_heads * (D / 2);
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < n_pairs;
       idx += (long long)gridDim.x * blockDim.x) {
    const float2 x = reinterpret_cast<const float2*>(x32)[idx];
    float x0 = x.x * scale, x1 = x.y * scale;
    if (cos != nullptr) {
      const long long i = ((idx / pairs_per_row) % seq) * (D / 2) + (idx % (D / 2));
      rotate_back(x0, x1, cos[i], sin[i]);
    }
    reinterpret_cast<uint32_t*>(out)[idx] = pack_bf16(x0, x1);
  }
}

template <int D>
inline cudaError_t finalize_grad(const float* x32, void* out, const float* cos, const float* sin,
                                 long long batch, long long seq, long long n_heads, float scale,
                                 cudaStream_t stream) {
  const long long n_pairs = batch * seq * n_heads * (D / 2);
  const long long blocks = (n_pairs + 255) / 256;
  finalize_grad_kernel<D><<<(unsigned)(blocks < 65535 ? blocks : 65535), 256, 0, stream>>>(
      x32, reinterpret_cast<__nv_bfloat16*>(out), cos, sin, n_pairs, seq, (int)n_heads, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// host side: tensor maps through cuTensorMapEncodeTiled, found at run time
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// 4-D map (D, N, S, B) of a view with element strides st = {b, s, n} and
// elements of `elem` bytes; boxes of `cols` columns (128 bytes) x `rows` rows
// of one head, 128-byte swizzle, rows past S read as zeros and never written
inline CUresult encode_map(EncodeTiledFn fn, CUtensorMap* map, CUtensorMapDataType type,
                           uint32_t elem, const void* ptr, long long d, long long n, long long s,
                           long long batch, const long long* st, uint32_t cols, uint32_t rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)n, (cuuint64_t)(s > 0 ? s : 1),
                              (cuuint64_t)batch};
  // a dim of extent 1 is never stepped: give it a stride TMA accepts
  const long long raw[3] = {st[2], st[1], st[0]};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i)
    strides[i] = dims[i + 1] == 1 ? (cuuint64_t)(d * elem) : (cuuint64_t)(raw[i] * elem);
  const cuuint32_t box[4] = {cols, 1, rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, type, 4, const_cast<void*>(ptr), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

constexpr int kNoEncodeEntry = 10000;  // cuTensorMapEncodeTiled not found
constexpr int kEncodeFailed = 20000;   // + the CUresult of a failed encode

}  // namespace sm90
