// Int4 unpack + per-channel int8 requantization for the W4A8 linear path
// (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel svi_tpu/ops/quant_matmul.py::_unpack_kernel
// (K3, launched by unpack_requant_int4). The port keeps linear weights as
// (out, in), so the packed weight is (N, K/2) int8 and the group ratios are
// (N, K/G) f32; the output is (N, K) int8, the transpose of the JAX kernel's
// (K, N), which is the column-major B operand torch._int_mm takes as w8.t().
//
// Packing (half-split): byte [n, i] holds input i in its low nibble and input
// i + K/2 in its high nibble, both sign-extended int4. Each output is
//   clip(rint(float(w4) * r[n, input / G]), -127, 127)
// with one f32 multiply and round-half-to-even (__float2int_rn), bit-equal to
// jnp.round of the same product.
//
// What bounds it on this card: bytes. It reads 0.5 byte of packed weight and
// writes 1 byte of int8 per weight, plus the small (N, K/G) ratio table:
// ~1.5 bytes per weight, ~108 MB for a 5120 x 13824 ffn linear (~32 us at
// 3.35 TB/s). The design is the plain one: each thread reads 4 packed bytes
// of one row as one 32-bit word and writes two 32-bit words, one to each
// half of the output row; rows are walked by the grid's y dimension. When K/2
// is not a multiple of 4 a one-byte-per-thread instantiation runs instead.
// Fusing the unpack into an int8 GEMM's operand load is left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int8_t requant(int w4, float r) {
  int v = __float2int_rn(static_cast<float>(w4) * r);
  v = v < -127 ? -127 : (v > 127 ? 127 : v);
  return static_cast<int8_t>(v);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
unpack_requant_kernel(const int8_t* __restrict__ wp, const float* __restrict__ r,
                      int8_t* __restrict__ out, long long n_rows, long long kh,
                      long long n_groups, int group) {
  const long long vec = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (vec * V >= kh) return;
  const long long i0 = vec * V;
  for (long long row = blockIdx.y; row < n_rows; row += gridDim.y) {
    const int8_t* src = wp + row * kh + i0;
    const float* rrow = r + row * n_groups;
    int8_t* dst = out + row * 2 * kh + i0;
    if (V == 4) {
      const uint32_t word = *reinterpret_cast<const uint32_t*>(src);
      uint32_t lo = 0u, hi = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int x = static_cast<int8_t>((word >> (8 * j)) & 0xFFu);
        const int w_lo = ((x & 0xF) ^ 8) - 8;  // sign-extended low nibble
        const int w_hi = x >> 4;                // arithmetic shift of the signed byte
        lo |= (uint32_t)(uint8_t)requant(w_lo, rrow[(i0 + j) / group]) << (8 * j);
        hi |= (uint32_t)(uint8_t)requant(w_hi, rrow[(i0 + j + kh) / group]) << (8 * j);
      }
      *reinterpret_cast<uint32_t*>(dst) = lo;
      *reinterpret_cast<uint32_t*>(dst + kh) = hi;
    } else {
      const int x = src[0];
      dst[0] = requant(((x & 0xF) ^ 8) - 8, rrow[i0 / group]);
      dst[kh] = requant(x >> 4, rrow[(i0 + kh) / group]);
    }
  }
}

template <int V>
cudaError_t launch(const int8_t* wp, const float* r, int8_t* out, long long n_rows,
                   long long kh, long long n_groups, int group, cudaStream_t st) {
  const long long vecs = kh / V;
  const dim3 grid((unsigned)((vecs + kThreads - 1) / kThreads),
                  (unsigned)(n_rows < 65535 ? n_rows : 65535));
  unpack_requant_kernel<V><<<grid, kThreads, 0, st>>>(wp, r, out, n_rows, kh, n_groups, group);
  return cudaGetLastError();
}

}  // namespace

// wp: (n_rows, kh) int8, contiguous; r: (n_rows, 2 * kh / group) f32,
// contiguous; out: (n_rows, 2 * kh) int8, contiguous. Returns a cudaError_t
// value; 0 means the kernel was launched.
extern "C" int svi_unpack_requant_int4(const void* wp, const float* r, void* out,
                                       long long n_rows, long long kh, int group,
                                       void* stream) {
  if (n_rows == 0 || kh == 0) return (int)cudaSuccess;
  if (group <= 0 || (2 * kh) % group != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const long long n_groups = 2 * kh / group;
  const int8_t* w = static_cast<const int8_t*>(wp);
  int8_t* o = static_cast<int8_t*>(out);
  const bool aligned = kh % 4 == 0 && reinterpret_cast<uintptr_t>(wp) % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 4 == 0;
  return (int)(aligned ? launch<4>(w, r, o, n_rows, kh, n_groups, group, st)
                       : launch<1>(w, r, o, n_rows, kh, n_groups, group, st));
}
