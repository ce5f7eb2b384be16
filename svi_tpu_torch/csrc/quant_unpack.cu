// Int4 unpack + per-channel int8 requantization for the W4A8 linear path
// (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel svi_tpu/ops/quant_matmul.py::_unpack_kernel
// (K3, launched by unpack_requant_int4). The port keeps linear weights as
// (out, in), so the packed weight is (N, K/2) int8 and the group ratios are
// (N, K/G) f32; the output is (N, K) int8, the transpose of the JAX kernel's
// (K, N), which is the column-major B operand torch._int_mm takes as w8.t().
// The W4A8 paths fuse it: the forward into w4a8_gemm_sm90.cu, the bf16
// straight-through backward into w4a8_dgrad_sm90.cu; this kernel serves the
// f32 straight-through backward.
//
// Packing (half-split): byte [n, i] holds input i in its low nibble and input
// i + K/2 in its high nibble, both sign-extended int4. Each output is
//   clip(rint(float(w4) * r[n, input / G]), -127, 127)
// with one f32 multiply and round-half-to-even (an FADD of 1.5 * 2^23), bit-
// equal to jnp.round of the same product.
//
// What bounds it on this card: bytes. It reads 0.5 byte of packed weight and
// writes 1 byte of int8 per weight, plus the small (N, K/G) ratio table:
// ~1.5 bytes per weight, ~108 MB for a 5120 x 13824 ffn linear (~32 us at
// 3.35 TB/s). The design keeps the memory system busy and the arithmetic out
// of its way: each thread of a grid sized to the SMs walks 16-byte vectors
// of packed bytes (one 16-byte load, two 16-byte stores: 32 outputs); the
// vector's low and high runs of 16 inputs each lie in one group (G % 16 ==
// 0), so each reads its ratio once, its group index a shift (G a power of
// two) or one division, all in 32-bit arithmetic; a weight costs a few
// integer and f32 instructions (the nibble placed in the mantissa of 2^23
// makes it a float). Shapes outside that (K/2 or G not a multiple of 16, a
// misaligned pointer: only the tiny test configs) take a byte-wise kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// the low byte of the result is rint(clamp(w4 * r, -127, 127)) in two's
// complement (clamping first is the same: +-127 are integers)
__device__ __forceinline__ uint32_t requant_bits(float w4, float r) {
  const float y = fminf(fmaxf(__fmul_rn(w4, r), -127.f), 127.f);
  return __float_as_uint(__fadd_rn(y, 12582912.f));
}

// the nibble u in bits 0-3 of x (the bits above it ignored) -> its int8 in
// the low byte: 2^23 + (u ^ 8), less 2^23 + 8, is the signed nibble
__device__ __forceinline__ uint32_t requant_nibble(uint32_t x, float r) {
  const float w4 = __fsub_rn(__uint_as_float(((x ^ 8u) & 0xFu) | 0x4B000000u), 8388616.f);
  return requant_bits(w4, r);
}

// four nibbles (bits 0-3 of each byte of w after the shift) -> four int8
__device__ __forceinline__ uint32_t requant4(uint32_t w, int shift, float r) {
  const uint32_t x = w >> shift;
  return __byte_perm(__byte_perm(requant_nibble(x, r), requant_nibble(x >> 8, r), 0x0040),
                     __byte_perm(requant_nibble(x >> 16, r), requant_nibble(x >> 24, r), 0x0040),
                     0x5410);
}

__device__ __forceinline__ uint4 requant16(uint4 w, int shift, float r) {
  return make_uint4(requant4(w.x, shift, r), requant4(w.y, shift, r), requant4(w.z, shift, r),
                    requant4(w.w, shift, r));
}

// one 16-byte vector of packed bytes per step: vector v is row v / vpr,
// bytes 16 (v % vpr) .. + 15; group index = input >> gshift, or input /
// group when gshift < 0
__global__ void __launch_bounds__(kThreads)
    unpack_requant16_kernel(const uint4* __restrict__ wp, const float* __restrict__ r,
                            uint4* __restrict__ out, uint32_t n_vecs, uint32_t vpr,
                            uint32_t n_groups, int gshift, uint32_t group) {
  for (uint32_t v = blockIdx.x * kThreads + threadIdx.x; v < n_vecs;
       v += gridDim.x * kThreads) {
    const uint32_t row = v / vpr, c = v - row * vpr;
    const uint32_t lo = 16 * c, hi = lo + 16 * vpr;  // the first low and high input
    const uint4 w = __ldg(wp + v);
    const float* rrow = r + (size_t)row * n_groups;
    const float r_lo = __ldg(rrow + (gshift >= 0 ? lo >> gshift : lo / group));
    const float r_hi = __ldg(rrow + (gshift >= 0 ? hi >> gshift : hi / group));
    uint4* orow = out + (size_t)row * 2 * vpr;
    orow[c] = requant16(w, 0, r_lo);
    orow[vpr + c] = requant16(w, 4, r_hi);
  }
}

// any shape: one packed byte per step
__global__ void __launch_bounds__(kThreads)
    unpack_requant1_kernel(const uint8_t* __restrict__ wp, const float* __restrict__ r,
                           uint8_t* __restrict__ out, long long n_bytes, long long kh,
                           long long n_groups, long long group) {
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n_bytes;
       i += (long long)gridDim.x * kThreads) {
    const long long row = i / kh, col = i - row * kh;
    const float* rrow = r + row * n_groups;
    const uint32_t w = wp[i];
    uint8_t* orow = out + row * 2 * kh;
    orow[col] = (uint8_t)requant_nibble(w, rrow[col / group]);
    orow[kh + col] = (uint8_t)requant_nibble(w >> 4, rrow[(kh + col) / group]);
  }
}

int grid_for(long long items) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  const long long blocks = (items + kThreads - 1) / kThreads;
  const long long resident = 8LL * sms;  // 2048 threads an SM
  return (int)(blocks < resident ? blocks : resident);
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
  const bool vec = kh % 16 == 0 && group % 16 == 0 && n_rows * kh / 16 < 0x7FFFFFFFll &&
                   reinterpret_cast<uintptr_t>(wp) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    const long long n_vecs = n_rows * kh / 16;
    const int gshift = (group & (group - 1)) == 0 ? __builtin_ctz((unsigned)group) : -1;
    unpack_requant16_kernel<<<grid_for(n_vecs), kThreads, 0, st>>>(
        static_cast<const uint4*>(wp), r, static_cast<uint4*>(out), (uint32_t)n_vecs,
        (uint32_t)(kh / 16), (uint32_t)n_groups, gshift, (uint32_t)group);
  } else {
    unpack_requant1_kernel<<<grid_for(n_rows * kh), kThreads, 0, st>>>(
        static_cast<const uint8_t*>(wp), r, static_cast<uint8_t*>(out), n_rows * kh, kh,
        n_groups, group);
  }
  return (int)cudaGetLastError();
}
