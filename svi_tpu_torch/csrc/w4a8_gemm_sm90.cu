// The W4A8 linear for Hopper (sm_90a): per-token int8 activations times an
// int4 weight unpacked and requantized to int8 inside the GEMM, with the
// scales and the bias in the epilogue. Plain C interface, two kernels:
//
//   1. w4a8_quantize_rows_kernel (the activation pre-pass): per row of x
//      (M, K) bf16 or f32, xs = amax|x| / 127 + 1e-12 (an IEEE division)
//      and x8 = clamp(rint(x / xs), -127, 127), bit-equal to the torch
//      `_quantize_rows_reference` (models.wan_dit's `_int8_exec` prologue);
//   2. w4a8_gemm_kernel: y = x8 . W8^T with W8 = clip(rint(w4 * r[n, k / G]),
//      -127, 127) made in shared memory from the packed int4 weight (K3's
//      arithmetic, one f32 product per weight), then
//      y = out((float(acc) * xs[m]) * s8[n]) and, with a bias,
//      y = out(float(y) + float(b[n])): `_int8_exec` then `_plus_bias`, bit
//      for bit (int32 to f32 by cvt.rn, as .float() does).
//
// Replaces, in the JAX package: the Pallas kernel
// svi_tpu/ops/quant_matmul.py::_unpack_kernel (K3, launched by
// unpack_requant_int4, pallas_call at :73) on the inference path, and the
// product, activation quantization and scaling it feeds, which XLA computes
// outside any kernel (svi_tpu/models/wan_dit.py:210 `_int8_exec`, the W4A8
// branch of `_dense` with its bias). The standalone K3 (quant_unpack.cu)
// stays for the straight-through backward.
//
// Packing (half-split, the quantizer's): byte i of weight row n holds input
// i in its low nibble and input i + K/2 in its high nibble. One packed tile
// of 64 bytes along K/2 at 64t therefore gives two int8 K-tiles, inputs
// [64t, 64t + 64) and [K/2 + 64t, ...): the producer loads it once with the
// two x8 tiles it pairs with.
//
// What bounds it on this card: at the DiT's linears (M = 9360 tokens) the
// int8 tensor cores, 2 M N K / 1979 TOP/s (0.67 ms at ffn.0, M9360 N13824
// K5120); the bytes (x once, the packed weight once, y once) are a few
// percent of that. The cost this design adds is the weight transform: each
// CTA makes its 128 rows of W8 once per 256 rows of x, ~2 integer
// instructions a weight through a 16-entry table per (row, group) (G = 128:
// byte permutes of the nibbles into the table, a sign-replicating permute
// to pick its half), run by the consumer warpgroups while their previous
// products run on the tensor cores. The int8 weight never reaches device
// memory, and neither does the int32 product or an f32 copy of it. On the
// card the tile loads hold it above that bound: every CTA reads 40 KB of x8
// and packed weight from L2 a k-step, and the loads alone take most of its
// time; the transform adds the rest. (A cluster sharing x8 by TMA multicast,
// and the transform moved to the producer warpgroup, were slower: PERF.md.)
//
// Structure: one CTA per 256 rows x 128 output channels; a producer warp
// TMA-loads x8 (two 256 x 64 tiles) and the packed weight (128 x 64 bytes)
// into a 4-stage mbarrier ring, 64-byte swizzle; two consumer warpgroups
// (setmaxnreg 240) each own 128 rows (two m64 halves, 128 int32 accumulators
// a thread), transform the packed tile into a double-buffered swizzled W8
// tile (generic-proxy stores, then fence.proxy.async and a barrier of the
// 256 consumer threads before wgmma reads it), and run wgmma m64n128k32 s8
// with both operands K-major from shared memory. The epilogue writes y from
// registers; rows past M and columns past N are skipped, and TMA zero-fills
// what lies past the tensors' edges (zero weights past K/2, zero rows past
// M), so every M >= 1 works without padding.

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int kBM = 256;       // rows of x per CTA: two consumer warpgroups of 128
constexpr int kBN = 128;       // output channels per CTA
constexpr int kGroupM = 8;  // row tiles a raster group walks
constexpr int kPK = 64;        // packed bytes per k-step (128 inputs)
constexpr int kStages = 4;
constexpr int kThreads = 384;  // warpgroups 0 and 1 consume, warpgroup 2 produces
constexpr int kConsumerWarps = 8;  // each releases a stage with one arrival
constexpr uint32_t kXTile = kBM * kPK;   // 16 KB: 256 rows x 64 int8
constexpr uint32_t kWTile = kBN * kPK;   // 8 KB: 128 rows x 64 bytes
constexpr uint32_t kStageBytes = 2 * kXTile + kWTile;  // x8 low, x8 high, packed weight
constexpr uint32_t kW8Bytes = 2 * kWTile;              // W8's low and high tiles
constexpr size_t kSmemBytes = kStages * kStageBytes + 2 * kW8Bytes + 8 * 2 * kStages + 1024;

struct Params {
  const float* xs;    // (M,) f32
  const float* r;     // (N, K/G) f32, contiguous
  const float* s8;    // (N,) f32
  const void* bias;   // (N,) in out's type, or null
  void* y;            // (M, N) contiguous, out's type
  long long m, n;
  int kh;             // K/2
  int x_hi;           // the column of x8 where input K/2 sits
  int n_groups;       // K/G
  int group;
  int k_steps;        // ceil(K/2 / kPK)
};

__device__ __forceinline__ uint32_t x_lo(uint32_t base, int st) { return base + kStageBytes * st; }
__device__ __forceinline__ uint32_t x_hi(uint32_t base, int st) { return x_lo(base, st) + kXTile; }
__device__ __forceinline__ uint32_t w_pk(uint32_t base, int st) {
  return x_lo(base, st) + 2 * kXTile;
}
__device__ __forceinline__ uint32_t w8_lo(uint32_t base, int buf) {
  return base + kStageBytes * kStages + kW8Bytes * buf;
}
__device__ __forceinline__ uint32_t w8_hi(uint32_t base, int buf) {
  return w8_lo(base, buf) + kWTile;
}
__device__ __forceinline__ uint32_t bar_full(uint32_t base, int st) {
  return base + kStageBytes * kStages + 2 * kW8Bytes + 8 * st;
}
__device__ __forceinline__ uint32_t bar_empty(uint32_t base, int st) {
  return bar_full(base, kStages + st);
}

// byte offset of 16-byte chunk `chunk` of row `row` in a 64-byte-swizzled
// tile (64-byte rows, 512-byte aligned)
__device__ __forceinline__ uint32_t swizzle64(int row, int chunk) {
  return row * 64u + (((chunk ^ (row >> 1)) & 3) << 4);
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}
__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// K3's requantization of one int4 value: rint(clamp(w4 * r)), as the bits
// whose low byte is the int8 (clamping first is the same: +-127 are integers)
__device__ __forceinline__ uint32_t requant_bits(float w4, float r) {
  return rint_bits(fminf(fmaxf(__fmul_rn(w4, r), -127.f), 127.f));
}

// the 16 requantized values of one (row, group), indexed by the nibble u
// (w4 = u for u < 8, u - 16 above): t[0] = u 0-3, t[1] = 4-7, t[2] = 8-11,
// t[3] = 12-15, byte j of t[i] the value of u = 4i + j
struct Lut {
  uint32_t t[4];
};

__device__ __forceinline__ Lut make_lut(float r) {
  Lut lut;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int u0 = 4 * i;
    const float w0 = (float)(u0 < 8 ? u0 : u0 - 16);
    lut.t[i] = pack_low_bytes(requant_bits(w0, r), requant_bits(w0 + 1.f, r),
                              requant_bits(w0 + 2.f, r), requant_bits(w0 + 3.f, r));
  }
  return lut;
}

// four nibbles (bits 0-3 of each byte of x, the upper bits zero) -> their
// four int8 values from the table: the low three bits of each nibble pick a
// byte of the u < 8 half and of the u >= 8 half (one byte permute each), the
// fourth bit picks between them through a sign-replicating permute
__device__ __forceinline__ uint32_t lut4(uint32_t x, const Lut& lut) {
  const uint32_t a = x & 0x07070707u;
  const uint32_t sel = prmt(a | (a >> 4), 0u, 0x0020u);  // nibbles a0 a1 a2 a3
  const uint32_t lo = prmt(lut.t[0], lut.t[1], sel);
  const uint32_t hi = prmt(lut.t[2], lut.t[3], sel);
  const uint32_t upper = prmt(x << 4, 0u, 0xBA98u);  // 0xFF in each byte whose u >= 8
  return (lo & ~upper) | (hi & upper);
}

// the generic transform: four packed bytes -> four low and four high int8
// values, each by K3's arithmetic (any group size that is a multiple of 4)
__device__ __forceinline__ void requant_word(uint32_t w, float r_lo, float r_hi, uint32_t& lo,
                                             uint32_t& hi) {
  uint32_t l[4], h[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int byte = (int)(int8_t)((w >> (8 * j)) & 0xFFu);
    l[j] = requant_bits((float)(((byte & 0xF) ^ 8) - 8), r_lo);
    h[j] = requant_bits((float)(byte >> 4), r_hi);
  }
  lo = pack_low_bytes(l[0], l[1], l[2], l[3]);
  hi = pack_low_bytes(h[0], h[1], h[2], h[3]);
}

template <typename OutT>
__device__ __forceinline__ float round_out(float x);
template <>
__device__ __forceinline__ float round_out<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
template <>
__device__ __forceinline__ float round_out<float>(float x) {
  return x;
}

__device__ __forceinline__ float load_out(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float load_out(const float* p) { return *p; }

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

template <bool LUT, typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
    w4a8_gemm_kernel(const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap tw, const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) & ~1023u;
  // grouped order: runs of kGroupM row tiles walk the column tiles together,
  // so a wave of CTAs reads a compact block of x8 rows and weight rows (L2)
  const int n_tiles = (int)((p.n + kBN - 1) / kBN), m_tiles = (int)((p.m + kBM - 1) / kBM);
  const int id = blockIdx.x, per_group = kGroupM * n_tiles;
  const int first_m = (id / per_group) * kGroupM;
  const int group_rows = min(m_tiles - first_m, kGroupM);
  const int n0 = ((id % per_group) / group_rows) * kBN;
  const long long m0 = (long long)(first_m + (id % per_group) % group_rows) * kBM;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full(base, st), 1);
      mbar_init(bar_empty(base, st), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      for (int t = 0; t < p.k_steps; ++t) {
        const int st = t % kStages;
        if (t >= kStages) mbar_wait(bar_empty(base, st), ((t / kStages) - 1) & 1);
        const uint32_t full = bar_full(base, st);
        mbar_expect_tx(full, kStageBytes);
        tma_load_2d(x_lo(base, st), &tx, full, t * kPK, (int)m0);
        tma_load_2d(x_hi(base, st), &tx, full, p.x_hi + t * kPK, (int)m0);
        tma_load_2d(w_pk(base, st), &tw, full, t * kPK, n0);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int ct = threadIdx.x;  // 0 .. 255
  const int tid = ct % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  // the transform: thread ct makes chunks 2 (ct % 2) and 2 (ct % 2) + 1 of
  // weight row ct / 2 of each tile
  const int wr = ct / 2, wc = 2 * (ct % 2);
  const long long wn = n0 + wr;
  const float* rrow = p.r + (wn < p.n ? wn : 0) * (long long)p.n_groups;
  const bool row_ok = wn < p.n;

  int acc[2][64];
  Lut lut_lo, lut_hi;
  int lut_group = -1;

  for (int t = 0; t < p.k_steps; ++t) {
    const int st = t % kStages, buf = t % 2;
    mbar_wait(bar_full(base, st), (t / kStages) & 1);

    // packed tile -> the int8 low and high tiles of W8 (64-byte swizzle)
    const int p0 = t * kPK;
    if constexpr (LUT) {
      // G = 128 and K/2 % 128 == 0: one group per half-tile row, the same
      // for two k-steps
      const int grp = p0 / 128;
      if (grp != lut_group) {
        // the two threads of a weight row build one table each and swap
        lut_group = grp;
        const bool hi_half = ct % 2;
        const Lut mine = make_lut(row_ok ? rrow[hi_half ? p.kh / 128 + grp : grp] : 0.f);
        Lut other;
#pragma unroll
        for (int i = 0; i < 4; ++i) other.t[i] = __shfl_xor_sync(0xffffffffu, mine.t[i], 1);
        lut_lo = hi_half ? other : mine;
        lut_hi = hi_half ? mine : other;
      }
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const uint32_t off = swizzle64(wr, wc + q);
      const uint4 w = lds128(w_pk(base, st) + off);
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
      uint32_t lo[4], hi[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (LUT) {
          lo[i] = lut4(words[i] & 0x0F0F0F0Fu, lut_lo);
          hi[i] = lut4((words[i] >> 4) & 0x0F0F0F0Fu, lut_hi);
        } else {
          const int k_lo = p0 + 16 * (wc + q) + 4 * i;  // this word's first low input
          const bool in = row_ok && k_lo < p.kh;       // past K/2 TMA gave zero bytes
          const float r_lo = in ? rrow[k_lo / p.group] : 0.f;
          const float r_hi = in ? rrow[(p.kh + k_lo) / p.group] : 0.f;
          requant_word(words[i], r_lo, r_hi, lo[i], hi[i]);
        }
      }
      sts128(w8_lo(base, buf) + off, make_uint4(lo[0], lo[1], lo[2], lo[3]));
      sts128(w8_hi(base, buf) + off, make_uint4(hi[0], hi[1], hi[2], hi[3]));
    }

    if (t > 0) {
      // this warpgroup's products of step t - 1 are done: its x8 stage is free
      wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(acc[h][i])::"memory");
      if (lane == 0) mbar_arrive(bar_empty(base, (t - 1) % kStages));
    }
    // the W8 stores are seen by wgmma (async proxy), and every consumer has
    // finished both its stores and its products of step t - 1, which read
    // the other W8 buffer
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, 256;\n" ::: "memory");

    wgmma_fence();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t rows = (wg * 128 + h * 64) * kPK;
#pragma unroll
      for (int kk = 0; kk < kPK / 32; ++kk)
        wgmma_s8_ss(acc[h], gmma_desc_sw64(x_lo(base, st) + rows + kk * 32, 512),
                    gmma_desc_sw64(w8_lo(base, buf) + kk * 32, 512), t > 0 || kk > 0);
#pragma unroll
      for (int kk = 0; kk < kPK / 32; ++kk)
        wgmma_s8_ss(acc[h], gmma_desc_sw64(x_hi(base, st) + rows + kk * 32, 512),
                    gmma_desc_sw64(w8_hi(base, buf) + kk * 32, 512), 1);
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(acc[h][i])::"memory");

  // epilogue: y = out((float(acc) * xs[m]) * s8[n]) (+ bias), from registers
  OutT* y = static_cast<OutT*>(p.y);
  const OutT* bias = static_cast<const OutT*>(p.bias);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long row = m0 + wg * 128 + h * 64 + warp * 16 + g + 8 * half;
      if (row >= p.m) continue;
      const float xs = p.xs[row];
      OutT* yrow = y + row * p.n;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const long long col = n0 + 8 * j + 2 * t4;
        if (col >= p.n) continue;
        const float2 s8 = *reinterpret_cast<const float2*>(p.s8 + col);
        float v0 = round_out<OutT>(
            __fmul_rn(__fmul_rn(__int2float_rn(acc[h][4 * j + 2 * half]), xs), s8.x));
        float v1 = round_out<OutT>(
            __fmul_rn(__fmul_rn(__int2float_rn(acc[h][4 * j + 2 * half + 1]), xs), s8.y));
        if (bias != nullptr) {
          v0 = __fadd_rn(v0, load_out(bias + col));
          v1 = __fadd_rn(v1, load_out(bias + col + 1));
        }
        store_pair(yrow + col, v0, v1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the activation pre-pass: one CTA per row. Bound by bytes (x read from
// device memory once; the second pass finds the row in L1).
// ---------------------------------------------------------------------------

constexpr int kQThreads = 256;

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(e[i]);
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

template <typename InT>
__global__ void __launch_bounds__(kQThreads)
    w4a8_quantize_rows_kernel(const InT* __restrict__ x, int8_t* __restrict__ x8,
                              float* __restrict__ xs, int k) {
  __shared__ float warp_max[kQThreads / 32];
  const long long row = blockIdx.x;
  const InT* xr = x + row * k;
  float amax = 0.f;
  for (int i = threadIdx.x * 8; i < k; i += kQThreads * 8) {
    float v[8];
    load8(xr + i, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[e]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = amax;
  __syncthreads();
  amax = warp_max[0];
#pragma unroll
  for (int w = 1; w < kQThreads / 32; ++w) amax = fmaxf(amax, warp_max[w]);
  const float s = __fadd_rn(__fdiv_rn(amax, 127.f), 1e-12f);
  if (threadIdx.x == 0) xs[row] = s;
  int8_t* qr = x8 + row * k;
  for (int i = threadIdx.x * 8; i < k; i += kQThreads * 8) {
    float v[8];
    load8(xr + i, v);
    uint32_t b[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) b[e] = rint_bits(fminf(fmaxf(__fdiv_rn(v[e], s), -127.f), 127.f));
    *reinterpret_cast<uint2*>(qr + i) =
        make_uint2(pack_low_bytes(b[0], b[1], b[2], b[3]), pack_low_bytes(b[4], b[5], b[6], b[7]));
  }
}

CUresult encode_2d(EncodeTiledFn fn, CUtensorMap* map, const void* ptr, long long cols,
                   long long rows, long long row_bytes, uint32_t box_cols, uint32_t box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <bool LUT, typename OutT>
int launch(const CUtensorMap& tx, const CUtensorMap& tw, const Params& p, dim3 grid,
           cudaStream_t st) {
  auto kern = w4a8_gemm_kernel<LUT, OutT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, kThreads, kSmemBytes, st>>>(tx, tw, p);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (m, k) contiguous, bf16 (in_f32 = 0) or f32; x8: (m, k) int8; xs: (m,)
// f32. k % 8 == 0, x 16-byte aligned. Returns a cudaError_t value; 0 means
// the kernel was launched.
extern "C" int svi_w4a8_quantize_rows(int in_f32, const void* x, void* x8, float* xs,
                                      long long m, long long k, void* stream) {
  if (m == 0) return (int)cudaSuccess;
  if (k <= 0 || k % 8 || m > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (in_f32)
    w4a8_quantize_rows_kernel<float><<<(unsigned)m, kQThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(x8), xs, (int)k);
  else
    w4a8_quantize_rows_kernel<__nv_bfloat16><<<(unsigned)m, kQThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(x8), xs, (int)k);
  return (int)cudaGetLastError();
}

// x8: (m, x_cols) int8 contiguous, inputs [0, k/2) at columns [0, k/2) and
// inputs [k/2, k) at [x_hi, x_hi + k/2) (x_hi = k/2 and x_cols = k unless
// k/2 % 16 != 0: TMA boxes start on 16-byte columns); xs: (m,) f32; wp: (n,
// k/2) int8 packed weight with rows w_stride bytes apart (a multiple of 16);
// r: (n, k/group) f32 contiguous, group % 4 == 0; s8: (n,) f32; bias: (n,)
// in out's type or null; y: (m, n) contiguous, bf16 (out_f32 = 0) or f32,
// n % 8 == 0. Returns 0 when the kernel was launched, a cudaError_t value,
// kNoEncodeEntry, or kEncodeFailed + the CUresult of a failed encode.
extern "C" int svi_w4a8_gemm(int out_f32, const void* x8, long long x_cols, long long x_hi,
                             const float* xs, const void* wp, long long w_stride, const float* r,
                             const float* s8, const void* bias, void* y, long long m, long long n,
                             long long k, int group, void* stream) {
  if (m == 0 || n == 0) return (int)cudaSuccess;
  if (k <= 0 || k % 8 || n % 8 || group <= 0 || group % 4 || k % group || w_stride % 16 ||
      w_stride < k / 2 || x_cols % 16 || x_hi % 16 || x_hi < k / 2 || x_hi + k / 2 > x_cols)
    return (int)cudaErrorInvalidValue;
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kNoEncodeEntry;
  CUtensorMap tx, tw;
  CUresult res;
  if ((res = encode_2d(fn, &tx, x8, x_cols, m, x_cols, kPK, kBM)) != CUDA_SUCCESS ||
      (res = encode_2d(fn, &tw, wp, k / 2, n, w_stride, kPK, kBN)) != CUDA_SUCCESS)
    return kEncodeFailed + (int)res;
  Params p;
  p.xs = xs;
  p.r = r;
  p.s8 = s8;
  p.bias = bias;
  p.y = y;
  p.m = m;
  p.n = n;
  p.kh = (int)(k / 2);
  p.x_hi = (int)x_hi;
  p.group = group;
  p.n_groups = (int)(k / group);
  p.k_steps = (int)((k / 2 + kPK - 1) / kPK);
  const long long ctas = (n + kBN - 1) / kBN * ((m + kBM - 1) / kBM);
  if (ctas > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)ctas);
  const bool lut = group == 128 && (k / 2) % 128 == 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (out_f32)
    return lut ? launch<true, float>(tx, tw, p, grid, st)
               : launch<false, float>(tx, tw, p, grid, st);
  return lut ? launch<true, __nv_bfloat16>(tx, tw, p, grid, st)
             : launch<false, __nv_bfloat16>(tx, tw, p, grid, st);
}
