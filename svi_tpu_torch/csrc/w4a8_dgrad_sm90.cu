// The W4A8 linear's straight-through input gradient for Hopper (sm_90a), one
// kernel, plain C interface:
//
//   dx (M, K) = bf16( bf16(g . bf16(s8)) @ bf16(W8) ),
//   W8 = clip(rint(w4 * r[n, k / G]), -127, 127)   (K3's arithmetic),
//
// g (M, N) bf16 the cotangent of y, s8 (N,) f32 the per-channel scales, the
// packed int4 weight (N, K/2) half-split (byte [n, i] holds input i in its
// low nibble and input i + K/2 in its high nibble), r (N, K/G) f32 the group
// ratios; products summed in f32.
//
// Replaces, in the JAX package: the Pallas kernel
// svi_tpu/ops/quant_matmul.py::_unpack_kernel (K3, pallas_call at :73),
// whose output the W4A8 branch of `_dense` keeps as the residual of
// `_int8_exec`'s custom VJP, with the backward that reads it
// (svi_tpu/models/wan_dit.py:234 `_int8_exec_bwd`: gs = g * col_scale in
// g's dtype, then a dot with w8i.astype(g.dtype), in XLA). The port's
// training backward runs that as a chain: K3 (the (N, K) int8 weight to
// device memory), a bf16 copy of it, g * s8 written back whole, then
// cuBLAS. No path calls this kernel: at the 14B's shapes it is slower than
// that chain on the H100 (PERF.md).
//
// What bounds the work: at the DiT's linears (M = 9360 tokens) the bf16
// tensor cores, 2 M N K / 989 TFLOP/s (1.340 ms at ffn.0 and ffn.2, 0.496 ms
// at a 5120 x 5120 projection); the bytes (g, the packed weight, r and s8
// once, dx once) are a few percent of that. What binds this design, as
// measured with copies that leave a part out (PERF.md): the consumers' two
// halves of a k-step, each slower than the tensor cores alone. The W8
// transform with g's fragments, without the products, takes about 1.35x
// the bound; the products with g's fragments, without the transform, about
// 1.5x; overlapped in part, the kernel runs about 2.3x the bound, slower
// than the chain. (One producer warp for every stage, waiting a memory
// round trip for each k-step's scales and ratios, had held it at 2.7x.)
// What this design adds to a bf16 GEMM is two transforms, run by the
// consumer warpgroups while their products of the previous k-step run on
// the tensor cores:
//   * the weight: each CTA makes 64 rows x 128 columns of bf16 W8 a k-step
//     from the packed tile, 32 weights a thread, each by K3's f32 product
//     and round-half-to-even (an FADD of 1.5 * 2^23), the nibble made a
//     float by placing it in the mantissa of 2^23, the rounded value made
//     bf16 by taking the f32's upper half and clipped to +-127 on bf16
//     pairs. The reduction index of this product is W's row n, which changes
//     every k-step, so a 16-entry table per (row, group) as the forward GEMM
//     builds (w4a8_gemm_sm90.cu) would be rebuilt for every 16-32 weights it
//     serves: the direct arithmetic (5 FP32 and ~3 integer instructions a
//     weight) is cheaper;
//   * g's scaling: the consumers ldmatrix their A fragments of g and
//     multiply each pair by bf16(s8) with one fma.rn.bf16x2 (a * s + -0):
//     the exact product of two bf16 values rounded once to bf16, the bits of
//     the plain version's bf16(float(g) * float(bf16(s8))). (Folding s8
//     into the weight instead would round differently.)
// Neither the int8 weight, its bf16 copy nor the scaled cotangent reaches
// device memory: per call the kernel reads g, the packed weight, r and s8
// and writes dx. Everything a k-step reads from device memory arrives
// through the producers' ring, stages ahead.
//
// Structure: one CTA per 256 rows of g x 128 columns of dx: the 64 columns
// [c0, c0 + 64) and the 64 columns [K/2 + c0, ...) that the same packed
// bytes [c0, c0 + 64) of each weight row give (the half-split pairing: each
// packed byte is read once for both). The 128 columns are one wgmma n128
// whose B operand is two 64-column boxes, low and high: one 64 x 128 f32
// accumulator per 64 rows (64 registers), against 2 x 64 for two separate
// column tiles at the same bytes per product; each consumer warpgroup owns
// 128 rows (two m64 halves, 128 accumulators a thread). Four producer
// warps, warp w for stage w of a 4-stage mbarrier ring (the k-steps t = w
// mod 4), so that four k-steps' loads are in flight at once: each
// TMA-loads its k-step's (256 x 64) tile of g (N contiguous, 128-byte
// swizzle) and the (64 x 64-byte) packed tile (64-byte swizzle), and stores
// beside them the k-step's 64 scales as bf16 and the group ratios of its 64
// rows (one per row and half where a group spans the CTA's 64 columns, G %
// 64 == 0, in adjacent words, which a consumer thread reads once a k-step;
// else one per 4-column word). The consumers write the bf16 W8 tile
// MN-major: rows n (the reduction) of 64 output columns, 128-byte swizzled
// as TMA would, the
// layout in which the transform writes each weight row where it reads it,
// so no transpose is needed; the descriptor's transpose bit (wgmma_rs's
// tnspB) reads it as B. Generic-proxy stores, then fence.proxy.async and a
// barrier of the 256 consumer threads before wgmma reads it; the tile is
// double-buffered, and so are the A fragments (registers of their own by
// step parity), so step t's transform and fragments are made while step t -
// 1's products run. Then m64n128k16 bf16 wgmma with A from registers.
// Edges: TMA zero-fills g past M and past N and the packed tile past N and
// K/2 (the wrapper gives TMA 16-byte rows: a padded copy where K/2 % 16 !=
// 0, only the tiny test configs), ratios and scales past N are 0, and
// stores are clipped at M and K.

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int kBM = 256;            // rows of g per CTA: two consumer warpgroups of 128
constexpr int kPK = 64;             // packed bytes per CTA: dx columns [c0, c0+64), [K/2+c0, ...)
constexpr int kBK = 64;             // weight rows (the reduction) per k-step
constexpr int kStages = 4;
constexpr int kProducerWarps = 4;   // warp 8 + w fills stage w: one stage each
static_assert(kStages == kProducerWarps, "each producer warp owns one stage");
constexpr int kThreads = 384;       // warpgroups 0 and 1 consume, warpgroup 2 produces
constexpr int kConsumerWarps = 8;   // each releases a stage with one arrival
constexpr int kGroupM = 8;          // row tiles a raster group walks
constexpr uint32_t kATile = kBM * kBK * 2;   // 32 KB: 256 rows x 64 bf16 of g
constexpr uint32_t kPTile = kBK * kPK;       // 4 KB: 64 weight rows x 64 packed bytes
constexpr uint32_t kStage = kATile + kPTile;
constexpr uint32_t kBBox = kBK * 128;        // 8 KB: 64 weight rows x 64 bf16 columns
constexpr uint32_t kBTile = 2 * kBBox;       // the low and the high box
constexpr uint32_t kS8Slot = kBK * 2;        // the k-step's 64 scales as bf16
constexpr int kWords = kPK / 4;              // 4-column words of a half-row
constexpr uint32_t kRSlot = 2 * kBK * kWords * 4;  // ratios [half][row][word], f32
constexpr size_t kSmemBytes =
    kStages * (kStage + kS8Slot + kRSlot) + 2 * kBTile + 8 * 2 * kStages + 1024;

struct Params {
  const float* r;     // (N, K/G) f32, contiguous
  const float* s8;    // (N,) f32
  __nv_bfloat16* dx;  // (M, K) bf16, contiguous
  long long m;
  int n, kh, n_groups, group, k_steps;
};

__device__ __forceinline__ uint32_t a_tile(uint32_t base, int st) { return base + kStage * st; }
__device__ __forceinline__ uint32_t p_tile(uint32_t base, int st) {
  return a_tile(base, st) + kATile;
}
__device__ __forceinline__ uint32_t b_tile(uint32_t base, int buf) {
  return base + kStage * kStages + kBTile * buf;
}
__device__ __forceinline__ uint32_t s8_slot(uint32_t base, int st) {
  return base + kStage * kStages + 2 * kBTile + kS8Slot * st;
}
__device__ __forceinline__ uint32_t r_slot(uint32_t base, int st) {
  return base + kStage * kStages + 2 * kBTile + kS8Slot * kStages + kRSlot * st;
}
__device__ __forceinline__ uint32_t bar_full(uint32_t base, int st) {
  return base + kStage * kStages + 2 * kBTile + (kS8Slot + kRSlot) * kStages + 8 * st;
}
__device__ __forceinline__ uint32_t bar_empty(uint32_t base, int st) {
  return bar_full(base, kStages + st);
}

// byte offset of 16-byte chunk `chunk` of row `row` in a 64-byte-swizzled
// tile (64-byte rows, 512-byte aligned), as TMA writes it
__device__ __forceinline__ uint32_t swizzle64(int row, int chunk) {
  return row * 64u + (((chunk ^ (row >> 1)) & 3) << 4);
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts128(uint32_t addr, uint32_t a, uint32_t b, uint32_t c,
                                       uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(a), "r"(b), "r"(c),
               "r"(d)
               : "memory");
}

__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// rows (lane % 16) and 16-byte columns (lane / 16) of a 16 x 16 bf16 block:
// the A fragment of m64nNk16 (a[0] row g k 2t, a[1] row g+8, a[2] / a[3] k + 8)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// bf16(a * s) for a pair: the exact product rounded once (the -0 addend
// changes no product, +0 and -0 included)
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t s) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(s), "r"(0x80008000u));
  return d;
}

// clip(v, -127, 127) for a bf16 pair
__device__ __forceinline__ uint32_t clip127_bf16x2(uint32_t v) {
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(v), "r"(0xC2FEC2FEu));  // -127
  asm("min.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(d), "r"(0x42FE42FEu));  // 127
  return d;
}

// four nibbles of a word (bits 0-3 of each byte after the shift) -> two bf16
// pairs of W8 = clip(rint(w4 * r), -127, 127) (K3's f32 product and
// rounding). Clipping after the rounding is the same (+-127 are integers);
// the rounded values' bf16 are their f32's upper halves: exact up to 256, and
// any larger magnitude (r far above the quantizer's 127/7) still clips to 127
__device__ __forceinline__ void requant4(uint32_t w, int shift, float r, uint32_t& lo,
                                         uint32_t& hi) {
  const uint32_t x = (w >> shift) ^ 0x08080808u;  // u ^ 8: w4 = (u ^ 8) - 8
  uint32_t z[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // 2^23 + (u ^ 8), less 2^23 + 8: the signed nibble, exactly
    const float w4 = __fsub_rn(__uint_as_float(((x >> (8 * j)) & 0xFu) | 0x4B000000u),
                               8388616.f);
    // rint, half to even: the FADD of 1.5 * 2^23 (never contracted with the product)
    z[j] = __float_as_uint(
        __fsub_rn(__fadd_rn(__fmul_rn(w4, r), 12582912.f), 12582912.f));
  }
  lo = clip127_bf16x2(__byte_perm(z[0], z[1], 0x7632));
  hi = clip127_bf16x2(__byte_perm(z[2], z[3], 0x7632));
}

// a consumer thread's place
struct Place {
  uint32_t base, a_row;
  int wg, lane, t4, wr, ws, shift, a_chunk, a_phase;
};

// this lane's A fragments of one m64 half (rows `at` on), each pair
// multiplied by its columns' bf16(s8)
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], uint32_t at, const Place& pl,
                                       const uint32_t (&sp)[4][2]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    ldmatrix_x4(a[kk], at + ((((2 * kk + pl.a_chunk) ^ pl.a_phase) & 7) << 4));
    a[kk][0] = mul_bf16x2(a[kk][0], sp[kk][0]);
    a[kk][1] = mul_bf16x2(a[kk][1], sp[kk][0]);
    a[kk][2] = mul_bf16x2(a[kk][2], sp[kk][1]);
    a[kk][3] = mul_bf16x2(a[kk][3], sp[kk][1]);
  }
}

// both m64 halves' fragments of stage st
__device__ __forceinline__ void load_a2(uint32_t (&a)[2][4][4], const Place& pl, int st) {
  // the scales of columns 16 kk + 2 t4 (+1) and 16 kk + 8 + 2 t4 (+1)
  uint32_t sp[4][2];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    sp[kk][0] = lds32(s8_slot(pl.base, st) + 4 * (8 * kk + pl.t4));
    sp[kk][1] = lds32(s8_slot(pl.base, st) + 4 * (8 * kk + 4 + pl.t4));
  }
  const uint32_t at = a_tile(pl.base, st) + pl.a_row;
  load_a(a[0], at, pl, sp);
  load_a(a[1], at + 64 * 128, pl, sp);
}

// what a consumer thread carries from one k-step to the next
struct Carry {
  float acc[2][64];        // two m64 halves x 128 columns
  uint32_t a[2][2][4][4];  // A fragments [step parity][half]
};

// k-step t (P = t % 2): the packed tile of stage st -> bf16 W8 tile P and
// the A fragments while step t - 1's products run, then its products
template <int P, bool ONE_GROUP>
__device__ __forceinline__ void k_step(Carry& c, const Place& pl, int t) {
  const int st = t % kStages;
  const uint32_t b = b_tile(pl.base, P);
  mbar_wait(bar_full(pl.base, st), (t / kStages) & 1);

  // packed bytes 32 ws .. 32 ws + 31 of weight row wr -> bf16 W8, row wr,
  // columns 32 ws .. of box wg, with the ratios the producer laid out (one
  // read of the row's one ratio, ONE_GROUP: the rows' ratios are adjacent
  // words, so a warp's 16 rows hit 16 banks)
  const uint32_t rrow = r_slot(pl.base, st) +
                        (ONE_GROUP ? (pl.wg * kBK + pl.wr) * 4
                                   : ((pl.wg * kBK + pl.wr) * kWords + 8 * pl.ws) * 4);
  const float r_row = ONE_GROUP ? __uint_as_float(lds32(rrow)) : 0.f;
  const uint32_t brow = b + pl.wg * kBBox + pl.wr * 128;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint4 w = lds128(p_tile(pl.base, st) + swizzle64(pl.wr, 2 * pl.ws + h));
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      uint32_t v[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int word = 4 * h + 2 * q + i;
        const float r = ONE_GROUP ? r_row : __uint_as_float(lds32(rrow + 4 * word));
        requant4(words[2 * q + i], pl.shift, r, v[2 * i], v[2 * i + 1]);
      }
      sts128(brow + ((((4 * pl.ws + 2 * h + q) ^ pl.wr) & 7) << 4), v[0], v[1], v[2], v[3]);
    }
  }
  load_a2(c.a[P], pl, st);

  if (t > 0) {
    // this warpgroup's products of step t - 1 are done: its stage is free
    wgmma_wait<0>();
    fence_regs(c.acc[0]);
    fence_regs(c.acc[1]);
    if (pl.lane == 0) mbar_arrive(bar_empty(pl.base, (t - 1) % kStages));
  }
  // the W8 stores are seen by wgmma (async proxy), and every consumer has
  // finished both its stores and its products of step t - 1, which read
  // the other W8 buffer
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  wgmma_fence();
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(c.acc[h], c.a[P][h][kk], gmma_desc(b + kk * 16 * 128, kBBox, 1024));
  wgmma_commit();
}

template <bool ONE_GROUP>
__global__ void __launch_bounds__(kThreads, 1)
    w4a8_dgrad_kernel(const __grid_constant__ CUtensorMap tg,
                      const __grid_constant__ CUtensorMap tw, const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) & ~1023u;
  // grouped order: runs of kGroupM row tiles walk the column tiles together,
  // so a wave of CTAs reads a compact block of g's rows and packed columns
  const int c_tiles = (p.kh + kPK - 1) / kPK, m_tiles = (int)((p.m + kBM - 1) / kBM);
  const int id = blockIdx.x, per_group = kGroupM * c_tiles;
  const int first_m = (id / per_group) * kGroupM;
  const int group_rows = min(m_tiles - first_m, kGroupM);
  const int c0 = ((id % per_group) / group_rows) * kPK;
  const long long m0 = (long long)(first_m + (id % per_group) % group_rows) * kBM;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full(base, st), 33);  // the TMA's expect_tx and its producer warp's 32 lanes
      mbar_init(bar_empty(base, st), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producers: warp 8 + w fills stage w. Lane 0 issues the TMA loads of g
    // and of the packed tile; every lane stores two of the k-step's scales
    // as bf16 and its share of the ratios, [half][row][word] (ONE_GROUP:
    // [half][row], one word a row), their loads issued before the wait for
    // the free stage
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    {
      const int lane = threadIdx.x % 32, pw = (threadIdx.x - 256) / 32;
      const int g_lo = c0 / p.group, g_hi = (p.kh + c0) / p.group;
      for (int t = pw; t < p.k_steps; t += kProducerWarps) {
        const int st = t % kStages, n0 = t * kBK;
        const int n = n0 + 2 * lane;  // N % 8 == 0: a pair is wholly in or out
        const float2 s = n < p.n ? __ldg(reinterpret_cast<const float2*>(p.s8 + n))
                                 : make_float2(0.f, 0.f);
        float r1[4];  // ONE_GROUP: rows 2 lane and 2 lane + 1, both halves
        if (ONE_GROUP) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int row = n + (j & 1);
            r1[j] = row < p.n ? __ldg(p.r + (long long)row * p.n_groups + (j < 2 ? g_lo : g_hi))
                              : 0.f;
          }
        }
        if (t >= kStages) mbar_wait(bar_empty(base, st), ((t / kStages) - 1) & 1);
        const uint32_t full = bar_full(base, st);
        if (lane == 0) {
          mbar_expect_tx(full, kStage);
          tma_load_2d(a_tile(base, st), &tg, full, n0, (int)m0);
          tma_load_2d(p_tile(base, st), &tw, full, c0, n0);
        }
        sts32(s8_slot(base, st) + 4 * lane, pack_bf16(s.x, s.y));
        const uint32_t rs = r_slot(base, st);
        if (ONE_GROUP) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            sts32(rs + ((j >> 1) * kBK + 2 * lane + (j & 1)) * 4, __float_as_uint(r1[j]));
        } else {
          // any group dividing K in multiples of 4 (the tiny configs): one
          // ratio per 4-column word, 0 past N and K/2
          for (int e = lane; e < 2 * kBK * kWords; e += 32) {
            const int half = e / (kBK * kWords), row = (e / kWords) % kBK, word = e % kWords;
            const int low = c0 + 4 * word;
            const bool in = n0 + row < p.n && low < p.kh;
            const float r = in ? __ldg(p.r + (long long)(n0 + row) * p.n_groups +
                                       (half * p.kh + low) / p.group)
                               : 0.f;
            sts32(rs + 4 * e, __float_as_uint(r));
          }
        }
        mbar_arrive(full);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  Place pl;
  pl.base = base;
  pl.wg = wg;
  const int tid = threadIdx.x % 128, warp = tid / 32;
  pl.lane = tid % 32;
  pl.t4 = pl.lane % 4;
  // the transform: warpgroup wg makes box wg (the low nibbles' columns, then
  // the high ones'); thread (row wr, segment ws) makes 32 columns of one row
  pl.wr = tid / 2;
  pl.ws = tid % 2;
  pl.shift = 4 * wg;
  // this lane's ldmatrix row and column-of-16-bytes offset; rows of an m64
  // half are 16-aligned, so the 128-byte swizzle's row phase is lane % 8
  pl.a_row = (uint32_t)(wg * 128 + warp * 16 + (pl.lane & 15)) * 128;
  pl.a_chunk = pl.lane >> 4;
  pl.a_phase = pl.lane & 7;

  Carry c;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) c.acc[h][i] = 0.f;

  for (int t = 0; t < p.k_steps; t += 2) {
    k_step<0, ONE_GROUP>(c, pl, t);
    if (t + 1 < p.k_steps) k_step<1, ONE_GROUP>(c, pl, t + 1);
  }
  wgmma_wait<0>();
  fence_regs(c.acc[0]);
  fence_regs(c.acc[1]);

  // epilogue: dx = bf16(acc) from registers; accumulator column 8j + 2 t4
  // (+1) is dx column c0 + 8j + 2 t4 for j < 8, K/2 + c0 + 8 (j - 8) + 2 t4
  // above; rows past M and columns past K are skipped
  const int g8 = pl.lane / 4;
  const long long k = 2LL * p.kh;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long row = m0 + wg * 128 + h * 64 + warp * 16 + g8 + 8 * half;
      if (row >= p.m) continue;
      __nv_bfloat16* drow = p.dx + row * k;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int low = c0 + 8 * (j % 8) + 2 * pl.t4;
        if (low >= p.kh) continue;
        *reinterpret_cast<uint32_t*>(drow + (j < 8 ? 0 : p.kh) + low) =
            pack_bf16(c.acc[h][4 * j + 2 * half], c.acc[h][4 * j + 2 * half + 1]);
      }
    }
  }
}

CUresult encode_2d(EncodeTiledFn fn, CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
                   long long cols, long long rows, long long row_bytes, uint32_t box_cols,
                   uint32_t box_rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <bool ONE_GROUP>
int launch(const CUtensorMap& tg, const CUtensorMap& tw, const Params& p, dim3 grid,
           cudaStream_t st) {
  auto kern = w4a8_dgrad_kernel<ONE_GROUP>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, kThreads, kSmemBytes, st>>>(tg, tw, p);
  return (int)cudaGetLastError();
}

}  // namespace

// g: (m, n) bf16 contiguous, 16-byte aligned; wp: (n, k/2) int8 packed
// weight whose rows are w_stride bytes apart (a multiple of 16, 16-byte
// aligned); r: (n, k/group) f32 contiguous; s8: (n,) f32, 8-byte aligned;
// dx: (m, k) bf16 contiguous. k % 16 == 0, n % 8 == 0, group % 4 == 0
// dividing k (the shapes of w4a8_linear). Returns 0 when the kernel was
// launched, a cudaError_t value, kNoEncodeEntry, or kEncodeFailed + the
// CUresult of a failed encode.
extern "C" int svi_w4a8_dgrad(const void* g, const void* wp, long long w_stride, const float* r,
                              const float* s8, void* dx, long long m, long long n, long long k,
                              int group, void* stream) {
  if (m == 0 || k == 0) return (int)cudaSuccess;
  if (n <= 0 || k % 16 || n % 8 || group <= 0 || group % 4 || k % group || m > 0x7FFFFFFFll ||
      n > 0x7FFFFFFFll || k > 0x7FFFFFFFll || w_stride % 16 || w_stride < k / 2 ||
      reinterpret_cast<uintptr_t>(g) % 16 || reinterpret_cast<uintptr_t>(wp) % 16 ||
      reinterpret_cast<uintptr_t>(s8) % 8)
    return (int)cudaErrorInvalidValue;
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kNoEncodeEntry;
  CUtensorMap tg, tw;
  CUresult res;
  if ((res = encode_2d(fn, &tg, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, g, n, m, n * 2, kBK, kBM,
                       CU_TENSOR_MAP_SWIZZLE_128B)) != CUDA_SUCCESS ||
      (res = encode_2d(fn, &tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, wp, k / 2, n, w_stride, kPK, kBK,
                       CU_TENSOR_MAP_SWIZZLE_64B)) != CUDA_SUCCESS)
    return kEncodeFailed + (int)res;
  Params p;
  p.r = r;
  p.s8 = s8;
  p.dx = static_cast<__nv_bfloat16*>(dx);
  p.m = m;
  p.n = (int)n;
  p.kh = (int)(k / 2);
  p.group = group;
  p.n_groups = (int)(k / group);
  p.k_steps = (int)((n + kBK - 1) / kBK);
  const long long ctas = (k / 2 + kPK - 1) / kPK * ((m + kBM - 1) / kBM);
  if (ctas > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  // every word of a thread in one group, the same for the 64 columns of a
  // half-row: G a multiple of 64 and K/2 on the same 64-column grid
  const bool one_group = group % 64 == 0 && (k / 2) % 64 == 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return one_group ? launch<true>(tg, tw, p, dim3((unsigned)ctas), st)
                   : launch<false>(tg, tw, p, dim3((unsigned)ctas), st);
}
