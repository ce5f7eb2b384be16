// Flash-attention forward for Hopper (sm_90a), bf16, head dim 128: TMA-fed
// wgmma with warp specialisation. Plain C interface.
//
// Replaces, for bf16 and D = 128, the Pallas TPU kernel
// svi_tpu/ops/attention.py::_fwd_kernel_flat (K1, launched by
// _flash_fwd_pallas_flat, pallas_call at :179) and the RoPE it applies inside
// the kernel (_rope_in_kernel, :60). The contract is K1's: q, k, v as
// (B, S, N, D) element strides (the last dim contiguous), optional
// interleaved-pair RoPE from (S, D/2) f32 tables, keys at or beyond
// min(kv_len, Sk) masked, out in bf16 and base-e lse (B, N, Sq) f32; a row
// whose keys are all masked gets out = 0 and lse = -1e30 + log(1e-30).
//
// What bounds it on this card: at the 14B DiT's self-attention (S = 32760,
// 40 heads) the two products, 4 * S^2 * D FLOP per head, at the bf16
// tensor-core rate (22.2 ms at 989 TFLOP/s); at the cross-attention shapes
// (Sk = 512 / 257) the bytes of q and out. The mma.sync kernel it replaces
// (csrc/flash_fwd.cu) ran at ~10% of that bound. What this design does about
// each of that kernel's limits:
//   1. tensor cores: wgmma m64n128k16, S = Q K^T with both operands read from
//      shared memory (K-major), O += P V with P in registers (the f32
//      accumulator layout of S, packed to bf16, is wgmma's A-fragment layout)
//      and V read as an MN-major operand (the transpose bit set);
//   2. no fragment loads: wgmma reads Q, K and V from shared memory through
//      descriptors of the 128-byte swizzled layout TMA writes;
//   3. loads overlap compute: one producer thread issues TMA loads into a
//      ring of three K/V stages guarded by mbarriers (K and V on separate
//      barriers); no __syncthreads in the loop. FA3's two schedules keep
//      the tensor cores busy through the softmax: inside each consumer
//      warpgroup, tile j's Q K^T and tile j-1's P V are issued together and
//      tile j's softmax runs while that P V completes (intra-warpgroup
//      overlap), and the two warpgroups take turns issuing on named barriers
//      (ping-pong), so one's softmax runs under the other's products;
//   4. RoPE is a pre-pass (flash_fwd_sm90_rope_kernel) that rotates q and k
//      once into contiguous bf16 buffers, with the arithmetic of the earlier
//      in-loop rotation (f32 products and sums rounded to nearest, one
//      rounding to bf16), so the rotated values are bit-identical to it;
//   5. 128 query rows per CTA (two consumer warpgroups of 64 rows, each with
//      240 registers through setmaxnreg) and 128-key tiles.
// Rows past S are zero-filled by TMA; only the last key tile is masked, and
// only when kv_end % 128 != 0. The epilogue stages bf16 out in the Q tile's
// shared memory and writes it with a TMA store, which clips rows past Sq.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kD = 128;
constexpr int kBM = 128;       // query rows per CTA: two consumer warpgroups of 64
constexpr int kBN = 128;       // keys per tile
constexpr int kStages = 3;     // K/V ring depth (224 KB of shared memory in all)
constexpr int kThreads = 384;  // warpgroups 0 and 1 consume, warpgroup 2 produces
constexpr int kConsumers = 256;
constexpr int kBoxCols = 64;   // one 128-byte swizzled row holds 64 bf16
constexpr uint32_t kRowBytes = 128;
constexpr uint32_t kBoxBytes = kBN * kRowBytes;  // 16 KB: 128 rows x 64 columns
constexpr uint32_t kTileBytes = 2 * kBoxBytes;   // 32 KB: 128 rows x 128 columns
constexpr uint32_t kBarBytes = 8 * (3 * kStages + 1);
constexpr size_t kSmemBytes = kTileBytes * (1 + 2 * kStages) + kBarBytes + 1024;

struct Params {
  float* lse;  // (B, N, Sq) contiguous
  long long sq;
  long long kv_end;  // min(kv_len, Sk)
  int n_heads;
  float scale_log2;  // softmax scale * log2(e)
};

// shared-memory map, offsets from a 1024-byte aligned base (the 128-byte
// swizzle repeats every 8 rows of 128 bytes, and wgmma descriptors assume
// atoms that start on that boundary)
__device__ __forceinline__ uint32_t k_tile(uint32_t base, int st) {
  return base + kTileBytes * (1 + st);
}
__device__ __forceinline__ uint32_t v_tile(uint32_t base, int st) {
  return base + kTileBytes * (1 + kStages + st);
}
__device__ __forceinline__ uint32_t bar_full_k(uint32_t base, int st) {
  return base + kTileBytes * (1 + 2 * kStages) + 8 * st;
}
__device__ __forceinline__ uint32_t bar_full_v(uint32_t base, int st) {
  return bar_full_k(base, kStages + st);
}
__device__ __forceinline__ uint32_t bar_empty(uint32_t base, int st) {
  return bar_full_k(base, 2 * kStages + st);
}
__device__ __forceinline__ uint32_t bar_q(uint32_t base) { return bar_full_k(base, 3 * kStages); }

// ---------------------------------------------------------------------------
// mbarrier, TMA and wgmma in inline PTX
// ---------------------------------------------------------------------------

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

// one box of a 4-D (D, N, S, B) map into shared memory, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle. lbo / sbo in bytes.
// K-major operands (Q, K): sbo = 1024 between 8-row groups, lbo unused.
// MN-major operand (V): lbo = the stride between 64-column boxes along N,
// sbo = 1024 between groups of 8 keys along K.
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

// pins accumulator registers: nothing that reads them moves above this point
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128 f32) (+)= A (64 x 16, smem) * B (16 x 128, smem), both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
      "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// a row of the accumulator lives in 4 neighbouring lanes
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float lse_of(float m, float l) {
  const float mm = (m == -INFINITY) ? -1e30f : m / kLog2e;
  return mm + logf(fmaxf(l, 1e-30f));
}

// ---------------------------------------------------------------------------
// consumer pieces. Accumulator layout of m64n128 (per thread, warp w of the
// warpgroup, lane = 4g + t): d[4j + i] is row 16w + g + 8 * (i >> 1), column
// 8j + 2t + (i & 1).
// ---------------------------------------------------------------------------

// S = Q K^T: this warpgroup's 64 query rows against a 128-key tile
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t q_rows, uint32_t k_base) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    wgmma_ss(s, gmma_desc(q_rows + off, 16, 1024), gmma_desc(k_base + off, 16, 1024), kk > 0);
  }
}

// O += P V over a 128-key tile; P's 16-key slice kk is pf[4kk .. 4kk + 3]
__device__ __forceinline__ void issue_pv(float (&o)[64], const uint32_t (&pf)[32],
                                         uint32_t v_base) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    const uint32_t a[4] = {pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2], pf[4 * kk + 3]};
    wgmma_rs(o, a, gmma_desc(v_base + kk * 16 * kRowBytes, kBoxBytes, 1024));
  }
}

// online softmax in base 2 on one tile's scores, in place: s becomes
// exp2(x - m_new); returns the factor that moves the running O to m_new.
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float scale_log2, bool mask,
                                             long long k0, long long kv_end, int t4) {
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] *= scale_log2;
  if (mask) {
#pragma unroll
    for (int i = 0; i < 64; ++i)
      if (k0 + 8 * (i / 4) + 2 * t4 + (i & 1) >= kv_end) s[i] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float mu[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = fmaxf(m[r], quad_max(mx[r]));
    mu[r] = (mn == -INFINITY) ? 0.f : mn;  // keeps exp2 of masked keys at 0, never NaN
    alpha[r] = ex2(m[r] - mu[r]);
    m[r] = mn;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const float e = ex2(s[i] - mu[(i >> 1) & 1]);
    s[i] = e;
    rs[(i >> 1) & 1] += e;
  }
  l[0] = l[0] * alpha[0] + rs[0];
  l[1] = l[1] * alpha[1] + rs[1];
}

// P rounded to bf16: the accumulators of key groups 2kk and 2kk + 1 are the
// A fragment of the kk-th 16-key step
__device__ __forceinline__ void pack_p(uint32_t (&pf)[32], const float (&s)[64]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    pf[4 * kk + 0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    pf[4 * kk + 1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pf[4 * kk + 2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pf[4 * kk + 3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// ping-pong: the consumer warpgroups take turns issuing their products, so
// one's softmax runs while the other's wgmmas do. Warpgroup wg waits for its
// turn on named barrier 3 + wg (its 128 threads and the other warpgroup's
// arrival) and hands the turn over when its products are issued.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(3 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int to_wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(3 + to_wg) : "memory");
}

__device__ __forceinline__ void rescale(float (&o)[64], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] *= alpha[(i >> 1) & 1];
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap to, const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) & ~1023u;
  const int q0 = blockIdx.x * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (int)((p.kv_end + kBN - 1) / kBN);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full_k(base, st), 1);
      mbar_init(bar_full_v(base, st), 1);
      mbar_init(bar_empty(base, st), kConsumers);
    }
    mbar_init(bar_q(base), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread keeps the K/V ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(bar_q(base), kTileBytes);
      tma_load(base, &tq, bar_q(base), 0, h, q0, b);
      tma_load(base + kBoxBytes, &tq, bar_q(base), kBoxCols, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        if (j >= kStages) mbar_wait(bar_empty(base, st), ((j / kStages) - 1) & 1);
        const uint32_t fk = bar_full_k(base, st), fv = bar_full_v(base, st);
        mbar_expect_tx(fk, kTileBytes);
        tma_load(k_tile(base, st), &tk, fk, 0, h, j * kBN, b);
        tma_load(k_tile(base, st) + kBoxBytes, &tk, fk, kBoxCols, h, j * kBN, b);
        mbar_expect_tx(fv, kTileBytes);
        tma_load(v_tile(base, st), &tv, fv, 0, h, j * kBN, b);
        tma_load(v_tile(base, st) + kBoxBytes, &tv, fv, kBoxCols, h, j * kBN, b);
      }
    }
  } else {
    // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
    const uint32_t q_rows = base + wg * 64 * kRowBytes;
    const bool ragged = (p.kv_end % kBN) != 0;

    float o[64], s[64], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
    uint32_t pf[32];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = s[i] = 0.f;

    mbar_wait(bar_q(base), 0);
    if (n_tiles > 0) {
      if (wg == 0) turn_pass(0);  // warpgroup 0 takes the first turn
      mbar_wait(bar_full_k(base, 0), 0);
      turn_wait(wg);
      wgmma_fence();
      issue_qk(s, q_rows, k_tile(base, 0));
      wgmma_commit();
      turn_pass(1 - wg);
      wgmma_wait<0>();
      fence_regs(s);
      softmax_tile(s, m, l, alpha, p.scale_log2, ragged && n_tiles == 1, 0, p.kv_end, t4);
      pack_p(pf, s);
      for (int j = 1; j < n_tiles; ++j) {
        const int st = j % kStages, sp = (j - 1) % kStages;
        mbar_wait(bar_full_k(base, st), (j / kStages) & 1);
        mbar_wait(bar_full_v(base, sp), ((j - 1) / kStages) & 1);
        turn_wait(wg);
        wgmma_fence();
        issue_qk(s, q_rows, k_tile(base, st));  // tile j's scores
        wgmma_commit();
        issue_pv(o, pf, v_tile(base, sp));  // tile j-1's values
        wgmma_commit();
        turn_pass(1 - wg);
        wgmma_wait<1>();
        fence_regs(s);
        softmax_tile(s, m, l, alpha, p.scale_log2, ragged && j == n_tiles - 1,
                     (long long)j * kBN, p.kv_end, t4);
        wgmma_wait<0>();
        fence_regs(o);
        mbar_arrive(bar_empty(base, sp));
        rescale(o, alpha);
        pack_p(pf, s);
      }
      const int sl = (n_tiles - 1) % kStages;
      mbar_wait(bar_full_v(base, sl), ((n_tiles - 1) / kStages) & 1);
      wgmma_fence();
      issue_pv(o, pf, v_tile(base, sl));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    }

    // epilogue: normalise, stage bf16 rows in this warpgroup's (now unread)
    // Q rows in the swizzled layout, TMA-store them
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = quad_sum(l[r]);
      inv[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
    const int r0 = warp * 16 + g;
#pragma unroll
    for (int jn = 0; jn < kD / 8; ++jn) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + 8 * half;
        const uint32_t addr = q_rows + (jn / 8) * kBoxBytes + row * kRowBytes +
                              (((jn % 8) ^ (row & 7)) << 4) + t4 * 4;
        const uint32_t val = pack_bf16(o[4 * jn + 2 * half] * inv[half],
                                       o[4 * jn + 2 * half + 1] * inv[half]);
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(val) : "memory");
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    const int row0 = q0 + wg * 64;
    if (tid == 0 && row0 < p.sq) {
      tma_store(&to, q_rows, 0, h, row0, b);
      tma_store(&to, q_rows + kBoxBytes, kBoxCols, h, row0, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
    if (t4 == 0) {
      float* lrow = p.lse + ((long long)b * p.n_heads + h) * p.sq;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long row = row0 + r0 + 8 * half;
        if (row < p.sq) lrow[row] = lse_of(m[half], l[half]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// RoPE pre-pass: rotate pairs (2i, 2i+1) of every head row of a strided
// (B, S, N, D) bf16 view into a contiguous (B, S, N, D) buffer. One CTA per
// (b, s) row; each thread moves 16 bytes at a time. Bound by bytes.
// ---------------------------------------------------------------------------

constexpr int kRopeThreads = 128;

__global__ void __launch_bounds__(kRopeThreads) flash_fwd_sm90_rope_kernel(
    const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ y,
    const float* __restrict__ cos, const float* __restrict__ sin, long long seq, int n_heads,
    int head_dim, long long sb, long long ss, long long sn) {
  const long long row = blockIdx.x;
  const long long b = row / seq, s = row % seq;
  const int vpr = head_dim / 8;  // 16-byte vectors per head row
  const __nv_bfloat16* xr = x + b * sb + s * ss;
  __nv_bfloat16* yr = y + row * (long long)n_heads * head_dim;
  const float* cr = cos + s * (head_dim / 2);
  const float* sr = sin + s * (head_dim / 2);
  for (int vi = threadIdx.x; vi < n_heads * vpr; vi += kRopeThreads) {
    const int n = vi / vpr, cv = vi % vpr;
    uint4 val = *reinterpret_cast<const uint4*>(xr + n * sn + cv * 8);
    const float4 c4 = __ldg(reinterpret_cast<const float4*>(cr + cv * 4));
    const float4 s4 = __ldg(reinterpret_cast<const float4*>(sr + cv * 4));
    const float cs[4] = {c4.x, c4.y, c4.z, c4.w}, sn4[4] = {s4.x, s4.y, s4.z, s4.w};
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x0 = __bfloat162float(e[2 * i]);
      const float x1 = __bfloat162float(e[2 * i + 1]);
      e[2 * i] = __float2bfloat16_rn(__fsub_rn(__fmul_rn(x0, cs[i]), __fmul_rn(x1, sn4[i])));
      e[2 * i + 1] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(x0, sn4[i]), __fmul_rn(x1, cs[i])));
    }
    *reinterpret_cast<uint4*>(yr + vi * 8) = val;
  }
}

// ---------------------------------------------------------------------------
// host side: tensor maps through cuTensorMapEncodeTiled, found at run time
// (no -lcuda)
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
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

// 4-D map (D, N, S, B) of a bf16 view with element strides st = {b, s, n};
// boxes of 64 columns x `rows` rows of one head, 128-byte swizzle, rows past
// S read as zeros
CUresult encode_map(EncodeTiledFn fn, CUtensorMap* map, const void* ptr, long long n,
                    long long s, long long batch, const long long* st, uint32_t rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)kD, (cuuint64_t)n, (cuuint64_t)(s > 0 ? s : 1),
                              (cuuint64_t)batch};
  // a dim of extent 1 is never stepped: give it a stride TMA accepts
  const long long raw[3] = {st[2], st[1], st[0]};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i)
    strides[i] = dims[i + 1] == 1 ? (cuuint64_t)(kD * 2) : (cuuint64_t)(raw[i] * 2);
  const cuuint32_t box[4] = {(cuuint32_t)kBoxCols, 1, rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

constexpr int kNoEncodeEntry = 10000;   // cuTensorMapEncodeTiled not found
constexpr int kEncodeFailed = 20000;    // + the CUresult of a failed encode

}  // namespace

// q, k, v, out: bf16 (B, S, N, 128) views; strides: 12 element strides, (b, s,
// n) for q, k, v, out in that order. Returns 0 when the kernel was launched, a
// cudaError_t value, kNoEncodeEntry, or kEncodeFailed + the CUresult of the
// tensor-map encode that failed.
extern "C" int svi_flash_fwd_sm90(const void* q, const void* k, const void* v, void* out,
                                  float* lse, long long batch, long long n_heads, long long sq,
                                  long long sk, long long kv_len, float scale,
                                  const long long* strides, void* stream) {
  if (batch == 0 || n_heads == 0 || sq == 0) return (int)cudaSuccess;
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kNoEncodeEntry;
  CUtensorMap tq, tk, tv, to;
  CUresult r;
  if ((r = encode_map(fn, &tq, q, n_heads, sq, batch, strides + 0, kBM)) != CUDA_SUCCESS ||
      (r = encode_map(fn, &tk, k, n_heads, sk, batch, strides + 3, kBN)) != CUDA_SUCCESS ||
      (r = encode_map(fn, &tv, v, n_heads, sk, batch, strides + 6, kBN)) != CUDA_SUCCESS ||
      (r = encode_map(fn, &to, out, n_heads, sq, batch, strides + 9, 64)) != CUDA_SUCCESS)
    return kEncodeFailed + (int)r;
  Params p;
  p.lse = lse;
  p.sq = sq;
  p.kv_end = kv_len < sk ? kv_len : sk;
  if (p.kv_end < 0) p.kv_end = 0;
  p.n_heads = (int)n_heads;
  p.scale_log2 = scale * kLog2e;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((sq + kBM - 1) / kBM), (unsigned)n_heads, (unsigned)batch);
  flash_fwd_sm90_kernel<<<grid, kThreads, kSmemBytes, reinterpret_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, to, p);
  return (int)cudaGetLastError();
}

// x: bf16 (B, S, N, D) view with element strides (sb, ss, sn), D % 8 == 0,
// 16-byte aligned; y: contiguous (B, S, N, D); cos / sin: (>= S, D/2) f32.
extern "C" int svi_rope_rotate(const void* x, void* y, const float* cos, const float* sin,
                               long long batch, long long seq, long long n_heads, int head_dim,
                               long long sb, long long ss, long long sn, void* stream) {
  if (batch == 0 || seq == 0 || n_heads == 0) return (int)cudaSuccess;
  if (head_dim % 8) return (int)cudaErrorInvalidValue;
  flash_fwd_sm90_rope_kernel<<<(unsigned)(batch * seq), kRopeThreads, 0,
                               reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const __nv_bfloat16*>(x), reinterpret_cast<__nv_bfloat16*>(y), cos, sin,
      seq, (int)n_heads, head_dim, sb, ss, sn);
  return (int)cudaGetLastError();
}
