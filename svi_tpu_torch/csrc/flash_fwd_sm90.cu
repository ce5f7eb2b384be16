// Flash-attention forward for Hopper (sm_90a), bf16, at head dims 32, 40,
// 64, 80, 88, 128, 160, 384 and 512: TMA-fed wgmma with warp
// specialisation. Plain C interface.
//
// Replaces, for bf16, the Pallas TPU kernels
// svi_tpu/ops/attention.py::_fwd_kernel_flat (K1, launched by
// _flash_fwd_pallas_flat, pallas_call at :179) with the RoPE it applies inside
// the kernel (_rope_in_kernel, :60), at D = 128 (every DiT attention) and at
// one head (D = 64; the VAE mid-blocks' 384 and 512); and ::_fwd_kernel (K2,
// launched by _flash_fwd_pallas, pallas_call at :531) on (B, N, S, D) views,
// at D = 128 (the ring's steps), D = 64 (CogVideoX's joint attention, 48
// heads), D = 40 / 80 / 160 (the SD family's UNets, ControlNets and motion
// modules, 8 heads) and D = 88 (Hunyuan-DiT, 16 heads). The contract is K1's:
// q, k, v as (B, S, N, D) element strides (the last dim contiguous), optional
// interleaved-pair RoPE from (S, D/2) f32 tables, keys at or beyond
// min(kv_len, Sk) masked, out in bf16 rounded once from f32 (P rounded to
// bf16 for P V), base-e lse (B, N, Sq) f32; a row whose keys are all masked
// gets out = 0 and lse = -1e30 + log(1e-30).
//
// What bounds it on this card: at the 14B DiT's self-attention (S = 32760,
// 40 heads, D = 128) the two products, 4 * S^2 * D FLOP per head, at the bf16
// tensor-core rate (22.2 ms at 989 TFLOP/s); at the cross-attention shapes
// (Sk = 512 / 257) the bytes of q and out. At D = 64 the products halve per
// score but each score still costs one exp2 on the special-function units
// (16 a clock an SM): at CogVideoX's B2 S17776 N48 the tensor-core bound is
// 7.85 ms and the exp2 floor 7.25 ms, nearly equal, so the softmax has to
// run almost wholly under the products. What this design does:
//   1. tensor cores: wgmma, S = Q K^T as m64n128k16 with both operands read
//      from shared memory (K-major; D / 16 k-steps), O += P V with P in
//      registers (the f32 accumulator layout of S, packed to bf16, is wgmma's
//      A-fragment layout) and V read as an MN-major operand (the transpose
//      bit set): m64n128k16 at D = 128, m64n64k16 at D = 64;
//   2. no fragment loads: wgmma reads Q, K and V from shared memory through
//      descriptors of the 128-byte swizzled layout TMA writes (a 64-column
//      box is one 128-byte row: two boxes a row at D = 128, one at D = 64);
//   3. loads overlap compute: one producer thread issues TMA loads into a
//      ring of K/V stages guarded by mbarriers (K and V on separate
//      barriers); no __syncthreads in the loop. FA3's two schedules keep
//      the tensor cores busy through the softmax: inside each consumer
//      warpgroup, tile j's Q K^T and tile j-1's P V are issued together and
//      tile j's softmax runs while that P V completes (intra-warpgroup
//      overlap), and the consumer warpgroups take turns issuing on named
//      barriers (a ring), so one's softmax runs under the others' products;
//   4. RoPE is a pre-pass (flash_fwd_sm90_rope_kernel) that rotates q and k
//      once into contiguous bf16 buffers, with the arithmetic of an in-loop
//      rotation (f32 products and sums rounded to nearest, one rounding to
//      bf16), so the rotated values are bit-identical to it;
//   5. D = 128: 128 query rows per CTA (two consumer warpgroups of 64 rows,
//      each with 240 registers through setmaxnreg), 128-key tiles, 3 stages.
//      D = 64 spends what the narrower rows free (an O accumulator of 32
//      registers, 16 KB tiles) on a third consumer warpgroup: 192 query rows
//      per CTA, so each K/V tile read from L2 feeds 1.5 times the rows, and
//      each warpgroup's softmax runs under two others' products (160
//      registers each through setmaxnreg, no spills); 4 K/V stages (152 KB);
//      the softmax scale is folded into the exp2's FMA. On an H100 SXM at
//      700 W at CogVideoX's shape this ran 14.4 ms against 17.0-17.2 ms
//      with two warpgroups; 5 or 6 stages moved it by under 2%, 2 stages
//      cost 7% (kernels/compare_fwd_sm90.py --variant builds and times them).
// Rows past S are zero-filled by TMA; only the last key tile is masked, and
// only when kv_end % 128 != 0. The epilogue stages bf16 out in the Q tile's
// shared memory and writes it with a TMA store, which clips rows past Sq.
//
// The other head dims. D = 32, 40, 80, 88, 160 run the same kernel on tiles
// of DP = D rounded up to whole 64-column boxes (64, 128, 192): each map is
// the 4-D tensor (D, N, S, B) with the true D as a dimension of its own, so a
// box's columns past D read as TMA's zeros (never the next head's) and a
// store clips them. Zero columns add exact zeros to Q K^T, which runs only
// the ceil(D / 16) k-steps that hold the head dim (3 of 4 at D = 40, 6 of 8
// at D = 88); zero columns of V give output columns that are never stored.
// D = 32 / 40 take D64's tiles (3 warpgroups, 4 stages), 80 / 88 D128's (2
// warpgroups, 3 stages; the scale folded in), 160 192-column tiles of 64
// keys (Q 48 KB + 3 stages of 48 KB; P V as m64n128 + m64n64; 168
// registers, no spills). Short sequences (Sq, Sk <= 16) at those five head
// dims take flash_fwd_sm90_short_kernel, and D = 384 / 512
// flash_fwd_sm90_wide_kernel (each described where it is defined).

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBoxCols = 64;  // one 128-byte swizzled row holds 64 bf16
constexpr uint32_t kRowBytes = 128;

// D: head dim (a multiple of 16 or of 8; the tiles are DP = D rounded up to
// whole 64-column boxes); WG: consumer warpgroups of 64 query rows; STAGES:
// K/V ring depth; FUSED: the softmax scale folded into the exp2's FMA; BN:
// keys per tile (128, or 64 where a 192-column K/V stage would not fit)
template <int D, int WG, int STAGES, bool FUSED, int BN = 128>
struct FwdCfg {
  static constexpr int kD = D;
  static constexpr int kDP = (D + kBoxCols - 1) / kBoxCols * kBoxCols;
  static constexpr int kQkSteps = (D + 15) / 16;  // k-steps of Q K^T: the rest of DP is zeros
  static constexpr int kWG = WG;
  static constexpr int kBM = 64 * WG;  // query rows per CTA
  static constexpr int kBN = BN;       // keys per tile
  static constexpr int kStages = STAGES;
  static constexpr bool kFused = FUSED;
  static constexpr int kThreads = 128 * (WG + 1);  // the last warpgroup produces
  static constexpr int kConsumers = 128 * WG;
  static constexpr int kBoxes = kDP / kBoxCols;  // 64-column boxes in a row
  static constexpr uint32_t kQBox = kBM * kRowBytes;
  static constexpr uint32_t kKBox = kBN * kRowBytes;  // 16 KB: 128 rows x 64 columns
  static constexpr uint32_t kQBytes = kQBox * kBoxes;
  static constexpr uint32_t kTileBytes = kKBox * kBoxes;
  static constexpr uint32_t kBarBytes = 8 * (3 * kStages + 1);
  static constexpr size_t kSmemBytes = kQBytes + 2 * kStages * kTileBytes + kBarBytes + 1024;
  // registers a thread: setmaxnreg moves them from the producer (24) to the
  // consumers, out of the 64K an SM holds
  static constexpr int kConsumerRegs = WG == 2 ? 240 : 160;
  static_assert(kDP <= 192 && (BN == 128 || BN == 64) && (WG == 2 || WG == 3),
                "unsupported configuration");
  static_assert(kSmemBytes <= 232448, "shared memory");
};

using FwdCfg128 = FwdCfg<128, 2, 3, false>;  // 224 KB of shared memory in all
using FwdCfg64 = FwdCfg<64, 3, 4, true>;     // 152 KB
using FwdCfg32 = FwdCfg<32, 3, 4, true>;     // D64's tiles, 2 k-steps of Q K^T
using FwdCfg40 = FwdCfg<40, 3, 4, true>;     // D64's tiles, 3 k-steps
using FwdCfg80 = FwdCfg<80, 2, 3, true>;     // D128's tiles, 5 k-steps
using FwdCfg88 = FwdCfg<88, 2, 3, true>;     // D128's tiles, 6 k-steps
using FwdCfg160 = FwdCfg<160, 2, 3, true, 64>;  // 192 columns, 64-key tiles: 193 KB

struct Params {
  float* lse;  // (B, N, Sq) contiguous
  long long sq;
  long long kv_end;  // min(kv_len, Sk)
  int n_heads;
  float scale_log2;  // softmax scale * log2(e)
};

// shared-memory map, offsets from a 1024-byte aligned base (the 128-byte
// swizzle repeats every 8 rows of 128 bytes, and wgmma descriptors assume
// atoms that start on that boundary): Q, the K stages, the V stages, the
// mbarriers
template <class C>
__device__ __forceinline__ uint32_t k_tile(uint32_t base, int st) {
  return base + C::kQBytes + C::kTileBytes * st;
}
template <class C>
__device__ __forceinline__ uint32_t v_tile(uint32_t base, int st) {
  return base + C::kQBytes + C::kTileBytes * (C::kStages + st);
}
template <class C>
__device__ __forceinline__ uint32_t bar_full_k(uint32_t base, int st) {
  return base + C::kQBytes + C::kTileBytes * 2 * C::kStages + 8 * st;
}
template <class C>
__device__ __forceinline__ uint32_t bar_full_v(uint32_t base, int st) {
  return bar_full_k<C>(base, C::kStages + st);
}
template <class C>
__device__ __forceinline__ uint32_t bar_empty(uint32_t base, int st) {
  return bar_full_k<C>(base, 2 * C::kStages + st);
}
template <class C>
__device__ __forceinline__ uint32_t bar_q(uint32_t base) {
  return bar_full_k<C>(base, 3 * C::kStages);
}

// ---------------------------------------------------------------------------
// wgmma m64n128k16 and m64n64k16 in inline PTX
// ---------------------------------------------------------------------------

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

// d (64 x 64 f32) += A (64 x 16 bf16, registers) * B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
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
// consumer pieces. Accumulator layout of m64nN (per thread, warp w of the
// warpgroup, lane = 4g + t): d[4j + i] is row 16w + g + 8 * (i >> 1), column
// 8j + 2t + (i & 1).
// ---------------------------------------------------------------------------

// N columns of an accumulator array, from p on, as an array of their own
template <int N>
__device__ __forceinline__ float (&acc_cols(float* p))[N] {
  return *reinterpret_cast<float(*)[N]>(p);
}

// S = Q K^T: this warpgroup's 64 query rows against a key tile, over the
// k-steps that hold the head dim's columns (TMA zero-fills the rest of a box)
template <class C>
__device__ __forceinline__ void issue_qk(float (&s)[C::kBN / 2], uint32_t q_rows,
                                         uint32_t k_base) {
#pragma unroll
  for (int kk = 0; kk < C::kQkSteps; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    const uint64_t da = gmma_desc(q_rows + (kk / 4) * C::kQBox + col, 16, 1024);
    const uint64_t db = gmma_desc(k_base + (kk / 4) * C::kKBox + col, 16, 1024);
    if constexpr (C::kBN == 128)
      wgmma_ss(s, da, db, kk > 0);
    else
      wgmma_ss64<0, 0>(s, da, db, kk > 0);
  }
}

// O (64 x N) += P V, N = 64, 128 or 192 (n128 + n64) columns of a V tile
// whose 64-column boxes are `box` bytes apart; `rows` addresses the tile's
// 16-key slice
template <int N>
__device__ __forceinline__ void wgmma_pv(float (&o)[N / 2], const uint32_t (&a)[4],
                                         uint32_t rows, uint32_t box) {
  if constexpr (N == 128) {
    wgmma_rs(o, a, gmma_desc(rows, box, 1024));
  } else if constexpr (N == 64) {
    wgmma_rs64(o, a, gmma_desc(rows, box, 1024));
  } else {
    static_assert(N == 192, "P V width");
    wgmma_rs(acc_cols<64>(o), a, gmma_desc(rows, box, 1024));
    wgmma_rs64(acc_cols<32>(o + 64), a, gmma_desc(rows + 2 * box, box, 1024));
  }
}

// O += P V over a key tile; P's 16-key slice kk is pf[4kk .. 4kk + 3]
template <class C>
__device__ __forceinline__ void issue_pv(float (&o)[C::kDP / 2], const uint32_t (&pf)[C::kBN / 4],
                                         uint32_t v_base) {
#pragma unroll
  for (int kk = 0; kk < C::kBN / 16; ++kk) {
    const uint32_t a[4] = {pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2], pf[4 * kk + 3]};
    wgmma_pv<C::kDP>(o, a, v_base + kk * 16 * kRowBytes, C::kKBox);
  }
}

// online softmax in base 2 on one tile's scores, in place: s becomes
// exp2(x - m_new), m is kept in scaled units; returns the factor that moves
// the running O to m_new. FUSED: the max is taken over the raw scores and
// the scale goes into the exp2's FMA (one rounding, one instruction less a
// score); else each score is scaled first.
template <bool FUSED, int NS>
__device__ __forceinline__ void softmax_tile(float (&s)[NS], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float scale_log2, bool mask,
                                             long long k0, long long kv_end, int t4) {
  if constexpr (!FUSED) {
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] *= scale_log2;
  }
  if (mask) {
#pragma unroll
    for (int i = 0; i < NS; ++i)
      if (k0 + 8 * (i / 4) + 2 * t4 + (i & 1) >= kv_end) s[i] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < NS; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float mu[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mn = quad_max(mx[r]);
    if constexpr (FUSED) mn *= scale_log2;  // the scale is positive: the max commutes
    mn = fmaxf(m[r], mn);
    mu[r] = (mn == -INFINITY) ? 0.f : mn;  // keeps exp2 of masked keys at 0, never NaN
    alpha[r] = ex2(m[r] - mu[r]);
    m[r] = mn;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const float x = FUSED ? fmaf(s[i], scale_log2, -mu[(i >> 1) & 1]) : s[i] - mu[(i >> 1) & 1];
    const float e = ex2(x);
    s[i] = e;
    rs[(i >> 1) & 1] += e;
  }
  l[0] = l[0] * alpha[0] + rs[0];
  l[1] = l[1] * alpha[1] + rs[1];
}

// P rounded to bf16: the accumulators of key groups 2kk and 2kk + 1 are the
// A fragment of the kk-th 16-key step
template <int NS>
__device__ __forceinline__ void pack_p(uint32_t (&pf)[NS / 2], const float (&s)[NS]) {
#pragma unroll
  for (int kk = 0; kk < NS / 8; ++kk) {
    pf[4 * kk + 0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    pf[4 * kk + 1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pf[4 * kk + 2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pf[4 * kk + 3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// The consumer warpgroups take turns issuing their products, so one's
// softmax runs while the others' wgmmas do. Warpgroup wg waits for its turn
// on named barrier 1 + WG + wg (its 128 threads and the previous
// warpgroup's arrival) and hands the turn to the next when its products are
// issued (barriers 1 .. WG are the epilogue's).
template <class C>
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + C::kWG + wg) : "memory");
}
template <class C>
__device__ __forceinline__ void turn_pass(int to_wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + C::kWG + to_wg) : "memory");
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= alpha[(i >> 1) & 1];
}

template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap to, const Params p) {
  constexpr int kStages = C::kStages, kBN = C::kBN, kDP = C::kDP;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) & ~1023u;
  const int q0 = blockIdx.x * C::kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (int)((p.kv_end + kBN - 1) / kBN);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full_k<C>(base, st), 1);
      mbar_init(bar_full_v<C>(base, st), 1);
      mbar_init(bar_empty<C>(base, st), C::kConsumers);
    }
    mbar_init(bar_q<C>(base), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == C::kWG) {
    // producer: one thread keeps the K/V ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == C::kConsumers) {
      mbar_expect_tx(bar_q<C>(base), C::kQBytes);
#pragma unroll
      for (int c = 0; c < C::kBoxes; ++c)
        tma_load(base + c * C::kQBox, &tq, bar_q<C>(base), c * kBoxCols, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        if (j >= kStages) mbar_wait(bar_empty<C>(base, st), ((j / kStages) - 1) & 1);
        const uint32_t fk = bar_full_k<C>(base, st), fv = bar_full_v<C>(base, st);
        mbar_expect_tx(fk, C::kTileBytes);
#pragma unroll
        for (int c = 0; c < C::kBoxes; ++c)
          tma_load(k_tile<C>(base, st) + c * C::kKBox, &tk, fk, c * kBoxCols, h, j * kBN, b);
        mbar_expect_tx(fv, C::kTileBytes);
#pragma unroll
        for (int c = 0; c < C::kBoxes; ++c)
          tma_load(v_tile<C>(base, st) + c * C::kKBox, &tv, fv, c * kBoxCols, h, j * kBN, b);
      }
    }
  } else {
    // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kConsumerRegs));
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
    const uint32_t q_rows = base + wg * 64 * kRowBytes;
    const bool ragged = (p.kv_end % kBN) != 0;
    const int next = C::kWG == 2 ? 1 - wg : (wg + 1) % C::kWG;

    float o[kDP / 2], s[kBN / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
    uint32_t pf[kBN / 4];
#pragma unroll
    for (int i = 0; i < kDP / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) s[i] = 0.f;

    mbar_wait(bar_q<C>(base), 0);
    if (n_tiles > 0) {
      if (wg == 0) turn_pass<C>(0);  // warpgroup 0 takes the first turn
      mbar_wait(bar_full_k<C>(base, 0), 0);
      turn_wait<C>(wg);
      wgmma_fence();
      issue_qk<C>(s, q_rows, k_tile<C>(base, 0));
      wgmma_commit();
      turn_pass<C>(next);
      wgmma_wait<0>();
      fence_regs(s);
      softmax_tile<C::kFused>(s, m, l, alpha, p.scale_log2, ragged && n_tiles == 1, 0,
                              p.kv_end, t4);
      pack_p(pf, s);
      for (int j = 1; j < n_tiles; ++j) {
        const int st = j % kStages, sp = (j - 1) % kStages;
        mbar_wait(bar_full_k<C>(base, st), (j / kStages) & 1);
        mbar_wait(bar_full_v<C>(base, sp), ((j - 1) / kStages) & 1);
        turn_wait<C>(wg);
        wgmma_fence();
        issue_qk<C>(s, q_rows, k_tile<C>(base, st));  // tile j's scores
        wgmma_commit();
        issue_pv<C>(o, pf, v_tile<C>(base, sp));  // tile j-1's values
        wgmma_commit();
        turn_pass<C>(next);
        wgmma_wait<1>();
        fence_regs(s);
        softmax_tile<C::kFused>(s, m, l, alpha, p.scale_log2, ragged && j == n_tiles - 1,
                                (long long)j * kBN, p.kv_end, t4);
        wgmma_wait<0>();
        fence_regs(o);
        mbar_arrive(bar_empty<C>(base, sp));
        rescale(o, alpha);
        pack_p(pf, s);
      }
      const int sl = (n_tiles - 1) % kStages;
      mbar_wait(bar_full_v<C>(base, sl), ((n_tiles - 1) / kStages) & 1);
      wgmma_fence();
      issue_pv<C>(o, pf, v_tile<C>(base, sl));
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
    for (int jn = 0; jn < kDP / 8; ++jn) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + 8 * half;
        const uint32_t addr = q_rows + (jn / 8) * C::kQBox + row * kRowBytes +
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
#pragma unroll
      for (int c = 0; c < C::kBoxes; ++c)
        tma_store(&to, q_rows + c * C::kQBox, c * kBoxCols, h, row0, b);
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
// D = 384 and 512 at one head (the VAE mid-blocks, 4096-16384 tokens): a
// 64 x 512 f32 O is 256 registers a thread, more than a warpgroup has. One
// CTA takes 64 query rows and two consumer warpgroups split O's columns in
// halves (192 or 256). S is not computed twice: warpgroup w multiplies its
// half of the head dim, Q[:, half w] K[:, half w]^T (m64n64 over 12 or 16
// k-steps), the two partial score tiles meet in shared memory (f32, 16 KB
// each, two named barriers a tile) and each warpgroup adds the other's, so
// both hold the same S (f32 addition commutes exactly), run the same
// softmax (the exp2s twice: a tenth of the products' time at D = 512) and
// multiply P by their half of V (m64n128 + m64n128, or + m64n64). So the
// products are the function's own, split evenly, where recomputing Q K^T in
// each warpgroup would cost 1.5 times. 64-key tiles: Q, one K and one V tile
// and the partial scores take 224 KB at D = 512, so K and V have one buffer
// each, refilled by two producer threads of their own as soon as both
// warpgroups are done with it; tile j's Q K^T is issued with tile j-1's
// P V, and the exchange and softmax run while that P V completes. What
// bounds it: the products (4 S^2 D FLOP, 0.556 ms at S16384 on 989 TFLOP/s)
// and, since a CTA holds only 64 query rows, the K and V bytes each CTA
// reads from L2 (128 KB a 64-key tile at D = 512, for 64 rows).
// ---------------------------------------------------------------------------

template <int D>
struct WideCfg {
  static constexpr int kD = D;
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kHalf = D / 2;  // O columns a warpgroup owns
  static constexpr int kHalfBoxes = kBoxes / 2;
  static constexpr int kHalfSteps = kHalf / 16;  // k-steps of a partial Q K^T
  static constexpr int kBM = 64, kBN = 64;
  static constexpr int kThreads = 384, kConsumers = 256;
  static constexpr uint32_t kBox = 64 * kRowBytes;  // 8 KB: 64 rows x 64 columns
  static constexpr uint32_t kTileBytes = kBox * kBoxes;  // Q, K or V
  static constexpr uint32_t kXBytes = 64 * kBN * 4;      // one warpgroup's partial scores
  static constexpr size_t kSmemBytes = 3 * kTileBytes + 2 * kXBytes + 8 * 5 + 1024;
  static_assert(kHalf == 192 || kHalf == 256, "unsupported head dim");
  static_assert(kSmemBytes <= 232448, "shared memory");
};

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// O += P V over this warpgroup's half of a 64-key V tile (v_half: its first
// box)
template <class C>
__device__ __forceinline__ void issue_pv_half(float (&o)[C::kHalf / 2],
                                              const uint32_t (&pf)[C::kBN / 4], uint32_t v_half) {
#pragma unroll
  for (int kk = 0; kk < C::kBN / 16; ++kk) {
    const uint32_t a[4] = {pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2], pf[4 * kk + 3]};
    const uint32_t rows = v_half + kk * 16 * kRowBytes;
    if constexpr (C::kHalf == 256) {
      wgmma_pv<128>(acc_cols<64>(o), a, rows, C::kBox);
      wgmma_pv<128>(acc_cols<64>(o + 64), a, rows + 2 * C::kBox, C::kBox);
    } else {
      wgmma_pv<192>(o, a, rows, C::kBox);
    }
  }
}

template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
    flash_fwd_sm90_wide_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap to, const Params p) {
  constexpr int kBN = C::kBN;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) & ~1023u;
  // Q, K, V, the two partial score tiles, the mbarriers
  const uint32_t q_tile = base, k_tile = base + C::kTileBytes, v_tile = base + 2 * C::kTileBytes;
  const uint32_t x_tiles = base + 3 * C::kTileBytes;
  const uint32_t bar_q = x_tiles + 2 * C::kXBytes, full_k = bar_q + 8, full_v = bar_q + 16,
                 empty_k = bar_q + 24, empty_v = bar_q + 32;
  const int q0 = blockIdx.x * C::kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (int)((p.kv_end + kBN - 1) / kBN);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    mbar_init(full_k, 1);
    mbar_init(full_v, 1);
    mbar_init(empty_k, C::kConsumers);
    mbar_init(empty_v, C::kConsumers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producers: one thread loads Q and the K tiles, one (in another warp)
    // the V tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == C::kConsumers) {
      mbar_expect_tx(bar_q, C::kTileBytes);
#pragma unroll
      for (int c = 0; c < C::kBoxes; ++c)
        tma_load(q_tile + c * C::kBox, &tq, bar_q, c * kBoxCols, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        if (j > 0) mbar_wait(empty_k, (j - 1) & 1);
        mbar_expect_tx(full_k, C::kTileBytes);
#pragma unroll
        for (int c = 0; c < C::kBoxes; ++c)
          tma_load(k_tile + c * C::kBox, &tk, full_k, c * kBoxCols, h, j * kBN, b);
      }
    } else if (threadIdx.x == C::kConsumers + 32) {
      for (int j = 0; j < n_tiles; ++j) {
        if (j > 0) mbar_wait(empty_v, (j - 1) & 1);
        mbar_expect_tx(full_v, C::kTileBytes);
#pragma unroll
        for (int c = 0; c < C::kBoxes; ++c)
          tma_load(v_tile + c * C::kBox, &tv, full_v, c * kBoxCols, h, j * kBN, b);
      }
    }
  } else {
    // consumers: warpgroup wg owns O's columns [wg * D/2, (wg + 1) * D/2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
    const uint32_t half = wg * C::kHalfBoxes * C::kBox;  // offset of this half's boxes
    const uint32_t x_own = x_tiles + wg * C::kXBytes + tid * 4;
    const uint32_t x_other = x_tiles + (1 - wg) * C::kXBytes + tid * 4;
    const bool ragged = (p.kv_end % kBN) != 0;

    float o[C::kHalf / 2], s[kBN / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f},
                                      alpha[2];
    uint32_t pf[kBN / 4];
#pragma unroll
    for (int i = 0; i < C::kHalf / 2; ++i) o[i] = 0.f;

    mbar_wait(bar_q, 0);
    for (int j = 0; j < n_tiles; ++j) {
      mbar_wait(full_k, j & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::kHalfSteps; ++kk) {  // this half's partial scores of tile j
        const uint32_t at = half + (kk / 4) * C::kBox + (kk % 4) * 32;
        wgmma_ss64<0, 0>(s, gmma_desc(q_tile + at, 16, 1024), gmma_desc(k_tile + at, 16, 1024),
                         kk > 0);
      }
      wgmma_commit();
      if (j > 0) {
        // V of tile j-1 is waited for after Q K^T of tile j is issued: a
        // wait before it cost 29% on an H100 SXM at 700 W (D512 S16384,
        // 1.57 against 1.22 ms)
        mbar_wait(full_v, (j - 1) & 1);
        issue_pv_half<C>(o, pf, v_tile + half);
        wgmma_commit();
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      fence_regs(s);
      mbar_arrive(empty_k);
      // the partial scores meet: barrier 1 keeps this write behind the other
      // warpgroup's read of the last tile, barrier 2 the read behind both writes
      if (j > 0) named_sync(1, C::kConsumers);
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i)
        asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(x_own + i * 512), "f"(s[i]) : "memory");
      named_sync(2, C::kConsumers);
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) {
        float x;
        asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x) : "r"(x_other + i * 512) : "memory");
        s[i] += x;
      }
      softmax_tile<true>(s, m, l, alpha, p.scale_log2, ragged && j == n_tiles - 1,
                         (long long)j * kBN, p.kv_end, t4);
      if (j > 0) {
        wgmma_wait<0>();
        fence_regs(o);
        mbar_arrive(empty_v);
        rescale(o, alpha);
      }
      pack_p(pf, s);
    }
    if (n_tiles > 0) {
      mbar_wait(full_v, (n_tiles - 1) & 1);
      wgmma_fence();
      issue_pv_half<C>(o, pf, v_tile + half);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    }

    // epilogue: normalise, stage bf16 in this half's (now unread) Q boxes,
    // TMA-store them
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = quad_sum(l[r]);
      inv[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
    const int r0 = warp * 16 + g;
#pragma unroll
    for (int jn = 0; jn < C::kHalf / 8; ++jn) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = r0 + 8 * hf;
        const uint32_t addr = q_tile + half + (jn / 8) * C::kBox + row * kRowBytes +
                              (((jn % 8) ^ (row & 7)) << 4) + t4 * 4;
        const uint32_t val =
            pack_bf16(o[4 * jn + 2 * hf] * inv[hf], o[4 * jn + 2 * hf + 1] * inv[hf]);
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(val) : "memory");
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_sync(3 + wg, 128);
    if (tid == 0 && q0 < p.sq) {
#pragma unroll
      for (int c = 0; c < C::kHalfBoxes; ++c)
        tma_store(&to, q_tile + half + c * C::kBox, (wg * C::kHalfBoxes + c) * kBoxCols, h, q0,
                  b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
    if (wg == 0 && t4 == 0) {
      float* lrow = p.lse + ((long long)b * p.n_heads + h) * p.sq;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const long long row = q0 + r0 + 8 * hf;
        if (row < p.sq) lrow[row] = lse_of(m[hf], l[hf]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Short sequences, Sq <= 16 and Sk <= 16 (AnimateDiff's temporal attention:
// 16 frames over thousands of (pixel, head) batches), at the head dims that
// are not 64 or 128: a 64-row tile would be 3/4 empty, and the work is bound
// by bytes. So one 64-row tile packs four (batch, head) items of 16 rows
// (16-row TMA boxes stacked in the 128-byte-swizzled tile), and their keys
// make one 64-key tile; warp w of the warpgroup holds item w's rows, so a
// block-diagonal mask (key column / 16 == w) keeps each item to its own
// keys. One warpgroup and one tile a CTA, no ring: the CTAs are small (25
// to 73 KB) and several on an SM hide each other's loads.
// ---------------------------------------------------------------------------

template <int D>
struct ShortCfg {
  static constexpr int kD = D;
  static constexpr int kDP = (D + kBoxCols - 1) / kBoxCols * kBoxCols;
  static constexpr int kQkSteps = (D + 15) / 16;
  static constexpr int kBoxes = kDP / kBoxCols;
  static constexpr int kItems = 4, kItemRows = 16;
  static constexpr uint32_t kItemBox = kItemRows * kRowBytes;  // 2 KB
  static constexpr uint32_t kBox = kItems * kItemBox;          // 64 rows x 64 columns
  static constexpr uint32_t kTileBytes = kBox * kBoxes;
  static constexpr size_t kSmemBytes = 3 * kTileBytes + 8 + 1024;
  static_assert(kDP <= 192, "unsupported head dim");
};

struct ShortParams {
  float* lse;  // (B, N, Sq) contiguous
  long long sq;
  long long kv_end;  // min(kv_len, Sk) <= 16
  long long items;   // B * N
  int n_heads;
  float scale_log2;
};

template <class C>
__global__ void __launch_bounds__(128)
    flash_fwd_sm90_short_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap to, const ShortParams p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) & ~1023u;
  const uint32_t q_tile = base, k_tile = base + C::kTileBytes, v_tile = base + 2 * C::kTileBytes;
  const uint32_t bar = base + 3 * C::kTileBytes;
  const long long item0 = (long long)blockIdx.x * C::kItems;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;

  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar, 3 * C::kTileBytes);  // boxes past the last item read as zeros
#pragma unroll
    for (int it = 0; it < C::kItems; ++it) {
      const int b = (int)((item0 + it) / p.n_heads), h = (int)((item0 + it) % p.n_heads);
#pragma unroll
      for (int c = 0; c < C::kBoxes; ++c) {
        const uint32_t at = c * C::kBox + it * C::kItemBox;
        tma_load(q_tile + at, &tq, bar, c * kBoxCols, h, 0, b);
        tma_load(k_tile + at, &tk, bar, c * kBoxCols, h, 0, b);
        tma_load(v_tile + at, &tv, bar, c * kBoxCols, h, 0, b);
      }
    }
  }
  __syncthreads();
  mbar_wait(bar, 0);

  float s[32];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < C::kQkSteps; ++kk) {
    const uint32_t at = (kk / 4) * C::kBox + (kk % 4) * 32;
    wgmma_ss64<0, 0>(s, gmma_desc(q_tile + at, 16, 1024), gmma_desc(k_tile + at, 16, 1024),
                     kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);

  // one tile: the softmax needs no running max; scale folded into the exp2
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int key = 8 * (i / 4) + 2 * t4 + (i & 1);
    if ((key >> 4) != warp || (key & 15) >= p.kv_end) s[i] = -INFINITY;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  }
  float m[2], mu[2], l[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = quad_max(mx[r]) * p.scale_log2;
    mu[r] = (m[r] == -INFINITY) ? 0.f : m[r];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float e = ex2(fmaf(s[i], p.scale_log2, -mu[(i >> 1) & 1]));
    s[i] = e;
    l[(i >> 1) & 1] += e;
  }
  uint32_t pf[16];
  pack_p(pf, s);

  float o[C::kDP / 2];
#pragma unroll
  for (int i = 0; i < C::kDP / 2; ++i) o[i] = 0.f;
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2], pf[4 * kk + 3]};
    wgmma_pv<C::kDP>(o, a, v_tile + kk * 16 * kRowBytes, C::kBox);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int jn = 0; jn < C::kDP / 8; ++jn) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = r0 + 8 * hf;
      const uint32_t addr = q_tile + (jn / 8) * C::kBox + row * kRowBytes +
                            (((jn % 8) ^ (row & 7)) << 4) + t4 * 4;
      const uint32_t val =
          pack_bf16(o[4 * jn + 2 * hf] * inv[hf], o[4 * jn + 2 * hf + 1] * inv[hf]);
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(val) : "memory");
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int it = 0; it < C::kItems; ++it) {
      if (item0 + it >= p.items) break;
      const int b = (int)((item0 + it) / p.n_heads), h = (int)((item0 + it) % p.n_heads);
#pragma unroll
      for (int c = 0; c < C::kBoxes; ++c)
        tma_store(&to, q_tile + c * C::kBox + it * C::kItemBox, c * kBoxCols, h, 0, b);
    }
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
  if (t4 == 0 && item0 + warp < p.items) {
    float* lrow = p.lse + (item0 + warp) * p.sq;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = g + 8 * hf;
      if (row < p.sq) lrow[row] = lse_of(m[hf], l[hf]);
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

constexpr int kMaxDevices = 64;

// cudaFuncSetAttribute once per kernel and device, not on every launch
inline cudaError_t allow_smem(bool (&done)[kMaxDevices], const void* kernel, size_t bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

// the four maps of one call, boxes of 64 columns and q_rows / kv_rows rows;
// D is the true head dim, so a box's columns past it read as zeros and are
// never written
inline int encode_maps(EncodeTiledFn fn, CUtensorMap (&m)[4], int d, const void* q,
                       const void* k, const void* v, void* out, long long batch,
                       long long n_heads, long long sq, long long sk, const long long* strides,
                       uint32_t q_rows, uint32_t kv_rows, uint32_t out_rows) {
  CUresult r;
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if ((r = encode_map(fn, &m[0], bf, 2, q, d, n_heads, sq, batch, strides + 0, kBoxCols,
                      q_rows)) != CUDA_SUCCESS ||
      (r = encode_map(fn, &m[1], bf, 2, k, d, n_heads, sk, batch, strides + 3, kBoxCols,
                      kv_rows)) != CUDA_SUCCESS ||
      (r = encode_map(fn, &m[2], bf, 2, v, d, n_heads, sk, batch, strides + 6, kBoxCols,
                      kv_rows)) != CUDA_SUCCESS ||
      (r = encode_map(fn, &m[3], bf, 2, out, d, n_heads, sq, batch, strides + 9, kBoxCols,
                      out_rows)) != CUDA_SUCCESS)
    return kEncodeFailed + (int)r;
  return 0;
}

inline Params make_params(float* lse, long long n_heads, long long sq, long long sk,
                          long long kv_len, float scale) {
  Params p;
  p.lse = lse;
  p.sq = sq;
  p.kv_end = kv_len < sk ? kv_len : sk;
  if (p.kv_end < 0) p.kv_end = 0;
  p.n_heads = (int)n_heads;
  p.scale_log2 = scale * kLog2e;
  return p;
}

#define SVI_FWD_PARAMS                                                                        \
  EncodeTiledFn fn, const void *q, const void *k, const void *v, void *out, float *lse,       \
      long long batch, long long n_heads, long long sq, long long sk, long long kv_len,       \
      float scale, const long long *strides, cudaStream_t stream
#define SVI_FWD_ARGS fn, q, k, v, out, lse, batch, n_heads, sq, sk, kv_len, scale, strides, st

template <class C>
int launch(SVI_FWD_PARAMS) {
  CUtensorMap m[4];
  if (const int e = encode_maps(fn, m, C::kD, q, k, v, out, batch, n_heads, sq, sk, strides,
                                C::kBM, C::kBN, 64))
    return e;
  const Params p = make_params(lse, n_heads, sq, sk, kv_len, scale);
  static bool ready[kMaxDevices];
  cudaError_t err = allow_smem(ready, (const void*)flash_fwd_sm90_kernel<C>, C::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((sq + C::kBM - 1) / C::kBM), (unsigned)n_heads, (unsigned)batch);
  flash_fwd_sm90_kernel<C><<<grid, C::kThreads, C::kSmemBytes, stream>>>(m[0], m[1], m[2], m[3],
                                                                         p);
  return (int)cudaGetLastError();
}

template <class C>
int launch_wide(SVI_FWD_PARAMS) {
  CUtensorMap m[4];
  if (const int e = encode_maps(fn, m, C::kD, q, k, v, out, batch, n_heads, sq, sk, strides,
                                C::kBM, C::kBN, C::kBM))
    return e;
  const Params p = make_params(lse, n_heads, sq, sk, kv_len, scale);
  static bool ready[kMaxDevices];
  cudaError_t err =
      allow_smem(ready, (const void*)flash_fwd_sm90_wide_kernel<C>, C::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((sq + C::kBM - 1) / C::kBM), (unsigned)n_heads, (unsigned)batch);
  flash_fwd_sm90_wide_kernel<C><<<grid, C::kThreads, C::kSmemBytes, stream>>>(m[0], m[1], m[2],
                                                                              m[3], p);
  return (int)cudaGetLastError();
}

template <class C>
int launch_short(SVI_FWD_PARAMS) {
  CUtensorMap m[4];
  if (const int e = encode_maps(fn, m, C::kD, q, k, v, out, batch, n_heads, sq, sk, strides,
                                C::kItemRows, C::kItemRows, C::kItemRows))
    return e;
  const Params base = make_params(lse, n_heads, sq, sk, kv_len, scale);
  ShortParams p;
  p.lse = lse;
  p.sq = sq;
  p.kv_end = base.kv_end;
  p.items = batch * n_heads;
  p.n_heads = (int)n_heads;
  p.scale_log2 = base.scale_log2;
  static bool ready[kMaxDevices];
  cudaError_t err =
      allow_smem(ready, (const void*)flash_fwd_sm90_short_kernel<C>, C::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((p.items + C::kItems - 1) / C::kItems);
  flash_fwd_sm90_short_kernel<C><<<grid, 128, C::kSmemBytes, stream>>>(m[0], m[1], m[2], m[3], p);
  return (int)cudaGetLastError();
}

// the head dims of this library (all, or under SVI_GROUP those named by
// -DSVI_D<d>); short sequences (Sq and Sk <= 16) take the packed kernel at
// the head dims that are not 64 or 128
int dispatch(int head_dim, SVI_FWD_PARAMS) {
  const cudaStream_t st = stream;
  const bool short_rows = sq <= 16 && sk <= 16;
  (void)short_rows;
  switch (head_dim) {
#if !defined(SVI_GROUP) || defined(SVI_D128)
    case 128: return launch<FwdCfg128>(SVI_FWD_ARGS);
#endif
#if !defined(SVI_GROUP) || defined(SVI_D64)
    case 64: return launch<FwdCfg64>(SVI_FWD_ARGS);
#endif
#if !defined(SVI_GROUP) || defined(SVI_D32)
    case 32:
      return short_rows ? launch_short<ShortCfg<32>>(SVI_FWD_ARGS)
                        : launch<FwdCfg32>(SVI_FWD_ARGS);
#endif
#if !defined(SVI_GROUP) || defined(SVI_D40)
    case 40:
      return short_rows ? launch_short<ShortCfg<40>>(SVI_FWD_ARGS)
                        : launch<FwdCfg40>(SVI_FWD_ARGS);
#endif
#if !defined(SVI_GROUP) || defined(SVI_D80)
    case 80:
      return short_rows ? launch_short<ShortCfg<80>>(SVI_FWD_ARGS)
                        : launch<FwdCfg80>(SVI_FWD_ARGS);
#endif
#if !defined(SVI_GROUP) || defined(SVI_D88)
    case 88:
      return short_rows ? launch_short<ShortCfg<88>>(SVI_FWD_ARGS)
                        : launch<FwdCfg88>(SVI_FWD_ARGS);
#endif
#if !defined(SVI_GROUP) || defined(SVI_D160)
    case 160:
      return short_rows ? launch_short<ShortCfg<160>>(SVI_FWD_ARGS)
                        : launch<FwdCfg160>(SVI_FWD_ARGS);
#endif
#if !defined(SVI_GROUP) || defined(SVI_D384)
    case 384: return launch_wide<WideCfg<384>>(SVI_FWD_ARGS);
#endif
#if !defined(SVI_GROUP) || defined(SVI_D512)
    case 512: return launch_wide<WideCfg<512>>(SVI_FWD_ARGS);
#endif
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out: bf16 (B, S, N, head_dim) views, head_dim 32, 40, 64, 80, 88,
// 128, 160, 384 or 512 (those of this library); strides: 12 element strides,
// (b, s, n) for q, k, v, out in that order. Returns 0 when the kernel was
// launched, a cudaError_t value (cudaErrorInvalidValue for a head dim this
// library does not hold), kNoEncodeEntry, or kEncodeFailed + the CUresult of
// the tensor-map encode that failed.
extern "C" int svi_flash_fwd_sm90(int head_dim, const void* q, const void* k, const void* v,
                                  void* out, float* lse, long long batch, long long n_heads,
                                  long long sq, long long sk, long long kv_len, float scale,
                                  const long long* strides, void* stream) {
  if (batch == 0 || n_heads == 0 || sq == 0) return (int)cudaSuccess;
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kNoEncodeEntry;
  return dispatch(head_dim, fn, q, k, v, out, lse, batch, n_heads, sq, sk, kv_len, scale,
                  strides, reinterpret_cast<cudaStream_t>(stream));
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
