// Split flash-attention backward for Hopper (sm_90a), bf16, head dim 128:
// TMA-fed wgmma with warp specialisation. Plain C interface.
//
// Replaces the Pallas TPU kernels svi_tpu/ops/attention.py::
// _bwd_dq_kernel_flat (K5a) and _bwd_dkv_kernel_flat (K5b), launched by
// _flash_bwd_pallas_flat: the backward of non-causal attention where the
// one-pass K4 is not taken -- the DiT's text and image cross-attention in
// training (Sq 9360 against Sk 512 / 257) and self-attention below K4's gate.
// With P = exp(S * scale - lse) recomputed from the forward's base-e lse and
// delta = rowsum(dO * O):
//   dP = dO V^T, dS = P * (dP - delta), dV = P^T dO, dK = scale dS^T Q,
//   dQ = scale dS K.
// q, k (rotated by the caller's RoPE pre-pass when the forward used RoPE, as
// K4's are; the TPU kernels rotate inside, the same arithmetic), v and dO are
// read through (B, S, N, D) element strides; dq, dk and dv are written
// contiguous (B, S, N*D) bf16, dq and dk rotated back by -theta when tables
// are given. lse * log2(e) and delta come from flash_bwd_prep_kernel (below),
// run once per backward for both kernels, padded with +inf and 0 to a
// multiple of 128 rows, so that queries past Sq get P = 0 with no mask. P and
// dS are rounded to bf16 before the products that consume them, as the
// forward rounds P.
//
// What bounds them on this card: the products at the bf16 tensor-core rate,
// 3 of Sq x Sk x 128 per head for dq (S, dP, dQ) and 4 for dk / dv (S, dP,
// dV, dK): 0.149 and 0.198 ms at the text cross-attention shape (N 40); the
// bytes of q, dO and dq come next. The mma.sync kernels they replace
// (flash_bwd.cu's D = 128 instantiations, removed) ran 14x and 22x above
// those bounds: fragments by plain loads, no double buffering, a
// __syncthreads around every tile, and 320 CTAs of 128 threads for dk / dv
// at Sk 512, each walking all 9360 queries. This design:
//   1. dq (flash_bwd_dq_kernel): one CTA per (128 query rows, head, batch),
//      2960 CTAs at Sq 9360, N 40. Its Q and dO tiles, lse and delta are
//      loaded once by TMA; one producer thread streams 64-key K / V tiles
//      through a 4-stage mbarrier ring. Two consumer warpgroups of 64 rows
//      compute S = Q K^T and dP = dO V^T by wgmma m64n64k16 from swizzled
//      shared memory, P and dS in registers, and dQ += dS K by wgmma
//      m64n128k16 with dS as the register A operand and K as an MN-major B
//      operand (the forward's V descriptor). dQ stays in f32 registers for
//      the whole pass, so no sum crosses CTAs and dq is deterministic; the
//      epilogue scales it, rotates it back, rounds it and stores it by TMA.
//      64-key tiles keep S, dP and dQ within the registers of a thread.
//   2. dk / dv (flash_bwd_dkv_kernel): K4's structure (flash_bwd_sm90.cu)
//      without its dQ stage. One CTA per (128-key tile, head, batch, query
//      chunk); K and V loaded once, 64-row Q / dO tiles streamed through a
//      4-stage ring. S^T = K Q^T and dP^T = V dO^T keep keys as rows, so P^T
//      and dS^T are the register A operands of dV += P^T dO and dK += dS^T Q
//      (dO and Q MN-major). The query axis is cut into chunks so that the
//      grid fills the card: Sk 512 alone gives 4 key tiles x 40 heads = 160
//      CTAs for 132 SMs. The host takes the fewest chunks that make at least
//      two waves with the last one 90% full (3 at Sk 512 and at Sk 257: 480
//      and 360 CTAs), each chunk at least 8 query steps. Each CTA's dK and dV
//      are then partial sums: staged in shared memory and added into f32
//      (B, Sk, N, D) buffers by TMA reduce-adds (cp.reduce.async.bulk.tensor
//      ... add); finalize_grad_kernel scales dk, rotates it back and rounds
//      both to bf16. The order of those f32 sums changes from run to run, so
//      dk and dv can differ in their last bits between two runs.
// Both run two consumer warpgroups with 240 registers a thread (setmaxnreg)
// beside a producer warpgroup with 24: with 168, K5b's dK, dV, S^T and dP^T
// spill.
// Ragged edges: rows past Sq / Sk are zero-filled by TMA and never stored.
// Keys past Sk get P = 0, masked in the last key tile only; in dk / dv a
// warpgroup whose 64 keys all lie past Sk does no work. At Sk 257 one live
// key spills into the last tile: dq computes 5 key tiles of 64 for 4.02 of
// keys and dk / dv 2.5 tiles of 128 for 2.01, 25% more work in each, which
// this design accepts (a narrower last tile would need another wgmma shape).

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kD = 128;
constexpr int kBoxCols = 64;   // one 128-byte swizzled row holds 64 bf16
constexpr int kThreads = 384;  // warpgroups 0 and 1 consume, warpgroup 2 produces
constexpr int kConsumers = 256;
constexpr int kStages = 4;
constexpr int kRows = 128;     // lse2 / delta are padded to a multiple of this

struct Params {
  const float* lse2;   // (B, N, sq_pad) lse * log2(e), +inf past Sq
  const float* delta;  // (B, N, sq_pad) rowsum(dO * O), 0 past Sq
  const float* cos;    // (>= max(Sq, Sk), 64) or null: dq / dk are rotated back
  const float* sin;
  long long sq, sk, sq_pad;
  int n_heads;
  int n_chunks;        // dk / dv: query chunks per key tile
  float scale;         // softmax scale
  float scale_log2;    // scale * log2(e)
};

__device__ __forceinline__ uint32_t aligned_base(unsigned char* smem_raw) {
  return (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) & ~1023u;
}

// ---------------------------------------------------------------------------
// dq (K5a). Accumulator layout of m64nN (warp w of the warpgroup, lane =
// 4g + t4): d[4j + i] is row 16w + g + 8 (i >> 1), column 8j + 2t4 + (i & 1).
// ---------------------------------------------------------------------------

namespace k5a {
constexpr int kBM = 128;                  // query rows per CTA
constexpr int kBN = 64;                   // keys per tile
constexpr uint32_t kQBox = kBM * 128;     // 16 KB: 128 rows x 64 columns
constexpr uint32_t kQTile = 2 * kQBox;    // 32 KB: a Q or dO tile
constexpr uint32_t kKBox = kBN * 128;     // 8 KB: 64 keys x 64 columns
constexpr uint32_t kKTile = 2 * kKBox;    // 16 KB: a K or V tile
constexpr uint32_t kOffG = kQTile;
constexpr uint32_t kOffStages = 2 * kQTile;                      // K, V per stage
constexpr uint32_t kOffVec = kOffStages + kStages * 2 * kKTile;  // lse2, delta
constexpr uint32_t kOffBar = kOffVec + 2 * kBM * 4;              // full, empty, q
constexpr size_t kSmemBytes = kOffBar + 8 * (2 * kStages + 1) + 1024;
static_assert(kSmemBytes <= 232448, "shared memory of one CTA");
}  // namespace k5a

__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tg,
                        const __grid_constant__ CUtensorMap tdq, const Params p) {
  using namespace k5a;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = aligned_base(smem_raw);
  const float* vec = reinterpret_cast<const float*>(
      smem_raw + (base - static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw))) + kOffVec);
  const int q0 = blockIdx.x * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (int)((p.sk + kBN - 1) / kBN);
  const int wg = threadIdx.x / 128;
  const uint32_t bar_q = base + kOffBar + 8 * 2 * kStages;
  auto bar_full = [&](int st) { return base + kOffBar + 8 * st; };
  auto bar_empty = [&](int st) { return base + kOffBar + 8 * (kStages + st); };
  auto k_tile = [&](int st) { return base + kOffStages + st * 2 * kKTile; };

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full(st), 1);
      mbar_init(bar_empty(st), kConsumers);
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread loads Q, dO, lse2 and delta once and keeps the
    // K / V ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      const long long vec_row = ((long long)b * p.n_heads + h) * p.sq_pad + q0;
      mbar_expect_tx(bar_q, 2 * kQTile + 2 * kBM * 4);
      tma_load(base, &tq, bar_q, 0, h, q0, b);
      tma_load(base + kQBox, &tq, bar_q, kBoxCols, h, q0, b);
      tma_load(base + kOffG, &tg, bar_q, 0, h, q0, b);
      tma_load(base + kOffG + kQBox, &tg, bar_q, kBoxCols, h, q0, b);
      bulk_load(base + kOffVec, p.lse2 + vec_row, kBM * 4, bar_q);
      bulk_load(base + kOffVec + kBM * 4, p.delta + vec_row, kBM * 4, bar_q);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        if (j >= kStages) mbar_wait(bar_empty(st), ((j / kStages) - 1) & 1);
        const uint32_t full = bar_full(st), kt = k_tile(st);
        mbar_expect_tx(full, 2 * kKTile);
        tma_load(kt, &tk, full, 0, h, j * kBN, b);
        tma_load(kt + kKBox, &tk, full, kBoxCols, h, j * kBN, b);
        tma_load(kt + kKTile, &tv, full, 0, h, j * kBN, b);
        tma_load(kt + kKTile + kKBox, &tv, full, kBoxCols, h, j * kBN, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const uint32_t q_rows = base + wg * 64 * 128;
  const uint32_t g_rows = base + kOffG + wg * 64 * 128;
  const int row = wg * 64 + warp * 16 + g;  // this thread's rows row and row + 8 of the CTA
  const bool ragged = (p.sk % kBN) != 0;

  float dqa[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dqa[i] = 0.f;

  mbar_wait(bar_q, 0);
  const float lq[2] = {vec[row], vec[row + 8]};
  const float dl[2] = {vec[kBM + row], vec[kBM + row + 8]};
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages;
    const uint32_t kt = k_tile(st);
    mbar_wait(bar_full(st), (j / kStages) & 1);

    // S = Q K^T and dP = dO V^T: 64 rows x 64 keys
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
    issue_scores(s, q_rows, kQBox, kt, kKBox);
    wgmma_commit();
    issue_scores(dp, g_rows, kQBox, kt + kKTile, kKBox);
    wgmma_commit();

    // S is done, and so is the previous tile's dQ product: its stage is free
    wgmma_wait<1>();
    fence_regs(s);
    if (j > 0) mbar_arrive(bar_empty((j - 1) % kStages));
    // P = exp2(S scale log2(e) - lse log2(e)); keys past Sk get 0
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = ex2(s[i] * p.scale_log2 - lq[(i >> 1) & 1]);
    if (ragged && j == n_tiles - 1) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (j * kBN + 8 * (i / 4) + 2 * t4 + (i & 1) >= p.sk) s[i] = 0.f;
    }
    // dS = P (dP - delta)
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - dl[(i >> 1) & 1]);
    uint32_t df[16];
    pack_a(df, dp);

    // dQ += dS K: K as the MN-major B operand (keys x 128)
    wgmma_fence();
    issue_rs(dqa, df, kt, kKBox);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(dqa);

  // epilogue: scale, rotate back, round, stage in this warpgroup's (now
  // unread) Q rows in the swizzled layout, TMA-store (rows past Sq clipped)
#pragma unroll
  for (int jn = 0; jn < kD / 8; ++jn) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = warp * 16 + g + 8 * half;  // row within the warpgroup
      const long long pos = (long long)q0 + wg * 64 + r;
      float x0 = dqa[4 * jn + 2 * half] * p.scale, x1 = dqa[4 * jn + 2 * half + 1] * p.scale;
      if (p.cos != nullptr && pos < p.sq)
        rotate_back(x0, x1, p.cos[pos * (kD / 2) + 4 * jn + t4],
                    p.sin[pos * (kD / 2) + 4 * jn + t4]);
      const uint32_t addr = q_rows + (jn / 8) * kQBox + swizzle128(r, jn % 8) + t4 * 4;
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(pack_bf16(x0, x1)) : "memory");
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  if (tid == 0 && q0 + wg * 64 < p.sq) {
    tma_store(&tdq, q_rows, 0, h, q0 + wg * 64, b);
    tma_store(&tdq, q_rows + kQBox, kBoxCols, h, q0 + wg * 64, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// dk / dv (K5b)
// ---------------------------------------------------------------------------

namespace k5b {
constexpr int kBN = 128;                  // keys per CTA: two warpgroups of 64
constexpr int kBM = 64;                   // query rows per step
constexpr int kMinSteps = 8;              // query steps per chunk, at least
constexpr uint32_t kKBox = kBN * 128;     // 16 KB: 128 keys x 64 columns
constexpr uint32_t kKTile = 2 * kKBox;    // 32 KB: a K or V tile
constexpr uint32_t kQBox = kBM * 128;     // 8 KB: 64 query rows x 64 columns
constexpr uint32_t kQTile = 2 * kQBox;    // 16 KB: a Q or dO tile
constexpr uint32_t kVecBytes = kBM * 4;   // 256 B: a slice of lse2 or delta
constexpr uint32_t kAccBox = 64 * 128;    // 8 KB: 64 keys x 32 f32 columns
constexpr uint32_t kAccWg = 8 * kAccBox;  // 64 KB: one warpgroup's dK and dV
constexpr uint32_t kOffV = kKTile;
constexpr uint32_t kOffStages = 2 * kKTile;                      // Q, dO per stage
constexpr uint32_t kOffVec = kOffStages + kStages * 2 * kQTile;  // lse2, delta per stage
constexpr uint32_t kOffBar = kOffVec + kStages * 2 * kVecBytes;  // full, empty, kv
constexpr size_t kSmemBytes = kOffBar + 8 * (2 * kStages + 1) + 1024;
static_assert(kSmemBytes <= 232448, "shared memory of one CTA");
static_assert(2 * kAccWg <= kOffVec, "the dK / dV staging reuses the K, V and Q / dO tiles");
}  // namespace k5b

// one warpgroup's 64 x 128 f32 accumulator into four 128-byte-swizzled
// 32-column boxes at dst; d[4j + i] is row 16 warp + g + 8 (i >> 1), column
// 8j + 2t4 + (i & 1)
__device__ __forceinline__ void stage_f32(uint32_t dst, const float (&d)[64], int warp, int g,
                                          int t4) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = warp * 16 + g + 8 * half;
      const int col = 8 * j + 2 * t4;
      const uint32_t addr = dst + (col / 32) * k5b::kAccBox + swizzle128(row, (col % 32) / 4) +
                            (col % 4) * 4;
      asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(d[4 * j + 2 * half]),
                   "f"(d[4 * j + 2 * half + 1])
                   : "memory");
    }
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tg,
                         const __grid_constant__ CUtensorMap tdk,
                         const __grid_constant__ CUtensorMap tdv, const Params p) {
  using namespace k5b;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = aligned_base(smem_raw);
  const unsigned char* gbase =
      smem_raw + (base - static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)));
  const int n_kt = (int)((p.sk + kBN - 1) / kBN);
  const int k0 = (blockIdx.x % n_kt) * kBN;
  const int chunk = blockIdx.x / n_kt;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nq = (int)((p.sq + kBM - 1) / kBM);
  const int it0 = (int)((long long)chunk * nq / p.n_chunks);
  const int n_it = (int)((long long)(chunk + 1) * nq / p.n_chunks) - it0;
  const int n_active = k0 + 64 < p.sk ? 2 : 1;  // warpgroups with a live key
  const int wg = threadIdx.x / 128;
  const uint32_t bar_kv = base + kOffBar + 8 * 2 * kStages;
  auto bar_full = [&](int st) { return base + kOffBar + 8 * st; };
  auto bar_empty = [&](int st) { return base + kOffBar + 8 * (kStages + st); };
  auto q_tile = [&](int st) { return base + kOffStages + st * 2 * kQTile; };

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full(st), 1);
      mbar_init(bar_empty(st), 128 * n_active);
    }
    mbar_init(bar_kv, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread loads K and V once and keeps the Q / dO ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(bar_kv, 2 * kKTile);
      tma_load(base, &tk, bar_kv, 0, h, k0, b);
      tma_load(base + kKBox, &tk, bar_kv, kBoxCols, h, k0, b);
      tma_load(base + kOffV, &tv, bar_kv, 0, h, k0, b);
      tma_load(base + kOffV + kKBox, &tv, bar_kv, kBoxCols, h, k0, b);
      const long long vec_row = ((long long)b * p.n_heads + h) * p.sq_pad;
      for (int i = 0; i < n_it; ++i) {
        const int st = i % kStages;
        if (i >= kStages) mbar_wait(bar_empty(st), ((i / kStages) - 1) & 1);
        const uint32_t full = bar_full(st), qt = q_tile(st);
        const int q0 = (it0 + i) * kBM;
        mbar_expect_tx(full, 2 * kQTile + 2 * kVecBytes);
        tma_load(qt, &tq, full, 0, h, q0, b);
        tma_load(qt + kQBox, &tq, full, kBoxCols, h, q0, b);
        tma_load(qt + kQTile, &tg, full, 0, h, q0, b);
        tma_load(qt + kQTile + kQBox, &tg, full, kBoxCols, h, q0, b);
        const uint32_t vec = base + kOffVec + st * 2 * kVecBytes;
        bulk_load(vec, p.lse2 + vec_row + q0, kVecBytes, full);
        bulk_load(vec + kVecBytes, p.delta + vec_row + q0, kVecBytes, full);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns keys k0 + 64 wg .. + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const bool active = wg < n_active && n_it > 0;
  float dk[64], dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;

  if (active) {
    const int kr = wg * 64 + warp * 16 + g;  // this thread's key rows kr and kr + 8 in the tile
    const bool key_ok[2] = {k0 + kr < p.sk, k0 + kr + 8 < p.sk};
    const bool ragged = k0 + kBN > p.sk;
    const uint32_t k_rows = base + wg * 64 * 128;
    const uint32_t v_rows = base + kOffV + wg * 64 * 128;
    mbar_wait(bar_kv, 0);
    for (int i = 0; i < n_it; ++i) {
      const int st = i % kStages;
      const uint32_t qt = q_tile(st), gt = qt + kQTile;
      const float* vec = reinterpret_cast<const float*>(gbase + kOffVec + st * 2 * kVecBytes);
      mbar_wait(bar_full(st), (i / kStages) & 1);

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries
      float s[32], dp[32];
#pragma unroll
      for (int x = 0; x < 32; ++x) s[x] = dp[x] = 0.f;
      wgmma_fence();
      issue_scores(s, k_rows, kKBox, qt, kQBox);
      wgmma_commit();
      issue_scores(dp, v_rows, kKBox, gt, kQBox);
      wgmma_commit();

      // P^T = exp2(S^T scale log2(e) - lse log2(e)); column (query) 8j + 2t4 + (x & 1)
      wgmma_wait<1>();
      fence_regs(s);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 lq = *reinterpret_cast<const float2*>(vec + 8 * j + 2 * t4);
#pragma unroll
        for (int x = 0; x < 4; ++x)
          s[4 * j + x] = ex2(s[4 * j + x] * p.scale_log2 - ((x & 1) ? lq.y : lq.x));
      }
      if (ragged) {
#pragma unroll
        for (int x = 0; x < 32; ++x)
          if (!key_ok[(x >> 1) & 1]) s[x] = 0.f;
      }
      // dS^T = P^T (dP^T - delta)
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(vec + kBM + 8 * j + 2 * t4);
#pragma unroll
        for (int x = 0; x < 4; ++x)
          dp[4 * j + x] = s[4 * j + x] * (dp[4 * j + x] - ((x & 1) ? dl.y : dl.x));
      }
      uint32_t pf[16], df[16];
      pack_a(pf, s);
      pack_a(df, dp);

      // dV += P^T dO, dK += dS^T Q
      wgmma_fence();
      issue_rs(dv, pf, gt, kQBox);
      issue_rs(dk, df, qt, kQBox);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
      mbar_arrive(bar_empty(st));  // Q and dO of this stage are read
    }
  }

  // every product of both warpgroups is done: the tiles' shared memory takes
  // the f32 dK and dV, which one TMA reduce-add per 32-column box adds into
  // the buffers (rows past Sk are skipped)
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  if (!active) return;
  const uint32_t acc = base + wg * kAccWg;
  stage_f32(acc, dk, warp, g, t4);
  stage_f32(acc + 4 * kAccBox, dv, warp, g, t4);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
  if (tid == 0) {
    for (int x = 0; x < 4; ++x) {
      tma_reduce_add(&tdk, acc + x * kAccBox, 32 * x, h, k0 + wg * 64, b);
      tma_reduce_add(&tdv, acc + (4 + x) * kAccBox, 32 * x, h, k0 + wg * 64, b);
    }
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// Prep: lse * log2(e) and delta = rowsum(dO * O) in f32, (B, N, sq_pad),
// padded with +inf and 0. One CTA per (32 rows, head, batch); 16 threads per
// 128-wide row, each reading 16 bytes of dO and of O. Bound by those bytes.
// ---------------------------------------------------------------------------

constexpr int kPrepRows = 32;
constexpr int kPrepThreads = 256;

__global__ void __launch_bounds__(kPrepThreads) flash_bwd_prep_kernel(
    const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ g,
    const float* __restrict__ lse, float* __restrict__ lse2, float* __restrict__ delta,
    long long sq, long long sq_pad, int n_heads, long long osb, long long oss, long long osn,
    long long gsb, long long gss, long long gsn) {
  __shared__ float sums[kPrepRows];
  const int h = blockIdx.y, b = blockIdx.z;
  const long long r0 = (long long)blockIdx.x * kPrepRows;
  const int col = (threadIdx.x % 16) * 8;
  for (int rr = threadIdx.x / 16; rr < kPrepRows; rr += kPrepThreads / 16) {
    const long long r = r0 + rr;
    float acc = 0.f;
    if (r < sq) {
      const uint4 ov = *reinterpret_cast<const uint4*>(o + b * osb + r * oss + h * osn + col);
      const uint4 gv = *reinterpret_cast<const uint4*>(g + b * gsb + r * gss + h * gsn + col);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 a = __bfloat1622float2(o2[i]), c = __bfloat1622float2(g2[i]);
        acc = fmaf(a.x, c.x, acc);
        acc = fmaf(a.y, c.y, acc);
      }
    }
#pragma unroll
    for (int off = 8; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (threadIdx.x % 16 == 0) sums[rr] = acc;
  }
  __syncthreads();
  if (threadIdx.x < kPrepRows && r0 + threadIdx.x < sq_pad) {
    const long long r = r0 + threadIdx.x;
    const long long bh = (long long)b * n_heads + h;
    delta[bh * sq_pad + r] = r < sq ? sums[threadIdx.x] : 0.f;
    lse2[bh * sq_pad + r] = r < sq ? lse[bh * sq + r] * kLog2e : INFINITY;
  }
}

// query chunks per key tile of dk / dv: the fewest that give at least two
// waves of the card's SMs with the last wave 90% full, each chunk at least
// kMinSteps query steps
int pick_chunks(long long ctas, long long n_steps) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long c_max = n_steps / k5b::kMinSteps > 1 ? n_steps / k5b::kMinSteps : 1;
  long long c = 1;
  for (; c < c_max; ++c) {
    const long long n = ctas * c, waves = (n + sms - 1) / sms;
    if (n >= 2 * sms && 10 * n >= 9 * waves * sms) break;
  }
  return (int)c;
}

Params make_params(const float* lse2, const float* delta, const float* cos, const float* sin,
                   long long n_heads, long long sq, long long sk, long long sq_pad,
                   float scale) {
  Params p;
  p.lse2 = lse2;
  p.delta = delta;
  p.cos = cos;
  p.sin = sin;
  p.sq = sq;
  p.sk = sk;
  p.sq_pad = sq_pad;
  p.n_heads = (int)n_heads;
  p.n_chunks = 1;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  return p;
}

}  // namespace

// Common arguments: q, k, v, dO bf16 (B, S, N, 128) views (q and k already
// rotated when the forward used RoPE), read through 12 element strides ((b,
// s, n) for q, k, v, dO in that order); lse2 and delta (B, N, sq_pad) f32
// from svi_flash_bwd_prep, sq_pad a multiple of 128; cos / sin (>= max(Sq,
// Sk), 64) f32 or null. Each returns 0 when its kernels were launched, a
// cudaError_t value, kNoEncodeEntry, or kEncodeFailed + the CUresult of the
// tensor-map encode that failed.

// K5a. dq: contiguous (B, Sq, N*128) bf16.
extern "C" int svi_flash_bwd_split_dq(const void* q, const void* k, const void* v,
                                      const void* g, const float* lse2, const float* delta,
                                      const float* cos, const float* sin, void* dq,
                                      long long batch, long long n_heads, long long sq,
                                      long long sk, long long sq_pad, float scale,
                                      const long long* strides, void* stream) {
  if (batch == 0 || n_heads == 0 || sq == 0) return (int)cudaSuccess;
  if (sq_pad % kRows || sq_pad < sq) return (int)cudaErrorInvalidValue;
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kNoEncodeEntry;
  CUtensorMap tq, tk, tv, tg, tdq;
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const long long dq_strides[3] = {sq * n_heads * kD, n_heads * kD, kD};
  CUresult r;
  if ((r = encode_map(fn, &tq, bf, 2, q, kD, n_heads, sq, batch, strides + 0, kBoxCols,
                      k5a::kBM)) != CUDA_SUCCESS ||
      (r = encode_map(fn, &tk, bf, 2, k, kD, n_heads, sk, batch, strides + 3, kBoxCols,
                      k5a::kBN)) != CUDA_SUCCESS ||
      (r = encode_map(fn, &tv, bf, 2, v, kD, n_heads, sk, batch, strides + 6, kBoxCols,
                      k5a::kBN)) != CUDA_SUCCESS ||
      (r = encode_map(fn, &tg, bf, 2, g, kD, n_heads, sq, batch, strides + 9, kBoxCols,
                      k5a::kBM)) != CUDA_SUCCESS ||
      (r = encode_map(fn, &tdq, bf, 2, dq, kD, n_heads, sq, batch, dq_strides, kBoxCols, 64)) !=
          CUDA_SUCCESS)
    return kEncodeFailed + (int)r;
  const Params p = make_params(lse2, delta, cos, sin, n_heads, sq, sk, sq_pad, scale);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)k5a::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((sq + k5a::kBM - 1) / k5a::kBM), (unsigned)n_heads, (unsigned)batch);
  flash_bwd_dq_kernel<<<grid, kThreads, k5a::kSmemBytes, reinterpret_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, tg, tdq, p);
  return (int)cudaGetLastError();
}

// K5b. dk32, dv32: (B, Sk, N, 128) f32 zeros; dk, dv: contiguous (B, Sk,
// N*128) bf16.
extern "C" int svi_flash_bwd_split_dkv(const void* q, const void* k, const void* v,
                                       const void* g, const float* lse2, const float* delta,
                                       const float* cos, const float* sin, float* dk32,
                                       float* dv32, void* dk, void* dv, long long batch,
                                       long long n_heads, long long sq, long long sk,
                                       long long sq_pad, float scale, const long long* strides,
                                       void* stream) {
  if (batch == 0 || n_heads == 0 || sk == 0) return (int)cudaSuccess;
  if (sq_pad % kRows || sq_pad < sq) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (sq > 0) {
    const EncodeTiledFn fn = encode_tiled();
    if (fn == nullptr) return kNoEncodeEntry;
    CUtensorMap tq, tk, tv, tg, tdk, tdv;
    const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    const long long acc_strides[3] = {sk * n_heads * kD, n_heads * kD, kD};
    CUresult r;
    if ((r = encode_map(fn, &tq, bf, 2, q, kD, n_heads, sq, batch, strides + 0, kBoxCols,
                        k5b::kBM)) != CUDA_SUCCESS ||
        (r = encode_map(fn, &tk, bf, 2, k, kD, n_heads, sk, batch, strides + 3, kBoxCols,
                        k5b::kBN)) != CUDA_SUCCESS ||
        (r = encode_map(fn, &tv, bf, 2, v, kD, n_heads, sk, batch, strides + 6, kBoxCols,
                        k5b::kBN)) != CUDA_SUCCESS ||
        (r = encode_map(fn, &tg, bf, 2, g, kD, n_heads, sq, batch, strides + 9, kBoxCols,
                        k5b::kBM)) != CUDA_SUCCESS ||
        (r = encode_map(fn, &tdk, f32, 4, dk32, kD, n_heads, sk, batch, acc_strides, 32, 64)) !=
            CUDA_SUCCESS ||
        (r = encode_map(fn, &tdv, f32, 4, dv32, kD, n_heads, sk, batch, acc_strides, 32, 64)) !=
            CUDA_SUCCESS)
      return kEncodeFailed + (int)r;
    Params p = make_params(lse2, delta, cos, sin, n_heads, sq, sk, sq_pad, scale);
    const long long n_kt = (sk + k5b::kBN - 1) / k5b::kBN;
    p.n_chunks = pick_chunks(n_kt * n_heads * batch, (sq + k5b::kBM - 1) / k5b::kBM);
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)k5b::kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)(n_kt * p.n_chunks), (unsigned)n_heads, (unsigned)batch);
    flash_bwd_dkv_kernel<<<grid, kThreads, k5b::kSmemBytes, st>>>(tq, tk, tv, tg, tdk, tdv, p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  cudaError_t err = finalize_grad<kD>(dk32, dk, cos, sin, batch, sk, n_heads, scale, st);
  if (err != cudaSuccess) return (int)err;
  return (int)finalize_grad<kD>(dv32, dv, nullptr, nullptr, batch, sk, n_heads, 1.f, st);
}

// o, g: bf16 (B, Sq, N, 128) views with element strides (b, s, n) in
// strides[0..2] and strides[3..5], rows 16-byte aligned; lse: contiguous
// (B, N, Sq) f32; lse2, delta: (B, N, sq_pad) f32 outputs, sq_pad >= Sq.
extern "C" int svi_flash_bwd_prep(const void* o, const void* g, const float* lse, float* lse2,
                                  float* delta, long long batch, long long n_heads, long long sq,
                                  long long sq_pad, const long long* strides, void* stream) {
  if (batch == 0 || n_heads == 0 || sq_pad == 0) return (int)cudaSuccess;
  if (sq_pad < sq) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((sq_pad + kPrepRows - 1) / kPrepRows), (unsigned)n_heads,
                  (unsigned)batch);
  flash_bwd_prep_kernel<<<grid, kPrepThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const __nv_bfloat16*>(o), reinterpret_cast<const __nv_bfloat16*>(g), lse,
      lse2, delta, sq, sq_pad, (int)n_heads, strides[0], strides[1], strides[2], strides[3],
      strides[4], strides[5]);
  return (int)cudaGetLastError();
}
