// One-pass flash-attention backward for Hopper (sm_90a), bf16, head dim 128:
// TMA-fed wgmma with warp specialisation. Plain C interface.
//
// Replaces the Pallas TPU kernel svi_tpu/ops/attention.py::
// _bwd_onepass_kernel_flat (K4, launched by _flash_bwd_onepass_pallas_flat):
// dq, dk and dv of non-causal attention in one pass over key tiles, for long
// self-attention (D = 128, S >= 4096, kv_len == Sk: the DiT's self-attention
// in training). With P = exp(S * scale - lse) recomputed from the forward's
// base-e lse and delta = rowsum(dO * O) (both prepared by the caller):
//   dP = dO V^T, dS = P * (dP - delta), dV = P^T dO, dK = scale dS^T Q,
//   dQ = scale dS K.
// q, k (rotated by the caller when the forward used RoPE: the JAX package
// rotates them outside this kernel too), v and dO are read through (B, S, N,
// D) element strides; dk and dv are written contiguous (B, Sk, N*D) bf16, dk
// rotated back by -theta when tables are given; dq is summed across key tiles
// in an f32 (B, Sq, N, D) buffer, then scaled, rotated back and rounded by
// finalize_grad_kernel (sm90_common.cuh). P and dS are rounded to bf16 before
// the products that consume them, as the forward rounds P.
//
// What bounds it on this card: 5 products of Sq x Sk x 128 per head at the
// bf16 tensor-core rate (4.54 ms at S = 9360, 40 heads). The mma.sync kernel
// it replaces (flash_bwd.cu's one-pass instantiation, removed) ran at 10.8x
// that, with fragments loaded by plain loads, no double buffering, a
// __syncthreads around every 32-row Q tile and one f32 atomicAdd per dq
// element per key tile. This design, FlashAttention-3's backward for D = 128:
//   1. one CTA per (128-key tile, head, batch); its K and V tiles are loaded
//      once by TMA. One producer thread streams 64-row Q and dO tiles with
//      their lse * log2(e) and delta slices through a 2-stage mbarrier ring;
//   2. two consumer warpgroups (240 registers each through setmaxnreg), each
//      owning 64 of the tile's keys: S^T = K Q^T and dP^T = V dO^T by wgmma
//      m64n64k16 from shared memory (K-major), then P^T and dS^T in
//      registers; dV += P^T dO and dK += dS^T Q by wgmma with P^T / dS^T as
//      the register A operand (the f32 accumulator layout, packed to bf16)
//      and dO / Q as the MN-major B operand. dV and dK stay in registers for
//      the whole pass;
//   3. dQ: each warpgroup writes its dS^T rows (bf16, 128-byte swizzled) to a
//      double-buffered shared tile; after a barrier of both warpgroups each
//      computes half of dQ's columns, dQ = dS K over all 128 keys, by wgmma
//      with dS as an MN-major A operand and K as an MN-major B operand. The
//      64 x 64 f32 half goes to shared memory and is added to the f32 dq
//      buffer by one TMA reduce-add per 32-column box
//      (cp.reduce.async.bulk.tensor ... add), instead of 4096 per-thread
//      atomics. The order of those f32 sums changes from run to run.
// Rows past Sq / Sk are zero-filled by TMA; queries past Sq get lse = +inf
// (P = 0) from the caller's padding, keys past Sk get P = 0 in the last key
// tile only, and the TMA reduce skips rows past Sq.

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kD = 128;
constexpr int kBN = 128;       // keys per CTA: two consumer warpgroups of 64
constexpr int kBM = 64;        // query rows per step
constexpr int kStages = 2;     // Q / dO ring depth
constexpr int kThreads = 384;  // warpgroups 0 and 1 consume, warpgroup 2 produces
constexpr int kConsumers = 256;
constexpr int kBoxCols = 64;   // one 128-byte swizzled row holds 64 bf16
constexpr uint32_t kKBox = kBN * 128;      // 16 KB: 128 key rows x 64 columns
constexpr uint32_t kKTile = 2 * kKBox;     // 32 KB: a K or V tile
constexpr uint32_t kQBox = kBM * 128;      // 8 KB: 64 query rows x 64 columns
constexpr uint32_t kQTile = 2 * kQBox;     // 16 KB: a Q or dO tile
constexpr uint32_t kDsTile = kBN * 128;    // 16 KB: dS^T, 128 keys x 64 queries
constexpr uint32_t kDqBox = kBM * 128;     // 8 KB: 64 rows x 32 f32
constexpr uint32_t kDqHalf = 2 * kDqBox;   // 16 KB: one warpgroup's 64 columns of dQ
constexpr uint32_t kVecBytes = kBM * 4;    // 256 B: a slice of lse * log2(e) or delta
// shared-memory map, offsets from a 1024-byte aligned base
constexpr uint32_t kOffV = kKTile;
constexpr uint32_t kOffStages = 2 * kKTile;                      // Q, dO per stage
constexpr uint32_t kOffDs = kOffStages + kStages * 2 * kQTile;   // two dS^T buffers
constexpr uint32_t kOffDq = kOffDs + 2 * kDsTile;                // two dQ halves
constexpr uint32_t kOffVec = kOffDq + 2 * kDqHalf;               // lse, delta per stage
constexpr uint32_t kOffBar = kOffVec + kStages * 2 * kVecBytes;  // full, empty, kv
constexpr size_t kSmemBytes = kOffBar + 8 * (2 * kStages + 1) + 1024;
static_assert(kSmemBytes <= 232448, "shared memory of one CTA");

struct Params {
  const float* lse2;   // (B, N, Sq_pad) lse * log2(e), +inf past Sq
  const float* delta;  // (B, N, Sq_pad) rowsum(dO * O), 0 past Sq
  const float* cos;    // (>= Sk, 64) or null: dk is rotated back
  const float* sin;
  __nv_bfloat16* dk;   // (B, Sk, N*D)
  __nv_bfloat16* dv;
  long long sq, sk, sq_pad;
  int n_heads;
  float scale;         // softmax scale
  float scale_log2;    // scale * log2(e)
};

__device__ __forceinline__ uint32_t q_tile(uint32_t base, int st) {
  return base + kOffStages + st * 2 * kQTile;
}
__device__ __forceinline__ uint32_t g_tile(uint32_t base, int st) {
  return q_tile(base, st) + kQTile;
}
__device__ __forceinline__ uint32_t bar_full(uint32_t base, int st) {
  return base + kOffBar + 8 * st;
}
__device__ __forceinline__ uint32_t bar_empty(uint32_t base, int st) {
  return bar_full(base, kStages + st);
}
__device__ __forceinline__ uint32_t bar_kv(uint32_t base) { return bar_full(base, 2 * kStages); }

__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tg,
                          const __grid_constant__ CUtensorMap tdq, const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) & ~1023u;
  const unsigned char* gbase =
      smem_raw + (base - static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)));
  const int k0 = blockIdx.x * kBN;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nq = (int)((p.sq + kBM - 1) / kBM);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full(base, st), 1);
      mbar_init(bar_empty(base, st), kConsumers);
    }
    mbar_init(bar_kv(base), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread loads K and V once and keeps the Q / dO ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(bar_kv(base), 2 * kKTile);
      tma_load(base, &tk, bar_kv(base), 0, h, k0, b);
      tma_load(base + kKBox, &tk, bar_kv(base), kBoxCols, h, k0, b);
      tma_load(base + kOffV, &tv, bar_kv(base), 0, h, k0, b);
      tma_load(base + kOffV + kKBox, &tv, bar_kv(base), kBoxCols, h, k0, b);
      const long long vec_row = ((long long)b * p.n_heads + h) * p.sq_pad;
      for (int it = 0; it < nq; ++it) {
        const int st = it % kStages;
        if (it >= kStages) mbar_wait(bar_empty(base, st), ((it / kStages) - 1) & 1);
        const uint32_t full = bar_full(base, st);
        const int q0 = it * kBM;
        mbar_expect_tx(full, 2 * kQTile + 2 * kVecBytes);
        tma_load(q_tile(base, st), &tq, full, 0, h, q0, b);
        tma_load(q_tile(base, st) + kQBox, &tq, full, kBoxCols, h, q0, b);
        tma_load(g_tile(base, st), &tg, full, 0, h, q0, b);
        tma_load(g_tile(base, st) + kQBox, &tg, full, kBoxCols, h, q0, b);
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
  const int kr = wg * 64 + warp * 16 + g;  // this thread's key rows kr and kr + 8 in the tile
  const bool key_ok[2] = {k0 + kr < p.sk, k0 + kr + 8 < p.sk};
  const bool ragged = k0 + kBN > p.sk;
  const uint32_t k_rows = base + wg * 64 * 128;
  const uint32_t v_rows = base + kOffV + wg * 64 * 128;
  const uint32_t dq_half = base + kOffDq + wg * kDqHalf;

  float dk[64], dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(bar_kv(base), 0);
  for (int it = 0; it < nq; ++it) {
    const int st = it % kStages;
    const uint32_t qt = q_tile(base, st), gt = g_tile(base, st);
    const float* vec = reinterpret_cast<const float*>(gbase + kOffVec + st * 2 * kVecBytes);
    mbar_wait(bar_full(base, st), (it / kStages) & 1);

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
    issue_scores(s, k_rows, kKBox, qt, kQBox);
    wgmma_commit();
    issue_scores(dp, v_rows, kKBox, gt, kQBox);
    wgmma_commit();

    // P^T = exp2(S^T scale log2(e) - lse log2(e)); column (query) 8j + 2t4 + (i & 1)
    wgmma_wait<1>();
    fence_regs(s);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 lq = *reinterpret_cast<const float2*>(vec + 8 * j + 2 * t4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[4 * j + i] = ex2(s[4 * j + i] * p.scale_log2 - ((i & 1) ? lq.y : lq.x));
    }
    if (ragged) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (!key_ok[(i >> 1) & 1]) s[i] = 0.f;
    }
    // dS^T = P^T (dP^T - delta)
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 dl = *reinterpret_cast<const float2*>(vec + kBM + 8 * j + 2 * t4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dp[4 * j + i] = s[4 * j + i] * (dp[4 * j + i] - ((i & 1) ? dl.y : dl.x));
    }
    uint32_t pf[16], df[16];
    pack_a(pf, s);
    pack_a(df, dp);

    // dS^T rows of this warpgroup into the shared tile (keys x queries,
    // 128-byte swizzled): the A operand of dQ = dS K, MN-major
    const uint32_t ds = base + kOffDs + (it & 1) * kDsTile;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = kr + 8 * half;
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(ds + swizzle128(row, j) + 4 * t4),
                     "r"(df[2 * j + half])
                     : "memory");
      }

    // dV += P^T dO, dK += dS^T Q
    wgmma_fence();
    issue_rs(dv, pf, gt, kQBox);
    issue_rs(dk, df, qt, kQBox);
    wgmma_commit();

    // both warpgroups' dS^T are written (and this warpgroup's previous dQ
    // reduce has read its staging tile)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    asm volatile("bar.sync 1, 256;\n" ::: "memory");

    // dQ[:, 64 wg .. + 63] = dS K: A = dS (queries x keys, MN-major), B = K's
    // column box wg (keys x 64, MN-major)
    float dq[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      wgmma_ss64<1, 1>(dq, gmma_desc(ds + kk * 16 * 128, kDsTile, 1024),
                       gmma_desc(base + wg * kKBox + kk * 16 * 128, kKBox, 1024), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(dk);
    fence_regs(dv);
    mbar_arrive(bar_empty(base, st));  // Q and dO of this stage are read

    // dQ half (64 rows x 64 columns f32) into two 128-byte-swizzled 32-column
    // boxes, then one TMA reduce-add each
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = warp * 16 + g + 8 * half;
        const int col = 8 * j + 2 * t4;  // 0 .. 63
        const uint32_t addr = dq_half + (col / 32) * kDqBox + swizzle128(row, (col % 32) / 4) +
                              (col % 4) * 4;
        asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(dq[4 * j + 2 * half]),
                     "f"(dq[4 * j + 2 * half + 1])
                     : "memory");
      }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
    if (tid == 0) {
      tma_reduce_add(&tdq, dq_half, wg * 64, h, it * kBM, b);
      tma_reduce_add(&tdq, dq_half + kDqBox, wg * 64 + 32, h, it * kBM, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }

  // dK (scaled, rotated back) and dV, rounded once to bf16; d[4j + i] is key
  // row kr + 8 (i >> 1), column 8j + 2t4 + (i & 1)
  const long long nd = (long long)p.n_heads * kD;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (!key_ok[half]) continue;
    const long long key = k0 + kr + 8 * half;
    __nv_bfloat16* dkr = p.dk + ((long long)b * p.sk + key) * nd + (long long)h * kD;
    __nv_bfloat16* dvr = p.dv + ((long long)b * p.sk + key) * nd + (long long)h * kD;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int d = 8 * j + 2 * t4;
      float x0 = dk[4 * j + 2 * half] * p.scale, x1 = dk[4 * j + 2 * half + 1] * p.scale;
      if (p.cos != nullptr)
        rotate_back(x0, x1, p.cos[key * (kD / 2) + d / 2], p.sin[key * (kD / 2) + d / 2]);
      *reinterpret_cast<uint32_t*>(dkr + d) = pack_bf16(x0, x1);
      *reinterpret_cast<uint32_t*>(dvr + d) =
          pack_bf16(dv[4 * j + 2 * half], dv[4 * j + 2 * half + 1]);
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace

// q, k, v, dO: bf16 (B, S, N, 128) views (q and k already rotated when the
// forward used RoPE); strides: 12 element strides, (b, s, n) for q, k, v, dO.
// lse2 = lse * log2(e) and delta: (B, N, sq_pad) f32, sq_pad a multiple of
// 64, padded with +inf and 0. cos / sin: (>= max(Sq, Sk), 64) f32 or null.
// dq32: (B, Sq, N, 128) f32 zeros; dq, dk, dv: contiguous (B, S, N*128) bf16.
// Returns 0 when both kernels were launched, a cudaError_t value,
// kNoEncodeEntry, or kEncodeFailed + the CUresult of the encode that failed.
extern "C" int svi_flash_bwd_sm90(const void* q, const void* k, const void* v, const void* g,
                                  const float* lse2, const float* delta, const float* cos,
                                  const float* sin, float* dq32, void* dq, void* dk, void* dv,
                                  long long batch, long long n_heads, long long sq, long long sk,
                                  long long sq_pad, float scale, const long long* strides,
                                  void* stream) {
  if (batch == 0 || n_heads == 0 || sq == 0 || sk == 0) return (int)cudaSuccess;
  if (sq_pad % kBM || sq_pad < sq) return (int)cudaErrorInvalidValue;
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kNoEncodeEntry;
  CUtensorMap tq, tk, tv, tg, tdq;
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const long long dq_strides[3] = {sq * n_heads * kD, n_heads * kD, kD};
  CUresult r;
  if ((r = encode_map(fn, &tq, bf, 2, q, kD, n_heads, sq, batch, strides + 0, kBoxCols, kBM)) !=
          CUDA_SUCCESS ||
      (r = encode_map(fn, &tk, bf, 2, k, kD, n_heads, sk, batch, strides + 3, kBoxCols, kBN)) !=
          CUDA_SUCCESS ||
      (r = encode_map(fn, &tv, bf, 2, v, kD, n_heads, sk, batch, strides + 6, kBoxCols, kBN)) !=
          CUDA_SUCCESS ||
      (r = encode_map(fn, &tg, bf, 2, g, kD, n_heads, sq, batch, strides + 9, kBoxCols, kBM)) !=
          CUDA_SUCCESS ||
      (r = encode_map(fn, &tdq, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, dq32, kD, n_heads, sq, batch,
                      dq_strides, 32, kBM)) != CUDA_SUCCESS)
    return kEncodeFailed + (int)r;
  Params p;
  p.lse2 = lse2;
  p.delta = delta;
  p.cos = cos;
  p.sin = sin;
  p.dk = reinterpret_cast<__nv_bfloat16*>(dk);
  p.dv = reinterpret_cast<__nv_bfloat16*>(dv);
  p.sq = sq;
  p.sk = sk;
  p.sq_pad = sq_pad;
  p.n_heads = (int)n_heads;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((sk + kBN - 1) / kBN), (unsigned)n_heads, (unsigned)batch);
  flash_bwd_sm90_kernel<<<grid, kThreads, kSmemBytes, st>>>(tq, tk, tv, tg, tdq, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)finalize_grad<kD>(dq32, dq, cos, sin, batch, sq, n_heads, scale, st);
}
