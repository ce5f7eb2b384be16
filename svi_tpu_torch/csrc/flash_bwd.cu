// Non-causal flash-attention backward for Hopper (sm_90a) on mma.sync, bf16
// head dim 64. Plain C interface.
//
// Replaces, for bf16 and D = 64, the split backward of the JAX package
// (svi_tpu/ops/attention.py): K5a _bwd_dq_kernel_flat and K5b
// _bwd_dkv_kernel_flat (launched by _flash_bwd_pallas_flat), dq over KV tiles
// and dk/dv over Q tiles, with RoPE applied in the kernel and dq/dk rotated
// back (route "mma" of ops.attention._split_bwd_route; no main path calls it).
// bf16 D = 128 -- the DiT's cross-attention and short self-attention in
// training -- moved to the TMA + wgmma kernels of flash_bwd_split_sm90.cu, and
// K4 (long self-attention) to flash_bwd_sm90.cu; their earlier mma.sync
// instantiations here were removed (their times are in PERF.md).
//
// Both recompute P = exp(S * scale - lse) from the forward's base-e lse
// (in base 2 here, log2(e) folded in) and use delta = rowsum(dO * O), which the
// caller computes, as the TPU code does outside its kernels:
//   dP = dO V^T, dS = P * (dP - delta), dV = P^T dO, dK = scale dS^T Q,
//   dQ = scale dS K.
// q, k, v and dO are read through (B, S, N, D) element strides (the flat
// (B, S, N*D) projections need no copy); dq, dk and dv are written contiguous
// (B, S, N*D). RoPE, where asked for, rotates q and k pairs (2i, 2i+1) as they
// are loaded, exactly as the forward does, and the gradients are rotated by
// -theta (the transpose of the rotation) before they are stored. Ragged
// sequences are masked in the kernel: rows beyond S are zero-filled in shared
// memory, a query beyond Sq gets lse = +inf (so P = 0), a key beyond Sk gets
// P = 0, and nothing is stored for them. kv_len < Sk is not handled here (the
// caller raises), as the TPU kernels do not handle it either.
//
// Tensor cores through mma.sync m16n8k16, bf16 operands, f32 accumulators.
// P and dS are rounded to bf16 before the products that consume them (dV, dK,
// dQ), as the forward rounds P for P.V.
//
// K5b (flash_bwd_kv_kernel): one CTA per (KV tile of WARPS x 16 keys, head,
// batch), each warp owning 16 keys whose dK and dV stay in registers while the
// CTA walks every 32-row Q tile. The transposed score tile S^T = K Q^T comes
// straight out of the MMA with keys as rows, so its accumulators are the A
// fragments of dV += P^T dO and dK += dS^T Q with no shared-memory round
// trip. K5a (flash_bwd_dq_kernel) is one CTA per (64 query rows, head, batch)
// looping over 32-key tiles, with dQ in registers.
//
// This design is the simple one: fragments come from shared memory with plain
// loads, tiles are not double-buffered, and the CTA synchronises around every
// tile (at D = 128 it ran 14x and 22x above its bounds; flash_bwd_split_sm90.cu
// says what its design does about each of these).

#include "flash_common.cuh"

namespace {

using namespace svi;
using bf16 = __nv_bfloat16;

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* g;        // dO
  const float* lse;     // (B, N, Sq) base e
  const float* delta;   // (B, N, Sq) rowsum(dO * O)
  const float* cos;     // (>= max(Sq, Sk), D/2) contiguous, or null
  const float* sin;
  void* dq;             // (B, Sq, N*D) contiguous
  void* dk;             // (B, Sk, N*D) contiguous
  void* dv;
  long long sq, sk;
  int n_heads;
  float scale;          // softmax scale
  float scale_log2;     // scale * log2(e)
  Strides qs, ks, vs, gs;
};

constexpr int kBq = 32;   // query rows per step of the KV kernels
constexpr int kBkQ = 32;  // keys per step of the dQ kernel
constexpr int kDqWarps = 4;

template <int D>
__device__ __forceinline__ void store_pair(bf16* base, long long row, long long row_stride,
                                           int d, float x0, float x1, const float* cos,
                                           const float* sin, bool rope) {
  if (rope) {  // rotate back by -theta: (x0 c + x1 s, x1 c - x0 s)
    const float c = cos[row * (D / 2) + d / 2], s = sin[row * (D / 2) + d / 2];
    const float y0 = x0 * c + x1 * s;
    const float y1 = x1 * c - x0 * s;
    x0 = y0;
    x1 = y1;
  }
  *reinterpret_cast<uint32_t*>(base + row * row_stride + d) = pack_bf16(x0, x1);
}

// ---------------------------------------------------------------------------
// K5b: dK, dV per KV tile
// ---------------------------------------------------------------------------

template <int D, int WARPS>
constexpr size_t kv_smem_bytes() {
  return sizeof(bf16) * (size_t)(2 * WARPS * 16 * (D + 8) + 2 * kBq * (D + 8)) +
         sizeof(float) * 2 * kBq;
}

template <int D, int WARPS, bool ROPE>
__global__ void __launch_bounds__(WARPS * 32) flash_bwd_kv_kernel(BwdParams p) {
  constexpr int THREADS = WARPS * 32;
  constexpr int BK = WARPS * 16;  // keys per CTA
  constexpr int LD = D + 8;       // padded rows: conflict-free fragment loads
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + BK * LD;
  bf16* sQ = sV + BK * LD;
  bf16* sG = sQ + kBq * LD;
  float* sL = reinterpret_cast<float*>(sG + kBq * LD);  // lse * log2(e)
  float* sDl = sL + kBq;                                // delta

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const long long k0 = (long long)blockIdx.x * BK;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const long long nd = (long long)p.n_heads * D;

  const bf16* qb = reinterpret_cast<const bf16*>(p.q) + b * p.qs.b + h * p.qs.n;
  const bf16* kb = reinterpret_cast<const bf16*>(p.k) + b * p.ks.b + h * p.ks.n;
  const bf16* vb = reinterpret_cast<const bf16*>(p.v) + b * p.vs.b + h * p.vs.n;
  const bf16* gb = reinterpret_cast<const bf16*>(p.g) + b * p.gs.b + h * p.gs.n;
  const float* lse_row = p.lse + (b * p.n_heads + h) * p.sq;
  const float* delta_row = p.delta + (b * p.n_heads + h) * p.sq;

  load_tile_bf16<D, BK, ROPE, THREADS>(sK, kb, p.ks.s, k0, p.sk, p.cos, p.sin);
  load_tile_bf16<D, BK, false, THREADS>(sV, vb, p.vs.s, k0, p.sk, nullptr, nullptr);

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[dt][i] = dv[dt][i] = 0.f;

  const int kr = warp * 16;  // this warp's first key row in the tile
  const bool key_ok[2] = {k0 + kr + g < p.sk, k0 + kr + g + 8 < p.sk};
  const long long nq = (p.sq + kBq - 1) / kBq;
  for (long long it = 0; it < nq; ++it) {
    const long long q0 = it * kBq;
    __syncthreads();  // every warp is done with the previous Q, dO and dS tiles
    load_tile_bf16<D, kBq, ROPE, THREADS>(sQ, qb, p.qs.s, q0, p.sq, p.cos, p.sin);
    load_tile_bf16<D, kBq, false, THREADS>(sG, gb, p.gs.s, q0, p.sq, nullptr, nullptr);
    for (int i = threadIdx.x; i < kBq; i += THREADS) {
      const long long r = q0 + i;
      sL[i] = r < p.sq ? lse_row[r] * kLog2e : INFINITY;
      sDl[i] = r < p.sq ? delta_row[r] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x kBq queries for this warp
    float s[kBq / 8][4], dp[kBq / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBq / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = dp[nt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      load_a_frag(ka, sK, LD, kr, kk * 16);
      load_a_frag(va, sV, LD, kr, kk * 16);
#pragma unroll
      for (int nt = 0; nt < kBq / 8; ++nt) {
        const bf16* qrow = sQ + (nt * 8 + g) * LD + kk * 16 + 2 * t4;
        const bf16* grow = sG + (nt * 8 + g) * LD + kk * 16 + 2 * t4;
        mma_bf16(s[nt], ka, ld_u32(qrow), ld_u32(qrow + 8));
        mma_bf16(dp[nt], va, ld_u32(grow), ld_u32(grow + 8));
      }
    }

    // P^T and dS^T in place (rows: keys g, g + 8; columns: queries)
#pragma unroll
    for (int nt = 0; nt < kBq / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qc = nt * 8 + 2 * t4 + (i & 1);
        const float pv = key_ok[i >> 1] ? exp2f(s[nt][i] * p.scale_log2 - sL[qc]) : 0.f;
        s[nt][i] = pv;
        dp[nt][i] = pv * (dp[nt][i] - sDl[qc]);
      }
    }

    // dV += P^T dO and dK += dS^T Q (the reduction runs over the queries)
#pragma unroll
    for (int kk = 0; kk < kBq / 16; ++kk) {
      uint32_t pa[4], da[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      da[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
      da[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
      da[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      da[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
      const bf16* grow = sG + (kk * 16 + 2 * t4) * LD + g;
      const bf16* qrow = sQ + (kk * 16 + 2 * t4) * LD + g;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const bf16* gp = grow + dt * 8;
        const bf16* qp = qrow + dt * 8;
        mma_bf16(dv[dt], pa, pack_bf16_raw(gp[0], gp[LD]), pack_bf16_raw(gp[8 * LD], gp[9 * LD]));
        mma_bf16(dk[dt], da, pack_bf16_raw(qp[0], qp[LD]), pack_bf16_raw(qp[8 * LD], qp[9 * LD]));
      }
    }
  }

  // dK (scaled, rotated back) and dV, rounded once to bf16
  bf16* dkb = reinterpret_cast<bf16*>(p.dk) + b * p.sk * nd + (long long)h * D;
  bf16* dvb = reinterpret_cast<bf16*>(p.dv) + b * p.sk * nd + (long long)h * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int d = dt * 8 + 2 * t4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!key_ok[r]) continue;
      const long long row = k0 + kr + g + 8 * r;
      store_pair<D>(dkb, row, nd, d, dk[dt][2 * r] * p.scale, dk[dt][2 * r + 1] * p.scale,
                    p.cos, p.sin, ROPE);
      store_pair<D>(dvb, row, nd, d, dv[dt][2 * r], dv[dt][2 * r + 1], nullptr, nullptr, false);
    }
  }
}

// ---------------------------------------------------------------------------
// K5a: dQ per 64-row Q tile, looping over 32-key tiles
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(bf16) * (size_t)(2 * kDqWarps * 16 * (D + 8) + 2 * kBkQ * (D + 8)) +
         sizeof(float) * 2 * kDqWarps * 16;
}

template <int D, bool ROPE>
__global__ void __launch_bounds__(kDqWarps * 32) flash_bwd_dq_kernel(BwdParams p) {
  constexpr int THREADS = kDqWarps * 32;
  constexpr int BQ = kDqWarps * 16;
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sG = sQ + BQ * LD;
  bf16* sK = sG + BQ * LD;
  bf16* sV = sK + kBkQ * LD;
  float* sL = reinterpret_cast<float*>(sV + kBkQ * LD);
  float* sDl = sL + BQ;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const long long q0 = (long long)blockIdx.x * BQ;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const long long nd = (long long)p.n_heads * D;

  const bf16* qb = reinterpret_cast<const bf16*>(p.q) + b * p.qs.b + h * p.qs.n;
  const bf16* kb = reinterpret_cast<const bf16*>(p.k) + b * p.ks.b + h * p.ks.n;
  const bf16* vb = reinterpret_cast<const bf16*>(p.v) + b * p.vs.b + h * p.vs.n;
  const bf16* gb = reinterpret_cast<const bf16*>(p.g) + b * p.gs.b + h * p.gs.n;
  const float* lse_row = p.lse + (b * p.n_heads + h) * p.sq;
  const float* delta_row = p.delta + (b * p.n_heads + h) * p.sq;

  load_tile_bf16<D, BQ, ROPE, THREADS>(sQ, qb, p.qs.s, q0, p.sq, p.cos, p.sin);
  load_tile_bf16<D, BQ, false, THREADS>(sG, gb, p.gs.s, q0, p.sq, nullptr, nullptr);
  for (int i = threadIdx.x; i < BQ; i += THREADS) {
    const long long r = q0 + i;
    sL[i] = r < p.sq ? lse_row[r] * kLog2e : INFINITY;
    sDl[i] = r < p.sq ? delta_row[r] : 0.f;
  }

  float dq[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) dq[dt][0] = dq[dt][1] = dq[dt][2] = dq[dt][3] = 0.f;

  const int qr = warp * 16;
  const long long n_tiles = (p.sk + kBkQ - 1) / kBkQ;
  for (long long j = 0; j < n_tiles; ++j) {
    const long long k0 = j * kBkQ;
    __syncthreads();  // every warp is done with the previous K and V tiles
    load_tile_bf16<D, kBkQ, ROPE, THREADS>(sK, kb, p.ks.s, k0, p.sk, p.cos, p.sin);
    load_tile_bf16<D, kBkQ, false, THREADS>(sV, vb, p.vs.s, k0, p.sk, nullptr, nullptr);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: 16 queries x 32 keys for this warp
    float s[kBkQ / 8][4], dp[kBkQ / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBkQ / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = dp[nt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], ga[4];
      load_a_frag(qa, sQ, LD, qr, kk * 16);
      load_a_frag(ga, sG, LD, qr, kk * 16);
#pragma unroll
      for (int nt = 0; nt < kBkQ / 8; ++nt) {
        const bf16* krow = sK + (nt * 8 + g) * LD + kk * 16 + 2 * t4;
        const bf16* vrow = sV + (nt * 8 + g) * LD + kk * 16 + 2 * t4;
        mma_bf16(s[nt], qa, ld_u32(krow), ld_u32(krow + 8));
        mma_bf16(dp[nt], ga, ld_u32(vrow), ld_u32(vrow + 8));
      }
    }

    const float lr[2] = {sL[qr + g], sL[qr + g + 8]};
    const float dl[2] = {sDl[qr + g], sDl[qr + g + 8]};
#pragma unroll
    for (int nt = 0; nt < kBkQ / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long key = k0 + nt * 8 + 2 * t4 + (i & 1);
        const float pv = key < p.sk ? exp2f(s[nt][i] * p.scale_log2 - lr[i >> 1]) : 0.f;
        dp[nt][i] = pv * (dp[nt][i] - dl[i >> 1]);
      }
    }

    // dQ += dS K (the reduction runs over the keys)
#pragma unroll
    for (int kk = 0; kk < kBkQ / 16; ++kk) {
      uint32_t da[4];
      da[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
      da[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
      da[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      da[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
      const bf16* krow = sK + (kk * 16 + 2 * t4) * LD + g;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const bf16* kp = krow + dt * 8;
        mma_bf16(dq[dt], da, pack_bf16_raw(kp[0], kp[LD]), pack_bf16_raw(kp[8 * LD], kp[9 * LD]));
      }
    }
  }

  bf16* dqb = reinterpret_cast<bf16*>(p.dq) + b * p.sq * nd + (long long)h * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int d = dt * 8 + 2 * t4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long row = q0 + qr + g + 8 * r;
      if (row < p.sq)
        store_pair<D>(dqb, row, nd, d, dq[dt][2 * r] * p.scale, dq[dt][2 * r + 1] * p.scale,
                      p.cos, p.sin, ROPE);
    }
  }
}

// ---------------------------------------------------------------------------
// launch helpers
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t launch(Kernel kern, dim3 grid, int threads, size_t smem, cudaStream_t st,
                   const BwdParams& p) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, threads, smem, st>>>(p);
  return cudaGetLastError();
}

template <int D, int WARPS, bool ROPE>
cudaError_t launch_kv(const BwdParams& p, long long batch, cudaStream_t st) {
  const dim3 grid((unsigned)((p.sk + WARPS * 16 - 1) / (WARPS * 16)), (unsigned)p.n_heads,
                  (unsigned)batch);
  return launch(flash_bwd_kv_kernel<D, WARPS, ROPE>, grid, WARPS * 32, kv_smem_bytes<D, WARPS>(),
                st, p);
}

template <int D, bool ROPE>
cudaError_t launch_dq(const BwdParams& p, long long batch, cudaStream_t st) {
  const dim3 grid((unsigned)((p.sq + kDqWarps * 16 - 1) / (kDqWarps * 16)),
                  (unsigned)p.n_heads, (unsigned)batch);
  return launch(flash_bwd_dq_kernel<D, ROPE>, grid, kDqWarps * 32, dq_smem_bytes<D>(), st, p);
}

BwdParams make_params(const void* q, const void* k, const void* v, const void* g,
                      const float* lse, const float* delta, const float* cos, const float* sin,
                      long long n_heads, long long sq, long long sk, float scale,
                      const long long* strides) {
  BwdParams p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.g = g;
  p.lse = lse;
  p.delta = delta;
  p.cos = cos;
  p.sin = sin;
  p.sq = sq;
  p.sk = sk;
  p.n_heads = (int)n_heads;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  p.qs = Strides{strides[0], strides[1], strides[2]};
  p.ks = Strides{strides[3], strides[4], strides[5]};
  p.vs = Strides{strides[6], strides[7], strides[8]};
  p.gs = Strides{strides[9], strides[10], strides[11]};
  return p;
}

}  // namespace

// Common arguments: bf16 q, k, v, dO read through 12 element strides ((b, s, n)
// for q, k, v, dO in that order); lse and delta (B, N, Sq) f32; cos/sin
// (>= max(Sq, Sk), D/2) f32 or null for no RoPE. Outputs are contiguous
// (B, S, N*D) bf16. head_dim must be 64. Each returns a cudaError_t value; 0
// means launched.

// K5a.
extern "C" int svi_flash_bwd_dq(int head_dim, const void* q, const void* k, const void* v,
                                const void* g, const float* lse, const float* delta,
                                const float* cos, const float* sin, void* dq, long long batch,
                                long long n_heads, long long sq, long long sk, float scale,
                                const long long* strides, void* stream) {
  BwdParams p = make_params(q, k, v, g, lse, delta, cos, sin, n_heads, sq, sk, scale, strides);
  p.dq = dq;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (head_dim != 64) return (int)cudaErrorInvalidValue;
  return (int)(cos ? launch_dq<64, true>(p, batch, st) : launch_dq<64, false>(p, batch, st));
}

// K5b.
extern "C" int svi_flash_bwd_dkv(int head_dim, const void* q, const void* k, const void* v,
                                 const void* g, const float* lse, const float* delta,
                                 const float* cos, const float* sin, void* dk, void* dv,
                                 long long batch, long long n_heads, long long sq, long long sk,
                                 float scale, const long long* strides, void* stream) {
  BwdParams p = make_params(q, k, v, g, lse, delta, cos, sin, n_heads, sq, sk, scale, strides);
  p.dk = dk;
  p.dv = dv;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (head_dim != 64) return (int)cudaErrorInvalidValue;
  return (int)(cos ? launch_kv<64, 4, true>(p, batch, st) : launch_kv<64, 4, false>(p, batch, st));
}
