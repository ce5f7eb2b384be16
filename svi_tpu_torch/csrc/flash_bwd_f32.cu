// Non-causal flash-attention backward for Hopper (sm_90a), float32, on the
// (B, N, S, D) route: head dims 40, 64, 80 and 160. Plain C interface.
//
// Replaces, for the SD 1.5 UNet (8 heads of 40, 80 and 160; ControlNet and
// AnimateDiff too) and the SDXL UNet (heads of 64) in f32, the function of
// the JAX package's split backward (svi_tpu/ops/attention.py): K5a
// _bwd_dq_kernel_flat (dq over key tiles) and K5b _bwd_dkv_kernel_flat (dk,
// dv over query tiles). On the TPU those head dims fail the flat layout's
// test (head_dim % 128 == 0 or one head), so _flash_core_flat_bwd computes
// them in XLA (_flash_bwd_xla); here they get kernels of their own, so the
// text-to-image LoRA trainer's step runs no plain attention on the card.
//
// Both kernels recompute P = exp(S * scale - lse) from the forward's base-e
// lse (in base 2, log2(e) folded in) and read delta = rowsum(dO * O), which
// the caller computes in f32 once for both:
//   dP = dO V^T, dS = P * (dP - delta), dV = P^T dO, dK = scale dS^T Q,
//   dQ = scale dS K.
// q, k, v and dO are read through (B, S, N, D) element strides (the flat
// (B, S, N*D) projections and the (B, N, S, D) views need no copy); dq, dk
// and dv are written contiguous (B, S, N*D). Rows past Sq and Sk are
// zero-filled in shared memory; a query past Sq gets lse = +inf (P = 0), a
// key past Sk (the text's 77 keys are no tile multiple) is masked to P = 0 in
// the dq kernel, and nothing is stored for either. No RoPE: the SD stacks
// have none. kv_len < Sk is the caller's (it cuts the keys first).
//
// Arithmetic: f32 FMA on the CUDA cores, every product and sum in f32, so
// the gradients keep f32-level error (TF32 would give 1e-3). The work is
// operations: the dq kernel does 3 and the dk/dv kernel 4 products of
// Sq x Sk x D per head, 14 * Sq * Sk * D FLOP in all. This design runs them
// at the 67 TFLOP/s of f32 FMA; the card's f32-accurate peak is 3xTF32 on
// the tensor cores (495 / 3 = 165 TFLOP/s of f32 work), which bounds it.
//
// Design, the simple one: one CTA of 256 threads per (64 rows of its own
// side, head, batch) -- queries for dq, keys for dk/dv -- with its own tiles
// (Q and dO, or K and V) in shared memory for the whole run, walking the
// other side in 64-row steps. Each step loads the other side's two tiles,
// computes the two 64 x 64 score tiles (S and dP, or their transposes) as
// 4 x 4 register micro-tiles per thread, turns them into P and dS in shared
// memory, then accumulates the thread's RPT rows x CPT columns of dQ (or dK
// and dV) in registers. Tile rows are padded to D + 1 floats and score rows
// to 65, so that the micro-tiles' loads fall on distinct banks. Nothing is
// double-buffered: the CTA synchronises three times a step.

#include "flash_common.cuh"

namespace {

using namespace svi;

struct BwdF32Params {
  const float* q;
  const float* k;
  const float* v;
  const float* g;       // dO
  const float* lse;     // (B, N, Sq) base e
  const float* delta;   // (B, N, Sq) rowsum(dO * O)
  float* dq;            // (B, Sq, N*D) contiguous
  float* dk;            // (B, Sk, N*D) contiguous
  float* dv;
  long long sq, sk;
  int n_heads;
  float scale;          // softmax scale
  float scale_log2;     // scale * log2(e)
  Strides qs, ks, vs, gs;
};

constexpr int kRows = 64;      // rows of a tile, on either side
constexpr int kThreads = 256;
constexpr int kLdS = kRows + 1;  // padded row of a 64 x 64 score tile

template <int D_, int NCG_, int MIN_BLOCKS_>
struct BwdCfg {
  static constexpr int D = D_;
  static constexpr int NCG = NCG_;               // column groups of the D-wide products
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int RG = kThreads / NCG;      // row groups
  static constexpr int RPT = kRows / RG;         // own rows per thread
  static constexpr int CPT = D / NCG;            // columns per thread
  static constexpr int LD = D + 1;               // padded tile row
  static constexpr int TILE = kRows * LD;
  static_assert(D % NCG == 0 && kThreads % NCG == 0 && kRows % RG == 0, "tiling");
  // four D-wide tiles, two score tiles, lse and delta of 64 rows
  static constexpr size_t SMEM = sizeof(float) * (size_t)(4 * TILE + 2 * kRows * kLdS + 2 * kRows);
  static_assert(SMEM <= 227 * 1024, "shared memory of one CTA");
};

// rows [row0, row0 + 64) of one head, D wide, into a padded tile; rows at or
// beyond nrows read as 0
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long row_stride,
                                          long long row0, long long nrows) {
  for (int idx = threadIdx.x; idx < kRows * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const long long gr = row0 + r;
    dst[r * (D + 1) + c] = gr < nrows ? src[gr * row_stride + c] : 0.f;
  }
}

// x[i][j] = sum_d a[ta + 16 i][d] b[tb + 16 j][d] and y likewise on the
// second pair: two 64 x 64 products over D as 4 x 4 micro-tiles
template <int D>
__device__ __forceinline__ void score_tiles(const float* a1, const float* b1, const float* a2,
                                            const float* b2, int ta, int tb, float (&x)[4][4],
                                            float (&y)[4][4]) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) x[i][j] = y[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4], cv[4], ev[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = a1[(ta + 16 * i) * LD + d];
      bv[i] = b1[(tb + 16 * i) * LD + d];
      cv[i] = a2[(ta + 16 * i) * LD + d];
      ev[i] = b2[(tb + 16 * i) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x[i][j] = fmaf(av[i], bv[j], x[i][j]);
        y[i][j] = fmaf(cv[i], ev[j], y[i][j]);
      }
  }
}

// ---------------------------------------------------------------------------
// K5a's function: dQ per 64 query rows, walking the keys
// ---------------------------------------------------------------------------

template <class C>
__global__ void __launch_bounds__(kThreads, C::MIN_BLOCKS) flash_bwd_f32_dq_kernel(BwdF32Params p) {
  constexpr int D = C::D;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sG = sQ + C::TILE;
  float* sK = sG + C::TILE;
  float* sV = sK + C::TILE;
  float* sDs = sV + C::TILE;               // dS[q][k]
  float* sL = sDs + 2 * kRows * kLdS;      // lse * log2(e), +inf past Sq
  float* sDl = sL + kRows;                 // delta

  const int tid = threadIdx.x;
  const long long q0 = (long long)blockIdx.x * kRows;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const float* qb = p.q + b * p.qs.b + h * p.qs.n;
  const float* kb = p.k + b * p.ks.b + h * p.ks.n;
  const float* vb = p.v + b * p.vs.b + h * p.vs.n;
  const float* gb = p.g + b * p.gs.b + h * p.gs.n;
  const long long row_base = (b * p.n_heads + h) * p.sq;

  load_tile<D>(sQ, qb, p.qs.s, q0, p.sq);
  load_tile<D>(sG, gb, p.gs.s, q0, p.sq);
  if (tid < kRows) {
    const long long gr = q0 + tid;
    sL[tid] = gr < p.sq ? p.lse[row_base + gr] * kLog2e : INFINITY;
    sDl[tid] = gr < p.sq ? p.delta[row_base + gr] : 0.f;
  }

  const int ta = tid / 16, tb = tid % 16;           // score micro-tile
  const int tr = tid / C::NCG, tc = tid % C::NCG;   // dQ rows and columns
  float acc[C::RPT][C::CPT];
#pragma unroll
  for (int i = 0; i < C::RPT; ++i)
#pragma unroll
    for (int j = 0; j < C::CPT; ++j) acc[i][j] = 0.f;

  for (long long k0 = 0; k0 < p.sk; k0 += kRows) {
    __syncthreads();  // the previous step is done with sK, sV and sDs
    load_tile<D>(sK, kb, p.ks.s, k0, p.sk);
    load_tile<D>(sV, vb, p.vs.s, k0, p.sk);
    __syncthreads();
    float s[4][4], dp[4][4];
    score_tiles<D>(sQ, sK, sG, sV, ta, tb, s, dp);  // S[q][k], dP[q][k]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = ta + 16 * i;
      const float l2 = sL[qr], dl = sDl[qr];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = tb + 16 * j;
        const float pr = k0 + kc < p.sk ? exp2f(s[i][j] * p.scale_log2 - l2) : 0.f;
        sDs[qr * kLdS + kc] = pr * (dp[i][j] - dl);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kc = 0; kc < kRows; ++kc) {
      float kv[C::CPT];
#pragma unroll
      for (int j = 0; j < C::CPT; ++j) kv[j] = sK[kc * C::LD + tc + C::NCG * j];
#pragma unroll
      for (int i = 0; i < C::RPT; ++i) {
        const float ds = sDs[(tr + C::RG * i) * kLdS + kc];
#pragma unroll
        for (int j = 0; j < C::CPT; ++j) acc[i][j] = fmaf(ds, kv[j], acc[i][j]);
      }
    }
  }

  const long long nd = (long long)p.n_heads * D;
#pragma unroll
  for (int i = 0; i < C::RPT; ++i) {
    const long long gr = q0 + tr + C::RG * i;
    if (gr >= p.sq) continue;
    float* row = p.dq + (b * p.sq + gr) * nd + (long long)h * D;
#pragma unroll
    for (int j = 0; j < C::CPT; ++j) row[tc + C::NCG * j] = acc[i][j] * p.scale;
  }
}

// ---------------------------------------------------------------------------
// K5b's function: dK, dV per 64 keys, walking the queries
// ---------------------------------------------------------------------------

template <class C>
__global__ void __launch_bounds__(kThreads, C::MIN_BLOCKS) flash_bwd_f32_dkv_kernel(BwdF32Params p) {
  constexpr int D = C::D;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + C::TILE;
  float* sQ = sV + C::TILE;
  float* sG = sQ + C::TILE;
  float* sP = sG + C::TILE;                // P[k][q]
  float* sDs = sP + kRows * kLdS;          // dS[k][q]
  float* sL = sDs + kRows * kLdS;          // lse * log2(e) of the step's queries
  float* sDl = sL + kRows;                 // their delta

  const int tid = threadIdx.x;
  const long long k0 = (long long)blockIdx.x * kRows;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const float* qb = p.q + b * p.qs.b + h * p.qs.n;
  const float* kb = p.k + b * p.ks.b + h * p.ks.n;
  const float* vb = p.v + b * p.vs.b + h * p.vs.n;
  const float* gb = p.g + b * p.gs.b + h * p.gs.n;
  const long long row_base = (b * p.n_heads + h) * p.sq;

  load_tile<D>(sK, kb, p.ks.s, k0, p.sk);
  load_tile<D>(sV, vb, p.vs.s, k0, p.sk);

  const int ta = tid / 16, tb = tid % 16;
  const int tr = tid / C::NCG, tc = tid % C::NCG;
  float dk[C::RPT][C::CPT], dv[C::RPT][C::CPT];
#pragma unroll
  for (int i = 0; i < C::RPT; ++i)
#pragma unroll
    for (int j = 0; j < C::CPT; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (long long q0 = 0; q0 < p.sq; q0 += kRows) {
    __syncthreads();  // the previous step is done with sQ, sG, sP and sDs
    load_tile<D>(sQ, qb, p.qs.s, q0, p.sq);
    load_tile<D>(sG, gb, p.gs.s, q0, p.sq);
    if (tid < kRows) {
      const long long gr = q0 + tid;
      sL[tid] = gr < p.sq ? p.lse[row_base + gr] * kLog2e : INFINITY;
      sDl[tid] = gr < p.sq ? p.delta[row_base + gr] : 0.f;
    }
    __syncthreads();
    float st[4][4], dpt[4][4];
    score_tiles<D>(sK, sQ, sV, sG, ta, tb, st, dpt);  // S^T[k][q], dP^T[k][q]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = ta + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = tb + 16 * j;
        const float pr = exp2f(st[i][j] * p.scale_log2 - sL[qc]);
        sP[kr * kLdS + qc] = pr;
        sDs[kr * kLdS + qc] = pr * (dpt[i][j] - sDl[qc]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int qc = 0; qc < kRows; ++qc) {
      float qv[C::CPT], gv[C::CPT];
#pragma unroll
      for (int j = 0; j < C::CPT; ++j) {
        qv[j] = sQ[qc * C::LD + tc + C::NCG * j];
        gv[j] = sG[qc * C::LD + tc + C::NCG * j];
      }
#pragma unroll
      for (int i = 0; i < C::RPT; ++i) {
        const int kr = tr + C::RG * i;
        const float pr = sP[kr * kLdS + qc], ds = sDs[kr * kLdS + qc];
#pragma unroll
        for (int j = 0; j < C::CPT; ++j) {
          dv[i][j] = fmaf(pr, gv[j], dv[i][j]);
          dk[i][j] = fmaf(ds, qv[j], dk[i][j]);
        }
      }
    }
  }

  const long long nd = (long long)p.n_heads * D;
#pragma unroll
  for (int i = 0; i < C::RPT; ++i) {
    const long long gr = k0 + tr + C::RG * i;
    if (gr >= p.sk) continue;
    float* krow = p.dk + (b * p.sk + gr) * nd + (long long)h * D;
    float* vrow = p.dv + (b * p.sk + gr) * nd + (long long)h * D;
#pragma unroll
    for (int j = 0; j < C::CPT; ++j) {
      krow[tc + C::NCG * j] = dk[i][j] * p.scale;
      vrow[tc + C::NCG * j] = dv[i][j];
    }
  }
}

template <class C, bool DQ>
cudaError_t launch(const BwdF32Params& p, long long batch, cudaStream_t st) {
  auto kern = DQ ? flash_bwd_f32_dq_kernel<C> : flash_bwd_f32_dkv_kernel<C>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const long long rows = DQ ? p.sq : p.sk;
  const dim3 grid((unsigned)((rows + kRows - 1) / kRows), (unsigned)p.n_heads, (unsigned)batch);
  kern<<<grid, kThreads, C::SMEM, st>>>(p);
  return cudaGetLastError();
}

// (D, column groups, CTAs an SM): 8 column groups of 5, 8 and 10 columns at
// D = 40, 64, 80 (2 rows a thread); 16 of 10 at D = 160 (4 rows a thread,
// 194 KB of shared memory, one CTA an SM)
template <bool DQ>
cudaError_t dispatch(int head_dim, const BwdF32Params& p, long long batch, cudaStream_t st) {
  switch (head_dim) {
    case 40: return launch<BwdCfg<40, 8, 2>, DQ>(p, batch, st);
    case 64: return launch<BwdCfg<64, 8, 2>, DQ>(p, batch, st);
    case 80: return launch<BwdCfg<80, 8, 2>, DQ>(p, batch, st);
    case 160: return launch<BwdCfg<160, 16, 1>, DQ>(p, batch, st);
    default: return cudaErrorInvalidValue;
  }
}

BwdF32Params make_params(const float* q, const float* k, const float* v, const float* g,
                         const float* lse, const float* delta, long long n_heads, long long sq,
                         long long sk, float scale, const long long* strides) {
  BwdF32Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.g = g;
  p.lse = lse;
  p.delta = delta;
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

// q, k, v, dO: f32 (B, S, N, D) views with a contiguous last dim; strides: 12
// element strides, (b, s, n) for q, k, v, dO in that order; lse and delta
// contiguous (B, N, Sq). Each returns a cudaError_t value; 0 means launched.
extern "C" int svi_flash_bwd_f32_dq(int head_dim, const float* q, const float* k, const float* v,
                                    const float* g, const float* lse, const float* delta,
                                    float* dq, long long batch, long long n_heads, long long sq,
                                    long long sk, float scale, const long long* strides,
                                    void* stream) {
  BwdF32Params p = make_params(q, k, v, g, lse, delta, n_heads, sq, sk, scale, strides);
  p.dq = dq;
  if (batch == 0 || n_heads == 0 || sq == 0) return (int)cudaSuccess;
  return (int)dispatch<true>(head_dim, p, batch, reinterpret_cast<cudaStream_t>(stream));
}

extern "C" int svi_flash_bwd_f32_dkv(int head_dim, const float* q, const float* k, const float* v,
                                     const float* g, const float* lse, const float* delta,
                                     float* dk, float* dv, long long batch, long long n_heads,
                                     long long sq, long long sk, float scale,
                                     const long long* strides, void* stream) {
  BwdF32Params p = make_params(q, k, v, g, lse, delta, n_heads, sq, sk, scale, strides);
  p.dk = dk;
  p.dv = dv;
  if (batch == 0 || n_heads == 0 || sk == 0) return (int)cudaSuccess;
  return (int)dispatch<false>(head_dim, p, batch, reinterpret_cast<cudaStream_t>(stream));
}
