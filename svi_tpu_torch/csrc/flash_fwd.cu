// Non-causal flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the two Pallas TPU forward kernels of the JAX package:
//   * svi_tpu/ops/attention.py::_fwd_kernel_flat (K1, launched by
//     _flash_fwd_pallas_flat): flat (B, S, N*D) layout, optional fused
//     interleaved-pair RoPE, keys >= kv_len masked, emits out + base-e lse;
//   * svi_tpu/ops/attention.py::_fwd_kernel (K2, launched by
//     _flash_fwd_pallas): the same forward on (B, N, S, D), used for head dims
//     that are not a multiple of 128 (CLIP's 80) and for the ring-attention lse.
// On the GPU a layout is only strides, so one kernel serves both: it takes
// (B, S, N, D) element strides for q, k, v and out (the last dim contiguous).
//
// What it computes: one CTA per (q-tile, head, batch). A loop over k-tiles
// inside the CTA replaces the TPU's sequential `j` grid axis and its VMEM
// scratch carry. The online softmax runs in f32 in base 2 (log2(e) folded into
// the scale); the emitted lse is base e, (B, N, Sq) f32. Keys at or beyond
// min(kv_len, Sk) are masked with bounds checks; nothing is padded in memory.
// A row whose keys are all masked gets out = 0 and a finite lse (l is clamped
// to >= 1e-30 as the TPU kernel does, and m = -inf is reported as -1e30).
//
// Two instantiation families (bf16 with D = 128, every DiT attention, runs
// the TMA + wgmma kernel of flash_fwd_sm90.cu instead):
//   * bf16, D = 64: tensor cores through mma.sync m16n8k16 with f32
//     accumulation. 4 warps x 16 query rows = 64 rows per CTA, 64-key tiles.
//     P is rounded to bf16 for the P.V product (as the TPU kernel does);
//     out is rounded to bf16 once, from the f32 accumulator.
//   * f32, D in {32, 64, 80, 128, 384}: plain f32 FMA, no TF32. 8 threads per
//     query row, 32 rows and 32-key tiles per CTA, all in dynamic shared memory
//     (D = 384 needs ~150 KB, above the 48 KB static limit).
// RoPE is applied to q and k tiles on load, from (S, D/2) f32 cos/sin tables:
// pairs (2i, 2i+1) are adjacent, so the TPU's pair-expanded sign-baked tables
// are not needed. The rotation is computed in f32 and rounded back to the
// input type, like the plain PyTorch version.
//
// What bounds it on this card: the 14B DiT self-attention (S = 32760, D = 128,
// 40 heads) is bound by tensor-core FLOPs; the text (Sk = 512) and image
// (Sk = 257) cross-attentions read q and write out once for a short key
// sequence and are bound by bytes. This design is the simple one: fragments
// are loaded from shared memory with plain loads, k/v tiles are not double
// buffered, and the CTA synchronises around every tile. The redesign with
// wgmma, TMA loads with mbarriers and warp specialisation is
// flash_fwd_sm90.cu, which took over bf16 D = 128 (its earlier times here are
// in PERF.md).

#include "flash_common.cuh"

namespace {

using namespace svi;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;         // (B, N, Sq) contiguous
  const float* cos;   // (>= max(Sq, Sk), D/2) contiguous, or null
  const float* sin;
  long long sq, sk;
  long long kv_end;   // min(kv_len, Sk)
  int n_heads;
  float scale_log2;   // softmax scale * log2(e)
  Strides qs, ks, vs, os;
};

__device__ __forceinline__ float lse_of(float m, float l) {
  const float mm = (m == -INFINITY) ? -1e30f : m / kLog2e;
  return mm + logf(fmaxf(l, 1e-30f));
}

// ---------------------------------------------------------------------------
// bf16 tensor-core path
// ---------------------------------------------------------------------------

constexpr int kBr16 = 64;   // query rows per CTA (4 warps x 16)
constexpr int kBc16 = 64;   // keys per tile
constexpr int kThreads16 = 128;

template <int D, bool ROPE>
__global__ void __launch_bounds__(kThreads16) flash_fwd_bf16_kernel(Params p) {
  constexpr int LD = D + 8;  // padded row: conflict-free fragment loads
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kBr16 * LD;
  __nv_bfloat16* sV = sK + kBc16 * LD;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // fragment row group
  const int t4 = lane % 4;  // thread in group
  const long long q0 = (long long)blockIdx.x * kBr16;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;

  const __nv_bfloat16* qb =
      reinterpret_cast<const __nv_bfloat16*>(p.q) + b * p.qs.b + h * p.qs.n;
  const __nv_bfloat16* kb =
      reinterpret_cast<const __nv_bfloat16*>(p.k) + b * p.ks.b + h * p.ks.n;
  const __nv_bfloat16* vb =
      reinterpret_cast<const __nv_bfloat16*>(p.v) + b * p.vs.b + h * p.vs.n;
  __nv_bfloat16* ob = reinterpret_cast<__nv_bfloat16*>(p.out) + b * p.os.b + h * p.os.n;

  load_tile_bf16<D, kBr16, ROPE, kThreads16>(sQ, qb, p.qs.s, q0, p.sq, p.cos, p.sin);
  __syncthreads();

  // this warp's 16 query rows as A fragments, kept in registers
  uint32_t qf[D / 16][4];
  {
    const int r0 = warp * 16 + g;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + 2 * t4;
      qf[kk][0] = ld_u32(sQ + r0 * LD + c);
      qf[kk][1] = ld_u32(sQ + (r0 + 8) * LD + c);
      qf[kk][2] = ld_u32(sQ + r0 * LD + c + 8);
      qf[kk][3] = ld_u32(sQ + (r0 + 8) * LD + c + 8);
    }
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // per-thread partial row sums, reduced at the end

  const long long n_tiles = (p.kv_end + kBc16 - 1) / kBc16;
  for (long long j = 0; j < n_tiles; ++j) {
    const long long k0 = j * kBc16;
    __syncthreads();  // every warp is done with the previous k/v tile
    load_tile_bf16<D, kBc16, ROPE, kThreads16>(sK, kb, p.ks.s, k0, p.sk, p.cos, p.sin);
    load_tile_bf16<D, kBc16, false, kThreads16>(sV, vb, p.vs.s, k0, p.sk, nullptr, nullptr);
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys
    float s[kBc16 / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBc16 / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* krow = sK + (nt * 8 + g) * LD + 2 * t4;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_bf16(s[nt], qf[kk], ld_u32(krow + kk * 16), ld_u32(krow + kk * 16 + 8));
    }

    // scale, mask, row max (rows g and g + 8; a row lives in 4 lanes)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kBc16 / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long col = k0 + nt * 8 + 2 * t4 + (i & 1);
        float x = s[nt][i] * p.scale_log2;
        if (col >= p.kv_end) x = -INFINITY;
        s[nt][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    }
    float mu[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], warp_max_xor(mx[r], 4));
      mu[r] = (mn == -INFINITY) ? 0.f : mn;  // keeps exp2 of masked keys at 0, never NaN
      alpha[r] = exp2f(m[r] - mu[r]);
      m[r] = mn;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kBc16 / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = exp2f(s[nt][i] - mu[i >> 1]);
        s[nt][i] = e;
        rs[i >> 1] += e;
      }
    }
    l[0] = l[0] * alpha[0] + rs[0];
    l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }

    // O += P V: the S accumulators of two adjacent 8-key tiles are exactly
    // the A fragment of one 16-key step
#pragma unroll
    for (int kk = 0; kk < kBc16 / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* vrow = sV + (kk * 16 + 2 * t4) * LD + g;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* vp = vrow + dt * 8;
        const uint32_t b0 = pack_bf16_raw(vp[0], vp[LD]);
        const uint32_t b1 = pack_bf16_raw(vp[8 * LD], vp[9 * LD]);
        mma_bf16(acc[dt], a, b0, b1);
      }
    }
  }

  const long long r0 = q0 + warp * 16 + g;
  const long long r1 = r0 + 8;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = warp_sum_xor(l[r], 4);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int d = dt * 8 + 2 * t4;
    if (r0 < p.sq)
      *reinterpret_cast<uint32_t*>(ob + r0 * p.os.s + d) =
          pack_bf16(acc[dt][0] * inv[0], acc[dt][1] * inv[0]);
    if (r1 < p.sq)
      *reinterpret_cast<uint32_t*>(ob + r1 * p.os.s + d) =
          pack_bf16(acc[dt][2] * inv[1], acc[dt][3] * inv[1]);
  }
  if (t4 == 0) {
    float* lrow = p.lse + (b * p.n_heads + h) * p.sq;
    if (r0 < p.sq) lrow[r0] = lse_of(m[0], l[0]);
    if (r1 < p.sq) lrow[r1] = lse_of(m[1], l[1]);
  }
}

// ---------------------------------------------------------------------------
// f32 FMA path
// ---------------------------------------------------------------------------

constexpr int kBr32 = 32;   // query rows per CTA
constexpr int kBc32 = 32;   // keys per tile
constexpr int kThreads32 = 256;  // 8 threads per query row

template <int D, int ROWS, bool ROPE>
__device__ __forceinline__ void load_tile_f32(float* dst, int ld, const float* src,
                                              long long row_stride, long long row0,
                                              long long nrows, const float* cos,
                                              const float* sin) {
  constexpr int kPairs = D / 2;
  for (int idx = threadIdx.x; idx < ROWS * kPairs; idx += kThreads32) {
    const int r = idx / kPairs;
    const int i = idx % kPairs;
    const long long gr = row0 + r;
    float x0 = 0.f, x1 = 0.f;
    if (gr < nrows) {
      x0 = src[gr * row_stride + 2 * i];
      x1 = src[gr * row_stride + 2 * i + 1];
      if (ROPE) {
        const float c = cos[gr * kPairs + i], s = sin[gr * kPairs + i];
        const float y0 = __fsub_rn(__fmul_rn(x0, c), __fmul_rn(x1, s));
        const float y1 = __fadd_rn(__fmul_rn(x0, s), __fmul_rn(x1, c));
        x0 = y0;
        x1 = y1;
      }
    }
    dst[r * ld + 2 * i] = x0;
    dst[r * ld + 2 * i + 1] = x1;
  }
}

template <int D>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) *
         (size_t)(kBr32 * (D + 1) + kBc32 * (D + 1) + kBc32 * D + kBr32 * (kBc32 + 1));
}

template <int D, bool ROPE>
__global__ void __launch_bounds__(kThreads32) flash_fwd_f32_kernel(Params p) {
  constexpr int LDQ = D + 1;  // odd stride: rows of q/k land on distinct banks
  constexpr int LDV = D;
  constexpr int LDP = kBc32 + 1;
  constexpr int DV = D / 8;   // output columns per thread
  extern __shared__ float smf[];
  float* sQ = smf;
  float* sK = sQ + kBr32 * LDQ;
  float* sV = sK + kBc32 * LDQ;
  float* sP = sV + kBc32 * LDV;

  const int r = threadIdx.x / 8;   // query row in the tile
  const int c8 = threadIdx.x % 8;  // lane within the row's 8 threads
  const long long q0 = (long long)blockIdx.x * kBr32;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;

  const float* qb = reinterpret_cast<const float*>(p.q) + b * p.qs.b + h * p.qs.n;
  const float* kb = reinterpret_cast<const float*>(p.k) + b * p.ks.b + h * p.ks.n;
  const float* vb = reinterpret_cast<const float*>(p.v) + b * p.vs.b + h * p.vs.n;
  float* ob = reinterpret_cast<float*>(p.out) + b * p.os.b + h * p.os.n;

  load_tile_f32<D, kBr32, ROPE>(sQ, LDQ, qb, p.qs.s, q0, p.sq, p.cos, p.sin);

  float o[DV];
#pragma unroll
  for (int i = 0; i < DV; ++i) o[i] = 0.f;
  float m = -INFINITY, l = 0.f;

  const long long n_tiles = (p.kv_end + kBc32 - 1) / kBc32;
  for (long long j = 0; j < n_tiles; ++j) {
    const long long k0 = j * kBc32;
    __syncthreads();
    load_tile_f32<D, kBc32, ROPE>(sK, LDQ, kb, p.ks.s, k0, p.sk, p.cos, p.sin);
    load_tile_f32<D, kBc32, false>(sV, LDV, vb, p.vs.s, k0, p.sk, nullptr, nullptr);
    __syncthreads();

    float s[kBc32 / 8];
    float mx = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < kBc32 / 8; ++jj) {
      const int c = c8 + 8 * jj;
      const float* qr = sQ + r * LDQ;
      const float* kr = sK + c * LDQ;
      float a = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) a = fmaf(qr[d], kr[d], a);
      float x = a * p.scale_log2;
      if (k0 + c >= p.kv_end) x = -INFINITY;
      s[jj] = x;
      mx = fmaxf(mx, x);
    }
    const float mn = fmaxf(m, warp_max_xor(mx, 8));
    const float mu = (mn == -INFINITY) ? 0.f : mn;
    const float alpha = exp2f(m - mu);
    m = mn;
    float rs = 0.f;
#pragma unroll
    for (int jj = 0; jj < kBc32 / 8; ++jj) {
      const float e = exp2f(s[jj] - mu);
      rs += e;
      sP[r * LDP + c8 + 8 * jj] = e;
    }
    l = l * alpha + rs;
    __syncwarp();  // a row's 8 threads share one warp
#pragma unroll
    for (int i = 0; i < DV; ++i) o[i] *= alpha;
    for (int c = 0; c < kBc32; ++c) {
      const float pc = sP[r * LDP + c];
      const float* vr = sV + c * LDV + c8;
#pragma unroll
      for (int i = 0; i < DV; ++i) o[i] = fmaf(pc, vr[8 * i], o[i]);
    }
  }

  l = warp_sum_xor(l, 8);
  const long long row = q0 + r;
  if (row < p.sq) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    float* orow = ob + row * p.os.s + c8;
#pragma unroll
    for (int i = 0; i < DV; ++i) orow[8 * i] = o[i] * inv;
    if (c8 == 0) p.lse[(b * p.n_heads + h) * p.sq + row] = lse_of(m, l);
  }
}

// ---------------------------------------------------------------------------
// launch helpers
// ---------------------------------------------------------------------------

template <int D, bool ROPE>
cudaError_t launch_bf16(const Params& p, dim3 grid, cudaStream_t st) {
  const size_t smem = sizeof(__nv_bfloat16) * (size_t)(kBr16 + 2 * kBc16) * (D + 8);
  auto kern = flash_fwd_bf16_kernel<D, ROPE>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, kThreads16, smem, st>>>(p);
  return cudaGetLastError();
}

template <int D, bool ROPE>
cudaError_t launch_f32(const Params& p, dim3 grid, cudaStream_t st) {
  const size_t smem = f32_smem_bytes<D>();
  auto kern = flash_fwd_f32_kernel<D, ROPE>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, kThreads32, smem, st>>>(p);
  return cudaGetLastError();
}

template <bool ROPE>
cudaError_t dispatch(int is_bf16, int head_dim, const Params& p, long long batch,
                     cudaStream_t st) {
  if (is_bf16) {
    const dim3 grid((unsigned)((p.sq + kBr16 - 1) / kBr16), (unsigned)p.n_heads,
                    (unsigned)batch);
    // bf16 D = 128 is served by flash_fwd_sm90.cu
    switch (head_dim) {
      case 64: return launch_bf16<64, ROPE>(p, grid, st);
      default: return cudaErrorInvalidValue;
    }
  }
  const dim3 grid((unsigned)((p.sq + kBr32 - 1) / kBr32), (unsigned)p.n_heads,
                  (unsigned)batch);
  switch (head_dim) {
    case 32: return launch_f32<32, ROPE>(p, grid, st);
    case 64: return launch_f32<64, ROPE>(p, grid, st);
    case 80: return launch_f32<80, ROPE>(p, grid, st);
    case 128: return launch_f32<128, ROPE>(p, grid, st);
    case 384: return launch_f32<384, ROPE>(p, grid, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 12 element strides, (b, s, n) for q, k, v, out in that order.
// Returns a cudaError_t value; 0 means the kernel was launched.
extern "C" int svi_flash_fwd(int is_bf16, int head_dim, int rope, const void* q,
                             const void* k, const void* v, void* out, float* lse,
                             const float* cos, const float* sin, long long batch,
                             long long n_heads, long long sq, long long sk,
                             long long kv_len, float scale, const long long* strides,
                             void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lse = lse;
  p.cos = cos;
  p.sin = sin;
  p.sq = sq;
  p.sk = sk;
  p.kv_end = kv_len < sk ? kv_len : sk;
  if (p.kv_end < 0) p.kv_end = 0;
  p.n_heads = (int)n_heads;
  p.scale_log2 = scale * kLog2e;
  p.qs = Strides{strides[0], strides[1], strides[2]};
  p.ks = Strides{strides[3], strides[4], strides[5]};
  p.vs = Strides{strides[6], strides[7], strides[8]};
  p.os = Strides{strides[9], strides[10], strides[11]};
  if (batch == 0 || n_heads == 0 || sq == 0) return (int)cudaSuccess;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const cudaError_t err = rope ? dispatch<true>(is_bf16, head_dim, p, batch, st)
                               : dispatch<false>(is_bf16, head_dim, p, batch, st);
  return (int)err;
}
