// Flash-attention forward for Hopper (sm_90a), bf16, at the head dims the
// TMA + wgmma kernel (flash_fwd_sm90.cu, D = 64 and 128) does not take:
// D = 32, 40, 80, 88, 160, 384, 512. Plain C interface.
//
// Replaces, for bf16 inputs, the Pallas TPU kernels
// svi_tpu/ops/attention.py::_fwd_kernel (K2, launched by _flash_fwd_pallas,
// pallas_call at :531: the SD 1.5 UNet's, ControlNet's and AnimateDiff's
// attention, 8 heads of 40, 80 or 160; Hunyuan-DiT's 16 heads of 88) and
// ::_fwd_kernel_flat (K1, pallas_call at :179) at one head (the VAE
// mid-blocks' one head of 512 of SD, SDXL, SD3, Kolors, SVD, OmniGen and
// FLUX). The contract is K2's: q, k, v and out as (B, S, N, D) element
// strides (the last dim contiguous, 16-byte aligned), keys at or beyond
// min(kv_len, Sk) masked, out in bf16 rounded once from f32, base-e lse
// (B, N, Sq) f32; a row whose keys are all masked gets out = 0 and
// lse = -1e30 + log(1e-30). RoPE is not applied here: the wrapper rotates q
// and k first with flash_fwd_sm90.cu's pre-pass (svi_rope_rotate).
//
// Arithmetic, as _fwd_kernel's: Q.K^T with bf16 operands and f32
// accumulation (each product of two bf16 values is exact in f32), the
// softmax scale and log2(e) applied in f32 to the sums, the online softmax
// in f32 and base 2, P rounded to bf16 for P.V (p.astype(v.dtype)) with the
// row sums taken of the unrounded f32 P, P.V accumulated in f32.
//
// What bounds it on this card: the two products, 4 * Sq * Sk * D FLOP per
// head at the bf16 tensor-core rate (989 TFLOP/s), or at short key counts
// the bytes of q and out. This is the simple design: mma.sync m16n8k16 (bf16
// in, f32 accumulators) rather than wgmma, because wgmma's 64-row
// warpgroup would hold a 64 x 512 f32 accumulator at D = 512 (256
// registers a thread) and needs D % 64 == 0. Instead one CTA takes BM query
// rows of one (batch, head), WR x WC warps: warp (r, c) owns query rows
// 16r .. 16r+15 and head-dim slice c (D / WC wide), so that at D = 512 a
// warp holds 16 x 128 of O (64 registers). Its Q fragments of slice c stay
// in registers for the whole key loop. Per key tile of BN keys the warp
// computes the partial scores of its slice; with WC > 1 the partials meet
// in shared memory and every warp of the row group sums them in the same
// order, so they all hold the same S, run the same softmax and multiply P
// by their slice of V. S's f32 accumulator of two 8-key groups, packed to
// bf16, is P's A fragment as it stands; V's B fragments come from
// ldmatrix.trans. D = 40 and D = 88 are not multiples of the k-step of 16:
// the last k-step of Q.K^T holds 8 real columns and 8 zeros in both
// operands' registers (no padded copy of any tensor; the tiles' pad
// columns are never read). K and V tiles arrive by cp.async in a
// double-buffered ring, so tile j + 1 loads while tile j is multiplied;
// rows past Sk are zero-filled by cp.async's source size and masked with
// kv_len. Tiles' row stride (D + 8 or D + 16, 8 mod 16 elements) puts each
// warp's 32-bit fragment loads and ldmatrix rows on distinct banks.
//
// kernels/build.py builds this source once per group of head dims, each in
// an nvcc of its own (-DSVI_GROUP -DSVI_D<d> for each head dim of the
// group), so that no one library sets the build's wall; without SVI_GROUP
// every head dim is built.

#include "flash_common.cuh"

namespace {

using namespace svi;
using bf16 = __nv_bfloat16;

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* out;
  float* lse;  // (B, N, Sq) contiguous
  long long sq, sk;
  long long kv_end;  // min(kv_len, Sk)
  int n_heads;
  float scale_log2;  // softmax scale * log2(e)
  Strides qs, ks, vs, os;
};

template <int D_, int WR_, int WC_, int BN_>
struct Cfg {
  static constexpr int D = D_, WR = WR_, WC = WC_, BN = BN_;
  static constexpr int BM = 16 * WR;               // query rows per CTA
  static constexpr int THREADS = 32 * WR * WC;
  static constexpr int DW = D / WC;                // head-dim slice of one warp
  static constexpr int KS = (DW + 15) / 16;        // k-steps of Q.K^T over the slice
  static constexpr bool HALF_LAST = DW % 16 == 8;  // the last k-step: 8 columns and 8 zeros
  static constexpr int NT = BN / 8;                // 8-key groups of a tile
  static constexpr int OT = DW / 8;                // 8-column groups of the warp's O
  // row stride of the Q, K and V tiles in bf16: 8 mod 16, so that the 8 rows
  // a fragment load or an ldmatrix reads fall on distinct banks
  static constexpr int LD = D % 16 == 0 ? D + 8 : D + 16;
  static constexpr int STAGE = 2 * BN * LD;        // bf16 of one K + V stage
  static constexpr int PART = WC > 1 ? WC * WR * NT * 128 : 0;  // floats of partial scores
  static constexpr size_t SMEM = sizeof(bf16) * 2 * (size_t)STAGE + sizeof(float) * PART;
  static_assert(D % 8 == 0 && DW % 8 == 0 && BN % 16 == 0, "whole 8-wide groups");
  static_assert(WC == 1 || DW % 16 == 0, "a slice of several is whole k-steps");
  static_assert(BM * LD <= STAGE, "Q is staged in the second K/V stage");
  static_assert(SMEM <= 227 * 1024, "shared memory of one CTA");
};

__device__ __forceinline__ float lse_of(float m, float l) {
  const float mm = (m == -INFINITY) ? -1e30f : m / kLog2e;
  return mm + logf(fmaxf(l, 1e-30f));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// two 8x8 bf16 matrices, transposed: lanes 0-7 give the row addresses of the
// first, lanes 8-15 of the second; lane i gets rows 2(i%4), 2(i%4)+1 of
// column i/4 of each
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr)
               : "memory");
}

// K and V rows [k0, k0 + BN) of one head into a stage; rows past Sk read as 0
// (a warp per row: its lanes copy the row's 16-byte chunks)
template <class C>
__device__ __forceinline__ void issue_kv(bf16* sK, bf16* sV, const bf16* kb, const bf16* vb,
                                         const Params& p, long long k0) {
  constexpr int kVec = C::D / 8;  // 16-byte chunks per row
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < C::BN; r += C::THREADS / 32) {
    const long long gr = k0 + r;
    const int bytes = gr < p.sk ? 16 : 0;
    const bf16* krow = kb + (bytes ? gr : 0) * p.ks.s;
    const bf16* vrow = vb + (bytes ? gr : 0) * p.vs.s;
    const uint32_t dk = smem_addr(sK + r * C::LD);
    const uint32_t dv = smem_addr(sV + r * C::LD);
    for (int cv = lane; cv < kVec; cv += 32) {
      cp_async16(dk + 16 * cv, krow + 8 * cv, bytes);
      cp_async16(dv + 16 * cv, vrow + 8 * cv, bytes);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, 1) flash_fwd_bf16_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  float* sPart = reinterpret_cast<float*>(smem_raw + sizeof(bf16) * 2 * (size_t)C::STAGE);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp / C::WC, wc = warp % C::WC;
  const int g = lane / 4, t = lane % 4;
  const long long q0 = (long long)blockIdx.x * C::BM;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int c0 = wc * C::DW;  // this warp's head-dim slice

  const bf16* qb = p.q + b * p.qs.b + h * p.qs.n;
  const bf16* kb = p.k + b * p.ks.b + h * p.ks.n;
  const bf16* vb = p.v + b * p.vs.b + h * p.vs.n;
  bf16* ob = p.out + b * p.os.b + h * p.os.n;
  const int n_tiles = (int)((p.kv_end + C::BN - 1) / C::BN);

  // Q through stage 1 into registers (A fragments of each k-step); tile 0
  // loads into stage 0 meanwhile
  {
    constexpr int kVec = C::D / 8;
    bf16* sQ = smem + C::STAGE;
    for (int idx = threadIdx.x; idx < C::BM * kVec; idx += C::THREADS) {
      const int r = idx / kVec, cv = idx % kVec;
      const long long gr = q0 + r;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (gr < p.sq) x = *reinterpret_cast<const uint4*>(qb + gr * p.qs.s + 8 * cv);
      *reinterpret_cast<uint4*>(sQ + r * C::LD + 8 * cv) = x;
    }
  }
  if (n_tiles > 0) issue_kv<C>(smem, smem + C::BN * C::LD, kb, vb, p, 0);
  __syncthreads();
  uint32_t qf[C::KS][4];
  {
    const bf16* q_lo = smem + C::STAGE + (wr * 16 + g) * C::LD + c0 + 2 * t;
#pragma unroll
    for (int kk = 0; kk < C::KS; ++kk) {
      qf[kk][0] = ld_u32(q_lo + kk * 16);               // row g, k 2t
      qf[kk][1] = ld_u32(q_lo + 8 * C::LD + kk * 16);   // row g + 8, k 2t
      if (C::HALF_LAST && kk == C::KS - 1) {
        qf[kk][2] = qf[kk][3] = 0u;                     // k 2t + 8: past D
      } else {
        qf[kk][2] = ld_u32(q_lo + kk * 16 + 8);              // row g, k 2t + 8
        qf[kk][3] = ld_u32(q_lo + 8 * C::LD + kk * 16 + 8);  // row g + 8, k 2t + 8
      }
    }
  }
  __syncthreads();  // stage 1 is free for tile 1

  float o[C::OT][4];
#pragma unroll
  for (int i = 0; i < C::OT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // per-thread partial row sums, reduced at the end

  for (int j = 0; j < n_tiles; ++j) {
    bf16* sK = smem + (j & 1) * C::STAGE;
    bf16* sV = sK + C::BN * C::LD;
    if (j + 1 < n_tiles) {  // tile j + 1 into the stage tile j - 1 used
      bf16* nK = smem + ((j + 1) & 1) * C::STAGE;
      issue_kv<C>(nK, nK + C::BN * C::LD, kb, vb, p, (long long)(j + 1) * C::BN);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();  // tile j is in shared memory for every thread
    const long long k0 = (long long)j * C::BN;

    // partial S = Q K^T over this warp's head-dim slice: 16 rows x BN keys;
    // K's B fragment is a key row's dims (2t, 2t+1) and (2t+8, 2t+9)
    float s[C::NT][4];
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < C::KS; ++kk) {
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
        const bf16* krow = sK + (nt * 8 + g) * C::LD + c0 + kk * 16 + 2 * t;
        const uint32_t b0 = ld_u32(krow);
        const uint32_t b1 = (C::HALF_LAST && kk == C::KS - 1) ? 0u : ld_u32(krow + 8);
        mma_bf16(s[nt], qf[kk], b0, b1);
      }
    }
    if (C::WC > 1) {  // the row group's partials, summed in slice order by each warp
      float4* part = reinterpret_cast<float4*>(sPart);
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt)
        part[((wr * C::WC + wc) * C::NT + nt) * 32 + lane] =
            make_float4(s[nt][0], s[nt][1], s[nt][2], s[nt][3]);
      __syncthreads();
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
        float4 acc = part[((wr * C::WC) * C::NT + nt) * 32 + lane];
#pragma unroll
        for (int c = 1; c < C::WC; ++c) {
          const float4 x = part[((wr * C::WC + c) * C::NT + nt) * 32 + lane];
          acc.x += x.x;
          acc.y += x.y;
          acc.z += x.z;
          acc.w += x.w;
        }
        s[nt][0] = acc.x;
        s[nt][1] = acc.y;
        s[nt][2] = acc.z;
        s[nt][3] = acc.w;
      }
    }

    // scale in f32, mask, online softmax (rows g and g + 8; a row lives in 4 lanes)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[nt][i] * p.scale_log2;
        if (k0 + nt * 8 + 2 * t + (i & 1) >= p.kv_end) x = -INFINITY;
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
    for (int nt = 0; nt < C::NT; ++nt) {
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
    for (int ot = 0; ot < C::OT; ++ot) {
      o[ot][0] *= alpha[0];
      o[ot][1] *= alpha[0];
      o[ot][2] *= alpha[1];
      o[ot][3] *= alpha[1];
    }

    // O += bf16(P) V: key groups 2ks and 2ks + 1 of S's accumulator, packed
    // to bf16, are P's A fragment of k-step ks; V's B fragments (keys 2t,
    // 2t+1 and 2t+8, 2t+9 of column g) by ldmatrix.trans from rows
    // 16ks + (lane & 15) (lanes 16-31 repeat 0-15; their addresses are unused)
#pragma unroll
    for (int ks = 0; ks < C::BN / 16; ++ks) {
      const uint32_t pa[4] = {pack_bf16(s[2 * ks][0], s[2 * ks][1]),
                              pack_bf16(s[2 * ks][2], s[2 * ks][3]),
                              pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]),
                              pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3])};
      const uint32_t vaddr = smem_addr(sV + (ks * 16 + (lane & 15)) * C::LD + c0);
#pragma unroll
      for (int ot = 0; ot < C::OT; ++ot) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, vaddr + 16 * ot);
        mma_bf16(o[ot], pa, b0, b1);
      }
    }
    __syncthreads();  // every warp is done with this stage and the partials
  }

  const long long r0 = q0 + wr * 16 + g;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = warp_sum_xor(l[r], 4);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int ot = 0; ot < C::OT; ++ot) {
    const int d = c0 + ot * 8 + 2 * t;
    if (r0 < p.sq)
      *reinterpret_cast<uint32_t*>(ob + r0 * p.os.s + d) =
          pack_bf16(o[ot][0] * inv[0], o[ot][1] * inv[0]);
    if (r0 + 8 < p.sq)
      *reinterpret_cast<uint32_t*>(ob + (r0 + 8) * p.os.s + d) =
          pack_bf16(o[ot][2] * inv[1], o[ot][3] * inv[1]);
  }
  if (wc == 0 && t == 0) {
    float* lrow = p.lse + (b * p.n_heads + h) * p.sq;
    if (r0 < p.sq) lrow[r0] = lse_of(m[0], l[0]);
    if (r0 + 8 < p.sq) lrow[r0 + 8] = lse_of(m[1], l[1]);
  }
}

template <class C>
cudaError_t launch(const Params& p, long long batch, cudaStream_t st) {
  auto kern = flash_fwd_bf16_kernel<C>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((p.sq + C::BM - 1) / C::BM), (unsigned)p.n_heads, (unsigned)batch);
  kern<<<grid, C::THREADS, C::SMEM, st>>>(p);
  return cudaGetLastError();
}

// tiles per head dim: (D, WR, WC, BN), shared memory from Cfg::SMEM.
// D = 32 / 40 / 80 / 88: 64 rows, one slice, 64-key tiles (20-53 KB).
// D = 160 (the SD UNet's deepest level): 64 rows x 2 slices of 80 (118 KB).
// D = 384 / 512 (the VAE mid-blocks, one head over 4096-16384 tokens): 32
// rows x 4 slices of 96 / 128 and 32-key tiles (116 / 149 KB).
// Queries of at most 16 rows (AnimateDiff's temporal attention: 16 frames
// over thousands of (pixel, head) batches) take one row group and 16-key
// tiles at the SD head dims, so no CTA runs three empty row groups.
cudaError_t dispatch(int head_dim, const Params& p, long long batch, cudaStream_t st) {
  if (p.sq <= 16) {
    switch (head_dim) {
#if !defined(SVI_GROUP) || defined(SVI_D40)
      case 40: return launch<Cfg<40, 1, 1, 16>>(p, batch, st);
#endif
#if !defined(SVI_GROUP) || defined(SVI_D80)
      case 80: return launch<Cfg<80, 1, 1, 16>>(p, batch, st);
#endif
#if !defined(SVI_GROUP) || defined(SVI_D160)
      case 160: return launch<Cfg<160, 1, 2, 16>>(p, batch, st);
#endif
      default: break;
    }
  }
  switch (head_dim) {
#if !defined(SVI_GROUP) || defined(SVI_D32)
    case 32: return launch<Cfg<32, 4, 1, 64>>(p, batch, st);
#endif
#if !defined(SVI_GROUP) || defined(SVI_D40)
    case 40: return launch<Cfg<40, 4, 1, 64>>(p, batch, st);
#endif
#if !defined(SVI_GROUP) || defined(SVI_D80)
    case 80: return launch<Cfg<80, 4, 1, 64>>(p, batch, st);
#endif
#if !defined(SVI_GROUP) || defined(SVI_D88)
    case 88: return launch<Cfg<88, 4, 1, 64>>(p, batch, st);
#endif
#if !defined(SVI_GROUP) || defined(SVI_D160)
    case 160: return launch<Cfg<160, 4, 2, 64>>(p, batch, st);
#endif
#if !defined(SVI_GROUP) || defined(SVI_D384)
    case 384: return launch<Cfg<384, 2, 4, 32>>(p, batch, st);
#endif
#if !defined(SVI_GROUP) || defined(SVI_D512)
    case 512: return launch<Cfg<512, 2, 4, 32>>(p, batch, st);
#endif
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out: bf16 (B, S, N, D) views, 16-byte aligned with element
// strides that are multiples of 8; cos and sin must be null (the wrapper
// rotates q and k first); strides: 12 element strides, (b, s, n) for q, k,
// v, out in that order. The argument list is svi_flash_fwd_f32's. Returns a
// cudaError_t value; 0 means the kernel was launched (cudaErrorInvalidValue
// for a head dim this library does not hold, or for RoPE tables).
extern "C" int svi_flash_fwd_bf16(int head_dim, const void* q, const void* k, const void* v,
                                  void* out, float* lse, const float* cos, const float* sin,
                                  long long batch, long long n_heads, long long sq, long long sk,
                                  long long kv_len, float scale, const long long* strides,
                                  void* stream) {
  if (cos || sin) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.out = static_cast<bf16*>(out);
  p.lse = lse;
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
  return (int)dispatch(head_dim, p, batch, reinterpret_cast<cudaStream_t>(stream));
}
