// Flash-attention forward for Hopper (sm_90a), float32, on the tensor cores
// through 3xTF32. Plain C interface.
//
// Replaces, for f32 inputs, the Pallas TPU kernels
// svi_tpu/ops/attention.py::_fwd_kernel_flat (K1, launched by
// _flash_fwd_pallas_flat: the Wan VAE's mid-block attention, one head of 384)
// and svi_tpu/ops/attention.py::_fwd_kernel (K2, launched by
// _flash_fwd_pallas: CLIP ViT-H/14, 16 heads of 80; the SD 1.5 UNet's,
// ControlNet's and AnimateDiff's attention, 8 heads of 40, 80 or 160; the SD
// VAE's mid-block, one head of 512, through K1; Hunyuan-DiT's self- and
// cross-attention, 16 heads of 88). The contract is K1's and
// K2's: q, k, v and out as (B, S, N, D) element strides (the last dim
// contiguous), optional interleaved-pair RoPE from (S, D/2) f32 tables applied
// on load, keys at or beyond min(kv_len, Sk) masked, base-e lse (B, N, Sq) f32;
// a row whose keys are all masked gets out = 0 and lse = -1e30 + log(1e-30).
// D is one of 32, 40, 64, 80, 88, 128, 160, 384, 512.
//
// What bounds it on this card: the two products, 4 * Sq * Sk * D FLOP per
// head. f32 stays f32 (TF32 is off for the VAE and CLIP), so the kernel does
// not round its operands to TF32 once: each f32 operand x is split in
// registers into hi = tf32(x) and lo = tf32(x - hi) (rounded as cvt.rna
// rounds: half away from zero on the 13 dropped mantissa bits), and every
// product is a_hi*b_hi + a_hi*b_lo + a_lo*b_hi on mma.sync m16n8k8 TF32 with
// f32 accumulators (CUTLASS's OpMultiplyAddFastF32). That keeps f32-level error,
// about 2^-21 relative per product, at three TF32 products per f32 product:
// the bound is 3 * FLOP at 495 TFLOP/s, below the f32 FMA bound (67 TFLOP/s)
// that the scalar FMA kernel it replaces ran at 10x of. wgmma is not used:
// TF32 wgmma takes only K-major operands, and V is MN-major for P.V.
//
// Design: one CTA per (BM query rows, head, batch), WR x WC warps. Warp (r, c)
// owns query rows 16r .. 16r+15 and the output columns of head-dim slice c
// (D / WC wide), so that at D = 384 a warp holds 16 x 96 of O (48 registers)
// instead of 16 x 384. Its Q rows of slice c stay in registers for the whole
// key loop. Per key tile of BN keys the warp computes the partial scores of
// its slice; with WC > 1 the partials meet in shared memory and every warp of
// the row group sums them in the same order, so they all hold the same S, run
// the same online softmax (f32, base 2, log2(e) folded into the scale) and
// multiply P by their slice of V. Keys within each 8-wide k-step are taken in
// the order (2t, 2t+1) for lane t, for Q.K^T (Q and K pairs load as one
// 64-bit word) and for P.V (S's accumulator pair (2t, 2t+1) is then P's A
// fragment as it stands, and V's B fragment reads rows 2t and 2t+1): a sum
// over a k-step does not depend on the order of its terms' indices. K and V
// tiles arrive by cp.async in a double-buffered ring, so tile j + 1 loads
// while tile j is multiplied; rows past Sk are zero-filled by cp.async's
// source size and masked with kv_len. K's and V's row strides (the first of
// D + 8, D + 16, D + 24 that is 8 or 24 mod 32: D + 16 at D = 40 and D = 88,
// D + 8 elsewhere; and D + 4 floats) put each warp's fragment loads on
// distinct banks. Q is staged through shared memory
// on its way to the registers: in the second K/V stage while tile 0 loads
// into the first, or, where BM rows of Q outgrow one stage (D = 512), in both
// stages before tile 0 is issued.
//
// kernels/build.py builds this source once per group of head dims, each in
// an nvcc of its own (-DSVI_GROUP -DSVI_D<d> for each head dim of the
// group), so that no one library sets the build's wall; without SVI_GROUP
// every head dim is built.

#include "flash_common.cuh"

namespace {

using namespace svi;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* out;
  float* lse;         // (B, N, Sq) contiguous
  const float* cos;   // (>= max(Sq, Sk), D/2) contiguous, or null
  const float* sin;
  long long sq, sk;
  long long kv_end;   // min(kv_len, Sk)
  int n_heads;
  float scale_log2;   // softmax scale * log2(e)
  Strides qs, ks, vs, os;
};

template <int D_, int WR_, int WC_, int BN_>
struct Cfg {
  static constexpr int D = D_, WR = WR_, WC = WC_, BN = BN_;
  static constexpr int BM = 16 * WR;          // query rows per CTA
  static constexpr int THREADS = 32 * WR * WC;
  static constexpr int DW = D / WC;           // head-dim slice of one warp
  static constexpr int KS = DW / 8;           // k-steps of Q.K^T over the slice
  static constexpr int NT = BN / 8;           // 8-key groups of a tile
  static constexpr int OT = DW / 8;           // 8-column groups of the warp's O
  // K rows: 64-bit fragment loads, no conflicts (a row stride of 8 or 24 mod 32)
  static constexpr int LDK = (D + 8) % 16 == 8 ? D + 8 : (D + 16) % 16 == 8 ? D + 16 : D + 24;
  static constexpr int LDV = D + 4;           // V rows: 32-bit fragment loads, no conflicts
  static constexpr int STAGE = BN * (LDK + LDV);  // floats of one K + V stage
  static constexpr int PART = WC > 1 ? WC * WR * NT * 128 : 0;  // partial scores
  static constexpr size_t SMEM = sizeof(float) * (size_t)(2 * STAGE + PART);
  // Q is staged in the second stage while tile 0 loads, or in both stages
  // before tile 0 is issued when it does not fit one
  static constexpr bool Q_WIDE = BM * LDK > STAGE;
  static_assert(DW % 8 == 0 && D % 4 == 0, "head-dim slice must be whole k-steps");
  static_assert(BM * LDK <= 2 * STAGE, "Q is staged in the K/V stages");
  static_assert(SMEM <= 227 * 1024, "shared memory of one CTA");
};

__device__ __forceinline__ float lse_of(float m, float l) {
  const float mm = (m == -INFINITY) ? -1e30f : m / kLog2e;
  return mm + logf(fmaxf(l, 1e-30f));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// rotate pairs (2i, 2i+1) by the angle of their row, in f32 with products and
// sums rounded to nearest (no FMA): the plain version's arithmetic
__device__ __forceinline__ void rope_pair(float& x0, float& x1, float c, float s) {
  const float y0 = __fsub_rn(__fmul_rn(x0, c), __fmul_rn(x1, s));
  const float y1 = __fadd_rn(__fmul_rn(x0, s), __fmul_rn(x1, c));
  x0 = y0;
  x1 = y1;
}

// K and V rows [k0, k0 + BN) of one head into a stage; rows past Sk read as 0
// (a warp per row: its lanes copy the row's 16-byte chunks)
template <class C>
__device__ __forceinline__ void issue_kv(float* sK, float* sV, const float* kb, const float* vb,
                                         const Params& p, long long k0) {
  constexpr int kVec = C::D / 4;  // 16-byte chunks per row
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < C::BN; r += C::THREADS / 32) {
    const long long gr = k0 + r;
    const int bytes = gr < p.sk ? 16 : 0;
    const float* krow = kb + (bytes ? gr : 0) * p.ks.s;
    const float* vrow = vb + (bytes ? gr : 0) * p.vs.s;
    const uint32_t dk = static_cast<uint32_t>(__cvta_generic_to_shared(sK + r * C::LDK));
    const uint32_t dv = static_cast<uint32_t>(__cvta_generic_to_shared(sV + r * C::LDV));
#pragma unroll
    for (int cv = lane; cv < kVec; cv += 32) {
      cp_async16(dk + 16 * cv, krow + 4 * cv, bytes);
      cp_async16(dv + 16 * cv, vrow + 4 * cv, bytes);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <class C, bool ROPE>
__global__ void __launch_bounds__(C::THREADS, 1) flash_fwd_f32_tc_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  float* sPart = smem + 2 * C::STAGE;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp / C::WC, wc = warp % C::WC;
  const int g = lane / 4, t = lane % 4;
  const long long q0 = (long long)blockIdx.x * C::BM;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int c0 = wc * C::DW;  // this warp's head-dim slice

  const float* qb = p.q + b * p.qs.b + h * p.qs.n;
  const float* kb = p.k + b * p.ks.b + h * p.ks.n;
  const float* vb = p.v + b * p.vs.b + h * p.vs.n;
  float* ob = p.out + b * p.os.b + h * p.os.n;
  const int n_tiles = (int)((p.kv_end + C::BN - 1) / C::BN);

  // Q (rotated) through stage 1 into registers: pairs (2t, 2t+1) of each
  // k-step; tile 0 loads into stage 0 meanwhile
  {
    float* sQ = C::Q_WIDE ? smem : smem + C::STAGE;
    for (int idx = threadIdx.x; idx < C::BM * (C::D / 2); idx += C::THREADS) {
      const int r = idx / (C::D / 2), i = idx % (C::D / 2);
      const long long gr = q0 + r;
      float2 x = make_float2(0.f, 0.f);
      if (gr < p.sq) {
        x = *reinterpret_cast<const float2*>(qb + gr * p.qs.s + 2 * i);
        if (ROPE) rope_pair(x.x, x.y, p.cos[gr * (C::D / 2) + i], p.sin[gr * (C::D / 2) + i]);
      }
      *reinterpret_cast<float2*>(sQ + r * C::LDK + 2 * i) = x;
    }
  }
  if (!C::Q_WIDE && n_tiles > 0) issue_kv<C>(smem, smem + C::BN * C::LDK, kb, vb, p, 0);
  __syncthreads();
  float qf[C::KS][4];
  {
    const float* q_lo =
        smem + (C::Q_WIDE ? 0 : C::STAGE) + (wr * 16 + g) * C::LDK + c0 + 2 * t;
#pragma unroll
    for (int kk = 0; kk < C::KS; ++kk) {
      const float2 a = *reinterpret_cast<const float2*>(q_lo + kk * 8);
      const float2 b2 = *reinterpret_cast<const float2*>(q_lo + 8 * C::LDK + kk * 8);
      qf[kk][0] = a.x;   // row g, k 2t
      qf[kk][1] = b2.x;  // row g + 8, k 2t
      qf[kk][2] = a.y;   // row g, k 2t + 1
      qf[kk][3] = b2.y;  // row g + 8, k 2t + 1
    }
  }
  __syncthreads();  // the stages Q passed through are free for the K/V tiles
  if (C::Q_WIDE && n_tiles > 0) issue_kv<C>(smem, smem + C::BN * C::LDK, kb, vb, p, 0);

  float o[C::OT][4];
#pragma unroll
  for (int i = 0; i < C::OT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // per-thread partial row sums, reduced at the end

  for (int j = 0; j < n_tiles; ++j) {
    float* sK = smem + (j & 1) * C::STAGE;
    float* sV = sK + C::BN * C::LDK;
    if (j + 1 < n_tiles) {  // tile j + 1 into the stage tile j - 1 used
      float* nK = smem + ((j + 1) & 1) * C::STAGE;
      issue_kv<C>(nK, nK + C::BN * C::LDK, kb, vb, p, (long long)(j + 1) * C::BN);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();  // tile j is in shared memory for every thread
    const long long k0 = (long long)j * C::BN;
    if (ROPE) {
      for (int idx = threadIdx.x; idx < C::BN * (C::D / 2); idx += C::THREADS) {
        const int r = idx / (C::D / 2), i = idx % (C::D / 2);
        const long long gr = k0 + r;
        if (gr < p.sk) {
          float2* x = reinterpret_cast<float2*>(sK + r * C::LDK + 2 * i);
          float2 y = *x;
          rope_pair(y.x, y.y, p.cos[gr * (C::D / 2) + i], p.sin[gr * (C::D / 2) + i]);
          *x = y;
        }
      }
      __syncthreads();
    }

    // partial S = Q K^T over this warp's head-dim slice: 16 rows x BN keys
    float s[C::NT][4];
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < C::KS; ++kk) {
      uint32_t ah[4], al[4];
      split4(qf[kk], ah, al);
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
        const float2 kv2 =
            *reinterpret_cast<const float2*>(sK + (nt * 8 + g) * C::LDK + c0 + kk * 8 + 2 * t);
        mma_3xtf32(s[nt], ah, al, kv2.x, kv2.y);
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

    // scale, mask, online softmax (rows g and g + 8; a row lives in 4 lanes)
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

    // O += P V over the tile: the accumulator pair (2t, 2t+1) of key group
    // nt is P's A fragment (keys taken in the order 2t, 2t+1), V's B
    // fragment is rows 2t and 2t+1
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt) {
      const float pa[4] = {s[nt][0], s[nt][2], s[nt][1], s[nt][3]};
      uint32_t ah[4], al[4];
      split4(pa, ah, al);
      const float* vrow = sV + (nt * 8 + 2 * t) * C::LDV + c0 + g;
#pragma unroll
      for (int ot = 0; ot < C::OT; ++ot)
        mma_3xtf32(o[ot], ah, al, vrow[ot * 8], vrow[ot * 8 + C::LDV]);
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
      *reinterpret_cast<float2*>(ob + r0 * p.os.s + d) =
          make_float2(o[ot][0] * inv[0], o[ot][1] * inv[0]);
    if (r0 + 8 < p.sq)
      *reinterpret_cast<float2*>(ob + (r0 + 8) * p.os.s + d) =
          make_float2(o[ot][2] * inv[1], o[ot][3] * inv[1]);
  }
  if (wc == 0 && t == 0) {
    float* lrow = p.lse + (b * p.n_heads + h) * p.sq;
    if (r0 < p.sq) lrow[r0] = lse_of(m[0], l[0]);
    if (r0 + 8 < p.sq) lrow[r0 + 8] = lse_of(m[1], l[1]);
  }
}

template <class C, bool ROPE>
cudaError_t launch(const Params& p, long long batch, cudaStream_t st) {
  auto kern = flash_fwd_f32_tc_kernel<C, ROPE>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((p.sq + C::BM - 1) / C::BM), (unsigned)p.n_heads, (unsigned)batch);
  kern<<<grid, C::THREADS, C::SMEM, st>>>(p);
  return cudaGetLastError();
}

// tiles per head dim: (D, WR, WC, BN). D = 384 (the Wan VAE, B2 S6240): 32
// rows x 4 column slices of 96 and 32-key tiles (211 KB of shared memory;
// 390 CTAs are 2.95 waves on 132 SMs). D = 512 (the SD VAE, B1 S4096): 32
// rows x 4 slices of 128 and 16-key tiles (141 KB; Q, 32 rows of 520 floats,
// outgrows one stage of 16 keys and is staged in both). D = 160 (the SD
// UNet's deepest levels): 64 rows x 2 slices of 80, as D = 80 runs one (198
// KB). D = 80 (CLIP, S257 N16): 32 rows, 144 CTAs in one wave. D = 88
// (Hunyuan-DiT, B2 S4096 N16, 11 k-steps of 8): 64 rows and 64-key tiles
// (100 KB, two CTAs an SM; 2048 CTAs). D = 32 / 40 / 64 / 128: 64 rows. Queries of at most 16 rows (AnimateDiff's temporal
// attention: 16 frames over thousands of (pixel, head) batches) take one row
// group and 16-key tiles at the SD head dims, so no CTA runs three empty row
// groups beside its one.
template <bool ROPE>
cudaError_t dispatch(int head_dim, const Params& p, long long batch, cudaStream_t st) {
  if (p.sq <= 16) {
    switch (head_dim) {
#if !defined(SVI_GROUP) || defined(SVI_D40)
      case 40: return launch<Cfg<40, 1, 1, 16>, ROPE>(p, batch, st);
#endif
#if !defined(SVI_GROUP) || defined(SVI_D80)
      case 80: return launch<Cfg<80, 1, 1, 16>, ROPE>(p, batch, st);
#endif
#if !defined(SVI_GROUP) || defined(SVI_D160)
      case 160: return launch<Cfg<160, 1, 2, 16>, ROPE>(p, batch, st);
#endif
      default: break;
    }
  }
  switch (head_dim) {
#if !defined(SVI_GROUP) || defined(SVI_D32)
    case 32: return launch<Cfg<32, 4, 1, 64>, ROPE>(p, batch, st);
#endif
#if !defined(SVI_GROUP) || defined(SVI_D40)
    case 40: return launch<Cfg<40, 4, 1, 64>, ROPE>(p, batch, st);
#endif
#if !defined(SVI_GROUP) || defined(SVI_D64)
    case 64: return launch<Cfg<64, 4, 1, 64>, ROPE>(p, batch, st);
#endif
#if !defined(SVI_GROUP) || defined(SVI_D80)
    case 80: return launch<Cfg<80, 2, 1, 64>, ROPE>(p, batch, st);
#endif
#if !defined(SVI_GROUP) || defined(SVI_D88)
    case 88: return launch<Cfg<88, 4, 1, 64>, ROPE>(p, batch, st);
#endif
#if !defined(SVI_GROUP) || defined(SVI_D128)
    case 128: return launch<Cfg<128, 4, 2, 64>, ROPE>(p, batch, st);
#endif
#if !defined(SVI_GROUP) || defined(SVI_D160)
    case 160: return launch<Cfg<160, 4, 2, 64>, ROPE>(p, batch, st);
#endif
#if !defined(SVI_GROUP) || defined(SVI_D384)
    case 384: return launch<Cfg<384, 2, 4, 32>, ROPE>(p, batch, st);
#endif
#if !defined(SVI_GROUP) || defined(SVI_D512)
    case 512: return launch<Cfg<512, 2, 4, 16>, ROPE>(p, batch, st);
#endif
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out: f32 (B, S, N, D) views, 16-byte aligned with element strides
// that are multiples of 4; strides: 12 element strides, (b, s, n) for q, k, v,
// out in that order. Returns a cudaError_t value; 0 means the kernel was
// launched.
extern "C" int svi_flash_fwd_f32(int head_dim, const float* q, const float* k, const float* v,
                                 float* out, float* lse, const float* cos, const float* sin,
                                 long long batch, long long n_heads, long long sq, long long sk,
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
  return (int)(cos ? dispatch<true>(head_dim, p, batch, st)
                   : dispatch<false>(head_dim, p, batch, st));
}
