// Int8 (SageAttention-class) flash-attention forward for Hopper (sm_90a) at
// head dim 64 (route "mma"; D = 128, the DiT's, is flash_fwd_q8_sm90.cu),
// plain C interface.
//
// Replaces the Pallas TPU kernel svi_tpu/ops/attention.py::_fwd_kernel_flat_q8
// (K6, launched by _flash_fwd_pallas_flat_q8). Inputs come from the port's
// `_quant_prep` (torch code, as the JAX package keeps `_quant_prep_xla` in
// XLA): q8 (B, Sq, N*D) int8 roped and quantized per token with scales
// qs (B, N, Sq) f32; k8 (B, Sk, N*D) int8 roped, mean-centred per (b, h,
// channel) and quantized with one scale per (b, h), kscale (B, N) f32; and
//   * qk8:    v (B, Sk, N*D) bf16;
//   * qk8pv8: v8 (B, Sk, N*D) int8 with per-channel scales vss (B, N, D) f32.
// Outputs: out (B, Sq, N*D) bf16 (qk8pv8 also f32) and the base-e lse
// (B, N, Sq) f32 of the CENTRED logits (so this forward has no backward).
//
// What it computes, per query row and key tile of 64 (the JAX kernel's key
// sub-block, with the same arithmetic in the same order):
//   s     = q8 . k8^T                      exact int32 (mma.sync m16n8k32 s8)
//   c     = qs * (kscale * scale * log2e)
//   m_t   = max(m, float(max_j s) * c)     the max runs over every key of the
//                                          tile, masked or zero-padded ones too
//   p     = exp2((s * c - m_t) + shift)    0 for keys >= min(kv_len, Sk)
//   l     = alpha * l + sum(p),  alpha = exp2(m - m_t)
//   qk8:    acc = acc * alpha + bf16(p) . v            (mma.sync m16n8k16 bf16)
//   qk8pv8: acc = acc * alpha + float(rint(p) . v8)    (m16n8k32 s8, exact int32)
//   out   = acc / max(l, 1e-30) rounded to out's type; qk8pv8 then
//           out * vss (v8 channel units back to v's), rounded again;
//   lse   = m / log2e + log(max(l, 1e-30)) - shift / log2e,
// with shift = log2(127) for qk8pv8 (p in [0, 127] before it is rounded to
// int8) and 0 for qk8. The key loop covers every tile up to Sk, not only up
// to kv_len, because the TPU kernel's row max sees its padded keys; the plain
// version (`_flash_fwd_q8_reference`, block 64) mirrors exactly this.
//
// Structure of the package's first bf16 forward (mma.sync, since replaced
// by flash_fwd_sm90.cu): one CTA of 4 warps per
// (64-query tile, head, batch), each warp 16 query rows, a loop over 64-key
// tiles inside the CTA, ragged rows zero-filled in shared memory and masked,
// nothing padded in device memory. Two layout problems of the int8 P.V
// product are solved at staging time:
//   * the s32 accumulator of Q.K^T gives a thread keys {2t, 2t+1} of each
//     8-key group, while an s8 A fragment of m16n8k32 wants keys 4t..4t+3 and
//     16+4t..16+4t+3 of a 32-key chunk. The sum over keys does not care about
//     their order, so V's keys are permuted as they are staged: slot
//     16h + 4t + i of a chunk holds key 16h + {2t, 2t+1, 8+2t, 9+2t}[i], and
//     the thread's own P values are its A fragment with no shuffle;
//   * the s8 B operand needs keys contiguous per channel, so V is transposed
//     into shared memory (sVt[channel][slot]) by 4x4 byte blocks.
//
// What bounds it on this card: at long sequences tensor-core operations:
// Q.K^T on the int8 rate (1979 TOPS dense), P.V on the bf16 rate (989
// TFLOP/s, qk8) or the int8 rate (qk8pv8). This design is the simple one:
// mma.sync fragments read from shared memory with plain loads, no double
// buffering, a CTA-wide barrier around every tile. No main path runs D = 64;
// the D = 128 kernel has the TMA + wgmma design.

#include "flash_common.cuh"

namespace {

using namespace svi;

constexpr float kLog2_127 = 6.9886846867721655f;
constexpr float kLn127 = 4.844187086458591f;  // log2(127) / log2(e)
constexpr float kNegInit = -1e30f;            // the TPU kernel's initial row max

constexpr int kBr = 64;       // query rows per CTA (4 warps x 16)
constexpr int kBc = 64;       // keys per tile
constexpr int kThreads = 128;
constexpr int kLdVt = kBc + 16;  // bytes per channel row of the transposed int8 V tile

struct Params {
  const int8_t* q8;
  const float* qs;      // (B, N, Sq) contiguous
  const int8_t* k8;
  const float* kscale;  // (B, N) contiguous
  const void* v;        // bf16 (qk8) or int8 (qk8pv8)
  const float* vss;     // (B, N, D) contiguous, qk8pv8 only
  void* out;            // bf16, or f32 (qk8pv8 only)
  float* lse;           // (B, N, Sq) contiguous
  long long sq, sk;
  long long kv_end;     // min(kv_len, Sk)
  int n_heads;
  float scale;
  Strides qst, kst, vst, ost;
};

__device__ __forceinline__ uint32_t ld_s8x4(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a (16x32 row-major s8) * b (32x8 col-major s8), s32 accumulate
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// p in [0, 127] (after the log2(127) shift) -> its int8 value, rounded half
// to even as jnp.round does
__device__ __forceinline__ uint32_t pack_p8(float p0, float p1, float p2, float p3) {
  return (uint32_t)__float2int_rn(p0) | ((uint32_t)__float2int_rn(p1) << 8) |
         ((uint32_t)__float2int_rn(p2) << 16) | ((uint32_t)__float2int_rn(p3) << 24);
}

// Rows [row0, row0 + ROWS) of one head's int8 q or k into shared memory (row
// stride D + 16 bytes), 16 bytes per load, zero-filled at or beyond nrows.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile_s8(int8_t* dst, const int8_t* src, long long row_stride,
                                             long long row0, long long nrows) {
  constexpr int LD = D + 16;
  constexpr int kPerRow = D / 16;
  for (int idx = threadIdx.x; idx < ROWS * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow;
    const int cv = idx % kPerRow;
    const long long gr = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < nrows) val = *reinterpret_cast<const uint4*>(src + gr * row_stride + cv * 16);
    *reinterpret_cast<uint4*>(dst + r * LD + cv * 16) = val;
  }
}

// The int8 V tile, transposed and key-permuted: sVt[c * kLdVt + slot] =
// v8[key(slot), c]. Each unit is 4 keys {2t, 2t+1, 8+2t, 9+2t} (+ 16h + 32
// chunk) x 4 channels: four 32-bit loads, a 4x4 byte transpose, four 32-bit
// stores into slots 32 chunk + 16h + 4t .. +3. Keys at or beyond Sk are 0.
template <int D>
__device__ __forceinline__ void load_vt_s8(int8_t* sVt, const int8_t* src, long long row_stride,
                                           long long row0, long long nrows) {
  constexpr int kUnitsPerChannelGroup = kBc / 4;  // 16
  for (int idx = threadIdx.x; idx < kUnitsPerChannelGroup * (D / 4); idx += kThreads) {
    const int u = idx % kUnitsPerChannelGroup;
    const int cg = idx / kUnitsPerChannelGroup;
    const int t = u & 3, h = (u >> 2) & 1, chunk = u >> 3;
    const int kbase = chunk * 32 + h * 16 + 2 * t;
    const int keys[4] = {kbase, kbase + 1, kbase + 8, kbase + 9};
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long gr = row0 + keys[i];
      w[i] = gr < nrows ? ld_s8x4(src + gr * row_stride + cg * 4) : 0u;
    }
    const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140);  // w0.b0 w1.b0 w0.b1 w1.b1
    const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140);
    const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362);  // w0.b2 w1.b2 w0.b3 w1.b3
    const uint32_t hi23 = __byte_perm(w[2], w[3], 0x7362);
    const uint32_t col[4] = {__byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
                             __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632)};
    const int slot = chunk * 32 + h * 16 + 4 * t;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<uint32_t*>(sVt + (cg * 4 + i) * kLdVt + slot) = col[i];
  }
}

template <int D, bool PV8>
constexpr size_t smem_bytes() {
  return (size_t)2 * kBr * (D + 16) +
         (PV8 ? (size_t)D * kLdVt : sizeof(__nv_bfloat16) * (size_t)kBc * (D + 8));
}

template <int D, bool PV8, typename OutT>
__global__ void __launch_bounds__(kThreads) flash_fwd_q8_kernel(Params p) {
  constexpr bool kF32Out = sizeof(OutT) == 4;
  constexpr int LDQ = D + 16;
  constexpr int LDV = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* sQ = reinterpret_cast<int8_t*>(smem_raw);
  int8_t* sK = sQ + kBr * LDQ;
  unsigned char* sV = smem_raw + 2 * kBr * LDQ;  // bf16 rows (qk8) or the int8 sVt (qk8pv8)

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const long long q0 = (long long)blockIdx.x * kBr;
  const int hd = blockIdx.y;
  const long long b = blockIdx.z;
  const long long bh = b * p.n_heads + hd;

  const int8_t* qb = p.q8 + b * p.qst.b + hd * p.qst.n;
  const int8_t* kb = p.k8 + b * p.kst.b + hd * p.kst.n;
  OutT* ob = static_cast<OutT*>(p.out) + b * p.ost.b + hd * p.ost.n;

  load_tile_s8<D, kBr>(sQ, qb, p.qst.s, q0, p.sq);
  __syncthreads();

  // this warp's 16 query rows as s8 A fragments, kept in registers
  uint32_t qf[D / 32][4];
  const int rl0 = warp * 16 + g;
#pragma unroll
  for (int kk = 0; kk < D / 32; ++kk) {
    const int8_t* qp = sQ + rl0 * LDQ + kk * 32 + 4 * t4;
    qf[kk][0] = ld_s8x4(qp);
    qf[kk][1] = ld_s8x4(qp + 8 * LDQ);
    qf[kk][2] = ld_s8x4(qp + 16);
    qf[kk][3] = ld_s8x4(qp + 8 * LDQ + 16);
  }

  const long long r0 = q0 + rl0;
  const long long r1 = r0 + 8;
  // per-row score scale c = qs * (kscale * scale * log2e); rows beyond Sq get 0
  const float kc = __fmul_rn(__fmul_rn(p.kscale[bh], p.scale), kLog2e);
  const float* qsrow = p.qs + bh * p.sq;
  const float c[2] = {r0 < p.sq ? __fmul_rn(qsrow[r0], kc) : 0.f,
                      r1 < p.sq ? __fmul_rn(qsrow[r1], kc) : 0.f};
  const float shift = PV8 ? kLog2_127 : 0.f;

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m[2] = {kNegInit, kNegInit};
  float l[2] = {0.f, 0.f};  // per-thread partial row sums, reduced at the end

  const long long n_tiles = (p.sk + kBc - 1) / kBc;
  for (long long j = 0; j < n_tiles; ++j) {
    const long long k0 = j * kBc;
    __syncthreads();  // every warp is done with the previous k/v tile
    load_tile_s8<D, kBc>(sK, kb, p.kst.s, k0, p.sk);
    if (PV8) {
      const int8_t* vb = static_cast<const int8_t*>(p.v) + b * p.vst.b + hd * p.vst.n;
      load_vt_s8<D>(reinterpret_cast<int8_t*>(sV), vb, p.vst.s, k0, p.sk);
    } else {
      const __nv_bfloat16* vb =
          static_cast<const __nv_bfloat16*>(p.v) + b * p.vst.b + hd * p.vst.n;
      load_tile_bf16<D, kBc, false, kThreads>(reinterpret_cast<__nv_bfloat16*>(sV), vb,
                                               p.vst.s, k0, p.sk, nullptr, nullptr);
    }
    __syncthreads();

    // S = Q K^T, exact in int32, 16 rows x 64 keys
    int s[kBc / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBc / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0;
      const int8_t* kp = sK + (nt * 8 + g) * LDQ + 4 * t4;
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk)
        mma_s8(s[nt], qf[kk], ld_s8x4(kp + kk * 32), ld_s8x4(kp + kk * 32 + 16));
    }

    // the row max on int32 over all 64 keys (masked and padded ones too),
    // then scaled: max commutes with the positive per-row rescale
    int mxi[2] = {s[0][0], s[0][2]};
#pragma unroll
    for (int nt = 0; nt < kBc / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) mxi[i >> 1] = max(mxi[i >> 1], s[nt][i]);
    }
    float mn[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mxi[r] = max(mxi[r], __shfl_xor_sync(0xffffffffu, mxi[r], 1));
      mxi[r] = max(mxi[r], __shfl_xor_sync(0xffffffffu, mxi[r], 2));
      mn[r] = fmaxf(m[r], __fmul_rn((float)mxi[r], c[r]));
      alpha[r] = exp2f(__fsub_rn(m[r], mn[r]));
      m[r] = mn[r];
    }

    // P = exp2(s * c - m_t + shift), 0 for masked keys (kept as float)
    float e[kBc / 8][4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kBc / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long col = k0 + nt * 8 + 2 * t4 + (i & 1);
        const float sf = __fmul_rn((float)s[nt][i], c[i >> 1]);
        const float x = col < p.kv_end ? exp2f(__fadd_rn(__fsub_rn(sf, mn[i >> 1]), shift)) : 0.f;
        e[nt][i] = x;
        rs[i >> 1] += x;
      }
    }
    l[0] = __fadd_rn(__fmul_rn(alpha[0], l[0]), rs[0]);
    l[1] = __fadd_rn(__fmul_rn(alpha[1], l[1]), rs[1]);

    if (PV8) {
      // P rounded to int8; the thread's values are its A fragment because V's
      // keys were permuted when staged (see the header)
      uint32_t a[2][4];
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        const int n0 = 4 * ch;
        a[ch][0] = pack_p8(e[n0][0], e[n0][1], e[n0 + 1][0], e[n0 + 1][1]);
        a[ch][1] = pack_p8(e[n0][2], e[n0][3], e[n0 + 1][2], e[n0 + 1][3]);
        a[ch][2] = pack_p8(e[n0 + 2][0], e[n0 + 2][1], e[n0 + 3][0], e[n0 + 3][1]);
        a[ch][3] = pack_p8(e[n0 + 2][2], e[n0 + 2][3], e[n0 + 3][2], e[n0 + 3][3]);
      }
      const int8_t* sVt = reinterpret_cast<const int8_t*>(sV);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        int pv[4] = {0, 0, 0, 0};
        const int8_t* vp = sVt + (dt * 8 + g) * kLdVt + 4 * t4;
#pragma unroll
        for (int ch = 0; ch < 2; ++ch)
          mma_s8(pv, a[ch], ld_s8x4(vp + ch * 32), ld_s8x4(vp + ch * 32 + 16));
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[dt][i] = __fadd_rn(__fmul_rn(acc[dt][i], alpha[i >> 1]), (float)pv[i]);
      }
    } else {
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        acc[dt][0] *= alpha[0];
        acc[dt][1] *= alpha[0];
        acc[dt][2] *= alpha[1];
        acc[dt][3] *= alpha[1];
      }
      // O += bf16(P) V as in the bf16 forward: the accumulators of two
      // adjacent 8-key tiles are the A fragment of one 16-key step
      const __nv_bfloat16* sVb = reinterpret_cast<const __nv_bfloat16*>(sV);
#pragma unroll
      for (int kk = 0; kk < kBc / 16; ++kk) {
        uint32_t a[4];
        a[0] = pack_bf16(e[2 * kk][0], e[2 * kk][1]);
        a[1] = pack_bf16(e[2 * kk][2], e[2 * kk][3]);
        a[2] = pack_bf16(e[2 * kk + 1][0], e[2 * kk + 1][1]);
        a[3] = pack_bf16(e[2 * kk + 1][2], e[2 * kk + 1][3]);
        const __nv_bfloat16* vrow = sVb + (kk * 16 + 2 * t4) * LDV + g;
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
          const __nv_bfloat16* vp = vrow + dt * 8;
          const uint32_t b0 = pack_bf16_raw(vp[0], vp[LDV]);
          const uint32_t b1 = pack_bf16_raw(vp[8 * LDV], vp[9 * LDV]);
          mma_bf16(acc[dt], a, b0, b1);
        }
      }
    }
  }

  float lm[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = warp_sum_xor(l[r], 4);
    lm[r] = fmaxf(l[r], 1e-30f);
  }
  const float* vsrow = PV8 ? p.vss + bh * D : nullptr;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int d = dt * 8 + 2 * t4;
    float o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[i] = __fdiv_rn(acc[dt][i], lm[i >> 1]);
      if (PV8) {  // out left in v8 channel units: round to out's type, rescale
        if constexpr (!kF32Out) o[i] = __bfloat162float(__float2bfloat16_rn(o[i]));
        o[i] = __fmul_rn(o[i], vsrow[d + (i & 1)]);
      }
    }
    if constexpr (kF32Out) {
      if (r0 < p.sq) *reinterpret_cast<float2*>(ob + r0 * p.ost.s + d) = make_float2(o[0], o[1]);
      if (r1 < p.sq) *reinterpret_cast<float2*>(ob + r1 * p.ost.s + d) = make_float2(o[2], o[3]);
    } else {
      if (r0 < p.sq)
        *reinterpret_cast<uint32_t*>(ob + r0 * p.ost.s + d) = pack_bf16(o[0], o[1]);
      if (r1 < p.sq)
        *reinterpret_cast<uint32_t*>(ob + r1 * p.ost.s + d) = pack_bf16(o[2], o[3]);
    }
  }
  if (t4 == 0) {
    float* lrow = p.lse + bh * p.sq;
    const float shift_e = PV8 ? kLn127 : 0.f;
    if (r0 < p.sq) lrow[r0] = __fsub_rn(__fadd_rn(__fdiv_rn(m[0], kLog2e), logf(lm[0])), shift_e);
    if (r1 < p.sq) lrow[r1] = __fsub_rn(__fadd_rn(__fdiv_rn(m[1], kLog2e), logf(lm[1])), shift_e);
  }
}

template <int D, bool PV8, typename OutT>
cudaError_t launch(const Params& p, dim3 grid, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<D, PV8>();
  auto kern = flash_fwd_q8_kernel<D, PV8, OutT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <bool PV8, typename OutT>
cudaError_t dispatch(int head_dim, const Params& p, dim3 grid, cudaStream_t st) {
  switch (head_dim) {
    case 64: return launch<64, PV8, OutT>(p, grid, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 12 element strides, (b, s, n) for q8, k8, v (or v8) and out, in
// that order, each in units of its own element type. out_f32: out is f32
// (qk8pv8 only) instead of bf16. Returns a cudaError_t value; 0 means the
// kernel was launched.
extern "C" int svi_flash_fwd_q8(int pv8, int out_f32, int head_dim, const void* q8,
                                const float* qs,
                                const void* k8, const float* kscale, const void* v,
                                const float* vss, void* out, float* lse, long long batch,
                                long long n_heads, long long sq, long long sk, long long kv_len,
                                float scale, const long long* strides, void* stream) {
  Params p;
  p.q8 = static_cast<const int8_t*>(q8);
  p.qs = qs;
  p.k8 = static_cast<const int8_t*>(k8);
  p.kscale = kscale;
  p.v = v;
  p.vss = vss;
  p.out = out;
  p.lse = lse;
  p.sq = sq;
  p.sk = sk;
  p.kv_end = kv_len < sk ? kv_len : sk;
  if (p.kv_end < 0) p.kv_end = 0;
  p.n_heads = (int)n_heads;
  p.scale = scale;
  p.qst = Strides{strides[0], strides[1], strides[2]};
  p.kst = Strides{strides[3], strides[4], strides[5]};
  p.vst = Strides{strides[6], strides[7], strides[8]};
  p.ost = Strides{strides[9], strides[10], strides[11]};
  if (batch == 0 || n_heads == 0 || sq == 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)((sq + kBr - 1) / kBr), (unsigned)n_heads, (unsigned)batch);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (!pv8) {
    if (out_f32) return (int)cudaErrorInvalidValue;
    return (int)dispatch<false, __nv_bfloat16>(head_dim, p, grid, st);
  }
  return (int)(out_f32 ? dispatch<true, float>(head_dim, p, grid, st)
                       : dispatch<true, __nv_bfloat16>(head_dim, p, grid, st));
}
