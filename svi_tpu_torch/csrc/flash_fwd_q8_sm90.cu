// Int8 (SageAttention-class) flash-attention forward for Hopper (sm_90a),
// head dim 128: TMA-fed integer wgmma with warp specialisation. Plain C
// interface.
//
// Replaces, at D = 128, the Pallas TPU kernel
// svi_tpu/ops/attention.py::_fwd_kernel_flat_q8 (K6, launched by
// _flash_fwd_pallas_flat_q8, pallas_call at :421) on the operands of
// _quant_prep_xla (the port's `_quant_prep`, torch code). What it computes is
// csrc/flash_fwd_q8.cu's contract (that kernel keeps D = 64, route "mma"),
// per query row and 128-key tile:
//   s     = q8 . k8^T                      exact int32
//   c     = qs * (kscale * scale * log2e)
//   m_t   = max(m, float(max_j s) * c)     over every key of the tile, the
//                                          masked and zero-padded ones too
//   p     = exp2((s * c - m_t) + shift)    0 for keys >= min(kv_len, Sk)
//   l     = alpha * l + sum(p),  alpha = exp2(m - m_t)
//   qk8:    acc = acc * alpha + bf16(p) . v
//   qk8pv8: acc = acc * alpha + float(rint(p) . v8)   (exact int32; the
//           kernel keeps the int32 sums of the tiles that share a max and
//           folds them into acc when the max moves: the same sum, rounded
//           fewer times)
//   out   = acc / max(l, 1e-30) in out's type; qk8pv8 then * vss, rounded
//   lse   = m / log2e + log(max(l, 1e-30)) - shift / log2e
// with shift = log2(127) for qk8pv8 and 0 for qk8. The plain version
// (`_flash_fwd_q8_reference` with block_k = Q8_BLOCK_K[128] = 128) walks the
// same tiles; the tile width sets where the running max is taken, so the two
// agree on it.
//
// What bounds it on this card: at the DiT's self-attention (S = 32760, 40
// heads) the tensor cores, Q.K^T at the int8 rate and P.V at the bf16 (qk8)
// or int8 (qk8pv8) rate: 16.7 / 11.1 ms. Beside that bound runs a floor the
// tensor-core bound does not show: one exp2 per score, B N S^2 = 4.3e10 of
// them at S = 32760, ~10-12 ms on the MUFU units, which is why the softmax
// of one warpgroup runs under the other's products. The design is the bf16
// forward's (flash_fwd_sm90.cu):
//   1. integer wgmma m64n128k32 for S = Q K^T, both operands K-major (q8
//      and k8 are D-contiguous; one 128-byte swizzled row holds a whole head
//      row, four k32 steps of 32 bytes): K from shared memory, Q from
//      registers, its s8 A fragments loaded once per CTA (faster at the
//      DiT's shape than reading Q from shared memory every tile);
//   2. one producer warp fills a 4-stage K/V ring by TMA, mbarriers guard
//      it; two consumer warpgroups of 64 query rows (setmaxnreg 240) issue
//      tile j's Q K^T and tile j-1's P V together, run tile j's softmax under
//      them, and take turns issuing (ping-pong) so one's softmax runs under
//      the other's products;
//   3. qk8's P V is the bf16 forward's: P rounded to bf16 as the register A
//      operand, V bf16 read MN-major (the transpose bit). qk8pv8's P V8 is an
//      integer wgmma, which takes K-major operands only: a pre-pass kernel
//      (v8_keys_major_kernel, below) stores v8 transposed to
//      (B, N, D, Sk_pad), keys contiguous and permuted
//      inside each 32-key chunk (slot 16h + 4t + i holds key 16h + {2t, 2t+1,
//      8+2t, 9+2t}[i]), so that a thread's own accumulator values of P,
//      rounded to int8, are its A fragment with no shuffle;
//   4. conversions on the critical path use full-rate instructions: a score
//      (|s| <= 127 * 127 * 128 < 2^22) becomes f32 as the bits of
//      1.5 * 2^23 + s less 1.5 * 2^23, and P (in [0, 127]) becomes int8 as
//      the low byte of p + 1.5 * 2^23 (round half to even); the row max
//      stays on int32; s * c - m (+ shift) is one FMA. Work per score that
//      the max does not need is skipped while a row's max holds: O is
//      rescaled (qk8) and the int32 P V8 sums folded into O (qk8pv8) only
//      when it moves;
//   5. keys past Sk are zero-filled by TMA (score 0, as the TPU kernel's
//      padded keys); only tiles that reach past kv_len are masked. The out
//      rows are written from registers (no staging tile fits beside the
//      ring at qk8's 48 KB stages). qk8pv8 keeps O in shared memory (see
//      o_bytes): its registers hold S, the int32 sums, P and Q.

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLog2_127 = 6.9886846867721655f;
constexpr float kLn127 = 4.844187086458591f;  // log2(127) / log2(e)
constexpr float kNegInit = -1e30f;            // the TPU kernel's initial row max

constexpr int kD = 128;
constexpr int kBM = 128;       // query rows per CTA: two consumer warpgroups of 64
constexpr int kBN = 128;       // keys per tile
constexpr int kStages = 4;     // K/V ring depth (a 2-stage ring is slower at S = 32760)
constexpr int kThreads = 384;  // warpgroups 0 and 1 consume, warpgroup 2 produces
constexpr int kConsumerWarps = 8;  // each releases a stage with one arrival
constexpr uint32_t kRowBytes = 128;
constexpr uint32_t kI8Tile = kBN * kRowBytes;   // 16 KB: 128 rows of 128 int8
constexpr uint32_t kBf16Box = kBN * kRowBytes;  // 16 KB: 128 rows of 64 bf16
constexpr int kBf16BoxCols = 64;

template <bool PV8>
__host__ __device__ constexpr uint32_t v_bytes() {
  return PV8 ? kI8Tile : 2 * kBf16Box;
}
// qk8pv8 keeps its f32 O in shared memory (64 KB: a warpgroup's 64 rows x
// 128 channels, element i of thread t at word 128 i + t): it is touched only
// when a row's max moves and at the end, and the registers go to S, the
// int32 P.V8 sums, P and Q
template <bool PV8>
__host__ __device__ constexpr uint32_t o_bytes() {
  return PV8 ? 2 * 64 * kD * 4 : 0;
}
template <bool PV8>
constexpr size_t smem_bytes() {
  return kI8Tile + kStages * (kI8Tile + v_bytes<PV8>()) + o_bytes<PV8>() +
         8 * (3 * kStages + 1) + 1024;
}

struct Params {
  const float* qs;      // (B, N, Sq) contiguous
  const float* kscale;  // (B, N) contiguous
  const float* vss;     // (B, N, D) contiguous, qk8pv8 only
  void* out;            // bf16, or f32 (qk8pv8 only)
  float* lse;           // (B, N, Sq) contiguous
  long long sq, sk;
  long long kv_end;     // min(kv_len, Sk)
  long long osb, oss, osn;  // out's element strides (b, s, n)
  int n_heads;
  float scale;
};

// shared-memory map from a 1024-byte aligned base: the Q tile, the K ring,
// the V ring, (qk8pv8) O, the barriers
__device__ __forceinline__ uint32_t k_tile(uint32_t base, int st) {
  return base + kI8Tile * (1 + st);
}
template <bool PV8>
__device__ __forceinline__ uint32_t v_tile(uint32_t base, int st) {
  return base + kI8Tile * (1 + kStages) + v_bytes<PV8>() * st;
}
template <bool PV8>
__device__ __forceinline__ uint32_t o_tile(uint32_t base, int wg) {
  return base + kI8Tile * (1 + kStages) + v_bytes<PV8>() * kStages + 64 * kD * 4 * wg;
}
template <bool PV8>
__device__ __forceinline__ uint32_t bar_full_k(uint32_t base, int st) {
  return base + kI8Tile * (1 + kStages) + v_bytes<PV8>() * kStages + o_bytes<PV8>() + 8 * st;
}
template <bool PV8>
__device__ __forceinline__ uint32_t bar_full_v(uint32_t base, int st) {
  return bar_full_k<PV8>(base, kStages + st);
}
template <bool PV8>
__device__ __forceinline__ uint32_t bar_empty(uint32_t base, int st) {
  return bar_full_k<PV8>(base, 2 * kStages + st);
}
template <bool PV8>
__device__ __forceinline__ uint32_t bar_q(uint32_t base) {
  return bar_full_k<PV8>(base, 3 * kStages);
}

template <int N>
__device__ __forceinline__ void fence_iregs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ int quad_max_i(int x) {
  x = max(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return max(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// consumer pieces. Accumulator layout of m64n128 (per thread, warp w of the
// warpgroup, lane = 4g + t): d[4j + i] is row 16w + g + 8 * (i >> 1), column
// 8j + 2t + (i & 1).
// ---------------------------------------------------------------------------

// S = Q8 K8^T: this warpgroup's 64 query rows against a 128-key tile
// (Q from registers, loaded once per CTA)
__device__ __forceinline__ void issue_qk(int (&s)[64], const uint32_t (&qf)[16],
                                         uint32_t k_base) {
#pragma unroll
  for (int kk = 0; kk < kD / 32; ++kk) {
    const uint32_t a[4] = {qf[4 * kk], qf[4 * kk + 1], qf[4 * kk + 2], qf[4 * kk + 3]};
    wgmma_s8_rs(s, a, gmma_desc(k_base + kk * 32, 16, 1024), kk > 0);
  }
}

// this thread's s8 A fragments of its warpgroup's 64 Q rows, from the
// swizzled Q tile: step kk, register 4kk + q holds row g + 8 (q & 1), bytes
// 32kk + 16 (q >> 1) + 4t .. + 3
__device__ __forceinline__ void load_q_frags(uint32_t (&qf)[16], uint32_t q_rows, int warp,
                                             int g, int t4) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = warp * 16 + g + 8 * (q & 1);
      const int byte = 32 * kk + 16 * (q >> 1) + 4 * t4;
      const uint32_t addr = q_rows + swizzle128(row, byte / 16) + byte % 16;
      asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(qf[4 * kk + q]) : "r"(addr));
    }
}

// qk8: O += P V over a 128-key tile, P's 16-key slice kk in pf[4kk .. 4kk + 3]
__device__ __forceinline__ void issue_pv_bf16(float (&o)[64], const uint32_t (&pf)[32],
                                              uint32_t v_base) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    const uint32_t a[4] = {pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2], pf[4 * kk + 3]};
    wgmma_rs(o, a, gmma_desc(v_base + kk * 16 * kRowBytes, kBf16Box, 1024));
  }
}

// qk8pv8: pv (+)= rint(P) V8 over a 128-key tile, exact int32 (`first`: pv
// starts from 0); the 32-key chunk c of P is pf[4c .. 4c + 3], of V8^T the
// bytes [32c, 32c + 32) of each row
__device__ __forceinline__ void issue_pv_s8(int (&pv)[64], const uint32_t (&pf)[16],
                                            uint32_t vt_base, bool first) {
#pragma unroll
  for (int c = 0; c < kBN / 32; ++c) {
    const uint32_t a[4] = {pf[4 * c], pf[4 * c + 1], pf[4 * c + 2], pf[4 * c + 3]};
    wgmma_s8_rs(pv, a, gmma_desc(vt_base + c * 32, 16, 1024), c > 0 || !first);
  }
}

// online softmax in base 2 on one tile's integer scores, in place: s[i]
// becomes the bits of p (f32); alpha moves the running sums to the new max.
// The exponent s * c - m (+ shift) is one FMA on the exact f32 score.
template <bool PV8>
__device__ __forceinline__ void softmax_tile(int (&s)[64], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], const float (&c)[2], bool mask,
                                             long long k0, long long kv_end, int t4) {
  // row maxima (and below, row sums) in four interleaved chains a row, so
  // that the reductions are not one dependent chain of 32
  int mx[2][4];
#pragma unroll
  for (int q = 0; q < 4; ++q) mx[0][q] = s[4 * q], mx[1][q] = s[4 * q + 2];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int q = (i >> 2) & 3, r = (i >> 1) & 1;
    mx[r][q] = max(mx[r][q], s[i]);
  }
  float nb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int mr = quad_max_i(max(max(mx[r][0], mx[r][1]), max(mx[r][2], mx[r][3])));
    const float mn = fmaxf(m[r], __fmul_rn(small_int_to_float(mr), c[r]));
    alpha[r] = ex2(__fsub_rn(m[r], mn));
    m[r] = mn;
    nb[r] = PV8 ? __fsub_rn(kLog2_127, mn) : -mn;
  }
  float rs[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    float p = ex2(__fmaf_rn(small_int_to_float(s[i]), c[r], nb[r]));
    if (mask && k0 + 8 * (i / 4) + 2 * t4 + (i & 1) >= kv_end) p = 0.f;
    s[i] = __float_as_int(p);
    rs[r][(i >> 2) & 3] += p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = __fadd_rn(__fmul_rn(alpha[r], l[r]), (rs[r][0] + rs[r][1]) + (rs[r][2] + rs[r][3]));
}

__device__ __forceinline__ float pf_at(const int (&s)[64], int i) { return __int_as_float(s[i]); }

// qk8: P rounded to bf16, the accumulators of key groups 2kk and 2kk + 1 as
// the A fragment of the kk-th 16-key step
__device__ __forceinline__ void pack_p_bf16(uint32_t (&pf)[32], const int (&s)[64]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      pf[4 * kk + q] = pack_bf16(pf_at(s, 8 * kk + 2 * q), pf_at(s, 8 * kk + 2 * q + 1));
}

// qk8pv8: P rounded to int8 (round half to even); the thread's keys {2t,
// 2t+1} of 8-key groups 4c .. 4c + 3 are, in the V8 slot order above, the s8
// A fragment of the 32-key chunk c
__device__ __forceinline__ void pack_p_s8(uint32_t (&pf)[16], const int (&s)[64]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int e = 16 * c;
    pf[4 * c + 0] = pack_low_bytes(rint_bits(pf_at(s, e + 0)), rint_bits(pf_at(s, e + 1)),
                                   rint_bits(pf_at(s, e + 4)), rint_bits(pf_at(s, e + 5)));
    pf[4 * c + 1] = pack_low_bytes(rint_bits(pf_at(s, e + 2)), rint_bits(pf_at(s, e + 3)),
                                   rint_bits(pf_at(s, e + 6)), rint_bits(pf_at(s, e + 7)));
    pf[4 * c + 2] = pack_low_bytes(rint_bits(pf_at(s, e + 8)), rint_bits(pf_at(s, e + 9)),
                                   rint_bits(pf_at(s, e + 12)), rint_bits(pf_at(s, e + 13)));
    pf[4 * c + 3] = pack_low_bytes(rint_bits(pf_at(s, e + 10)), rint_bits(pf_at(s, e + 11)),
                                   rint_bits(pf_at(s, e + 14)), rint_bits(pf_at(s, e + 15)));
  }
}

// qk8: O moves to the new max; a row whose max held (alpha == 1 exactly:
// ex2(0)) is left as it is, which is the same value
__device__ __forceinline__ void rescale(float (&o)[64], const float (&alpha)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (alpha[r] != 1.f) {
#pragma unroll
      for (int i = 0; i < 64; ++i)
        if (((i >> 1) & 1) == r) o[i] *= alpha[r];
    }
  }
}

// qk8pv8: the exact int32 sums pv of the tiles since a row's max last moved
// share that max's scale, so they stay in int32 (|pv| <= 127 * 127 * Sk <
// 2^31 for Sk <= 131072) and fold into the f32 O only when the max moves:
// O = (O + float(pv)) * alpha, pv = 0. The plain version folds every tile;
// the sums are the same, rounded fewer times.
// (O in shared memory: o_sm is this thread's element 0, element i 512 bytes on)
__device__ __forceinline__ float ld_o(uint32_t o_sm, int i) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(o_sm + 512u * i));
  return v;
}
__device__ __forceinline__ void st_o(uint32_t o_sm, int i, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(o_sm + 512u * i), "f"(v) : "memory");
}
__device__ __forceinline__ void fold_pv(uint32_t o_sm, int (&pv)[64], const float (&alpha)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (alpha[r] != 1.f) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        if (((i >> 1) & 1) != r) continue;
        st_o(o_sm, i, __fmul_rn(__fadd_rn(ld_o(o_sm, i), __int2float_rn(pv[i])), alpha[r]));
        pv[i] = 0;
      }
    }
  }
}

// ping-pong turns between the consumer warpgroups (named barriers 3 and 4)
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(3 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int to_wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(3 + to_wg) : "memory");
}

template <typename OutT>
__device__ __forceinline__ void store_pair(OutT* p, float a, float b);
template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}
template <>
__device__ __forceinline__ void store_pair<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

template <bool PV8, typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_q8_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv, const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) & ~1023u;
  const int q0 = blockIdx.x * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (int)((p.sk + kBN - 1) / kBN);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full_k<PV8>(base, st), 1);
      mbar_init(bar_full_v<PV8>(base, st), 1);
      mbar_init(bar_empty<PV8>(base, st), kConsumerWarps);
    }
    mbar_init(bar_q<PV8>(base), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread keeps the K/V ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(bar_q<PV8>(base), kI8Tile);
      tma_load(base, &tq, bar_q<PV8>(base), 0, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        if (j >= kStages) mbar_wait(bar_empty<PV8>(base, st), ((j / kStages) - 1) & 1);
        const uint32_t fk = bar_full_k<PV8>(base, st), fv = bar_full_v<PV8>(base, st);
        mbar_expect_tx(fk, kI8Tile);
        tma_load(k_tile(base, st), &tk, fk, 0, h, j * kBN, b);
        const uint32_t vt = v_tile<PV8>(base, st);
        mbar_expect_tx(fv, v_bytes<PV8>());
        if (PV8) {
          // v8^T (B, N, D, Sk_pad) as rows of keys: channels h*D .. h*D + 127
          tma_load(vt, &tv, fv, j * kBN, 0, h * kD, b);
        } else {
          tma_load(vt, &tv, fv, 0, h, j * kBN, b);
          tma_load(vt + kBf16Box, &tv, fv, kBf16BoxCols, h, j * kBN, b);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
    const uint32_t q_rows = base + wg * 64 * kRowBytes;
    const long long bh = (long long)b * p.n_heads + h;
    const long long row0 = q0 + wg * 64 + warp * 16 + g;
    // per-row score scale c = qs * (kscale * scale * log2e); rows past Sq get 0
    const float kc = __fmul_rn(__fmul_rn(p.kscale[bh], p.scale), kLog2e);
    const float* qsrow = p.qs + bh * p.sq;
    const float c[2] = {row0 < p.sq ? __fmul_rn(qsrow[row0], kc) : 0.f,
                        row0 + 8 < p.sq ? __fmul_rn(qsrow[row0 + 8], kc) : 0.f};
    const long long mask_from = p.kv_end / kBN;  // the first tile with a key >= kv_end

    float o[PV8 ? 1 : 64], m[2] = {kNegInit, kNegInit}, l[2] = {0.f, 0.f}, alpha[2];
    int s[64];
    int pv[PV8 ? 64 : 1];
    uint32_t pf[PV8 ? 16 : 32], qf[16];
    const uint32_t o_sm = o_tile<PV8>(base, wg) + 4 * tid;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      if constexpr (PV8)
        st_o(o_sm, i, 0.f);
      else
        o[i] = 0.f;
    }

    mbar_wait(bar_q<PV8>(base), 0);
    load_q_frags(qf, q_rows, warp, g, t4);
    if (wg == 0) turn_pass(0);  // warpgroup 0 takes the first turn
    mbar_wait(bar_full_k<PV8>(base, 0), 0);
    turn_wait(wg);
    wgmma_fence();
    issue_qk(s, qf, k_tile(base, 0));
    wgmma_commit();
    turn_pass(1 - wg);
    wgmma_wait<0>();
    fence_iregs(s);
    softmax_tile<PV8>(s, m, l, alpha, c, mask_from == 0, 0, p.kv_end, t4);
    if constexpr (PV8) {
      pack_p_s8(pf, s);
    } else {
      pack_p_bf16(pf, s);
    }
    for (int j = 1; j < n_tiles; ++j) {
      const int st = j % kStages, sp = (j - 1) % kStages;
      mbar_wait(bar_full_k<PV8>(base, st), (j / kStages) & 1);
      mbar_wait(bar_full_v<PV8>(base, sp), ((j - 1) / kStages) & 1);
      turn_wait(wg);
      wgmma_fence();
      issue_qk(s, qf, k_tile(base, st));  // tile j's scores
      wgmma_commit();
      if constexpr (PV8)
        issue_pv_s8(pv, pf, v_tile<PV8>(base, sp), j == 1);  // tile j-1's values
      else
        issue_pv_bf16(o, pf, v_tile<PV8>(base, sp));
      wgmma_commit();
      turn_pass(1 - wg);
      wgmma_wait<1>();
      fence_iregs(s);
      softmax_tile<PV8>(s, m, l, alpha, c, j >= mask_from, (long long)j * kBN,
                        p.kv_end, t4);
      wgmma_wait<0>();
      if constexpr (PV8) {
        fence_iregs(pv);
        if (lane == 0) mbar_arrive(bar_empty<PV8>(base, sp));
        fold_pv(o_sm, pv, alpha);
        pack_p_s8(pf, s);
      } else {
        fence_regs(o);
        if (lane == 0) mbar_arrive(bar_empty<PV8>(base, sp));
        rescale(o, alpha);
        pack_p_bf16(pf, s);
      }
    }
    const int sl = (n_tiles - 1) % kStages;
    mbar_wait(bar_full_v<PV8>(base, sl), ((n_tiles - 1) / kStages) & 1);
    wgmma_fence();
    if constexpr (PV8)
      issue_pv_s8(pv, pf, v_tile<PV8>(base, sl), n_tiles == 1);
    else
      issue_pv_bf16(o, pf, v_tile<PV8>(base, sl));
    wgmma_commit();
    wgmma_wait<0>();
    if constexpr (PV8)
      fence_iregs(pv);
    else
      fence_regs(o);

    // epilogue: normalise and write this thread's two rows from registers
    float lm[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) lm[r] = fmaxf(quad_sum(l[r]), 1e-30f);
    OutT* ob = static_cast<OutT*>(p.out) + b * p.osb + h * p.osn;
    const float* vsrow = PV8 ? p.vss + bh * kD : nullptr;
#pragma unroll
    for (int jn = 0; jn < kD / 8; ++jn) {
      const int d = jn * 8 + 2 * t4;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long row = row0 + 8 * half;
        if (row >= p.sq) continue;
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * jn + 2 * half + e;
          float acc;
          if constexpr (PV8)
            acc = __fadd_rn(ld_o(o_sm, i), __int2float_rn(pv[i]));
          else
            acc = o[i];
          y[e] = __fdiv_rn(acc, lm[half]);
          if (PV8) {  // out left in v8 channel units: round to out's type, rescale
            if constexpr (sizeof(OutT) == 2) y[e] = __bfloat162float(__float2bfloat16_rn(y[e]));
            y[e] = __fmul_rn(y[e], vsrow[d + e]);
          }
        }
        store_pair<OutT>(ob + row * p.oss + d, y[0], y[1]);
      }
    }
    if (t4 == 0) {
      float* lrow = p.lse + bh * p.sq;
      const float shift_e = PV8 ? kLn127 : 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long row = row0 + 8 * half;
        if (row < p.sq)
          lrow[row] =
              __fsub_rn(__fadd_rn(__fdiv_rn(m[half], kLog2e), logf(lm[half])), shift_e);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// qk8pv8's V8 pre-pass: v8 (B, Sk, N*D) int8 -> v8^T (B, N, D, Sk_pad), keys
// contiguous and permuted inside each 32-key chunk (slot 16h + 4t + i holds
// key 16h + (2t, 2t+1, 8+2t, 9+2t)[i]), zeros past Sk. One CTA per
// (128-key tile, head, batch) stages the 128 x 128 tile in shared memory, so
// that both its reads and its writes move 16 bytes a thread. Bound by bytes.
// ---------------------------------------------------------------------------

constexpr int kVtThreads = 256;
constexpr int kVtPitch = kD + 16;  // bytes per staged key row

__global__ void __launch_bounds__(kVtThreads)
    v8_keys_major_kernel(const int8_t* __restrict__ v8, int8_t* __restrict__ vt, long long sk,
                         long long sk_pad, int n_heads, long long sb, long long ss) {
  __shared__ __align__(16) int8_t tile[kBN * kVtPitch];
  const long long j0 = (long long)blockIdx.x * kBN;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int8_t* src = v8 + b * sb + (long long)h * kD;
  for (int idx = threadIdx.x; idx < kBN * (kD / 16); idx += kVtThreads) {
    const int key = idx / (kD / 16), c16 = idx % (kD / 16);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (j0 + key < sk) v = *reinterpret_cast<const uint4*>(src + (j0 + key) * ss + c16 * 16);
    *reinterpret_cast<uint4*>(tile + key * kVtPitch + c16 * 16) = v;
  }
  __syncthreads();
  int8_t* dst = vt + ((b * n_heads + h) * kD) * sk_pad + j0;
  for (int idx = threadIdx.x; idx < kD * (kBN / 16); idx += kVtThreads) {
    const int d = idx / (kBN / 16), s16 = idx % (kBN / 16);
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t word = 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int slot = s16 * 16 + 4 * q + e, r = slot % 32;
        const int t = (r % 16) / 4, i = r % 4;
        const int key = slot - r + 16 * (r / 16) + 2 * t + (i & 1) + 8 * (i >> 1);
        word |= (uint32_t)(uint8_t)tile[key * kVtPitch + d] << (8 * e);
      }
      w[q] = word;
    }
    *reinterpret_cast<uint4*>(dst + (long long)d * sk_pad + s16 * 16) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <bool PV8, typename OutT>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, const Params& p,
           dim3 grid, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<PV8>();
  auto kern = flash_fwd_q8_sm90_kernel<PV8, OutT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, kThreads, smem, st>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

}  // namespace

// q8, k8: int8 (B, S, N, 128) views; v: bf16 (B, Sk, N, 128) view (qk8) or,
// for qk8pv8, the contiguous (B, N, 128, sk_pad) int8 v8^T in the key order
// above (sk_pad a multiple of 128); out: bf16 (or f32 for qk8pv8) view.
// strides: 12 element strides, (b, s, n) for q8, k8, v and out in that order
// (v's are not read for qk8pv8). Sk must be at least 1. Returns 0 when the
// kernel was launched, a cudaError_t value, kNoEncodeEntry, or
// kEncodeFailed + the CUresult of the tensor-map encode that failed.
extern "C" int svi_flash_fwd_q8_sm90(int pv8, int out_f32, const void* q8, const float* qs,
                                     const void* k8, const float* kscale, const void* v,
                                     const float* vss, void* out, float* lse, long long batch,
                                     long long n_heads, long long sq, long long sk,
                                     long long sk_pad, long long kv_len, float scale,
                                     const long long* strides, void* stream) {
  if (batch == 0 || n_heads == 0 || sq == 0) return (int)cudaSuccess;
  if (sk <= 0 || (!pv8 && out_f32) || (pv8 && (sk_pad < sk || sk_pad % kBN)))
    return (int)cudaErrorInvalidValue;
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kNoEncodeEntry;
  CUtensorMap tq, tk, tv;
  CUresult r;
  const CUtensorMapDataType u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  if ((r = encode_map(fn, &tq, u8, 1, q8, kD, n_heads, sq, batch, strides + 0, kD, kBM)) !=
          CUDA_SUCCESS ||
      (r = encode_map(fn, &tk, u8, 1, k8, kD, n_heads, sk, batch, strides + 3, kD, kBN)) !=
          CUDA_SUCCESS)
    return kEncodeFailed + (int)r;
  if (pv8) {
    // rows of sk_pad keys: (sk_pad, 1, N * D, B)
    const long long st[3] = {n_heads * kD * sk_pad, sk_pad, sk_pad};
    r = encode_map(fn, &tv, u8, 1, v, sk_pad, 1, n_heads * kD, batch, st, kBN, kD);
  } else {
    r = encode_map(fn, &tv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, v, kD, n_heads, sk, batch,
                   strides + 6, kBf16BoxCols, kBN);
  }
  if (r != CUDA_SUCCESS) return kEncodeFailed + (int)r;
  Params p;
  p.qs = qs;
  p.kscale = kscale;
  p.vss = vss;
  p.out = out;
  p.lse = lse;
  p.sq = sq;
  p.sk = sk;
  p.kv_end = kv_len < sk ? kv_len : sk;
  if (p.kv_end < 0) p.kv_end = 0;
  p.osb = strides[9];
  p.oss = strides[10];
  p.osn = strides[11];
  p.n_heads = (int)n_heads;
  p.scale = scale;
  const dim3 grid((unsigned)((sq + kBM - 1) / kBM), (unsigned)n_heads, (unsigned)batch);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (!pv8) return launch<false, __nv_bfloat16>(tq, tk, tv, p, grid, st);
  return out_f32 ? launch<true, float>(tq, tk, tv, p, grid, st)
                 : launch<true, __nv_bfloat16>(tq, tk, tv, p, grid, st);
}

// v8: int8 (B, Sk, N, 128) view with element strides (sb, ss) of batch and
// key (the head stride is 128, the channels contiguous), 16-byte aligned rows;
// vt: contiguous (B, N, 128, sk_pad), sk_pad a multiple of 128. Returns a
// cudaError_t value; 0 means the kernel was launched.
extern "C" int svi_v8_keys_major(const void* v8, void* vt, long long batch, long long n_heads,
                                 long long sk, long long sk_pad, long long sb, long long ss,
                                 void* stream) {
  if (batch == 0 || n_heads == 0 || sk_pad == 0) return (int)cudaSuccess;
  if (sk_pad % kBN || sk_pad < sk || batch > 65535 || n_heads > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(sk_pad / kBN), (unsigned)n_heads, (unsigned)batch);
  v8_keys_major_kernel<<<grid, kVtThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(v8), static_cast<int8_t*>(vt), sk, sk_pad, (int)n_heads, sb,
      ss);
  return (int)cudaGetLastError();
}
