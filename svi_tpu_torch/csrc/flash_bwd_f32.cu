// Non-causal flash-attention backward for Hopper (sm_90a), float32, on the
// (B, N, S, D) route: head dims 40, 64, 80 and 160, on the tensor cores in
// 3xTF32. Plain C interface.
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
// q, k, v and dO are read through (B, S, N, D) element strides (16-byte
// aligned, strides multiples of 4 elements: the wrapper checks); dq, dk and
// dv are written contiguous (B, S, N*D). No RoPE: the SD stacks have none.
// kv_len < Sk is the caller's (it cuts the keys first).
//
// Arithmetic: every product in 3xTF32 on mma.sync m16n8k8 with f32
// accumulators, as the f32 forward (flash_fwd_f32.cu) takes its products:
// each f32 operand x is split in registers into hi = tf32(x) and lo =
// tf32(x - hi) and a*b is taken as a_hi*b_hi + a_hi*b_lo + a_lo*b_hi, about
// 2^-21 relative per product, so the gradients keep f32-level error (TF32
// alone gives 1e-3). What bounds the kernels: the operations, 3 products of
// Sq x Sk x D per head for dq (S, dP, dQ) and 4 for dk / dv (S, dP, dV,
// dK), three TF32 products each at 495 TFLOP/s (165 TFLOP/s of f32 work).
// The f32 FMA kernels they replace ran at 10x that bound. wgmma is not
// used: TF32 wgmma takes only K-major shared-memory operands, and three of
// the five products contract over the rows of K, dO or Q (MN-major).
//
// Design:
//   1. dq (flash_bwd_f32_dq_kernel): one CTA of 4 warps per (BM query rows,
//      head, batch); warp w owns MT m-tiles of 16 rows. Q and dO arrive once
//      by cp.async and stay in shared memory; BN-key K and V tiles stream
//      through a two-stage cp.async ring, so tile j + 1 loads while tile j
//      is multiplied. Per tile: S = Q K^T and dP = dO V^T as accumulators
//      (Q's and dO's A fragments read and split once per 8-wide k-step and
//      used across the tile's keys), P = exp2(S scale log2(e) - lse log2(e))
//      and dS = P (dP - delta) in registers (a key past Sk gets P = 0), then
//      dQ += dS K with dS's accumulators as the A operand: keys are taken in
//      the order (2t, 2t+1) for lane t within each 8-wide k-step, so the
//      accumulator pair (2t, 2t+1) is the A fragment as it stands (the
//      forward's P.V does the same), and K's B fragment is rows 2t and
//      2t + 1. dQ stays in registers for the whole pass.
//   2. dk / dv (flash_bwd_f32_dkv_kernel): K5b's structure
//      (flash_bwd_split_sm90.cu, item 2). One CTA per (64 keys, head, batch,
//      query chunk), K and V resident in shared memory; BQ-row Q and dO tiles
//      with their lse and delta stream through the ring. S^T = K Q^T and
//      dP^T = V dO^T keep keys as rows, so P^T and dS^T are the A operands of
//      dV += P^T dO and dK += dS^T Q as they stand. At D = 160 two warps
//      share each 16 keys and own half of dK's and dV's columns each (both
//      compute the 16 rows' scores).
//   3. Bank conflicts: every tile's rows are padded to a stride L = 4 mod 8
//      floats, so that the A and B fragments of the score products (row g,
//      column t of a k-step) and the B fragments of the dQ / dK / dV
//      products (rows 2t and 2t + 1, column g) fall on 32 distinct banks.
//   4. Filling the card: the grid of dk / dv is 64-key tiles x heads x
//      batch, 16 CTAs at SD 1.5's 77 text keys. The caller cuts the query
//      axis into n_chunks chunks of whole 64-row units (the rule is the
//      wrapper's, ops/attention.py `_f32_dkv_chunks`: about two waves of the
//      card's SMs). With one chunk the kernel writes dk (scaled) and dv
//      itself. With more, each chunk writes its partial dK and dV into its
//      own slot of an f32 scratch buffer of the caller's, and
//      sum_chunks_kernel adds the slots in chunk order and scales dk: no sum
//      crosses CTAs by atomics, so both gradients are the same bit for bit
//      from run to run.
//   5. Long sums: the mma's f32 accumulate does not round to nearest, and a
//      sum that stays in the accumulators over 4096 keys (1536 accumulates)
//      drifts with their count: on an H100, dq, dk and dv at S4096 came
//      within 0.29-0.43 of the 1e-4 bound, at S1024 within 0.06-0.13. Every
//      kFlushRows (256) rows of the other side each thread adds its dQ, or
//      dK and dV, into its own place of the output (or the chunk's slot)
//      with round-to-nearest f32 adds and starts again from 0: 0.04-0.06 of
//      the bound at S4096, for 1-7% of the time.
// Ragged edges: rows past Sq / Sk are zero-filled by cp.async's source size
// and never stored. A zero-filled query row (lse and delta read as 0) gives
// P = 1 and dS = 0 against a zero dO, so it adds nothing to dK or dV; a key
// past Sk is masked to P = 0 in dq (its K row is 0, but P could overflow).
//
// kernels/build.py builds this source once per head dim, each in an nvcc of
// its own (-DSVI_GROUP -DSVI_D<d>); without SVI_GROUP every head dim is
// built.

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
  float* dk_part;       // (n_chunks, B, Sk, N*D) partial sums when n_chunks > 1
  float* dv_part;
  long long sq, sk;
  int n_heads;
  int n_chunks;         // query chunks of dk / dv
  float scale;          // softmax scale
  float scale_log2;     // scale * log2(e)
  Strides qs, ks, vs, gs;
};

constexpr int kKeyRows = 64;    // keys per CTA of dk / dv
constexpr int kChunkRows = 64;  // query chunks are whole multiples of this
constexpr int kFlushRows = 256;  // rows of the other side a long sum takes in registers

// a tile row of d floats padded to 4 mod 8 (16-byte aligned rows)
__host__ __device__ constexpr int padded(int d) { return d + (12 - d % 8) % 8; }

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [row0, row0 + ROWS) of one head, D floats each, into a tile of row
// stride padded(D); rows at or past nrows are zero-filled
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void issue_rows(float* dst, const float* src, long long row_stride,
                                           long long row0, long long nrows) {
  constexpr int kVec = D / 4;  // 16-byte chunks per row
  constexpr int L = padded(D);
  for (int idx = threadIdx.x; idx < ROWS * kVec; idx += THREADS) {
    const int r = idx / kVec, cv = idx % kVec;
    const long long gr = row0 + r;
    const bool ok = gr < nrows;
    cp_async16(dst + r * L + 4 * cv, src + (ok ? gr : 0) * row_stride + 4 * cv, ok);
  }
}

// b split once for every m-tile that multiplies it
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh[0], bh[1]);
  mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}

__device__ __forceinline__ void split2(float b0, float b1, uint32_t (&bh)[2], uint32_t (&bl)[2]) {
  split_tf32(b0, bh[0], bl[0]);
  split_tf32(b1, bh[1], bl[1]);
}

// the A fragment (rows g and g + 8, columns t and t + 4) of a 16 x 8 block
// of a padded tile, split
template <int L>
__device__ __forceinline__ void a_frag(const float* p, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float x[4] = {p[0], p[8 * L], p[4], p[8 * L + 4]};
  split4(x, hi, lo);
}

// a thread's pair of a long sum, flushed from its registers into its place
// in global memory: written at the first flush, read back and added to at
// the later ones (no other thread touches it), scaled at the last
__device__ __forceinline__ void flush_pair(float* dst, float a, float b, bool first, bool last,
                                           float scale) {
  float2 x = make_float2(a, b);
  if (!first) {
    const float2 y = *reinterpret_cast<const float2*>(dst);
    x.x += y.x;
    x.y += y.y;
  }
  if (last) {
    x.x *= scale;
    x.y *= scale;
  }
  *reinterpret_cast<float2*>(dst) = x;
}

// an accumulator block (rows g, g + 8; columns 2t, 2t + 1) as the A fragment
// of a product over its columns, split
__device__ __forceinline__ void acc_frag(const float (&c)[4], uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  const float x[4] = {c[0], c[2], c[1], c[3]};
  split4(x, hi, lo);
}

// ---------------------------------------------------------------------------
// K5a's function: dQ per BM query rows, walking the keys
// ---------------------------------------------------------------------------

template <int D_, int MT_, int BN_, int MIN_BLOCKS_>
struct DqCfg {
  static constexpr int D = D_, MT = MT_, BN = BN_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int WARPS = 4, THREADS = 32 * WARPS;
  static constexpr int BM = 16 * MT * WARPS;  // query rows per CTA
  static constexpr int L = padded(D);
  static constexpr int KS = D / 8;             // k-steps of S and dP
  static constexpr int NT = BN / 8;            // 8-key groups of a tile
  static constexpr int OT = D / 8;             // 8-column groups of dQ
  static constexpr int RES = 2 * BM * L;       // Q, dO
  static constexpr int STAGE = 2 * BN * L;     // K, V
  static constexpr int FLUSH = kFlushRows / BN;  // key tiles between two flushes of dQ
  static constexpr size_t SMEM = sizeof(float) * (size_t)(RES + 2 * STAGE);
  static_assert(D % 8 == 0 && BN % 8 == 0 && kFlushRows % BN == 0, "tiling");
  static_assert(SMEM <= 227 * 1024, "shared memory of one CTA");
};

// the thread's dQ sums into dq (rows g and g + 8 of each m-tile past none of
// Sq), then zeroed
template <class C>
__device__ __forceinline__ void flush_dq(float (&acc)[C::MT][C::OT][4], const BwdF32Params& p,
                                         long long b, int h, long long row, int t, bool first,
                                         bool last) {
  const long long nd = (long long)p.n_heads * C::D;
#pragma unroll
  for (int m = 0; m < C::MT; ++m) {
    const long long r0 = row + 16 * m;
    float* row0 = p.dq + (b * p.sq + r0) * nd + (long long)h * C::D + 2 * t;
#pragma unroll
    for (int ot = 0; ot < C::OT; ++ot) {
      if (r0 < p.sq)
        flush_pair(row0 + ot * 8, acc[m][ot][0], acc[m][ot][1], first, last, p.scale);
      if (r0 + 8 < p.sq)
        flush_pair(row0 + 8 * nd + ot * 8, acc[m][ot][2], acc[m][ot][3], first, last, p.scale);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][ot][i] = 0.f;
    }
  }
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
    flash_bwd_f32_dq_kernel(BwdF32Params p) {
  constexpr int D = C::D, L = C::L, MT = C::MT;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sG = sQ + C::BM * L;
  float* ring = smem + C::RES;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const long long q0 = (long long)blockIdx.x * C::BM;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const float* qb = p.q + b * p.qs.b + h * p.qs.n;
  const float* kb = p.k + b * p.ks.b + h * p.ks.n;
  const float* vb = p.v + b * p.vs.b + h * p.vs.n;
  const float* gb = p.g + b * p.gs.b + h * p.gs.n;
  const int n_tiles = (int)((p.sk + C::BN - 1) / C::BN);
  const int wrow = warp * 16 * MT;  // the warp's first row in the CTA

  float acc[MT][C::OT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int ot = 0; ot < C::OT; ++ot)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][ot][i] = 0.f;

  if (n_tiles > 0) {
    issue_rows<D, C::BM, C::THREADS>(sQ, qb, p.qs.s, q0, p.sq);
    issue_rows<D, C::BM, C::THREADS>(sG, gb, p.gs.s, q0, p.sq);
    cp_commit();
    issue_rows<D, C::BN, C::THREADS>(ring, kb, p.ks.s, 0, p.sk);
    issue_rows<D, C::BN, C::THREADS>(ring + C::BN * L, vb, p.vs.s, 0, p.sk);
    cp_commit();
  }

  // lse * log2(e) and delta of the thread's rows (g and g + 8 of each m-tile)
  float l2[MT][2], dl[MT][2];
  {
    const long long rb = (b * p.n_heads + h) * p.sq;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const long long gr = q0 + wrow + 16 * m + g + 8 * r;
        const bool ok = gr < p.sq;
        l2[m][r] = ok ? p.lse[rb + gr] * kLog2e : 0.f;
        dl[m][r] = ok ? p.delta[rb + gr] : 0.f;
      }
  }

  for (int j = 0; j < n_tiles; ++j) {
    const float* sK = ring + (j & 1) * C::STAGE;
    const float* sV = sK + C::BN * L;
    if (j + 1 < n_tiles) {  // tile j + 1 into the stage tile j - 1 used
      float* nK = ring + ((j + 1) & 1) * C::STAGE;
      const long long k1 = (long long)(j + 1) * C::BN;
      issue_rows<D, C::BN, C::THREADS>(nK, kb, p.ks.s, k1, p.sk);
      issue_rows<D, C::BN, C::THREADS>(nK + C::BN * L, vb, p.vs.s, k1, p.sk);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // tile j (and Q, dO) in shared memory for every thread

    // S = Q K^T and dP = dO V^T over the tile: MT x 16 rows x BN keys
    float s[MT][C::NT][4], dp[MT][C::NT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[m][nt][i] = dp[m][nt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < C::KS; ++kk) {
      uint32_t qh[MT][4], ql[MT][4], gh[MT][4], gl[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int off = (wrow + 16 * m + g) * L + kk * 8 + t;
        a_frag<L>(sQ + off, qh[m], ql[m]);
        a_frag<L>(sG + off, gh[m], gl[m]);
      }
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
        const int off = (nt * 8 + g) * L + kk * 8 + t;
        uint32_t bh[2], bl[2];
        split2(sK[off], sK[off + 4], bh, bl);
#pragma unroll
        for (int m = 0; m < MT; ++m) mma3(s[m][nt], qh[m], ql[m], bh, bl);
        split2(sV[off], sV[off + 4], bh, bl);
#pragma unroll
        for (int m = 0; m < MT; ++m) mma3(dp[m][nt], gh[m], gl[m], bh, bl);
      }
    }

    // P and dS in place of S (keys past Sk: P = 0)
    const long long k0 = (long long)j * C::BN;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i >> 1;
          const bool live = k0 + nt * 8 + 2 * t + (i & 1) < p.sk;
          const float pr = live ? exp2f(s[m][nt][i] * p.scale_log2 - l2[m][r]) : 0.f;
          s[m][nt][i] = pr * (dp[m][nt][i] - dl[m][r]);
        }

    // dQ += dS K: the accumulator pair (2t, 2t + 1) of key group nt is dS's
    // A fragment, K's B fragment is rows 2t and 2t + 1 at column g
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt) {
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) acc_frag(s[m][nt], ah[m], al[m]);
      const float* kc = sK + (nt * 8 + 2 * t) * L + g;
#pragma unroll
      for (int ot = 0; ot < C::OT; ++ot) {
        uint32_t bh[2], bl[2];
        split2(kc[ot * 8], kc[ot * 8 + L], bh, bl);
#pragma unroll
        for (int m = 0; m < MT; ++m) mma3(acc[m][ot], ah[m], al[m], bh, bl);
      }
    }
    // every kFlushRows keys the sums leave the registers, so that each mma's
    // f32 accumulate rounds (toward zero) against a short partial sum
    if (j + 1 == n_tiles || (j + 1) % C::FLUSH == 0)
      flush_dq<C>(acc, p, b, h, q0 + wrow + g, t, j < C::FLUSH, j + 1 == n_tiles);
    __syncthreads();  // every warp is done with this stage
  }
  if (n_tiles == 0) flush_dq<C>(acc, p, b, h, q0 + wrow + g, t, true, true);
}

// ---------------------------------------------------------------------------
// K5b's function: dK, dV per 64 keys and query chunk, walking the queries
// ---------------------------------------------------------------------------

template <int D_, int BQ_, int WC_, int MIN_BLOCKS_>
struct DkvCfg {
  static constexpr int D = D_, BQ = BQ_, WC = WC_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int WR = kKeyRows / 16;     // row groups of 16 keys
  static constexpr int THREADS = 32 * WR * WC;
  static constexpr int L = padded(D);
  static constexpr int KS = D / 8;             // k-steps of S^T and dP^T
  static constexpr int NT = BQ / 8;            // 8-query groups of a tile
  static constexpr int DW = D / WC;            // dK / dV columns of one warp
  static constexpr int OT = DW / 8;
  static constexpr int RES = 2 * kKeyRows * L;        // K, V
  static constexpr int STAGE = 2 * BQ * L + 2 * BQ;   // Q, dO, lse, delta
  static constexpr int FLUSH = kFlushRows / BQ;       // steps between two flushes
  static constexpr size_t SMEM = sizeof(float) * (size_t)(RES + 2 * STAGE);
  static_assert(DW % 8 == 0 && BQ % 8 == 0 && kChunkRows % BQ == 0 && kFlushRows % BQ == 0,
                "tiling");
  static_assert(SMEM <= 227 * 1024, "shared memory of one CTA");
};

template <class C>
__device__ __forceinline__ void issue_query_tile(float* st, const float* qb, const float* gb,
                                                 const float* lse, const float* delta,
                                                 const BwdF32Params& p, long long q) {
  constexpr int L = C::L;
  issue_rows<C::D, C::BQ, C::THREADS>(st, qb, p.qs.s, q, p.sq);
  issue_rows<C::D, C::BQ, C::THREADS>(st + C::BQ * L, gb, p.gs.s, q, p.sq);
  float* sL = st + 2 * C::BQ * L;
  for (int r = threadIdx.x; r < C::BQ; r += C::THREADS) {
    const long long gr = q + r;
    const bool ok = gr < p.sq;
    cp_async4(sL + r, lse + (ok ? gr : 0), ok);
    cp_async4(sL + C::BQ + r, delta + (ok ? gr : 0), ok);
  }
  cp_commit();
}

// the thread's dK and dV sums (keys g and g + 8 of its warp past none of
// Sk, columns col and col + 1 of each 8-column group) into dk (scaled at the
// last flush) and dv with one chunk, or into the chunk's slots of the
// partial buffers; then zeroed
template <class C>
__device__ __forceinline__ void flush_dkv(float (&dk)[C::OT][4], float (&dv)[C::OT][4],
                                          const BwdF32Params& p, long long b, int h,
                                          long long chunk, long long key, int col, bool first,
                                          bool last) {
  const long long nd = (long long)p.n_heads * C::D;
  const bool whole = p.n_chunks == 1;
  const long long slot = whole ? 0 : chunk * p.sk * nd * (long long)gridDim.z;
  float* dkb = (whole ? p.dk : p.dk_part + slot) + (long long)h * C::D + col;
  float* dvb = (whole ? p.dv : p.dv_part + slot) + (long long)h * C::D + col;
  const float ks = whole ? p.scale : 1.f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long r = key + 8 * half;
    if (r >= p.sk) continue;
    const long long row = (b * p.sk + r) * nd;
#pragma unroll
    for (int ot = 0; ot < C::OT; ++ot) {
      flush_pair(dkb + row + ot * 8, dk[ot][2 * half], dk[ot][2 * half + 1], first, last, ks);
      flush_pair(dvb + row + ot * 8, dv[ot][2 * half], dv[ot][2 * half + 1], first, last, 1.f);
    }
  }
#pragma unroll
  for (int ot = 0; ot < C::OT; ++ot)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[ot][i] = dv[ot][i] = 0.f;
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
    flash_bwd_f32_dkv_kernel(BwdF32Params p) {
  constexpr int D = C::D, L = C::L;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + kKeyRows * L;
  float* ring = smem + C::RES;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp / C::WC, wc = warp % C::WC;
  const int g = lane / 4, t = lane % 4;
  const int c0 = wc * C::DW;  // this warp's dK / dV columns
  const long long n_kt = (p.sk + kKeyRows - 1) / kKeyRows;
  const long long chunk = blockIdx.x / n_kt;
  const long long k0 = (blockIdx.x % n_kt) * kKeyRows;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const float* qb = p.q + b * p.qs.b + h * p.qs.n;
  const float* kb = p.k + b * p.ks.b + h * p.ks.n;
  const float* vb = p.v + b * p.vs.b + h * p.vs.n;
  const float* gb = p.g + b * p.gs.b + h * p.gs.n;
  const long long rb = (b * p.n_heads + h) * p.sq;
  const float* lse = p.lse + rb;
  const float* delta = p.delta + rb;

  // this chunk's queries: 64-row units [u0, u1), cut at Sq
  const long long units = (p.sq + kChunkRows - 1) / kChunkRows;
  const long long qa = chunk * units / p.n_chunks * kChunkRows;
  const long long qz_units = (chunk + 1) * units / p.n_chunks * kChunkRows;
  const long long qz = qz_units < p.sq ? qz_units : p.sq;
  const int n_steps = qz > qa ? (int)((qz - qa + C::BQ - 1) / C::BQ) : 0;

  float dk[C::OT][4], dv[C::OT][4];
#pragma unroll
  for (int ot = 0; ot < C::OT; ++ot)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[ot][i] = dv[ot][i] = 0.f;

  if (n_steps > 0) {
    issue_rows<D, kKeyRows, C::THREADS>(sK, kb, p.ks.s, k0, p.sk);
    issue_rows<D, kKeyRows, C::THREADS>(sV, vb, p.vs.s, k0, p.sk);
    cp_commit();
    issue_query_tile<C>(ring, qb, gb, lse, delta, p, qa);
  }

  const int krow = wr * 16;  // the warp's first key in the CTA
  for (int j = 0; j < n_steps; ++j) {
    const float* sQ = ring + (j & 1) * C::STAGE;
    const float* sG = sQ + C::BQ * L;
    const float* sL = sG + C::BQ * L;
    const float* sD = sL + C::BQ;
    if (j + 1 < n_steps) {
      issue_query_tile<C>(ring + ((j + 1) & 1) * C::STAGE, qb, gb, lse, delta, p,
                          qa + (long long)(j + 1) * C::BQ);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // step j (and K, V) in shared memory for every thread

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x BQ queries
    float st[C::NT][4], dpt[C::NT][4];
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[nt][i] = dpt[nt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < C::KS; ++kk) {
      uint32_t kh[4], kl[4], vh[4], vl[4];
      const int aoff = (krow + g) * L + kk * 8 + t;
      a_frag<L>(sK + aoff, kh, kl);
      a_frag<L>(sV + aoff, vh, vl);
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
        const int off = (nt * 8 + g) * L + kk * 8 + t;
        uint32_t bh[2], bl[2];
        split2(sQ[off], sQ[off + 4], bh, bl);
        mma3(st[nt], kh, kl, bh, bl);
        split2(sG[off], sG[off + 4], bh, bl);
        mma3(dpt[nt], vh, vl, bh, bl);
      }
    }

    // P^T and dS^T in place (query columns 2t, 2t + 1 of each group)
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qc = nt * 8 + 2 * t + (i & 1);
        const float pr = exp2f(st[nt][i] * p.scale_log2 - sL[qc] * kLog2e);
        st[nt][i] = pr;
        dpt[nt][i] = pr * (dpt[nt][i] - sD[qc]);
      }

    // dV += P^T dO and dK += dS^T Q over the step's queries (queries 2t,
    // 2t + 1 of each k-step; B fragments rows 2t, 2t + 1 at column g)
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt) {
      uint32_t ph[4], pl[4], dh[4], dl[4];
      acc_frag(st[nt], ph, pl);
      acc_frag(dpt[nt], dh, dl);
      const int off = (nt * 8 + 2 * t) * L + c0 + g;
#pragma unroll
      for (int ot = 0; ot < C::OT; ++ot) {
        uint32_t bh[2], bl[2];
        split2(sG[off + ot * 8], sG[off + ot * 8 + L], bh, bl);
        mma3(dv[ot], ph, pl, bh, bl);
        split2(sQ[off + ot * 8], sQ[off + ot * 8 + L], bh, bl);
        mma3(dk[ot], dh, dl, bh, bl);
      }
    }
    // every kFlushRows queries the sums leave the registers (as in dq)
    if (j + 1 == n_steps || (j + 1) % C::FLUSH == 0)
      flush_dkv<C>(dk, dv, p, b, h, chunk, k0 + krow + g, c0 + 2 * t, j < C::FLUSH,
                   j + 1 == n_steps);
    __syncthreads();  // every warp is done with this stage
  }
  if (n_steps == 0) flush_dkv<C>(dk, dv, p, b, h, chunk, k0 + krow + g, c0 + 2 * t, true, true);
}

// out[i] = scale * (part[0][i] + part[1][i] + ...), chunks added in order
__global__ void sum_chunks_kernel(const float4* __restrict__ part, float4* __restrict__ out,
                                  long long n4, int n_chunks, float scale) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    float4 a = part[i];
    for (int c = 1; c < n_chunks; ++c) {
      const float4 x = part[c * n4 + i];
      a.x += x.x;
      a.y += x.y;
      a.z += x.z;
      a.w += x.w;
    }
    out[i] = make_float4(a.x * scale, a.y * scale, a.z * scale, a.w * scale);
  }
}

cudaError_t start(void (*kern)(BwdF32Params), size_t smem, int threads, long long blocks,
                  const BwdF32Params& p, long long batch, cudaStream_t st) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)blocks, (unsigned)p.n_heads, (unsigned)batch);
  kern<<<grid, threads, smem, st>>>(p);
  return cudaGetLastError();
}

template <class C>
cudaError_t launch_dq(const BwdF32Params& p, long long batch, cudaStream_t st) {
  return start(flash_bwd_f32_dq_kernel<C>, C::SMEM, C::THREADS, (p.sq + C::BM - 1) / C::BM, p,
               batch, st);
}

template <class C>
cudaError_t launch_dkv(const BwdF32Params& p, long long batch, cudaStream_t st) {
  return start(flash_bwd_f32_dkv_kernel<C>, C::SMEM, C::THREADS,
               (p.sk + kKeyRows - 1) / kKeyRows * p.n_chunks, p, batch, st);
}

// Tiles per head dim. dq: DqCfg<D, m-tiles a warp, keys a tile, CTAs an SM>;
// dk / dv: DkvCfg<D, queries a step, warps sharing 16 keys, CTAs an SM>.
#if !defined(SVI_GROUP) || defined(SVI_D40)
using DqCfg40 = DqCfg<40, 2, 32, 2>;    // 128 rows, 68 KB
using DkvCfg40 = DkvCfg<40, 64, 1, 2>;  // 68 KB
#endif
#if !defined(SVI_GROUP) || defined(SVI_D64)
using DqCfg64 = DqCfg<64, 1, 64, 2>;    // 64 rows, 104 KB
using DkvCfg64 = DkvCfg<64, 64, 1, 2>;  // 104 KB
#endif
#if !defined(SVI_GROUP) || defined(SVI_D80)
using DqCfg80 = DqCfg<80, 1, 64, 1>;    // 64 rows, 129 KB
using DkvCfg80 = DkvCfg<80, 64, 1, 1>;  // 130 KB
#endif
#if !defined(SVI_GROUP) || defined(SVI_D160)
using DqCfg160 = DqCfg<160, 1, 32, 1>;    // 64 rows, 168 KB
using DkvCfg160 = DkvCfg<160, 32, 2, 1>;  // 8 warps, 168 KB
#endif

template <bool DQ>
cudaError_t dispatch(int head_dim, const BwdF32Params& p, long long batch, cudaStream_t st) {
  switch (head_dim) {
#if !defined(SVI_GROUP) || defined(SVI_D40)
    case 40: return DQ ? launch_dq<DqCfg40>(p, batch, st) : launch_dkv<DkvCfg40>(p, batch, st);
#endif
#if !defined(SVI_GROUP) || defined(SVI_D64)
    case 64: return DQ ? launch_dq<DqCfg64>(p, batch, st) : launch_dkv<DkvCfg64>(p, batch, st);
#endif
#if !defined(SVI_GROUP) || defined(SVI_D80)
    case 80: return DQ ? launch_dq<DqCfg80>(p, batch, st) : launch_dkv<DkvCfg80>(p, batch, st);
#endif
#if !defined(SVI_GROUP) || defined(SVI_D160)
    case 160: return DQ ? launch_dq<DqCfg160>(p, batch, st) : launch_dkv<DkvCfg160>(p, batch, st);
#endif
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
  p.n_chunks = 1;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  p.qs = Strides{strides[0], strides[1], strides[2]};
  p.ks = Strides{strides[3], strides[4], strides[5]};
  p.vs = Strides{strides[6], strides[7], strides[8]};
  p.gs = Strides{strides[9], strides[10], strides[11]};
  return p;
}

}  // namespace

// q, k, v, dO: f32 (B, S, N, D) views, 16-byte aligned with element strides
// that are multiples of 4 and a contiguous last dim; strides: 12 element
// strides, (b, s, n) for q, k, v, dO in that order; lse and delta contiguous
// (B, N, Sq). Each returns a cudaError_t value; 0 means launched.
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

// n_chunks >= 1 query chunks (at most one per 64 queries); with more than
// one, dk_part and dv_part are (n_chunks, B, Sk, N*D) f32 scratch buffers
// (their contents are overwritten), else they may be null.
extern "C" int svi_flash_bwd_f32_dkv(int head_dim, const float* q, const float* k, const float* v,
                                     const float* g, const float* lse, const float* delta,
                                     float* dk, float* dv, float* dk_part, float* dv_part,
                                     long long n_chunks, long long batch, long long n_heads,
                                     long long sq, long long sk, float scale,
                                     const long long* strides, void* stream) {
  BwdF32Params p = make_params(q, k, v, g, lse, delta, n_heads, sq, sk, scale, strides);
  p.dk = dk;
  p.dv = dv;
  p.dk_part = dk_part;
  p.dv_part = dv_part;
  if (batch == 0 || n_heads == 0 || sk == 0) return (int)cudaSuccess;
  const long long units = (sq + kChunkRows - 1) / kChunkRows;
  if (n_chunks < 1 || (n_chunks > 1 && (n_chunks > units || !dk_part || !dv_part)))
    return (int)cudaErrorInvalidValue;
  p.n_chunks = (int)n_chunks;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = dispatch<false>(head_dim, p, batch, st);
  if (err != cudaSuccess || n_chunks == 1) return (int)err;
  const long long n4 = batch * sk * n_heads * head_dim / 4;
  const long long blocks = (n4 + 255) / 256 < 4096 ? (n4 + 255) / 256 : 4096;
  sum_chunks_kernel<<<(unsigned)blocks, 256, 0, st>>>(reinterpret_cast<const float4*>(dk_part),
                                                      reinterpret_cast<float4*>(dk), n4,
                                                      (int)n_chunks, scale);
  sum_chunks_kernel<<<(unsigned)blocks, 256, 0, st>>>(reinterpret_cast<const float4*>(dv_part),
                                                      reinterpret_cast<float4*>(dv), n4,
                                                      (int)n_chunks, 1.f);
  return (int)cudaGetLastError();
}
