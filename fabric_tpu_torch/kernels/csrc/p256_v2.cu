// The v2 comparison verifier: batched ECDSA-P256 in signed base-2^6
// digits, a team of TPI threads per lane, the products' chunk reduction
// on the int8 tensor cores.
//
// Replaces the JAX program fabric_tpu/ops/p256v2.py::verify_batch
// (jitted as verify_batch_jit), whose field core is
// fabric_tpu/ops/digits.py::DigitMod (mul, settle, canonical, eq_zero)
// and whose point functions are the Renes-Costello-Batina complete
// formulas pt_add, pt_add_mixed and pt_double (a = -3).
//
// What it computes: the reference accept set (bccsp/sw/ecdsa.go:41-58).
// The host supplies the admission bit pre_ok (r, s ranges, low-S, Q's
// range and not (0, 0)) and r + n with rpn_ok, as the reference's
// verify_host does; the device checks Q on the curve, computes s^-1 by
// Fermat, u1 and u2 as canonical digits, the 16-entry u2*Q table, 64
// steps of [4 doublings + add T_Q[w2] + mixed add T_G[w1], skipped at
// digit 0] and the X == r Z or (r+n) Z (mod p) compare.
//
// The form is v2's: a value is 43 signed 6-bit digits.  A product is the
// digit convolution (43 x 43 multiply-adds into 85 columns) plus the
// linear reduction of the 42 high columns, each cut into three 6-bit
// chunks, against the constant R [126 x 43]; then settle's certified
// carry schedule (3 rounds of 3 passes and a chunked fold through F,
// then one tidy pass).  int32 is exact because DigitMod.bound_check keeps
// every column under 2^24.  Each value carries a |digit| bound beside
// its digits, and a product settles ("condenses") an operand exactly
// where the reference's FV.__mul__ does.  The bounds are the same in
// every lane, so every thread of a block takes the same branches: the
// decisions the reference makes at trace time.
//
// What bounds it on Hopper: the integer work of ~5,700 products and
// ~6,700 settles a lane, ~9,000 INT32 operations each, on the CUDA
// cores; the reduction, 60% of a product's multiply-adds, was the TPU's
// matrix product and is the tensor cores' here.  The first design (one
// thread a lane) kept a 15 KB stack a lane in local memory (the
// u2*Q table, eight 43-digit temporaries a formula, the product's
// columns), ran 128 warps at 4,096 lanes on 132 SMs, and streamed R
// (21.7 KB) through __constant__ memory once a product.  This design:
//   - a team of TPI = 8 threads per lane (6 digits a rank, the 43 digits
//     padded to 48), 16 lanes a block, so 4,096 lanes make ~8 warps an
//     SM;
//   - the convolution is the team product of p256_team.cuh: b's digits
//     are broadcast a macro-round at a time with __shfl_sync(width =
//     TPI), each rank adds its own L x L products into 2L columns; rank
//     0's low L columns are then complete and go to the lane's row of an
//     int32 [16 x 48] tile in shared memory, while the rest shift one rank
//     down.  After TPI rounds rank t holds high columns 48 + tL .. + L - 1;
//     columns 43..47 (the first five high ones) came out through rank 0
//     and the ranks holding positions 43..47 take them from the row;
//   - the reduction on the tensor cores in int8, exact: a high column x
//     (|x| < 2^24) is lo = x & 63, mid = (x >> 6) & 63 and hi = x >> 12,
//     and hi = (hi & 63) + 64 (hi >> 6), every part within int8; each
//     rank writes the four chunks of its columns into an int8 [16 x 192]
//     tile, and the block's warps compute, with nvcuda::wmma (m16n16k16,
//     signed char into int),
//         row += [lo | mid | hi & 63] @ R + 64 ((hi >> 6) @ R_hi)
//     against the modulus's int8 [192 x 48] matrix (R's balanced digits
//     lie in [-32, 32]), loaded once a block.  An integer identity, so
//     the digits equal DigitMod.mul's.  Two __syncthreads around it: the
//     whole block follows one schedule;
//   - settle on the CUDA cores across the team: a pass is local but for
//     one __shfl_up_sync of the carry across each rank boundary; digit
//     42's carry (the top rank's) is the fold's `top`, broadcast from the
//     top rank;
//   - canonical forms (6 a lane, at the kernel's edges) settle across the
//     team, then rank 0 runs the serial carries and compares over the
//     lane's row in shared memory;
//   - no local memory: the u2*Q table sits in shared memory as int16 (its
//     entries are pt_add outputs, sums of two settled values: |digit| <=
//     2 * 80 < 2^15), with TG as int8 (canonical digits) and R, F, the
//     moduli and b loaded once a block: ~100 KB a 16-lane block, two
//     blocks an SM.
// Lanes past B run on the last real row with their store masked, so
// every shuffle, vote, barrier and tensor-core product has all of its
// threads.
//
// Frame row (int32, 260 columns): e | r | s | rpn | qx | qy as 43
// canonical digits each, then rpn_ok, pre_ok.  Constant block (int32
// words; the bytes after the 4-word header are copied as they are into
// the first kTableBytes of each block's shared memory):
// settled_p, settled_n, 0, 0 | int8 R tiles of mod p, of mod n (each
// [12 k-tiles][3 n-tiles][16][16], row c*48 + q of the [192 x 48] matrix
// the chunk kind c of column position q) | int32 F [2][4][48] | int32
// digits of p and n [2][48] | int8 TG [16][2][48] | int32 digits of b [48].

#include <cstdint>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

constexpr unsigned kWarp = 0xFFFFFFFFu;
constexpr int K = 43;       // digits of a value
constexpr int KP = 48;      // the digits padded to the team
constexpr int W = 6;
constexpr int DM = 63;
constexpr int kCols = 6 * K + 2;
constexpr int kLanes = 16;  // lanes a block: one m16 tile of the reduction
// threads a lane: 8 was faster than 4 at every batch measured (16 to
// 12,288 lanes) and than 16 from 4,096 lanes up (PERF.md, from
// tools/launch_steps.py --phase comparison on an H100)
constexpr int kTPI = 8;
constexpr int kHeader = 4;  // words of the constant block before its tables
constexpr long long kSumLimit = (1 << 24) / K;

// shared memory, bytes
constexpr int kTileBytes = 256;                         // an int8 16 x 16 tile
constexpr int kKTiles = 12;                             // [lo | mid | hi & 63 | hi >> 6], 48 each
constexpr int kKTilesLow = 9;                           // the first three kinds
constexpr int kNTiles = 3;                              // 48 digit columns
constexpr int kBBytes = kKTiles * kNTiles * kTileBytes;  // one modulus's matrix
constexpr int kOffB = 0;
constexpr int kOffF = kOffB + 2 * kBBytes;              // int32 [2][4][48]
constexpr int kOffM = kOffF + 2 * 4 * KP * 4;           // int32 [2][48]
constexpr int kOffTG = kOffM + 2 * KP * 4;              // int8 [16][2][48]
constexpr int kOffBD = kOffTG + 16 * 2 * KP;            // int32 [48]
constexpr int kTableBytes = kOffBD + KP * 4;
constexpr int kOffA = kTableBytes;                      // int8 [12][16][16] chunk tiles
constexpr int kOffC = kOffA + kKTiles * kTileBytes;     // int32 [16][48] rows
constexpr int kOffTQ = kOffC + kLanes * KP * 4;         // int16 [16][3][48] per lane
constexpr int kTQStride = 16 * 3 * KP * 2 + 32;         // + 32: a bank skew per lane
constexpr int kSmemBytes = kOffTQ + kLanes * kTQStride;
static_assert(kOffA % 32 == 0 && kOffC % 32 == 0, "wmma tiles need 256-bit alignment");

constexpr int P_ = 0;  // mod p
constexpr int N_ = 1;  // mod n

// n - 2, little-endian 32-bit words: the Fermat exponent
__constant__ uint32_t kNm2[8] = {0xFC63254Fu, 0xF3B9CAC2u, 0xA7179E84u, 0xBCE6FAADu,
                                 0xFFFFFFFFu, 0xFFFFFFFFu, 0x00000000u, 0xFFFFFFFFu};

// One lane's team: this thread's rank and the lane's shared rows.
template <int TPI>
struct Lane {
  static constexpr int L = KP / TPI;                // digits a rank
  static constexpr int kTop = (K - 1) / L;          // the rank holding digit 42
  static constexpr int kL42 = (K - 1) - kTop * L;   // digit 42's position there
  int t;            // rank in the team
  int row;          // the lane's row of the block's tiles
  uint32_t team;    // the team's bits in a warp vote
  int32_t keep;     // 0 on the top rank: digit 42's carry is `top`, not digit 43's
  uint8_t* sm;      // the block's shared memory
  int32_t* crow;    // the lane's int32 row
  int32_t settled[2];

  __device__ __forceinline__ Lane(uint8_t* smem, const int32_t* consts) {
    const int lane = threadIdx.x & 31;
    t = lane & (TPI - 1);
    row = threadIdx.x / TPI;
    team = ((1u << (TPI - 1)) * 2u - 1u) << (lane & ~(TPI - 1));
    keep = t == kTop ? 0 : -1;
    sm = smem;
    crow = (int32_t*)(smem + kOffC) + row * KP;
    settled[0] = consts[0];
    settled[1] = consts[1];
  }

  // true when no rank of the team has pred
  __device__ __forceinline__ bool none(bool pred) const {
    return (__ballot_sync(kWarp, pred) & team) == 0u;
  }
};

template <int TPI>
struct FV {
  int32_t d[KP / TPI];
  int32_t b;  // |digit| bound, the same in every lane
};

template <int TPI>
struct PtV {
  FV<TPI> x, y, z;
};

// One settle pass (every digit to its low 6 bits plus the carry of the
// digit below it) across the team; returns digit 42's carry, meaningful
// on the top rank.
template <int TPI>
__device__ __forceinline__ int32_t settle_pass(const Lane<TPI>& ln, int32_t* v) {
  constexpr int L = Lane<TPI>::L;
  int32_t c[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    c[l] = v[l] >> W;
    v[l] &= DM;
  }
  int32_t cin = __shfl_up_sync(kWarp, c[L - 1], 1, TPI);
  if (ln.t == 0) cin = 0;
#pragma unroll
  for (int l = L - 1; l > 0; --l)
    v[l] += (l == Lane<TPI>::kL42 + 1) ? (c[l - 1] & ln.keep) : c[l - 1];
  v[0] += cin;
  return c[Lane<TPI>::kL42];
}

// DigitMod.settle across the team, in place: |digit| < 2^24 in, the
// settled bound out, the value kept mod M.
template <int TPI, int M>
__device__ __forceinline__ void settle(const Lane<TPI>& ln, int32_t* v) {
  constexpr int L = Lane<TPI>::L;
  const int32_t* F = (const int32_t*)(ln.sm + kOffF) + M * 4 * KP + ln.t * L;
#pragma unroll 1
  for (int round = 0; round < 3; ++round) {
    int32_t top = 0;
#pragma unroll
    for (int p = 0; p < 3; ++p) top += settle_pass<TPI>(ln, v);
    top = __shfl_sync(kWarp, top, Lane<TPI>::kTop, TPI);
    const int32_t t0 = top & DM, t1 = (top >> W) & DM, t2 = top >> (2 * W);
#pragma unroll
    for (int l = 0; l < L; ++l) v[l] += t0 * F[l] + t1 * F[KP + l] + t2 * F[2 * KP + l];
  }
  int32_t top = settle_pass<TPI>(ln, v);
  top = __shfl_sync(kWarp, top, Lane<TPI>::kTop, TPI);
#pragma unroll
  for (int l = 0; l < L; ++l) v[l] += top * F[l];
}

// The block's reduction: every lane's row += [lo | mid | hi & 63] @ R +
// 64 ((hi >> 6) @ R_hi), one 16-column tile of the rows per warp.
template <int TPI, int M>
__device__ __forceinline__ void reduce_tiles(const Lane<TPI>& ln) {
  using namespace nvcuda;
  constexpr int kWarps = kLanes * TPI / 32;
  const signed char* A = (const signed char*)(ln.sm + kOffA);
  const signed char* R = (const signed char*)(ln.sm + kOffB + M * kBBytes);
  int* C = (int*)(ln.sm + kOffC);
#pragma unroll 1
  for (int nt = threadIdx.x / 32; nt < kNTiles; nt += kWarps) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc, acc_hi;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> fb;
    wmma::load_matrix_sync(acc, C + nt * 16, KP, wmma::mem_row_major);
    wmma::fill_fragment(acc_hi, 0);
#pragma unroll
    for (int kt = 0; kt < kKTiles; ++kt) {
      wmma::load_matrix_sync(fa, A + kt * kTileBytes, 16);
      wmma::load_matrix_sync(fb, R + (kt * kNTiles + nt) * kTileBytes, 16);
      if (kt < kKTilesLow) {
        wmma::mma_sync(acc, fa, fb, acc);
      } else {
        wmma::mma_sync(acc_hi, fa, fb, acc_hi);
      }
    }
#pragma unroll
    for (int i = 0; i < acc.num_elements; ++i) acc.x[i] += 64 * acc_hi.x[i];
    wmma::store_matrix_sync(C + nt * 16, acc, KP, wmma::mem_row_major);
  }
}

// out = a * b mod M, settled (DigitMod.mul); out may alias a or b.
// Caller contract: |a| |b| K < 2^24.
template <int TPI, int M>
__device__ __forceinline__ void dm_mul(const Lane<TPI>& ln, int32_t* out, const int32_t* a,
                                       const int32_t* b) {
  constexpr int L = Lane<TPI>::L;
  int32_t acc[2 * L];
#pragma unroll
  for (int c = 0; c < 2 * L; ++c) acc[c] = 0;
  // the convolution: macro-round j adds a (own digits) x b (rank j's)
#pragma unroll 1
  for (int j = 0; j < TPI; ++j) {
    int32_t bj[L];
#pragma unroll
    for (int s = 0; s < L; ++s) bj[s] = __shfl_sync(kWarp, b[s], j, TPI);
#pragma unroll
    for (int l = 0; l < L; ++l)
#pragma unroll
      for (int s = 0; s < L; ++s) acc[l + s] += a[l] * bj[s];
    // rank 0's low columns j*L .. j*L + L - 1 are complete
    if (ln.t == 0) {
#pragma unroll
      for (int l = 0; l < L; ++l) ln.crow[j * L + l] = acc[l];
    }
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const int32_t x = __shfl_down_sync(kWarp, acc[l], 1, TPI);
      acc[l] = acc[L + l] + (ln.t == TPI - 1 ? 0 : x);
      acc[L + l] = 0;
    }
  }
  __syncwarp();
  // rank t holds high column 48 + q at position l (q = tL + l); columns
  // 43..47 came out through rank 0 into the row: the ranks holding
  // positions q = 43..47 take them and clear digits 43..47 of the row.
  // The four chunks of each go to the chunk tiles; R's rows are zero
  // where a position holds no column (q = 37..42).
  signed char* A = (signed char*)(ln.sm + kOffA);
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int q = ln.t * L + l;
    int32_t x = acc[l];
    if (q >= K) {
      x = ln.crow[q];
      ln.crow[q] = 0;
    }
    const int32_t hi = x >> (2 * W);
    const int32_t ch[4] = {x & DM, (x >> W) & DM, hi & DM, hi >> W};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = c * KP + q;
      A[(col >> 4) * kTileBytes + ln.row * 16 + (col & 15)] = (signed char)ch[c];
    }
  }
  __syncthreads();
  reduce_tiles<TPI, M>(ln);
  __syncthreads();
  int32_t v[L];
#pragma unroll
  for (int l = 0; l < L; ++l) v[l] = ln.crow[ln.t * L + l];
  settle<TPI, M>(ln, v);
#pragma unroll
  for (int l = 0; l < L; ++l) out[l] = v[l];
}

// sequential carry over the lane's row: digits to [0, 63], returns the carry out
__device__ __forceinline__ int32_t sweep(int32_t* t) {
  int32_t carry = 0;
#pragma unroll 1
  for (int k = 0; k < K; ++k) {
    const int32_t v = t[k] + carry;
    t[k] = v & DM;
    carry = v >> W;
  }
  return carry;
}

// The canonical digits of (value mod M) into the lane's row
// (DigitMod.canonical): settle across the team, then rank 0 runs the
// serial carries and compares over the row.
template <int TPI, int M>
__device__ __forceinline__ void canonical_row(const Lane<TPI>& ln, const int32_t* in) {
  constexpr int L = Lane<TPI>::L;
  int32_t v[L];
#pragma unroll
  for (int l = 0; l < L; ++l) v[l] = in[l];
  settle<TPI, M>(ln, v);
#pragma unroll
  for (int l = 0; l < L; ++l) ln.crow[ln.t * L + l] = v[l];
  __syncwarp();
  if (ln.t == 0) {
    int32_t* t = ln.crow;
    const int32_t* F0 = (const int32_t*)(ln.sm + kOffF) + M * 4 * KP;
    const int32_t* m = (const int32_t*)(ln.sm + kOffM) + M * KP;
#pragma unroll 1
    for (int r = 0; r < 3; ++r) {
      const int32_t over = sweep(t);
#pragma unroll 1
      for (int k = 0; k < K; ++k) t[k] += over * F0[k];
    }
    sweep(t);
#pragma unroll 1
    for (int r = 0; r < 4; ++r) {  // value < 2^258 < 5m for both moduli
      bool gt = false, lt = false;
#pragma unroll 1
      for (int k = K - 1; k >= 0; --k) {
        const bool und = !gt && !lt;
        gt = gt || (und && t[k] > m[k]);
        lt = lt || (und && t[k] < m[k]);
      }
      const int32_t ge = (gt || !lt) ? 1 : 0;
#pragma unroll 1
      for (int k = 0; k < K; ++k) t[k] -= ge * m[k];
      sweep(t);
    }
  }
  __syncwarp();
}

// value == 0 (mod M), any representation (DigitMod.eq_zero)
template <int TPI, int M>
__device__ __forceinline__ bool eq_zero(const Lane<TPI>& ln, const int32_t* in) {
  canonical_row<TPI, M>(ln, in);
  int32_t acc = 0;
#pragma unroll
  for (int l = 0; l < Lane<TPI>::L; ++l) acc |= ln.crow[ln.t * Lane<TPI>::L + l];
  return ln.none(acc != 0);
}

// the canonical scalar in the lane's row as eight little-endian words,
// in every rank
template <int TPI>
__device__ __forceinline__ void row_words(const Lane<TPI>& ln, uint32_t* u) {
#pragma unroll
  for (int i = 0; i < 8; ++i) u[i] = 0u;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const uint32_t d = (uint32_t)ln.crow[k];
    const int b = W * k;
    if ((b >> 5) < 8) u[b >> 5] |= d << (b & 31);
    if ((b & 31) > 32 - W && (b >> 5) + 1 < 8) u[(b >> 5) + 1] |= d >> (32 - (b & 31));
  }
  __syncwarp();
}

// the top 4-bit window of a 256-bit scalar, which then moves up by 4
// bits (so the scalar stays in registers: no runtime word index)
__device__ __forceinline__ int next_window(uint32_t* u) {
  const int d = (int)(u[7] >> 28);
#pragma unroll
  for (int k = 7; k > 0; --k) u[k] = (u[k] << 4) | (u[k - 1] >> 28);
  u[0] <<= 4;
  return d;
}

// -- FV: the reference's bound-tracked field value ----------------------

template <int TPI>
__device__ __forceinline__ void fv_add(FV<TPI>& o, const FV<TPI>& a, const FV<TPI>& b) {
  const int32_t bound = a.b + b.b;
#pragma unroll
  for (int l = 0; l < KP / TPI; ++l) o.d[l] = a.d[l] + b.d[l];
  o.b = bound;
}

template <int TPI>
__device__ __forceinline__ void fv_sub(FV<TPI>& o, const FV<TPI>& a, const FV<TPI>& b) {
  const int32_t bound = a.b + b.b;
#pragma unroll
  for (int l = 0; l < KP / TPI; ++l) o.d[l] = a.d[l] - b.d[l];
  o.b = bound;
}

template <int TPI>
__device__ __forceinline__ void fv_select(FV<TPI>& o, const FV<TPI>& a, const FV<TPI>& b,
                                          bool take_a) {
#pragma unroll
  for (int l = 0; l < KP / TPI; ++l) o.d[l] = take_a ? a.d[l] : b.d[l];
  o.b = take_a ? a.b : b.b;
}

// o = a * b, condensing the fatter side first when the pairing limit
// would be passed, then both (FV.__mul__).  The settles run through one
// site: bit k of `side` names the k-th one's operand (1: b).
template <int TPI, int M>
__device__ __forceinline__ void fv_mul(const Lane<TPI>& ln, FV<TPI>& o, const FV<TPI>& a,
                                       const FV<TPI>& b) {
  constexpr int L = Lane<TPI>::L;
  const int32_t settled = ln.settled[M];
  int32_t ca[L], cb[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    ca[l] = a.d[l];
    cb[l] = b.d[l];
  }
  long long ab = a.b, bb = b.b;
  int n = 0, side = 0;
  if (ab * bb >= kSumLimit) {
    if (ab >= bb) {
      ab = settled;
    } else {
      side = 1;
      bb = settled;
    }
    n = 1;
    if (ab * bb >= kSumLimit) {
      side |= 4;  // then a, then b
      n = 3;
    }
  }
#pragma unroll 1
  for (int k = 0; k < n; ++k) {
    const bool on_b = (side >> k) & 1;
    int32_t x[L];
#pragma unroll
    for (int l = 0; l < L; ++l) x[l] = on_b ? cb[l] : ca[l];
    settle<TPI, M>(ln, x);
#pragma unroll
    for (int l = 0; l < L; ++l) {
      if (on_b) {
        cb[l] = x[l];
      } else {
        ca[l] = x[l];
      }
    }
  }
  dm_mul<TPI, M>(ln, o.d, ca, cb);
  o.b = settled;
}

// this rank's digits of a 43-digit column (canonical), padding zero
template <int TPI>
__device__ __forceinline__ void fv_load(const Lane<TPI>& ln, FV<TPI>& o, const int32_t* col,
                                        int32_t bound) {
#pragma unroll
  for (int l = 0; l < KP / TPI; ++l) {
    const int k = ln.t * (KP / TPI) + l;
    o.d[l] = k < K ? col[k] : 0;
  }
  o.b = bound;
}

template <int TPI>
__device__ __forceinline__ void fv_const(const Lane<TPI>& ln, FV<TPI>& o, int32_t lo,
                                         int32_t bound) {
#pragma unroll
  for (int l = 0; l < KP / TPI; ++l) o.d[l] = 0;
  if (ln.t == 0) o.d[0] = lo;
  o.b = bound;
}

// -- RCB complete formulas, the reference's statement order --------------

// RCB16 algorithm 4 (pt_add); o may alias p or q
template <int TPI>
__device__ __forceinline__ void pt_add(const Lane<TPI>& ln, PtV<TPI>& o, const PtV<TPI>& p,
                                       const PtV<TPI>& q, const FV<TPI>& bf) {
  FV<TPI> t0, t1, t2, t3, t4, X3, Y3, Z3;
  fv_mul<TPI, P_>(ln, t0, p.x, q.x);
  fv_mul<TPI, P_>(ln, t1, p.y, q.y);
  fv_mul<TPI, P_>(ln, t2, p.z, q.z);
  fv_add(t3, p.x, p.y);
  fv_add(t4, q.x, q.y);
  fv_mul<TPI, P_>(ln, t3, t3, t4);
  fv_add(t4, t0, t1);
  fv_sub(t3, t3, t4);
  fv_add(t4, p.y, p.z);
  fv_add(X3, q.y, q.z);
  fv_mul<TPI, P_>(ln, t4, t4, X3);
  fv_add(X3, t1, t2);
  fv_sub(t4, t4, X3);
  fv_add(X3, p.x, p.z);
  fv_add(Y3, q.x, q.z);
  fv_mul<TPI, P_>(ln, X3, X3, Y3);
  fv_add(Y3, t0, t2);
  fv_sub(Y3, X3, Y3);
  fv_mul<TPI, P_>(ln, Z3, bf, t2);
  fv_sub(X3, Y3, Z3);
  fv_add(Z3, X3, X3);
  fv_add(X3, X3, Z3);
  fv_sub(Z3, t1, X3);
  fv_add(X3, t1, X3);
  fv_mul<TPI, P_>(ln, Y3, bf, Y3);
  fv_add(t1, t2, t2);
  fv_add(t2, t1, t2);
  fv_sub(Y3, Y3, t2);
  fv_sub(Y3, Y3, t0);
  fv_add(t1, Y3, Y3);
  fv_add(Y3, t1, Y3);
  fv_add(t1, t0, t0);
  fv_add(t0, t1, t0);
  fv_sub(t0, t0, t2);
  fv_mul<TPI, P_>(ln, t1, t4, Y3);
  fv_mul<TPI, P_>(ln, t2, t0, Y3);
  fv_mul<TPI, P_>(ln, Y3, X3, Z3);
  fv_add(Y3, Y3, t2);
  fv_mul<TPI, P_>(ln, X3, t3, X3);
  fv_sub(X3, X3, t1);
  fv_mul<TPI, P_>(ln, Z3, t4, Z3);
  fv_mul<TPI, P_>(ln, t1, t3, t0);
  fv_add(Z3, Z3, t1);
  o.x = X3;
  o.y = Y3;
  o.z = Z3;
}

// RCB16 algorithm 5 (pt_add_mixed): (x2, y2) affine, never infinity
template <int TPI>
__device__ __forceinline__ void pt_add_mixed(const Lane<TPI>& ln, PtV<TPI>& o, const PtV<TPI>& p,
                                             const FV<TPI>& x2, const FV<TPI>& y2,
                                             const FV<TPI>& bf) {
  FV<TPI> t0, t1, t2, t3, t4, X3, Y3, Z3;
  fv_mul<TPI, P_>(ln, t0, p.x, x2);
  fv_mul<TPI, P_>(ln, t1, p.y, y2);
  fv_add(t3, x2, y2);
  fv_add(t4, p.x, p.y);
  fv_mul<TPI, P_>(ln, t3, t3, t4);
  fv_add(t4, t0, t1);
  fv_sub(t3, t3, t4);
  fv_mul<TPI, P_>(ln, t4, y2, p.z);
  fv_add(t4, t4, p.y);
  fv_mul<TPI, P_>(ln, Y3, x2, p.z);
  fv_add(Y3, Y3, p.x);
  fv_mul<TPI, P_>(ln, Z3, bf, p.z);
  fv_sub(X3, Y3, Z3);
  fv_add(Z3, X3, X3);
  fv_add(X3, X3, Z3);
  fv_sub(Z3, t1, X3);
  fv_add(X3, t1, X3);
  fv_mul<TPI, P_>(ln, Y3, bf, Y3);
  fv_add(t1, p.z, p.z);
  fv_add(t2, t1, p.z);
  fv_sub(Y3, Y3, t2);
  fv_sub(Y3, Y3, t0);
  fv_add(t1, Y3, Y3);
  fv_add(Y3, t1, Y3);
  fv_add(t1, t0, t0);
  fv_add(t0, t1, t0);
  fv_sub(t0, t0, t2);
  fv_mul<TPI, P_>(ln, t1, t4, Y3);
  fv_mul<TPI, P_>(ln, t2, t0, Y3);
  fv_mul<TPI, P_>(ln, Y3, X3, Z3);
  fv_add(Y3, Y3, t2);
  fv_mul<TPI, P_>(ln, X3, t3, X3);
  fv_sub(X3, X3, t1);
  fv_mul<TPI, P_>(ln, Z3, t4, Z3);
  fv_mul<TPI, P_>(ln, t1, t3, t0);
  fv_add(Z3, Z3, t1);
  o.x = X3;
  o.y = Y3;
  o.z = Z3;
}

// RCB16 algorithm 6 (pt_double), in place
template <int TPI>
__device__ __forceinline__ void pt_double(const Lane<TPI>& ln, PtV<TPI>& p, const FV<TPI>& bf) {
  FV<TPI> t0, t1, t2, t3, X3, Y3, Z3;
  fv_mul<TPI, P_>(ln, t0, p.x, p.x);
  fv_mul<TPI, P_>(ln, t1, p.y, p.y);
  fv_mul<TPI, P_>(ln, t2, p.z, p.z);
  fv_mul<TPI, P_>(ln, t3, p.x, p.y);
  fv_add(t3, t3, t3);
  fv_mul<TPI, P_>(ln, Z3, p.x, p.z);
  fv_add(Z3, Z3, Z3);
  fv_mul<TPI, P_>(ln, Y3, bf, t2);
  fv_sub(Y3, Y3, Z3);
  fv_add(X3, Y3, Y3);
  fv_add(Y3, X3, Y3);
  fv_sub(X3, t1, Y3);
  fv_add(Y3, t1, Y3);
  fv_mul<TPI, P_>(ln, Y3, X3, Y3);
  fv_mul<TPI, P_>(ln, X3, X3, t3);
  fv_add(t3, t2, t2);
  fv_add(t2, t2, t3);
  fv_mul<TPI, P_>(ln, Z3, bf, Z3);
  fv_sub(Z3, Z3, t2);
  fv_sub(Z3, Z3, t0);
  fv_add(t3, Z3, Z3);
  fv_add(Z3, Z3, t3);
  fv_add(t3, t0, t0);
  fv_add(t0, t3, t0);
  fv_sub(t0, t0, t2);
  fv_mul<TPI, P_>(ln, t0, t0, Z3);
  fv_add(Y3, Y3, t0);
  fv_mul<TPI, P_>(ln, t0, p.y, p.z);
  fv_add(t0, t0, t0);
  fv_mul<TPI, P_>(ln, Z3, t0, Z3);
  fv_sub(X3, X3, Z3);
  fv_mul<TPI, P_>(ln, Z3, t0, t1);
  fv_add(Z3, Z3, Z3);
  fv_add(Z3, Z3, Z3);
  p.x = X3;
  p.y = Y3;
  p.z = Z3;
}

// the lane's u2*Q table entry d in shared memory: int16 digits
template <int TPI>
__device__ __forceinline__ void tq_store(const Lane<TPI>& ln, int16_t* tq, int d,
                                         const PtV<TPI>& e) {
  constexpr int L = Lane<TPI>::L;
  int16_t* p = tq + d * 3 * KP + ln.t * L;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    p[l] = (int16_t)e.x.d[l];
    p[KP + l] = (int16_t)e.y.d[l];
    p[2 * KP + l] = (int16_t)e.z.d[l];
  }
}

template <int TPI>
__global__ void __launch_bounds__(kLanes * TPI)
p256_v2_kernel(const int32_t* __restrict__ frame, int B, const int32_t* __restrict__ consts,
               uint8_t* __restrict__ out) {
  extern __shared__ __align__(128) uint8_t v2_smem[];
  for (int i = threadIdx.x; i < kTableBytes / 4; i += blockDim.x)
    ((int32_t*)v2_smem)[i] = consts[kHeader + i];
  const Lane<TPI> ln(v2_smem, consts);
  constexpr int L = Lane<TPI>::L;
  const int lane = blockIdx.x * kLanes + ln.row;
  const int32_t* row = frame + (size_t)min(lane, B - 1) * kCols;
  const int32_t sp = ln.settled[P_], sn = ln.settled[N_];
  const bool rpn_ok = row[6 * K] != 0;
  const bool pre_ok = row[6 * K + 1] != 0;
  int16_t* tq = (int16_t*)(v2_smem + kOffTQ + ln.row * kTQStride);
  const signed char* tg = (const signed char*)(v2_smem + kOffTG);
  __syncthreads();

  // on-curve (mod p): y^2 == x^3 - 3x + b
  FV<TPI> qx, qy, bf;
  fv_load(ln, qx, row + 4 * K, 63);
  fv_load(ln, qy, row + 5 * K, 63);
  fv_load(ln, bf, (const int32_t*)(v2_smem + kOffBD), 63);
  bool on_curve;
  {
    FV<TPI> y2, x2, x3, t;
    fv_mul<TPI, P_>(ln, y2, qy, qy);
    fv_mul<TPI, P_>(ln, x2, qx, qx);
    fv_mul<TPI, P_>(ln, x3, x2, qx);
    fv_add(t, qx, qx);
    fv_add(t, t, qx);
    fv_sub(x3, x3, t);
    fv_add(x3, x3, bf);
    fv_sub(t, y2, x3);
    on_curve = eq_zero<TPI, P_>(ln, t.d);
  }

  // s^-1 (mod n) by Fermat: a square per bit of n - 2, a multiply at
  // each set bit (step 2i squares, step 2i + 1 multiplies), one product site
  uint32_t u1[8], u2[8];
  {
    FV<TPI> s, acc, y;
    fv_load(ln, s, row + 2 * K, 63);
    fv_const(ln, acc, 1, sn);
#pragma unroll 1
    for (int step = 0; step < 512; ++step) {
      const int j = 255 - (step >> 1);
      const bool mul = step & 1;
      if (mul && !((kNm2[j >> 5] >> (j & 31)) & 1u)) continue;
      acc.b = sn;
      fv_select(y, s, acc, mul);
      fv_mul<TPI, N_>(ln, acc, acc, y);
    }
    acc.b = sn;
    // u1 = e s^-1, then u2 = r s^-1, as canonical digits
#pragma unroll 1
    for (int k = 0; k < 2; ++k) {
      FV<TPI> t;
      fv_load(ln, t, row + k * K, 63);
      fv_mul<TPI, N_>(ln, t, t, acc);
      canonical_row<TPI, N_>(ln, t.d);
      uint32_t w[8];
      row_words(ln, w);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (k == 0) {
          u1[i] = w[i];
        } else {
          u2[i] = w[i];
        }
      }
    }
  }

  // u2*Q window table: T[0] = infinity (0 : 1 : 0), T[d] = d*Q
  PtV<TPI> q1;
  {
    PtV<TPI> e;
    fv_const(ln, e.x, 0, 0);
    fv_const(ln, e.y, 1, 63);
    fv_const(ln, e.z, 0, 0);
    tq_store(ln, tq, 0, e);
    q1.x = qx;
    q1.y = qy;
    fv_const(ln, q1.z, 1, 63);
    tq_store(ln, tq, 1, q1);
  }
  int32_t tq_bound = 63;
  {
    PtV<TPI> e = q1;
#pragma unroll 1
    for (int d = 2; d < 16; ++d) {
      pt_add(ln, e, e, q1, bf);
      tq_store(ln, tq, d, e);
      tq_bound = max(tq_bound, max(e.x.b, max(e.y.b, e.z.b)));
    }
  }

  // 64 steps of 4 doublings, + T_Q[w2], + T_G[w1] unless w1 = 0; a settle
  // of the running point after each step
  FV<TPI> X, Y, Z;
  fv_const(ln, X, 0, sp);
  fv_const(ln, Y, 1, sp);
  fv_const(ln, Z, 0, sp);
#pragma unroll 1
  for (int i = 0; i < 64; ++i) {
    PtV<TPI> R, Rg, sel;
    R.x = X;
    R.y = Y;
    R.z = Z;
    R.x.b = R.y.b = R.z.b = sp;
#pragma unroll 1
    for (int k = 0; k < 4; ++k) pt_double(ln, R, bf);
    {
      const int16_t* e = tq + next_window(u2) * 3 * KP + ln.t * L;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        sel.x.d[l] = e[l];
        sel.y.d[l] = e[KP + l];
        sel.z.d[l] = e[2 * KP + l];
      }
      sel.x.b = sel.y.b = sel.z.b = tq_bound;
    }
    pt_add(ln, R, R, sel, bf);
    const int d1 = next_window(u1);
    FV<TPI> gx, gy;
    {
      const signed char* g = tg + d1 * 2 * KP + ln.t * L;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        gx.d[l] = g[l];
        gy.d[l] = g[KP + l];
      }
      gx.b = gy.b = 63;
    }
    pt_add_mixed(ln, Rg, R, gx, gy, bf);
    fv_select(X, R.x, Rg.x, d1 == 0);
    fv_select(Y, R.y, Rg.y, d1 == 0);
    fv_select(Z, R.z, Rg.z, d1 == 0);
    settle<TPI, P_>(ln, X.d);
    settle<TPI, P_>(ln, Y.d);
    settle<TPI, P_>(ln, Z.d);
  }

  // R != infinity and x(R) == r (mod n): X == r Z or (r+n) Z (mod p)
  X.b = Z.b = sp;
  const bool not_inf = !eq_zero<TPI, P_>(ln, Z.d);
  bool cmp1 = false, cmp2 = false;
#pragma unroll 1
  for (int k = 0; k < 2; ++k) {
    FV<TPI> t, u;
    fv_load(ln, t, row + (k == 0 ? K : 3 * K), 63);
    fv_mul<TPI, P_>(ln, t, t, Z);
    fv_sub(u, X, t);
    const bool eq = eq_zero<TPI, P_>(ln, u.d);
    if (k == 0) {
      cmp1 = eq;
    } else {
      cmp2 = eq && rpn_ok;
    }
  }
  if (ln.t == 0 && lane < B)
    out[lane] = (uint8_t)(pre_ok && on_curve && not_inf && (cmp1 || cmp2));
}

}  // namespace

// consts: the int32 block of the module comment; each block copies its
// tables into shared memory.  16 lanes a block.
extern "C" int fab_p256_verify_v2(const int32_t* frame, int B, const int32_t* consts,
                                  uint8_t* out, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  const cudaError_t err = cudaFuncSetAttribute(
      p256_v2_kernel<kTPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  p256_v2_kernel<kTPI><<<(B + kLanes - 1) / kLanes, kLanes * kTPI, kSmemBytes,
                         (cudaStream_t)stream>>>(frame, B, consts, out);
  return (int)cudaGetLastError();
}

// out: the threads a lane, the registers a thread and the local bytes a
// thread (stack frame, spills included) of the kernel a B-lane batch runs
extern "C" int fab_p256_verify_v2_attrs(int, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, p256_v2_kernel<kTPI>);
  out[0] = kTPI;
  out[1] = a.numRegs;
  out[2] = (int)a.localSizeBytes;
  return (int)err;
}

extern "C" const char* fab_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
