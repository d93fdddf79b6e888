// P-256 field and point arithmetic for a team of TPI threads per
// signature (TPI = 8: one 32-bit limb per thread; TPI = 4: two).  Used by
// p256_verify.cu, p256_sign.cu and p256_v1.cu.  A field element is eight
// little-endian 32-bit limbs in Montgomery form (R = 2^256); rank t of
// the team holds limbs t*L .. t*L + L - 1 (L = 8 / TPI).  Every value is
// fully reduced into [0, p) after each operation, so equality is limb
// equality, and the point functions are the Renes-Costello-Batina
// complete formulas with a = -3 in the schedule of
// fabric_tpu/ops/p256v3.py.
//
// The product is CIOS over the team.  Macro-round j takes b's limbs
// j*L .. j*L + L - 1, broadcast from rank j with __shfl_sync(width =
// TPI); each rank adds its own column of 32x32->64 products into 64-bit
// column accumulators (2L columns: its own L and the L above, which
// belong to the next rank until the shift).  Since -p^-1 = 1 (mod 2^32)
// the reduction multiplier of a column is its own low word, and since
// p's limbs are all-ones, zero or one, m*p is limb-aligned adds:
//   (t + m*p) / 2^32 = (t >> 32) + m*2^64 + m*2^160 - m*2^192 + m*2^224,
// written without a negative term as +m at column 2, +m at 5,
// +(2^32 - m) at 6 and +(m - [m != 0]) at 7.  Rank 0 holds the low L
// columns, so it computes the macro-round's L multipliers locally; then
// the multipliers (from rank 0) and the low words (one rank down) move
// in the same step, and the multipliers' terms are added to the shifted
// columns.  Carries are not resolved per round: the 64-bit columns
// absorb them, and the final 257-bit result is normalised once, with a
// shuffle of each rank's top carry and a carry-lookahead over the team
// (two __ballot_sync votes), then reduced once below p (a borrow
// lookahead, two more votes).  Additions and subtractions use the same
// lookaheads; equality and is-zero are one vote each.
//
// Every team runs the same instruction stream (selects, no branches on
// data), so each shuffle and vote has all 32 lanes of its warp.
//
// No inline PTX: nvcc builds this with the hardware intrinsics, and the
// host harness of tests/test_torch_kernels_host.py compiles the same
// text as C++ with emulated intrinsics, one std::thread per thread.

#pragma once

#include <cstdint>

namespace {

constexpr unsigned kWarp = 0xFFFFFFFFu;

// p = 2^256 - 2^224 + 2^192 + 2^96 - 1, little-endian 32-bit limbs
__device__ __forceinline__ uint32_t team_pl(int i) {
  return (i < 3) ? 0xFFFFFFFFu : (i < 6) ? 0u : (i == 6) ? 1u : 0xFFFFFFFFu;
}

template <int TPI>
struct Fe {
  static constexpr int L = 8 / TPI;
  uint32_t v[L];
};

template <int TPI>
struct TPt {
  Fe<TPI> x, y, z;
};

template <int TPI>
struct Team {
  static constexpr int L = 8 / TPI;
  // the top-rank lanes of every team of a warp (0x80808080 at TPI = 8)
  static constexpr uint32_t kTop = (0xFFFFFFFFu / ((1u << TPI) - 1u)) << (TPI - 1);
  int t;             // rank within the team
  uint32_t lanebit;  // this lane's bit in a warp vote
  uint32_t topbit;   // the bit of this team's top rank
  uint32_t team;     // the bits of this team
  uint32_t below;    // ~0 unless this is the top rank (no rank above it)
  uint32_t p[L];     // this rank's limbs of p
  // the share of m*p / 2^32 that lands on own column l from multiplier
  // s, as two factors: m * fl + hi(m * fh) is +m (fl = 1), 2^32 - m mod
  // 2^32 (fl = 2^32 - 1) or m - [m != 0] (fh = 2^32 - 1), or 0; both
  // multiplies run on the IMAD pipe, beside the adds on the ALU pipe
  uint32_t fl[L][L], fh[L][L];

  __device__ __forceinline__ Team() {
    const int lane = threadIdx.x & 31;
    t = lane & (TPI - 1);
    lanebit = 1u << lane;
    topbit = 1u << (lane | (TPI - 1));
    team = ((1u << (TPI - 1)) * 2u - 1u) << (lane & ~(TPI - 1));
    below = (t == TPI - 1) ? 0u : 0xFFFFFFFFu;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      p[l] = team_pl(t * L + l);
#pragma unroll
      for (int s = 0; s < L; ++s) {
        // column t*L + l after the shift was column t*L + l + L before it;
        // multiplier s sits at column s, so the offset from it is:
        const int o = t * L + l + L - s;
        fl[l][s] = (o == 3 || o == 6) ? 1u : (o == 7) ? 0xFFFFFFFFu : 0u;
        fh[l][s] = (o == 8) ? 0xFFFFFFFFu : 0u;
      }
    }
  }

  __device__ __forceinline__ uint32_t term(uint32_t m, int l, int s) const {
    return __umulhi(m, fh[l][s]) + m * fl[l][s];
  }

  // true when no rank of the team has pred
  __device__ __forceinline__ bool none(bool pred) const {
    return (__ballot_sync(kWarp, pred) & team) == 0u;
  }

  // Carry-lookahead over the team, on whole-warp votes.  g: ranks whose
  // own add carries out; q: ranks that pass an incoming carry on (all
  // limbs at the wrap value).  No rank has both.  Top ranks' g and q
  // bits are cleared before the add, so no carry crosses into the next
  // team; the carry out of the top rank is g | (q & carry in) there.
  // Returns the carry into this rank and sets *out to the team's carry
  // out of its top rank.
  __device__ __forceinline__ uint32_t lookahead(bool g, bool q, uint32_t* out) const {
    const uint32_t gm = __ballot_sync(kWarp, g), qm = __ballot_sync(kWarp, q);
    const uint32_t qi = qm & ~kTop;
    const uint32_t c = (((gm & ~kTop) << 1) + qi) ^ qi;
    *out = ((gm | (qm & c)) & topbit) ? 1u : 0u;
    return (c & lanebit) ? 1u : 0u;
  }
};

// ---------------------------------------------------------------------------
// Limb-local helpers (one rank's L limbs)

template <int L>
__device__ __forceinline__ bool all_ones(const uint32_t* r) {
  uint32_t a = 0xFFFFFFFFu;
#pragma unroll
  for (int l = 0; l < L; ++l) a &= r[l];
  return a == 0xFFFFFFFFu;
}

template <int L>
__device__ __forceinline__ bool all_zero(const uint32_t* r) {
  uint32_t a = 0u;
#pragma unroll
  for (int l = 0; l < L; ++l) a |= r[l];
  return a == 0u;
}

template <int L>
__device__ __forceinline__ void add_carry_in(uint32_t* r, uint32_t c) {
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const uint64_t s = (uint64_t)r[l] + c;
    r[l] = (uint32_t)s;
    c = (uint32_t)(s >> 32);
  }
}

template <int L>
__device__ __forceinline__ void sub_borrow_in(uint32_t* r, uint32_t b) {
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const uint64_t s = (uint64_t)r[l] - b;
    r[l] = (uint32_t)s;
    b = (uint32_t)(s >> 63);
  }
}

// r = a - b over this rank's limbs; returns the borrow out
template <int L>
__device__ __forceinline__ uint32_t sub_local(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t br = 0;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const uint64_t s = (uint64_t)a[l] - b[l] - br;
    r[l] = (uint32_t)s;
    br = (uint32_t)(s >> 63);
  }
  return br;
}

// r = a + b over this rank's limbs; returns the carry out
template <int L>
__device__ __forceinline__ uint32_t add_local(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t c = 0;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const uint64_t s = (uint64_t)a[l] + b[l] + c;
    r[l] = (uint32_t)s;
    c = (uint32_t)(s >> 32);
  }
  return c;
}

// ---------------------------------------------------------------------------
// Team field operations

// r = (top:r) - p if (top:r) >= p, for (top:r) < 2p
template <int TPI>
__device__ __forceinline__ void fe_reduce(const Team<TPI>& tm, uint32_t* r, uint32_t top) {
  constexpr int L = Team<TPI>::L;
  uint32_t d[L];
  const uint32_t bo = sub_local<L>(d, r, tm.p);
  uint32_t bout;
  const uint32_t bin = tm.lookahead(bo != 0u, all_zero<L>(d), &bout);
  sub_borrow_in<L>(d, bin);
  const uint32_t m = (top != 0u || bout == 0u) ? 0xFFFFFFFFu : 0u;
#pragma unroll
  for (int l = 0; l < L; ++l) r[l] = (d[l] & m) | (r[l] & ~m);
}

template <int TPI>
__device__ __forceinline__ void fe_add(const Team<TPI>& tm, Fe<TPI>& r, const Fe<TPI>& a,
                                       const Fe<TPI>& b) {
  constexpr int L = Team<TPI>::L;
  const uint32_t c = add_local<L>(r.v, a.v, b.v);
  uint32_t top;
  const uint32_t cin = tm.lookahead(c != 0u, all_ones<L>(r.v), &top);
  add_carry_in<L>(r.v, cin);
  fe_reduce<TPI>(tm, r.v, top);
}

template <int TPI>
__device__ __forceinline__ void fe_sub(const Team<TPI>& tm, Fe<TPI>& r, const Fe<TPI>& a,
                                       const Fe<TPI>& b) {
  constexpr int L = Team<TPI>::L;
  const uint32_t bo = sub_local<L>(r.v, a.v, b.v);
  uint32_t bout;
  const uint32_t bin = tm.lookahead(bo != 0u, all_zero<L>(r.v), &bout);
  sub_borrow_in<L>(r.v, bin);
  // a borrow out of the top rank: add p back (mod 2^256)
  const uint32_t m = bout ? 0xFFFFFFFFu : 0u;
  uint32_t pm[L];
#pragma unroll
  for (int l = 0; l < L; ++l) pm[l] = tm.p[l] & m;
  const uint32_t c = add_local<L>(r.v, r.v, pm);
  uint32_t ignored;
  const uint32_t cin = tm.lookahead(c != 0u, all_ones<L>(r.v), &ignored);
  add_carry_in<L>(r.v, cin);
}

template <int TPI>
__device__ __forceinline__ void fe_triple(const Team<TPI>& tm, Fe<TPI>& r, const Fe<TPI>& a) {
  Fe<TPI> t;
  fe_add<TPI>(tm, t, a, a);
  fe_add<TPI>(tm, r, t, a);
}

template <int TPI>
__device__ __forceinline__ bool fe_eq(const Team<TPI>& tm, const Fe<TPI>& a, const Fe<TPI>& b) {
  uint32_t d = 0u;
#pragma unroll
  for (int l = 0; l < Team<TPI>::L; ++l) d |= a.v[l] ^ b.v[l];
  return tm.none(d != 0u);
}

template <int TPI>
__device__ __forceinline__ bool fe_is_zero(const Team<TPI>& tm, const Fe<TPI>& a) {
  return tm.none(!all_zero<Team<TPI>::L>(a.v));
}

// how many independent products run interleaved: at TPI = 8 a product
// in flight is ~4 registers, so a whole RCB group of 5 or 6 fits; at
// TPI = 4 its 64-bit column pairs cost 8, so two
template <int TPI>
constexpr int kIlp = (TPI == 8) ? 6 : 2;

// N <= kIlp independent Montgomery products r[n] = a[n] * b[n] * 2^-256
// mod p, interleaved round by round, so that one product's shuffles and
// votes overlap the others' arithmetic.  An output may be an input of
// any of the N: every input is read before any output is written.
template <int TPI, int N>
__device__ __forceinline__ void fe_mul_il(const Team<TPI>& tm, Fe<TPI>* const* r,
                                          const Fe<TPI>* const* a, const Fe<TPI>* const* b) {
  constexpr int L = Team<TPI>::L;
  uint64_t acc[N][2 * L];
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int c = 0; c < 2 * L; ++c) acc[n][c] = 0u;

  if constexpr (L == 1) {
    // one limb a rank: the column is a 32-bit word plus a carry of at
    // most 2, so a*b + word fits 64 bits and the multiply-add fuses
    uint32_t cw[N], cc[N];
#pragma unroll
    for (int n = 0; n < N; ++n) cw[n] = cc[n] = 0u;
#pragma unroll
    for (int j = 0; j < TPI; ++j) {
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const uint32_t bi = __shfl_sync(kWarp, b[n]->v[0], j, TPI);
        const uint64_t x = (uint64_t)a[n]->v[0] * bi + cw[n];
        const uint32_t xl = (uint32_t)x;
        const uint32_t m = __shfl_sync(kWarp, xl, 0, TPI);
        const uint32_t lo = __shfl_down_sync(kWarp, xl, 1, TPI) & tm.below;
        const uint64_t v = (x >> 32) + cc[n] + lo + tm.term(m, 0, 0);
        cw[n] = (uint32_t)v;
        cc[n] = (uint32_t)(v >> 32);
      }
    }
#pragma unroll
    for (int n = 0; n < N; ++n) acc[n][0] = ((uint64_t)cc[n] << 32) | cw[n];
  } else {
#pragma unroll
    for (int j = 0; j < TPI; ++j) {
      // own column products of b's limbs j*L .. j*L + L - 1
#pragma unroll
      for (int s = 0; s < L; ++s) {
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const uint32_t bi = __shfl_sync(kWarp, b[n]->v[s], j, TPI);
#pragma unroll
          for (int l = 0; l < L; ++l) {
            const uint64_t pr = (uint64_t)a[n]->v[l] * bi;
            acc[n][l + s] += (uint32_t)pr;
            acc[n][l + s + 1] += pr >> 32;
          }
        }
      }
      // carries of the own columns into the first column above them
#pragma unroll
      for (int n = 0; n < N; ++n)
#pragma unroll
        for (int l = 0; l < L; ++l) {
          acc[n][l + 1] += acc[n][l] >> 32;
          acc[n][l] &= 0xFFFFFFFFu;
        }
      // rank 0's low words are the multipliers; every rank's low words
      // move one rank down (the low L columns leave the number)
#pragma unroll
      for (int n = 0; n < N; ++n) {
        uint32_t m[L], lo[L];
#pragma unroll
        for (int l = 0; l < L; ++l) {
          m[l] = __shfl_sync(kWarp, (uint32_t)acc[n][l], 0, TPI);
          lo[l] = __shfl_down_sync(kWarp, (uint32_t)acc[n][l], 1, TPI) & tm.below;
        }
#pragma unroll
        for (int l = 0; l < L; ++l) {
          uint64_t v = acc[n][L + l] + lo[l];
#pragma unroll
          for (int s = 0; s < L; ++s) v += tm.term(m[s], l, s);
          acc[n][l] = v;
          acc[n][L + l] = 0u;
        }
      }
    }
  }

  // normalise: own carries up, each rank's top carry to the rank above
  // (the top rank's is bit 256), one lookahead, then one reduction
#pragma unroll
  for (int n = 0; n < N; ++n) {
    uint32_t v[L];
#pragma unroll
    for (int l = 0; l + 1 < L; ++l) acc[n][l + 1] += acc[n][l] >> 32;
#pragma unroll
    for (int l = 0; l < L; ++l) v[l] = (uint32_t)acc[n][l];
    const uint32_t h = (uint32_t)(acc[n][L - 1] >> 32);
    uint32_t hin = __shfl_up_sync(kWarp, h, 1, TPI);
    if (tm.t == 0) hin = 0u;
    uint32_t c = 0u;
    {
      uint64_t s = (uint64_t)v[0] + hin;
      v[0] = (uint32_t)s;
      c = (uint32_t)(s >> 32);
#pragma unroll
      for (int l = 1; l < L; ++l) {
        s = (uint64_t)v[l] + c;
        v[l] = (uint32_t)s;
        c = (uint32_t)(s >> 32);
      }
    }
    // the top rank's own carry and its column overflow both mean bit 256
    const bool g = c != 0u || (tm.t == TPI - 1 && h != 0u);
    uint32_t top;
    const uint32_t cin = tm.lookahead(g, all_ones<L>(v), &top);
    add_carry_in<L>(v, cin);
    fe_reduce<TPI>(tm, v, top);
#pragma unroll
    for (int l = 0; l < L; ++l) r[n]->v[l] = v[l];
  }
}

// N independent products, kIlp at a time; outputs may alias inputs
template <int TPI, int N>
__device__ __forceinline__ void fe_mul_n(const Team<TPI>& tm, Fe<TPI>* const* r,
                                         const Fe<TPI>* const* a, const Fe<TPI>* const* b) {
  if constexpr (N <= kIlp<TPI>) {
    fe_mul_il<TPI, N>(tm, r, a, b);
  } else {
    Fe<TPI> o[N];
    Fe<TPI>* ro[N];
#pragma unroll
    for (int n = 0; n < N; ++n) ro[n] = &o[n];
    fe_mul_il<TPI, kIlp<TPI>>(tm, ro, a, b);
    fe_mul_n<TPI, N - kIlp<TPI>>(tm, ro + kIlp<TPI>, a + kIlp<TPI>, b + kIlp<TPI>);
#pragma unroll
    for (int n = 0; n < N; ++n) *r[n] = o[n];
  }
}

template <int TPI>
__device__ __forceinline__ void fe_mul(const Team<TPI>& tm, Fe<TPI>& r, const Fe<TPI>& a,
                                       const Fe<TPI>& b) {
  Fe<TPI>* rr[1] = {&r};
  const Fe<TPI>* aa[1] = {&a};
  const Fe<TPI>* bb[1] = {&b};
  fe_mul_n<TPI, 1>(tm, rr, aa, bb);
}

template <int TPI>
__device__ __forceinline__ void fe_mul2(const Team<TPI>& tm, Fe<TPI>& r0, const Fe<TPI>& a0,
                                        const Fe<TPI>& b0, Fe<TPI>& r1, const Fe<TPI>& a1,
                                        const Fe<TPI>& b1) {
  Fe<TPI>* rr[2] = {&r0, &r1};
  const Fe<TPI>* aa[2] = {&a0, &a1};
  const Fe<TPI>* bb[2] = {&b0, &b1};
  fe_mul_n<TPI, 2>(tm, rr, aa, bb);
}

template <int TPI>
__device__ __forceinline__ void fe_select(Fe<TPI>& r, const Fe<TPI>& a, const Fe<TPI>& b,
                                          bool take_a) {
  const uint32_t m = take_a ? 0xFFFFFFFFu : 0u;
#pragma unroll
  for (int l = 0; l < Team<TPI>::L; ++l) r.v[l] = (a.v[l] & m) | (b.v[l] & ~m);
}

// ---------------------------------------------------------------------------
// Points: the RCB complete formulas, a = -3, each group of independent
// products interleaved

// RCB16 algorithm 4: complete projective addition.
template <int TPI>
__device__ __forceinline__ void tpt_add(const Team<TPI>& tm, TPt<TPI>& o, const TPt<TPI>& p,
                                        const TPt<TPI>& q, const Fe<TPI>& bm) {
  Fe<TPI> u1, v1, u2, v2, u3, v3;
  fe_add(tm, u1, p.x, p.y);
  fe_add(tm, v1, q.x, q.y);
  fe_add(tm, u2, p.y, p.z);
  fe_add(tm, v2, q.y, q.z);
  fe_add(tm, u3, p.x, p.z);
  fe_add(tm, v3, q.x, q.z);
  Fe<TPI> t0, t1, t2, s1, s2, s3, u, v;
  {
    Fe<TPI>* r[6] = {&t0, &t1, &t2, &s1, &s2, &s3};
    const Fe<TPI>* a[6] = {&p.x, &p.y, &p.z, &u1, &u2, &u3};
    const Fe<TPI>* b[6] = {&q.x, &q.y, &q.z, &v1, &v2, &v3};
    fe_mul_n<TPI, 6>(tm, r, a, b);
  }
  Fe<TPI> t3, t4, y3a;
  fe_add(tm, u, t0, t1); fe_sub(tm, t3, s1, u);
  fe_add(tm, u, t1, t2); fe_sub(tm, t4, s2, u);
  fe_add(tm, u, t0, t2); fe_sub(tm, y3a, s3, u);
  Fe<TPI> bz, by;
  fe_mul2(tm, bz, bm, t2, by, bm, y3a);
  Fe<TPI> x3b, z3a, x3c, t2b, y3c, t0c;
  fe_sub(tm, u, y3a, bz); fe_triple(tm, x3b, u);
  fe_sub(tm, z3a, t1, x3b);
  fe_add(tm, x3c, t1, x3b);
  fe_triple(tm, t2b, t2);
  fe_sub(tm, u, by, t2b); fe_sub(tm, v, u, t0); fe_triple(tm, y3c, v);
  fe_triple(tm, u, t0); fe_sub(tm, t0c, u, t2b);
  Fe<TPI> m1, m2, m3, m4, m5, m6;
  {
    Fe<TPI>* r[6] = {&m1, &m2, &m3, &m4, &m5, &m6};
    const Fe<TPI>* a[6] = {&t4, &t0c, &x3c, &t3, &t4, &t3};
    const Fe<TPI>* b[6] = {&y3c, &y3c, &z3a, &x3c, &z3a, &t0c};
    fe_mul_n<TPI, 6>(tm, r, a, b);
  }
  fe_sub(tm, o.x, m4, m1);
  fe_add(tm, o.y, m3, m2);
  fe_add(tm, o.z, m5, m6);
}

// RCB16 algorithm 5: mixed addition, (x2, y2) affine and never infinity.
template <int TPI>
__device__ __forceinline__ void tpt_add_mixed(const Team<TPI>& tm, TPt<TPI>& o, const TPt<TPI>& p,
                                              const Fe<TPI>& x2, const Fe<TPI>& y2,
                                              const Fe<TPI>& bm) {
  Fe<TPI> t0, t1, s1, myz, mxz, bz1, u, v;
  fe_add(tm, u, x2, y2);
  fe_add(tm, v, p.x, p.y);
  {
    Fe<TPI>* r[6] = {&t0, &t1, &s1, &myz, &mxz, &bz1};
    const Fe<TPI>* a[6] = {&p.x, &p.y, &u, &y2, &x2, &bm};
    const Fe<TPI>* b[6] = {&x2, &y2, &v, &p.z, &p.z, &p.z};
    fe_mul_n<TPI, 6>(tm, r, a, b);
  }
  Fe<TPI> t3, t4, y3a, x3b, z3a, x3c, by, t2b, y3c, t0c;
  fe_add(tm, u, t0, t1); fe_sub(tm, t3, s1, u);
  fe_add(tm, t4, myz, p.y);
  fe_add(tm, y3a, mxz, p.x);
  fe_sub(tm, u, y3a, bz1); fe_triple(tm, x3b, u);
  fe_sub(tm, z3a, t1, x3b);
  fe_add(tm, x3c, t1, x3b);
  fe_mul(tm, by, bm, y3a);
  fe_triple(tm, t2b, p.z);
  fe_sub(tm, u, by, t2b); fe_sub(tm, v, u, t0); fe_triple(tm, y3c, v);
  fe_triple(tm, u, t0); fe_sub(tm, t0c, u, t2b);
  Fe<TPI> m1, m2, m3, m4, m5, m6;
  {
    Fe<TPI>* r[6] = {&m1, &m2, &m3, &m4, &m5, &m6};
    const Fe<TPI>* a[6] = {&t4, &t0c, &x3c, &t3, &t4, &t3};
    const Fe<TPI>* b[6] = {&y3c, &y3c, &z3a, &x3c, &z3a, &t0c};
    fe_mul_n<TPI, 6>(tm, r, a, b);
  }
  fe_sub(tm, o.x, m4, m1);
  fe_add(tm, o.y, m3, m2);
  fe_add(tm, o.z, m5, m6);
}

// RCB16 algorithm 6: doubling, in place.
template <int TPI>
__device__ __forceinline__ void tpt_double(const Team<TPI>& tm, TPt<TPI>& p, const Fe<TPI>& bm) {
  Fe<TPI> t0, t1, t2, xy, xz, yz, u, v;
  {
    Fe<TPI>* r[6] = {&t0, &t1, &t2, &xy, &xz, &yz};
    const Fe<TPI>* a[6] = {&p.x, &p.y, &p.z, &p.x, &p.x, &p.y};
    const Fe<TPI>* b[6] = {&p.x, &p.y, &p.z, &p.y, &p.z, &p.z};
    fe_mul_n<TPI, 6>(tm, r, a, b);
  }
  Fe<TPI> t3, zz2, bt2, bz;
  fe_add(tm, t3, xy, xy);
  fe_add(tm, zz2, xz, xz);
  fe_mul2(tm, bt2, bm, t2, bz, bm, zz2);
  Fe<TPI> y3b, x3a, y3c, t2b, z3b, t0c, yz2;
  fe_sub(tm, u, bt2, zz2); fe_triple(tm, y3b, u);
  fe_sub(tm, x3a, t1, y3b);
  fe_add(tm, y3c, t1, y3b);
  fe_triple(tm, t2b, t2);
  fe_sub(tm, u, bz, t2b); fe_sub(tm, v, u, t0); fe_triple(tm, z3b, v);
  fe_triple(tm, u, t0); fe_sub(tm, t0c, u, t2b);
  fe_add(tm, yz2, yz, yz);
  Fe<TPI> y3m, x3m, a1, a2, a3;
  {
    Fe<TPI>* r[5] = {&y3m, &x3m, &a1, &a2, &a3};
    const Fe<TPI>* a[5] = {&x3a, &x3a, &t0c, &yz2, &yz2};
    const Fe<TPI>* b[5] = {&y3c, &t3, &z3b, &z3b, &t1};
    fe_mul_n<TPI, 5>(tm, r, a, b);
  }
  fe_sub(tm, p.x, x3m, a2);
  fe_add(tm, p.y, y3m, a1);
  fe_add(tm, u, a3, a3);
  fe_add(tm, p.z, u, u);
}

}  // anonymous namespace (p256_team.cuh)
