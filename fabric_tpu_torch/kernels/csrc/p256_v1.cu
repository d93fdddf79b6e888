// The v1 comparison verifier: batched ECDSA-P256, one team of TPI
// threads per lane.
//
// Replaces the JAX program fabric_tpu/ops/p256.py::verify_batch (jitted
// as verify_batch_jit), with its field core _mont_mul and the point
// functions _pt_double, _pt_add and _bit_of.
//
// What it computes: the reference accept set (bccsp/sw/ecdsa.go:41-58),
// every check on the device as in the reference: r, s in [1, n-1],
// s <= n/2, Q's coordinates below p, Q not (0, 0) and on the curve,
// e mod n, s^-1 = s^(n-2) by Fermat, u1 = e s^-1 and u2 = r s^-1 mod n,
// R = u1 G + u2 Q by a 256-step double-and-add Shamir ladder over
// {infinity, G, Q, G+Q}, and X == r Z^2 or (r+n) Z^2 (mod p).
//
// What bounds it on Hopper: integer multiply-adds, ~6,200 Montgomery
// products mod p and 428 mod n a lane (each 64 + 64 32x32->64 products
// in eight 32-bit limbs); nothing but the 320-byte frame row and a
// 320-byte constant block is read from device memory.  v1's 16-bit limbs
// were the TPU's lack of 64-bit products and are not part of what it
// computes.  The first design (one thread a lane) ran 128 warps at
// 4,096 lanes on 132 SMs, 168 registers with a spill, a generic CIOS
// with 64-bit signed borrows in every add, and computed the doubling
// case of every complete add (8 of each ladder step's 32 products) to
// select it away.  This design:
//   - a team of TPI threads per lane over p256_team.cuh (TPI = 8: one
//     32-bit limb a rank; TPI = 4: two), 8 teams a block: the team's
//     Montgomery product, its carry-lookahead adds and subtracts, and
//     its votes for equality and zero; each formula's independent
//     products run interleaved (fe_mul_n);
//   - the range, low-S and zero checks are team lookaheads and votes;
//     each rank loads its own limbs of the frame row;
//   - a team mod-n product: the same CIOS over the team, but rank 0
//     forms the round's multipliers m = t0 * (-n^-1 mod 2^32) from its
//     low columns and broadcasts them, and m * n takes n's limbs as real
//     products (-n^-1 is not 1 mod 2^32, and n's limbs are not all-ones
//     or zero): about two mod-p products;
//   - jac_add's doubling case (P1 = P2, computed only to be selected)
//     runs when a team of the warp needs it: an __any_sync vote, so the
//     branch is uniform over the warp and every shuffle keeps its 32
//     lanes, and the select is the reference's.  Q = G makes G + Q a
//     doubling, Q = -G makes it infinity; both still take the
//     reference's arithmetic.
// Every team runs every vote and shuffle: checks are combined only after
// each is computed.  Lanes past B run on the last real row with their
// store masked.
//
// Frame row (int32, 80 columns): e | r | s | qx | qy as 16 little-endian
// 16-bit limbs each.  Constant block (uint32 little-endian limbs, 8 each):
// R^2 mod p | b R | Gx R | Gy R | R mod p | R^2 mod n | R mod n | n | n/2 | p.

#include <cstdint>
#include <cuda_runtime.h>

#include "p256_team.cuh"

namespace {

constexpr int kCols = 80;
constexpr int kTeams = 8;                   // teams (lanes) a block
constexpr uint32_t kN0Inv = 0xEE00BC4Fu;    // -n^-1 mod 2^32

// n - 2, little-endian 32-bit words: the Fermat exponent
__constant__ uint32_t kNm2[8] = {0xFC63254Fu, 0xF3B9CAC2u, 0xA7179E84u, 0xBCE6FAADu,
                                 0xFFFFFFFFu, 0xFFFFFFFFu, 0x00000000u, 0xFFFFFFFFu};

// this rank's limbs of a 16-limb little-endian 16-bit column group
template <int TPI>
__device__ __forceinline__ void load_le16(Fe<TPI>& r, const int32_t* col, int t) {
#pragma unroll
  for (int l = 0; l < Fe<TPI>::L; ++l) {
    const int i = t * Fe<TPI>::L + l;
    r.v[l] = ((uint32_t)col[2 * i] & 0xFFFFu) | (((uint32_t)col[2 * i + 1] & 0xFFFFu) << 16);
  }
}

template <int TPI>
__device__ __forceinline__ void load_const_fe(Fe<TPI>& r, const uint32_t* c, int t) {
#pragma unroll
  for (int l = 0; l < Fe<TPI>::L; ++l) r.v[l] = c[t * Fe<TPI>::L + l];
}

// a < b over the team: the borrow out of a - b
template <int TPI>
__device__ __forceinline__ bool fe_lt(const Team<TPI>& tm, const Fe<TPI>& a, const Fe<TPI>& b) {
  constexpr int L = Team<TPI>::L;
  uint32_t d[L];
  const uint32_t bo = sub_local<L>(d, a.v, b.v);
  uint32_t bout;
  tm.lookahead(bo != 0u, all_zero<L>(d), &bout);
  return bout != 0u;
}

// r = a - b (mod 2^256)
template <int TPI>
__device__ __forceinline__ void fe_sub_raw(const Team<TPI>& tm, Fe<TPI>& r, const Fe<TPI>& a,
                                           const Fe<TPI>& b) {
  constexpr int L = Team<TPI>::L;
  const uint32_t bo = sub_local<L>(r.v, a.v, b.v);
  uint32_t ignored;
  const uint32_t bin = tm.lookahead(bo != 0u, all_zero<L>(r.v), &ignored);
  sub_borrow_in<L>(r.v, bin);
}

// r = a + b (mod 2^256); returns the carry out of 2^256
template <int TPI>
__device__ __forceinline__ uint32_t fe_add_raw(const Team<TPI>& tm, Fe<TPI>& r, const Fe<TPI>& a,
                                               const Fe<TPI>& b) {
  constexpr int L = Team<TPI>::L;
  const uint32_t c = add_local<L>(r.v, a.v, b.v);
  uint32_t top;
  const uint32_t cin = tm.lookahead(c != 0u, all_ones<L>(r.v), &top);
  add_carry_in<L>(r.v, cin);
  return top;
}

// Montgomery product mod n, a * b * 2^-256, for a * b < n 2^256: the
// output is in [0, n).  CIOS over the team (fe_mul_il's layout): in
// macro-round j every rank adds a x (rank j's limbs of b) into its 2L
// 64-bit columns; rank 0 forms the round's L multipliers from its low
// columns (each from the column's low word once the multipliers below
// it are added) and broadcasts them; every rank adds m x (its limbs of
// n), which clears rank 0's low columns; the columns' carries move up
// and the low words one rank down.  Then one normalisation and one
// reduction below n, as fe_mul_il does below p.  nl: this rank's limbs of n.
template <int TPI>
__device__ __forceinline__ void fn_mul(const Team<TPI>& tm, Fe<TPI>& r, const Fe<TPI>& a,
                                       const Fe<TPI>& b, const uint32_t* nl) {
  constexpr int L = Team<TPI>::L;
  uint64_t acc[2 * L];
#pragma unroll
  for (int c = 0; c < 2 * L; ++c) acc[c] = 0u;
#pragma unroll
  for (int j = 0; j < TPI; ++j) {
#pragma unroll
    for (int s = 0; s < L; ++s) {
      const uint32_t bi = __shfl_sync(kWarp, b.v[s], j, TPI);
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const uint64_t pr = (uint64_t)a.v[l] * bi;
        acc[l + s] += (uint32_t)pr;
        acc[l + s + 1] += pr >> 32;
      }
    }
    uint32_t m[L];
    {
      uint64_t lo[L];
#pragma unroll
      for (int c = 0; c < L; ++c) lo[c] = acc[c];
#pragma unroll
      for (int s = 0; s < L; ++s) {
        if (s > 0) lo[s] += lo[s - 1] >> 32;
        m[s] = (uint32_t)lo[s] * kN0Inv;
#pragma unroll
        for (int l = 0; l + s < L; ++l) {
          const uint64_t pr = (uint64_t)m[s] * nl[l];
          lo[s + l] += (uint32_t)pr;
          if (s + l + 1 < L) lo[s + l + 1] += pr >> 32;
        }
      }
#pragma unroll
      for (int s = 0; s < L; ++s) m[s] = __shfl_sync(kWarp, m[s], 0, TPI);
    }
#pragma unroll
    for (int s = 0; s < L; ++s)
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const uint64_t pr = (uint64_t)m[s] * nl[l];
        acc[l + s] += (uint32_t)pr;
        acc[l + s + 1] += pr >> 32;
      }
#pragma unroll
    for (int l = 0; l < L; ++l) {
      acc[l + 1] += acc[l] >> 32;
      acc[l] &= 0xFFFFFFFFu;
    }
    uint32_t lo[L];
#pragma unroll
    for (int l = 0; l < L; ++l)
      lo[l] = __shfl_down_sync(kWarp, (uint32_t)acc[l], 1, TPI) & tm.below;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      acc[l] = acc[L + l] + lo[l];
      acc[L + l] = 0u;
    }
  }
  // normalise: own carries up, each rank's top carry to the rank above
  // (the top rank's is bit 256), one lookahead, then one reduction below n
  uint32_t v[L];
#pragma unroll
  for (int l = 0; l + 1 < L; ++l) acc[l + 1] += acc[l] >> 32;
#pragma unroll
  for (int l = 0; l < L; ++l) v[l] = (uint32_t)acc[l];
  const uint32_t h = (uint32_t)(acc[L - 1] >> 32);
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
  const bool g = c != 0u || (tm.t == TPI - 1 && h != 0u);
  uint32_t top;
  const uint32_t cin = tm.lookahead(g, all_ones<L>(v), &top);
  add_carry_in<L>(v, cin);
  // (top:v) - n if (top:v) >= n, for (top:v) < 2n
  uint32_t d[L];
  const uint32_t bo = sub_local<L>(d, v, nl);
  uint32_t bout;
  const uint32_t bin = tm.lookahead(bo != 0u, all_zero<L>(d), &bout);
  sub_borrow_in<L>(d, bin);
  const uint32_t keep_d = (top != 0u || bout == 0u) ? 0xFFFFFFFFu : 0u;
#pragma unroll
  for (int l = 0; l < L; ++l) r.v[l] = (d[l] & keep_d) | (v[l] & ~keep_d);
}

// dbl-2001-b, a = -3 (the reference's _pt_double), in place; Z = 0 stays 0
template <int TPI>
__device__ __forceinline__ void jac_double(const Team<TPI>& tm, TPt<TPI>& p) {
  Fe<TPI> yz, delta, gamma, yz2;
  fe_add(tm, yz, p.y, p.z);
  {
    Fe<TPI>* r[3] = {&delta, &gamma, &yz2};
    const Fe<TPI>* a[3] = {&p.z, &p.y, &yz};
    fe_mul_n<TPI, 3>(tm, r, a, a);
  }
  Fe<TPI> t1, t2, t3, beta, alpha, gg;
  fe_sub(tm, t1, p.x, delta);
  fe_add(tm, t2, p.x, delta);
  fe_triple(tm, t3, t2);
  {
    Fe<TPI>* r[3] = {&beta, &alpha, &gg};
    const Fe<TPI>* a[3] = {&p.x, &t1, &gamma};
    const Fe<TPI>* b[3] = {&gamma, &t3, &gamma};
    fe_mul_n<TPI, 3>(tm, r, a, b);
  }
  Fe<TPI> u, v, beta4, aa, x3, z3, g8;
  fe_add(tm, u, beta, beta);
  fe_add(tm, beta4, u, u);
  fe_mul(tm, aa, alpha, alpha);
  fe_add(tm, v, beta4, beta4);
  fe_sub(tm, x3, aa, v);
  fe_sub(tm, v, yz2, gamma);
  fe_sub(tm, z3, v, delta);
  fe_add(tm, u, gg, gg);
  fe_add(tm, v, u, u);
  fe_add(tm, g8, v, v);
  fe_sub(tm, u, beta4, x3);
  fe_mul(tm, v, alpha, u);
  fe_sub(tm, p.y, v, g8);
  p.x = x3;
  p.z = z3;
}

template <int TPI>
__device__ __forceinline__ void pt_select(TPt<TPI>& o, const TPt<TPI>& a, const TPt<TPI>& b,
                                          bool take_a) {
  fe_select(o.x, a.x, b.x, take_a);
  fe_select(o.y, a.y, b.y, take_a);
  fe_select(o.z, a.z, b.z, take_a);
}

// Complete Jacobian addition (the reference's _pt_add): o = p + q, o may
// alias p or q.  The doubling case runs only when a team of the warp
// takes it.
template <int TPI>
__device__ __forceinline__ void jac_add(const Team<TPI>& tm, TPt<TPI>& o, const TPt<TPI>& p,
                                        const TPt<TPI>& q) {
  Fe<TPI> z1z, z2z, y1z2, y2z1, z1z2;
  {
    Fe<TPI>* r[5] = {&z1z, &z2z, &y1z2, &y2z1, &z1z2};
    const Fe<TPI>* a[5] = {&p.z, &q.z, &p.y, &q.y, &p.z};
    const Fe<TPI>* b[5] = {&p.z, &q.z, &q.z, &p.z, &q.z};
    fe_mul_n<TPI, 5>(tm, r, a, b);
  }
  Fe<TPI> u1, u2, s1, s2;
  {
    Fe<TPI>* r[4] = {&u1, &u2, &s1, &s2};
    const Fe<TPI>* a[4] = {&p.x, &q.x, &y1z2, &y2z1};
    const Fe<TPI>* b[4] = {&z2z, &z1z, &z2z, &z1z};
    fe_mul_n<TPI, 4>(tm, r, a, b);
  }
  Fe<TPI> h, rr, hh, rr2, z3;
  fe_sub(tm, h, u2, u1);
  fe_sub(tm, rr, s2, s1);
  {
    Fe<TPI>* r[3] = {&hh, &rr2, &z3};
    const Fe<TPI>* a[3] = {&h, &rr, &z1z2};
    const Fe<TPI>* b[3] = {&h, &rr, &h};
    fe_mul_n<TPI, 3>(tm, r, a, b);
  }
  Fe<TPI> hhh, v;
  fe_mul2(tm, hhh, h, hh, v, u1, hh);
  Fe<TPI> t, w, x3, y3a, s1h;
  fe_sub(tm, t, rr2, hhh);
  fe_add(tm, w, v, v);
  fe_sub(tm, x3, t, w);
  fe_sub(tm, t, v, x3);
  fe_mul2(tm, y3a, rr, t, s1h, s1, hhh);
  TPt<TPI> r;
  r.x = x3;
  fe_sub(tm, r.y, y3a, s1h);
  r.z = z3;
  const bool p1_inf = fe_is_zero(tm, p.z);
  const bool p2_inf = fe_is_zero(tm, q.z);
  const bool h0 = fe_is_zero(tm, h);
  const bool r0 = fe_is_zero(tm, rr);
  const bool same = h0 && r0 && !p1_inf && !p2_inf;
  if (__any_sync(kWarp, same)) {
    TPt<TPI> d = p;
    jac_double(tm, d);
    pt_select(r, d, r, same);
  }
  pt_select(r, q, r, p1_inf);
  pt_select(o, p, r, p2_inf);
}

// the top bit of a 256-bit scalar, which then moves up by one (so the
// scalar stays in registers: no runtime word index)
__device__ __forceinline__ uint32_t next_bit(uint32_t* u) {
  const uint32_t b = u[7] >> 31;
#pragma unroll
  for (int k = 7; k > 0; --k) u[k] = (u[k] << 1) | (u[k - 1] >> 31);
  u[0] <<= 1;
  return b;
}

// the whole 256-bit value of a team element, in every rank
template <int TPI>
__device__ __forceinline__ void gather_words(uint32_t* u, const Fe<TPI>& a) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
    u[i] = __shfl_sync(kWarp, a.v[i % Fe<TPI>::L], i / Fe<TPI>::L, TPI);
}

template <int TPI>
__global__ void __launch_bounds__(kTeams * TPI)
p256_v1_kernel(const int32_t* __restrict__ frame, int B, const uint32_t* __restrict__ consts,
               uint8_t* __restrict__ out) {
  const Team<TPI> tm;
  const int t = tm.t;
  const int lane = blockIdx.x * kTeams + threadIdx.x / TPI;
  const int32_t* row = frame + (size_t)min(lane, B - 1) * kCols;
  Fe<TPI> e, r, s, qx, qy;
  load_le16(e, row, t);
  load_le16(r, row + 16, t);
  load_le16(s, row + 32, t);
  load_le16(qx, row + 48, t);
  load_le16(qy, row + 64, t);
  Fe<TPI> r2, bm, one, r2n, rn, nf, half_n, pf;
  TPt<TPI> g;
  load_const_fe(r2, consts, t);
  load_const_fe(bm, consts + 8, t);
  load_const_fe(g.x, consts + 16, t);
  load_const_fe(g.y, consts + 24, t);
  load_const_fe(one, consts + 32, t);
  load_const_fe(r2n, consts + 40, t);
  load_const_fe(rn, consts + 48, t);
  load_const_fe(nf, consts + 56, t);
  load_const_fe(half_n, consts + 64, t);
  load_const_fe(pf, consts + 72, t);
  g.z = one;

  // scalar ranges and low-S; Q's coordinates below p and not (0, 0)
  const bool r_zero = fe_is_zero(tm, r), r_lt = fe_lt(tm, r, nf);
  const bool s_zero = fe_is_zero(tm, s), s_lt = fe_lt(tm, s, nf);
  const bool high_s = fe_lt(tm, half_n, s);
  const bool qx_lt = fe_lt(tm, qx, pf), qy_lt = fe_lt(tm, qy, pf);
  const bool qx_zero = fe_is_zero(tm, qx), qy_zero = fe_is_zero(tm, qy);
  const bool admitted = !r_zero && r_lt && !s_zero && s_lt && !high_s && qx_lt && qy_lt &&
                        !(qx_zero && qy_zero);
  // Q to Montgomery form; on the curve: y^2 == x^3 - 3x + b
  TPt<TPI> q;
  fe_mul2(tm, q.x, qx, r2, q.y, qy, r2);
  q.z = one;
  bool on_curve;
  {
    Fe<TPI> y2, x2, x3, tr, rhs;
    fe_mul2(tm, y2, q.y, q.y, x2, q.x, q.x);
    fe_mul(tm, x3, x2, q.x);
    fe_triple(tm, tr, q.x);
    fe_sub(tm, rhs, x3, tr);
    fe_add(tm, rhs, rhs, bm);
    on_curve = fe_eq(tm, y2, rhs);
  }

  // u1 = e s^-1, u2 = r s^-1 (mod n); w = s^(n-2) in Montgomery form
  uint32_t u1[8], u2[8];
  {
    uint32_t nl[Fe<TPI>::L];
#pragma unroll
    for (int l = 0; l < Fe<TPI>::L; ++l) nl[l] = nf.v[l];
    Fe<TPI> e_red, e_n, sm, w, x;
    const bool e_lt = fe_lt(tm, e, nf);
    fe_sub_raw(tm, e_n, e, nf);
    fe_select(e_red, e, e_n, e_lt);
    fn_mul(tm, sm, s, r2n, nl);
    w = rn;
#pragma unroll 1
    for (int k = 0; k < 256; ++k) {
      fn_mul(tm, w, w, w, nl);
      const int j = 255 - k;
      if ((kNm2[j >> 5] >> (j & 31)) & 1u) fn_mul(tm, w, w, sm, nl);
    }
    fn_mul(tm, x, e_red, w, nl);
    gather_words(u1, x);
    fn_mul(tm, x, r, w, nl);
    gather_words(u2, x);
  }

  // Shamir ladder over {infinity, G, Q, G+Q}
  TPt<TPI> gq;
  jac_add(tm, gq, g, q);
  TPt<TPI> acc;
#pragma unroll
  for (int l = 0; l < Fe<TPI>::L; ++l) acc.x.v[l] = acc.y.v[l] = acc.z.v[l] = 0u;
#pragma unroll 1
  for (int k = 0; k < 256; ++k) {
    jac_double(tm, acc);
    const uint32_t b1 = next_bit(u1), b2 = next_bit(u2);
    TPt<TPI> tt;
    pt_select(tt, q, g, b2 != 0u);
    pt_select(tt, gq, tt, (b1 & b2) != 0u);
    const uint32_t zm = (b1 | b2) ? 0xFFFFFFFFu : 0u;  // bits 0, 0: infinity
#pragma unroll
    for (int l = 0; l < Fe<TPI>::L; ++l) tt.z.v[l] &= zm;
    jac_add(tm, acc, acc, tt);
  }

  // R != infinity and x(R) == r (mod n): X == r Z^2 or (r+n) Z^2 (mod p)
  const bool not_inf = !fe_is_zero(tm, acc.z);
  Fe<TPI> rpn, z2, rm, pm, rz, pz;
  const uint32_t carry = fe_add_raw(tm, rpn, r, nf);
  const bool rpn_lt = fe_lt(tm, rpn, pf);
  {
    Fe<TPI>* o[3] = {&z2, &rm, &pm};
    const Fe<TPI>* a[3] = {&acc.z, &r, &rpn};
    const Fe<TPI>* b[3] = {&acc.z, &r2, &r2};
    fe_mul_n<TPI, 3>(tm, o, a, b);
  }
  fe_mul2(tm, rz, rm, z2, pz, pm, z2);
  const bool cmp1 = fe_eq(tm, acc.x, rz);
  const bool cmp2 = fe_eq(tm, acc.x, pz) && carry == 0u && rpn_lt;
  if (t == 0 && lane < B)
    out[lane] = (uint8_t)(admitted && on_curve && not_inf && (cmp1 || cmp2));
}

}  // namespace

// the largest batch that runs at TPI = 8; larger ones run at TPI = 4.
// Only tools/launch_steps.py sets it (-D), to time each size alone.
#ifndef FAB_V1_TEAM8_LANES
#define FAB_V1_TEAM8_LANES 8192
#endif

extern "C" int fab_p256_verify_v1(const int32_t* frame, int B, const uint32_t* consts,
                                  uint8_t* out, void* stream) {
  if (B > 0) {
    const int blocks = (B + kTeams - 1) / kTeams;
    const cudaStream_t s = (cudaStream_t)stream;
    if (B <= FAB_V1_TEAM8_LANES) {
      p256_v1_kernel<8><<<blocks, kTeams * 8, 0, s>>>(frame, B, consts, out);
    } else {
      p256_v1_kernel<4><<<blocks, kTeams * 4, 0, s>>>(frame, B, consts, out);
    }
  }
  return (int)cudaGetLastError();
}

// out: the threads a lane, the registers a thread and the local bytes a
// thread (stack frame, spills included) of the kernel a B-lane batch runs
extern "C" int fab_p256_verify_v1_attrs(int B, int* out) {
  cudaFuncAttributes a;
  const bool team8 = B <= FAB_V1_TEAM8_LANES;
  const cudaError_t err = team8 ? cudaFuncGetAttributes(&a, p256_v1_kernel<8>)
                                : cudaFuncGetAttributes(&a, p256_v1_kernel<4>);
  out[0] = team8 ? 8 : 4;
  out[1] = a.numRegs;
  out[2] = (int)a.localSizeBytes;
  return (int)err;
}

extern "C" const char* fab_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
