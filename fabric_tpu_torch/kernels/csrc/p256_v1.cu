// The v1 comparison verifier: batched ECDSA-P256, one thread per lane.
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
// What bounds it on Hopper: integer multiply-adds.  A lane runs 8,654
// Montgomery products (8,226 mod p, 428 mod n), each a CIOS product of
// eight 32-bit limbs (64 + 64 32x32->64 multiply-adds); nothing but the
// 320-byte frame row and a 320-byte constant block is read from device
// memory.  v1's 16-bit limbs were the TPU's lack of 64-bit products and
// are not part of what it computes, so the field here is the eight-limb
// Montgomery core of p256_field.cuh (R = 2^256, every value fully
// reduced after each operation, so equality is limb equality) plus a
// mod-n product of the same shape.
//
// Design: the Jacobian formulas stay complete, as the reference's
// _pt_add is: the generic sum, the doubling (P1 = P2) and the identity
// cases (either operand at Z = 0) are all computed and selected without
// branches, and P1 = -P2 gives Z = 0 through h = 0.  So G + Q for
// Q = +-G, a ladder that starts at infinity and u1 = 0 take the
// reference's arithmetic.  The Fermat exponent is the same for every
// lane, so the square-and-multiply branches on its bits and no lane
// diverges.  Known weakness: 256 serial steps of 32 products on one
// thread per lane, with the add's temporaries spilling to local memory.
//
// Frame row (int32, 80 columns): e | r | s | qx | qy as 16 little-endian
// 16-bit limbs each.  Constant block (uint32 little-endian limbs, 8 each):
// R^2 mod p | b R | Gx R | Gy R | R mod p | R^2 mod n | R mod n | n | n/2 | p.

#include <cstdint>
#include <cuda_runtime.h>

#include "p256_field.cuh"

namespace {

constexpr int kCols = 80;
constexpr int kThreads = 32;
constexpr uint32_t kN0Inv = 0xEE00BC4Fu;  // -n^-1 mod 2^32

// n - 2, little-endian 32-bit words: the Fermat exponent
__device__ __forceinline__ uint32_t nm2_word(int i) {
  constexpr uint32_t w[8] = {0xFC63254Fu, 0xF3B9CAC2u, 0xA7179E84u, 0xBCE6FAADu,
                             0xFFFFFFFFu, 0xFFFFFFFFu, 0x00000000u, 0xFFFFFFFFu};
  return w[i];
}

__device__ __forceinline__ bool lt256(const uint32_t* a, const uint32_t* b) {
  int64_t br = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) br = ((int64_t)a[i] - (int64_t)b[i] + br) >> 32;
  return br != 0;
}

__device__ __forceinline__ bool is_zero256(const uint32_t* a) {
  uint32_t acc = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc |= a[i];
  return acc == 0u;
}

// r = a - b (mod 2^256)
__device__ __forceinline__ void sub256(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  int64_t br = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t s = (int64_t)a[i] - (int64_t)b[i] + br;
    r[i] = (uint32_t)s;
    br = s >> 32;
  }
}

// r = a + b; returns the carry out of 2^256
__device__ __forceinline__ uint32_t add256(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c += (uint64_t)a[i] + b[i];
    r[i] = (uint32_t)c;
    c >>= 32;
  }
  return (uint32_t)c;
}

// Montgomery product mod n, a*b*2^-256 (CIOS), for a*b < n * 2^256; the
// output is in [0, n).
__device__ __noinline__ void fn_mul(uint32_t* r, const uint32_t* a, const uint32_t* b,
                                    const uint32_t* nl) {
  uint32_t t[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) t[i] = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c += (uint64_t)a[j] * b[i] + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[8];
    t[8] = (uint32_t)c;
    t[9] = (uint32_t)(c >> 32);
    const uint32_t m = t[0] * kN0Inv;
    c = ((uint64_t)m * nl[0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      c += (uint64_t)m * nl[j] + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[8];
    t[7] = (uint32_t)c;
    t[8] = t[9] + (uint32_t)(c >> 32);
  }
  uint32_t d[8];
  int64_t br = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t s = (int64_t)t[i] - (int64_t)nl[i] + br;
    d[i] = (uint32_t)s;
    br = s >> 32;
  }
  const uint32_t keep = (t[8] == 0u && br != 0) ? 0xFFFFFFFFu : 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] = (t[i] & keep) | (d[i] & ~keep);
}

__device__ __forceinline__ void sel8(uint32_t* r, bool c, const uint32_t* a, const uint32_t* b) {
  const uint32_t m = c ? 0xFFFFFFFFu : 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] = (a[i] & m) | (b[i] & ~m);
}

// dbl-2001-b, a = -3 (the reference's _pt_double), in place; Z = 0 stays 0.
__device__ __noinline__ void jac_double(Pt& p) {
  uint32_t delta[8], gamma[8], beta[8], t1[8], t2[8], t3[8], alpha[8], beta4[8], u[8], v[8];
  fe_mul(delta, p.z, p.z);
  fe_mul(gamma, p.y, p.y);
  fe_mul(beta, p.x, gamma);
  fe_sub(t1, p.x, delta);
  fe_add(t2, p.x, delta);
  fe_add(u, t2, t2);
  fe_add(t3, t2, u);
  fe_mul(alpha, t1, t3);
  fe_add(u, beta, beta);
  fe_add(beta4, u, u);
  uint32_t x3[8], z3[8], g8[8];
  fe_mul(u, alpha, alpha);
  fe_add(v, beta4, beta4);
  fe_sub(x3, u, v);
  fe_add(u, p.y, p.z);
  fe_mul(v, u, u);
  fe_sub(v, v, gamma);
  fe_sub(z3, v, delta);
  fe_mul(u, gamma, gamma);
  fe_add(v, u, u);
  fe_add(g8, v, v);
  fe_add(g8, g8, g8);
  fe_sub(u, beta4, x3);
  fe_mul(v, alpha, u);
  fe_sub(p.y, v, g8);
  fe_copy(p.x, x3);
  fe_copy(p.z, z3);
}

// Complete Jacobian addition (the reference's _pt_add): o = p + q, o may
// alias p.
__device__ __noinline__ void jac_add(Pt& o, const Pt& p, const Pt& q) {
  uint32_t z1z[8], z2z[8], u1[8], u2[8], s1[8], s2[8], h[8], rr[8], u[8], v[8];
  fe_mul(z1z, p.z, p.z);
  fe_mul(z2z, q.z, q.z);
  fe_mul(u1, p.x, z2z);
  fe_mul(u2, q.x, z1z);
  fe_mul(u, p.y, q.z);
  fe_mul(s1, u, z2z);
  fe_mul(u, q.y, p.z);
  fe_mul(s2, u, z1z);
  fe_sub(h, u2, u1);
  fe_sub(rr, s2, s1);
  uint32_t hh[8], hhh[8], vv[8], x3[8], y3[8], z3[8];
  fe_mul(hh, h, h);
  fe_mul(hhh, h, hh);
  fe_mul(vv, u1, hh);
  fe_mul(u, rr, rr);
  fe_sub(u, u, hhh);
  fe_add(v, vv, vv);
  fe_sub(x3, u, v);
  fe_sub(u, vv, x3);
  fe_mul(v, rr, u);
  fe_mul(u, s1, hhh);
  fe_sub(y3, v, u);
  fe_mul(u, p.z, q.z);
  fe_mul(z3, u, h);
  const bool p1_inf = fe_is_zero(p.z);
  const bool p2_inf = fe_is_zero(q.z);
  const bool same = fe_is_zero(h) && fe_is_zero(rr) && !p1_inf && !p2_inf;
  Pt d = p;
  jac_double(d);
  Pt r;
  sel8(r.x, same, d.x, x3);
  sel8(r.y, same, d.y, y3);
  sel8(r.z, same, d.z, z3);
  sel8(r.x, p1_inf, q.x, r.x);
  sel8(r.y, p1_inf, q.y, r.y);
  sel8(r.z, p1_inf, q.z, r.z);
  sel8(o.x, p2_inf, p.x, r.x);
  sel8(o.y, p2_inf, p.y, r.y);
  sel8(o.z, p2_inf, p.z, r.z);
}

// 16 little-endian 16-bit limbs (int32 each) → 8 little-endian 32-bit limbs
__device__ __forceinline__ void load_le16(uint32_t* r, const int32_t* row) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
    r[i] = ((uint32_t)row[2 * i] & 0xFFFFu) | (((uint32_t)row[2 * i + 1] & 0xFFFFu) << 16);
}

__device__ __forceinline__ uint32_t bit_of(const uint32_t* u, int j) {
  return (u[j >> 5] >> (j & 31)) & 1u;
}

__global__ void __launch_bounds__(kThreads)
p256_v1_kernel(const int32_t* __restrict__ frame, int B, const uint32_t* __restrict__ consts,
               uint8_t* __restrict__ out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const int32_t* row = frame + (size_t)lane * kCols;
  uint32_t e[8], r[8], s[8], qx[8], qy[8];
  load_le16(e, row);
  load_le16(r, row + 16);
  load_le16(s, row + 32);
  load_le16(qx, row + 48);
  load_le16(qy, row + 64);
  uint32_t r2[8], bm[8], one[8], r2n[8], rn[8], nl[8], half_n[8], pl8[8];
  Pt g;
  load_const(r2, consts);
  load_const(bm, consts + 8);
  load_const(g.x, consts + 16);
  load_const(g.y, consts + 24);
  load_const(one, consts + 32);
  load_const(r2n, consts + 40);
  load_const(rn, consts + 48);
  load_const(nl, consts + 56);
  load_const(half_n, consts + 64);
  load_const(pl8, consts + 72);
  fe_copy(g.z, one);

  // scalar ranges and low-S
  const bool r_ok = !is_zero256(r) && lt256(r, nl);
  const bool s_ok = !is_zero256(s) && lt256(s, nl);
  const bool low_s = !lt256(half_n, s);
  // Q: coordinates below p, not (0, 0), on the curve
  const bool q_range = lt256(qx, pl8) && lt256(qy, pl8) && !(is_zero256(qx) && is_zero256(qy));
  Pt q;
  fe_mul(q.x, qx, r2);
  fe_mul(q.y, qy, r2);
  fe_copy(q.z, one);
  bool on_curve;
  {
    uint32_t y2[8], x2[8], x3[8], t[8], u[8];
    fe_mul(y2, q.y, q.y);
    fe_mul(x2, q.x, q.x);
    fe_mul(x3, x2, q.x);
    fe_add(t, q.x, q.x);
    fe_add(t, q.x, t);
    fe_sub(u, x3, t);
    fe_add(u, u, bm);
    on_curve = fe_eq(y2, u) && q_range;
  }

  // u1 = e s^-1, u2 = r s^-1 (mod n); w = s^(n-2) in Montgomery form
  uint32_t e_red[8], sm[8], w[8], u1[8], u2[8];
  if (lt256(e, nl)) {
    fe_copy(e_red, e);
  } else {
    sub256(e_red, e, nl);
  }
  fn_mul(sm, s, r2n, nl);
  fe_copy(w, rn);
#pragma unroll 1
  for (int k = 0; k < 256; ++k) {
    fn_mul(w, w, w, nl);
    const int j = 255 - k;
    if ((nm2_word(j >> 5) >> (j & 31)) & 1u) fn_mul(w, w, sm, nl);
  }
  fn_mul(u1, e_red, w, nl);
  fn_mul(u2, r, w, nl);

  // Shamir ladder over {infinity, G, Q, G+Q}
  Pt gq;
  jac_add(gq, g, q);
  Pt acc;
  fe_zero(acc.x);
  fe_zero(acc.y);
  fe_zero(acc.z);
#pragma unroll 1
  for (int k = 0; k < 256; ++k) {
    jac_double(acc);
    const int j = 255 - k;
    const uint32_t idx = bit_of(u1, j) + 2u * bit_of(u2, j);
    Pt t;
    sel8(t.x, idx == 3u, gq.x, idx == 2u ? q.x : g.x);
    sel8(t.y, idx == 3u, gq.y, idx == 2u ? q.y : g.y);
    sel8(t.z, idx == 3u, gq.z, one);
    if (idx == 0u) fe_zero(t.z);
    jac_add(acc, acc, t);
  }

  // R != infinity and x(R) == r (mod n): X == r Z^2 or (r+n) Z^2 (mod p)
  const bool not_inf = !fe_is_zero(acc.z);
  uint32_t z2[8], rm[8], rz[8], rpn[8];
  fe_mul(z2, acc.z, acc.z);
  fe_mul(rm, r, r2);
  fe_mul(rz, rm, z2);
  const bool cmp1 = fe_eq(acc.x, rz);
  const uint32_t carry = add256(rpn, r, nl);
  const bool rpn_lt_p = carry == 0u && lt256(rpn, pl8);
  fe_mul(rm, rpn, r2);
  fe_mul(rz, rm, z2);
  const bool cmp2 = fe_eq(acc.x, rz) && rpn_lt_p;
  out[lane] = (uint8_t)(r_ok && s_ok && low_s && on_curve && not_inf && (cmp1 || cmp2));
}

}  // namespace

extern "C" int fab_p256_verify_v1(const int32_t* frame, int B, const uint32_t* consts,
                                  uint8_t* out, void* stream) {
  if (B > 0) {
    const int blocks = (B + kThreads - 1) / kThreads;
    p256_v1_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(frame, B, consts, out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* fab_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
