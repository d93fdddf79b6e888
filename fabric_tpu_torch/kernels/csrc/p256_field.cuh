// P-256 field and point arithmetic of one thread per lane, used by
// p256_v1.cu (p256_verify.cu and p256_sign.cu run teams of threads over
// p256_team.cuh): eight little-endian 32-bit limbs, Montgomery form with
// R = 2^256 (CIOS product), every value fully reduced into [0, p) after
// each operation, and the Renes-Costello-Batina complete formulas with
// a = -3 (pt_add, pt_add_mixed, pt_double) in the schedule of
// fabric_tpu/ops/p256v3.py.  Device functions only; each kernel source
// includes this header into its own translation unit.

#pragma once

#include <cstdint>

namespace {

// p = 2^256 - 2^224 + 2^192 + 2^96 - 1, little-endian 32-bit limbs
__device__ __forceinline__ uint32_t pl(int i) {
  return (i < 3) ? 0xFFFFFFFFu : (i < 6) ? 0u : (i == 6) ? 1u : 0xFFFFFFFFu;
}

__device__ __forceinline__ void fe_copy(uint32_t* r, const uint32_t* a) {
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] = a[i];
}

__device__ __forceinline__ void fe_zero(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] = 0u;
}

// r = t - p if (hi != 0 or t >= p) else t; t < 2p as (hi:t)
__device__ __forceinline__ void fe_reduce_once(uint32_t* r, const uint32_t* t, uint32_t hi) {
  uint32_t d[8];
  int64_t br = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int64_t s = (int64_t)t[i] - (int64_t)pl(i) + br;
    d[i] = (uint32_t)s;
    br = s >> 32;  // 0 or -1
  }
  const uint32_t m = (hi != 0u || br == 0) ? 0xFFFFFFFFu : 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] = (d[i] & m) | (t[i] & ~m);
}

__device__ __forceinline__ void fe_add(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t t[8];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c += (uint64_t)a[i] + b[i];
    t[i] = (uint32_t)c;
    c >>= 32;
  }
  fe_reduce_once(r, t, (uint32_t)c);
}

__device__ __forceinline__ void fe_sub(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t t[8];
  int64_t br = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int64_t s = (int64_t)a[i] - (int64_t)b[i] + br;
    t[i] = (uint32_t)s;
    br = s >> 32;
  }
  const uint32_t m = br ? 0xFFFFFFFFu : 0u;  // borrow: add p back
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c += (uint64_t)t[i] + (pl(i) & m);
    r[i] = (uint32_t)c;
    c >>= 32;
  }
}

// Montgomery product a*b*2^-256 mod p (CIOS); -p^-1 mod 2^32 == 1.
__device__ __forceinline__ void fe_mul(uint32_t* r, const uint32_t* a, const uint32_t* b) {
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
    const uint32_t m = t[0];
    c = ((uint64_t)m * pl(0) + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      c += (uint64_t)m * pl(j) + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[8];
    t[7] = (uint32_t)c;
    t[8] = t[9] + (uint32_t)(c >> 32);
  }
  fe_reduce_once(r, t, t[8]);
}

__device__ __forceinline__ void fe_triple(uint32_t* r, const uint32_t* a) {
  uint32_t t[8];
  fe_add(t, a, a);
  fe_add(r, t, a);
}

__device__ __forceinline__ bool fe_is_zero(const uint32_t* a) {
  uint32_t acc = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc |= a[i];
  return acc == 0u;
}

__device__ __forceinline__ bool fe_eq(const uint32_t* a, const uint32_t* b) {
  uint32_t acc = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc |= a[i] ^ b[i];
  return acc == 0u;
}

struct Pt {
  uint32_t x[8], y[8], z[8];
};

// RCB16 algorithm 4: complete projective addition, a = -3.
__device__ __forceinline__ void pt_add(Pt& o, const Pt& p, const Pt& q, const uint32_t* bm) {
  uint32_t t0[8], t1[8], t2[8], s1[8], s2[8], s3[8], u[8], v[8];
  fe_mul(t0, p.x, q.x);
  fe_mul(t1, p.y, q.y);
  fe_mul(t2, p.z, q.z);
  fe_add(u, p.x, p.y); fe_add(v, q.x, q.y); fe_mul(s1, u, v);
  fe_add(u, p.y, p.z); fe_add(v, q.y, q.z); fe_mul(s2, u, v);
  fe_add(u, p.x, p.z); fe_add(v, q.x, q.z); fe_mul(s3, u, v);
  uint32_t t3[8], t4[8], y3a[8];
  fe_add(u, t0, t1); fe_sub(t3, s1, u);
  fe_add(u, t1, t2); fe_sub(t4, s2, u);
  fe_add(u, t0, t2); fe_sub(y3a, s3, u);
  uint32_t bz[8], by[8];
  fe_mul(bz, bm, t2);
  fe_mul(by, bm, y3a);
  uint32_t x3b[8], z3a[8], x3c[8], t2b[8], y3c[8], t0c[8];
  fe_sub(u, y3a, bz); fe_triple(x3b, u);
  fe_sub(z3a, t1, x3b);
  fe_add(x3c, t1, x3b);
  fe_triple(t2b, t2);
  fe_sub(u, by, t2b); fe_sub(v, u, t0); fe_triple(y3c, v);
  fe_triple(u, t0); fe_sub(t0c, u, t2b);
  uint32_t m1[8], m2[8], m3[8], m4[8], m5[8], m6[8];
  fe_mul(m1, t4, y3c);
  fe_mul(m2, t0c, y3c);
  fe_mul(m3, x3c, z3a);
  fe_mul(m4, t3, x3c);
  fe_mul(m5, t4, z3a);
  fe_mul(m6, t3, t0c);
  fe_sub(o.x, m4, m1);
  fe_add(o.y, m3, m2);
  fe_add(o.z, m5, m6);
}

// RCB16 algorithm 5: mixed addition, (x2, y2) affine and never infinity.
__device__ __forceinline__ void pt_add_mixed(Pt& o, const Pt& p, const uint32_t* x2,
                                             const uint32_t* y2, const uint32_t* bm) {
  uint32_t t0[8], t1[8], s1[8], myz[8], mxz[8], bz1[8], u[8], v[8];
  fe_mul(t0, p.x, x2);
  fe_mul(t1, p.y, y2);
  fe_add(u, x2, y2); fe_add(v, p.x, p.y); fe_mul(s1, u, v);
  fe_mul(myz, y2, p.z);
  fe_mul(mxz, x2, p.z);
  fe_mul(bz1, bm, p.z);
  uint32_t t3[8], t4[8], y3a[8], x3b[8], z3a[8], x3c[8], by[8], t2b[8], y3c[8], t0c[8];
  fe_add(u, t0, t1); fe_sub(t3, s1, u);
  fe_add(t4, myz, p.y);
  fe_add(y3a, mxz, p.x);
  fe_sub(u, y3a, bz1); fe_triple(x3b, u);
  fe_sub(z3a, t1, x3b);
  fe_add(x3c, t1, x3b);
  fe_mul(by, bm, y3a);
  fe_triple(t2b, p.z);
  fe_sub(u, by, t2b); fe_sub(v, u, t0); fe_triple(y3c, v);
  fe_triple(u, t0); fe_sub(t0c, u, t2b);
  uint32_t m1[8], m2[8], m3[8], m4[8], m5[8], m6[8];
  fe_mul(m1, t4, y3c);
  fe_mul(m2, t0c, y3c);
  fe_mul(m3, x3c, z3a);
  fe_mul(m4, t3, x3c);
  fe_mul(m5, t4, z3a);
  fe_mul(m6, t3, t0c);
  fe_sub(o.x, m4, m1);
  fe_add(o.y, m3, m2);
  fe_add(o.z, m5, m6);
}

// RCB16 algorithm 6: doubling, a = -3 (in place).
__device__ __forceinline__ void pt_double(Pt& p, const uint32_t* bm) {
  uint32_t t0[8], t1[8], t2[8], xy[8], xz[8], yz[8], u[8], v[8];
  fe_mul(t0, p.x, p.x);
  fe_mul(t1, p.y, p.y);
  fe_mul(t2, p.z, p.z);
  fe_mul(xy, p.x, p.y);
  fe_mul(xz, p.x, p.z);
  fe_mul(yz, p.y, p.z);
  uint32_t t3[8], zz2[8], bt2[8], bz[8];
  fe_add(t3, xy, xy);
  fe_add(zz2, xz, xz);
  fe_mul(bt2, bm, t2);
  fe_mul(bz, bm, zz2);
  uint32_t y3b[8], x3a[8], y3c[8], t2b[8], z3b[8], t0c[8], yz2[8];
  fe_sub(u, bt2, zz2); fe_triple(y3b, u);
  fe_sub(x3a, t1, y3b);
  fe_add(y3c, t1, y3b);
  fe_triple(t2b, t2);
  fe_sub(u, bz, t2b); fe_sub(v, u, t0); fe_triple(z3b, v);
  fe_triple(u, t0); fe_sub(t0c, u, t2b);
  fe_add(yz2, yz, yz);
  uint32_t y3m[8], x3m[8], a1[8], a2[8], a3[8];
  fe_mul(y3m, x3a, y3c);
  fe_mul(x3m, x3a, t3);
  fe_mul(a1, t0c, z3b);
  fe_mul(a2, yz2, z3b);
  fe_mul(a3, yz2, t1);
  fe_sub(p.x, x3m, a2);
  fe_add(p.y, y3m, a1);
  fe_add(u, a3, a3);
  fe_add(p.z, u, u);
}

// 16 big-endian 16-bit limbs → 8 little-endian 32-bit limbs
__device__ __forceinline__ void load_be16(uint32_t* r, const int16_t* row) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t hi = (uint16_t)row[14 - 2 * i];
    const uint32_t lo = (uint16_t)row[15 - 2 * i];
    r[i] = (hi << 16) | lo;
  }
}

__device__ __forceinline__ void load_const(uint32_t* r, const uint32_t* c) {
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] = __ldg(c + i);
}

// 4-bit window digit i (MSB-first, 0..63) of a 256-bit scalar
__device__ __forceinline__ int digit(const uint32_t* u, int i) {
  const int sh = 4 * (63 - i);
  return (int)((u[sh >> 5] >> (sh & 31)) & 15u);
}

}  // anonymous namespace (p256_field.cuh)
