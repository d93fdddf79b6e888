// Batched ECDSA-P256 verification, one thread per signature lane.
//
// Replaces the JAX program fabric_tpu/ops/p256v3.py::verify_batch
// (entered through verify_batch_packed / verify_batch_packed_limbs, with
// device_recode_windows), whose field core is the RNS Montgomery
// product of fabric_tpu/ops/rns.py (_mont_mul_arr, _extend).
//
// What bounds it on Hopper: integer multiply-adds.  The TPU needed RNS
// because its matrix unit turns base extension into a bf16 matmul; on
// this card a 256-bit Montgomery product in eight 32-bit limbs (CIOS,
// 64 + 64 32x32->64 products) is ~128 multiply-adds against ~6,600 for
// the two RNS base extensions, so the field core here is positional.
// A lane runs ~5,260 products (64 steps x (4 doublings + 1 add + 1 mixed
// add) plus the 16-entry table), all of it register/local-memory work:
// nothing but the 196-byte frame row is read from device memory.
//
// Design: values stay fully reduced in [0, p) after every operation
// (conditional subtraction in each add/sub/product), so equality is limb
// equality.  The point formulas are the Renes-Costello-Batina complete
// ones with a = -3 in the reference's schedule (pt_add / pt_add_mixed /
// pt_double), so infinity, Q = +-G and repeated digits take exactly the
// reference's arithmetic.  The per-lane u2*Q table lives in local
// memory; the affine u1*G table (Montgomery form) comes from a constant
// block read through the read-only cache.  The digit-0 skip of the mixed
// add is a select.  Known weakness: one thread per lane leaves the card
// mostly idle at 3072 lanes (96 blocks of 32 threads on 132 SMs); the
// launch is latency-bound.
//
// Frame row (int16, 98 columns): qx | qy | r | r+n | u1 | u2 as 16
// big-endian 16-bit limbs each, then rpn_ok, pre_ok.
// Constant block (uint32 little-endian limbs): R^2 | b*R | R | TG[16][2].

#include <cstdint>
#include <cuda_runtime.h>

#include "p256_field.cuh"

namespace {

constexpr int kCols = 98;
constexpr int kThreads = 32;

__global__ void __launch_bounds__(kThreads)
p256_verify_kernel(const int16_t* __restrict__ frame, int B,
                   const uint32_t* __restrict__ consts, uint8_t* __restrict__ out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const int16_t* row = frame + (size_t)lane * kCols;
  uint32_t qx[8], qy[8], rr[8], rpn[8], u1[8], u2[8];
  load_be16(qx, row);
  load_be16(qy, row + 16);
  load_be16(rr, row + 32);
  load_be16(rpn, row + 48);
  load_be16(u1, row + 64);
  load_be16(u2, row + 80);
  const bool rpn_ok = row[96] != 0;
  const bool pre_ok = row[97] != 0;

  uint32_t r2[8], bm[8], one[8];
  load_const(r2, consts);
  load_const(bm, consts + 8);
  load_const(one, consts + 16);
  const uint32_t* tg = consts + 24;  // TG[d][xy][8]

  // Q to Montgomery form; on-curve: y^2 == x^3 - 3x + b
  Pt q;
  fe_mul(q.x, qx, r2);
  fe_mul(q.y, qy, r2);
  fe_copy(q.z, one);
  bool on_curve;
  {
    uint32_t y2[8], x2[8], x3[8], t[8], rhs[8];
    fe_mul(y2, q.y, q.y);
    fe_mul(x2, q.x, q.x);
    fe_mul(x3, x2, q.x);
    fe_triple(t, q.x);
    fe_add(rhs, x3, bm);
    fe_sub(rhs, rhs, t);
    on_curve = fe_eq(y2, rhs);
  }

  // u2*Q window table: T[0] = infinity (0 : 1 : 0), T[d] = d*Q
  Pt tab[16];
  fe_zero(tab[0].x);
  fe_copy(tab[0].y, one);
  fe_zero(tab[0].z);
  tab[1] = q;
#pragma unroll 1
  for (int d = 2; d < 16; ++d) pt_add(tab[d], tab[d - 1], q, bm);

  Pt acc;
  fe_zero(acc.x);
  fe_copy(acc.y, one);
  fe_zero(acc.z);
#pragma unroll 1
  for (int i = 0; i < 64; ++i) {
#pragma unroll 1
    for (int k = 0; k < 4; ++k) pt_double(acc, bm);
    Pt t;
    pt_add(t, acc, tab[digit(u2, i)], bm);
    const int d1 = digit(u1, i);
    uint32_t gx[8], gy[8];
    load_const(gx, tg + d1 * 16);
    load_const(gy, tg + d1 * 16 + 8);
    Pt g;
    pt_add_mixed(g, t, gx, gy, bm);
    const uint32_t m = d1 ? 0xFFFFFFFFu : 0u;  // digit 0 skips the add
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc.x[j] = (g.x[j] & m) | (t.x[j] & ~m);
      acc.y[j] = (g.y[j] & m) | (t.y[j] & ~m);
      acc.z[j] = (g.z[j] & m) | (t.z[j] & ~m);
    }
  }

  // x(R) == r (mod n)  <=>  X == r*Z or (r+n)*Z (mod p), r+n only if < p
  const bool not_inf = !fe_is_zero(acc.z);
  uint32_t rm[8], rz[8];
  fe_mul(rm, rr, r2);
  fe_mul(rz, rm, acc.z);
  const bool cmp1 = fe_eq(acc.x, rz);
  fe_mul(rm, rpn, r2);
  fe_mul(rz, rm, acc.z);
  const bool cmp2 = rpn_ok && fe_eq(acc.x, rz);
  out[lane] = (uint8_t)(pre_ok && on_curve && not_inf && (cmp1 || cmp2));
}

}  // namespace

extern "C" int fab_p256_verify(const int16_t* frame, int B, const uint32_t* consts,
                               uint8_t* out, void* stream) {
  if (B > 0) {
    const int blocks = (B + kThreads - 1) / kThreads;
    p256_verify_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(frame, B, consts, out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* fab_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
