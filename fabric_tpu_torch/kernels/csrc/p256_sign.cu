// Batched fixed-base scalar multiplication R = k*G for ECDSA-P256
// signing, one thread per signature lane.
//
// Replaces the JAX program fabric_tpu/ops/p256sign.py::sign_batch_limbs
// (with its comb table _fb_table and device_recode_windows).
//
// What bounds it on Hopper: integer multiply-adds.  The base point never
// changes, so the verify ladder's 64 x [4 doublings + table add]
// collapses to 64 complete MIXED adds against a comb table
// T[j][d] = d * 16^(63-j) * G (affine, Montgomery form): 13 Montgomery
// products per nonzero digit, ~830 per lane, each ~128 32x32->64
// multiply-adds (p256_field.cuh).  Nothing but the 32-byte nonce row and
// the table entries a lane selects is read from device memory; the
// 64 KiB table is too large for __constant__ space and its lookups are
// data-dependent per lane, so it stays in global memory and is read
// through the read-only path (__ldg), where the 50 MB L2 holds it.
//
// Design: the schedule is the reference's.  The running point starts at
// infinity (0 : R : 0); pt_add_mixed needs an affine addend that is not
// infinity, so a digit-0 step keeps the running point (slot 0 of each
// table row is never read).  k in [1, n-1] makes R finite, so Z != 0 for
// real lanes; the wrapper pads lanes with k = 1.  The kernel writes the
// projective X and Z in Montgomery form; the host computes
// x = X * Z^-1 mod p, where the Montgomery factors cancel.  Known
// weakness: one thread per lane, like p256_verify; at 256 lanes the
// launch is latency-bound.
//
// Nonce row (int16, 16 columns): k as big-endian 16-bit limbs.
// Constant block (uint32 little-endian limbs): b*R | R.
// Comb table (uint32): [64 steps][16 digits][x | y][8 limbs].
// Output (uint32): [B][X | Z][8 limbs].

#include <cstdint>
#include <cuda_runtime.h>

#include "p256_field.cuh"

namespace {

constexpr int kSignThreads = 64;

__global__ void __launch_bounds__(kSignThreads)
p256_sign_kernel(const int16_t* __restrict__ limbs, int B,
                 const uint32_t* __restrict__ consts, const uint32_t* __restrict__ comb,
                 uint32_t* __restrict__ out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  uint32_t k[8];
  load_be16(k, limbs + (size_t)lane * 16);
  uint32_t bm[8], one[8];
  load_const(bm, consts);
  load_const(one, consts + 8);

  Pt acc;
  fe_zero(acc.x);
  fe_copy(acc.y, one);
  fe_zero(acc.z);
#pragma unroll 1
  for (int i = 0; i < 64; ++i) {
    const int d = digit(k, i);
    if (d == 0) continue;  // the running point stays
    const uint32_t* t = comb + ((size_t)i * 16 + d) * 16;
    uint32_t gx[8], gy[8];
    load_const(gx, t);
    load_const(gy, t + 8);
    Pt g;
    pt_add_mixed(g, acc, gx, gy, bm);
    acc = g;
  }
  uint32_t* o = out + (size_t)lane * 16;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    o[j] = acc.x[j];
    o[8 + j] = acc.z[j];
  }
}

}  // namespace

extern "C" int fab_p256_sign(const int16_t* limbs, int B, const uint32_t* consts,
                             const uint32_t* comb, uint32_t* out, void* stream) {
  if (B > 0) {
    const int blocks = (B + kSignThreads - 1) / kSignThreads;
    p256_sign_kernel<<<blocks, kSignThreads, 0, (cudaStream_t)stream>>>(limbs, B, consts,
                                                                        comb, out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* fab_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
