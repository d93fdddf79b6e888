// Batched fixed-base scalar multiplication R = k*G for ECDSA-P256
// signing: each lane's 64 comb steps split into C chains, each chain run
// by one team of TPI threads.
//
// Replaces the JAX program fabric_tpu/ops/p256sign.py::sign_batch_limbs
// (with its comb table _fb_table and device_recode_windows).
//
// What bounds it on Hopper: the latency of a dependent chain of
// Montgomery products.  The base point never changes, so the verify
// ladder's 64 x [4 doublings + table add] collapses to 64 complete MIXED
// adds against a comb table T[j][d] = d * 16^(63-j) * G (affine,
// Montgomery form): 13 products per nonzero digit.  The sign lane
// launches 16 lanes at a time (one flush of at most 8 digests, padded),
// so the work is tiny and the time is the length of one lane's chain.
//
// What the first design (one thread per lane) lost: a
// lane was one thread running all 64 adds, ~830 products one after
// another, each a generic CIOS with 64-bit signed borrows (121
// registers); 16 lanes were one warp on one SM, and the time stayed at
// 0.53-0.60 ms from 16 to 4,096 lanes.  This design:
//   - a team of TPI threads per chain (p256_team.cuh, as p256_verify):
//     8 / TPI limbs a thread, the product in P-256's form with carries
//     resolved once a product by team votes;
//   - C chains per lane (C = 1, 2, 4, 8 or 16, chosen by the caller:
//     it changes the projective representative).  The comb has no
//     doublings, so any split of the digits sums to k*G: chain c adds
//     the digits c*64/C .. (c+1)*64/C - 1 against their comb rows,
//     starting from its first digit's entry (or infinity, (0 : 1 : 0),
//     for a zero digit) instead of adding it to infinity.  The C partial
//     points of a lane meet in shared memory and are summed by a fixed
//     tree of complete adds in log2(C) levels, adjacent pairs first.
//     The critical path falls from 64 mixed adds to 64/C - 1 mixed adds
//     and log2(C) complete adds;
//   - every team runs the same instruction stream: each digit step runs
//     the mixed add and then selects (a zero digit keeps the point), so
//     every shuffle and vote has all 32 lanes of its warp; at a tree
//     level, a team whose partial is not needed computes a sum all the
//     same (the formulas are symmetric, so both teams of a pair get the
//     same point) unless its whole warp is not needed, which skips the
//     add together;
//   - lanes past B run on the last real row with their store masked.
// The comb entries a team reads come through the read-only path (__ldg),
// one word per thread; the 64 KiB table stays in L2.
//
// Nonce row (int16, 16 columns): k as big-endian 16-bit limbs.
// Constant block (uint32 little-endian limbs): b*R | R.
// Comb table (uint32): [64 steps][16 digits][x | y][8 limbs].
// Output (uint32): [B][X | Z][8 limbs], canonical Montgomery form.

#include <cstdint>
#include <cuda_runtime.h>

#include "p256_team.cuh"

namespace {

constexpr int kMaxChains = 16;
constexpr int kLaneTeams = 8;   // at least this many teams a block
constexpr int kPtWords = 24;    // x | y | z, 8 words each
constexpr int kSmemWords = 2 * kMaxChains * kPtWords;  // two buffers, by level parity
// the largest batch that runs at TPI = 8; larger ones run at TPI = 4.
// Only tools/launch_steps.py sets it (-D), to time each size alone.
#ifndef FAB_SIGN_TEAM8_LANES
#define FAB_SIGN_TEAM8_LANES 3072
#endif

// teams a block: whole lanes, at least kLaneTeams
__host__ __device__ constexpr int sign_block_teams(int chains) {
  return chains > kLaneTeams ? chains : kLaneTeams;
}

// 4-bit window digit i (MSB-first, 0..63) of a 16-limb big-endian row
__device__ __forceinline__ int nonce_digit(const int16_t* row, int i) {
  return (int)(((uint32_t)(uint16_t)__ldg(row + (i >> 2)) >> (12 - 4 * (i & 3))) & 15u);
}

template <int TPI>
__device__ __forceinline__ void load_comb(Fe<TPI>& x, Fe<TPI>& y, const uint32_t* comb, int i,
                                          int d, int t) {
  const uint32_t* e = comb + ((size_t)i * 16 + d) * 16;
#pragma unroll
  for (int l = 0; l < Fe<TPI>::L; ++l) {
    x.v[l] = __ldg(e + t * Fe<TPI>::L + l);
    y.v[l] = __ldg(e + 8 + t * Fe<TPI>::L + l);
  }
}

template <int TPI>
__device__ __forceinline__ void load_const_fe(Fe<TPI>& r, const uint32_t* c, int t) {
#pragma unroll
  for (int l = 0; l < Fe<TPI>::L; ++l) r.v[l] = __ldg(c + t * Fe<TPI>::L + l);
}

template <int TPI>
__global__ void __launch_bounds__(kMaxChains * TPI)
p256_sign_kernel(const int16_t* __restrict__ limbs, int B, int chains,
                 const uint32_t* __restrict__ consts, const uint32_t* __restrict__ comb,
                 uint32_t* __restrict__ out) {
  __shared__ __align__(16) uint32_t smem[kSmemWords];
  constexpr int L = Fe<TPI>::L;
  const Team<TPI> tm;
  const int t = tm.t;
  const int team = threadIdx.x / TPI;
  const int c = team & (chains - 1);  // this team's chain within its lane
  const int lane = (blockIdx.x * sign_block_teams(chains) + team) / chains;
  const int16_t* row = limbs + (size_t)min(lane, B - 1) * 16;
  const int steps = 64 / chains;
  const int i0 = c * steps;
  Fe<TPI> bm, one, zero;
  load_const_fe(bm, consts, t);
  load_const_fe(one, consts + 8, t);
#pragma unroll
  for (int l = 0; l < L; ++l) zero.v[l] = 0u;

  // the chain's first digit: its entry, or infinity for a zero digit
  TPt<TPI> acc;
  {
    const int d = nonce_digit(row, i0);
    Fe<TPI> gx, gy;
    load_comb(gx, gy, comb, i0, d, t);  // entry 0 holds zeros
    fe_select(acc.x, gx, zero, d != 0);
    fe_select(acc.y, gy, one, d != 0);
    fe_select(acc.z, one, zero, d != 0);
  }
#pragma unroll 1
  for (int s = 1; s < steps; ++s) {
    const int i = i0 + s;
    const int d = nonce_digit(row, i);
    Fe<TPI> gx, gy;
    load_comb(gx, gy, comb, i, d, t);
    TPt<TPI> g;
    tpt_add_mixed(tm, g, acc, gx, gy, bm);
    fe_select(acc.x, g.x, acc.x, d != 0);  // a zero digit keeps the point
    fe_select(acc.y, g.y, acc.y, d != 0);
    fe_select(acc.z, g.z, acc.z, d != 0);
  }

  // the lane's partials: level h adds the partial of chain c ^ h, so
  // chain 0 ends with ((P0 + P1) + (P2 + P3)) + ... .  A warp none of
  // whose teams has c % 2h == 0 holds no partial still needed and skips
  // the add (the test is the same in every team of a warp).
  const int warp_teams = 32 / TPI;
  const int warp_c0 = c & ~(warp_teams - 1);
  int parity = 0;
#pragma unroll 1
  for (int h = 1; h < chains; h <<= 1, parity ^= 1) {
    uint32_t* buf = smem + parity * kMaxChains * kPtWords;
    uint32_t* mine = buf + team * kPtWords;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      mine[t * L + l] = acc.x.v[l];
      mine[8 + t * L + l] = acc.y.v[l];
      mine[16 + t * L + l] = acc.z.v[l];
    }
    __syncthreads();
    const uint32_t* other = buf + (team ^ h) * kPtWords;
    TPt<TPI> q;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      q.x.v[l] = other[t * L + l];
      q.y.v[l] = other[8 + t * L + l];
      q.z.v[l] = other[16 + t * L + l];
    }
    if (2 * h <= warp_teams || warp_c0 % (2 * h) == 0) tpt_add(tm, acc, acc, q, bm);
  }

  if (c == 0 && lane < B) {
    uint32_t* o = out + (size_t)lane * 16;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      o[t * L + l] = acc.x.v[l];
      o[8 + t * L + l] = acc.z.v[l];
    }
  }
}

}  // namespace

// TPI the launch of a B-lane batch runs at
extern "C" int fab_p256_sign_tpi(int B) { return B <= FAB_SIGN_TEAM8_LANES ? 8 : 4; }

extern "C" int fab_p256_sign(const int16_t* limbs, int B, int chains, const uint32_t* consts,
                             const uint32_t* comb, uint32_t* out, void* stream) {
  if (chains < 1 || chains > kMaxChains || (chains & (chains - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  if (B > 0) {
    const int teams = sign_block_teams(chains);
    const int blocks = (int)(((long long)B * chains + teams - 1) / teams);
    const cudaStream_t s = (cudaStream_t)stream;
    if (fab_p256_sign_tpi(B) == 8) {
      p256_sign_kernel<8><<<blocks, teams * 8, 0, s>>>(limbs, B, chains, consts, comb, out);
    } else {
      p256_sign_kernel<4><<<blocks, teams * 4, 0, s>>>(limbs, B, chains, consts, comb, out);
    }
  }
  return (int)cudaGetLastError();
}

extern "C" const char* fab_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
