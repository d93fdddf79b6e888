// Batched ECDSA-P256 verification, one team of TPI threads per
// signature lane.
//
// Replaces the JAX program fabric_tpu/ops/p256v3.py::verify_batch
// (entered through verify_batch_packed / verify_batch_packed_limbs, with
// device_recode_windows), whose field core is the RNS Montgomery
// product of fabric_tpu/ops/rns.py (_mont_mul_arr, _extend).
//
// What bounds it on Hopper: INT32 multiply-adds.  The TPU needed RNS
// because its matrix unit turns base extension into a bf16 matmul; on
// this card a 256-bit Montgomery product in eight 32-bit limbs (CIOS,
// 64 + 64 32x32->64 products) is ~128 multiply-adds against ~6,600 for
// the two RNS base extensions, so the field core here is positional.
// A lane runs ~5,260 products (64 steps x (4 doublings + 1 add + 1 mixed
// add) plus the 16-entry table); nothing but the 196-byte frame row and
// the 1.75 KiB constant block is read from device memory.  In the SASS
// the multiply-adds run on the IMAD pipe and the carry handling (adds,
// logic, shifts, compares) on the INT32 ALU pipe, which issues 64 lanes
// a clock per SM, half the rate of the schedulers: that pipe is the
// limit, so the product keeps its per-round work there small.
//
// What the first design (one thread per lane, blocks of 32) lost, and
// where:
//   - occupancy: 3,072 lanes made 96 warps for 132 SMs x 4 schedulers,
//     so most schedulers had no warp and none had a second one to hide
//     the latency of a ~5,200-product dependent chain; the time stayed
//     at ~7 ms from 3,072 to 12,288 lanes;
//   - the per-lane 16-entry u2*Q table (1,536 bytes) indexed by a
//     runtime digit lived in local memory (a 1,632-byte stack), read
//     through L1 at every table add;
//   - 255 registers per thread for eight-limb temporaries, and a
//     generic CIOS with a full reduction in every add and subtract.
// The team design (p256_team.cuh):
//   - TPI threads per lane, each holding 8 / TPI limbs, in blocks of 8
//     teams, so the lanes spread evenly over the SMs.  The team size
//     follows the batch (fab_p256_verify): up to 6,144 lanes TPI = 8,
//     where 3,072 lanes make 768 warps and the kernel needs the warps to
//     hide latency; above, TPI = 4 (142 registers), whose lane issues
//     fewer instructions once the SMs are full.  Measured with
//     fabric_tpu_torch/tools/launch_steps.py on an H100 80GB HBM3, 700 W
//     (ms, TPI = 8 / 4): 2.18 / 2.92 at 3,072 lanes, 2.08 / 2.88 at
//     4,096, 3.16 / 3.30 at 6,144, 4.11 / 3.36 at 6,656, 4.33 / 3.40 at
//     8,192, 5.36 / 5.32 at 9,216, 6.32 / 5.23 at 12,288;
//   - each team's u2*Q table sits in shared memory, laid out
//     [d][coord][limb] with a 32-word entry stride and an 8-word skew per
//     team, so a table read is one word per thread, neighbouring threads
//     on neighbouring banks, and the four teams of a warp on four
//     different bank groups: no conflicts; the affine u1*G table (1 KiB)
//     is loaded into shared memory once per block;
//   - a field element is 8 / TPI registers per thread: 77 registers,
//     no stack, no spill at TPI = 8; the scalars' windows are taken by
//     shifting, so no array is indexed at run time;
//   - the product uses P-256's form (the multiplier is the low column,
//     m*p is four limb-aligned adds whose factors run on the IMAD pipe)
//     and resolves carries once per product with a team carry-lookahead
//     on whole-warp __ballot_sync votes;
//   - the RCB formulas' independent products run interleaved, up to six
//     at TPI = 8 (fe_mul_n).  Against pairs this paid 2-3% at 6,144 and
//     12,288 lanes and nothing at 3,072 (chip_smoke.py on an H100 80GB
//     HBM3, 700 W): ptxas kept 77 registers, so it did not hold more
//     products in flight, and at 1.5 warps a scheduler the 3,072-lane
//     launch stays ~35% slower per lane than the larger ones.
// Lanes past B run on the last real row with their store masked, so
// every shuffle and vote has all of its threads.
//
// Frame row (int16, 98 columns): qx | qy | r | r+n | u1 | u2 as 16
// big-endian 16-bit limbs each, then rpn_ok, pre_ok.
// Constant block (uint32 little-endian limbs): R^2 | b*R | R | TG[16][2].

#include <cstdint>
#include <cuda_runtime.h>

#include "p256_team.cuh"

namespace {

constexpr int kCols = 98;
constexpr int kTeams = 8;                     // teams (lanes) per block
constexpr int kEntryWords = 32;               // x | y | z | pad, 8 words each
constexpr int kTeamWords = 16 * kEntryWords + 8;  // + 8: bank skew per team
constexpr int kTgWords = 16 * 2 * 8;
constexpr int kSmemWords = kTeams * kTeamWords + kTgWords;
// the largest batch that runs at TPI = 8; larger ones run at TPI = 4.
// Only tools/launch_steps.py sets it (-D), to time each size alone.
#ifndef FAB_TEAM8_LANES
#define FAB_TEAM8_LANES 6144
#endif

// this rank's limbs of a 16-limb big-endian int16 column group
template <int TPI>
__device__ __forceinline__ void load_fe(Fe<TPI>& r, const int16_t* col, int t) {
#pragma unroll
  for (int l = 0; l < Fe<TPI>::L; ++l) {
    const int i = t * Fe<TPI>::L + l;
    const uint32_t hi = (uint16_t)col[14 - 2 * i];
    const uint32_t lo = (uint16_t)col[15 - 2 * i];
    r.v[l] = (hi << 16) | lo;
  }
}

template <int TPI>
__device__ __forceinline__ void load_const_fe(Fe<TPI>& r, const uint32_t* c, int t) {
#pragma unroll
  for (int l = 0; l < Fe<TPI>::L; ++l) r.v[l] = c[t * Fe<TPI>::L + l];
}

template <int TPI>
__device__ __forceinline__ void store_pt(uint32_t* e, const TPt<TPI>& p, int t) {
#pragma unroll
  for (int l = 0; l < Fe<TPI>::L; ++l) {
    e[t * Fe<TPI>::L + l] = p.x.v[l];
    e[8 + t * Fe<TPI>::L + l] = p.y.v[l];
    e[16 + t * Fe<TPI>::L + l] = p.z.v[l];
  }
}

// the whole 256-bit scalar of a 16-limb big-endian column group
__device__ __forceinline__ void load_scalar(uint32_t* u, const int16_t* col) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
    u[i] = ((uint32_t)(uint16_t)col[14 - 2 * i] << 16) | (uint16_t)col[15 - 2 * i];
}

// the top 4-bit window of a 256-bit scalar, which then moves up by 4
// bits (so the scalar stays in registers: no runtime limb index)
__device__ __forceinline__ int next_window(uint32_t* u) {
  const int d = (int)(u[7] >> 28);
#pragma unroll
  for (int k = 7; k > 0; --k) u[k] = (u[k] << 4) | (u[k - 1] >> 28);
  u[0] <<= 4;
  return d;
}

template <int TPI>
__global__ void __launch_bounds__(kTeams * TPI)
p256_verify_kernel(const int16_t* __restrict__ frame, int B,
                   const uint32_t* __restrict__ consts, uint8_t* __restrict__ out) {
  __shared__ __align__(16) uint32_t smem[kSmemWords];
  const Team<TPI> tm;
  const int t = tm.t;
  const int team = threadIdx.x / TPI;
  const int lane = blockIdx.x * (blockDim.x / TPI) + team;
  const int16_t* row = frame + (size_t)min(lane, B - 1) * kCols;
  uint32_t* sq = smem + team * kTeamWords;  // this team's T[d] = d*Q
  uint32_t* sg = smem + kTeams * kTeamWords;  // TG[d][xy][limb], affine d*G
  for (int i = threadIdx.x; i < kTgWords; i += blockDim.x) sg[i] = consts[24 + i];

  Fe<TPI> qx, qy, rr, rpn, r2, bm, one;
  load_fe(qx, row, t);
  load_fe(qy, row + 16, t);
  load_fe(rr, row + 32, t);
  load_fe(rpn, row + 48, t);
  uint32_t u1[8], u2[8];
  load_scalar(u1, row + 64);
  load_scalar(u2, row + 80);
  const bool rpn_ok = row[96] != 0;
  const bool pre_ok = row[97] != 0;
  load_const_fe(r2, consts, t);
  load_const_fe(bm, consts + 8, t);
  load_const_fe(one, consts + 16, t);

  // Q to Montgomery form; on-curve: y^2 == x^3 - 3x + b
  TPt<TPI> q;
  fe_mul2(tm, q.x, qx, r2, q.y, qy, r2);
  q.z = one;
  bool on_curve;
  {
    Fe<TPI> y2, x2, x3, tr, rhs;
    fe_mul2(tm, y2, q.y, q.y, x2, q.x, q.x);
    fe_mul(tm, x3, x2, q.x);
    fe_triple(tm, tr, q.x);
    fe_add(tm, rhs, x3, bm);
    fe_sub(tm, rhs, rhs, tr);
    on_curve = fe_eq(tm, y2, rhs);
  }

  // u2*Q window table in shared memory: T[0] = infinity (0 : 1 : 0)
  TPt<TPI> acc;
#pragma unroll
  for (int l = 0; l < Fe<TPI>::L; ++l) acc.x.v[l] = acc.z.v[l] = 0u;
  acc.y = one;
  store_pt(sq, acc, t);
  store_pt(sq + kEntryWords, q, t);
  {
    TPt<TPI> e = q;
#pragma unroll 1
    for (int d = 2; d < 16; ++d) {
      tpt_add(tm, e, e, q, bm);
      store_pt(sq + d * kEntryWords, e, t);
    }
  }
  __syncthreads();  // the team's table and the block's TG

#pragma unroll 1
  for (int i = 0; i < 64; ++i) {
#pragma unroll 1
    for (int k = 0; k < 4; ++k) tpt_double(tm, acc, bm);
    const uint32_t* e = sq + next_window(u2) * kEntryWords;
    TPt<TPI> tq, tt;
#pragma unroll
    for (int l = 0; l < Fe<TPI>::L; ++l) {
      tq.x.v[l] = e[t * Fe<TPI>::L + l];
      tq.y.v[l] = e[8 + t * Fe<TPI>::L + l];
      tq.z.v[l] = e[16 + t * Fe<TPI>::L + l];
    }
    tpt_add(tm, tt, acc, tq, bm);
    const int d1 = next_window(u1);
    Fe<TPI> gx, gy;
    load_const_fe(gx, sg + d1 * 16, t);
    load_const_fe(gy, sg + d1 * 16 + 8, t);
    TPt<TPI> g;
    tpt_add_mixed(tm, g, tt, gx, gy, bm);
    fe_select(acc.x, g.x, tt.x, d1 != 0);  // digit 0 skips the add
    fe_select(acc.y, g.y, tt.y, d1 != 0);
    fe_select(acc.z, g.z, tt.z, d1 != 0);
  }

  // x(R) == r (mod n)  <=>  X == r*Z or (r+n)*Z (mod p), r+n only if < p
  const bool not_inf = !fe_is_zero(tm, acc.z);
  Fe<TPI> rm, pm, rz, pz;
  fe_mul2(tm, rm, rr, r2, pm, rpn, r2);
  fe_mul2(tm, rz, rm, acc.z, pz, pm, acc.z);
  const bool cmp1 = fe_eq(tm, acc.x, rz);
  const bool cmp2 = fe_eq(tm, acc.x, pz) && rpn_ok;  // the vote runs in every team
  if (t == 0 && lane < B) out[lane] = (uint8_t)(pre_ok && on_curve && not_inf && (cmp1 || cmp2));
}

}  // namespace

extern "C" int fab_p256_verify(const int16_t* frame, int B, const uint32_t* consts,
                               uint8_t* out, void* stream) {
  if (B > 0) {
    const int blocks = (B + kTeams - 1) / kTeams;
    const cudaStream_t s = (cudaStream_t)stream;
    if (B <= FAB_TEAM8_LANES) {
      p256_verify_kernel<8><<<blocks, kTeams * 8, 0, s>>>(frame, B, consts, out);
    } else {
      p256_verify_kernel<4><<<blocks, kTeams * 4, 0, s>>>(frame, B, consts, out);
    }
  }
  return (int)cudaGetLastError();
}

extern "C" const char* fab_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
