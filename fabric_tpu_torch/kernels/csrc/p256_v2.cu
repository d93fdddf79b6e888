// The v2 comparison verifier: batched ECDSA-P256 in signed base-2^6
// digits, one thread per lane.
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
// The form is v2's: a value is 43 signed 6-bit digits in int32.  A
// product is the digit convolution (43 x 43 multiply-adds into 85
// columns) plus the linear reduction of the 42 high columns, each cut
// into three 6-bit chunks, against the constant R [126 x 43]; then
// settle's certified carry schedule (3 rounds of 3 passes and a chunked
// fold through F, then one tidy pass).  int32 is exact because
// DigitMod.bound_check keeps every column under 2^24; the schedule is
// the certified one, unchanged.  R, F, the digits of each modulus and
// the settled bounds are in __constant__ memory (every lane reads the
// same entry at once), copied there from the wrapper's constant block
// once per device; the affine u1*G table TG[16][2][43] is read from device
// memory (lanes read different rows).
//
// Each value carries a |digit| bound beside its digits, and a product
// settles ("condenses") an operand exactly where the reference's
// FV.__mul__ does.  The bounds are the same in every lane, so every lane
// takes the same branch: the decisions the reference makes at trace time.
//
// What bounds it on Hopper: integer multiply-adds, ~7,300 per product
// plus ~1,700 settle operations, ~5,700 products per lane.  Known
// weakness: one thread per lane keeps the u2*Q table (16 x 3 x 43 int32,
// 8.3 KB) and every temporary point in local memory; at 4096 lanes the
// card runs 128 warps on 132 SMs.  One warp per lane with the digits
// across its threads, or tensor-core products, are later work.
//
// Frame row (int32, 260 columns): e | r | s | rpn | qx | qy as 43
// canonical digits each, then rpn_ok, pre_ok.  Constant block (int32):
// settled_p | settled_n | R_p[126][43] | R_n | F_p[4][43] | F_n |
// digits of p | digits of n | TG[16][2][43].

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int K = 43;
constexpr int H = 42;
constexpr int W = 6;
constexpr int DM = 63;
constexpr int kCols = 6 * K + 2;
constexpr int kThreads = 32;
constexpr long long kSumLimit = (1 << 24) / K;

struct Tables {
  int32_t settled[2];
  int32_t R[2][3 * H][K];
  int32_t F[2][4][K];
  int32_t m[2][K];
};
constexpr int kTableWords = (int)(sizeof(Tables) / 4);

__constant__ Tables cT;

struct FV {
  int32_t d[K];
  int32_t b;  // |digit| bound, the same in every lane
};

// one settle round schedule on digits held in registers (DigitMod.settle)
template <int M>
__device__ __forceinline__ void settle_regs(int32_t* t) {
#pragma unroll 1
  for (int round = 0; round < 3; ++round) {
    int32_t top = 0;
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      int32_t cin = 0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int32_t v = t[k];
        t[k] = (v & DM) + cin;
        cin = v >> W;
      }
      top += cin;
    }
    const int32_t t0 = top & DM, t1 = (top >> W) & DM, t2 = top >> (2 * W);
#pragma unroll
    for (int k = 0; k < K; ++k)
      t[k] += t0 * cT.F[M][0][k] + t1 * cT.F[M][1][k] + t2 * cT.F[M][2][k];
  }
  int32_t cin = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int32_t v = t[k];
    t[k] = (v & DM) + cin;
    cin = v >> W;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) t[k] += cin * cT.F[M][0][k];
}

// out = a * b mod m, settled (DigitMod.mul); out may alias a or b
template <int M>
__device__ __noinline__ void dm_mul(int32_t* out, const int32_t* a, const int32_t* b) {
  int32_t ra[K], rb[K], t[K], hc[H];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    ra[i] = a[i];
    rb[i] = b[i];
  }
#pragma unroll
  for (int k = 0; k < 2 * K - 1; ++k) {
    int32_t acc = 0;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      if (k - i >= 0 && k - i < K) acc += ra[i] * rb[k - i];
    }
    if (k < K) {
      t[k] = acc;
    } else {
      hc[k - K] = acc;
    }
  }
#pragma unroll 1
  for (int h = 0; h < H; ++h) {
    const int32_t x = hc[h];
    const int32_t lo = x & DM, mid = (x >> W) & DM, hi = x >> (2 * W);
#pragma unroll
    for (int j = 0; j < K; ++j)
      t[j] += lo * cT.R[M][h][j] + mid * cT.R[M][H + h][j] + hi * cT.R[M][2 * H + h][j];
  }
  settle_regs<M>(t);
#pragma unroll
  for (int i = 0; i < K; ++i) out[i] = t[i];
}

template <int M>
__device__ __noinline__ void dm_settle(int32_t* out, const int32_t* in) {
  int32_t t[K];
#pragma unroll
  for (int i = 0; i < K; ++i) t[i] = in[i];
  settle_regs<M>(t);
#pragma unroll
  for (int i = 0; i < K; ++i) out[i] = t[i];
}

// sequential carry over the digits: digits to [0, 63], returns the carry out
__device__ __forceinline__ int32_t sweep(int32_t* t) {
  int32_t carry = 0;
  for (int k = 0; k < K; ++k) {
    const int32_t v = t[k] + carry;
    t[k] = v & DM;
    carry = v >> W;
  }
  return carry;
}

// canonical digits of (value mod m) (DigitMod.canonical)
template <int M>
__device__ __noinline__ void dm_canonical(int32_t* t, const int32_t* in) {
  dm_settle<M>(t, in);
  for (int r = 0; r < 3; ++r) {
    const int32_t over = sweep(t);
    for (int k = 0; k < K; ++k) t[k] += over * cT.F[M][0][k];
  }
  sweep(t);
  for (int r = 0; r < 4; ++r) {
    bool gt = false, lt = false;
    for (int k = K - 1; k >= 0; --k) {
      const bool und = !gt && !lt;
      gt = gt || (und && t[k] > cT.m[M][k]);
      lt = lt || (und && t[k] < cT.m[M][k]);
    }
    const int32_t ge = (gt || !lt) ? 1 : 0;
    for (int k = 0; k < K; ++k) t[k] -= ge * cT.m[M][k];
    sweep(t);
  }
}

template <int M>
__device__ bool dm_eq_zero(const int32_t* in) {
  int32_t t[K];
  dm_canonical<M>(t, in);
  int32_t acc = 0;
  for (int k = 0; k < K; ++k) acc |= t[k];
  return acc == 0;
}

// -- FV: the reference's bound-tracked field value ----------------------

__device__ __forceinline__ void fv_add(FV& o, const FV& a, const FV& b) {
  const int32_t bound = a.b + b.b;
  for (int k = 0; k < K; ++k) o.d[k] = a.d[k] + b.d[k];
  o.b = bound;
}

__device__ __forceinline__ void fv_sub(FV& o, const FV& a, const FV& b) {
  const int32_t bound = a.b + b.b;
  for (int k = 0; k < K; ++k) o.d[k] = a.d[k] - b.d[k];
  o.b = bound;
}

// o = a * b, condensing the fatter side first when the pairing limit
// would be passed, then both (FV.__mul__)
template <int M>
__device__ __noinline__ void fv_mul(FV& o, const FV& a, const FV& b) {
  const int32_t settled = cT.settled[M];
  FV ca, cb;
  const int32_t* pa = a.d;
  const int32_t* pb = b.d;
  long long ab = a.b, bb = b.b;
  if (ab * bb >= kSumLimit) {
    if (ab >= bb) {
      dm_settle<M>(ca.d, pa);
      pa = ca.d;
      ab = settled;
    } else {
      dm_settle<M>(cb.d, pb);
      pb = cb.d;
      bb = settled;
    }
    if (ab * bb >= kSumLimit) {
      dm_settle<M>(ca.d, pa);
      dm_settle<M>(cb.d, pb);
      pa = ca.d;
      pb = cb.d;
    }
  }
  dm_mul<M>(o.d, pa, pb);
  o.b = settled;
}

__device__ __forceinline__ void fv_settled(FV& o, const int32_t* d, int32_t bound) {
  for (int k = 0; k < K; ++k) o.d[k] = d[k];
  o.b = bound;
}

struct PtV {
  FV x, y, z;
};

constexpr int P_ = 0;  // mod p
constexpr int N_ = 1;  // mod n

// RCB16 algorithm 4 (pt_add), the reference's statement order; o may
// alias p or q
__device__ __noinline__ void pt_add(PtV& o, const PtV& p, const PtV& q, const FV& bf) {
  FV t0, t1, t2, t3, t4, X3, Y3, Z3;
  fv_mul<P_>(t0, p.x, q.x);
  fv_mul<P_>(t1, p.y, q.y);
  fv_mul<P_>(t2, p.z, q.z);
  fv_add(t3, p.x, p.y);
  fv_add(t4, q.x, q.y);
  fv_mul<P_>(t3, t3, t4);
  fv_add(t4, t0, t1);
  fv_sub(t3, t3, t4);
  fv_add(t4, p.y, p.z);
  fv_add(X3, q.y, q.z);
  fv_mul<P_>(t4, t4, X3);
  fv_add(X3, t1, t2);
  fv_sub(t4, t4, X3);
  fv_add(X3, p.x, p.z);
  fv_add(Y3, q.x, q.z);
  fv_mul<P_>(X3, X3, Y3);
  fv_add(Y3, t0, t2);
  fv_sub(Y3, X3, Y3);
  fv_mul<P_>(Z3, bf, t2);
  fv_sub(X3, Y3, Z3);
  fv_add(Z3, X3, X3);
  fv_add(X3, X3, Z3);
  fv_sub(Z3, t1, X3);
  fv_add(X3, t1, X3);
  fv_mul<P_>(Y3, bf, Y3);
  fv_add(t1, t2, t2);
  fv_add(t2, t1, t2);
  fv_sub(Y3, Y3, t2);
  fv_sub(Y3, Y3, t0);
  fv_add(t1, Y3, Y3);
  fv_add(Y3, t1, Y3);
  fv_add(t1, t0, t0);
  fv_add(t0, t1, t0);
  fv_sub(t0, t0, t2);
  fv_mul<P_>(t1, t4, Y3);
  fv_mul<P_>(t2, t0, Y3);
  fv_mul<P_>(Y3, X3, Z3);
  fv_add(Y3, Y3, t2);
  fv_mul<P_>(X3, t3, X3);
  fv_sub(X3, X3, t1);
  fv_mul<P_>(Z3, t4, Z3);
  fv_mul<P_>(t1, t3, t0);
  fv_add(Z3, Z3, t1);
  o.x = X3;
  o.y = Y3;
  o.z = Z3;
}

// RCB16 algorithm 5 (pt_add_mixed): (x2, y2) affine, never infinity
__device__ __noinline__ void pt_add_mixed(PtV& o, const PtV& p, const FV& x2, const FV& y2,
                                          const FV& bf) {
  FV t0, t1, t2, t3, t4, X3, Y3, Z3;
  fv_mul<P_>(t0, p.x, x2);
  fv_mul<P_>(t1, p.y, y2);
  fv_add(t3, x2, y2);
  fv_add(t4, p.x, p.y);
  fv_mul<P_>(t3, t3, t4);
  fv_add(t4, t0, t1);
  fv_sub(t3, t3, t4);
  fv_mul<P_>(t4, y2, p.z);
  fv_add(t4, t4, p.y);
  fv_mul<P_>(Y3, x2, p.z);
  fv_add(Y3, Y3, p.x);
  fv_mul<P_>(Z3, bf, p.z);
  fv_sub(X3, Y3, Z3);
  fv_add(Z3, X3, X3);
  fv_add(X3, X3, Z3);
  fv_sub(Z3, t1, X3);
  fv_add(X3, t1, X3);
  fv_mul<P_>(Y3, bf, Y3);
  fv_add(t1, p.z, p.z);
  fv_add(t2, t1, p.z);
  fv_sub(Y3, Y3, t2);
  fv_sub(Y3, Y3, t0);
  fv_add(t1, Y3, Y3);
  fv_add(Y3, t1, Y3);
  fv_add(t1, t0, t0);
  fv_add(t0, t1, t0);
  fv_sub(t0, t0, t2);
  fv_mul<P_>(t1, t4, Y3);
  fv_mul<P_>(t2, t0, Y3);
  fv_mul<P_>(Y3, X3, Z3);
  fv_add(Y3, Y3, t2);
  fv_mul<P_>(X3, t3, X3);
  fv_sub(X3, X3, t1);
  fv_mul<P_>(Z3, t4, Z3);
  fv_mul<P_>(t1, t3, t0);
  fv_add(Z3, Z3, t1);
  o.x = X3;
  o.y = Y3;
  o.z = Z3;
}

// RCB16 algorithm 6 (pt_double); o may alias p
__device__ __noinline__ void pt_double(PtV& o, const PtV& p, const FV& bf) {
  FV t0, t1, t2, t3, X3, Y3, Z3;
  fv_mul<P_>(t0, p.x, p.x);
  fv_mul<P_>(t1, p.y, p.y);
  fv_mul<P_>(t2, p.z, p.z);
  fv_mul<P_>(t3, p.x, p.y);
  fv_add(t3, t3, t3);
  fv_mul<P_>(Z3, p.x, p.z);
  fv_add(Z3, Z3, Z3);
  fv_mul<P_>(Y3, bf, t2);
  fv_sub(Y3, Y3, Z3);
  fv_add(X3, Y3, Y3);
  fv_add(Y3, X3, Y3);
  fv_sub(X3, t1, Y3);
  fv_add(Y3, t1, Y3);
  fv_mul<P_>(Y3, X3, Y3);
  fv_mul<P_>(X3, X3, t3);
  fv_add(t3, t2, t2);
  fv_add(t2, t2, t3);
  fv_mul<P_>(Z3, bf, Z3);
  fv_sub(Z3, Z3, t2);
  fv_sub(Z3, Z3, t0);
  fv_add(t3, Z3, Z3);
  fv_add(Z3, Z3, t3);
  fv_add(t3, t0, t0);
  fv_add(t0, t3, t0);
  fv_sub(t0, t0, t2);
  fv_mul<P_>(t0, t0, Z3);
  fv_add(Y3, Y3, t0);
  fv_mul<P_>(t0, p.y, p.z);
  fv_add(t0, t0, t0);
  fv_mul<P_>(Z3, t0, Z3);
  fv_sub(X3, X3, Z3);
  fv_mul<P_>(Z3, t0, t1);
  fv_add(Z3, Z3, Z3);
  fv_add(Z3, Z3, Z3);
  o.x = X3;
  o.y = Y3;
  o.z = Z3;
}

// window i (most significant first) of a canonical digit scalar
__device__ __forceinline__ int window_of(const int32_t* u, int i) {
  const int b0 = 4 * (63 - i);
  int w = 0;
  for (int q = 0; q < 4; ++q) {
    const int b = b0 + q;
    w |= ((u[b / W] >> (b % W)) & 1) << q;
  }
  return w;
}

__device__ __forceinline__ void fv_const(FV& o, int32_t lo, int32_t bound) {
  for (int k = 0; k < K; ++k) o.d[k] = 0;
  o.d[0] = lo;
  o.b = bound;
}

__device__ __forceinline__ void fv_load(FV& o, const int32_t* row, int32_t bound) {
  for (int k = 0; k < K; ++k) o.d[k] = row[k];
  o.b = bound;
}

__global__ void __launch_bounds__(kThreads)
p256_v2_kernel(const int32_t* __restrict__ frame, int B, const int32_t* __restrict__ tg,
               const int32_t* __restrict__ b_digits, uint8_t* __restrict__ out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const int32_t* row = frame + (size_t)lane * kCols;
  const int32_t sp = cT.settled[P_], sn = cT.settled[N_];
  const bool rpn_ok = row[6 * K] != 0;
  const bool pre_ok = row[6 * K + 1] != 0;

  // on-curve (mod p): y^2 == x^3 - 3x + b
  FV qx, qy, bf;
  fv_load(qx, row + 4 * K, 63);
  fv_load(qy, row + 5 * K, 63);
  fv_load(bf, b_digits, 63);
  bool on_curve;
  {
    FV y2, x2, x3, t;
    fv_mul<P_>(y2, qy, qy);
    fv_mul<P_>(x2, qx, qx);
    fv_mul<P_>(x3, x2, qx);
    fv_add(t, qx, qx);
    fv_add(t, t, qx);
    fv_sub(x3, x3, t);
    fv_add(x3, x3, bf);
    fv_sub(t, y2, x3);
    on_curve = dm_eq_zero<P_>(t.d);
  }

  // s^-1 (mod n) by Fermat: a square per bit of n - 2, a multiply at each set bit
  int32_t u1[K], u2[K];
  {
    FV s, acc, sq, t;
    fv_load(s, row + 2 * K, 63);
    fv_const(acc, 1, sn);
    constexpr uint32_t nm2[8] = {0xFC63254Fu, 0xF3B9CAC2u, 0xA7179E84u, 0xBCE6FAADu,
                                 0xFFFFFFFFu, 0xFFFFFFFFu, 0x00000000u, 0xFFFFFFFFu};
#pragma unroll 1
    for (int i = 0; i < 256; ++i) {
      acc.b = sn;
      fv_mul<N_>(sq, acc, acc);
      const int j = 255 - i;
      if ((nm2[j >> 5] >> (j & 31)) & 1u) {
        fv_mul<N_>(acc, sq, s);
      } else {
        acc = sq;
      }
    }
    acc.b = sn;
    fv_load(t, row, 63);
    fv_mul<N_>(t, t, acc);
    dm_canonical<N_>(u1, t.d);
    fv_load(t, row + K, 63);
    fv_mul<N_>(t, t, acc);
    dm_canonical<N_>(u2, t.d);
  }

  // u2*Q window table: T[0] = infinity (0 : 1 : 0), T[d] = d*Q
  PtV tq[16];
  fv_const(tq[0].x, 0, 0);
  fv_const(tq[0].y, 1, 63);
  fv_const(tq[0].z, 0, 0);
  tq[1].x = qx;
  tq[1].y = qy;
  fv_const(tq[1].z, 1, 63);
  int32_t tq_bound = 63;
#pragma unroll 1
  for (int d = 2; d < 16; ++d) {
    pt_add(tq[d], tq[d - 1], tq[1], bf);
    tq_bound = max(tq_bound, max(tq[d].x.b, max(tq[d].y.b, tq[d].z.b)));
  }

  // 64 steps of 4 doublings, + T_Q[w2], + T_G[w1] unless w1 = 0; a settle
  // of the running point after each step
  int32_t X[K], Y[K], Z[K];
  for (int k = 0; k < K; ++k) X[k] = Y[k] = Z[k] = 0;
  Y[0] = 1;
  PtV R, Rg;
  FV gx, gy;
#pragma unroll 1
  for (int i = 0; i < 64; ++i) {
    fv_settled(R.x, X, sp);
    fv_settled(R.y, Y, sp);
    fv_settled(R.z, Z, sp);
#pragma unroll 1
    for (int k = 0; k < 4; ++k) pt_double(R, R, bf);
    PtV& t2 = tq[window_of(u2, i)];
    PtV sel;
    fv_settled(sel.x, t2.x.d, tq_bound);
    fv_settled(sel.y, t2.y.d, tq_bound);
    fv_settled(sel.z, t2.z.d, tq_bound);
    pt_add(R, R, sel, bf);
    const int d1 = window_of(u1, i);
    fv_load(gx, tg + (d1 * 2) * K, 63);
    fv_load(gy, tg + (d1 * 2 + 1) * K, 63);
    pt_add_mixed(Rg, R, gx, gy, bf);
    const PtV& src = d1 == 0 ? R : Rg;
    dm_settle<P_>(X, src.x.d);
    dm_settle<P_>(Y, src.y.d);
    dm_settle<P_>(Z, src.z.d);
  }

  // R != infinity and x(R) == r (mod n): X == r Z or (r+n) Z (mod p)
  FV Xf, Zf, t, u;
  fv_settled(Xf, X, sp);
  fv_settled(Zf, Z, sp);
  const bool not_inf = !dm_eq_zero<P_>(Z);
  fv_load(t, row + K, 63);
  fv_mul<P_>(t, t, Zf);
  fv_sub(u, Xf, t);
  const bool cmp1 = dm_eq_zero<P_>(u.d);
  fv_load(t, row + 3 * K, 63);
  fv_mul<P_>(t, t, Zf);
  fv_sub(u, Xf, t);
  const bool cmp2 = dm_eq_zero<P_>(u.d) && rpn_ok;
  out[lane] = (uint8_t)(pre_ok && on_curve && not_inf && (cmp1 || cmp2));
}

}  // namespace

// Copies the Tables part of the constant block (the module comment) into
// the current device's __constant__ memory and waits for the copy.  The
// block is a constant of the curve, so the wrapper calls this once per
// device, before the first launch there; launches on any stream then
// read it.
extern "C" int fab_p256_v2_tables(const int32_t* consts, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemcpyToSymbolAsync(cT, consts, sizeof(Tables), 0,
                                            cudaMemcpyDeviceToDevice, s);
  if (err == cudaSuccess) err = cudaStreamSynchronize(s);
  return (int)err;
}

// consts: the int32 block of the module comment, its Tables already in
// __constant__ memory (fab_p256_v2_tables); TG and b are read from it.
extern "C" int fab_p256_verify_v2(const int32_t* frame, int B, const int32_t* consts,
                                  uint8_t* out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (B > 0) {
    const int blocks = (B + kThreads - 1) / kThreads;
    const int32_t* tg = consts + kTableWords;
    const int32_t* b_digits = tg + 16 * 2 * K;
    p256_v2_kernel<<<blocks, kThreads, 0, s>>>(frame, B, tg, b_digits, out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* fab_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
