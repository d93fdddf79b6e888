// Signature staging of the commit path (counterpart:
// the JAX package's native/ecprep.cpp, adapted to the port's launch
// frame).
//
// One call stages a whole batch for p256_verify: admission, Montgomery's
// batch inversion of s (one Fermat exponentiation and 3(B-1) products
// over 4x64-bit limbs, the algorithm of ops/p256v3.py::_batch_inv_mod_n),
// u1 = e*s^-1 and u2 = r*s^-1 mod n, written in place into the port's
// [B, 98] int16 frame (ops/p256v3.py), one row a signature at a row
// stride:
//
//     qx | qy | r | r+n | u1 | u2   (16 big-endian 16-bit limbs each)
//     | rpn_ok | pre_ok
//
// Admission is the reference accept set's host part
// (bccsp/sw/ecdsa.go:41-58): 0 < r < n, 0 < s <= n/2, and Q admitted
// (0 <= qx, qy < p, not (0, 0): ec_q_admit, once per identity).  r + n
// and rpn_ok are set only where r + n < p.  Rejected rows are all zero.
// A row whose s is not in (0, n) inverts 1 so the batch product stays
// invertible; Montgomery's trick is exact, so every admitted row's
// u1, u2 are those of ops/p256v3.py::stage_frame_ref, which inverts 1
// for every rejected row.
//
// The counterpart writes the TPU frame's window digits or u1/u2 limbs;
// this one writes every column of the port's frame.

#include <cstdint>
#include <cstring>

namespace {

typedef unsigned __int128 u128;

struct U256 {
  uint64_t w[4];  // little-endian limbs
};

// P-256 group order n and field prime p
static const U256 ORDER_N = {{0xf3b9cac2fc632551ull, 0xbce6faada7179e84ull,
                              0xffffffffffffffffull, 0xffffffff00000000ull}};
static const U256 PRIME_P = {{0xffffffffffffffffull, 0x00000000ffffffffull,
                              0x0000000000000000ull, 0xffffffff00000001ull}};

static int cmp(const U256& a, const U256& b) {
  for (int i = 3; i >= 0; i--) {
    if (a.w[i] < b.w[i]) return -1;
    if (a.w[i] > b.w[i]) return 1;
  }
  return 0;
}

static bool is_zero(const U256& a) {
  return !(a.w[0] | a.w[1] | a.w[2] | a.w[3]);
}

// a - b, returns borrow
static uint64_t sub(U256& out, const U256& a, const U256& b) {
  uint64_t borrow = 0;
  for (int i = 0; i < 4; i++) {
    u128 d = (u128)a.w[i] - b.w[i] - borrow;
    out.w[i] = (uint64_t)d;
    borrow = (d >> 64) ? 1 : 0;
  }
  return borrow;
}

// a + b, returns carry
static uint64_t add(U256& out, const U256& a, const U256& b) {
  uint64_t carry = 0;
  for (int i = 0; i < 4; i++) {
    u128 s = (u128)a.w[i] + b.w[i] + carry;
    out.w[i] = (uint64_t)s;
    carry = (uint64_t)(s >> 64);
  }
  return carry;
}

// Montgomery context for one odd 256-bit modulus (R = 2^256)
struct Mont {
  U256 mod;
  uint64_t n0;  // -mod^{-1} mod 2^64
  U256 R2;      // 2^512 mod mod

  void init(const U256& m) {
    mod = m;
    // Newton iteration for mod^{-1} mod 2^64, then negate
    uint64_t inv = m.w[0];
    for (int i = 0; i < 6; i++) inv *= 2 - m.w[0] * inv;
    n0 = (uint64_t)(0 - inv);
    // R2 = 2^512 mod m by 512 modular doublings of 1
    U256 x = {{1, 0, 0, 0}};
    for (int i = 0; i < 512; i++) {
      uint64_t carry = add(x, x, x);
      if (carry || cmp(x, mod) >= 0) sub(x, x, mod);
    }
    R2 = x;
  }

  // CIOS Montgomery multiplication: a·b·2^{-256} mod m.
  // Safe for any a, b < 2^256 (output < m + small overflow handled by
  // the final conditional subtract; garbage-in rows are masked by the
  // kernel's pre_ok anyway).
  U256 mul(const U256& a, const U256& b) const {
    uint64_t t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; i++) {
      uint64_t carry = 0;
      for (int j = 0; j < 4; j++) {
        u128 s = (u128)t[j] + (u128)a.w[i] * b.w[j] + carry;
        t[j] = (uint64_t)s;
        carry = (uint64_t)(s >> 64);
      }
      u128 s = (u128)t[4] + carry;
      t[4] = (uint64_t)s;
      t[5] = (uint64_t)(s >> 64);

      uint64_t mfac = t[0] * n0;
      carry = 0;
      for (int j = 0; j < 4; j++) {
        u128 s2 = (u128)t[j] + (u128)mfac * mod.w[j] + carry;
        t[j] = (uint64_t)s2;
        carry = (uint64_t)(s2 >> 64);
      }
      s = (u128)t[4] + carry;
      t[4] = (uint64_t)s;
      t[5] += (uint64_t)(s >> 64);
      // shift right one limb
      t[0] = t[1]; t[1] = t[2]; t[2] = t[3]; t[3] = t[4]; t[4] = t[5];
      t[5] = 0;
    }
    U256 r = {{t[0], t[1], t[2], t[3]}};
    if (t[4] || cmp(r, mod) >= 0) sub(r, r, mod);
    return r;
  }

  U256 to_mont(const U256& a) const { return mul(a, R2); }

  // x^(mod-2) in Montgomery domain (Fermat inverse for prime modulus)
  U256 inv_mont(const U256& x) const {
    U256 e;
    sub(e, mod, U256{{2, 0, 0, 0}});
    U256 one_m = to_mont(U256{{1, 0, 0, 0}});
    U256 acc = one_m;
    for (int i = 255; i >= 0; i--) {
      acc = mul(acc, acc);
      if ((e.w[i / 64] >> (i % 64)) & 1) acc = mul(acc, x);
    }
    return acc;
  }
};

static U256 load_be(const uint8_t* p) {
  U256 v;
  for (int i = 0; i < 4; i++) {
    uint64_t w = 0;
    for (int j = 0; j < 8; j++) w = (w << 8) | p[8 * i + j];
    v.w[3 - i] = w;
  }
  return v;
}

// 16 BIG-endian 16-bit limbs (ops/p256v3.py::_limbs16: limb j holds
// bytes 2j, 2j+1 of the big-endian encoding)
static void limbs16_of(const U256& v, int16_t* out) {
  for (int i = 0; i < 16; i++) {
    int byte_hi = 31 - 2 * i;  // big-endian byte pair
    uint64_t hi = (v.w[byte_hi / 8] >> (8 * (byte_hi % 8))) & 0xff;
    uint64_t lo = (v.w[(byte_hi - 1) / 8] >> (8 * ((byte_hi - 1) % 8))) & 0xff;
    out[i] = (int16_t)((hi << 8) | lo);
  }
}

static void limbs16_of_be(const uint8_t* p, int16_t* out) {
  for (int i = 0; i < 16; i++) out[i] = (int16_t)((p[2 * i] << 8) | p[2 * i + 1]);
}

static const Mont& mont_n() {
  // magic static: thread-safe one-time init (ctypes releases the GIL,
  // so first calls from the prefetch thread and another may race)
  static const Mont M = [] { Mont m; m.init(ORDER_N); return m; }();
  return M;
}

const int kLimbs = 16;
const int kRpnOk = 6 * kLimbs, kPreOk = 6 * kLimbs + 1, kCols = 6 * kLimbs + 2;

}  // namespace

extern "C" {

// Q admission of n public keys, q_pool [n, 64] bytes (qx || qy, each
// 32 bytes big-endian): ok[i] = qx < p and qy < p and not (0, 0).
void ec_q_admit(const uint8_t* q_pool, int64_t n, uint8_t* ok) {
  for (int64_t i = 0; i < n; i++) {
    U256 qx = load_be(q_pool + 64 * i), qy = load_be(q_pool + 64 * i + 32);
    ok[i] = cmp(qx, PRIME_P) < 0 && cmp(qy, PRIME_P) < 0 &&
            !(is_zero(qx) && is_zero(qy));
  }
}

// Stage B signatures: e_b, r_b, s_b [B, 32] big-endian bytes; row i's
// public key is q_pool row q_idx[i] ([*, 64] bytes) and q_ok[q_idx[i]]
// its admission.  Row i of the frame is written at frame + i * stride
// (int16 elements).
void ec_stage_frame(const uint8_t* e_b, const uint8_t* r_b, const uint8_t* s_b,
                    const int32_t* q_idx, const uint8_t* q_pool, const uint8_t* q_ok,
                    int64_t B, int16_t* frame, int64_t stride) {
  if (B <= 0) return;
  const Mont& M = mont_n();

  U256 half_n;  // n >> 1  (n odd → floor(n/2))
  for (int i = 0; i < 4; i++)
    half_n.w[i] = (ORDER_N.w[i] >> 1) |
                  (i < 3 ? (ORDER_N.w[i + 1] << 63) : 0);
  U256 p_minus_n;
  sub(p_minus_n, PRIME_P, ORDER_N);

  U256* s_hat = new U256[B];   // ŝ = s·R (s forced to 1 when out of range)
  U256* pref = new U256[B + 1];
  uint8_t* admitted = new uint8_t[B];
  U256 one_m = M.to_mont(U256{{1, 0, 0, 0}});

  for (int64_t i = 0; i < B; i++) {
    U256 r = load_be(r_b + 32 * i);
    U256 s = load_be(s_b + 32 * i);
    bool r_ok = !is_zero(r) && cmp(r, ORDER_N) < 0;
    bool s_ok = !is_zero(s) && cmp(s, half_n) <= 0;
    bool s_invertible = !is_zero(s) && cmp(s, ORDER_N) < 0;
    admitted[i] = r_ok && s_ok && q_ok[q_idx[i]];
    s_hat[i] = M.to_mont(s_invertible ? s : U256{{1, 0, 0, 0}});
  }

  pref[0] = one_m;
  for (int64_t i = 0; i < B; i++) pref[i + 1] = M.mul(pref[i], s_hat[i]);
  U256 inv_all = M.inv_mont(pref[B]);
  for (int64_t i = B - 1; i >= 0; i--) {
    U256 sinv_m = M.mul(pref[i], inv_all);  // (s_i)⁻¹·R
    inv_all = M.mul(inv_all, s_hat[i]);
    int16_t* row = frame + stride * i;
    if (!admitted[i]) {
      memset(row, 0, sizeof(int16_t) * kCols);
      continue;
    }
    U256 e = load_be(e_b + 32 * i);
    U256 r = load_be(r_b + 32 * i);
    const uint8_t* q = q_pool + 64 * int64_t(q_idx[i]);
    limbs16_of_be(q, row);
    limbs16_of_be(q + 32, row + kLimbs);
    limbs16_of_be(r_b + 32 * i, row + 2 * kLimbs);
    bool rpn_ok = cmp(r, p_minus_n) < 0;  // r + n < p
    if (rpn_ok) {
      U256 rpn;
      add(rpn, r, ORDER_N);
      limbs16_of(rpn, row + 3 * kLimbs);
    } else {
      memset(row + 3 * kLimbs, 0, sizeof(int16_t) * kLimbs);
    }
    // mont_mul(plain, x̂) = plain·x mod n — one step, no extra domain hop
    limbs16_of(M.mul(e, sinv_m), row + 4 * kLimbs);
    limbs16_of(M.mul(r, sinv_m), row + 5 * kLimbs);
    row[kRpnOk] = rpn_ok ? 1 : 0;
    row[kPreOk] = 1;
  }
  delete[] s_hat;
  delete[] pref;
  delete[] admitted;
}

}  // extern "C"
