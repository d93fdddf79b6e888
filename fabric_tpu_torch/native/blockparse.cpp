// The block pre-parser of the commit path (counterpart:
// the JAX package's native/blockparse.cpp, adapted to the port).
//
// The validator needs, per envelope: header spans (creator, nonce,
// tx_id, channel, type), the creator-signature item (sha256(payload),
// r, s), every endorsement's item (sha256(prp || endorser), r, s) with
// its identity span, the tx_id binding digest sha256(nonce || creator),
// and the read/write-set span.  This walks the whole block's wire
// format in ONE call; the Fabric envelope encoding is the compatibility
// contract, so the field numbers below are stable by construction.
//
// Envelopes this walk does not carry (config transactions, malformed
// bytes, an odd endorsement) come back ok = 0 and the validator decodes
// them with the port's front end (peer/frontend.py), one by one.
//
// Differences from the counterpart:
//  * DER signatures follow the port's decoder (crypto/ec_ref.py::
//    der_decode_sig): definite lengths in their shortest form, up to 4
//    length bytes.  An INTEGER longer than 32 bytes is valid DER that
//    only a verify can reject, so its envelope takes the front end
//    (ok = 0) instead of reading as an undecodable signature.
//  * A capacity overflow returns -1 and the caller grows its arrays and
//    calls again; it never drops the block to Python.
//
// SHA-256 is implemented from FIPS 180-4, with the SHA-NI compress
// function where the CPU has it (run-time dispatch).

#include <cstdint>
#include <cstring>
#include <string_view>
#include <unordered_map>
#if defined(__x86_64__) || defined(__i386__)
#include <immintrin.h>
#define BP_HAVE_SHANI_COMPILE 1
#endif

namespace {

#ifdef BP_HAVE_SHANI_COMPILE
// SHA-NI compress function (Intel SHA extensions): ~10× the scalar
// path; the commit pre-parser hashes ~4.5 MB per 1000-tx block, so
// this is a double-digit-ms saving per block on a single core.
// Structure follows Intel's published reference sequence.
__attribute__((target("sha,sse4.1,ssse3")))
static void sha256_block_ni(uint32_t h[8], const uint8_t* p) {
  const __m128i MASK =
      _mm_set_epi64x(0x0c0d0e0f08090a0bULL, 0x0405060700010203ULL);
  __m128i TMP = _mm_loadu_si128(reinterpret_cast<const __m128i*>(&h[0]));
  __m128i STATE1 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(&h[4]));
  TMP = _mm_shuffle_epi32(TMP, 0xB1);        // CDAB
  STATE1 = _mm_shuffle_epi32(STATE1, 0x1B);  // EFGH
  __m128i STATE0 = _mm_alignr_epi8(TMP, STATE1, 8);  // ABEF
  STATE1 = _mm_blend_epi16(STATE1, TMP, 0xF0);       // CDGH
  const __m128i ABEF_SAVE = STATE0, CDGH_SAVE = STATE1;
  __m128i MSG, MSG0, MSG1, MSG2, MSG3;

  // rounds 0-3
  MSG0 = _mm_shuffle_epi8(
      _mm_loadu_si128(reinterpret_cast<const __m128i*>(p + 0)), MASK);
  MSG = _mm_add_epi32(
      MSG0, _mm_set_epi64x(0xE9B5DBA5B5C0FBCFULL, 0x71374491428A2F98ULL));
  STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
  MSG = _mm_shuffle_epi32(MSG, 0x0E);
  STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);

  // rounds 4-7
  MSG1 = _mm_shuffle_epi8(
      _mm_loadu_si128(reinterpret_cast<const __m128i*>(p + 16)), MASK);
  MSG = _mm_add_epi32(
      MSG1, _mm_set_epi64x(0xAB1C5ED5923F82A4ULL, 0x59F111F13956C25BULL));
  STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
  MSG = _mm_shuffle_epi32(MSG, 0x0E);
  STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
  MSG0 = _mm_sha256msg1_epu32(MSG0, MSG1);

  // rounds 8-11
  MSG2 = _mm_shuffle_epi8(
      _mm_loadu_si128(reinterpret_cast<const __m128i*>(p + 32)), MASK);
  MSG = _mm_add_epi32(
      MSG2, _mm_set_epi64x(0x550C7DC3243185BEULL, 0x12835B01D807AA98ULL));
  STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
  MSG = _mm_shuffle_epi32(MSG, 0x0E);
  STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
  MSG1 = _mm_sha256msg1_epu32(MSG1, MSG2);

  // rounds 12-15
  MSG3 = _mm_shuffle_epi8(
      _mm_loadu_si128(reinterpret_cast<const __m128i*>(p + 48)), MASK);
  MSG = _mm_add_epi32(
      MSG3, _mm_set_epi64x(0xC19BF1749BDC06A7ULL, 0x80DEB1FE72BE5D74ULL));
  STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
  TMP = _mm_alignr_epi8(MSG3, MSG2, 4);
  MSG0 = _mm_add_epi32(MSG0, TMP);
  MSG0 = _mm_sha256msg2_epu32(MSG0, MSG3);
  MSG = _mm_shuffle_epi32(MSG, 0x0E);
  STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
  MSG2 = _mm_sha256msg1_epu32(MSG2, MSG3);

  // rounds 16-19
  MSG = _mm_add_epi32(
      MSG0, _mm_set_epi64x(0x240CA1CC0FC19DC6ULL, 0xEFBE4786E49B69C1ULL));
  STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
  TMP = _mm_alignr_epi8(MSG0, MSG3, 4);
  MSG1 = _mm_add_epi32(MSG1, TMP);
  MSG1 = _mm_sha256msg2_epu32(MSG1, MSG0);
  MSG = _mm_shuffle_epi32(MSG, 0x0E);
  STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
  MSG3 = _mm_sha256msg1_epu32(MSG3, MSG0);

  // rounds 20-23
  MSG = _mm_add_epi32(
      MSG1, _mm_set_epi64x(0x76F988DA5CB0A9DCULL, 0x4A7484AA2DE92C6FULL));
  STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
  TMP = _mm_alignr_epi8(MSG1, MSG0, 4);
  MSG2 = _mm_add_epi32(MSG2, TMP);
  MSG2 = _mm_sha256msg2_epu32(MSG2, MSG1);
  MSG = _mm_shuffle_epi32(MSG, 0x0E);
  STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
  MSG0 = _mm_sha256msg1_epu32(MSG0, MSG1);

  // rounds 24-27
  MSG = _mm_add_epi32(
      MSG2, _mm_set_epi64x(0xBF597FC7B00327C8ULL, 0xA831C66D983E5152ULL));
  STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
  TMP = _mm_alignr_epi8(MSG2, MSG1, 4);
  MSG3 = _mm_add_epi32(MSG3, TMP);
  MSG3 = _mm_sha256msg2_epu32(MSG3, MSG2);
  MSG = _mm_shuffle_epi32(MSG, 0x0E);
  STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
  MSG1 = _mm_sha256msg1_epu32(MSG1, MSG2);

  // rounds 28-31
  MSG = _mm_add_epi32(
      MSG3, _mm_set_epi64x(0x1429296706CA6351ULL, 0xD5A79147C6E00BF3ULL));
  STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
  TMP = _mm_alignr_epi8(MSG3, MSG2, 4);
  MSG0 = _mm_add_epi32(MSG0, TMP);
  MSG0 = _mm_sha256msg2_epu32(MSG0, MSG3);
  MSG = _mm_shuffle_epi32(MSG, 0x0E);
  STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
  MSG2 = _mm_sha256msg1_epu32(MSG2, MSG3);

  // rounds 32-35
  MSG = _mm_add_epi32(
      MSG0, _mm_set_epi64x(0x53380D134D2C6DFCULL, 0x2E1B213827B70A85ULL));
  STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
  TMP = _mm_alignr_epi8(MSG0, MSG3, 4);
  MSG1 = _mm_add_epi32(MSG1, TMP);
  MSG1 = _mm_sha256msg2_epu32(MSG1, MSG0);
  MSG = _mm_shuffle_epi32(MSG, 0x0E);
  STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
  MSG3 = _mm_sha256msg1_epu32(MSG3, MSG0);

  // rounds 36-39
  MSG = _mm_add_epi32(
      MSG1, _mm_set_epi64x(0x92722C8581C2C92EULL, 0x766A0ABB650A7354ULL));
  STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
  TMP = _mm_alignr_epi8(MSG1, MSG0, 4);
  MSG2 = _mm_add_epi32(MSG2, TMP);
  MSG2 = _mm_sha256msg2_epu32(MSG2, MSG1);
  MSG = _mm_shuffle_epi32(MSG, 0x0E);
  STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
  MSG0 = _mm_sha256msg1_epu32(MSG0, MSG1);

  // rounds 40-43
  MSG = _mm_add_epi32(
      MSG2, _mm_set_epi64x(0xC76C51A3C24B8B70ULL, 0xA81A664BA2BFE8A1ULL));
  STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
  TMP = _mm_alignr_epi8(MSG2, MSG1, 4);
  MSG3 = _mm_add_epi32(MSG3, TMP);
  MSG3 = _mm_sha256msg2_epu32(MSG3, MSG2);
  MSG = _mm_shuffle_epi32(MSG, 0x0E);
  STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
  MSG1 = _mm_sha256msg1_epu32(MSG1, MSG2);

  // rounds 44-47
  MSG = _mm_add_epi32(
      MSG3, _mm_set_epi64x(0x106AA070F40E3585ULL, 0xD6990624D192E819ULL));
  STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
  TMP = _mm_alignr_epi8(MSG3, MSG2, 4);
  MSG0 = _mm_add_epi32(MSG0, TMP);
  MSG0 = _mm_sha256msg2_epu32(MSG0, MSG3);
  MSG = _mm_shuffle_epi32(MSG, 0x0E);
  STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
  MSG2 = _mm_sha256msg1_epu32(MSG2, MSG3);

  // rounds 48-51
  MSG = _mm_add_epi32(
      MSG0, _mm_set_epi64x(0x34B0BCB52748774CULL, 0x1E376C0819A4C116ULL));
  STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
  TMP = _mm_alignr_epi8(MSG0, MSG3, 4);
  MSG1 = _mm_add_epi32(MSG1, TMP);
  MSG1 = _mm_sha256msg2_epu32(MSG1, MSG0);
  MSG = _mm_shuffle_epi32(MSG, 0x0E);
  STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);
  MSG3 = _mm_sha256msg1_epu32(MSG3, MSG0);

  // rounds 52-55
  MSG = _mm_add_epi32(
      MSG1, _mm_set_epi64x(0x682E6FF35B9CCA4FULL, 0x4ED8AA4A391C0CB3ULL));
  STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
  TMP = _mm_alignr_epi8(MSG1, MSG0, 4);
  MSG2 = _mm_add_epi32(MSG2, TMP);
  MSG2 = _mm_sha256msg2_epu32(MSG2, MSG1);
  MSG = _mm_shuffle_epi32(MSG, 0x0E);
  STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);

  // rounds 56-59
  MSG = _mm_add_epi32(
      MSG2, _mm_set_epi64x(0x8CC7020884C87814ULL, 0x78A5636F748F82EEULL));
  STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
  TMP = _mm_alignr_epi8(MSG2, MSG1, 4);
  MSG3 = _mm_add_epi32(MSG3, TMP);
  MSG3 = _mm_sha256msg2_epu32(MSG3, MSG2);
  MSG = _mm_shuffle_epi32(MSG, 0x0E);
  STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);

  // rounds 60-63
  MSG = _mm_add_epi32(
      MSG3, _mm_set_epi64x(0xC67178F2BEF9A3F7ULL, 0xA4506CEB90BEFFFAULL));
  STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);
  MSG = _mm_shuffle_epi32(MSG, 0x0E);
  STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);

  STATE0 = _mm_add_epi32(STATE0, ABEF_SAVE);
  STATE1 = _mm_add_epi32(STATE1, CDGH_SAVE);

  TMP = _mm_shuffle_epi32(STATE0, 0x1B);      // FEBA
  STATE1 = _mm_shuffle_epi32(STATE1, 0xB1);   // DCHG
  STATE0 = _mm_blend_epi16(TMP, STATE1, 0xF0);       // DCBA
  STATE1 = _mm_alignr_epi8(STATE1, TMP, 8);          // HGFE
  _mm_storeu_si128(reinterpret_cast<__m128i*>(&h[0]), STATE0);
  _mm_storeu_si128(reinterpret_cast<__m128i*>(&h[4]), STATE1);
}

static bool shani_available() {
  static const bool ok = __builtin_cpu_supports("sha");
  return ok;
}
#endif  // BP_HAVE_SHANI_COMPILE

// ---------------------------------------------------------------- sha256
struct Sha256 {
  uint32_t h[8];
  uint8_t buf[64];
  uint64_t len = 0;
  unsigned fill = 0;
  bool ni = true;  // SHA-NI where the CPU has it; false: the scalar path

  static constexpr uint32_t K[64] = {
      0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
      0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
      0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
      0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
      0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
      0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
      0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
      0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
      0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
      0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
      0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

  Sha256() { reset(); }
  void reset() {
    static const uint32_t init[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372,
                                     0xa54ff53a, 0x510e527f, 0x9b05688c,
                                     0x1f83d9ab, 0x5be0cd19};
    memcpy(h, init, sizeof(h));
    len = 0;
    fill = 0;
  }
  static uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }
  void block(const uint8_t* p) {
#ifdef BP_HAVE_SHANI_COMPILE
    if (ni && shani_available()) { sha256_block_ni(h, p); return; }
#endif
    uint32_t w[64];
    for (int i = 0; i < 16; i++)
      w[i] = (uint32_t(p[4 * i]) << 24) | (uint32_t(p[4 * i + 1]) << 16) |
             (uint32_t(p[4 * i + 2]) << 8) | uint32_t(p[4 * i + 3]);
    for (int i = 16; i < 64; i++) {
      uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
      uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5],
             g = h[6], hh = h[7];
    for (int i = 0; i < 64; i++) {
      uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      uint32_t ch = (e & f) ^ (~e & g);
      uint32_t t1 = hh + S1 + ch + K[i] + w[i];
      uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      uint32_t t2 = S0 + maj;
      hh = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
  }
  void update(const uint8_t* p, size_t n) {
    len += n;
    if (fill) {
      while (n && fill < 64) { buf[fill++] = *p++; n--; }
      if (fill == 64) { block(buf); fill = 0; }
    }
    while (n >= 64) { block(p); p += 64; n -= 64; }
    while (n) { buf[fill++] = *p++; n--; }
  }
  void final(uint8_t out[32]) {
    uint64_t bits = len * 8;
    uint8_t pad = 0x80;
    update(&pad, 1);
    uint8_t z = 0;
    while (fill != 56) update(&z, 1);
    uint8_t lenb[8];
    for (int i = 0; i < 8; i++) lenb[i] = uint8_t(bits >> (56 - 8 * i));
    update(lenb, 8);
    for (int i = 0; i < 8; i++) {
      out[4 * i] = uint8_t(h[i] >> 24);
      out[4 * i + 1] = uint8_t(h[i] >> 16);
      out[4 * i + 2] = uint8_t(h[i] >> 8);
      out[4 * i + 3] = uint8_t(h[i]);
    }
  }
};
constexpr uint32_t Sha256::K[64];

static void sha2(const uint8_t* a, size_t an, const uint8_t* b, size_t bn,
                 uint8_t out[32]) {
  Sha256 s;
  s.update(a, an);
  if (b) s.update(b, bn);
  s.final(out);
}

// ------------------------------------------------------------- wire walk
struct Span {
  const uint8_t* p = nullptr;
  size_t n = 0;
  bool ok = false;
};

static bool varint(const uint8_t*& p, const uint8_t* end, uint64_t& out) {
  out = 0;
  int shift = 0;
  while (p < end && shift < 64) {
    uint8_t b = *p++;
    out |= uint64_t(b & 0x7f) << shift;
    if (!(b & 0x80)) return true;
    shift += 7;
  }
  return false;
}

// LAST occurrence of length-delimited field `field` — protobuf
// last-field-wins semantics, matching the front end's codec exactly (a
// duplicate-field envelope must not validate differently on the two
// parse paths).
//
// All length checks compare the attacker-controlled varint length
// against the REMAINING size (`len > uint64_t(end - p)`) — never
// `p + len > end`, whose pointer arithmetic is UB and wraps for huge
// lengths, letting a crafted envelope pass the check with an
// out-of-bounds span.
static Span field_bytes(const uint8_t* p, size_t n, uint32_t field) {
  const uint8_t* end = p + n;
  Span found{};
  while (p < end) {
    uint64_t key;
    if (!varint(p, end, key)) return {};
    uint32_t f = uint32_t(key >> 3), wt = uint32_t(key & 7);
    if (f == 0) return {};  // upb rejects field number 0
    if (wt == 2) {
      uint64_t len;
      if (!varint(p, end, len) || len > uint64_t(end - p)) return {};
      if (f == field) found = {p, size_t(len), true};
      p += len;
    } else if (wt == 0) {
      uint64_t v;
      if (!varint(p, end, v)) return {};
      (void)v;
    } else if (wt == 5) {
      if (uint64_t(end - p) < 4) return {};
      p += 4;
    } else if (wt == 1) {
      if (uint64_t(end - p) < 8) return {};
      p += 8;
    } else {
      return {};
    }
  }
  return found;
}

static bool field_varint(const uint8_t* p, size_t n, uint32_t field,
                         uint64_t& out) {
  const uint8_t* end = p + n;
  bool got = false;
  while (p < end) {
    uint64_t key;
    if (!varint(p, end, key)) return false;
    uint32_t f = uint32_t(key >> 3), wt = uint32_t(key & 7);
    if (f == 0) return false;  // upb rejects field number 0
    if (wt == 0) {
      uint64_t v;
      if (!varint(p, end, v)) return false;
      if (f == field) { out = v; got = true; }  // last wins
    } else if (wt == 2) {
      uint64_t len;
      if (!varint(p, end, len) || len > uint64_t(end - p)) return false;
      p += len;
    } else if (wt == 5) {
      if (uint64_t(end - p) < 4) return false;
      p += 4;
    } else if (wt == 1) {
      if (uint64_t(end - p) < 8) return false;
      p += 8;
    } else {
      return false;
    }
  }
  return got;
}

// DER ECDSA-Sig-Value -> r, s as 32-byte big-endian: 1 decoded, 0 not
// DER the port's decoder accepts, 2 valid DER with an INTEGER longer
// than 32 bytes (the caller sends the envelope to the front end)
static int der_sig(const uint8_t* p, size_t n, uint8_t r[32], uint8_t s[32]) {
  const uint8_t* end = p + n;
  // a TLV's definite length, in its shortest form (ec_ref._der_tlv)
  auto read_len = [&](const uint8_t*& q, size_t& len) -> bool {
    if (q >= end) return false;
    uint8_t b = *q++;
    if (b < 0x80) { len = b; return true; }
    int cnt = b & 0x7f;
    if (cnt < 1 || cnt > 4 || cnt > end - q || *q == 0) return false;
    len = 0;
    while (cnt--) len = (len << 8) | *q++;
    return len >= 0x80;
  };
  bool oversize = false;
  auto read_int = [&](const uint8_t*& q, uint8_t out[32]) -> bool {
    if (end - q < 2 || *q++ != 0x02) return false;
    size_t len;
    if (!read_len(q, len) || len == 0 || len > size_t(end - q)) return false;
    const uint8_t* v = q;
    q += len;
    if (v[0] & 0x80) return false;              // negative: invalid
    if (len > 1 && v[0] == 0 && !(v[1] & 0x80))
      return false;                             // non-minimal encoding
    size_t skip = (len > 1 && v[0] == 0) ? 1 : 0;
    memset(out, 0, 32);
    if (len - skip > 32) { oversize = true; return true; }
    memcpy(out + (32 - (len - skip)), v + skip, len - skip);
    return true;
  };
  if (n < 2 || *p != 0x30) return 0;
  const uint8_t* q = p + 1;
  size_t total;
  if (!read_len(q, total)) return 0;
  if (total != size_t(end - q)) return 0;       // exact outer length
  if (!read_int(q, r) || !read_int(q, s)) return 0;
  if (q != end) return 0;                       // no trailing elements
  return oversize ? 2 : 1;
}

static void put_span(int64_t* arr, int i, const uint8_t* base, Span s) {
  arr[2 * i] = s.ok ? (s.p - base) : -1;
  arr[2 * i + 1] = s.ok ? int64_t(s.n) : 0;
}

// upb (and the port's codec, protos/wire.py) rejects invalid UTF-8 in
// proto3 STRING fields; anything the front end would refuse must leave
// this walk, or the two entries would give one block different codes.
static bool valid_utf8(const uint8_t* p, size_t n) {
  size_t i = 0;
  while (i < n) {
    uint8_t c = p[i];
    if (c < 0x80) { i++; continue; }
    int extra;
    uint32_t cp, min;
    if ((c & 0xE0) == 0xC0) { extra = 1; cp = c & 0x1F; min = 0x80; }
    else if ((c & 0xF0) == 0xE0) { extra = 2; cp = c & 0x0F; min = 0x800; }
    else if ((c & 0xF8) == 0xF0) { extra = 3; cp = c & 0x07; min = 0x10000; }
    else return false;
    if (i + extra >= n) return false;
    for (int k = 1; k <= extra; k++) {
      uint8_t cc = p[i + k];
      if ((cc & 0xC0) != 0x80) return false;
      cp = (cp << 6) | (cc & 0x3F);
    }
    if (cp < min || cp > 0x10FFFF || (cp >= 0xD800 && cp <= 0xDFFF))
      return false;
    i += extra + 1;
  }
  return true;
}

// one-level wire-framing walk: true iff every field's framing parses
// (the acceptance bar upb applies to every submessage it decodes —
// unknown fields with VALID framing are fine, torn ones are not)
static bool frame_ok(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  while (p < end) {
    uint64_t key;
    if (!varint(p, end, key)) return false;
    if ((key >> 3) == 0) return false;  // upb rejects field number 0
    uint32_t wt = uint32_t(key & 7);
    if (wt == 2) {
      uint64_t len;
      if (!varint(p, end, len) || len > uint64_t(end - p)) return false;
      p += len;
    } else if (wt == 0) {
      uint64_t v;
      if (!varint(p, end, v)) return false;
    } else if (wt == 5) {
      if (uint64_t(end - p) < 4) return false;
      p += 4;
    } else if (wt == 1) {
      if (uint64_t(end - p) < 8) return false;
      p += 8;
    } else {
      return false;
    }
  }
  return true;
}

// occurrences of length-delimited field `field` — upb MERGES duplicate
// singular submessages (their repeated subfields concatenate), which
// last-occurrence extraction cannot replicate: any submessage the fast
// path descends into must appear exactly once or the envelope takes
// the front end
static int count_wt2(const uint8_t* p, size_t n, uint32_t field) {
  const uint8_t* end = p + n;
  int cnt = 0;
  while (p < end) {
    uint64_t key;
    if (!varint(p, end, key)) return -1;
    uint32_t f = uint32_t(key >> 3), wt = uint32_t(key & 7);
    if (f == 0) return -1;
    if (wt == 2) {
      uint64_t len;
      if (!varint(p, end, len) || len > uint64_t(end - p)) return -1;
      if (f == field) cnt++;
      p += len;
    } else if (wt == 0) {
      uint64_t v;
      if (!varint(p, end, v)) return -1;
    } else if (wt == 5) {
      if (uint64_t(end - p) < 4) return -1;
      p += 4;
    } else if (wt == 1) {
      if (uint64_t(end - p) < 8) return -1;
      p += 8;
    } else {
      return -1;
    }
  }
  return cnt;
}

// ChannelHeader strictness: upb validates the Timestamp submessage's
// framing (field 3) and the UTF-8 of channel_id(4) / tx_id(5)
static bool chdr_strict(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  while (p < end) {
    uint64_t key;
    if (!varint(p, end, key)) return false;
    uint32_t f = uint32_t(key >> 3), wt = uint32_t(key & 7);
    if (f == 0) return false;  // upb rejects field number 0
    if (wt == 2) {
      uint64_t len;
      if (!varint(p, end, len) || len > uint64_t(end - p)) return false;
      if (f == 3 && !frame_ok(p, size_t(len))) return false;
      if ((f == 4 || f == 5) && !valid_utf8(p, size_t(len))) return false;
      p += len;
    } else if (wt == 0) {
      uint64_t v;
      if (!varint(p, end, v)) return false;
    } else if (wt == 5) {
      if (uint64_t(end - p) < 4) return false;
      p += 4;
    } else if (wt == 1) {
      if (uint64_t(end - p) < 8) return false;
      p += 8;
    } else {
      return false;
    }
  }
  return true;
}

// ChaincodeAction strictness: Response(3) framing + message UTF-8,
// ChaincodeID(4) framing + path/name/version UTF-8 — all parsed by
// the front end's ChaincodeAction decode
static bool strings_strict(const uint8_t* p, size_t n, uint32_t lo,
                           uint32_t hi) {
  const uint8_t* end = p + n;
  while (p < end) {
    uint64_t key;
    if (!varint(p, end, key)) return false;
    uint32_t f = uint32_t(key >> 3), wt = uint32_t(key & 7);
    if (f == 0) return false;  // upb rejects field number 0
    if (wt == 2) {
      uint64_t len;
      if (!varint(p, end, len) || len > uint64_t(end - p)) return false;
      if (f >= lo && f <= hi && !valid_utf8(p, size_t(len))) return false;
      p += len;
    } else if (wt == 0) {
      uint64_t v;
      if (!varint(p, end, v)) return false;
    } else if (wt == 5) {
      if (uint64_t(end - p) < 4) return false;
      p += 4;
    } else if (wt == 1) {
      if (uint64_t(end - p) < 8) return false;
      p += 8;
    } else {
      return false;
    }
  }
  return true;
}

static bool cca_strict(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  while (p < end) {
    uint64_t key;
    if (!varint(p, end, key)) return false;
    uint32_t f = uint32_t(key >> 3), wt = uint32_t(key & 7);
    if (f == 0) return false;  // upb rejects field number 0
    if (wt == 2) {
      uint64_t len;
      if (!varint(p, end, len) || len > uint64_t(end - p)) return false;
      if (f == 3 && !strings_strict(p, size_t(len), 2, 2)) return false;
      if (f == 4 && !strings_strict(p, size_t(len), 1, 3)) return false;
      p += len;
    } else if (wt == 0) {
      uint64_t v;
      if (!varint(p, end, v)) return false;
    } else if (wt == 5) {
      if (uint64_t(end - p) < 4) return false;
      p += 4;
    } else if (wt == 1) {
      if (uint64_t(end - p) < 8) return false;
      p += 8;
    } else {
      return false;
    }
  }
  return true;
}

// Transaction strictness: the front end uses actions[0] (FIRST, not last) and
// upb validates the framing of EVERY action — return the first
// action's span iff all actions frame-parse
static Span first_action_strict(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  Span first{};
  while (p < end) {
    uint64_t key;
    if (!varint(p, end, key)) return {};
    uint32_t f = uint32_t(key >> 3), wt = uint32_t(key & 7);
    if (f == 0) return {};  // upb rejects field number 0
    if (wt == 2) {
      uint64_t len;
      if (!varint(p, end, len) || len > uint64_t(end - p)) return {};
      if (f == 1) {
        if (!frame_ok(p, size_t(len))) return {};
        if (!first.ok) first = {p, size_t(len), true};
      }
      p += len;
    } else if (wt == 0) {
      uint64_t v;
      if (!varint(p, end, v)) return {};
    } else if (wt == 5) {
      if (uint64_t(end - p) < 4) return {};
      p += 4;
    } else if (wt == 1) {
      if (uint64_t(end - p) < 8) return {};
      p += 8;
    } else {
      return {};
    }
  }
  return first;
}

}  // namespace

extern "C" {

// SHA-256 of arbitrary bytes through the walk's dispatch, or (scalar
// != 0) the scalar path alone: the tests hold both against hashlib at
// every padding boundary.
void bp_sha256(const uint8_t* p, int64_t n, int32_t scalar, uint8_t out[32]) {
  Sha256 s;
  s.ni = !scalar;
  s.update(p, size_t(n));
  s.final(out);
}

// Parse n envelopes (spans into blob).  Per-env outputs; endorsements
// flatten into the e_* arrays (capacity cap_endo).  Returns the total
// endorsement count, or -1 if a capacity was too small (the caller
// grows the arrays and calls again).
//
// ok[i]: 1 = standard endorser tx fully parsed; 0 = the validator
// decodes the envelope with the front end.
//
// Identity INTERNING: creators/endorsers are deduped block-wide into
// ident_span (uid → span); creator_uid / e_uid reference it and
// e_dup marks repeat endorsers WITHIN a tx — the validator then
// resolves each distinct identity exactly once (a block re-presents
// the same few certs thousands of times).
int64_t bp_parse_block(
    const uint8_t* blob, const int64_t* env_off, const int64_t* env_len,
    int64_t n, int64_t cap_endo, int64_t cap_ids,
    // per-envelope outputs
    uint8_t* ok, int64_t* ch_type,
    int64_t* txid_span, int64_t* channel_span, int64_t* creator_span,
    int64_t* nonce_span, int64_t* results_span, int64_t* events_span,
    uint8_t* payload_digest,       // [n,32] sha256(env.payload)
    uint8_t* txid_digest,          // [n,32] sha256(nonce ‖ creator)
    uint8_t* creator_sig_ok, uint8_t* creator_r, uint8_t* creator_s,
    int64_t* endo_start, int64_t* endo_count,
    // flat endorsement outputs
    int64_t* e_endorser_span, uint8_t* e_digest, uint8_t* e_r, uint8_t* e_s,
    uint8_t* e_ok,
    // identity interning outputs
    int32_t* creator_uid,          // [n]; -1 = none
    int32_t* e_uid, uint8_t* e_dup,  // [cap_endo]
    int64_t* ident_span,           // [cap_ids, 2]
    int64_t* n_ids_out) {
  int64_t ne = 0;
  std::unordered_map<std::string_view, int32_t> ids;
  int32_t next_id = 0;
  auto intern = [&](const uint8_t* p, size_t len) -> int32_t {
    std::string_view k(reinterpret_cast<const char*>(p), len);
    auto it = ids.find(k);
    if (it != ids.end()) return it->second;
    if (next_id >= cap_ids) return -2;  // capacity: the caller grows it
    ident_span[2 * next_id] = p - blob;
    ident_span[2 * next_id + 1] = int64_t(len);
    ids.emplace(k, next_id);
    return next_id++;
  };
  for (int64_t i = 0; i < n; i++) {
    ok[i] = 0;
    ch_type[i] = -1;
    endo_start[i] = ne;
    endo_count[i] = 0;
    creator_sig_ok[i] = 0;
    put_span(txid_span, i, blob, {});
    put_span(channel_span, i, blob, {});
    put_span(creator_span, i, blob, {});
    put_span(nonce_span, i, blob, {});
    put_span(results_span, i, blob, {});
    put_span(events_span, i, blob, {});
    const uint8_t* env = blob + env_off[i];
    size_t len = size_t(env_len[i]);
    if (!len) continue;

    Span payload = field_bytes(env, len, 1);
    Span sig = field_bytes(env, len, 2);
    if (!payload.ok) continue;
    Span header = field_bytes(payload.p, payload.n, 1);
    Span data = field_bytes(payload.p, payload.n, 2);
    if (!header.ok) continue;
    // Payload.header is a SUBMESSAGE: duplicates merge under upb
    if (count_wt2(payload.p, payload.n, 1) != 1) continue;
    Span chdr = field_bytes(header.p, header.n, 1);
    Span shdr = field_bytes(header.p, header.n, 2);
    if (!chdr.ok || !shdr.ok) continue;
    // upb parses the SignatureHeader as part of the structural
    // BAD_PAYLOAD gate — a torn one must take the front end, not
    // ride on with empty creator/nonce spans
    if (!frame_ok(shdr.p, shdr.n)) continue;
    uint64_t type = 0;
    field_varint(chdr.p, chdr.n, 1, type);
    ch_type[i] = int64_t(type);
    if (!chdr_strict(chdr.p, chdr.n)) continue;  // the front end decides
    Span channel = field_bytes(chdr.p, chdr.n, 4);
    Span txid = field_bytes(chdr.p, chdr.n, 5);
    Span creator = field_bytes(shdr.p, shdr.n, 1);
    Span nonce = field_bytes(shdr.p, shdr.n, 2);
    put_span(txid_span, i, blob, txid);
    put_span(channel_span, i, blob, channel);
    put_span(creator_span, i, blob, creator);
    put_span(nonce_span, i, blob, nonce);
    creator_uid[i] = -1;
    if (creator.ok) {
      int32_t uid = intern(creator.p, creator.n);
      if (uid == -2) return -1;
      creator_uid[i] = uid;
    }

    // creator signature item: digest of the raw payload bytes
    sha2(payload.p, payload.n, nullptr, 0, payload_digest + 32 * i);
    // absent fields are empty in proto3 — hash exactly what
    // protoutil.compute_tx_id(sh.nonce, sh.creator) hashes
    sha2(nonce.ok ? nonce.p : blob, nonce.ok ? nonce.n : 0,
         creator.ok ? creator.p : blob, creator.ok ? creator.n : 0,
         txid_digest + 32 * i);
    if (sig.ok) {
      int d = der_sig(sig.p, sig.n, creator_r + 32 * i, creator_s + 32 * i);
      if (d == 2) continue;  // the front end decides
      creator_sig_ok[i] = d == 1;
    }

    if (type != 3 /* ENDORSER_TRANSACTION */ || !data.ok) continue;
    // FIRST action (the front end's rule), with every action frame-checked
    Span action = first_action_strict(data.p, data.n);
    if (!action.ok) continue;
    Span cap = field_bytes(action.p, action.n, 2);  // TransactionAction.payload
    if (!cap.ok) continue;
    Span cea = field_bytes(cap.p, cap.n, 2);  // ChaincodeActionPayload.action
    if (!cea.ok) continue;
    // .action is a SUBMESSAGE: duplicate occurrences would merge
    // (endorsements concatenating across them) under upb
    if (count_wt2(cap.p, cap.n, 2) != 1) continue;
    Span prp = field_bytes(cea.p, cea.n, 1);
    if (!prp.ok) continue;
    Span cca = field_bytes(prp.p, prp.n, 2);  // prp.extension
    if (!cca.ok) continue;
    if (!cca_strict(cca.p, cca.n)) continue;  // Response/ChaincodeID
    Span results = field_bytes(cca.p, cca.n, 1);
    Span events = field_bytes(cca.p, cca.n, 2);
    put_span(results_span, i, blob, results);
    put_span(events_span, i, blob, events);

    // endorsements: iterate repeated field 2 of ChaincodeEndorsedAction
    const uint8_t* p = cea.p;
    const uint8_t* cend = cea.p + cea.n;
    bool endo_fail = false;
    while (p < cend) {
      uint64_t key;
      if (!varint(p, cend, key)) { endo_fail = true; break; }
      uint32_t f = uint32_t(key >> 3), wt = uint32_t(key & 7);
      if (f == 0) { endo_fail = true; break; }  // upb rejects field number 0
      if (wt != 2) {
        uint64_t v;
        if (wt == 0) { if (!varint(p, cend, v)) { endo_fail = true; break; } continue; }
        if (wt == 5) { if (uint64_t(cend - p) < 4) { endo_fail = true; break; } p += 4; continue; }
        if (wt == 1) { if (uint64_t(cend - p) < 8) { endo_fail = true; break; } p += 8; continue; }
        endo_fail = true;  // malformed framing: upb rejects the WHOLE
        break;             // ChaincodeActionPayload — the front end decides
      }
      uint64_t flen;
      if (!varint(p, cend, flen) || flen > uint64_t(cend - p)) {
        endo_fail = true;
        break;
      }
      const uint8_t* fp = p;
      p += flen;
      if (f != 2) continue;
      if (ne >= cap_endo) return -1;
      Span endorser = field_bytes(fp, flen, 1);
      Span esig = field_bytes(fp, flen, 2);
      put_span(e_endorser_span, ne, blob, endorser);
      e_uid[ne] = -1;
      e_dup[ne] = 0;
      if (endorser.ok) {
        int32_t uid = intern(endorser.p, endorser.n);
        if (uid == -2) return -1;
        e_uid[ne] = uid;
        for (int64_t k = endo_start[i]; k < ne; k++)
          if (e_uid[k] == uid) { e_dup[ne] = 1; break; }
      }
      e_ok[ne] = 0;
      if (endorser.ok && esig.ok &&
          der_sig(esig.p, esig.n, e_r + 32 * ne, e_s + 32 * ne) == 1) {
        // message = prp_bytes ‖ endorser_bytes
        sha2(prp.p, prp.n, endorser.p, endorser.n, e_digest + 32 * ne);
        e_ok[ne] = 1;
      } else {
        endo_fail = true;
      }
      ne++;
      endo_count[i]++;
    }
    if (endo_fail) continue;  // the front end sorts out the odd endorsement
    ok[i] = 1;
  }
  *n_ids_out = next_id;
  return ne;
}

}  // extern "C"
