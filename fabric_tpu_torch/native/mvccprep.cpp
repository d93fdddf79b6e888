// Read/write-set parse and key interning of the commit path
// (counterpart: the JAX package's native/mvccprep.cpp, adapted to the
// port).
//
// One call a block walks the raw wire form of every used transaction's
// TxReadWriteSet (the rwset encoding is the compatibility contract),
// interns namespaces and (namespace, key) pairs into dense ids, keeps the
// last read or write of a repeated key (the dict semantics of the port's
// ledger/rwset.py::TxRWSet.from_bytes) and emits flat arrays, from which
// ops/mvcc.py::prepare_block_from_flat and the validator's update batch
// scatter with numpy.
//
// It covers public reads and writes (KVRWSet fields 1 and 3).  A range
// query, a metadata write, a hashed collection, non-UTF-8 text, bytes
// that do not parse or a full array mark the transaction status 1: the
// validator parses its set with TxRWSet.from_bytes.  Key-id order here is
// the interning order; the callers renumber keys in lexicographic order.
//
// Difference from the counterpart: a KVRead with its version given more
// than once also takes status 1.  The wire codec merges repeated
// occurrences of a singular sub-message, which a last-occurrence read of
// the version cannot reproduce.

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>

namespace {

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

// Walk one message's fields; calls visit(field, wire_type, span_or_value).
// Returns false on malformed wire data.
template <typename F>
static bool walk(const uint8_t* p, size_t n, F&& visit) {
  const uint8_t* end = p + n;
  while (p < end) {
    uint64_t key;
    if (!varint(p, end, key)) return false;
    uint32_t f = uint32_t(key >> 3), wt = uint32_t(key & 7);
    if (f == 0) return false;  // upb rejects field number 0
    if (wt == 2) {
      uint64_t len;
      if (!varint(p, end, len) || len > uint64_t(end - p)) return false;
      if (!visit(f, 2, Span{p, size_t(len), true}, 0)) return false;
      p += len;
    } else if (wt == 0) {
      uint64_t v;
      if (!varint(p, end, v)) return false;
      if (!visit(f, 0, Span{}, v)) return false;
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

// Strict UTF-8 check (no overlongs, no surrogates, max U+10FFFF): the
// port's codec rejects invalid UTF-8 in string fields (BAD_RWSET), so
// such a transaction takes status 1.
static bool utf8_valid(const uint8_t* p, size_t n) {
  size_t i = 0;
  while (i < n) {
    uint8_t c = p[i];
    if (c < 0x80) { i++; continue; }
    int extra;
    uint32_t cp;
    if ((c & 0xe0) == 0xc0) { extra = 1; cp = c & 0x1f; }
    else if ((c & 0xf0) == 0xe0) { extra = 2; cp = c & 0x0f; }
    else if ((c & 0xf8) == 0xf0) { extra = 3; cp = c & 0x07; }
    else return false;
    if (i + size_t(extra) >= n) return false;
    for (int k = 1; k <= extra; k++) {
      if ((p[i + k] & 0xc0) != 0x80) return false;
      cp = (cp << 6) | (p[i + k] & 0x3f);
    }
    if (extra == 1 && cp < 0x80) return false;
    if (extra == 2 && cp < 0x800) return false;
    if (extra == 3 && cp < 0x10000) return false;
    if (cp > 0x10ffff || (cp >= 0xd800 && cp <= 0xdfff)) return false;
    i += extra + 1;
  }
  return true;
}

struct Interner {
  std::unordered_map<std::string, int32_t> map;
  int32_t next = 0;
  // Returns the id, or -1 when interning a FRESH entry would exceed
  // cap — the map is left untouched so out_counts never exceeds the
  // caller-allocated table sizes (the tx takes status 1).
  int32_t get(int32_t ns_id, const uint8_t* key, size_t klen,
              bool& fresh, int64_t cap) {
    std::string k;
    k.reserve(4 + klen);
    k.append(reinterpret_cast<const char*>(&ns_id), 4);
    k.append(reinterpret_cast<const char*>(key), klen);
    auto it = map.find(k);
    if (it != map.end()) { fresh = false; return it->second; }
    if (next >= cap) { fresh = false; return -1; }
    fresh = true;
    map.emplace(std::move(k), next);
    return next++;
  }
};

}  // namespace

extern "C" {

// See file comment.  Outputs are caller-allocated; out_counts returns
// [n_ns, n_ukeys, n_reads, n_writes].  Always returns 0: a tx whose
// data exceeds a cap takes status 1, never lost.
int64_t mvcc_prep(
    const uint8_t* blob, const int64_t* results_span, const uint8_t* use,
    int64_t n, int64_t cap_entries, int64_t cap_ns, int64_t cap_keys,
    uint8_t* status,                       // [n] 0 flat / 1 parse / 2 unused
    int64_t* tx_ns_start, int64_t* tx_ns_count,
    int32_t* ns_ids_flat,                  // [cap_entries]
    int64_t* r_start, int64_t* r_count,
    int64_t* w_start, int64_t* w_count,
    int32_t* r_uid, uint8_t* r_has_ver, uint64_t* r_ver,   // [cap],[cap],[cap,2]
    int32_t* w_uid, uint8_t* w_is_del,
    int64_t* w_key_span, int64_t* w_val_span,              // [cap,2] each
    int32_t* ns_of_ukey,                   // [cap_keys]
    int64_t* ns_span,                      // [cap_ns,2]
    int64_t* ukey_span,                    // [cap_keys,2]
    int64_t* out_counts) {
  Interner ns_intern, key_intern;
  int64_t nr = 0, nw = 0, nns_flat = 0;

  for (int64_t i = 0; i < n; i++) {
    status[i] = 2;
    tx_ns_start[i] = nns_flat; tx_ns_count[i] = 0;
    r_start[i] = nr; r_count[i] = 0;
    w_start[i] = nw; w_count[i] = 0;
    if (!use[i]) continue;
    int64_t off = results_span[2 * i], len = results_span[2 * i + 1];
    if (off < 0) continue;
    const uint8_t* rw = blob + off;

    bool bad = false;
    int64_t tx_r0 = nr, tx_w0 = nw, tx_ns0 = nns_flat;

    // TxReadWriteSet: field 2 = repeated NsReadWriteSet
    bool ok = walk(rw, size_t(len), [&](uint32_t f, int wt, Span s,
                                        uint64_t) -> bool {
      if (f != 2 || wt != 2) return true;  // data_model etc: skip
      int32_t ns_id = -1;
      Span ns_name{}, kvset{};
      bool ok2 = walk(s.p, s.n, [&](uint32_t f2, int wt2, Span s2,
                                    uint64_t) -> bool {
        if (f2 == 1 && wt2 == 2) ns_name = s2;
        else if (f2 == 2 && wt2 == 2) kvset = s2;
        else if (f2 == 3) bad = true;  // hashed collections → status 1
        return true;
      });
      if (!ok2 || bad || !ns_name.ok ||
          !utf8_valid(ns_name.p, ns_name.n)) { bad = true; return true; }
      bool fresh;
      ns_id = ns_intern.get(0, ns_name.p, ns_name.n, fresh, cap_ns);
      if (ns_id < 0) { bad = true; return true; }
      if (fresh) {
        ns_span[2 * ns_id] = ns_name.p - blob;
        ns_span[2 * ns_id + 1] = int64_t(ns_name.n);
      }
      // per-tx ns dedup (same ns may repeat; from_bytes merges)
      bool seen_ns = false;
      for (int64_t k = tx_ns0; k < nns_flat; k++)
        if (ns_ids_flat[k] == ns_id) { seen_ns = true; break; }
      if (!seen_ns) {
        if (nns_flat >= cap_entries) { bad = true; return true; }
        ns_ids_flat[nns_flat++] = ns_id;
      }
      if (!kvset.ok) return true;  // empty KVRWSet

      // KVRWSet: 1 reads, 2 range, 3 writes, 4 metadata
      bool ok3 = walk(kvset.p, kvset.n, [&](uint32_t f3, int wt3, Span s3,
                                            uint64_t) -> bool {
        // range queries (2) and metadata writes (4) → status 1
        if (f3 == 2 || f3 == 4) { bad = true; return true; }
        if (wt3 != 2) return true;
        if (f3 == 1) {  // KVRead{1 key, 2 Version{1 block, 2 tx}}
          Span key{}, ver{};
          bool has_ver = false;
          int n_ver = 0;
          if (!walk(s3.p, s3.n, [&](uint32_t f4, int wt4, Span s4,
                                    uint64_t) -> bool {
                if (f4 == 1 && wt4 == 2) key = s4;
                if (f4 == 2 && wt4 == 2) { ver = s4; has_ver = true; n_ver++; }
                return true;
              })) { bad = true; return true; }
          if (n_ver > 1) { bad = true; return true; }  // merged versions
          uint64_t vb = 0, vt = 0;
          if (has_ver &&
              !walk(ver.p, ver.n, [&](uint32_t f5, int wt5, Span,
                                      uint64_t v) -> bool {
                if (wt5 == 0 && f5 == 1) vb = v;
                if (wt5 == 0 && f5 == 2) vt = v;
                return true;
              })) { bad = true; return true; }
          if (key.ok && !utf8_valid(key.p, key.n)) { bad = true; return true; }
          bool fresh2;
          int32_t uid = key_intern.get(ns_id, key.ok ? key.p : blob,
                                       key.ok ? key.n : 0, fresh2, cap_keys);
          if (uid < 0) { bad = true; return true; }
          if (fresh2) {
            ns_of_ukey[uid] = ns_id;
            ukey_span[2 * uid] = key.ok ? (key.p - blob) : 0;
            ukey_span[2 * uid + 1] = key.ok ? int64_t(key.n) : 0;
          }
          // dict semantics: repeated read of a key — last wins
          for (int64_t k = tx_r0; k < nr; k++)
            if (r_uid[k] == uid) {
              r_has_ver[k] = has_ver ? 1 : 0;
              r_ver[2 * k] = vb; r_ver[2 * k + 1] = vt;
              return true;
            }
          if (nr >= cap_entries) { bad = true; return true; }
          r_uid[nr] = uid;
          r_has_ver[nr] = has_ver ? 1 : 0;
          r_ver[2 * nr] = vb; r_ver[2 * nr + 1] = vt;
          nr++;
        } else if (f3 == 3) {  // KVWrite{1 key, 2 is_delete, 3 value}
          Span key{}, val{};
          uint64_t is_del = 0;
          if (!walk(s3.p, s3.n, [&](uint32_t f4, int wt4, Span s4,
                                    uint64_t v) -> bool {
                if (f4 == 1 && wt4 == 2) key = s4;
                if (f4 == 2 && wt4 == 0) is_del = v;
                if (f4 == 3 && wt4 == 2) val = s4;
                return true;
              })) { bad = true; return true; }
          if (key.ok && !utf8_valid(key.p, key.n)) { bad = true; return true; }
          bool fresh2;
          int32_t uid = key_intern.get(ns_id, key.ok ? key.p : blob,
                                       key.ok ? key.n : 0, fresh2, cap_keys);
          if (uid < 0) { bad = true; return true; }
          if (fresh2) {
            ns_of_ukey[uid] = ns_id;
            ukey_span[2 * uid] = key.ok ? (key.p - blob) : 0;
            ukey_span[2 * uid + 1] = key.ok ? int64_t(key.n) : 0;
          }
          for (int64_t k = tx_w0; k < nw; k++)
            if (w_uid[k] == uid) {  // last write wins
              w_is_del[k] = is_del ? 1 : 0;
              w_val_span[2 * k] = val.ok ? (val.p - blob) : -1;
              w_val_span[2 * k + 1] = val.ok ? int64_t(val.n) : 0;
              return true;
            }
          if (nw >= cap_entries) { bad = true; return true; }
          w_uid[nw] = uid;
          w_is_del[nw] = is_del ? 1 : 0;
          w_key_span[2 * nw] = key.ok ? (key.p - blob) : 0;
          w_key_span[2 * nw + 1] = key.ok ? int64_t(key.n) : 0;
          w_val_span[2 * nw] = val.ok ? (val.p - blob) : -1;
          w_val_span[2 * nw + 1] = val.ok ? int64_t(val.n) : 0;
          nw++;
        }
        return true;
      });
      if (!ok3) bad = true;
      return true;
    });

    if (!ok || bad) {
      // rewind this tx's contributions; the validator parses its set
      nr = tx_r0; nw = tx_w0; nns_flat = tx_ns0;
      status[i] = 1;
      tx_ns_count[i] = 0; r_count[i] = 0; w_count[i] = 0;
      continue;
    }
    status[i] = 0;
    tx_ns_count[i] = nns_flat - tx_ns0;
    r_count[i] = nr - tx_r0;
    w_count[i] = nw - tx_w0;
  }
  out_counts[0] = ns_intern.next;
  out_counts[1] = key_intern.next;
  out_counts[2] = nr;
  out_counts[3] = nw;
  return 0;
}

}  // extern "C"
