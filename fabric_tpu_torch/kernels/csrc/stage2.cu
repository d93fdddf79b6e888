// Fused block stage 2: endorsement-policy reduction and MVCC validation.
//
// Replaces the JAX program fabric_tpu/peer/device_block.py::build_stage2
// (stage2, with _policy_reduce) and fabric_tpu/ops/mvcc.py::
// mvcc_validate_hostver; with its per-read compare prologue it also
// serves fabric_tpu/ops/mvcc.py::mvcc_validate.
//
// stage2_policy — ONE launch a block over every policy group.  The
//   block's group frames ([Eb, S*P + S + 1] int32 each: match | endo_idx
//   | tx_of) lie one after another in one buffer; a table of the CTAs
//   (each CTA's rows, shape and plan) and the groups' plans (the gate
//   tree as data: leaf principal columns, leaf ranks, gate thresholds
//   and child slots, so no kernel is built per policy) lie in a second,
//   built once per set of plans and shapes.  Each CTA of 128 threads
//   takes up to 32 consecutive entries of one group (the host's choice:
//   more CTAs, a few staged words a thread): it stages the plan and its
//   rows in shared memory with coalesced asynchronous copies, then
//   gathers every slot's signature bit at once (a thread per (entry,
//   slot)), then a thread an
//   entry turns each slot into a P-bit match mask ANDed with its
//   signature bit (in place of the slot's first word), counts leaf l's
//   matches as bit leaf_p[l] summed over the slots, compares with the
//   leaf ranks and walks the gates, in registers and shared memory only
//   (P <= 32: the masks are 32-bit, which the host's plan_vector
//   checks).  It writes its consumption-safety bit and one int32: its
//   transaction when its verdict is false, else -1; the fixpoint folds
//   those into the policy set.  The chain is three dependent global
//   round trips (the CTA's row; plan and rows; the signature bits)
//   whatever S is.  Bound: a few bytes per entry.  The first design
//   launched once per group after a fill of the policy vector, read the
//   plan from global memory in every thread, kept a data-indexed count
//   array in local memory, read a 68-byte row per lane (strided across
//   the warp), gathered a lane's S signature bits one after another and
//   folded verdicts with global atomicMin.
//
// mvcc_bitsets — one warp per (transaction j, 32-transaction word w):
//   the direct-conflict (read key == earlier write key) and phantom
//   (earlier write key inside a read range [lo, hi)) relations as
//   strictly lower-triangular [T, ceil(T/32)] uint32 bitsets, lane l
//   testing row i = 32w + l, the words formed by __ballot_sync.  Bound:
//   T^2 (R + Q) W compares of small ints, a few million at T = 1024.
//   The first design gave each thread a whole (j, w) word: 32 rows one
//   after another, each row's keys a separate, uncoalesced read.
//
// mvcc_fixpoint — ONE thread block: the policy set (all ones, the bit
//   of every transaction stage2_policy named cleared: a warp folds its
//   entries per word, then one shared-memory atomic a word), pre_ok = structural & creator & policy, then the validity fixpoint valid[j] = ver_ok[j] &
//   !any(conflict[j, i] & valid[i], i < j) by Jacobi iteration on a
//   shared-memory bitset until it stops changing (the reference's
//   while_loop, never returning to the host), then the conflict and
//   phantom flags against the final vector, written as the packed int8
//   output.  Bound: (chain depth + 1) rounds of T * ceil(T/32) / 2
//   word ANDs.  Where T * ceil(T/32) words fit the 227 KiB a block may
//   opt in to (T <= 1,348; 132 KiB at T = 1024), direct | phantom is
//   staged once in dynamic shared memory, rows padded to an odd stride;
//   above, the rounds read both matrices from global memory.  A round's
//   scan of a row is a straight OR over its words.  The first design
//   read every row from global memory in every round and left the scan
//   at the first hit, so a row's loads ran one after another, ~20
//   rounds of up to 32 dependent L2 round trips on one SM.
//
// mvcc_verok — the per-read committed-version compare of mvcc_validate.

#include <atomic>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kPolicyThreads = 128;
constexpr int kCtaCols = 8;  // a CTA's row of the policy table
constexpr int kMaxPlanWords = 256;  // a plan's words (<= 64 leaves + gates)
constexpr int kPolicyRowBytes = 32768;  // staged rows a CTA, under the 48 KiB default
constexpr int kFixThreads = 1024;
constexpr unsigned kFull = 0xFFFFFFFFu;
// the most dynamic shared memory a block may opt in to on sm_90 (227 KiB)
constexpr size_t kFixSmemBytes = 232448;

__device__ __forceinline__ bool sig_bit(const uint8_t* sv, int n_sig, int idx) {
  return idx >= 0 && idx < n_sig && sv[idx] != 0;
}

// plan: L | G | colmask | 0 | leaf_p[L] | leaf_rank[L] | gate_n[G] |
//       gate_off[G+1] | children[...]
// meta: a row of kCtaCols a CTA [frame offset of its first row, its
//       entries n, S, P, plan offset, plan words, its first entry, 0]
//       (two 16-byte loads) | the plans
__global__ void __launch_bounds__(kPolicyThreads)
stage2_policy_kernel(const uint8_t* __restrict__ sv, int n_sig,
                     const int32_t* __restrict__ frames, const int32_t* __restrict__ meta,
                     int T, int8_t* __restrict__ safe_out, int32_t* __restrict__ fail_tx) {
  extern __shared__ int32_t policy_rows[];
  __shared__ int32_t plan[kMaxPlanWords];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int4* cta = reinterpret_cast<const int4*>(meta) + (kCtaCols / 4) * blockIdx.x;
  const int4 c0 = __ldg(cta), c1 = __ldg(cta + 1);
  const int n = c0.y, S = c0.z, P = c0.w;
  const int rw = S * P + S + 1;
  // plan and rows by asynchronous copies (cp.async): every word of them
  // in flight at once, none through a register
  for (int i = tid; i < c1.y; i += nt) __pipeline_memcpy_async(plan + i, meta + c1.x + i, 4);
  const int32_t* src = frames + c0.x;
  for (int i = tid; i < n * rw; i += nt) __pipeline_memcpy_async(policy_rows + i, src + i, 4);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  // every slot's endorsement index becomes its signature bit: the CTA's
  // n * S gathers are independent, so they are in flight together
  const int top = n_sig - 1;
#pragma unroll 4
  for (int i = tid; i < n * S; i += nt) {
    int32_t* endo = policy_rows + (i / S) * rw + S * P + i % S;
    const int idx = *endo;
    // the load does not wait on the range test: a clamped index, read always
    const uint8_t v = top >= 0 ? __ldg(sv + min(max(idx, 0), top)) : 0;
    *endo = idx >= 0 && idx <= top && v != 0;
  }
  __syncthreads();
  if (tid >= n) return;

  // rw is odd (S is a power of two), so a warp's rows fall on distinct banks
  int32_t* row = policy_rows + tid * rw;
  const int L = plan[0], G = plan[1];
  const uint32_t colmask = (uint32_t)plan[2];
  const int32_t* leaf_p = plan + 4;
  const int32_t* leaf_rank = leaf_p + L;
  const int32_t* gate_n = leaf_rank + L;
  const int32_t* gate_off = gate_n + G;
  const int32_t* children = gate_off + G + 1;
  const int tx = row[S * P + S];
  bool safe = true;
  // slot s's mask replaces row[s]: every word a later slot reads (its
  // match words at s'P.., its signature bit at SP + s') lies past s
  for (int s = 0; s < S; ++s) {
    uint32_t m = 0u;
    if (row[S * P + s])
      for (int p = 0; p < P; ++p) m |= (uint32_t)(row[s * P + p] != 0) << p;
    safe &= __popc(m & colmask) <= 1;
    row[s] = (int32_t)m;
  }
  uint64_t vals = 0;
  for (int l = 0; l < L; ++l) {
    const int p = leaf_p[l];
    int c = 0;
    for (int s = 0; s < S; ++s) c += (row[s] >> p) & 1;
    if (leaf_rank[l] < c) vals |= 1ull << l;
  }
  for (int g = 0; g < G; ++g) {
    int acc = 0;
    for (int c = gate_off[g]; c < gate_off[g + 1]; ++c) acc += (int)((vals >> children[c]) & 1ull);
    if (acc >= gate_n[g]) vals |= 1ull << (L + g);
  }
  const bool ok = (vals >> (L + G - 1)) & 1ull;
  const int e = c1.z + tid;
  safe_out[e] = safe ? 1 : 0;
  fail_tx[e] = (!ok && tx >= 0 && tx < T) ? tx : -1;
}

// One warp per (transaction j, 32-transaction word w): lane l tests
// i = 32w + l, reading row i's W write keys (neighbouring lanes on
// neighbouring rows) against j's R read keys and Q ranges (the same
// address in every lane, one broadcast load); two warp ballots form the
// words and lane 0 stores them.  Rows i >= j give 0 bits: the relations
// are strictly lower-triangular.
// static_p row: read_keys[R] | write_keys[W] | rq_lo[Q] | rq_hi[Q]
__global__ void mvcc_bitsets_kernel(const int32_t* __restrict__ sp, int T, int R, int W, int Q,
                                    int nw, uint32_t* __restrict__ direct,
                                    uint32_t* __restrict__ phantom) {
  const long long word = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (word >= (long long)T * nw) return;  // whole warps
  const int j = (int)(word / nw), w = (int)(word % nw);
  const int i = 32 * w + (int)(threadIdx.x & 31);
  const int cols = R + W + 2 * Q;
  bool dh = false, phh = false;
  if (i < j) {
    const int32_t* rj = sp + (size_t)j * cols;
    const int32_t* wk = sp + (size_t)i * cols + R;
    for (int b = 0; b < W; ++b) {
      const int k = wk[b];
      if (k < 0) continue;
      for (int a = 0; a < R; ++a) dh |= (rj[a] >= 0) && (rj[a] == k);
      for (int q = 0; q < Q; ++q) {
        const int lo = rj[R + W + q], hi = rj[R + W + Q + q];
        phh |= (lo >= 0) && (k >= lo) && (k < hi);
      }
    }
  }
  const uint32_t d = __ballot_sync(kFull, dh), ph = __ballot_sync(kFull, phh);
  if ((threadIdx.x & 31) == 0) {
    direct[word] = d;
    phantom[word] = ph;
  }
}
__global__ void mvcc_verok_kernel(const int32_t* __restrict__ rk, const uint8_t* __restrict__ rp,
                                  const uint32_t* __restrict__ rv, const uint8_t* __restrict__ cp,
                                  const uint32_t* __restrict__ cv, int T, int R,
                                  uint8_t* __restrict__ ver_ok) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  bool ok = true;
  for (int a = 0; a < R; ++a) {
    const size_t k = (size_t)t * R + a;
    if (rk[k] < 0) continue;
    const bool p1 = rp[k] != 0, p2 = cp[k] != 0;
    const bool eq = rv[2 * k] == cv[2 * k] && rv[2 * k + 1] == cv[2 * k + 1];
    ok &= (p1 && p2) ? eq : (p1 == p2);
  }
  ver_ok[t] = ok ? 1 : 0;
}

__device__ __forceinline__ bool bit(const uint32_t* s, int t) {
  return (s[t >> 5] >> (t & 31)) & 1u;
}

// words of one conflict row in shared memory: odd, so the rows of a
// warp's 32 transactions fall on 32 different banks
__host__ __device__ inline int fix_row_words(int nw) { return nw | 1; }

// Stage-2 mode (launch_vec != null): launch_vec [T,3] = creator_idx |
// structural | ver_ok, creator sentinels -1 → false, -2 → true;
// fail_tx [n_fail]: the transaction of each policy entry whose verdict
// is false, else -1; writes valid | conflict | phantom | creator_ok |
// policy_ok | sig_valid.  The policy set lives in `nxt`, which the
// first Jacobi round writes before it reads.
// MVCC mode: ver_ok & pre_ok given; writes valid | conflict | phantom.
// ld > 0: direct | phantom staged in shared memory as [T][ld] words;
// ld == 0: the rounds read both matrices from global memory.  blockDim
// is a multiple of 32: warp k handles the transactions of words k,
// k + blockDim/32, ..., one per lane, and a ballot forms each word.
__global__ void __launch_bounds__(kFixThreads)
mvcc_fixpoint_kernel(int T, int nw, int ld, const uint32_t* __restrict__ direct,
                     const uint32_t* __restrict__ phantom, const uint8_t* __restrict__ ver_ok,
                     const uint8_t* __restrict__ pre_ok, const int32_t* __restrict__ launch_vec,
                     const uint8_t* __restrict__ sv, int n_sig,
                     const int32_t* __restrict__ fail_tx, int n_fail,
                     int8_t* __restrict__ out) {
  extern __shared__ uint32_t sm[];
  uint32_t* vok = sm;
  uint32_t* cur = sm + nw;
  uint32_t* nxt = sm + 2 * nw;
  uint32_t* conf = sm + 3 * nw;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  if (launch_vec != nullptr) {
    for (int w = tid; w < nw; w += nt) nxt[w] = kFull;
    __syncthreads();
    // a warp's failing entries are folded per word first (their
    // transactions mostly share one or two words), then one shared
    // atomic a word: an atomic an entry serialises on the word
    for (int base = tid - lane; base < n_fail; base += nt) {
      const int t = base + lane < n_fail ? fail_tx[base + lane] : -1;
      const bool hit = t >= 0 && t < T;
      const int w = hit ? t >> 5 : -1;
      for (unsigned todo = __ballot_sync(kFull, hit); todo;) {
        const int lw = __shfl_sync(kFull, w, __ffs(todo) - 1);
        const unsigned same = __ballot_sync(kFull, w == lw);
        const unsigned bits = __reduce_or_sync(kFull, w == lw ? 1u << (t & 31) : 0u);
        if (lane == __ffs(todo) - 1) atomicAnd(nxt + lw, ~bits);
        todo &= ~same;
      }
    }
    __syncthreads();
  }
  for (int base = tid - lane; base < T; base += nt) {
    const int t = base + lane;
    bool v = false;
    if (t < T) {
      if (launch_vec != nullptr) {
        const int ci = launch_vec[3 * t];
        const bool cok = ci >= 0 ? sig_bit(sv, n_sig, ci) : (ci == -2);
        const bool pok = bit(nxt, t);
        out[3 * T + t] = cok;
        out[4 * T + t] = pok;
        v = launch_vec[3 * t + 2] != 0 && launch_vec[3 * t + 1] != 0 && cok && pok;
      } else {
        v = ver_ok[t] != 0 && pre_ok[t] != 0;
      }
    }
    const uint32_t m = __ballot_sync(kFull, v);
    if (lane == 0) vok[base >> 5] = cur[base >> 5] = m;
  }
  if (launch_vec != nullptr)
    for (int i = tid; i < n_sig; i += nt) out[5 * T + i] = sv[i] != 0;
  if (ld > 0) {
    // a warp per row, its lanes over the row's words below the diagonal
    // (the rest are 0 and never read): coalesced loads, rows independent
    const int warp = tid >> 5, warps = nt >> 5;
#pragma unroll 4
    for (int t = warp; t < T; t += warps)
      for (int w = lane; w <= (t >> 5); w += 32)
        conf[(size_t)t * ld + w] = direct[(size_t)t * nw + w] | phantom[(size_t)t * nw + w];
  }
  __syncthreads();

  // Jacobi rounds: valid[t] = vok[t] & !any(conflict row t & cur), a
  // straight OR over the row's words; the system is strictly
  // lower-triangular, so it settles after (chain depth + 1) rounds
  for (int it = 0; it <= T + 1; ++it) {
    int moved = 0;
    for (int base = tid - lane; base < T; base += nt) {
      const int t = base + lane;
      bool ok = false;
      if (t < T && bit(vok, t)) {
        uint32_t hit = 0u;
        const int n = (t >> 5) + 1;
        if (ld > 0) {
          const uint32_t* row = conf + (size_t)t * ld;
          for (int w = 0; w < n; ++w) hit |= row[w] & cur[w];
        } else {
          const uint32_t* dr = direct + (size_t)t * nw;
          const uint32_t* pr = phantom + (size_t)t * nw;
          for (int w = 0; w < n; ++w) hit |= (dr[w] | pr[w]) & cur[w];
        }
        ok = hit == 0u;
      }
      const uint32_t m = __ballot_sync(kFull, ok);
      if (lane == 0) {
        nxt[base >> 5] = m;
        moved |= m != cur[base >> 5];
      }
    }
    const int again = __syncthreads_or(moved);
    uint32_t* s = cur;
    cur = nxt;
    nxt = s;
    if (!again) break;
  }
  // the flags: only a transaction that passed the version check and is
  // not valid at the fixpoint has a conflict among valid ones, so only
  // its rows are read again
  for (int t = tid; t < T; t += nt) {
    const bool v = bit(cur, t);
    uint32_t dh = 0u, ph = 0u;
    if (bit(vok, t) && !v) {
      const uint32_t* dr = direct + (size_t)t * nw;
      const uint32_t* pr = phantom + (size_t)t * nw;
      for (int w = 0; w <= (t >> 5); ++w) {
        dh |= dr[w] & cur[w];
        ph |= pr[w] & cur[w];
      }
    }
    out[t] = v;
    out[T + t] = dh != 0u;
    out[2 * T + t] = ph != 0u;
  }
}
}  // namespace

// every policy group of one block in one launch of n_cta CTAs, `smem`
// bytes of staged rows a CTA (the caller sizes both from the group table)
extern "C" int fab_stage2_policy(const uint8_t* sv, int n_sig, const int32_t* frames,
                                 const int32_t* meta, int n_cta, int smem, int T,
                                 int8_t* safe_out, int32_t* fail_tx, void* stream) {
  if (smem < 0 || smem > kPolicyRowBytes) return (int)cudaErrorInvalidValue;
  if (n_cta > 0) {
    stage2_policy_kernel<<<n_cta, kPolicyThreads, smem, (cudaStream_t)stream>>>(
        sv, n_sig, frames, meta, T, safe_out, fail_tx);
  }
  return (int)cudaGetLastError();
}

extern "C" int fab_mvcc_bitsets(const int32_t* sp, int T, int R, int W, int Q,
                                uint32_t* direct, uint32_t* phantom, void* stream) {
  const int nw = (T + 31) / 32;
  const long long n = 32LL * T * nw;  // a warp per word
  if (n > 0) {
    const int threads = 256;
    mvcc_bitsets_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                          (cudaStream_t)stream>>>(sp, T, R, W, Q, nw, direct, phantom);
  }
  return (int)cudaGetLastError();
}

extern "C" int fab_mvcc_verok(const int32_t* rk, const uint8_t* rp, const uint32_t* rv,
                              const uint8_t* cp, const uint32_t* cv, int T, int R,
                              uint8_t* ver_ok, void* stream) {
  if (T > 0) {
    const int threads = 256;
    mvcc_verok_kernel<<<(T + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        rk, rp, rv, cp, cv, T, R, ver_ok);
  }
  return (int)cudaGetLastError();
}

// whether the fixpoint of T transactions stages direct | phantom in
// shared memory: its 3 state words and T rows of fix_row_words fit
extern "C" int fab_mvcc_fixpoint_in_smem(int T) {
  const size_t nw = (size_t)(T + 31) / 32;
  return (3 * nw + (size_t)T * fix_row_words((int)nw)) * 4 <= kFixSmemBytes;
}

extern "C" int fab_mvcc_fixpoint(int T, const uint32_t* direct, const uint32_t* phantom,
                                 const uint8_t* ver_ok, const uint8_t* pre_ok,
                                 const int32_t* launch_vec, const uint8_t* sv, int n_sig,
                                 const int32_t* fail_tx, int n_fail, int8_t* out,
                                 void* stream) {
  const int nw = (T + 31) / 32;
  const bool in_smem = fab_mvcc_fixpoint_in_smem(T) != 0;
  const size_t smem = (3 * (size_t)nw + (in_smem ? (size_t)T * fix_row_words(nw) : 0)) * 4;
  if (smem > kFixSmemBytes) return (int)cudaErrorInvalidValue;
  if (T > 0) {
    if (smem > 48 * 1024) {
      // past 48 KiB a kernel must opt in, once per device
      static std::atomic<uint64_t> opted{0};
      int dev = 0;
      cudaGetDevice(&dev);
      const uint64_t m = 1ull << (dev & 63);
      if (!(opted.load() & m)) {
        const cudaError_t e = cudaFuncSetAttribute(
            mvcc_fixpoint_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kFixSmemBytes);
        if (e != cudaSuccess) return (int)e;
        opted.fetch_or(m);
      }
    }
    const int threads = T < kFixThreads ? ((T + 31) / 32) * 32 : kFixThreads;
    mvcc_fixpoint_kernel<<<1, threads, smem, (cudaStream_t)stream>>>(
        T, nw, in_smem ? fix_row_words(nw) : 0, direct, phantom, ver_ok, pre_ok, launch_vec, sv,
        n_sig, fail_tx, n_fail, out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* fab_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
