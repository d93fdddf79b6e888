// Fused block stage 2: endorsement-policy reduction and MVCC validation.
//
// Replaces the JAX program fabric_tpu/peer/device_block.py::build_stage2
// (stage2, with _policy_reduce) and fabric_tpu/ops/mvcc.py::
// mvcc_validate_hostver; with its per-read compare prologue it also
// serves fabric_tpu/ops/mvcc.py::mvcc_validate.
//
// stage2_policy — one thread per endorsement entry of one policy group.
//   The policy's gate tree arrives as data (leaf principal columns,
//   leaf ranks, gate thresholds and child slots), so no kernel is built
//   per policy.  Each thread gathers its S signature bits, counts
//   principal matches, compares them with the leaf ranks, walks the
//   gates, writes the consumption-safety bit and folds its verdict into
//   the transaction's int32 policy slot with atomicMin (there are no
//   int8 atomics).  Bound: a few bytes per entry; launch latency.
//
// mvcc_bitsets — one thread per (transaction j, 32-transaction word w):
//   the direct-conflict (read key == earlier write key) and phantom
//   (earlier write key inside a read range [lo, hi)) relations as
//   strictly lower-triangular [T, ceil(T/32)] uint32 bitsets.  Bound:
//   T^2 (R + Q) W compares of small ints, a few million at T = 1024.
//
// mvcc_fixpoint — ONE thread block: pre_ok = structural & creator &
//   policy, then the validity fixpoint valid[j] = ver_ok[j] &
//   !any(conflict[j, i] & valid[i], i < j) by Jacobi iteration on a
//   shared-memory bitset until it stops changing (the reference's
//   while_loop, never returning to the host), then the conflict and
//   phantom flags against the final vector, written as the packed int8
//   output.  Grid-stride over transactions handles T > blockDim.  Bound:
//   (chain depth + 1) rounds of T * ceil(T/32) word ANDs from L1/L2.
//
// mvcc_verok — the per-read committed-version compare of mvcc_validate.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxP = 32;      // principal columns per policy
constexpr int kMaxSlots = 64;  // leaves + gates per policy
constexpr int kFixThreads = 1024;

__device__ __forceinline__ bool sig_bit(const uint8_t* sv, int n_sig, int idx) {
  return idx >= 0 && idx < n_sig && sv[idx] != 0;
}

// plan: L | G | colmask | 0 | leaf_p[L] | leaf_rank[L] | gate_n[G] |
//       gate_off[G+1] | children[...]
__global__ void stage2_policy_kernel(const uint8_t* __restrict__ sv, int n_sig,
                                     const int32_t* __restrict__ gp, int Eb, int S, int P,
                                     const int32_t* __restrict__ plan,
                                     int32_t* __restrict__ policy_ok, int T,
                                     int8_t* __restrict__ safe_out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= Eb) return;
  const int L = plan[0], G = plan[1];
  const uint32_t colmask = (uint32_t)plan[2];
  const int32_t* leaf_p = plan + 4;
  const int32_t* leaf_rank = leaf_p + L;
  const int32_t* gate_n = leaf_rank + L;
  const int32_t* gate_off = gate_n + G;
  const int32_t* children = gate_off + G + 1;

  const int32_t* row = gp + (size_t)e * (S * P + S + 1);
  const int32_t* endo = row + S * P;
  const int tx = row[S * P + S];
  int counts[kMaxP];
  for (int p = 0; p < P; ++p) counts[p] = 0;
  bool safe = true;
  for (int s = 0; s < S; ++s) {
    if (!sig_bit(sv, n_sig, endo[s])) continue;
    int leaf_cols = 0;
    for (int p = 0; p < P; ++p) {
      if (row[s * P + p] != 0) {
        ++counts[p];
        leaf_cols += (colmask >> p) & 1u;
      }
    }
    if (leaf_cols > 1) safe = false;
  }
  uint64_t vals = 0;
  for (int l = 0; l < L; ++l)
    if (leaf_rank[l] < counts[leaf_p[l]]) vals |= 1ull << l;
  for (int g = 0; g < G; ++g) {
    int acc = 0;
    for (int c = gate_off[g]; c < gate_off[g + 1]; ++c) acc += (int)((vals >> children[c]) & 1ull);
    if (acc >= gate_n[g]) vals |= 1ull << (L + g);
  }
  const int ok = (int)((vals >> (L + G - 1)) & 1ull);
  safe_out[e] = safe ? 1 : 0;
  if (tx >= 0 && tx < T) atomicMin(policy_ok + tx, ok);
}

// static_p row: read_keys[R] | write_keys[W] | rq_lo[Q] | rq_hi[Q]
__global__ void mvcc_bitsets_kernel(const int32_t* __restrict__ sp, int T, int R, int W, int Q,
                                    int nw, uint32_t* __restrict__ direct,
                                    uint32_t* __restrict__ phantom) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)T * nw) return;
  const int j = (int)(idx / nw), w = (int)(idx % nw);
  const int cols = R + W + 2 * Q;
  const int32_t* rj = sp + (size_t)j * cols;
  uint32_t d = 0u, ph = 0u;
  const int i0 = 32 * w;
  const int i1 = min(i0 + 32, j);
  for (int i = i0; i < i1; ++i) {
    const int32_t* wk = sp + (size_t)i * cols + R;
    bool dh = false, phh = false;
    for (int b = 0; b < W; ++b) {
      const int k = wk[b];
      if (k < 0) continue;
      for (int a = 0; a < R; ++a) dh |= (rj[a] >= 0) && (rj[a] == k);
      for (int q = 0; q < Q; ++q) {
        const int lo = rj[R + W + q], hi = rj[R + W + Q + q];
        phh |= (lo >= 0) && (k >= lo) && (k < hi);
      }
    }
    d |= (uint32_t)dh << (i - i0);
    ph |= (uint32_t)phh << (i - i0);
  }
  direct[idx] = d;
  phantom[idx] = ph;
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

// Stage-2 mode (launch_vec != null): launch_vec [T,3] = creator_idx |
// structural | ver_ok, creator sentinels -1 → false, -2 → true; writes
// valid | conflict | phantom | creator_ok | policy_ok | sig_valid.
// MVCC mode: ver_ok & pre_ok given; writes valid | conflict | phantom.
__global__ void __launch_bounds__(kFixThreads)
mvcc_fixpoint_kernel(int T, int nw, const uint32_t* __restrict__ direct,
                     const uint32_t* __restrict__ phantom, const uint8_t* __restrict__ ver_ok,
                     const uint8_t* __restrict__ pre_ok, const int32_t* __restrict__ launch_vec,
                     const uint8_t* __restrict__ sv, int n_sig,
                     const int32_t* __restrict__ policy_ok, int8_t* __restrict__ out) {
  extern __shared__ uint32_t sm[];
  uint32_t* vok = sm;
  uint32_t* cur = sm + nw;
  uint32_t* nxt = sm + 2 * nw;
  __shared__ int changed;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int w = tid; w < nw; w += nt) vok[w] = 0u;
  __syncthreads();
  for (int t = tid; t < T; t += nt) {
    bool v;
    if (launch_vec != nullptr) {
      const int ci = launch_vec[3 * t];
      const bool cok = ci >= 0 ? sig_bit(sv, n_sig, ci) : (ci == -2);
      const bool pok = policy_ok[t] != 0;
      out[3 * T + t] = cok;
      out[4 * T + t] = pok;
      v = launch_vec[3 * t + 2] != 0 && launch_vec[3 * t + 1] != 0 && cok && pok;
    } else {
      v = ver_ok[t] != 0 && pre_ok[t] != 0;
    }
    if (v) atomicOr(vok + (t >> 5), 1u << (t & 31));
  }
  if (launch_vec != nullptr)
    for (int i = tid; i < n_sig; i += nt) out[5 * T + i] = sv[i] != 0;
  __syncthreads();
  for (int w = tid; w < nw; w += nt) cur[w] = vok[w];
  __syncthreads();
  for (int it = 0; it <= T + 1; ++it) {
    for (int w = tid; w < nw; w += nt) nxt[w] = 0u;
    if (tid == 0) changed = 0;
    __syncthreads();
    for (int t = tid; t < T; t += nt) {
      if (!bit(vok, t)) continue;
      const uint32_t* dr = direct + (size_t)t * nw;
      const uint32_t* pr = phantom + (size_t)t * nw;
      bool hit = false;
      for (int w = 0; w <= (t >> 5) && !hit; ++w) hit = ((dr[w] | pr[w]) & cur[w]) != 0u;
      if (!hit) atomicOr(nxt + (t >> 5), 1u << (t & 31));
    }
    __syncthreads();
    for (int w = tid; w < nw; w += nt)
      if (nxt[w] != cur[w]) changed = 1;
    __syncthreads();
    const bool again = changed != 0;
    for (int w = tid; w < nw; w += nt) cur[w] = nxt[w];
    __syncthreads();
    if (!again) break;
  }
  for (int t = tid; t < T; t += nt) {
    const bool vo = bit(vok, t);
    const uint32_t* dr = direct + (size_t)t * nw;
    const uint32_t* pr = phantom + (size_t)t * nw;
    bool dh = false, ph = false;
    for (int w = 0; w <= (t >> 5); ++w) {
      dh |= (dr[w] & cur[w]) != 0u;
      ph |= (pr[w] & cur[w]) != 0u;
    }
    out[t] = bit(cur, t);
    out[T + t] = dh && vo;
    out[2 * T + t] = ph && vo;
  }
}

}  // namespace

extern "C" int fab_stage2_policy(const uint8_t* sv, int n_sig, const int32_t* gp, int Eb,
                                 int S, int P, const int32_t* plan, int32_t* policy_ok, int T,
                                 int8_t* safe_out, void* stream) {
  if (P > kMaxP) return (int)cudaErrorInvalidValue;
  if (Eb > 0) {
    const int threads = 128;
    stage2_policy_kernel<<<(Eb + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        sv, n_sig, gp, Eb, S, P, plan, policy_ok, T, safe_out);
  }
  return (int)cudaGetLastError();
}

extern "C" int fab_mvcc_bitsets(const int32_t* sp, int T, int R, int W, int Q,
                                uint32_t* direct, uint32_t* phantom, void* stream) {
  const int nw = (T + 31) / 32;
  const long long n = (long long)T * nw;
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

extern "C" int fab_mvcc_fixpoint(int T, const uint32_t* direct, const uint32_t* phantom,
                                 const uint8_t* ver_ok, const uint8_t* pre_ok,
                                 const int32_t* launch_vec, const uint8_t* sv, int n_sig,
                                 const int32_t* policy_ok, int8_t* out, void* stream) {
  const int nw = (T + 31) / 32;
  const size_t smem = 3 * (size_t)nw * sizeof(uint32_t);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (T > 0) {
    const int threads = T < kFixThreads ? ((T + 31) / 32) * 32 : kFixThreads;
    mvcc_fixpoint_kernel<<<1, threads, smem, (cudaStream_t)stream>>>(
        T, nw, direct, phantom, ver_ok, pre_ok, launch_vec, sv, n_sig, policy_ok, out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* fab_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
