// Device-resident MVCC state: the committed-version check against the
// resident version table, and the table's row scatter.
//
// resident_verok replaces fabric_tpu/peer/device_block.py::
//   _resident_ver_ok (the resident_dims branch of build_stage2.stage2).
//   One thread per (transaction, read): a read key id indexes the
//   block's unique-key pack u_pack [Ub, 4] (slot | present | vb | vt),
//   read as one 16-byte load; slot >= 0 gathers the committed row
//   (present | vb | vt) from the table [cap, 3], slot -1 takes the row's
//   own host lane (a miss or an in-flight overlay value) and never
//   touches the table.  The compare is validateKVRead's: version
//   equality when both sides are present, a presence flip is stale,
//   padding reads (id < 0) pass.  Ids past the pack read an absent row
//   and slots past the table clamp to its last row, as the reference's
//   gathers do.  A transaction's reads take `lanes` neighbouring
//   threads, R rounded up to a power of two and at most a warp (a lane
//   walks reads j, j + lanes, ... when R > 32), so no transaction
//   straddles a warp: one ballot gives its verdict, which its first
//   lane writes into column 2 of the block's launch vector [T, 3],
//   where stage2_mvcc reads it, so stage2.cu keeps its contract.  The
//   chain is three dependent loads (key id, pack row, table row)
//   whatever R is; the expected row is read coalesced by (t, a), the
//   pack and the table through the read-only path.  Bound: bytes, ~56
//   per read (key id, pack row, table row, expected row), a few hundred
//   KB per block.  The first design walked a transaction's R reads in
//   one thread, R chains of three dependent misses one after another.
//
// table_scatter replaces fabric_tpu/state/residency.py::
//   ResidencyManager._scatter (table.at[idx].set(rows)).  One thread per
//   int32 word of the k x 3 rows writes table[idx[i / 3]][i % 3] =
//   rows[i], so the reads of rows coalesce.  It takes the k real rows
//   only: the reference pads with idx == capacity, which jax drops and
//   which here would be an out-of-bounds write; the caller checks every
//   index against [0, cap) on the host before the launch.  Indices are
//   distinct within one call (the manager hands out one slot per key).
//   Bound: bytes, 28 per row (index read once, row read and written);
//   at a block's ~2,000 rows the launch path on the host is the time.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// log2 of a transaction's lanes: R rounded up to a power of two, at most 32
inline int verok_shift(int R) {
  int shift = 0;
  while ((1 << shift) < R && shift < 5) ++shift;
  return shift;
}

__global__ void __launch_bounds__(kThreads)
resident_verok_kernel(const int32_t* __restrict__ sp, int T, int cols, int R, int shift,
                      const int32_t* __restrict__ table, int cap,
                      const int32_t* __restrict__ u_pack, int Ub,
                      const int32_t* __restrict__ read_pv, int32_t* __restrict__ launch_vec) {
  const int lanes = 1 << shift;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int t = i >> shift, j = i & (lanes - 1);
  bool ok = true;
  if (t < T) {
    for (int a = j; a < R; a += lanes) {
      const int rk = sp[(size_t)t * cols + a];
      const int32_t* e = read_pv + ((size_t)t * R + a) * 3;
      const bool rp = e[0] != 0;
      const int32_t evb = e[1], evt = e[2];
      bool cp = false;
      int32_t cvb = 0, cvt = 0;
      if (rk >= 0 && rk < Ub) {
        const int4 u = __ldg(reinterpret_cast<const int4*>(u_pack) + rk);
        if (u.x >= 0) {
          const int32_t* row = table + (size_t)min(u.x, cap - 1) * 3;
          cp = __ldg(row) != 0;
          cvb = __ldg(row + 1);
          cvt = __ldg(row + 2);
        } else {
          cp = u.y != 0;
          cvb = u.z;
          cvt = u.w;
        }
      }
      if (rk >= 0) ok &= (rp && cp) ? (evb == cvb && evt == cvt) : (rp == cp);
    }
  }
  // every thread of the warp votes; a transaction's lanes are one
  // aligned segment of it
  const unsigned bad = __ballot_sync(0xFFFFFFFFu, !ok);
  if (t < T && j == 0) {
    const unsigned seg = lanes == 32 ? 0xFFFFFFFFu : (1u << lanes) - 1u;
    launch_vec[(size_t)t * 3 + 2] = ((bad >> (threadIdx.x & 31)) & seg) == 0u ? 1 : 0;
  }
}

__global__ void table_scatter_kernel(int32_t* __restrict__ table,
                                     const int32_t* __restrict__ idx,
                                     const int32_t* __restrict__ rows, int k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 3 * k) return;
  const int r = i / 3;
  table[(size_t)idx[r] * 3 + (i - 3 * r)] = rows[i];
}

}  // namespace

extern "C" int fab_resident_verok(const int32_t* sp, int T, int cols, int R,
                                  const int32_t* table, int cap, const int32_t* u_pack,
                                  int Ub, const int32_t* read_pv, int32_t* launch_vec,
                                  void* stream) {
  const int shift = verok_shift(R);
  const long long n = (long long)T << shift;
  if (n > (1LL << 30)) return (int)cudaErrorInvalidValue;
  if (T > 0) {
    resident_verok_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                            (cudaStream_t)stream>>>(sp, T, cols, R, shift, table, cap, u_pack,
                                                    Ub, read_pv, launch_vec);
  }
  return (int)cudaGetLastError();
}

extern "C" int fab_table_scatter(int32_t* table, const int32_t* idx, const int32_t* rows, int k,
                                 void* stream) {
  if (k > 0) {
    table_scatter_kernel<<<(3 * k + kThreads - 1) / kThreads, kThreads, 0,
                           (cudaStream_t)stream>>>(table, idx, rows, k);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* fab_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
