// Device-resident MVCC state: the committed-version check against the
// resident version table, and the table's row scatter.
//
// resident_verok replaces fabric_tpu/peer/device_block.py::
//   _resident_ver_ok (the resident_dims branch of build_stage2.stage2).
//   One thread per transaction walks its R reads: a read key id indexes
//   the block's unique-key pack u_pack [Ub, 4] (slot | present | vb | vt);
//   slot >= 0 gathers the committed row (present | vb | vt) from the
//   table [cap, 3], slot -1 takes the row's own host lane (a miss or an
//   in-flight overlay value) and never touches the table.  The compare
//   is validateKVRead's: version equality when both sides are present,
//   a presence flip is stale, padding reads (id < 0) pass.  Ids past the
//   pack read an absent row and slots past the table clamp to its last
//   row, as the reference's gathers do.  The verdict goes into column 2
//   of the block's launch vector [T, 3], where stage2_mvcc reads it, so
//   stage2.cu keeps its contract.  Bound: bytes, ~56 per read (key id,
//   pack row, table row, expected row), a few hundred KB per block; the
//   launch is latency-bound.
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

__global__ void resident_verok_kernel(const int32_t* __restrict__ sp, int T, int cols, int R,
                                      const int32_t* __restrict__ table, int cap,
                                      const int32_t* __restrict__ u_pack, int Ub,
                                      const int32_t* __restrict__ read_pv,
                                      int32_t* __restrict__ launch_vec) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  bool ok = true;
  for (int a = 0; a < R; ++a) {
    const int rk = sp[(size_t)t * cols + a];
    if (rk < 0) continue;
    bool cp = false;
    int32_t cvb = 0, cvt = 0;
    if (rk < Ub) {
      const int32_t* u = u_pack + (size_t)rk * 4;
      const int slot = u[0];
      const int32_t* row = slot >= 0 ? table + (size_t)min(slot, cap - 1) * 3 : u + 1;
      cp = row[0] != 0;
      cvb = row[1];
      cvt = row[2];
    }
    const int32_t* e = read_pv + ((size_t)t * R + a) * 3;
    const bool rp = e[0] != 0;
    ok &= (rp && cp) ? (e[1] == cvb && e[2] == cvt) : (rp == cp);
  }
  launch_vec[(size_t)t * 3 + 2] = ok ? 1 : 0;
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
  if (T > 0) {
    resident_verok_kernel<<<(T + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
        sp, T, cols, R, table, cap, u_pack, Ub, read_pv, launch_vec);
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
