"""The CUDA kernel sources' device code, compiled as host C++ (g++,
-std=c++20 -pthread) and run against the plain versions on the CPU (and
the sign kernel against ``ec_ref``).

The sm_90a kernels themselves run only on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).  Here shim macros
turn ``__global__``/``__device__`` functions into plain C++.  Kernels of
one thread per lane run one thread per block, a loop over ``blockIdx``
playing the grid.  The team kernels (``p256_verify``, ``p256_sign``,
``p256_v1``, ``p256_v2``), the warp-ballot stage-2 kernels, the policy
kernel, ``resident_verok`` and ``sha256_blocks`` (its producer and
consumer warps) run each block's ``blockDim.x`` threads as
``std::thread``s
(``threadIdx`` and ``blockIdx`` are ``thread_local``):
``__syncthreads``, ``__syncwarp``, the shuffles, ``__ballot_sync`` and
``__any_sync`` go through a per-block exchange array and a C++20
``std::barrier``, in full warps of teams, at the team sizes each
kernel launches (8 and 4; ``p256_v2`` 8).
``nvcuda::wmma``'s int8 tiles (``p256_v2``) are whole tiles in every
thread, multiplied in lane 0, which makes the warp's store;
``cuda_pipeline.h``'s asynchronous copies are copies made at once;
``sha256.cu``'s mbarriers (inline PTX on the card) are an atomic phase bit
and arrival count waited on with C++20 ``atomic::wait``.  The shared
``p256_team.cuh`` is inlined where a source includes it.  Nothing here
is skipped on the CPU.  That checks
each kernel's arithmetic and indexing — the team Montgomery products
mod p and mod n (against Python ints), the team carry-lookahead votes,
the point formulas, the window recoding, the comb ladder, the policy
gate walk, the bitsets, the fixpoint, the resident-table compare, the
table scatter and the SHA-256 compression (against ``hashlib``), the v1
verifier's team ladder step (the doubling case taken by one team of a
warp) and whole verify, and the v2 verifier's team digit product (the
convolution across the team, the split int8 reduction) and settle
(against ``DigitMod`` at the largest legal magnitudes) and whole verify
— bit for bit, before a card ever sees it."""

import ctypes
import hashlib
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from fabric_tpu_torch.crypto import ec_ref
from fabric_tpu_torch.crypto import policy as pol
from fabric_tpu_torch.ops import digits as dg
from fabric_tpu_torch.ops import fp256
from fabric_tpu_torch.ops import mvcc
from fabric_tpu_torch.ops import p256 as v1
from fabric_tpu_torch.ops import p256sign
from fabric_tpu_torch.ops import p256v2 as v2
from fabric_tpu_torch.ops import sha256 as psha
from fabric_tpu_torch.ops import p256v3 as v3
from fabric_tpu_torch.peer import device_block as db
from fabric_tpu_torch.state import residency

CSRC = pathlib.Path(__file__).resolve().parents[1] / "fabric_tpu_torch" / "kernels" / "csrc"

SHIM = r"""
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <mutex>
#include <new>
#include <thread>
#include <vector>
using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(x)
#define __restrict__
#define __align__(n) alignas(n)
#define __shared__ static
#define __ldg(p) (*(p))
#define __constant__
static inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, unsigned s) {
  s &= 31;
  return s ? (lo >> s) | (hi << (32 - s)) : lo;
}
static inline uint32_t __umulhi(uint32_t a, uint32_t b) { return ((uint64_t)a * b) >> 32; }
struct Dim { unsigned x = 0, y = 0, z = 0; };
static thread_local Dim blockIdx, threadIdx, blockDim;
template <class T> static T atomicOr(T* p, T v) { T o = *p; *p |= v; return o; }
template <class T> static T atomicMin(T* p, T v) { T o = *p; if (v < o) *p = v; return o; }
static std::mutex host_atomic_mutex;  // shared-memory atomics of a block's threads
template <class T> static T atomicAnd(T* p, T v) {
  std::lock_guard<std::mutex> g(host_atomic_mutex);
  T o = *p;
  *p &= v;
  return o;
}
static inline int __popc(uint32_t x) { return __builtin_popcount(x); }
// cuda_pipeline.h's asynchronous copies: done at once
#define __pipeline_memcpy_async(dst, src, n) std::memcpy((dst), (src), (n))
#define __pipeline_commit()
#define __pipeline_wait_prior(n)
struct int4 { int x, y, z, w; };
struct uint4 { uint32_t x, y, z, w; };
static inline uint4 make_uint4(uint32_t x, uint32_t y, uint32_t z, uint32_t w) {
  return uint4{x, y, z, w};
}
static uint32_t host_smem[1 << 16];
// mbarriers (sha256.cu's bar_* helpers): the 8-byte word holds the phase
// bit (waited on with C++20 atomic wait) and the arrivals left in the
// low half of its second word, the expected count in the high half; the
// last arrival of a phase refills the count and flips the phase
#define FAB_HOST_SHIM 1
static std::atomic<uint32_t>* host_bar(uint64_t* bar) {
  return reinterpret_cast<std::atomic<uint32_t>*>(bar);
}
static void bar_init(uint64_t* bar, uint32_t count) {
  new (host_bar(bar)) std::atomic<uint32_t>(0);
  new (host_bar(bar) + 1) std::atomic<uint32_t>((count << 16) | count);
}
static void bar_init_fence() {}
static void bar_arrive(uint64_t* bar) {
  std::atomic<uint32_t>* w = host_bar(bar);
  const uint32_t old = w[1].fetch_sub(1);
  if ((old & 0xFFFFu) == 1) {
    w[1].store((old & 0xFFFF0000u) | (old >> 16));
    w[0].fetch_xor(1);
    w[0].notify_all();
  }
}
// returns once the phase of parity `parity` has completed
static void bar_wait(uint64_t* bar, uint32_t parity) {
  std::atomic<uint32_t>* w = host_bar(bar);
  for (uint32_t ph = w[0].load(); (ph & 1) == parity; ph = w[0].load()) w[0].wait(ph);
}

// One block of threads: a std::thread per CUDA thread, a barrier for
// the block and one for each warp, a double-buffered exchange array for
// the collectives and the block's shared memory.  The threads of a warp
// make the same sequence of warp collectives (shuffles, votes), and the
// threads of a block the same sequence of block barriers, so one
// barrier per call suffices: a buffer is written again only two calls
// later, after every thread concerned has passed the barrier of the
// call in between.  A warp's collectives wait for its own threads only,
// as on the card, so warps may run loops of different lengths.
struct HostBlock {
  explicit HostBlock(int n) : bar(n) {
    for (int w = 0; w < n; w += 32) warp_bar.emplace_back(new std::barrier<>(std::min(32, n - w)));
  }
  std::barrier<> bar;
  std::vector<std::unique_ptr<std::barrier<>>> warp_bar;
  uint64_t xch[2][1024];
  uint64_t bxch[2][1024];
  alignas(128) uint32_t smem[1 << 15];
};
static thread_local HostBlock* host_block = nullptr;  // null: one-thread launchers
static thread_local unsigned host_calls = 0, host_block_calls = 0;
static uint32_t* host_block_smem() { return host_block->smem; }
static void __syncthreads() {
  if (host_block) host_block->bar.arrive_and_wait();
}
static void __syncwarp(unsigned = 0xFFFFFFFFu) {
  if (host_block) host_block->warp_bar[threadIdx.x / 32]->arrive_and_wait();
}
static const uint64_t* host_exchange(uint64_t w) {
  uint64_t* buf = host_block->xch[host_calls++ & 1];
  buf[threadIdx.x] = w;
  host_block->warp_bar[threadIdx.x / 32]->arrive_and_wait();
  return buf;
}
static int __syncthreads_or(int pred) {
  uint64_t* buf = host_block->bxch[host_block_calls++ & 1];
  buf[threadIdx.x] = pred ? 1u : 0u;
  host_block->bar.arrive_and_wait();
  int r = 0;
  for (unsigned t = 0; t < blockDim.x; ++t) r |= (int)buf[t];
  return r;
}
template <class T> static T host_read(const uint64_t* buf, int tid) {
  T r;
  std::memcpy(&r, &buf[tid], sizeof(T));
  return r;
}
template <class T> static uint64_t host_word(T v) {
  uint64_t w = 0;
  std::memcpy(&w, &v, sizeof(T));
  return w;
}
// lane l of a width-w segment reads lane src of the same segment
template <class T> static T __shfl_sync(unsigned, T v, int src, int width = 32) {
  const uint64_t* buf = host_exchange(host_word(v));
  const int lane = threadIdx.x & 31;
  const int seg = (int)threadIdx.x - lane + (lane & ~(width - 1));
  return host_read<T>(buf, seg + (src & (width - 1)));
}
template <class T> static T __shfl_up_sync(unsigned, T v, unsigned d, int width = 32) {
  const uint64_t* buf = host_exchange(host_word(v));
  const int i = threadIdx.x & (width - 1);
  return i < (int)d ? v : host_read<T>(buf, threadIdx.x - d);
}
template <class T> static T __shfl_down_sync(unsigned, T v, unsigned d, int width = 32) {
  const uint64_t* buf = host_exchange(host_word(v));
  const int i = threadIdx.x & (width - 1);
  return i + (int)d >= width ? v : host_read<T>(buf, threadIdx.x + d);
}
static unsigned __ballot_sync(unsigned, bool pred) {
  const uint64_t* buf = host_exchange(pred ? 1u : 0u);
  const unsigned base = threadIdx.x & ~31u;
  unsigned m = 0;
  for (unsigned l = 0; l < 32 && base + l < blockDim.x; ++l) m |= (unsigned)buf[base + l] << l;
  return m;
}
static bool __any_sync(unsigned mask, bool pred) { return __ballot_sync(mask, pred) != 0; }
static unsigned __reduce_or_sync(unsigned, unsigned v) {
  const uint64_t* buf = host_exchange(v);
  const unsigned base = threadIdx.x & ~31u;
  unsigned r = 0;
  for (unsigned l = 0; l < 32 && base + l < blockDim.x; ++l) r |= (unsigned)buf[base + l];
  return r;
}
static int __reduce_max_sync(unsigned, int v) {
  const uint64_t* buf = host_exchange((uint64_t)(uint32_t)v);
  const unsigned base = threadIdx.x & ~31u;
  int r = v;
  for (unsigned l = 0; l < 32 && base + l < blockDim.x; ++l) r = std::max(r, (int)(uint32_t)buf[base + l]);
  return r;
}
static inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }

// the grid, `concurrent` blocks at a time
static void host_launch(int grid, int block, int concurrent, const std::function<void()>& k) {
  for (int b0 = 0; b0 < grid; b0 += concurrent) {
    const int nb = std::min(concurrent, grid - b0);
    std::vector<std::unique_ptr<HostBlock>> blocks;
    std::vector<std::thread> threads;
    for (int b = 0; b < nb; ++b) blocks.emplace_back(new HostBlock(block));
    for (int b = 0; b < nb; ++b)
      for (int t = 0; t < block; ++t)
        threads.emplace_back([&, b, t] {
          blockIdx.x = b0 + b;
          threadIdx.x = t;
          blockDim.x = block;
          host_block = blocks[b].get();
          k();
        });
    for (auto& th : threads) th.join();
  }
}

// nvcuda::wmma for the int8 tiles of p256_v2.cu: each thread holds the
// whole 16 x 16 tile; lane 0 computes the warp's products and makes its
// store, between two warp barriers (the collective's).
namespace nvcuda {
namespace wmma {
struct matrix_a {};
struct matrix_b {};
struct accumulator {};
struct row_major {};
enum layout_t { mem_row_major };
template <class Use, int M, int N, int Kd, class T, class Layout = void>
struct fragment {
  static constexpr int num_elements = 256;
  T x[256];
};
template <class Use, class T>
static void load_matrix_sync(fragment<Use, 16, 16, 16, T, row_major>& f, const T* p, unsigned ldm) {
  for (int r = 0; r < 16; ++r)
    for (int c = 0; c < 16; ++c) f.x[r * 16 + c] = p[r * ldm + c];
}
static void load_matrix_sync(fragment<accumulator, 16, 16, 16, int>& f, const int* p, unsigned ldm,
                             layout_t) {
  for (int r = 0; r < 16; ++r)
    for (int c = 0; c < 16; ++c) f.x[r * 16 + c] = p[r * ldm + c];
}
static void fill_fragment(fragment<accumulator, 16, 16, 16, int>& f, int v) {
  for (int i = 0; i < 256; ++i) f.x[i] = v;
}
static void mma_sync(fragment<accumulator, 16, 16, 16, int>& d,
                     const fragment<matrix_a, 16, 16, 16, signed char, row_major>& a,
                     const fragment<matrix_b, 16, 16, 16, signed char, row_major>& b,
                     const fragment<accumulator, 16, 16, 16, int>& c) {
  if ((threadIdx.x & 31) != 0) return;
  int out[256];
  for (int i = 0; i < 16; ++i)
    for (int j = 0; j < 16; ++j) {
      int s = c.x[i * 16 + j];
      for (int k = 0; k < 16; ++k) s += (int)a.x[i * 16 + k] * (int)b.x[k * 16 + j];
      out[i * 16 + j] = s;
    }
  std::memcpy(d.x, out, sizeof(out));
}
static void store_matrix_sync(int* p, const fragment<accumulator, 16, 16, 16, int>& f,
                              unsigned ldm, layout_t) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0)
    for (int r = 0; r < 16; ++r)
      for (int c = 0; c < 16; ++c) p[r * ldm + c] = f.x[r * 16 + c];
  __syncwarp();
}
}  // namespace wmma
}  // namespace nvcuda
"""

LAUNCHERS = {
    "p256_verify": r"""
// the team kernel at TPI threads per lane, `teams` lanes per block
template <int TPI>
static void host_p256_tpi(const int16_t* f, int B, const uint32_t* c, uint8_t* out, int teams,
                          int concurrent) {
  host_launch((B + teams - 1) / teams, teams * TPI, concurrent,
              [&] { p256_verify_kernel<TPI>(f, B, c, out); });
}
extern "C" void host_p256(const int16_t* f, int B, const uint32_t* c, uint8_t* out, int tpi,
                          int teams, int concurrent) {
  if (tpi == 8) host_p256_tpi<8>(f, B, c, out, teams, concurrent);
  if (tpi == 4) host_p256_tpi<4>(f, B, c, out, teams, concurrent);
}
// n team products r = a * b * 2^-256 mod p (8 little-endian words each),
// one team per group of G products run together through fe_mul_n
template <int TPI, int G>
static void host_mul_group(const uint32_t* a, const uint32_t* b, uint32_t* r, int n) {
  host_launch((n + G - 1) / G, TPI, 8, [&] {
    const Team<TPI> tm;
    const int i = blockIdx.x * G;
    Fe<TPI> x[G], y[G], z[G];
    Fe<TPI>* rz[G];
    const Fe<TPI>* rx[G];
    const Fe<TPI>* ry[G];
    for (int k = 0; k < G; ++k) {
      for (int l = 0; l < Fe<TPI>::L; ++l) {
        const int j = std::min(i + k, n - 1) * 8 + tm.t * Fe<TPI>::L + l;
        x[k].v[l] = a[j];
        y[k].v[l] = b[j];
      }
      rz[k] = &z[k];
      rx[k] = &x[k];
      ry[k] = &y[k];
    }
    fe_mul_n<TPI, G>(tm, rz, rx, ry);
    for (int k = 0; k < G && i + k < n; ++k)
      for (int l = 0; l < Fe<TPI>::L; ++l) r[(i + k) * 8 + tm.t * Fe<TPI>::L + l] = z[k].v[l];
  });
}
template <int TPI>
static void host_mul_tpi(const uint32_t* a, const uint32_t* b, uint32_t* r, int n, int group) {
  if (group == 1) host_mul_group<TPI, 1>(a, b, r, n);
  if (group == 2) host_mul_group<TPI, 2>(a, b, r, n);
  if (group == 6) host_mul_group<TPI, 6>(a, b, r, n);
}
extern "C" void host_team_mul(const uint32_t* a, const uint32_t* b, uint32_t* r, int n, int tpi,
                              int group) {
  if (tpi == 8) host_mul_tpi<8>(a, b, r, n, group);
  if (tpi == 4) host_mul_tpi<4>(a, b, r, n, group);
}
""",
    "stage2": r"""
// every group in one launch: n_cta CTAs of kPolicyThreads threads, one
// CTA at a time (the plan's static shared array is one per process here)
extern "C" void host_policy(const uint8_t* sv, int n_sig, const int32_t* frames,
                            const int32_t* meta, int n_cta, int T, int8_t* safe, int32_t* fail) {
  host_launch(n_cta, kPolicyThreads, 1,
              [&] { stage2_policy_kernel(sv, n_sig, frames, meta, T, safe, fail); });
}
// one warp per word, two warps a block
extern "C" void host_bitsets(const int32_t* sp, int T, int R, int W, int Q, uint32_t* d,
                             uint32_t* p) {
  const int nw = (T + 31) / 32;
  host_launch((T * nw + 1) / 2, 64, 8, [&] { mvcc_bitsets_kernel(sp, T, R, W, Q, nw, d, p); });
}
extern "C" void host_verok(const int32_t* rk, const uint8_t* rp, const uint32_t* rv,
                           const uint8_t* cp, const uint32_t* cv, int T, int R, uint8_t* vo) {
  blockDim.x = 1;
  for (int t = 0; t < T; ++t) { blockIdx.x = t; mvcc_verok_kernel(rk, rp, rv, cp, cv, T, R, vo); }
}
// one block of `threads` (a multiple of 32); in_smem: direct | phantom
// staged in shared memory, else read from global memory in each round
extern "C" void host_fixpoint(int T, const uint32_t* d, const uint32_t* p, const uint8_t* vo,
                              const uint8_t* po, const int32_t* lv, const uint8_t* sv, int n_sig,
                              const int32_t* fail, int n_fail, int8_t* out, int threads,
                              int in_smem) {
  const int nw = (T + 31) / 32;
  host_launch(1, threads, 1, [&] {
    mvcc_fixpoint_kernel(T, nw, in_smem ? fix_row_words(nw) : 0, d, p, vo, po, lv, sv, n_sig,
                         fail, n_fail, out);
  });
}
""",
    "resident": r"""
// a thread per (transaction, read lane), blocks of kThreads, two at a time
extern "C" void host_verok(const int32_t* sp, int T, int cols, int R, const int32_t* table,
                           int cap, const int32_t* u_pack, int Ub, const int32_t* read_pv,
                           int32_t* lv) {
  const int shift = verok_shift(R);
  host_launch(((T << shift) + kThreads - 1) / kThreads, kThreads, 2, [&] {
    resident_verok_kernel(sp, T, cols, R, shift, table, cap, u_pack, Ub, read_pv, lv);
  });
}
extern "C" void host_scatter(int32_t* table, const int32_t* idx, const int32_t* rows, int k) {
  blockDim.x = 1;
  for (int i = 0; i < 3 * k; ++i) { blockIdx.x = i; table_scatter_kernel(table, idx, rows, k); }
}
""",
    "sha256": r"""
// the launch's grid of CTAs (kConsumers consumer and as many producer
// warps each, the barriers and the ring in the block's shared memory),
// two CTAs at a time
extern "C" void host_sha256(const uint32_t* blocks, const int32_t* nb, int B, int M,
                            uint32_t* out) {
  if (B > 0)
    host_launch((B + kMsgs - 1) / kMsgs, kThreads, 2,
                [&] { sha256_blocks_kernel(blocks, nb, B, M, out, 1u); });
}
""",
    "p256_v1": r"""
// the team kernel at TPI threads per lane, 8 lanes a block
template <int TPI>
static void host_v1_tpi(const int32_t* f, int B, const uint32_t* c, uint8_t* out, int concurrent) {
  host_launch((B + kTeams - 1) / kTeams, kTeams * TPI, concurrent,
              [&] { p256_v1_kernel<TPI>(f, B, c, out); });
}
extern "C" void host_v1(const int32_t* f, int B, const uint32_t* c, uint8_t* out, int tpi,
                        int concurrent) {
  if (tpi == 8) host_v1_tpi<8>(f, B, c, out, concurrent);
  if (tpi == 4) host_v1_tpi<4>(f, B, c, out, concurrent);
}
// n ladder steps, a team a lane: out = 2 acc + t (Jacobian, Montgomery
// form, 24 words a lane: X | Y | Z)
template <int TPI>
static void host_v1_step_tpi(const uint32_t* acc, const uint32_t* t, uint32_t* out, int n) {
  host_launch((n + kTeams - 1) / kTeams, kTeams * TPI, 2, [&] {
    const Team<TPI> tm;
    const int lane = blockIdx.x * kTeams + threadIdx.x / TPI;
    const int i = std::min(lane, n - 1);
    TPt<TPI> a, b;
    load_const_fe(a.x, acc + i * 24, tm.t);
    load_const_fe(a.y, acc + i * 24 + 8, tm.t);
    load_const_fe(a.z, acc + i * 24 + 16, tm.t);
    load_const_fe(b.x, t + i * 24, tm.t);
    load_const_fe(b.y, t + i * 24 + 8, tm.t);
    load_const_fe(b.z, t + i * 24 + 16, tm.t);
    jac_double(tm, a);
    jac_add(tm, a, a, b);
    if (lane < n)
      for (int l = 0; l < Fe<TPI>::L; ++l) {
        const int k = tm.t * Fe<TPI>::L + l;
        out[i * 24 + k] = a.x.v[l];
        out[i * 24 + 8 + k] = a.y.v[l];
        out[i * 24 + 16 + k] = a.z.v[l];
      }
  });
}
extern "C" void host_v1_step(const uint32_t* acc, const uint32_t* t, uint32_t* out, int n,
                             int tpi) {
  if (tpi == 8) host_v1_step_tpi<8>(acc, t, out, n);
  if (tpi == 4) host_v1_step_tpi<4>(acc, t, out, n);
}
// n team products r = a * b * 2^-256 mod n (8 little-endian words each)
template <int TPI>
static void host_fn_mul_tpi(const uint32_t* a, const uint32_t* b, const uint32_t* nw, uint32_t* r,
                            int n) {
  host_launch((n + kTeams - 1) / kTeams, kTeams * TPI, 2, [&] {
    const Team<TPI> tm;
    const int lane = blockIdx.x * kTeams + threadIdx.x / TPI;
    const int i = std::min(lane, n - 1);
    Fe<TPI> x, y, z;
    uint32_t nl[Fe<TPI>::L];
    load_const_fe(x, a + i * 8, tm.t);
    load_const_fe(y, b + i * 8, tm.t);
    for (int l = 0; l < Fe<TPI>::L; ++l) nl[l] = nw[tm.t * Fe<TPI>::L + l];
    fn_mul(tm, z, x, y, nl);
    if (lane < n)
      for (int l = 0; l < Fe<TPI>::L; ++l) r[i * 8 + tm.t * Fe<TPI>::L + l] = z.v[l];
  });
}
extern "C" void host_fn_mul(const uint32_t* a, const uint32_t* b, const uint32_t* nw, uint32_t* r,
                            int n, int tpi) {
  if (tpi == 8) host_fn_mul_tpi<8>(a, b, nw, r, n);
  if (tpi == 4) host_fn_mul_tpi<4>(a, b, nw, r, n);
}
""",
    "p256_v2": r"""
// the team kernel, 16 lanes a block
extern "C" void host_v2(const int32_t* f, int B, const int32_t* c, uint8_t* out, int concurrent) {
  host_launch((B + kLanes - 1) / kLanes, kLanes * kTPI, concurrent,
              [&] { p256_v2_kernel<kTPI>(f, B, c, out); });
}
// one team per lane, 16 lanes a block: op 0 out = a * b mod m (dm_mul),
// op 1 out = settle(a); a, b 43 digits a lane, out 48 (the padding too)
extern "C" void host_v2_op(const int32_t* c, int mod, int op, const int32_t* a, const int32_t* b,
                           int32_t* out, int n) {
  host_launch((n + kLanes - 1) / kLanes, kLanes * kTPI, 2, [&] {
    uint8_t* sm = (uint8_t*)host_block_smem();
    for (int i = threadIdx.x; i < kTableBytes / 4; i += blockDim.x)
      ((int32_t*)sm)[i] = c[kHeader + i];
    const Lane<kTPI> ln(sm, c);
    constexpr int L = Lane<kTPI>::L;
    const int lane = blockIdx.x * kLanes + ln.row;
    const int i = std::min(lane, n - 1);
    __syncthreads();
    int32_t x[L], y[L];
    for (int l = 0; l < L; ++l) {
      const int k = ln.t * L + l;
      x[l] = k < K ? a[i * K + k] : 0;
      y[l] = k < K ? b[i * K + k] : 0;
    }
    if (op == 0 && mod == 0) dm_mul<kTPI, 0>(ln, x, x, y);
    if (op == 0 && mod == 1) dm_mul<kTPI, 1>(ln, x, x, y);
    if (op == 1 && mod == 0) settle<kTPI, 0>(ln, x);
    if (op == 1 && mod == 1) settle<kTPI, 1>(ln, x);
    if (lane < n)
      for (int l = 0; l < L; ++l) out[lane * KP + ln.t * L + l] = x[l];
  });
}
""",
    "p256_sign": r"""
// the team kernel at TPI threads per chain, `chains` chains per lane
template <int TPI>
static void host_sign_tpi(const int16_t* limbs, int B, int chains, const uint32_t* c,
                          const uint32_t* comb, uint32_t* out, int concurrent) {
  const int teams = sign_block_teams(chains);
  host_launch((B * chains + teams - 1) / teams, teams * TPI, concurrent,
              [&] { p256_sign_kernel<TPI>(limbs, B, chains, c, comb, out); });
}
extern "C" void host_sign(const int16_t* limbs, int B, int chains, const uint32_t* c,
                          const uint32_t* comb, uint32_t* out, int tpi, int concurrent) {
  if (tpi == 8) host_sign_tpi<8>(limbs, B, chains, c, comb, out, concurrent);
  if (tpi == 4) host_sign_tpi<4>(limbs, B, chains, c, comb, out, concurrent);
}
""",
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel sources with")
    out = {}
    d = tmp_path_factory.mktemp("host_kernels")
    for name, launcher in LAUNCHERS.items():
        src = (CSRC / f"{name}.cu").read_text()
        for header in ("p256_team.cuh",):
            text = (CSRC / header).read_text().replace("#pragma once", "")
            src = src.replace(f'#include "{header}"', text)
        device_code = src.split("}  // namespace")[0]
        device_code = device_code.replace("#include <cuda_runtime.h>", "").replace(
            "#include <cuda_pipeline.h>", "").replace(
            "extern __shared__ uint32_t sm[];", "uint32_t* sm = host_smem;").replace(
            "extern __shared__ int32_t policy_rows[];",
            "int32_t* policy_rows = (int32_t*)host_block_smem();").replace(
            "extern __shared__ __align__(128) uint8_t v2_smem[];",
            "uint8_t* v2_smem = (uint8_t*)host_block_smem();").replace(
            "#include <mma.h>", "").replace(
            "__shared__ __align__(16) uint32_t smem[kSmemWords];",
            "uint32_t* smem = host_block_smem();").replace(
            "extern __shared__ __align__(16) uint32_t sha_smem[];",
            "uint32_t* sha_smem = host_block_smem();")
        cpp = d / f"{name}.cpp"
        cpp.write_text(SHIM + device_code + "}  // namespace\n" + launcher)
        so = d / f"{name}.so"
        subprocess.run([cxx, "-O2", "-std=c++20", "-pthread", "-shared", "-fPIC", "-w", "-o",
                        str(so), str(cpp)], check=True, timeout=300)
        out[name] = ctypes.CDLL(str(so))
    return out


def _p(a):
    return None if a is None else a.ctypes.data_as(ctypes.c_void_p)


def _items(n, seed=3):
    rng = np.random.default_rng(seed)
    keys = [ec_ref.SigningKey(d=int(rng.integers(1, 1 << 62))) for _ in range(3)]
    base = []
    for k in keys:
        for _ in range(4):
            e = int.from_bytes(rng.bytes(32), "big")
            base.append((e, *k.sign_digest(e), *k.public))
    base += [(0, *k.sign_digest(0), *k.public) for k in keys]  # zero u1 windows
    wrapped = [ec_ref.wrapped_x_signature(int(rng.integers(1, 1 << 62)) << 64,
                                          int.from_bytes(rng.bytes(32), "big"),
                                          ec_ref.HALF_N - j) for j in range(2)]
    out = []
    for i in range(n):
        e, r, s, qx, qy = base[i % len(base)]
        kind = i % 10
        if kind == 1:
            r = (r + 1) % ec_ref.N
        elif kind == 2:
            s = ec_ref.N - s
        elif kind == 3:
            qx = (qx + 1) % ec_ref.P
        elif kind == 4:
            e ^= 2
        elif kind == 5:
            s = ec_ref.N + 1
        elif kind == 6:
            r = 0
        elif kind in (7, 8):  # x(R) in [n, p): accepted only through r + n
            e, r, s, qx, qy = wrapped[i % 2]
            e ^= kind == 8
        elif kind == 9:
            qx, qy = 0, 0
        out.append((e, r, s, qx, qy))
    return out


@pytest.mark.parametrize("tpi", [8, 4])
def test_verify_kernel_source_matches_plain_and_oracle(host_kernels, tpi):
    """The team kernel, one std::thread per CUDA thread, at TPI = 8 and 4,
    on every adversarial kind; B is not a multiple of the block, so the
    last block's spare teams run a dummy row with their stores masked.
    ``_items`` repeats with period 30 (15 base signatures x 10 kinds), so
    30 lanes hold every distinct (signature, kind) pair."""
    items = _items(30)
    frame = v3.stage_frame(items, len(items) + 1)
    consts = v3._kernel_consts(torch.device("cpu")).numpy().view(np.uint32)
    out = np.zeros(len(frame), np.uint8)
    # full warps: 32 / TPI teams a block, so the votes mix teams
    host_kernels["p256_verify"].host_p256(_p(frame), len(frame), _p(consts), _p(out), tpi,
                                          32 // tpi, 2)
    plain = v3.verify_batch_ref(torch.from_numpy(frame)).numpy()
    assert np.array_equal(out.astype(bool), plain)
    want = [ec_ref.verify_digest((x, y), e, r, s) for e, r, s, x, y in items]
    assert out[:len(items)].astype(bool).tolist() == want
    assert any(want) and not all(want)
    assert all(want[i] == (i % 10 == 7) for i in range(len(items)) if i % 10 in (7, 8))


@pytest.mark.parametrize("tpi", [8, 4])
def test_team_product_matches_python_ints(host_kernels, tpi):
    """The team Montgomery product, alone and interleaved in groups of 2
    and 6 (at TPI = 4 the 6 run as three pairs), at 0, 1, p - 1, p - 2,
    2^255 mod p, R mod p and random values."""
    P, R = ec_ref.P, 1 << 256
    rng = np.random.default_rng(14)
    edge = [0, 1, P - 1, P - 2, (1 << 255) % P, R % P, (1 << 224) - 1, 1 << 192]
    rand = [int.from_bytes(rng.bytes(32), "big") % P for _ in range(24)]
    pairs = [(a, b) for a in edge for b in edge] + list(zip(rand, rand[::-1]))
    words = lambda xs: np.frombuffer(b"".join(x.to_bytes(32, "little") for x in xs),
                                     np.uint32).copy()
    a, b = words([x for x, _ in pairs]), words([y for _, y in pairs])
    want = [x * y * pow(R, -1, P) % P for x, y in pairs]
    for group in (1, 2, 6):
        r = np.zeros_like(a)
        host_kernels["p256_verify"].host_team_mul(_p(a), _p(b), _p(r), len(pairs), tpi, group)
        got = [int.from_bytes(r[8 * i:8 * i + 8].tobytes(), "little") for i in range(len(pairs))]
        assert got == want


def _stage2(seed, T=96, n_sig=160, S=4):
    rng = np.random.default_rng(seed)
    sv = rng.random(n_sig) < 0.85
    lv = np.zeros((T, 3), np.int32)
    lv[:, 0] = rng.integers(-2, n_sig, T)
    lv[:, 1] = rng.random(T) < 0.95
    lv[:, 2] = rng.random(T) < 0.9
    R, W, Q = 2, 2, 1
    sp = np.full((T, R + W + 2 * Q), -1, np.int32)
    sp[:, :R + W] = rng.integers(-1, 120, (T, R + W))
    for i in range(40):  # a chain across the 32-transaction words
        sp[30 + i, 0], sp[30 + i, R] = 500 + i, 501 + i
        lv[30 + i] = (-2, 1, 1)
    rq = rng.choice(T, 12, replace=False)
    sp[rq, R + W] = rng.integers(0, 110, 12)
    sp[rq, R + W + Q] = sp[rq, R + W] + rng.integers(1, 10, 12)
    groups = []
    for dsl, eb in (("OutOf(2, 'Org1MSP.peer', 'Org2MSP.peer', 'Org3MSP.peer')", 128),
                    ("OutOf(1, 'Org1MSP.peer', 'Org1MSP.member')", 16),
                    ("AND('Org1MSP.member', OR('Org2MSP.peer', 'Org3MSP.peer'))", 32)):
        plan = pol.compile_plan(pol.from_dsl(dsl))
        P = len(plan.principals)
        gp = np.zeros((eb, S * P + S + 1), np.int32)
        idx = np.where(rng.random((eb, S)) < 0.8, rng.integers(0, n_sig, (eb, S)), -1)
        gp[:, :S * P] = (rng.random((eb, S * P)) < 0.4) & np.repeat(idx >= 0, P, axis=1)
        gp[:, S * P:S * P + S] = idx
        gp[:, -1] = rng.integers(-1, T, eb)
        groups.append((plan, gp, eb, S))
    return sv, lv, groups, sp, (R, W, Q)


def _host_stage2(lib, sv, lv, groups, sp, dims, words=None):
    """The fused stage 2 through the host-compiled kernels as the CUDA
    path launches them: every group's frame in one buffer and the
    ``policy_meta`` table, one policy launch, the bitsets (``words``:
    given as (direct, phantom) or computed by the bitsets kernel), the
    fixpoint over the failing entries → (packed out, fail list)."""
    R, W, Q = dims
    T, n_sig = lv.shape[0], sv.shape[0]
    meta, n_cta, smem, n_ent = db.policy_meta([(p, e, s) for p, _, e, s in groups])
    assert smem <= 4 * (1 << 15)  # the host block's shared memory
    frames = (np.concatenate([g.reshape(-1) for _, g, _, _ in groups]) if groups
              else np.zeros(0, np.int32))
    out = np.zeros(5 * T + n_sig + n_ent, np.int8)
    fail = np.full(n_ent, -7, np.int32)  # every entry must be written
    svb = sv.astype(np.uint8)
    safe = out[5 * T + n_sig:]
    lib.host_policy(_p(svb), n_sig, _p(frames), _p(meta), n_cta, T, _p(safe), _p(fail))
    nw = (T + 31) // 32
    if words is None:
        d, ph = np.zeros((T, nw), np.uint32), np.zeros((T, nw), np.uint32)
        lib.host_bitsets(_p(sp), T, R, W, Q, _p(d), _p(ph))
    else:
        d, ph = words
    lib.host_fixpoint(T, _p(d), _p(ph), None, None, _p(lv), _p(svb), n_sig, _p(fail), n_ent,
                      _p(out), 64, 1)
    return out, fail, (d, ph)


def _stage2_want(sv, lv, groups, sp, dims):
    t = torch.from_numpy
    return db.stage2_ref(t(sv), t(lv), [(p, t(g), e, s) for p, g, e, s in groups], t(sp),
                         dims).numpy()


@pytest.mark.parametrize("seed", range(3))
def test_stage2_kernel_sources_match_plain(host_kernels, seed):
    """One policy launch over three groups, the bitsets and the fixpoint
    folding the failing entries, bit-equal to ``stage2_ref``; each
    entry's fail word names its transaction exactly when its verdict is
    false and the transaction is in range."""
    lib = host_kernels["stage2"]
    sv, lv, groups, sp, (R, W, Q) = _stage2(seed)
    T = lv.shape[0]
    t = torch.from_numpy
    want = _stage2_want(sv, lv, groups, sp, (R, W, Q))
    out, fail, (d, ph) = _host_stage2(lib, sv, lv, groups, sp, (R, W, Q))
    assert np.array_equal(out, want)
    assert 0 < want[:T].sum() < T
    oks = [db.policy_reduce_ref(t(sv), t(g), s_, len(p.principals), p)[0].numpy()
           for p, g, _, s_ in groups]
    tx = np.concatenate([g[:, -1] for _, g, _, _ in groups])
    assert np.array_equal(fail, np.where(~np.concatenate(oks) & (tx >= 0) & (tx < T), tx, -1))
    assert (fail >= 0).any()

    # the mvcc_validate entry: per-read prologue + fixpoint in MVCC mode
    rng = np.random.default_rng(100 + seed)
    rk = np.ascontiguousarray(sp[:, :R])
    rp = rng.random((T, R)) < 0.9
    rv = rng.integers(0, 3, (T, R, 2)).astype(np.uint32)
    cp = rp ^ (rng.random((T, R)) < 0.05)
    cv = (rv + (rng.random((T, R, 2)) < 0.05)).astype(np.uint32)
    pre = rng.random(T) < 0.9
    vo = np.zeros(T, np.uint8)
    lib.host_verok(_p(rk), _p(rp.astype(np.uint8)), _p(rv), _p(cp.astype(np.uint8)), _p(cv),
                   T, R, _p(vo))
    o3 = np.zeros(3 * T, np.int8)
    lib.host_fixpoint(T, _p(d), _p(ph), _p(vo), _p(pre.astype(np.uint8)), None, None, 0,
                      None, 0, _p(o3), 64, 1)
    c = lambda a: t(np.ascontiguousarray(a))
    ref = mvcc.mvcc_validate_ref(c(rk), c(rp), c(rv.view(np.int32)), c(cp), c(cv.view(np.int32)),
                                 c(sp[:, R:R + W]), c(sp[:, R + W:R + W + Q]),
                                 c(sp[:, R + W + Q:]), c(pre))
    assert np.array_equal(o3.astype(bool), torch.cat(ref).numpy())


POLICY_DSL = ("OutOf(2, 'Org1MSP.peer', 'Org2MSP.peer', 'Org3MSP.peer')",
              "OutOf(1, 'Org1MSP.peer', 'Org1MSP.member')",
              "AND('Org1MSP.member', OR('Org2MSP.peer', 'Org3MSP.peer'))")


def _policy_case(case, T, seed=7):
    """Stage-2 operands whose MVCC part is empty (no keys: every
    conflict word 0), so that the policy launch decides: ``empty`` (a
    group of no entries between two others), ``tx_range`` (tx_of -1, T
    and past it), ``spread`` (each transaction's entries in all three
    groups, a few failing in one only), ``wide`` (S = 64: 31 entries a
    CTA, a group over several CTAs), ``random`` (three groups)."""
    rng = np.random.default_rng(seed + T)
    n_sig = 2 * T + 40
    sv = rng.random(n_sig) < 0.85
    lv = np.zeros((T, 3), np.int32)
    lv[:, 0] = -2
    lv[:, 1] = lv[:, 2] = 1
    sp = np.full((T, 6), -1, np.int32)
    S = 64 if case == "wide" else 4
    sizes = {"empty": (64, 0, 32), "wide": (100, 16, 40)}.get(case, (128, 16, 32))
    groups = []
    for g, (dsl, eb) in enumerate(zip(POLICY_DSL, sizes)):
        plan = pol.compile_plan(pol.from_dsl(dsl))
        P = len(plan.principals)
        gp = np.zeros((eb, S * P + S + 1), np.int32)
        k = 2 if case == "wide" else S  # slots in use
        idx = np.full((eb, S), -1, np.int32)
        idx[:, :k] = np.where(rng.random((eb, k)) < 0.8, rng.integers(0, n_sig, (eb, k)), -1)
        if case == "wide":
            idx[::3, S - 1] = rng.integers(0, n_sig, len(idx[::3]))  # the last slot too
        gp[:, :S * P] = (rng.random((eb, S * P)) < 0.4) & np.repeat(idx >= 0, P, axis=1)
        gp[:, S * P:S * P + S] = idx
        gp[:, -1] = rng.integers(0, T, eb)
        if case == "tx_range":
            gp[::4, -1] = -1
            gp[1::4, -1] = T
            gp[2::8, -1] = T + 5 + g
        if case == "spread":
            gp[:, -1] = np.arange(eb) % T  # every transaction in every group
        groups.append((plan, gp, eb, S))
    return sv, lv, groups, sp, (2, 2, 1)


@pytest.mark.parametrize("case,T", [("empty", 96), ("tx_range", 96), ("spread", 48),
                                    ("wide", 96), ("random", 1), ("random", 31),
                                    ("random", 33), ("random", 1024)])
def test_policy_kernel_source_at_edges(host_kernels, case, T):
    """One policy launch over every group at its edges: an empty group,
    tx_of of -1 and >= T, one transaction's entries spread across the
    groups, rows wide enough that a CTA stages 31 entries, and T at the
    32-transaction word edges and at a block's 1,024, each bit-equal to
    ``stage2_ref`` through the fixpoint's policy set."""
    lib = host_kernels["stage2"]
    sv, lv, groups, sp, dims = _policy_case(case, T)
    nw = (T + 31) // 32
    zero = (np.zeros((T, nw), np.uint32), np.zeros((T, nw), np.uint32))
    want = _stage2_want(sv, lv, groups, sp, dims)
    out, fail, _ = _host_stage2(lib, sv, lv, groups, sp, dims, words=zero)
    assert np.array_equal(out, want)
    pok = want[4 * T:5 * T]
    if T > 1:
        assert 0 < pok.sum() < T  # some transactions fail their policy, some pass
    assert ((fail >= -1) & (fail < T)).all()
    if case == "spread":
        # a transaction fails when any of its groups' entries fails
        t = torch.from_numpy
        bad = np.zeros(T, bool)
        for p, g, _, s_ in groups:
            ok = db.policy_reduce_ref(t(sv), t(g), s_, len(p.principals), p)[0].numpy()
            bad[g[~ok, -1]] = True
        assert np.array_equal(pok == 0, bad)


def test_policy_table_sizes_match_the_source():
    """The policy kernel's fixed sizes in ``kernels`` are stage2.cu's."""
    from fabric_tpu_torch import kernels

    src = (CSRC / "stage2.cu").read_text()
    for name, value in (("kCtaCols", db.CTA_COLS),
                        ("kPolicyRowBytes", kernels.POLICY_ROW_BYTES),
                        ("kMaxPlanWords", kernels.POLICY_PLAN_WORDS)):
        assert f"constexpr int {name} = {value};" in src
    threads = int(re.search(r"constexpr int kPolicyThreads = (\d+);", src).group(1))
    assert kernels.POLICY_ENTRIES <= threads  # a thread an entry
    # 100 entries of 257-word rows take 4 CTAs (31, 31, 31, 7), an empty
    # group none, 16 entries of 17 words one
    plan = pol.compile_plan(pol.from_dsl(POLICY_DSL[0]))
    meta, n_cta, smem, n = db.policy_meta([(plan, 100, 64), (plan, 0, 4), (plan, 16, 4)])
    vec = db.plan_vector(plan)
    po = [8 * 5, 8 * 5 + len(vec), 8 * 5 + 2 * len(vec)]
    assert (n_cta, smem, n) == (5, 4 * 257 * 31, 116)
    assert meta[:8 * n_cta].reshape(n_cta, 8).tolist() == [
        [0, 31, 64, 3, po[0], len(vec), 0, 0], [31 * 257, 31, 64, 3, po[0], len(vec), 31, 0],
        [62 * 257, 31, 64, 3, po[0], len(vec), 62, 0], [93 * 257, 7, 64, 3, po[0], len(vec), 93, 0],
        [100 * 257, 16, 4, 3, po[2], len(vec), 100, 0]]
    assert meta[8 * n_cta:].tolist() == vec * 3


def _mvcc_operands(seed, T):
    """Random keys, a conflict chain as deep as T allows (crossing the
    32-transaction words), and range reads holding phantoms."""
    rng = np.random.default_rng(seed)
    R, W, Q = 2, 2, 1
    sp = np.full((T, R + W + 2 * Q), -1, np.int32)
    sp[:, :R + W] = rng.integers(-1, max(4, T), (T, R + W))
    depth = min(T - 1, 60)
    for i in range(depth):  # T - 1 - depth .. T - 1: each reads the one before's write
        j = T - depth + i
        sp[j, 0], sp[j - 1, R] = 10_000 + i, 10_000 + i
    nq = max(1, T // 8)
    rq = rng.choice(T, nq, replace=False)
    sp[rq, R + W] = rng.integers(0, max(4, T), nq)
    sp[rq, R + W + Q] = sp[rq, R + W] + rng.integers(1, 12, nq)
    n_sig = 2 * T + 8
    sv = rng.random(n_sig) < 0.9
    lv = np.zeros((T, 3), np.int32)
    lv[:, 0] = rng.integers(-2, n_sig, T)
    lv[:, 1] = rng.random(T) < 0.95
    lv[:, 2] = rng.random(T) < 0.9
    lv[T - depth - 1:, :] = (-2, 1, 1)  # the chain starts valid
    pok = (rng.random(T + 1) < 0.95).astype(np.int32)
    return sp, (R, W, Q), sv, lv, pok


def _words_of(rel):
    """[T, T] bool → [T, ceil(T/32)] uint32, bit i % 32 of word i // 32."""
    T = rel.shape[0]
    pad = np.zeros((T, -(-T // 32) * 32), bool)
    pad[:, :T] = rel
    return np.packbits(pad.reshape(T, -1, 32)[..., ::-1], axis=-1,
                       bitorder="big").view(">u4").astype(np.uint32).reshape(T, -1)


@pytest.mark.parametrize("T", [1, 31, 33, 160])
@pytest.mark.parametrize("in_smem", [1, 0])
def test_mvcc_kernel_sources_match_plain_at_word_edges(host_kernels, T, in_smem):
    """The warp-ballot bitsets and the fixpoint (direct | phantom staged
    in shared memory, or read from global memory in each round) at T on
    each side of a 32-transaction word and past a 64-thread block, with a
    chain up to 60 deep; stage-2 and MVCC modes, bit-equal to the plain
    relations and fixpoint."""
    lib = host_kernels["stage2"]
    sp, (R, W, Q), sv, lv, pok = _mvcc_operands(T, T)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    direct, phantom = mvcc._relations(t(sp[:, :R]), t(sp[:, R:R + W]), t(sp[:, R + W:R + W + Q]),
                                      t(sp[:, R + W + Q:]))
    nw = (T + 31) // 32
    d, ph = np.zeros((T, nw), np.uint32), np.zeros((T, nw), np.uint32)
    lib.host_bitsets(_p(sp), T, R, W, Q, _p(d), _p(ph))
    assert np.array_equal(d, _words_of(direct.numpy()))
    assert np.array_equal(ph, _words_of(phantom.numpy()))
    threads = min(64, nw * 32)

    n_sig = len(sv)
    out = np.zeros(5 * T + n_sig, np.int8)
    svb = sv.astype(np.uint8)
    # the policy verdicts as the policy kernel hands them over: the
    # failing transactions, some twice, among -1 words
    fail = np.concatenate([np.flatnonzero(pok[:T] == 0), np.flatnonzero(pok[:T] == 0)[:3],
                           [-1, -1]]).astype(np.int32)
    np.random.default_rng(T).shuffle(fail)
    lib.host_fixpoint(T, _p(d), _p(ph), None, None, _p(lv), _p(svb), n_sig, _p(fail), len(fail),
                      _p(out), threads, in_smem)
    cok = db.creator_ok_ref(t(sv), t(lv[:, 0])).numpy()
    pre = (lv[:, 1] != 0) & cok & (pok[:T] != 0)
    v, c, p_ = mvcc._fixpoint(direct, phantom, t((lv[:, 2] != 0) & pre))
    want = np.concatenate([v, c, p_, cok, pok[:T] != 0, sv]).astype(np.int8)
    assert np.array_equal(out, want)

    vo = (lv[:, 2] != 0).astype(np.uint8)
    pre8 = pre.astype(np.uint8)
    o3 = np.zeros(3 * T, np.int8)
    lib.host_fixpoint(T, _p(d), _p(ph), _p(vo), _p(pre8), None, None, 0, None, 0, _p(o3),
                      threads, in_smem)
    ref = mvcc.mvcc_validate_hostver_ref(t(sp[:, :R]), t(vo != 0), t(sp[:, R:R + W]),
                                         t(sp[:, R + W:R + W + Q]), t(sp[:, R + W + Q:]),
                                         t(pre))
    assert np.array_equal(o3.astype(bool), torch.cat(ref).numpy())
    if T > 64:
        assert 0 < v.sum() < T and c.any() and p_.any()


def _sign_nonces():
    """Today's edge nonces, nonces whose digits all lie in one chain at
    every C (one nonzero digit, or a few adjacent ones), chains of
    all-15 digits, and random nonces: 27 lanes, so the last block of
    every C below 8 has masked lanes."""
    N = ec_ref.N
    rng = np.random.default_rng(11)
    ks = [1, 2, N - 1, N - 2, 16, 16 ** 63, 0x0F << 200, (1 << 255) | 1]
    ks += [0x9 << 128, 0xABCD << 132, 7 << 252]  # all chains zero but one
    ks += [0xFFFFFFFF << 224, (1 << 128) - 1, (1 << 16) - 1, 0xFFFF << 64]  # all-15 runs
    ks += [int.from_bytes(rng.bytes(32), "big") % (N - 1) + 1 for _ in range(12)]
    return ks


@pytest.mark.parametrize("tpi", [8, 4])
@pytest.mark.parametrize("chains", [1, 2, 8, 16])
def test_sign_kernel_source_matches_plain_and_oracle(host_kernels, tpi, chains):
    """The team sign kernel, one std::thread per CUDA thread, bit-equal to
    ``sign_batch_ref`` at the same chain count, and X / Z equal to the
    affine x of k·G from ``ec_ref``; the batch is not padded, so the
    last block's spare teams run the last row with their stores masked."""
    ks = _sign_nonces()
    limbs = v3._limbs16(ks)
    consts, comb = (t.numpy().view(np.uint32)
                    for t in p256sign._kernel_tables(torch.device("cpu")))
    out = np.zeros((len(limbs), 2, 8), np.uint32)
    host_kernels["p256_sign"].host_sign(_p(limbs), len(limbs), chains, _p(consts), _p(comb),
                                        _p(out), tpi, 4)
    plain = p256sign.sign_batch_ref(torch.from_numpy(limbs), chains=chains)
    assert np.array_equal(out, plain.numpy().view(np.uint32))
    xs, zs = p256sign._to_ints(out[:, 0]), p256sign._to_ints(out[:, 1])
    for k, X, Z in zip(ks, xs, zs):
        assert X * pow(Z, -1, ec_ref.P) % ec_ref.P == ec_ref.pt_mul(k, ec_ref.G)[0]


def _resident_operands(seed, T=64, R=2, U=40, cap=32, bad=0.1):
    rng = np.random.default_rng(seed)
    Ub = 64
    sp = np.full((T, R + 2 + 2), -1, np.int32)
    sp[:, :R] = np.where(rng.random((T, R)) < 0.85, rng.integers(0, U, (T, R)), -1)
    sp[:4, 0] = [U, Ub, Ub + 5, U + 3]  # ids past the pack read an absent row
    table = rng.integers(-2, 3, (cap, 3)).astype(np.int32)
    table[:, 0] = rng.random(cap) < 0.8
    u_pack = np.zeros((Ub, 4), np.int32)
    u_pack[:, 0] = np.where(rng.random(Ub) < 0.6, rng.integers(0, cap, Ub), -1)
    u_pack[5, 0] = cap + 7  # a slot past the table clamps to its last row
    u_pack[:, 1] = rng.random(Ub) < 0.8
    u_pack[:, 2:4] = rng.integers(-2, 3, (Ub, 2))
    read_pv = np.zeros((T, R, 3), np.int32)
    ids = np.clip(sp[:, :R], 0, Ub - 1)
    slot = u_pack[ids, 0]
    row = np.where((slot >= 0)[..., None], table[np.clip(slot, 0, cap - 1)],
                   u_pack[ids, 1:4])
    read_pv[:] = row  # mostly matching reads ...
    flip = rng.random((T, R)) < bad
    read_pv[flip, 0] ^= 1  # ... some with presence flipped ...
    bump = rng.random((T, R)) < bad
    read_pv[bump, 2] += 1  # ... some stale
    return sp, table, u_pack, read_pv, R


@pytest.mark.parametrize("seed", range(3))
def test_resident_kernel_sources_match_plain(host_kernels, seed):
    lib = host_kernels["resident"]
    sp, table, u_pack, read_pv, R = _resident_operands(seed)
    T = sp.shape[0]
    t = torch.from_numpy
    want = db.resident_ver_ok_ref(t(sp), t(table), t(u_pack), t(read_pv), R).numpy()
    lv = np.zeros((T, 3), np.int32)
    lib.host_verok(_p(sp), T, sp.shape[1], R, _p(table), table.shape[0], _p(u_pack),
                   u_pack.shape[0], _p(read_pv), _p(lv))
    assert np.array_equal(lv[:, 2].astype(bool), want)
    assert 0 < want.sum() < T

    rng = np.random.default_rng(50 + seed)
    k = 20
    idx = rng.choice(table.shape[0], k, replace=False).astype(np.int32)
    rows = rng.integers(-5, 5, (k, 3)).astype(np.int32)
    got = table.copy()
    lib.host_scatter(_p(got), _p(idx), _p(rows), k)
    ref = t(table.copy())
    residency.table_scatter(ref, idx, rows)
    assert np.array_equal(got, ref.numpy())


@pytest.mark.parametrize("R", [1, 2, 3, 5, 40])
def test_resident_kernel_source_at_read_counts(host_kernels, R):
    """A thread per (transaction, read): R = 1, 2, 3 and 5 (lanes padded
    to 1, 2, 4 and 8, so a 256-thread block holds 256, 128, 64 and 32
    transactions) and 40 (a warp a transaction, lanes walking reads j
    and j + 32), each against the plain version, with a transaction
    failing on its last read alone."""
    lib = host_kernels["resident"]
    sp, table, u_pack, read_pv, _ = _resident_operands(11 + R, T=70, R=R, bad=0.2 / R)
    T = sp.shape[0]
    # tx 5 reads R real keys, every one as committed but the last, whose
    # presence is flipped
    sp[5, :R] = np.arange(R) % 40
    slot = u_pack[sp[5, :R], 0]
    read_pv[5] = np.where((slot >= 0)[:, None], table[np.clip(slot, 0, table.shape[0] - 1)],
                          u_pack[sp[5, :R], 1:4])
    read_pv[5, R - 1, 0] ^= 1
    t = torch.from_numpy
    want = db.resident_ver_ok_ref(t(sp), t(table), t(u_pack), t(read_pv), R).numpy()
    lv = np.full((T, 3), 7, np.int32)
    lib.host_verok(_p(sp), T, sp.shape[1], R, _p(table), table.shape[0], _p(u_pack),
                   u_pack.shape[0], _p(read_pv), _p(lv))
    assert np.array_equal(lv[:, 2].astype(bool), want)
    assert set(np.unique(lv[:, 2])) <= {0, 1} and (lv[:, :2] == 7).all()
    assert not want[5]
    assert 0 < want.sum() < T


def test_sha256_kernel_source_matches_hashlib(host_kernels):
    rng = np.random.default_rng(8)
    lengths = [0, 55, 56, 63, 64, 119, 120, 200, *rng.integers(0, 8 * 64 - 9, 40).tolist()]
    msgs = [rng.bytes(int(n)) for n in lengths]
    blocks, nb = psha.pad_messages(msgs, max_blocks=8)
    nb[-1] = 0  # no block: the initial state
    out = np.zeros((len(msgs), 8), np.uint32)
    host_kernels["sha256"].host_sha256(_p(blocks), _p(nb), len(msgs), 8, _p(out))
    plain = psha.sha256_blocks(torch.from_numpy(blocks.view(np.int32)), torch.from_numpy(nb))
    assert np.array_equal(out, plain.numpy().view(np.uint32))
    want = [hashlib.sha256(m).digest() for m in msgs[:-1]]
    assert psha.digests_to_bytes(out)[:-1] == want
    assert out[-1].tolist() == psha.H0.tolist()


def _sha_check(lib, msgs, M, zero=()):
    """``msgs`` padded to M blocks, the rows in ``zero`` given no block,
    through the kernel's CTAs (producer and consumer warps, their
    barriers) → equal to ``sha256_blocks_ref`` and to hashlib."""
    blocks, nb = psha.pad_messages(msgs, max_blocks=M)
    nb[list(zero)] = 0
    out = np.zeros((len(msgs), 8), np.uint32)
    lib.host_sha256(_p(blocks), _p(nb), len(msgs), M, _p(out))
    plain = psha.sha256_blocks_ref(torch.from_numpy(blocks.view(np.int32)), torch.from_numpy(nb))
    assert np.array_equal(out, plain.numpy().view(np.uint32))
    want = [psha.H0.astype(">u4").tobytes() if i in zero else hashlib.sha256(m).digest()
            for i, m in enumerate(msgs)]
    assert psha.digests_to_bytes(out) == want


# messages a CTA of sha256.cu (kMsgs: two consumer warps)
SHA_CTA_MSGS = 64


def _block_messages(n_tx, rng):
    """A commit block's signed messages, tx by tx: the envelope payload
    (3,285 B, 52 blocks) and two endorsement messages (837 B, 14)."""
    return [rng.bytes(n) for _ in range(n_tx) for n in (3285, 837, 837)]


@pytest.mark.parametrize("case", ["partial_cta", "mixed_52_14", "zero_rows", "one_message",
                                  "mixed_over_ctas"])
def test_sha256_kernel_cta_cases(host_kernels, case):
    """The kernel's CTAs: a batch whose last CTA is not full, a warp
    mixing 52- and 14-block messages at M = 64 (a commit block's), rows
    with no block (one a whole warp's first lane, one its last), B = 1,
    and a commit block's messages among short ones over two CTAs and a
    partial third, rows with no block among them."""
    lib = host_kernels["sha256"]
    rng = np.random.default_rng(21)
    if case == "partial_cta":
        msgs = [rng.bytes(int(n)) for n in rng.integers(0, 8 * 64 - 9, SHA_CTA_MSGS + 37)]
        _sha_check(lib, msgs, 8)
    elif case == "mixed_52_14":
        msgs = _block_messages(11, rng)
        assert {(len(m) + 8) // 64 + 1 for m in msgs} == {52, 14}
        _sha_check(lib, msgs, 64)
    elif case == "zero_rows":
        msgs = [rng.bytes(int(n)) for n in rng.integers(0, 3 * 64 - 9, 70)]
        _sha_check(lib, msgs, 4, zero=(0, 5, 31, 32, 63, 69))
    elif case == "one_message":
        _sha_check(lib, [b"abc"], 1)
    else:
        msgs = _block_messages(4, rng)
        msgs += [rng.bytes(int(n)) for n in rng.integers(0, 200, 2 * SHA_CTA_MSGS - len(msgs) + 3)]
        _sha_check(lib, msgs, 64, zero=(1, SHA_CTA_MSGS, len(msgs) - 1))


def _v1_v2_items():
    """Lanes of every kind for the comparison verifiers, Q = +-G included."""
    items = _items(40, seed=4)
    e = 0x1234567
    items += [(e, *ec_ref.SigningKey(d=1).sign_digest(e), ec_ref.GX, ec_ref.GY)]
    neg = ec_ref.SigningKey(d=ec_ref.N - 1)
    items += [(e ^ 1, *neg.sign_digest(e ^ 1), *neg.public)]
    return items


def _words(vals):
    return np.frombuffer(b"".join(int(v).to_bytes(32, "little") for v in vals), np.uint32).copy()


def _ints(words):
    return [int.from_bytes(words[8 * i:8 * i + 8].tobytes(), "little")
            for i in range(len(words) // 8)]


@pytest.mark.parametrize("tpi", [8, 4])
def test_v1_kernel_source_matches_plain_and_oracle(host_kernels, tpi):
    """The team kernel on every kind, Q = G and Q = -G included, 44 lanes
    (the last a padding lane), so the last block runs spare teams."""
    items = _v1_v2_items()
    frame = v1.stage_frame(items, len(items) + 1)
    consts = v1.kernel_consts(torch.device("cpu")).numpy().view(np.uint32)
    out = np.zeros(len(frame), np.uint8)
    host_kernels["p256_v1"].host_v1(_p(frame), len(frame), _p(consts), _p(out), tpi, 2)
    plain = v1.verify_batch_v1_ref(torch.from_numpy(frame)).numpy()
    assert np.array_equal(out.astype(bool), plain)
    want = [ec_ref.verify_digest((x, y), e, r, s) for e, r, s, x, y in items]
    assert out[:len(items)].astype(bool).tolist() == want
    assert want[-2:] == [True, True] and any(want) and not all(want)


@pytest.mark.parametrize("tpi", [8, 4])
def test_v1_ladder_step_matches_oracle(host_kernels, tpi):
    """acc = 2 acc + t from the team's jac_double and jac_add, all cases in
    one launch: acc or t or both at infinity, 2 acc = t (the doubling
    case, in a warp where no other team takes it), 2 acc = -t (infinity)
    and random points."""
    P, R = ec_ref.P, 1 << 256
    rng = np.random.default_rng(12)
    q = ec_ref.pt_mul(99991, ec_ref.G)
    q2 = ec_ref.pt_double(q)
    cases = [(None, q), (q, None), (None, None), (q, q2), (q, (q2[0], P - q2[1]))]
    for _ in range(6):
        ks = [int(x) for x in rng.integers(1, 1 << 62, 2)]
        cases.append((ec_ref.pt_mul(ks[0], ec_ref.G), ec_ref.pt_mul(ks[1], ec_ref.G)))

    def jac(pt):
        if pt is None:
            return [0, 0, 0]
        z = int(rng.integers(2, 1 << 62))
        return [pt[0] * z * z % P * R % P, pt[1] * z ** 3 % P * R % P, z * R % P]

    acc = _words([v for a, _ in cases for v in jac(a)])
    t = _words([v for _, b in cases for v in jac(b)])
    out = np.zeros_like(acc)
    host_kernels["p256_v1"].host_v1_step(_p(acc), _p(t), _p(out), len(cases), tpi)
    vals = _ints(out)
    for i, (a, b) in enumerate(cases):
        X, Y, Z = (v * pow(R, -1, P) % P for v in vals[3 * i:3 * i + 3])
        got = None if Z == 0 else (X * pow(Z, -2, P) % P, Y * pow(Z, -3, P) % P)
        assert got == ec_ref.pt_add(ec_ref.pt_double(a), b), i


@pytest.mark.parametrize("tpi", [8, 4])
def test_v1_mod_n_product_matches_python_ints(host_kernels, tpi):
    """The team's Montgomery product mod n (rank 0's multipliers, n's
    limbs as real products) at 0, 1, n - 1, n - 2, 2^255 mod n, R mod n,
    R^2 mod n and random values."""
    N, R = ec_ref.N, 1 << 256
    rng = np.random.default_rng(15)
    edge = [0, 1, N - 1, N - 2, (1 << 255) % N, R % N, R * R % N]
    rand = [int.from_bytes(rng.bytes(32), "big") % N for _ in range(24)]
    pairs = [(a, b) for a in edge for b in edge] + list(zip(rand, rand[::-1]))
    a, b = _words([x for x, _ in pairs]), _words([y for _, y in pairs])
    r = np.zeros_like(a)
    host_kernels["p256_v1"].host_fn_mul(_p(a), _p(b), _p(_words([N])), _p(r), len(pairs), tpi)
    assert _ints(r) == [x * y * pow(R, -1, N) % N for x, y in pairs]


@pytest.mark.parametrize("mod", ["p", "n"])
def test_v2_digit_product_and_settle_match_python_ints(host_kernels, mod):
    """The team product (convolution across the team, the int8 chunk
    reduction through the tensor-core tiles, the team settle) and the
    team settle alone, digit for digit against ``DigitMod.mul`` and
    ``settle``, at the largest legal magnitudes (|a| = |b| = 624, inputs
    to settle up to 2^24 - 1), with carries crossing every rank
    boundary; 20 lanes, so the second block runs 12 spare lanes.  The
    padding digits 43..47 stay zero."""
    dm = v2.MODP if mod == "p" else v2.MODN
    lib = host_kernels["p256_v2"]
    consts = v2.kernel_consts(torch.device("cpu")).numpy()
    side = v2.MAX_SIDE
    rng = np.random.default_rng(13)
    rows = [np.full(dg.K, side), np.full(dg.K, -side),
            np.array([side if i % 2 else -side for i in range(dg.K)]),
            np.array([(-1) ** i * (side - i) for i in range(dg.K)])]
    rows += [rng.integers(-side, side + 1, dg.K) for _ in range(16)]
    a = np.ascontiguousarray(np.stack(rows), np.int32)
    b = np.ascontiguousarray(a[::-1], np.int32)
    out = np.zeros((len(a), 48), np.int32)
    lib.host_v2_op(_p(consts), int(mod == "n"), 0, _p(a), _p(b), _p(out), len(a))
    assert not out[:, dg.K:].any()
    out = out[:, :dg.K]
    assert np.abs(out).max() <= dg.SETTLED_MAX
    for o, x, y in zip(out, a, b):
        assert dg.digits_to_int(o) % dm.m == dg.digits_to_int(x) * dg.digits_to_int(y) % dm.m
    assert np.array_equal(out, dm.mul(torch.from_numpy(a).long(), torch.from_numpy(b).long()))
    t = np.ascontiguousarray(rng.integers(-(1 << 24) + 1, 1 << 24, (20, dg.K)), np.int32)
    t[0], t[1] = (1 << 24) - 1, -(1 << 24) + 1
    t[2] = [(1 << 24) - 1 if i % 2 else 63 for i in range(dg.K)]
    st = np.zeros((len(t), 48), np.int32)
    lib.host_v2_op(_p(consts), int(mod == "n"), 1, _p(t), _p(t), _p(st), len(t))
    assert not st[:, dg.K:].any()
    st = st[:, :dg.K]
    assert np.abs(st).max() <= dg.SETTLED_MAX
    assert [dg.digits_to_int(r) % dm.m for r in st] == [dg.digits_to_int(r) % dm.m for r in t]
    assert np.array_equal(st, dm.settle(torch.from_numpy(t).long()))


def test_v2_kernel_source_matches_plain_and_oracle(host_kernels):
    """The team kernel on 32 lanes of every kind (two blocks of 16), Q = G
    and Q = -G included."""
    items = _v1_v2_items()[:30] + _v1_v2_items()[-2:]
    frame = v2.stage_frame(items, v2.bucket(len(items)))
    consts = v2.kernel_consts(torch.device("cpu")).numpy()
    out = np.zeros(len(frame), np.uint8)
    host_kernels["p256_v2"].host_v2(_p(frame), len(frame), _p(consts), _p(out), 2)
    plain = v2.verify_batch_v2_ref(torch.from_numpy(frame)).numpy()
    assert np.array_equal(out.astype(bool), plain)
    want = [ec_ref.verify_digest((x, y), e, r, s) for e, r, s, x, y in items]
    assert out[:len(items)].astype(bool).tolist() == want
    assert want[-2:] == [True, True] and any(want) and not all(want)
