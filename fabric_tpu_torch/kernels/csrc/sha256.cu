// Batched SHA-256 over pre-padded messages, the schedule and the rounds
// on separate warps.
//
// Replaces fabric_tpu/ops/sha256.py::sha256_blocks (with _compress):
// blocks [B, M, 16] big-endian 32-bit words (held in int32, read as
// uint32), nblocks [B] -> digests [B, 8].  Message i runs the
// compression over its first min(nblocks[i], M) blocks (none when that
// is 0 or less: the initial state).
//
// The operation count, the one every bound of this kernel uses: 1,384
// INT32 instructions a compression at the ISA level, where a 3-input
// logical op (LOP3) or a 3-input add (IADD3) is one and a rotation is
// one funnel shift (SHF):
//   schedule  48 x 10: sigma0 and sigma1 of 2 rotations + 1 shift + 1
//             LOP3 each, then W[t-16] + s0 + W[t-7] + s1 in 2 IADD3;
//   rounds    64 x 14: Sigma1 and Sigma0 of 3 rotations + 1 LOP3 each,
//             Ch 1 LOP3, Maj 1 LOP3, T1 = h + Sigma1 + Ch + K + W in 2
//             IADD3, e = d + T1 1, a = T1 + Sigma0 + Maj 1 IADD3;
//   and the 8 adds of the state at the end.
// Of these, 1,024 are SHF or LOP3 (rounds 64 x 10, schedule 48 x 8) and
// run only on a sub-partition's INT32 pipe; the other 360 are adds,
// which run there or, as IMADs, on its FMA pipe.  Each pipe does 16
// lanes a cycle, and a sub-partition issues one warp instruction (32
// lanes) a cycle, so the card's peak for this mix is 16.7 T op/s
// (132 SMs x 64 x 1.98 GHz) for the SHF and LOP3 and 33.4 T op/s for
// all 1,384 together.  A compression's least time is the larger of
// 1,024 / 16.7 T and 1,384 / 33.4 T: the first, 61 ps.  The bound at
// 4,096 messages x 200 B (4 compressions each): 16,384 compressions,
// 1.00 us (bytes 1.2 MB, 0.36 us); at a 1,000-tx commit block's ~3,000
// signed messages (an envelope payload of 52 compressions and two
// endorsement messages of 14 each a tx): ~80,000 compressions, 4.9 us
// (bytes 5.1 MB, 1.5 us).
//
// What bounds it is the chain, not the bound: a message's compressions
// depend on each other, and so do a compression's 64 rounds.  At these
// shapes there are far fewer messages (128 or ~94 warps of one thread
// a message) than the card's 528 SM sub-partitions, so every warp runs
// alone on its sub-partition, and the kernel takes as long as one warp
// takes for its longest message.  On Hopper a sub-partition's INT32
// pipe (LOP3, SHF, IADD3) and its FMA pipe (IMAD) have 16 lanes each, so
// a warp's instruction holds its pipe two cycles: the kernel gets faster
// only if that warp issues fewer instructions a compression, spreads
// them over both pipes, and waits less between them.  The chain floor:
// a warp's issue cycles a compression (max of 2 x INT32, 2 x FMA, all
// instructions) times the longest message's compressions.
//
// The first design (one thread a message doing everything) lost time
// five ways, and this one answers each:
// - One warp issued a message's schedule (48 x 10) and its rounds (64 x
//   14) on one sub-partition: 1,270 INT32 instructions a compression,
//   2,540 issue cycles (its SASS).  Here a PRODUCER warp computes the
//   schedule and writes W[t] + K[t] for all 64 rounds of a block into a
//   shared-memory ring, and a CONSUMER warp (a thread a message) runs
//   only the rounds, reading W + K four rounds at a time with one
//   16-byte load (a warp's 512 contiguous bytes, no bank conflict).
//   Each CTA holds two consumer warps and then two producer warps, so
//   that the four sit on the SM's four sub-partitions, one warp each.
//   Producer warp p feeds consumer warp p: it is busy about as long a
//   block as its consumer, so one feeding two, or sharing a
//   sub-partition with a consumer, halves the pace (measured on the
//   card, 2.5x and 1.5x the time at a commit block's messages).
// - A round's sums went to the INT32 pipe beside its 10 logical
//   instructions (6 SHF, 4 LOP3), and the new e waited four dependent
//   instructions on the old.  Here every add is an IMAD (x * one + y):
//   a round is 6 SHF, 4 LOP3 and 8 IMAD, 1,190
//   instructions and 1,302 issue cycles a compression with the wait,
//   the loads and the state's select, and d + h + W + K and Ch are
//   summed while Sigma1 is computed, so the new e (and the new a) is
//   three dependent instructions after the old.  The schedule's sums
//   too: 648 instructions, 768 issue cycles a block.
// - Each compression began with 16 loads of its block, neighbouring
//   lanes M x 64 B apart, and round 0 waited for them.  Here the
//   producer stages a block with asynchronous copies (cp.async) of 16 B
//   a lane, four lanes on a message's 64 contiguous bytes, one step
//   ahead of the block it expands, which in turn runs up to kSlots
//   blocks ahead of the consumer: the loads leave the chain but for the
//   first block's.
// - The ring's slots hand over through mbarriers, "full" (the
//   producer's 32 lanes arrive after writing a slot) and "empty" (the
//   consumer's 32 lanes arrive after reading it), waited on by phase
//   parity, one wait a block on each side: every wait or arrival ends a
//   stretch the compiler can schedule and costs its latency, so a slot
//   is published whole, not by quarters.  No CTA-wide barrier after
//   the set-up.
// - 128-thread CTAs of one role put 32 CTAs on 32 SMs at 4,096
//   messages; here 64 messages a CTA make 64 CTAs of four warps.  A
//   warp still runs to its longest message, and every lane runs every
//   block's rounds, keeping the result only while its message has the
//   block: a lane past its count on a path of its own (its own wait, or
//   skipped rounds) splits the warp into two paths run in turn, which
//   cost a commit block's mixed warps a quarter of their time.
// The eight state words leave as two 16-byte stores (one 32-byte
// sector) a message.  A second body of round code in the consumer (the
// first block computed by the consumer itself, or by quarters) slowed
// its loop by a fifth to a third on the card with the same work a
// block, and rolling the loops lost more than it saved: the loops stay
// one body each, unrolled in full.

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kConsumers = 2;                  // consumer warps a CTA, and producer warps
constexpr int kThreads = 32 * 2 * kConsumers;  // 128
constexpr int kMsgs = 32 * kConsumers;         // messages a CTA
constexpr int kSlots = 2;                      // ring slots a consumer warp
constexpr int kStride = 20;  // a staged block's words, padded: a warp's 16-byte reads hit every bank
constexpr unsigned kFull = 0xFFFFFFFFu;
// dynamic shared memory in 32-bit words: the mbarriers (full, then
// empty, one 8-byte word each per consumer warp and slot), the W + K
// ring ([kConsumers][kSlots][16][32] uint4: 64 words a message a slot),
// the staging ([kConsumers][2 steps][32 messages][kStride])
constexpr int kBarWords = ((2 * 2 * kConsumers * kSlots) + 3) & ~3;
constexpr int kRingWords = kConsumers * kSlots * 64 * 32;
constexpr int kStageWords = kConsumers * 2 * 32 * kStride;
constexpr int kSmemBytes = 4 * (kBarWords + kRingWords + kStageWords);  // 43,072
static_assert(kSmemBytes <= 48 * 1024, "launched without opting in to more shared memory");

__constant__ uint32_t kK[64] = {
    0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu, 0x59F111F1u,
    0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u, 0x243185BEu, 0x550C7DC3u,
    0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u, 0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u,
    0x0FC19DC6u, 0x240CA1CCu, 0x2DE92C6Fu, 0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu,
    0x983E5152u, 0xA831C66Du, 0xB00327C8u, 0xBF597FC7u, 0xC6E00BF3u, 0xD5A79147u,
    0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu, 0x53380D13u,
    0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u, 0xA2BFE8A1u, 0xA81A664Bu,
    0xC24B8B70u, 0xC76C51A3u, 0xD192E819u, 0xD6990624u, 0xF40E3585u, 0x106AA070u,
    0x19A4C116u, 0x1E376C08u, 0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au,
    0x5B9CCA4Fu, 0x682E6FF3u, 0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u,
    0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u, 0xC67178F2u};

#ifndef FAB_HOST_SHIM
// the mbarrier operations (a host build of this code brings its own)
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(smem_addr(bar))
      : "memory");
}
// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
#endif

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

__device__ __forceinline__ int msg_blocks(const int32_t* __restrict__ nblocks, int i, int B,
                                          int M) {
  return i < B ? min(max(nblocks[i], 0), M) : 0;
}

// x + y as x * one + y (one = 1, a kernel argument the compiler cannot
// fold): one IMAD, on the FMA pipe, instead of the INT32 pipe
__device__ __forceinline__ uint32_t add(uint32_t x, uint32_t y, uint32_t one) {
  return x * one + y;
}

// one round; the callers rotate the names, so that only d and h change
__device__ __forceinline__ void sha_round(uint32_t a, uint32_t b, uint32_t c, uint32_t& d,
                                          uint32_t e, uint32_t f, uint32_t g, uint32_t& h,
                                          uint32_t wk, uint32_t one) {
  const uint32_t s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
  const uint32_t ch = (e & f) ^ (~e & g);
  const uint32_t s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
  const uint32_t maj = (a & b) | (c & (a | b));
  // every add an IMAD, ordered so that the new e is three dependent
  // instructions after e (d + h + W + K and Ch are ready before Sigma1)
  // and the new a three after a
  const uint32_t hw = add(h, wk, one);
  const uint32_t t1 = add(add(hw, ch, one), s1, one);
  d = add(add(add(d, hw, one), ch, one), s1, one);
  h = add(add(t1, maj, one), s0, one);
}

// the 64 rounds of one block on the state; wk: this lane's W + K, four
// rounds a uint4, the lanes' uint4s side by side
__device__ __forceinline__ void rounds(uint32_t st[8], const uint4* __restrict__ wk,
                                       uint32_t one) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int q = 0; q < 16; q += 2) {
    const uint4 u = wk[q * 32], v = wk[(q + 1) * 32];
    sha_round(a, b, c, d, e, f, g, h, u.x, one);
    sha_round(h, a, b, c, d, e, f, g, u.y, one);
    sha_round(g, h, a, b, c, d, e, f, u.z, one);
    sha_round(f, g, h, a, b, c, d, e, u.w, one);
    sha_round(e, f, g, h, a, b, c, d, v.x, one);
    sha_round(d, e, f, g, h, a, b, c, v.y, one);
    sha_round(c, d, e, f, g, h, a, b, v.z, one);
    sha_round(b, c, d, e, f, g, h, a, v.w, one);
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

// W[t] for 16 <= t < 64 in place in the rolling window w
__device__ __forceinline__ void expand(uint32_t w[16], int t, uint32_t one) {
  const uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
  const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
  const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
  // W[t-2] -> s1 -> one add: the chain's step
  w[t & 15] = add(add(add(w[t & 15], s0, one), w[(t - 7) & 15], one), s1, one);
}

// the schedule of one block: w holds its 16 words; writes W[t] + K[t]
// for t < 64 to dst, four rounds a uint4, the lanes' uint4s side by side
__device__ __forceinline__ void schedule(uint32_t w[16], uint4* __restrict__ dst,
                                         uint32_t one) {
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    uint32_t x[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = 4 * q + r;
      if (t >= 16) expand(w, t, one);
      x[r] = add(w[t & 15], kK[t], one);
    }
    dst[q * 32] = make_uint4(x[0], x[1], x[2], x[3]);
  }
}

__global__ void __launch_bounds__(kThreads)
    sha256_blocks_kernel(const uint32_t* __restrict__ blocks, const int32_t* __restrict__ nblocks,
                         int B, int M, uint32_t* __restrict__ out, uint32_t one) {
  extern __shared__ __align__(16) uint32_t sha_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(sha_smem);  // [kConsumers][kSlots]
  uint64_t* empty = full + kConsumers * kSlots;
  uint4* ring = reinterpret_cast<uint4*>(sha_smem + kBarWords);
  uint32_t* staging = sha_smem + kBarWords + kRingWords;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int j = 0; j < kConsumers * kSlots; ++j) {
      bar_init(full + j, 32);
      bar_init(empty + j, 32);
    }
    bar_init_fence();
  }
  __syncthreads();
  const int first = blockIdx.x * kMsgs;  // the CTA's first message

  if (warp < kConsumers) {
    // a consumer: the rounds of message i, block after block
    const int i = first + warp * 32 + lane;
    const int nb = msg_blocks(nblocks, i, B, M);
    const int steps = __reduce_max_sync(kFull, nb);
    uint32_t st[8] = {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
                      0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u};
    const uint4* wk = ring + warp * kSlots * 512 + lane;
    for (int k = 0; k < steps; ++k) {
      const int s = k % kSlots;
      bar_wait(full + warp * kSlots + s, (k / kSlots) & 1);
      // every lane runs the rounds (no divergent path) on a copy of its
      // state, and keeps it while its message has block k
      uint32_t x[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = st[j];
      rounds(x, wk + s * 512, one);
      const bool live = k < nb;
#pragma unroll
      for (int j = 0; j < 8; ++j) st[j] = live ? x[j] : st[j];
      bar_arrive(empty + warp * kSlots + s);
    }
    if (i < B) {
      uint4* o = reinterpret_cast<uint4*>(out + (size_t)i * 8);
      o[0] = make_uint4(st[0], st[1], st[2], st[3]);
      o[1] = make_uint4(st[4], st[5], st[6], st[7]);
    }
    return;
  }

  // producer warp p: stages and expands the blocks of consumer warp p
  const int p = warp - kConsumers;
  uint32_t* stage = staging + p * 2 * 32 * kStride;
  const size_t base = (size_t)first + p * 32;  // the fed warp's first message
  const int nb = msg_blocks(nblocks, first + p * 32 + lane, B, M);
  const int steps = __reduce_max_sync(kFull, nb);
  // block k of every fed message that has one, into staging half k & 1:
  // lane l copies 16 bytes, chunk l % 4 of message 8j + l / 4
  auto stage_block = [&](int k) {
    uint32_t* dst = stage + (k & 1) * 32 * kStride;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = 8 * j + (lane >> 2), c = 4 * (lane & 3);
      if (k < __shfl_sync(kFull, nb, m))
        __pipeline_memcpy_async(dst + m * kStride + c, blocks + ((base + m) * M + k) * 16 + c,
                                16);
    }
    __pipeline_commit();
  };
  if (steps > 0) stage_block(0);
  for (int k = 0; k < steps; ++k) {
    if (k + 1 < steps) stage_block(k + 1);
    else __pipeline_commit();
    __pipeline_wait_prior(1);  // this lane's copies of block k
    __syncwarp();              // ... and every lane's
    const int s = k % kSlots;
    uint32_t w[16];
    const uint4* row = reinterpret_cast<const uint4*>(stage + ((k & 1) * 32 + lane) * kStride);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 v = row[q];
      w[4 * q] = v.x; w[4 * q + 1] = v.y; w[4 * q + 2] = v.z; w[4 * q + 3] = v.w;
    }
    bar_wait(empty + p * kSlots + s, ((k / kSlots) & 1) ^ 1);
    schedule(w, ring + (p * kSlots + s) * 512 + lane, one);
    bar_arrive(full + p * kSlots + s);
    __syncwarp();  // every lane has read half k & 1 before block k + 2 lands there
  }
}

}  // namespace

extern "C" int fab_sha256_blocks(const uint32_t* blocks, const int32_t* nblocks, int B, int M,
                                 uint32_t* out, void* stream) {
  if (B > 0)
    sha256_blocks_kernel<<<(B + kMsgs - 1) / kMsgs, kThreads, kSmemBytes,
                           (cudaStream_t)stream>>>(blocks, nblocks, B, M, out, 1u);
  return (int)cudaGetLastError();
}

extern "C" const char* fab_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
