// Batched SHA-256 over pre-padded messages.
//
// Replaces fabric_tpu/ops/sha256.py::sha256_blocks (with _compress):
// blocks [B, M, 16] big-endian 32-bit words (held in int32, read as
// uint32), nblocks [B] -> digests [B, 8].  Message i runs the
// compression over its first min(nblocks[i], M) blocks; the reference
// masks the rest with a per-message select, here the loop simply stops.
//
// One thread per message.  The eight state words live in registers,
// the message schedule is a 16-word rolling window in registers, and
// the 64 rounds are unrolled.  K sits in __constant__: every lane of a
// warp reads the same index, so each read is a broadcast.  Rotations
// are __funnelshift_r.  Bound: operations, ~2,250 32-bit integer
// operations per compression against 64 bytes of input; the loads are
// per-thread strided (64 bytes apart between neighbouring lanes), which
// a later PR can coalesce through shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

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

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

__device__ __forceinline__ void compress(uint32_t st[8], const uint32_t* __restrict__ blk) {
  uint32_t w[16];
#pragma unroll
  for (int t = 0; t < 16; ++t) w[t] = blk[t];
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    uint32_t wt;
    if (t < 16) {
      wt = w[t];
    } else {
      const uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
      const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      wt = w[t & 15] + s0 + w[(t - 7) & 15] + s1;
      w[t & 15] = wt;
    }
    const uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t t1 = h + S1 + ch + kK[t] + wt;
    const uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    const uint32_t t2 = S0 + maj;
    h = g; g = f; f = e; e = d + t1; d = c; c = b; b = a; a = t1 + t2;
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

__global__ void sha256_blocks_kernel(const uint32_t* __restrict__ blocks,
                                     const int32_t* __restrict__ nblocks, int B, int M,
                                     uint32_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  uint32_t st[8] = {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
                    0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u};
  const int nb = min(nblocks[i], M);
  const uint32_t* msg = blocks + (size_t)i * M * 16;
  for (int k = 0; k < nb; ++k) compress(st, msg + (size_t)k * 16);
#pragma unroll
  for (int j = 0; j < 8; ++j) out[(size_t)i * 8 + j] = st[j];
}

}  // namespace

extern "C" int fab_sha256_blocks(const uint32_t* blocks, const int32_t* nblocks, int B, int M,
                                 uint32_t* out, void* stream) {
  if (B > 0) {
    sha256_blocks_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
        blocks, nblocks, B, M, out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* fab_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
