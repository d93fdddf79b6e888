"""The CUDA kernel sources' device code, compiled as host C++ and run
one thread per block, against the plain versions on the CPU.

The sm_90a kernels themselves run only on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).  Here a few shim
macros turn ``__global__``/``__device__`` functions into plain C++ and
a loop over ``blockIdx`` plays the grid; with one thread per block the
fixpoint kernel's barriers are no-ops and its grid-stride loops cover
every transaction.  That checks each kernel's arithmetic and indexing
— the 256-bit Montgomery product, the point formulas, the window
recoding, the policy gate walk, the bitsets and the fixpoint — bit for
bit, before a card ever sees it."""

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from fabric_tpu_torch.crypto import ec_ref
from fabric_tpu_torch.crypto import policy as pol
from fabric_tpu_torch.ops import mvcc
from fabric_tpu_torch.ops import p256v3 as v3
from fabric_tpu_torch.peer import device_block as db

CSRC = pathlib.Path(__file__).resolve().parents[1] / "fabric_tpu_torch" / "kernels" / "csrc"

SHIM = r"""
#include <algorithm>
#include <cstddef>
#include <cstdint>
using std::min;
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__
#define __shared__ static
#define __ldg(p) (*(p))
#define __syncthreads() do {} while (0)
struct Dim { unsigned x = 0, y = 0, z = 0; };
static Dim blockIdx, threadIdx, blockDim;
template <class T> static T atomicOr(T* p, T v) { T o = *p; *p |= v; return o; }
template <class T> static T atomicMin(T* p, T v) { T o = *p; if (v < o) *p = v; return o; }
static uint32_t host_smem[1 << 16];
"""

LAUNCHERS = {
    "p256_verify": r"""
extern "C" void host_p256(const int16_t* f, int B, const uint32_t* c, uint8_t* out) {
  blockDim.x = 1;
  for (int i = 0; i < B; ++i) { blockIdx.x = i; p256_verify_kernel(f, B, c, out); }
}
""",
    "stage2": r"""
extern "C" void host_policy(const uint8_t* sv, int n_sig, const int32_t* gp, int Eb, int S,
                            int P, const int32_t* plan, int32_t* pok, int T, int8_t* safe) {
  blockDim.x = 1;
  for (int e = 0; e < Eb; ++e) { blockIdx.x = e;
    stage2_policy_kernel(sv, n_sig, gp, Eb, S, P, plan, pok, T, safe); }
}
extern "C" void host_bitsets(const int32_t* sp, int T, int R, int W, int Q, uint32_t* d,
                             uint32_t* p) {
  const int nw = (T + 31) / 32;
  blockDim.x = 1;
  for (long i = 0; i < (long)T * nw; ++i) { blockIdx.x = i;
    mvcc_bitsets_kernel(sp, T, R, W, Q, nw, d, p); }
}
extern "C" void host_verok(const int32_t* rk, const uint8_t* rp, const uint32_t* rv,
                           const uint8_t* cp, const uint32_t* cv, int T, int R, uint8_t* vo) {
  blockDim.x = 1;
  for (int t = 0; t < T; ++t) { blockIdx.x = t; mvcc_verok_kernel(rk, rp, rv, cp, cv, T, R, vo); }
}
extern "C" void host_fixpoint(int T, const uint32_t* d, const uint32_t* p, const uint8_t* vo,
                              const uint8_t* po, const int32_t* lv, const uint8_t* sv, int n_sig,
                              const int32_t* pok, int8_t* out) {
  blockDim.x = 1;
  mvcc_fixpoint_kernel(T, (T + 31) / 32, d, p, vo, po, lv, sv, n_sig, pok, out);
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
        device_code = src.split("}  // namespace")[0]
        device_code = device_code.replace("#include <cuda_runtime.h>", "").replace(
            "extern __shared__ uint32_t sm[];", "uint32_t* sm = host_smem;")
        cpp = d / f"{name}.cpp"
        cpp.write_text(SHIM + device_code + "}  // namespace\n" + launcher)
        so = d / f"{name}.so"
        subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-w", "-o", str(so),
                        str(cpp)], check=True, timeout=300)
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


def test_verify_kernel_source_matches_plain_and_oracle(host_kernels):
    items = _items(120)
    frame = v3.stage_frame(items, v3._bucket(len(items)))
    consts = v3._kernel_consts(torch.device("cpu")).numpy().view(np.uint32)
    out = np.zeros(len(frame), np.uint8)
    host_kernels["p256_verify"].host_p256(_p(frame), len(frame), _p(consts), _p(out))
    plain = v3.verify_batch_ref(torch.from_numpy(frame)).numpy()
    assert np.array_equal(out.astype(bool), plain)
    want = [ec_ref.verify_digest((x, y), e, r, s) for e, r, s, x, y in items]
    assert out[:len(items)].astype(bool).tolist() == want
    assert any(want) and not all(want)
    assert all(want[i] == (i % 10 == 7) for i in range(len(items)) if i % 10 in (7, 8))


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


@pytest.mark.parametrize("seed", range(3))
def test_stage2_kernel_sources_match_plain(host_kernels, seed):
    lib = host_kernels["stage2"]
    sv, lv, groups, sp, (R, W, Q) = _stage2(seed)
    T, n_sig = lv.shape[0], sv.shape[0]
    t = torch.from_numpy
    want = db.stage2_ref(t(sv), t(lv), [(p, t(g), e, s) for p, g, e, s in groups], t(sp),
                         (R, W, Q)).numpy()
    out = np.zeros_like(want)
    pok = np.ones(T + 1, np.int32)
    svb = sv.astype(np.uint8)
    off = 5 * T + n_sig
    for plan, gp, eb, S in groups:
        vec = np.array(db.plan_vector(plan), np.int32)
        safe = np.zeros(eb, np.int8)
        lib.host_policy(_p(svb), n_sig, _p(gp), eb, S, len(plan.principals), _p(vec),
                        _p(pok), T, _p(safe))
        out[off:off + eb] = safe
        off += eb
    nw = (T + 31) // 32
    d, ph = np.zeros((T, nw), np.uint32), np.zeros((T, nw), np.uint32)
    lib.host_bitsets(_p(sp), T, R, W, Q, _p(d), _p(ph))
    lib.host_fixpoint(T, _p(d), _p(ph), None, None, _p(lv), _p(svb), n_sig, _p(pok), _p(out))
    assert np.array_equal(out, want)
    assert 0 < want[:T].sum() < T

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
                      None, _p(o3))
    c = lambda a: t(np.ascontiguousarray(a))
    ref = mvcc.mvcc_validate_ref(c(rk), c(rp), c(rv.view(np.int32)), c(cp), c(cv.view(np.int32)),
                                 c(sp[:, R:R + W]), c(sp[:, R + W:R + W + Q]),
                                 c(sp[:, R + W + Q:]), c(pre))
    assert np.array_equal(o3.astype(bool), torch.cat(ref).numpy())
