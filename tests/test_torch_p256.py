"""The port's P-256 verify path (fabric_tpu_torch/ops/fp256.py and
ops/p256v3.py) on the CPU, where the kernel wrapper runs its plain
version, held against Python ints, the pure-Python oracle and the JAX
package (fabric_tpu/ops/p256v3.py).  Every quantity is an integer or a
bit: equality is exact."""

import numpy as np
import pytest
import torch

from fabric_tpu.crypto import ec_ref as jax_ec_ref
from fabric_tpu.ops import p256v3 as jv3
from fabric_tpu_torch.crypto import ec_ref
from fabric_tpu_torch.ops import fp256
from fabric_tpu_torch.ops import p256v3 as v3

P, N = ec_ref.P, ec_ref.N
EDGE = [0, 1, 2, 3, P - 1, P, P + 1, P - 2, (1 << 256) - 2, (1 << 256) - 1, 1 << 255,
        fp256.R_MOD_P, N - 1, N, 0xFFFFFFFF, 1 << 224, (1 << 192) - 1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes,
    and the pipeline tests run torch ops on two threads at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def keys():
    rng = np.random.default_rng(7)
    return [ec_ref.SigningKey(d=int.from_bytes(rng.bytes(32), "big") % (N - 1) + 1)
            for _ in range(3)]


def _ints(rng, n):
    return [int.from_bytes(rng.bytes(32), "big") for _ in range(n)]


def test_field_core_matches_python_ints():
    rng = np.random.default_rng(11)
    xs = EDGE + _ints(rng, 47)
    ys = list(reversed(EDGE)) + _ints(rng, 47)
    a, b = fp256.ints_to_limbs(xs), fp256.ints_to_limbs(ys)
    assert fp256.limbs_to_ints(a) == xs
    rinv = fp256.RINV
    prod = fp256.mont_mul(a, b)
    assert fp256.limbs_to_ints(fp256.canon(prod)) == [x * y * rinv % P for x, y in zip(xs, ys)]
    # the reduced form the formulas rely on
    assert int(prod.min()) >= -(1 << 7) and int(prod.max()) <= (1 << 16) + (1 << 7)
    assert fp256.limbs_to_ints(fp256.canon(a + b)) == [(x + y) % P for x, y in zip(xs, ys)]
    assert fp256.limbs_to_ints(fp256.canon(a - b)) == [(x - y) % P for x, y in zip(xs, ys)]
    assert fp256.limbs_to_ints(fp256.from_mont(fp256.to_mont(a))) == [x % P for x in xs]
    assert fp256.eq(a, a + fp256.const(P, "cpu")).all()
    assert fp256.is_zero(fp256.ints_to_limbs([0, P])).all()
    # the largest operands the RCB formulas build: 15 summed reduced
    # values against 6 summed negated ones
    big, neg = 15 * prod, -6 * prod
    want = [(15 * v) * (-6 * v) * rinv % P
            for v in (x * y * rinv % P for x, y in zip(xs, ys))]
    assert fp256.limbs_to_ints(fp256.canon(fp256.mont_mul(big, neg))) == want


def _mont_pts(points):
    """affine points (None = infinity) → Montgomery projective limbs."""
    R = fp256.R
    xs = [0 if p is None else p[0] * R % P for p in points]
    ys = [R % P if p is None else p[1] * R % P for p in points]
    zs = [0 if p is None else R % P for p in points]
    return tuple(fp256.ints_to_limbs(v) for v in (xs, ys, zs))


def _affine(pt):
    x, y, z = (fp256.limbs_to_ints(fp256.from_mont(c)) for c in pt)
    out = []
    for xi, yi, zi in zip(x, y, z):
        if zi == 0:
            out.append(None)
        else:
            zinv = pow(zi, -1, P)
            out.append((xi * zinv % P, yi * zinv % P))
    return out


def test_complete_add_and_double_match_ec_ref():
    b, _, _ = v3._plain_consts(torch.device("cpu"))
    G = ec_ref.G
    k2, k3 = ec_ref.pt_mul(2, G), ec_ref.pt_mul(3, G)
    negG = (G[0], P - G[1])
    p1 = [G, G, G, None, k2, None]
    p2 = [k2, G, negG, k3, None, None]
    want = [ec_ref.pt_add(x, y) for x, y in zip(p1, p2)]
    bb = b.expand(len(p1), -1)
    assert _affine(v3.pt_add(_mont_pts(p1), _mont_pts(p2), bb)) == want
    dp = [G, k2, None, k3, negG]
    assert _affine(v3.pt_double(_mont_pts(dp), b.expand(len(dp), -1))) == [
        ec_ref.pt_double(p) for p in dp]
    # mixed addition against affine G (never infinity)
    mp = [k2, None, G, negG]
    gx = fp256.ints_to_limbs([G[0] * fp256.R % P] * len(mp))
    gy = fp256.ints_to_limbs([G[1] * fp256.R % P] * len(mp))
    got = _affine(v3.pt_add_mixed(_mont_pts(mp), gx, gy, b.expand(len(mp), -1)))
    assert got == [ec_ref.pt_add(p, G) for p in mp]


def test_host_staging_matches_reference(keys):
    rng = np.random.default_rng(13)
    ss = [int.from_bytes(rng.bytes(32), "big") % N or 1 for _ in range(40)]
    assert v3._batch_inv_mod_n(ss) == jv3._batch_inv_mod_n(ss)
    us = [0, 1, 15, 16, N - 1, 1 << 255, (1 << 256) - 1] + _ints(rng, 25)
    assert np.array_equal(v3._windows(us), jv3._windows(us))
    assert np.array_equal(v3._limbs16(us), jv3._limbs16(us))
    rec = v3.recode_windows(torch.from_numpy(v3._limbs16(us))).numpy()
    assert np.array_equal(rec, jv3._windows(us))
    for n in (1, 15, 16, 17, 100, 512, 513, 1000, 3001):
        assert v3._bucket(n) == jv3._bucket(n)
    items = _adversarial(keys, 32)
    want = jv3.prepare(items, pad_to=32)
    frame = v3.stage_frame(items, 32)
    assert np.array_equal(frame[:, v3._PRE_OK] != 0, np.asarray(want[7]))
    pre = np.asarray(want[7])
    # r+n < p only matters on admitted lanes; the port zeroes the rest
    assert np.array_equal((frame[:, v3._RPN_OK] != 0)[pre], np.asarray(want[6])[pre])


def _adversarial(keys, n):
    """n lanes: valid signatures plus bad r, high-S, r = 0, s >= n,
    off-curve Q, tampered digest, Q = (0, 0), zero u1 windows, and a
    signature whose x(R) lies in [n, p) (accepted only through the
    r + n compare) with its tampered twin."""
    zero_e = [(0, *k.sign_digest(0), *k.public) for k in keys]
    wrapped = [ec_ref.wrapped_x_signature(j << 120, ec_ref.digest_int(b"wrap-%d" % j),
                                          ec_ref.HALF_N - j) for j in range(3)]
    out = []
    for i in range(n):
        k = keys[i % 3]
        e = ec_ref.digest_int(b"lane-%d" % i)
        r, s = k.sign_digest(e)
        qx, qy = k.public
        kind = i % 12
        if kind == 1:
            r = (r + 1) % N
        elif kind == 2:
            s = N - s
        elif kind == 3:
            r = 0
        elif kind == 4:
            s = N + 3
        elif kind == 5:
            qx = (qx + 1) % P
        elif kind == 6:
            e ^= 1 << 7
        elif kind == 7:
            qx, qy = 0, 0
        elif kind == 8:
            e, r, s, qx, qy = zero_e[i % 3]
        elif kind in (9, 10):
            e, r, s, qx, qy = wrapped[i % 3]
            e ^= kind == 10
        out.append((e, r, s, qx, qy))
    return out


@pytest.mark.parametrize("lanes", [16, 64])
def test_verify_matches_oracle_and_reference(keys, lanes):
    items = _adversarial(keys, lanes)
    got = v3.verify_host(items, device="cpu")
    oracle = [ec_ref.verify_digest((x, y), e, r, s) for e, r, s, x, y in items]
    assert got == oracle
    assert any(oracle) and not all(oracle)
    # the r + n lanes: accepted where untampered, and only through r + n
    wrapped = [i for i in range(lanes) if i % 12 in (9, 10)]
    assert [got[i] for i in wrapped] == [i % 12 == 9 for i in wrapped]
    frame = v3.stage_frame(items, lanes)
    frame[:, v3._RPN_OK] = 0
    assert not v3.verify_batch_ref(torch.from_numpy(frame))[wrapped].any()
    assert jv3.verify_launch(items)() == got
    # the two oracles are the same module, copied
    assert [jax_ec_ref.verify_digest((x, y), e, r, s) for e, r, s, x, y in items] == oracle


def test_launch_forms_agree(keys):
    """A coalesced launch gives each batch its solo accept set."""
    items = _adversarial(keys, 40)
    mono = v3.verify_launch(items, device="cpu").fetch()
    many = v3.verify_launch_many([items[:5], [], items[5:]], device="cpu")
    assert [h() for h in many] == [mono[:5], [], mono[5:]]
    assert many[0].device_out.shape[0] == v3._bucket(5)
