"""The port's v2 verifier (``fabric_tpu_torch/ops/digits.py``,
``ops/p256v2.py``) against the JAX package's ``fabric_tpu/ops/digits.py``
and ``ops/p256v2.py`` and ``ec_ref``, on the CPU.

Field level: ``DigitMod.mul``, ``settle``, ``canonical`` and
``eq_zero`` on the same int32 inputs, random and at the largest legal
magnitudes (the pairing limit, +-624); the digits must be the
reference's exactly (its float32 contractions are exact below 2^24,
which the certificate bounds), their values right mod m, and settled
digits within 96.  ``bound_check`` equals the reference's.  Point
level: the RCB formulas against the reference's on the same FV inputs,
digits and bounds (so the port condenses where the reference does).
Verify level: the plain version against ``ec_ref`` and against the
JAX ``verify_host`` on one 16-lane batch, computed once.  Exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fabric_tpu.ops import digits as jdg
from fabric_tpu.ops import p256v2 as jv2
from fabric_tpu_torch.crypto import ec_ref
from fabric_tpu_torch.ops import digits as dg
from fabric_tpu_torch.ops import p256v2 as tv2

P, N, K = ec_ref.P, ec_ref.N, dg.K
MODS = {"p": (tv2.MODP, jv2.MODP), "n": (tv2.MODN, jv2.MODN)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _value(row) -> int:
    return dg.digits_to_int(row)


def _operands(rng, m):
    side = tv2.MAX_SIDE
    a = [dg.int_to_digits(int.from_bytes(rng.bytes(32), "big") % m) for _ in range(4)]
    a += [np.full(K, side), np.full(K, -side),
          np.array([side if i % 2 else -side for i in range(K)]),
          np.array([(-1) ** i * (side - i) for i in range(K)])]
    a += [rng.integers(-side, side + 1, K) for _ in range(4)]
    return np.stack(a).astype(np.int32)


@pytest.mark.parametrize("mod", ["p", "n"])
def test_digit_ops_match_reference(mod):
    tm, jm = MODS[mod]
    rng = np.random.default_rng(1 if mod == "p" else 2)
    a = _operands(rng, tm.m)
    b = a[::-1].copy()
    got = tm.mul(torch.from_numpy(a).long(), torch.from_numpy(b).long()).numpy()
    want = np.asarray(jm.mul(jnp.asarray(a), jnp.asarray(b)))
    assert np.array_equal(got, want)
    assert np.abs(got).max() <= dg.SETTLED_MAX
    for row, x, y in zip(got, a, b):
        assert _value(row) % tm.m == _value(x) * _value(y) % tm.m
    # settle of unsettled columns (|d| < 2^24), canonical and eq_zero
    t = rng.integers(-(1 << 23), 1 << 23, (8, K)).astype(np.int32)
    st = tm.settle(torch.from_numpy(t).long()).numpy()
    assert np.array_equal(st, np.asarray(jm.settle(jnp.asarray(t))))
    assert np.abs(st).max() <= dg.SETTLED_MAX
    assert [_value(r) % tm.m for r in st] == [_value(r) % tm.m for r in t]
    x = np.concatenate([got, st, np.zeros((1, K), np.int32),
                        dg.int_to_digits(tm.m)[None].astype(np.int32)])
    can = tm.canonical(torch.from_numpy(x).long()).numpy()
    assert np.array_equal(can, np.asarray(jm.canonical(jnp.asarray(x))))
    assert [_value(r) for r in can] == [_value(r) % tm.m for r in x]
    assert tm.eq_zero(torch.from_numpy(x).long()).tolist() == \
        np.asarray(jm.eq_zero(jnp.asarray(x))).tolist() == [False] * (len(x) - 2) + [True, True]


@pytest.mark.parametrize("mod", ["p", "n"])
def test_bound_check_matches_reference(mod):
    tm, jm = MODS[mod]
    for a, b in ((tv2.MAX_SIDE, tv2.MAX_SIDE), (288, 288), (96, 63), (500, 700)):
        assert tm.bound_check(a, b) == jm.bound_check(a, b)
    assert tv2.SETTLED == {P: jv2._SETTLED[id(jv2.MODP)], N: jv2._SETTLED[id(jv2.MODN)]}
    assert np.array_equal(tm.R_np, np.asarray(jm._Rnp))
    assert np.array_equal(tm.F_np, np.asarray(jm._Fnp))
    with pytest.raises(AssertionError):
        tm.bound_check(700, 700)


def _pts(rng, affine, bound=None):
    """Affine points (None = infinity) → (port FV point, JAX FV point)
    of random projective representatives, digits mod 2^258."""
    tp, jp_ = [], []
    for pt in affine:
        if pt is None:
            xyz = (0, 1, 0)
        else:
            z = int.from_bytes(rng.bytes(32), "big") % (P - 1) + 1
            xyz = (pt[0] * z % P, pt[1] * z % P, z)
        tp.append(xyz)
    cols = [np.stack([dg.int_to_digits(v[c]) for v in tp]).astype(np.int32) for c in range(3)]
    b = 63 if bound is None else bound
    port = tuple(tv2.FV(torch.from_numpy(c).long(), b, tv2.MODP) for c in cols)
    ref = tuple(jv2.FV(jnp.asarray(c), b, jv2.MODP) for c in cols)
    return port, ref


def _same(port_pt, ref_pt):
    for a, b in zip(port_pt, ref_pt):
        assert a.bound == b.bound
        assert np.array_equal(a.arr.numpy(), np.asarray(b.arr))


def _to_affine(port_pt):
    out = []
    X, Y, Z = ([_value(r) % P for r in c.arr.numpy()] for c in port_pt)
    for x, y, z in zip(X, Y, Z):
        out.append(None if z == 0 else (x * pow(z, -1, P) % P, y * pow(z, -1, P) % P))
    return out


def test_rcb_ops_match_reference():
    rng = np.random.default_rng(5)
    ks = [int.from_bytes(rng.bytes(32), "big") % (N - 1) + 1 for _ in range(4)]
    p1 = [ec_ref.pt_mul(k, ec_ref.G) for k in ks]
    p2 = [ec_ref.pt_mul(3 * k + 7, ec_ref.G) for k in ks]
    q = ec_ref.pt_mul(777, ec_ref.G)
    p1 += [None, q, q, q]
    p2 += [q, None, q, (q[0], P - q[1])]
    # a bound high enough that the products condense operands
    a_t, a_j = _pts(rng, p1, bound=400)
    b_t, b_j = _pts(rng, p2)
    bf_t = tv2.FV(torch.from_numpy(dg.int_to_digits(ec_ref.B)).long().expand(8, K), 63, tv2.MODP)
    bf_j = jv2.FV(jnp.broadcast_to(jnp.asarray(jdg.int_to_digits(ec_ref.B)), (8, K)), 63,
                  jv2.MODP)

    got = tv2.pt_add(a_t, b_t, bf_t)
    _same(got, jv2.pt_add(a_j, b_j, bf_j))
    assert _to_affine(got) == [ec_ref.pt_add(x, y) for x, y in zip(p1, p2)]

    got = tv2.pt_double(a_t, bf_t)
    _same(got, jv2.pt_double(a_j, bf_j))
    assert _to_affine(got) == [ec_ref.pt_double(x) for x in p1]

    # mixed: P2 affine and never infinity
    aff = [ec_ref.pt_mul(k + 11, ec_ref.G) for k in ks] + [q, q, q, q]
    p1m = p1[:4] + [None, q, (q[0], P - q[1]), p1[0]]
    x2 = np.stack([dg.int_to_digits(pt[0]) for pt in aff]).astype(np.int32)
    y2 = np.stack([dg.int_to_digits(pt[1]) for pt in aff]).astype(np.int32)
    m_t, m_j = _pts(rng, p1m)
    fv_t = lambda a: tv2.FV(torch.from_numpy(a).long(), 63, tv2.MODP)
    fv_j = lambda a: jv2.FV(jnp.asarray(a), 63, jv2.MODP)
    got = tv2.pt_add_mixed(m_t, fv_t(x2), fv_t(y2), bf_t)
    _same(got, jv2.pt_add_mixed(m_j, fv_j(x2), fv_j(y2), bf_j))
    assert _to_affine(got) == [ec_ref.pt_add(x, y) for x, y in zip(p1m, aff)]


def _lanes():
    rng = np.random.default_rng(9)
    keys = [ec_ref.SigningKey(d=int(rng.integers(1, 1 << 62))) for _ in range(2)]
    sig = lambda k, e: (e, *k.sign_digest(e), *k.public)
    e = int.from_bytes(rng.bytes(32), "big")
    valid = sig(keys[0], e)
    _, r, s, qx, qy = valid
    wrapped = ec_ref.wrapped_x_signature(int(rng.integers(1, 1 << 62)) << 64,
                                         int.from_bytes(rng.bytes(32), "big"), ec_ref.HALF_N)
    lanes = [
        ("valid", valid), ("valid", sig(keys[1], e ^ 3)),
        ("corrupted_digest", (e ^ 1, r, s, qx, qy)), ("high_s", (e, r, N - s, qx, qy)),
        ("r_zero", (e, 0, s, qx, qy)), ("s_zero", (e, r, 0, qx, qy)),
        ("r_eq_n", (e, N, s, qx, qy)), ("off_curve", (e, r, s, qx, (qy + 1) % P)),
        ("q_zero", (e, r, s, 0, 0)), ("q_eq_g", sig(ec_ref.SigningKey(d=1), e)),
        ("q_eq_minus_g", sig(ec_ref.SigningKey(d=N - 1), e ^ 9)),
        ("x_wrapped", wrapped), ("x_wrapped_tampered", (wrapped[0] ^ 1, *wrapped[1:])),
        ("u1_zero", sig(keys[1], 0)), ("s_ge_n", (e, r, N + 1, qx, qy)),
        ("wrong_key", (e, r, s, *keys[1].public)),
    ]
    return [it for _, it in lanes], [k for k, _ in lanes]


@pytest.fixture(scope="module")
def batch():
    items, kinds = _lanes()
    want = [ec_ref.verify_digest((x, y), e, r, s) for e, r, s, x, y in items]
    frame = torch.from_numpy(tv2.stage_frame(items, tv2.bucket(len(items))))
    return items, kinds, want, tv2.verify_batch_v2_ref(frame)


def test_plain_verify_matches_oracle(batch):
    items, kinds, want, got = batch
    assert got.shape == (16,) and got.tolist() == want
    assert {k for k, w in zip(kinds, want) if w} == {"valid", "q_eq_g", "q_eq_minus_g",
                                                    "x_wrapped", "u1_zero"}


def test_plain_verify_matches_jax_v2(batch):
    items, _, _, got = batch
    assert jv2.verify_host(items) == got.tolist()


def test_staging_and_wrapper(batch):
    items = batch[0]
    frame = tv2.stage_frame(items[:3], 16)
    assert frame.shape == (16, tv2.FRAME_COLS) and frame.dtype == np.int32
    assert not frame[3:, tv2._PRE_OK].any()  # padding lanes fail pre_ok
    assert frame[3, K:2 * K].tolist() == dg.int_to_digits(1).tolist()  # pad item r = 1
    with pytest.raises(ValueError, match="int32"):
        tv2.verify_batch_v2(torch.zeros((16, 10), dtype=torch.int32))
