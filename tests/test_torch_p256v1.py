"""The port's v1 verifier (``fabric_tpu_torch/ops/p256.py``) against the
JAX package's ``fabric_tpu/ops/p256.py`` and ``ec_ref``, on the CPU.

Field level: the Montgomery product mod p (the port's ``fp256`` core)
and mod n (the port's exact 16-bit-word CIOS), to and from Montgomery
form.  Point level: the complete Jacobian doubling and addition, with
lanes at infinity, doubling and inverse, called eagerly on small
batches.  Verify level: the plain version against ``ec_ref`` on every
kind of lane, and against the JAX ``_verify_host_v1`` on one 16-lane
batch, computed once (16 lanes is the bucket the JAX kernel is
compiled for).  Exact throughout: every output is an integer or a bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fabric_tpu.ops import p256 as jp
from fabric_tpu_torch.crypto import ec_ref
from fabric_tpu_torch.ops import fp256
from fabric_tpu_torch.ops import p256 as tp

P, N = ec_ref.P, ec_ref.N


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ints(rng, n, bound):
    return [int.from_bytes(rng.bytes(40), "big") % bound for _ in range(n)]


def _jax(xs):
    return jnp.asarray(jp.ints_to_limbs(xs))


def _port(xs):
    return fp256.ints_to_limbs(xs)


def _canon_ints(t):
    return fp256.limbs_to_ints(fp256.canon(t))


@pytest.mark.parametrize("seed", range(3))
def test_mont_mul_mod_p_matches_reference(seed):
    rng = np.random.default_rng(seed)
    a = _ints(rng, 12, P) + [0, 1, P - 1, P - 1]
    b = _ints(rng, 12, P) + [P - 1, P - 1, 1, P - 1]
    want = jp.limbs_to_ints(jp._mont_mul(_jax(a), _jax(b), jp.MODP))
    assert _canon_ints(fp256.mont_mul(_port(a), _port(b))) == want
    assert want == [x * y * pow(1 << 256, -1, P) % P for x, y in zip(a, b)]
    # to and from Montgomery form
    jm = jp.limbs_to_ints(jp._to_mont(_jax(a), jp.MODP))
    assert _canon_ints(fp256.to_mont(_port(a))) == jm
    assert fp256.limbs_to_ints(fp256.from_mont(fp256.ints_to_limbs(jm))) == \
        jp.limbs_to_ints(jp._from_mont(_jax(jm), jp.MODP)) == a


@pytest.mark.parametrize("seed", range(3))
def test_mont_mul_mod_n_matches_reference(seed):
    rng = np.random.default_rng(10 + seed)
    a = _ints(rng, 12, N) + [0, 1, N - 1, N - 1]
    b = _ints(rng, 12, N) + [N - 1, N - 1, 1, N - 1]
    want = jp.limbs_to_ints(jp._mont_mul(_jax(a), _jax(b), jp.MODN))
    got = tp.mont_mul_n(_port(a), _port(b))
    assert fp256.limbs_to_ints(got) == want
    assert int(got.max()) <= 0xFFFF and int(got.min()) >= 0
    r2n = tp._v1_consts(torch.device("cpu"))["r2n"].expand(len(a), -1)
    jm = jp.limbs_to_ints(jp._to_mont(_jax(a), jp.MODN))
    assert fp256.limbs_to_ints(tp.mont_mul_n(_port(a), r2n)) == jm
    one = _port([1] * len(a))
    assert fp256.limbs_to_ints(tp.mont_mul_n(_port(jm), one)) == \
        jp.limbs_to_ints(jp._from_mont(_jax(jm), jp.MODN)) == a
    # the Fermat inverse the kernel computes, against Python's
    assert pow(a[3], N - 2, N) == pow(a[3], -1, N)


def _jacobian_mont(pts, rng):
    """Affine points (None = infinity) → random Jacobian Montgomery-form
    (X, Y, Z) ints; infinity is (0, 0, 0), as the ladder starts."""
    X, Y, Z = [], [], []
    for pt in pts:
        if pt is None:
            X.append(0), Y.append(0), Z.append(0)
            continue
        z = _ints(rng, 1, P - 1)[0] + 1
        X.append(pt[0] * z * z % P * (1 << 256) % P)
        Y.append(pt[1] * z * z * z % P * (1 << 256) % P)
        Z.append(z * (1 << 256) % P)
    return X, Y, Z


def _affine(X, Y, Z):
    out = []
    for x, y, z in zip(X, Y, Z):
        x, y, z = (v * pow(1 << 256, -1, P) % P for v in (x, y, z))
        if z == 0:
            out.append(None)
            continue
        zi = pow(z, -1, P)
        out.append((x * zi * zi % P, y * zi * zi * zi % P))
    return out


def test_points_match_reference():
    rng = np.random.default_rng(21)
    ks = _ints(rng, 5, N - 1)
    p1 = [ec_ref.pt_mul(k + 1, ec_ref.G) for k in ks]
    p2 = [ec_ref.pt_mul(3 * k + 7, ec_ref.G) for k in ks]
    q = ec_ref.pt_mul(12345, ec_ref.G)
    qneg = (q[0], P - q[1])
    # infinity + P, P + infinity, P + P (doubling), P + (-P), infinity + infinity
    p1 += [None, q, q, q, None]
    p2 += [q, None, q, qneg, None]
    a, b = _jacobian_mont(p1, rng), _jacobian_mont(p2, rng)
    ja = [_jax(c) for c in a]
    jb = [_jax(c) for c in b]
    ta = [_port(c) for c in a]
    tb = [_port(c) for c in b]

    want_d = [jp.limbs_to_ints(c) for c in jp._pt_double(*ja)]
    got_d = [_canon_ints(c) for c in tp.pt_double_v1(*ta)]
    assert got_d == want_d
    assert _affine(*got_d) == [ec_ref.pt_double(pt) for pt in p1]

    want_a = [jp.limbs_to_ints(c) for c in jp._pt_add(*ja, *jb)]
    got_a = [_canon_ints(c) for c in tp.pt_add_v1(*ta, *tb)]
    assert got_a == want_a
    assert _affine(*got_a) == [ec_ref.pt_add(x, y) for x, y in zip(p1, p2)]


def _lanes():
    """16 lanes of every kind → (items, kinds)."""
    rng = np.random.default_rng(7)
    keys = [ec_ref.SigningKey(d=int(rng.integers(1, 1 << 62))) for _ in range(2)]
    sig = lambda k, e: (e, *k.sign_digest(e), *k.public)
    e = int.from_bytes(rng.bytes(32), "big")
    valid = sig(keys[0], e)
    _, r, s, qx, qy = valid
    wrapped = ec_ref.wrapped_x_signature(int(rng.integers(1, 1 << 62)) << 64,
                                         int.from_bytes(rng.bytes(32), "big"), ec_ref.HALF_N)
    g_key, neg_g_key = ec_ref.SigningKey(d=1), ec_ref.SigningKey(d=N - 1)
    lanes = [
        ("valid", valid), ("valid", sig(keys[1], e ^ 5)),
        ("corrupted_digest", (e ^ 1, r, s, qx, qy)),
        ("high_s", (e, r, N - s, qx, qy)),
        ("r_zero", (e, 0, s, qx, qy)), ("s_zero", (e, r, 0, qx, qy)),
        ("r_eq_n", (e, N, s, qx, qy)), ("s_ge_n", (e, r, N + 1, qx, qy)),
        ("off_curve", (e, r, s, qx, (qy + 1) % P)), ("q_zero", (e, r, s, 0, 0)),
        ("q_eq_g", sig(g_key, e)), ("q_eq_minus_g", sig(neg_g_key, e ^ 9)),
        ("x_wrapped", wrapped), ("x_wrapped_tampered", (wrapped[0] ^ 1, *wrapped[1:])),
        ("u1_zero", sig(keys[1], 0)),
        ("r_above_2_256", (e, r + (1 << 256), s, qx, qy)),
    ]
    return [it for _, it in lanes], [k for k, _ in lanes]


@pytest.fixture(scope="module")
def batch():
    items, kinds = _lanes()
    want = [ec_ref.verify_digest((x, y), e, r, s) for e, r, s, x, y in items]
    frame = torch.from_numpy(tp.stage_frame(items, tp.bucket(len(items))))
    return items, kinds, want, tp.verify_batch_v1_ref(frame)


def test_plain_verify_matches_oracle(batch):
    items, kinds, want, got = batch
    assert len(items) == 16 and got.shape == (16,)
    assert got.tolist() == want
    accepted = {k for k, w in zip(kinds, want) if w}
    assert accepted == {"valid", "q_eq_g", "q_eq_minus_g", "x_wrapped", "u1_zero"}


def test_plain_verify_matches_jax_v1(batch):
    items, kinds, want, got = batch
    # the reference keeps the low 256 bits of an out-of-range component;
    # the port's staging rejects the lane (ec_ref rejects it too)
    ref_items = [it if k != "r_above_2_256" else tp.PAD_ITEM for it, k in zip(items, kinds)]
    assert jp._verify_host_v1(ref_items) == got.tolist()


def test_facade_and_kernel_wrapper_on_cpu(batch):
    items, _, want, _ = batch
    h = tp.verify_launch(items[:3], kernel="v1", device="cpu")
    assert h.device_out.shape == (16,) and h.fetch() == want[:3]
    assert tp.verify_launch([], kernel="v1", device="cpu").fetch() == []
    assert tp.bucket(3) == 16 and tp.bucket(17) == 32 and tp.bucket(3000) == 4096
    frame = tp.stage_frame(items[:3], 16)
    assert (frame[3:] == 0).all()  # padding is the all-zero item
    with pytest.raises(ValueError, match="int32"):
        tp.verify_batch_v1(torch.zeros((16, 80), dtype=torch.int64))
