"""The port's endorsement sign lane (fabric_tpu_torch/ops/p256sign.py,
peer/signlane.py, crypto/ec_ref.py's RFC 6979 nonce and DER codec) on
the CPU, where ``sign_batch_limbs`` runs its plain version, held
against the port's and the JAX package's ``ec_ref`` and the JAX
``p256sign.sign_digests``.  Signatures are integers: equality is exact."""

import threading

import numpy as np
import pytest
import torch

from fabric_tpu.crypto import ec_ref as jec
from fabric_tpu.ops import p256sign as jsign
from fabric_tpu_torch.crypto import ec_ref
from fabric_tpu_torch.ops import p256sign, p256v3
from fabric_tpu_torch.peer import signlane

N, P = ec_ref.N, ec_ref.P
D = 0xC9AFA9D845BA75166B5C215767B1D6934E50C3DB36E89B127B8A622B120F6721  # RFC 6979 A.2.5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _digests(n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "big") for _ in range(n)]


def test_rfc6979_and_der_match_reference():
    for msg, want_k in ((b"sample", 0xA6E3C57DD01ABE90086538398355DD4C3B17AA873382B0F24D6129493D8AAD60),
                        (b"test", 0xD16B6AE827F17175E040871A1C7EC3500192C4C92677336EC2537ACAEE0008E0)):
        e = ec_ref.digest_int(msg)
        assert ec_ref.rfc6979_k(D, e) == jec.rfc6979_k(D, e) == want_k
    for e in _digests(8, 1):
        assert ec_ref.rfc6979_k(D, e) == jec.rfc6979_k(D, e)
    for bad in (0, N):
        with pytest.raises(ValueError):
            ec_ref.rfc6979_k(bad, 5)
    pairs = [(1, 2), (N - 1, ec_ref.HALF_N), (0x80, 0x7F)]
    pairs += [ec_ref.SigningKey(D).sign_digest(e) for e in _digests(4, 2)]
    for r, s in pairs:
        der = ec_ref.der_encode_sig(r, s)
        assert der == jec.der_encode_sig(r, s)
        assert ec_ref.der_decode_sig(der) == (r, s)
    der = ec_ref.der_encode_sig(5, 7)
    for bad in (b"", b"\x30\x00", der[:-1], der + b"\x00", b"\x31" + der[1:]):
        with pytest.raises(ValueError):
            ec_ref.der_decode_sig(bad)
    for r, s in ((0, 2), (1, N)):
        with pytest.raises(ValueError):
            ec_ref.der_encode_sig(r, s)


@pytest.fixture(scope="module")
def ref_sign():
    """The JAX lane at one bucket (32 lanes), compiled once."""
    def sign(digests, key, ks=None):
        assert 16 < len(digests) <= 32
        return jsign.sign_digests(digests, key, ks=ks)
    return sign


def test_random_digests_match_oracles(ref_sign):
    """21 lanes (not a bucket size: 11 pad lanes with k = 1), per-lane keys."""
    digests = _digests(21, 3)
    rng = np.random.default_rng(4)
    ds = [int.from_bytes(rng.bytes(32), "big") % (N - 1) + 1 for _ in digests]
    got = p256sign.sign_digests(digests, ds, device="cpu")
    assert len(got) == 21
    assert got == [ec_ref.SigningKey(d).sign_digest(e) for e, d in zip(digests, ds)]
    assert got == ref_sign(digests, ds)
    assert got == p256sign.sign_host(digests, ds)
    assert all(s <= ec_ref.HALF_N for _, s in got)
    items = [(e, r, s, *ec_ref.SigningKey(d).public) for e, d, (r, s) in zip(digests, ds, got)]
    assert p256v3.verify_launch(items, device="cpu").fetch() == [True] * 21


def _edge_scalars():
    ks = [1, 2, N - 1, N - 2, 15, 16, 17]
    ks += [16 ** j for j in (1, 2, 31, 62, 63)]
    ks += [int("f" + "0" * 62 + "1", 16), int("8" * 20 + "0" * 40 + "3" * 4, 16),
           int("1" + "0" * 63, 16) - 1, (1 << 255) + (1 << 128), 0xF << 128]
    return ks


def test_edge_scalars_and_low_s(ref_sign):
    """k = 1, 2, n-1, n-2, powers of 16, runs of zero digits: every lane
    equals ``ec_ref`` and the JAX lane at the same fixed k; the low-S
    rule flips s on some lanes."""
    ks = _edge_scalars()
    digests = _digests(len(ks), 5)
    got = p256sign.sign_digests(digests, D, ks=ks, device="cpu")
    want = [ec_ref.SigningKey(D).sign_digest(e, k=k) for e, k in zip(digests, ks)]
    assert got == want == ref_sign(digests, D, ks=ks)
    qx, qy = ec_ref.SigningKey(D).public
    items = [(e, r, s, qx, qy) for e, (r, s) in zip(digests, got)]
    assert p256v3.verify_launch(items, device="cpu").fetch() == [True] * len(ks)
    raw_s = [pow(k, -1, N) * (e + r * D) % N for (r, _), e, k in zip(got, digests, ks)]
    flipped = [s != rs for (_, s), rs in zip(got, raw_s)]
    assert any(flipped) and not all(flipped)
    # the device output itself: (X, Z) of k·G in Montgomery form
    limbs = np.zeros((32, 16), np.int16)
    limbs[:len(ks)] = p256v3._limbs16(ks)
    limbs[len(ks):, -1] = 1
    out = p256sign.sign_batch_ref(torch.from_numpy(limbs)).numpy().view(np.uint32)
    xs, zs = p256sign._to_ints(out[:, 0]), p256sign._to_ints(out[:, 1])
    for k, X, Z in zip(ks + [1] * (32 - len(ks)), xs, zs):
        assert X < P and 0 < Z < P
        assert X * pow(Z, -1, P) % P == ec_ref.pt_mul(k, ec_ref.G)[0]


@pytest.fixture(scope="module")
def edge_ref(ref_sign):
    """The JAX lane's signatures over the edge scalars, once per module."""
    ks = _edge_scalars()
    digests = _digests(len(ks), 8)
    return digests, ks, ref_sign(digests, D, ks=ks)


@pytest.mark.parametrize("chains", p256sign.CHAINS)
def test_plain_sign_at_every_chain_count_matches_oracles(edge_ref, monkeypatch, chains):
    """``sign_batch_ref`` at each chain count (forced through
    ``sign_chains``): the signatures equal ``ec_ref``'s and the JAX
    lane's, and X / Z give the affine x of k·G."""
    digests, ks, want_jax = edge_ref
    monkeypatch.setattr(p256sign, "sign_chains", lambda B: chains)
    got = p256sign.sign_digests(digests, D, ks=ks, device="cpu")
    assert got == [ec_ref.SigningKey(D).sign_digest(e, k=k) for e, k in zip(digests, ks)]
    assert got == want_jax
    limbs = torch.from_numpy(p256v3._limbs16(ks))
    out = p256sign.sign_batch_ref(limbs, chains=chains).numpy().view(np.uint32)
    xs, zs = p256sign._to_ints(out[:, 0]), p256sign._to_ints(out[:, 1])
    for k, X, Z in zip(ks, xs, zs):
        assert X < P and 0 < Z < P
        assert X * pow(Z, -1, P) % P == ec_ref.pt_mul(k, ec_ref.G)[0]
    with pytest.raises(ValueError):
        p256sign.sign_batch_ref(limbs, chains=3)


def test_signatures_verify_through_verify_launch(monkeypatch):
    digests = _digests(9, 6)
    sigs = p256sign.sign_digests(digests, D, device="cpu")
    qx, qy = ec_ref.SigningKey(D).public
    items = [(e, r, s, qx, qy) for e, (r, s) in zip(digests, sigs)]
    assert p256v3.verify_launch(items, device="cpu").fetch() == [True] * 9
    assert p256sign.sign_digests(digests, D, verify_after=True, device="cpu") == sigs
    real = p256sign.sign_batch_ref

    def corrupt(limbs):
        out = real(limbs)
        out[2, 0, 0] ^= 1  # one bit of lane 2's X
        return out

    monkeypatch.setattr(p256sign, "sign_batch_ref", corrupt)
    with pytest.raises(RuntimeError, match="verify-after-sign rejected lanes \\[2\\]"):
        p256sign.sign_digests(digests, D, verify_after=True, device="cpu")


def test_sign_launch_checks():
    assert p256sign.sign_digests([], D, device="cpu") == []
    for kw in ({"key": 0}, {"key": N}, {"key": [D, D]}, {"key": D, "ks": [0]},
               {"key": D, "ks": [N]}, {"key": D, "ks": [1, 2]}):
        with pytest.raises(ValueError):
            p256sign.sign_launch([5], device="cpu", **kw)
    with pytest.raises(ValueError):
        p256sign.sign_batch_limbs(torch.zeros((4, 15), dtype=torch.int16))


def test_batcher_threads_equal_serial_backend():
    """8 client threads through ``SignBatcher(device_sign_backend(...))``
    give the DER signatures of the serial ``cpu_sign_backend``."""
    serial = signlane.cpu_sign_backend(D)
    msgs = [b"proposal-%d" % i for i in range(48)]
    want = {m: ec_ref.der_encode_sig(*serial([ec_ref.digest_int(m)])[0]) for m in msgs}
    got, errors = {}, []
    backend = signlane.device_sign_backend(D, device="cpu")
    with signlane.SignBatcher(backend, batch_max=16, wait_ms=20.0) as batcher:
        signer = signlane.BatchedSigner(ec_ref.SigningKey(D), batcher)

        def client(part):
            try:
                for m in part:
                    got[m] = signer.sign(m)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(msgs[i::8],)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads) and not errors
        st = batcher.stats()
    assert got == want
    assert st["signed_total"] == 48 and st["batches_total"] < 48 and st["busy_total"] == 0
    assert signer.d == D and signlane.private_scalar(signer) == D


def test_batcher_busy_overflow_and_backend_error():
    gate, entered = threading.Event(), threading.Event()

    def gated(digests):
        entered.set()
        assert gate.wait(30)
        return signlane.cpu_sign_backend(D)(digests)

    results, errors = [], []

    def call(b, e):
        try:
            results.append(b.sign_digest(e))
        except Exception as exc:  # noqa: BLE001 — collected for the asserts
            errors.append(exc)

    with signlane.SignBatcher(gated, batch_max=1, wait_ms=0.0) as b:
        first = threading.Thread(target=call, args=(b, 1))
        first.start()
        assert entered.wait(30)  # the flusher holds lane 1 in the backend
        queued = [threading.Thread(target=call, args=(b, e)) for e in (2, 3)]
        for t in queued:
            t.start()
        while b.stats()["depth"] < 2:
            threading.Event().wait(0.005)
        with pytest.raises(signlane.SignBusy) as busy:
            b.sign_digest(4)
        assert busy.value.cap == 2 and busy.value.retry_ms == signlane.SIGN_RETRY_MS
        gate.set()
        for t in (first, *queued):
            t.join(timeout=30)
        st = b.stats()
    assert sorted(results) == sorted(signlane.cpu_sign_backend(D)([1, 2, 3])) and not errors
    assert st["busy_total"] == 1 and 0 < st["busy_rate"] < 1

    def broken(digests):
        raise KeyError("backend down")

    results.clear()
    with signlane.SignBatcher(broken, batch_max=8, wait_ms=50.0) as b:
        threads = [threading.Thread(target=call, args=(b, e)) for e in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not results and len(errors) == 6
    assert all(isinstance(e, KeyError) for e in errors)
    with pytest.raises(ValueError):
        signlane.SignBatcher(broken, batch_max=0)
    with pytest.raises(ValueError):
        signlane.private_scalar(object())
