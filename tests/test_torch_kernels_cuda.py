"""The port's hand-written CUDA kernels against their plain versions on
the card.  Marked ``cuda``: on a host without a CUDA device every test
skips.  On a GPU host (which need not have JAX) run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Exact equality throughout: every output is a bit or an integer."""

import numpy as np
import pytest
import torch

from fabric_tpu_torch.crypto import ec_ref
from fabric_tpu_torch.crypto import policy as pol
from fabric_tpu_torch.ops import mvcc
from fabric_tpu_torch.ops import p256v3 as v3
from fabric_tpu_torch.peer import device_block as db

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the sm_90a kernels run only on an NVIDIA GPU")
    return torch.device("cuda")


def _items(n):
    rng = np.random.default_rng(3)
    keys = [ec_ref.SigningKey(d=int(rng.integers(1, 1 << 62))) for _ in range(3)]
    base = []
    for k in keys:
        for j in range(4):
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
        elif kind in (6, 7):  # x(R) in [n, p): accepted only through r + n
            e, r, s, qx, qy = wrapped[i % 2]
            e ^= kind == 7
        elif kind == 8:
            qx, qy = 0, 0
        out.append((e, r, s, qx, qy))
    return out


def test_p256_verify_kernel_matches_plain(cuda):
    items = _items(200)
    frame = torch.from_numpy(v3.stage_frame(items, v3._bucket(len(items)))).to(cuda)
    got = v3.verify_batch_packed(frame)
    assert torch.equal(got, v3.verify_batch_ref(frame))
    want = [ec_ref.verify_digest((x, y), e, r, s) for e, r, s, x, y in items]
    assert got[:len(items)].tolist() == want and any(want) and not all(want)


def _stage2_operands(dev, T=256, n_sig=512, S=4, seed=5):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    sig_valid = rng.random(n_sig) < 0.85
    lv = np.zeros((T, 3), np.int32)
    lv[:, 0] = rng.integers(-2, n_sig, T)
    lv[:, 1] = rng.random(T) < 0.95
    lv[:, 2] = rng.random(T) < 0.9
    R, W, Q = 2, 2, 1
    sp = np.full((T, R + W + 2 * Q), -1, np.int32)
    sp[:, :R + W] = rng.integers(-1, 300, (T, R + W))
    for i in range(20):  # 20-deep chain
        sp[10 + i, 0], sp[10 + i, R] = 1000 + i, 1001 + i
        lv[10 + i] = (-2, 1, 1)
    rq = rng.choice(T, 30, replace=False)
    sp[rq, R + W] = rng.integers(0, 290, 30)
    sp[rq, R + W + Q] = sp[rq, R + W] + rng.integers(1, 10, 30)
    groups = []
    for dsl, eb in (("OutOf(2, 'Org1MSP.peer', 'Org2MSP.peer', 'Org3MSP.peer')", 256),
                    ("OutOf(1, 'Org1MSP.peer', 'Org1MSP.member')", 32)):
        plan = pol.compile_plan(pol.from_dsl(dsl))
        P = len(plan.principals)
        gp = np.zeros((eb, S * P + S + 1), np.int32)
        idx = np.where(rng.random((eb, S)) < 0.8, rng.integers(0, n_sig, (eb, S)), -1)
        gp[:, :S * P] = (rng.random((eb, S * P)) < 0.4) & np.repeat(idx >= 0, P, axis=1)
        gp[:, S * P:S * P + S] = idx
        gp[:, -1] = rng.integers(-1, T, eb)
        groups.append((plan, t(gp), eb, S))
    return t(sig_valid), t(lv), groups, t(sp), (R, W, Q)


def test_stage2_kernels_match_plain(cuda):
    sv, lv, groups, sp, dims = _stage2_operands(cuda)
    got = db.stage2(sv, lv, groups, sp, dims)
    want = db.stage2_ref(sv, lv, groups, sp, dims)
    assert torch.equal(got, want)
    T = lv.shape[0]
    assert 0 < int(want[:T].sum()) < T


def test_mvcc_validate_kernel_matches_plain(cuda):
    _, lv, _, sp, (R, W, Q) = _stage2_operands(cuda, seed=9)
    rng = np.random.default_rng(9)
    T = sp.shape[0]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    rp = rng.random((T, R)) < 0.9
    rv = rng.integers(0, 3, (T, R, 2)).astype(np.int32)
    cp = rp ^ (rng.random((T, R)) < 0.03)
    cv = rv + (rng.random((T, R, 2)) < 0.03)
    args = (sp[:, :R].contiguous(), t(rp), t(rv), t(cp), t(cv.astype(np.int32)),
            sp[:, R:R + W].contiguous(), sp[:, R + W:R + W + Q].contiguous(),
            sp[:, R + W + Q:].contiguous(), t(rng.random(T) < 0.95))
    for a, b in zip(mvcc.mvcc_validate(*args), mvcc.mvcc_validate_ref(*args)):
        assert torch.equal(a, b)
    ver_ok, pre = lv[:, 2] != 0, lv[:, 1] != 0
    hv = (sp[:, :R].contiguous(), ver_ok, sp[:, R:R + W].contiguous(),
          sp[:, R + W:R + W + Q].contiguous(), sp[:, R + W + Q:].contiguous(), pre)
    for a, b in zip(mvcc.mvcc_validate_hostver(*hv), mvcc.mvcc_validate_hostver_ref(*hv)):
        assert torch.equal(a, b)
