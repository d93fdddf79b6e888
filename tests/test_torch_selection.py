"""The facade's kernel selection through the port's validator, on the
CPU: ``BlockValidator(kernel="v1" | "v2")`` on one small block of
``tests/test_torch_slice.py``'s network gives the filters, update batch
and history of the port's v3 validator and of the JAX validator, with
no stage 2 (every block takes ``_validate_host``).  The JAX package's
v1 and v2 verifiers are not compiled here: ``test_torch_p256v1.py``
and ``test_torch_p256v2.py`` hold the port's against them.  An
unknown kernel name selects v3, as in the reference."""

import pytest
import torch

from fabric_tpu.ledger.statedb import MemVersionedDB as JMemDB
from fabric_tpu.peer.validator import BlockValidator as JBlockValidator
from fabric_tpu_torch import carry
from fabric_tpu_torch.ops import p256
from fabric_tpu_torch.peer import validator as pv
from test_torch_slice import POLICIES, _blocks, _decode, _reference, _rows, _seed_batch
from test_torch_slice import net  # noqa: F401  (module fixture)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def one_block(net):  # noqa: F811
    blocks = _blocks(net, seed=20261020, n_blocks=1)
    want = _reference(net, blocks)[0]
    seed = JMemDB()
    seed.apply_updates(_seed_batch(), (1, 0))
    rows = [(ns, key, vv.value, vv.version) for (ns, key), vv in seed.iter_all()]
    people = [net["client"], *net["peers"]]
    idents = [(p.msp_id, p.identity.role, *p.identity.public_numbers) for p in people]
    _, _, carried = carry.from_reference(rows, POLICIES, idents)
    known = {(i.msp_id, i.role, i.qx, i.qy): i for i in carried}
    parser = JBlockValidator(net["mgr"], net["prov"], JMemDB())
    return _decode(blocks[0], parser, net["mgr"], known), want, rows


def _validate(block, rows, kernel):
    state, prov, _ = carry.from_reference(rows, POLICIES, [])
    v = pv.BlockValidator(prov, state, device="cpu", kernel=kernel)
    pend = v.validate_launch(block)
    flt, batch, hist = v.validate_finish(pend)
    return v, pend, (flt, _rows(batch), list(hist))


@pytest.fixture(scope="module")
def v3_result(one_block):
    block, want, rows = one_block
    v, pend, got = _validate(block, rows, "v3")
    assert pend.dpre is not None and pend.fetch2 is not None  # the fused stage 2
    return got


@pytest.mark.parametrize("kernel", ["v1", "v2"])
def test_comparison_kernel_equals_v3_and_reference(one_block, v3_result, kernel):
    block, want, rows = one_block
    v, pend, got = _validate(block, rows, kernel)
    assert v.kernel == kernel
    assert pend.dpre is None and pend.fetch2 is None  # no stage 2: the host path
    assert pend.items and pend.handle.device_out.shape[0] == p256.bucket(len(pend.items))
    assert got == v3_result == want


def test_unknown_kernel_selects_v3(monkeypatch):
    assert p256.selected("v9") == p256.selected("") == "v3"
    assert p256.selected("v1") == "v1" and p256.selected("v2") == "v2"
    monkeypatch.setattr(p256, "KERNEL", "v2")
    assert p256.selected() == "v2" and p256.selected("v3") == "v3"
    monkeypatch.setattr(p256, "KERNEL", "bogus")
    assert p256.selected() == "v3"
    v = pv.BlockValidator(pv.PolicyProvider({}), None, device="cpu", kernel="nope")
    assert v.kernel == "v3"
