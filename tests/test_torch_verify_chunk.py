"""Chunked ``p256_verify`` launches (``fabric_tpu_torch/ops/p256v3.py``)
against the reference's (``fabric_tpu/ops/p256v3.py:1103-1180``), on the
CPU, where each chunk runs the kernel's plain version into its slice of
the one output vector: ``_chunk_bounds`` over a grid of (n, chunk); the
chunked verify equal to the monolithic one and to the JAX
``verify_launch(chunk=)`` on an adversarial batch, with and without a
staging pool, coalesced or not; the chunk metrics, spans and ledger
record; and whole slice blocks through ``BlockValidator(verify_chunk=)``
(alone, and chunking coalesced groups over a pool) equal to the JAX
validator's.  Verdicts compare exactly."""

import pytest
import torch
from test_torch_p256 import _adversarial, keys  # noqa: F401  (module fixture)
from test_torch_slice import (POLICIES, _blocks, _decode, _reference, _rows, _seed_batch,
                              _Store, net)  # noqa: F401  (module fixture)

from fabric_tpu.ledger.statedb import MemVersionedDB as JMemDB
from fabric_tpu.ops import p256v3 as jv3
from fabric_tpu.peer.validator import BlockValidator as JBlockValidator
from fabric_tpu_torch import carry
from fabric_tpu_torch.observe import Tracer
from fabric_tpu_torch.observe import ledger as pledger
from fabric_tpu_torch.ops import p256v3 as v3
from fabric_tpu_torch.ops_metrics import Registry
from fabric_tpu_torch.parallel.hostpool import HostStagePool
from fabric_tpu_torch.peer import validator as pv
from fabric_tpu_torch.peer.pipeline import CommitPipeline

BLOCKS = 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("chunk", [16, 17, 64, 512, 1000, 4096])
def test_chunk_bounds_equal_the_references(chunk):
    for n in list(range(1, 70)) + [511, 512, 513, 1000, 3000, 3072, 6143, 24576, 24577]:
        assert v3._chunk_bounds(n, chunk) == jv3._chunk_bounds(n, chunk), (n, chunk)
        bounds = v3._chunk_bounds(n, chunk)
        assert bounds[-1][0] + bounds[-1][2] == v3._bucket(n)
        assert all(pad == chunk for _, _, pad in bounds[:-1])


@pytest.fixture(scope="module")
def batch(keys):  # noqa: F811
    items = _adversarial(keys, 40)
    return items, v3.verify_launch(items, device="cpu").fetch()


@pytest.mark.parametrize("pooled", [False, True])
def test_chunked_verify_equals_monolithic_and_reference(batch, pooled):
    items, mono = batch
    pool = HostStagePool(2) if pooled else None
    try:
        h = v3.verify_launch(items, device="cpu", chunk=16, pool=pool)
    finally:
        if pool is not None:
            pool.shutdown()
    # item i at index i of one vector of the monolithic length
    assert h.device_out.shape == (v3._bucket(40),)
    assert h.fetch() == mono
    assert any(mono) and not all(mono)
    if not pooled:
        assert jv3.verify_launch(items, chunk=16)() == mono


def test_chunked_coalesced_launch_keeps_each_blocks_lanes(batch):
    items, mono = batch
    parts = [items[:5], [], items[5:21], items[21:]]
    many = v3.verify_launch_many(parts, device="cpu", chunk=16)
    assert [h() for h in many] == [mono[:5], [], mono[5:21], mono[21:]]
    assert [h.device_out.shape[0] for h in many] == [16, 0, 16, 32]
    # the chunk floor is MIN_BUCKET, as the reference's
    assert v3.verify_launch(items[:20], device="cpu", chunk=3).fetch() == mono[:20]


def test_chunks_are_observed_as_the_reference_observes_them(batch, monkeypatch):
    """Each chunk: one ``verify_chunk`` span and one stage observation;
    the batch: one ``verify_chunks_per_batch`` observation and ONE
    launch-ledger record with every chunk's bytes noted."""
    from fabric_tpu_torch import ops_metrics

    items, mono = batch
    reg, tracer = Registry(), Tracer(ring_blocks=4, slow_factor=0)
    monkeypatch.setattr(ops_metrics, "global_registry", lambda: reg)
    monkeypatch.setattr(v3, "global_tracer", lambda: tracer)
    led = pledger.LaunchLedger(registry=Registry(), tracer=Tracer())
    monkeypatch.setattr(pledger, "_global", led)
    root = tracer.begin_block(1)
    tok = tracer.attach(root)
    try:
        assert v3.verify_launch(items, device="cpu", chunk=16).fetch() == mono
    finally:
        tracer.detach(tok)
    tracer.finish_block(root)
    spans = [c for c in root.children if c.name == "verify_chunk"]
    assert [(c.attrs["chunk"], c.attrs["lanes"]) for c in spans] == [(0, 16), (1, 16), (2, 8)]
    assert reg.metric("verify_chunks_per_batch").value()["count"] == 1
    assert reg.metric("verify_chunk_stage_seconds").value(stage="stage_dispatch")["count"] == 3
    rows = led.report(rows=4)["recent"]
    assert len(rows) == 1 and rows[0]["h2d_bytes"] == 64 * v3.FRAME_COLS * 2


@pytest.fixture(scope="module")
def chunk_streams(net):  # noqa: F811
    blocks = _blocks(net, seed=20261019, n_blocks=BLOCKS)
    want = _reference(net, blocks)
    seed = JMemDB()
    seed.apply_updates(_seed_batch(), (1, 0))
    rows = [(ns, key, vv.value, vv.version) for (ns, key), vv in seed.iter_all()]
    people = [net["client"], *net["peers"]]
    idents = [(p.msp_id, p.identity.role, *p.identity.public_numbers) for p in people]
    _, _, carried = carry.from_reference(rows, POLICIES, idents)
    known = {(i.msp_id, i.role, i.qx, i.qy): i for i in carried}
    parser = JBlockValidator(net["mgr"], net["prov"], JMemDB())
    return [_decode(b, parser, net["mgr"], known) for b in blocks], want, rows


@pytest.mark.parametrize("chunk,coalesce,workers", [(16, 0, 0), (64, 4, 2)])
def test_blocks_through_a_chunking_validator_equal_the_reference(chunk_streams, monkeypatch,
                                                                 chunk, coalesce, workers):
    decoded, want, rows = chunk_streams
    state, prov, _ = carry.from_reference(rows, POLICIES, [])
    store = _Store()
    launches = []
    orig = v3._chunk_bounds

    def counted(n, c):
        bounds = orig(n, c)
        launches.append([pad for _, _, pad in bounds])
        return bounds

    monkeypatch.setattr(v3, "_chunk_bounds", counted)

    def commit(res):
        state.apply_updates(res.batch)
        store.txids.update(t for t, _ in res.txids)

    v = pv.BlockValidator(prov, state, block_store=store, device="cpu", verify_chunk=chunk,
                          host_stage_workers=workers)
    got = []
    try:
        with CommitPipeline(v, commit, depth=2, coalesce_blocks=coalesce) as pipe:
            if coalesce:
                got += pipe.submit_many(decoded)
            else:
                got += [r for r in map(pipe.submit, decoded) if r is not None]
            res = pipe.flush()
            if res is not None:
                got.append(res)
    finally:
        v.close()
    assert len(got) == len(decoded)
    for res, (flt, batch_rows, hist) in zip(got, want):
        assert res.tx_filter == flt, res.block.number
        assert _rows(res.batch) == batch_rows, res.block.number
        assert res.history == hist, res.block.number
    # the launches were chunked: more than one chunk, every chunk but a
    # batch's last exactly `chunk` lanes
    assert any(len(b) > 1 for b in launches), launches
    assert all(p == chunk for b in launches for p in b[:-1]), launches
