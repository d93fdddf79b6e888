"""Port-only helpers for the crash tests of ``tests/test_torch_faults.py``:
a child process imports this module (and no JAX) to commit toy blocks
into the port's ``KVLedger``."""

import json

from fabric_tpu_torch import protoutil as pu
from fabric_tpu_torch.ledger.statedb import UpdateBatch


def toy_blocks(n: int) -> list:
    """n chained port blocks, one JSON transaction each."""
    out, prev = [], b""
    for k in range(n):
        blk = pu.new_block(k, prev)
        blk.data.data.append(json.dumps({"id": f"tx{k}", "key": f"k{k}"}).encode())
        blk = pu.finalize_block(blk)
        prev = pu.block_header_hash(blk.header)
        out.append(blk)
    return out


def toy_txid(blk) -> str:
    return json.loads(bytes(blk.data.data[0]))["id"]


def toy_batch(blk) -> UpdateBatch:
    t = json.loads(bytes(blk.data.data[0]))
    batch = UpdateBatch()
    batch.put("ns", t["key"], b"v%d" % blk.header.number, (blk.header.number, 0))
    return batch


class _ToyPending:
    def __init__(self, block, raw):
        self.block, self.raw, self.txs = block, raw, []
        self.txids = {t["id"] for t in raw}


class ToyValidator:
    """The pipeline's validator protocol over one-transaction JSON
    blocks (no ``resident_commit``: the pipe skips it)."""

    def preprocess(self, block):
        return [json.loads(bytes(d)) for d in block.data.data]

    def validate_launch(self, block, pre=None, overlay=None, extra_txids=None):
        return _ToyPending(block, pre if pre is not None else self.preprocess(block))

    def validate_finish(self, pend):
        return bytes([0] * len(pend.raw)), toy_batch(pend.block), []
