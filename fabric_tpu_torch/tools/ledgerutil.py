"""Offline ledger forensics: verify and compare (counterpart:
``fabric_tpu/tools/ledgerutil.py``; the reference's internal/ledgerutil).

Operates on closed ledger directories (a peer's ``<data>/<channel>``,
the chain in ``chains/`` in the reference's format): ``verify_ledger``
re-checks header numbers, the previous-hash chain, every data hash and
the commit-hash chain; ``compare_ledgers`` diffs two peers' ledgers
block by block to localize divergence.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

from fabric_tpu_torch import protoutil
from fabric_tpu_torch.ledger.blockstore import BlockStore
from fabric_tpu_torch.protos import messages as m


@dataclass
class VerifyResult:
    height: int = 0
    errors: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.errors


def verify_ledger(ledger_dir: str) -> VerifyResult:
    """Walk the block store checking: header numbers, previous-hash
    chaining, data-hash integrity, and commit-hash chaining."""
    import os

    store = BlockStore(os.path.join(ledger_dir, "chains"))
    res = VerifyResult(height=store.height)
    prev_hash = b""
    commit_hash = b""
    try:
        for num in range(store.height):
            blk = store.get_block(num)
            if blk is None:
                boot = store.bootstrap_info()
                if boot and num < boot[0]:
                    continue  # pre-snapshot blocks absent by design
                res.errors.append(f"block {num}: missing")
                continue
            if blk.header.number != num:
                res.errors.append(f"block {num}: header number {blk.header.number}")
            if prev_hash and blk.header.previous_hash != prev_hash:
                res.errors.append(f"block {num}: previous_hash mismatch")
            want_data = protoutil.block_data_hash(blk.data)
            if blk.header.data_hash != want_data:
                res.errors.append(f"block {num}: data_hash mismatch")
            idx = m.META_COMMIT_HASH
            if len(blk.metadata.metadata) > idx and blk.metadata.metadata[idx]:
                flt = protoutil.get_tx_filter(blk)
                want = hashlib.sha256(
                    commit_hash + protoutil.block_header_hash(blk.header)
                    + bytes(flt)
                ).digest()
                got = blk.metadata.metadata[idx]
                if got != want:
                    res.errors.append(f"block {num}: commit_hash chain broken")
                commit_hash = got
            prev_hash = protoutil.block_header_hash(blk.header)
    finally:
        store.close()
    return res


def compare_ledgers(dir_a: str, dir_b: str) -> dict:
    """Block-level diff of two ledgers; returns the first divergence
    (the reference's compare produces a diff record set)."""
    import os

    sa = BlockStore(os.path.join(dir_a, "chains"))
    sb = BlockStore(os.path.join(dir_b, "chains"))
    try:
        out = {
            "height_a": sa.height, "height_b": sb.height,
            "common_height": min(sa.height, sb.height),
            "first_divergence": None,
            "identical": True,
        }
        for num in range(out["common_height"]):
            a, b = sa.get_block(num), sb.get_block(num)
            ab = a.serialize() if a else b""
            bb = b.serialize() if b else b""
            if ab != bb:
                out["first_divergence"] = num
                out["identical"] = False
                break
        if sa.height != sb.height:
            out["identical"] = False
        return out
    finally:
        sa.close()
        sb.close()
