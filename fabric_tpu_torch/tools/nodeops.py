"""Offline peer-channel operations: rollback / reset / unjoin /
rebuild-dbs (counterpart: ``fabric_tpu/tools/nodeops.py``; the
reference's internal/peer/node/{rollback,reset,unjoin,rebuild_dbs}.go).

Filesystem surgery on a STOPPED peer's channel directory: everything
but the block segments is derived state, rebuilt by replay on the next
start (``KVLedger.recover``).
"""

from __future__ import annotations

import os
import shutil
import struct

_LEN = struct.Struct("<I")

# everything except the block segments is derived state
_DERIVED = (
    "state.db", "state.db-wal", "state.db-shm",
    "history.db", "history.db-wal", "history.db-shm",
    "pvtdata.db", "pvtdata.db-wal", "pvtdata.db-shm",
    "transient.db", "transient.db-wal", "transient.db-shm",
    "confighistory.db", "confighistory.db-wal", "confighistory.db-shm",
)


def _drop_derived(channel_dir: str) -> list:
    dropped = []
    for name in _DERIVED:
        p = os.path.join(channel_dir, name)
        if os.path.exists(p):
            os.unlink(p)
            dropped.append(name)
    # the block index (chains/index.db) is derived from the segments
    for idx in ("index.db", "index.db-wal", "index.db-shm"):
        p = os.path.join(channel_dir, "chains", idx)
        if os.path.exists(p):
            os.unlink(p)
            dropped.append(f"chains/{idx}")
    return dropped


def reset(channel_dir: str) -> dict:
    """Drop ALL derived databases (state, history, indexes); block
    segments stay.  Next start replays the chain from block 0
    (node/reset.go)."""
    dropped = _drop_derived(channel_dir)
    return {"channel_dir": channel_dir, "dropped": dropped}


def rebuild_dbs(channel_dir: str) -> dict:
    """Alias surface of the reference's rebuild-dbs (reset keeps the
    same post-condition here: derived DBs rebuilt by replay)."""
    out = reset(channel_dir)
    out["op"] = "rebuild-dbs"
    return out


def unjoin(channel_dir: str) -> dict:
    """Remove the channel entirely from this peer (node/unjoin.go)."""
    if not os.path.isdir(channel_dir):
        raise FileNotFoundError(channel_dir)
    shutil.rmtree(channel_dir)
    return {"channel_dir": channel_dir, "removed": True}


def rollback(channel_dir: str, block_number: int) -> dict:
    """Truncate the chain so ``block_number`` is the LAST block
    (node/rollback.go), dropping every derived DB — the next start
    replays state up to the rollback point.

    Block segments are scanned for the cut point; later segments are
    deleted and the containing segment truncated."""
    dirpath = os.path.join(channel_dir, "chains")
    seg_names = sorted(
        n for n in os.listdir(dirpath)
        if n.startswith("blocks_") and n.endswith(".bin")
    )
    if not seg_names:
        raise FileNotFoundError(f"no block segments under {dirpath}")

    from fabric_tpu_torch.protos import messages as m

    cut_done = False
    removed_blocks = 0
    for name in seg_names:
        path = os.path.join(dirpath, name)
        if cut_done:
            os.unlink(path)
            continue
        with open(path, "rb") as f:
            blob = f.read()
        off = 0
        keep = None
        while off + _LEN.size <= len(blob):
            (ln,) = _LEN.unpack(blob[off:off + _LEN.size])
            end = off + _LEN.size + ln
            if end > len(blob):
                break
            blk = m.Block.parse(blob[off + _LEN.size:end])
            if blk.header.number > block_number:
                keep = off
                break
            off = end
        if keep is not None:
            removed_blocks += 1  # at least; exact count not needed
            with open(path, "r+b") as f:
                f.truncate(keep)
            cut_done = True
    _drop_derived(channel_dir)
    return {
        "channel_dir": channel_dir, "rolled_back_to": block_number,
        "truncated": cut_done,
    }
