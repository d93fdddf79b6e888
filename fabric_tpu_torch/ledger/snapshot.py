"""Ledger snapshots: export, verify, join (counterpart:
``fabric_tpu/ledger/snapshot.py``; the reference's
kvledger/snapshot.go).

``generate_snapshot`` writes the public and hashed-collection state
(``public_state.data``) and the committed tx ids with their codes
(``txids.data``) as length-prefixed records, and hashes each file into
``_snapshot_signable_metadata.json``; the files are the reference's,
byte for byte, for the same ledger.  ``create_from_snapshot`` builds a
ledger positioned at the snapshot's height: the state imported under
the exporter's savepoint, the block store bootstrapped with the chain
anchors and the tx-id index, the commit-hash chain seeded.
``warm_resident`` admits the snapshot's keys into a validator's
device-resident table (``state/residency.py``) before the first
replayed block.  ``state_digest`` is the order-insensitive content
hash two ledgers compare equal under iff their committed records are.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import struct

from fabric_tpu_torch import protoutil
from fabric_tpu_torch.ledger.statedb import UpdateBatch

_LEN = struct.Struct("<I")

STATE_FILE = "public_state.data"
TXIDS_FILE = "txids.data"
META_FILE = "_snapshot_signable_metadata.json"


class _HashingWriter:
    def __init__(self, path: str):
        self.f = open(path, "wb")
        self.h = hashlib.sha256()

    def record(self, *fields: bytes):
        for b in fields:
            hdr = _LEN.pack(len(b))
            self.f.write(hdr)
            self.f.write(b)
            self.h.update(hdr)
            self.h.update(b)

    def close(self) -> str:
        self.f.close()
        return self.h.hexdigest()


def _iter_records(path: str, arity: int):
    with open(path, "rb") as f:
        while True:
            hdr = f.read(4)
            if not hdr:
                return
            fields = []
            for i in range(arity):
                if i:
                    hdr = f.read(4)
                (n,) = _LEN.unpack(hdr)
                fields.append(f.read(n))
            yield tuple(fields)


def _file_hash(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _version_bytes(ver) -> bytes:
    return _LEN.pack(ver[0]) + _LEN.pack(ver[1])


def generate_snapshot(ledger, out_dir: str, channel_id: str = "",
                      config_bytes: bytes = b"") -> dict:
    """Export ``ledger`` (a ``KVLedger``) at its height (the
    reference's :75); returns the signable metadata.  The caller keeps
    commits out meanwhile."""
    os.makedirs(out_dir, exist_ok=True)
    ledger.drain_state()
    height = ledger.blocks.height
    if height == 0:
        raise ValueError("cannot snapshot an empty ledger")
    last = ledger.blocks.get_block(height - 1)
    if last is not None:
        last_hash = protoutil.block_header_hash(last.header).hex()
        prev_hash = last.header.previous_hash.hex()
    else:  # joined from a snapshot, nothing committed since
        boot = ledger.blocks.bootstrap_info()
        if boot is None:
            raise ValueError("empty store without bootstrap anchor")
        last_hash = boot[1].hex()
        prev_hash = ""

    sw = _HashingWriter(os.path.join(out_dir, STATE_FILE))
    for (ns, key), vv in ledger.state.iter_all():
        # a collection's cleartext is per-peer: only its hashes export
        if "$" in ns and not ns.endswith("#hashed"):
            continue
        sw.record(ns.encode(), key.encode(), vv.value or b"", _version_bytes(vv.version),
                  vv.metadata or b"")
    state_hash = sw.close()

    tw = _HashingWriter(os.path.join(out_dir, TXIDS_FILE))
    for txid, code in ledger.blocks.iter_txid_codes():
        tw.record(txid.encode(), bytes([code & 0xFF]))
    txids_hash = tw.close()

    sp = ledger.state.savepoint()
    meta = {
        "channel_name": channel_id,
        "last_block_number": height - 1,
        "last_block_hash": last_hash,
        "previous_block_hash": prev_hash,
        "last_commit_hash": (ledger.commit_hash or b"").hex(),
        "height": height,
        "state_savepoint": list(sp) if sp is not None else None,
        "config": config_bytes.hex(),
        "files": {STATE_FILE: state_hash, TXIDS_FILE: txids_hash},
    }
    with open(os.path.join(out_dir, META_FILE), "w") as f:
        json.dump(meta, f, sort_keys=True, indent=1)
    return meta


def verify_snapshot(snap_dir: str) -> dict:
    """Check every file's hash against the metadata, which it returns
    (the reference's :149); raises ``ValueError`` on a mismatch."""
    with open(os.path.join(snap_dir, META_FILE)) as f:
        meta = json.load(f)
    for name, want in meta["files"].items():
        if _file_hash(os.path.join(snap_dir, name)) != want:
            raise ValueError(f"snapshot file {name} hash mismatch")
    return meta


def create_from_snapshot(snap_dir: str, ledger_dir: str, state_db=None,
                         enable_history: bool = True, async_commit: bool = False,
                         apply_queue_blocks: int = 4):
    """A new ``KVLedger`` in the empty ``ledger_dir`` positioned at the
    snapshot's height (the reference's :161) → (ledger, meta).  It holds
    no history from before the snapshot."""
    from fabric_tpu_torch.ledger.kvledger import KVLedger

    meta = verify_snapshot(snap_dir)
    lg = KVLedger(ledger_dir, state_db=state_db, enable_history=enable_history,
                  async_commit=async_commit, apply_queue_blocks=apply_queue_blocks)
    if lg.blocks.height != 0:
        raise ValueError("ledger directory is not empty")
    last_block = meta["last_block_number"]
    sp = tuple(meta.get("state_savepoint") or (last_block, 0))
    batch = UpdateBatch()
    for n, (ns, key, value, ver, md) in enumerate(
            iter_state_records(snap_dir), 1):
        batch.put(ns, key, value, ver, md)
        if n % 10000 == 0:
            lg.state.apply_updates(batch, sp)
            batch = UpdateBatch()
    lg.state.apply_updates(batch, sp)
    lg.blocks.bootstrap_from_snapshot(
        last_block + 1, bytes.fromhex(meta["last_block_hash"]),
        ((t.decode(), c[0]) for t, c in _iter_records(os.path.join(snap_dir, TXIDS_FILE), 2)),
        commit_hash=bytes.fromhex(meta["last_commit_hash"]))
    lg.bootstrap_commit_hash(bytes.fromhex(meta["last_commit_hash"]) or None)
    return lg, meta


def iter_state_records(snap_dir: str):
    """``(ns, key, value, (block, txnum), metadata or None)`` off the
    snapshot's state file."""
    for ns, key, value, ver, md in _iter_records(os.path.join(snap_dir, STATE_FILE), 5):
        yield (ns.decode(), key.decode(), value,
               (_LEN.unpack(ver[:4])[0], _LEN.unpack(ver[4:])[0]), md or None)


def warm_resident(res, snap_dir: str, limit: int | None = None) -> int:
    """Admit the snapshot's keys, with their versions, into the
    resident table ``res`` (a ``ResidencyManager``; the reference's
    :224) in free slots, up to ``limit`` keys or capacity.  Returns the
    keys admitted (0 without a table)."""
    if res is None:
        return 0
    items = ((ns, key, ver) for ns, key, _v, ver, _m in iter_state_records(snap_dir))
    return res.warm(itertools.islice(items, limit))


def state_digest(state) -> str:
    """XOR of each committed record's sha256 in the snapshot's framing
    (the reference's :242): independent of iteration order and of the
    batch boundaries the writes came in."""
    acc = bytearray(32)
    for (ns, key), vv in state.iter_all():
        h = hashlib.sha256()
        for b in (ns.encode(), key.encode(), vv.value or b"", _version_bytes(vv.version),
                  vv.metadata or b""):
            h.update(_LEN.pack(len(b)))
            h.update(b)
        for i, x in enumerate(h.digest()):
            acc[i] ^= x
    return bytes(acc).hex()
