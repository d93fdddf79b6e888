"""Minimal Raft consensus for the ordering service (counterpart:
``fabric_tpu/ordering/raft.py``; the WAL's files are the reference's,
byte for byte).

The reference embeds etcd/raft as an in-process library and drives it
from `Chain.run` (orderer/consensus/etcdraft/chain.go:614,
node.go:23); this image ships no raft library, so the algorithm core
is implemented here directly — elections, log replication, commitment,
and a write-ahead log, per the Raft paper's §5 rules.  Scope matches
what the orderer needs: crash-fault tolerance on a small static
cluster with deterministic apply order; reconfiguration and snapshot
transfer ride on top (chain-level catch-up pulls blocks, as the
reference's follower chain does, orderer/common/follower).

Transport is injected (``comm/rpc.py`` in production, direct queues
in tests).  Timers are asyncio-based; all state transitions run on the
event loop, so there is no locking.  Election timeouts draw from the
node's own ``random.Random`` (``rng=``, which a caller may seed; a
fresh unseeded one by default), where the reference draws from module
``random``.
"""

from __future__ import annotations

import asyncio
import json
import os
import random
import struct
from dataclasses import dataclass

MSG_VOTE = "vote"
MSG_VOTE_RESP = "vote_resp"
MSG_APPEND = "append"
MSG_APPEND_RESP = "append_resp"
MSG_SNAP_HINT = "snap_hint"  # leader compacted past the follower

_LEN = struct.Struct(">I")


@dataclass
class Entry:
    term: int
    index: int
    data: bytes


class WAL:
    """Append-only entry log + term/vote metadata, fsync'd.

    Layout: meta.json {term, voted_for}; wal.bin frames of
    [u32 len | u64 term | u64 index | data].  Torn tails are truncated
    on open (same recovery stance as the blockstore)."""

    def __init__(self, dirpath: str):
        os.makedirs(dirpath, exist_ok=True)
        self.dir = dirpath
        self.meta_path = os.path.join(dirpath, "meta.json")
        self.wal_path = os.path.join(dirpath, "wal.bin")
        self.term = 0
        self.voted_for: str | None = None
        # compaction watermark: entries <= snap_index are gone from the
        # log (their effects live in the materialized block store —
        # the reference's WAL+snapshot split, etcdraft/storage.go)
        self.snap_index = 0
        self.snap_term = 0
        self.entries: list[Entry] = []
        self._load()
        self._f = open(self.wal_path, "ab")

    def _load(self):
        if os.path.exists(self.meta_path):
            with open(self.meta_path) as f:
                meta = json.load(f)
            self.term = meta.get("term", 0)
            self.voted_for = meta.get("voted_for")
            self.snap_index = meta.get("snap_index", 0)
            self.snap_term = meta.get("snap_term", 0)
        if not os.path.exists(self.wal_path):
            return
        good = 0
        with open(self.wal_path, "rb") as f:
            blob = f.read()
        off = 0
        while off + 20 <= len(blob):
            (ln,) = _LEN.unpack(blob[off:off + 4])
            term, index = struct.unpack(">QQ", blob[off + 4:off + 20])
            if off + 20 + ln > len(blob):
                break  # torn write
            data = blob[off + 20:off + 20 + ln]
            ent = Entry(term, index, data)
            # replace-from semantics: an entry with index i overwrites
            # any previously-read suffix from i (leader change rewrote it)
            while self.entries and self.entries[-1].index >= index:
                self.entries.pop()
            if index > self.snap_index:  # compacted entries are gone
                self.entries.append(ent)
            off += 20 + ln
            good = off
        if good != len(blob):
            with open(self.wal_path, "r+b") as f:
                f.truncate(good)

    def save_meta(self, term: int, voted_for: str | None):
        self.term, self.voted_for = term, voted_for
        tmp = self.meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({
                "term": term, "voted_for": voted_for,
                "snap_index": self.snap_index, "snap_term": self.snap_term,
            }, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.meta_path)

    def _rewrite(self):
        self._f.close()
        tmp = self.wal_path + ".tmp"
        with open(tmp, "wb") as f:
            for e in self.entries:
                f.write(_LEN.pack(len(e.data))
                        + struct.pack(">QQ", e.term, e.index) + e.data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.wal_path)
        self._f = open(self.wal_path, "ab")

    def compact_to(self, index: int) -> int:
        """Drop entries <= index from the log (they are materialized in
        the block store); records the (snap_index, snap_term)
        watermark.  → number of entries dropped."""
        if index <= self.snap_index:
            return 0
        dropped = 0
        term = self.snap_term
        for e in self.entries:
            if e.index <= index:
                dropped += 1
                term = e.term
        if not dropped:
            return 0
        self.entries = [e for e in self.entries if e.index > index]
        self.snap_index = index
        self.snap_term = term
        self.save_meta(self.term, self.voted_for)  # watermark FIRST
        self._rewrite()
        return dropped

    def install_snapshot(self, index: int, term: int) -> None:
        """Out-of-band catch-up installed state through ``index`` (the
        chain pulled the blocks): the log restarts after it."""
        self.entries = [e for e in self.entries if e.index > index]
        self.snap_index = index
        self.snap_term = term
        self.save_meta(self.term, self.voted_for)
        self._rewrite()

    def append(self, entries: list[Entry]):
        for e in entries:
            self._f.write(_LEN.pack(len(e.data)) + struct.pack(">QQ", e.term, e.index) + e.data)
        self._f.flush()
        os.fsync(self._f.fileno())
        self.entries.extend(entries)

    def truncate_from(self, index: int):
        """Drop log entries >= index (conflict rewrite).  Rewrites the
        file — raft conflicts are rare, and compaction keeps the log
        short, so the rewrite is bounded by the retention window."""
        self.entries = [e for e in self.entries if e.index < index]
        self._rewrite()

    def close(self):
        self._f.close()


class RaftNode:
    """One member of a static cluster.

    apply_cb(entry) fires exactly once per committed entry, in index
    order, on every live node.  send_cb(peer_id, msg_dict) delivers a
    message (fire-and-forget; loss tolerated)."""

    def __init__(self, node_id: str, peers: list[str], wal: WAL,
                 apply_cb, send_cb,
                 election_timeout: tuple[float, float] = (0.15, 0.30),
                 heartbeat: float = 0.05, catchup_cb=None,
                 rng: random.Random | None = None):
        self.id = node_id
        self.rng = rng if rng is not None else random.Random()
        self.peers = [p for p in peers if p != node_id]
        self.wal = wal
        self.apply_cb = apply_cb
        self.send_cb = send_cb
        # catchup_cb(snap_index, snap_term): the leader compacted past
        # this follower — pull state out-of-band (blocks from the
        # cluster, the follower-chain pattern) then install_snapshot
        self.catchup_cb = catchup_cb
        self.election_timeout = election_timeout
        self.heartbeat = heartbeat

        self.state = "follower"
        self.leader_id: str | None = None
        # a compacted WAL restarts with everything <= snap_index
        # already materialized by the chain
        self.commit_index = wal.snap_index
        self.last_applied = wal.snap_index
        self.next_index: dict[str, int] = {}
        self.match_index: dict[str, int] = {}
        self.votes: set[str] = set()
        self._timer: asyncio.TimerHandle | None = None
        self._hb_task: asyncio.Task | None = None
        self._stopped = False
        self._apply_waiters: list = []

    # -- log helpers -------------------------------------------------------

    @property
    def last_index(self) -> int:
        return self.wal.entries[-1].index if self.wal.entries else self.wal.snap_index

    @property
    def last_term(self) -> int:
        return self.wal.entries[-1].term if self.wal.entries else self.wal.snap_term

    def _entry(self, index: int) -> Entry | None:
        if not self.wal.entries:
            return None
        base = self.wal.entries[0].index
        i = index - base
        if 0 <= i < len(self.wal.entries):
            return self.wal.entries[i]
        return None

    # -- lifecycle ----------------------------------------------------------

    def start(self):
        self._reset_election_timer()
        # replay committed state is the chain's job (it persists blocks)

    def stop(self):
        self._stopped = True
        if self._timer:
            self._timer.cancel()
        if self._hb_task:
            self._hb_task.cancel()

    # -- timers --------------------------------------------------------------

    def _reset_election_timer(self):
        if self._timer:
            self._timer.cancel()
        if self._stopped:
            return
        delay = self.rng.uniform(*self.election_timeout)
        self._timer = asyncio.get_event_loop().call_later(delay, self._election_timeout)

    def _election_timeout(self):
        if self._stopped or self.state == "leader":
            return
        self._start_election()

    def _start_election(self):
        self.state = "candidate"
        self.wal.save_meta(self.wal.term + 1, self.id)
        self.votes = {self.id}
        self.leader_id = None
        self._reset_election_timer()
        for p in self.peers:
            self.send_cb(p, {
                "type": MSG_VOTE, "term": self.wal.term, "from": self.id,
                "last_index": self.last_index, "last_term": self.last_term,
            })
        self._maybe_win()

    def _maybe_win(self):
        if self.state == "candidate" and len(self.votes) * 2 > len(self.peers) + 1:
            self._become_leader()

    def _become_leader(self):
        self.state = "leader"
        self.leader_id = self.id
        for p in self.peers:
            self.next_index[p] = self.last_index + 1
            self.match_index[p] = 0
        if self._timer:
            self._timer.cancel()
        self._hb_task = asyncio.ensure_future(self._heartbeat_loop())

    async def _heartbeat_loop(self):
        while not self._stopped and self.state == "leader":
            for p in self.peers:
                self._send_append(p)
            await asyncio.sleep(self.heartbeat)

    # -- client API ----------------------------------------------------------

    def propose(self, data: bytes) -> int | None:
        """Leader-only: append + replicate; → assigned index or None."""
        if self.state != "leader":
            return None
        ent = Entry(self.wal.term, self.last_index + 1, data)
        self.wal.append([ent])
        self.match_index[self.id] = ent.index
        for p in self.peers:
            self._send_append(p)
        self._advance_commit()
        return ent.index

    async def wait_applied(self, index: int, digest: str | None = None):
        # raft never reassigns indices (leader-append-only log), so the
        # digest confirmation the BFT consenter needs is a no-op here
        if self.last_applied >= index:
            return
        ev = asyncio.Event()
        tup = (index, ev)
        self._apply_waiters.append(tup)
        try:
            await ev.wait()
        finally:
            # cancelled waiters (deposed-leader broadcast timeouts)
            # must not pile up in the list forever
            try:
                self._apply_waiters.remove(tup)
            except ValueError:
                pass

    # -- message handling ------------------------------------------------------

    def handle(self, msg: dict):
        if self._stopped:
            return
        t = msg["term"]
        if t > self.wal.term:
            self.wal.save_meta(t, None)
            if self.state == "leader" and self._hb_task:
                self._hb_task.cancel()
            self.state = "follower"
            self._reset_election_timer()
        kind = msg["type"]
        if kind == MSG_VOTE:
            self._on_vote(msg)
        elif kind == MSG_VOTE_RESP:
            self._on_vote_resp(msg)
        elif kind == MSG_APPEND:
            self._on_append(msg)
        elif kind == MSG_APPEND_RESP:
            self._on_append_resp(msg)
        elif kind == MSG_SNAP_HINT:
            self._on_snap_hint(msg)

    def _on_snap_hint(self, msg):
        # term ordering must not gate the catch-up ACTION: a follower
        # whose term churned above the leader's (election storms while
        # partitioned) would otherwise discard the only message kind
        # the leader sends it (next_index < snap_index ⇒ hints, never
        # AppendEntries) and keep churning until vote traffic happens
        # to converge the terms.  Acting on a stale-term hint is safe —
        # catchup_cb pulls SIGNED blocks and verifies them before
        # installing — so only the election-timer reset (a leadership
        # claim) stays term-gated.
        if msg["snap_index"] <= self.last_applied:
            return
        if msg["term"] >= self.wal.term:
            self._reset_election_timer()
        if self.catchup_cb is not None:
            self.catchup_cb(msg["snap_index"], msg["snap_term"])

    def install_snapshot(self, index: int, term: int) -> None:
        """The chain pulled and materialized blocks through raft index
        ``index`` out-of-band: fast-forward the log state so
        replication resumes after it."""
        if index <= self.last_applied:
            return
        self.wal.install_snapshot(index, term)
        self.commit_index = max(self.commit_index, index)
        self.last_applied = max(self.last_applied, index)
        if self._apply_waiters:
            rest = []
            for idx, ev in self._apply_waiters:
                if self.last_applied >= idx:
                    ev.set()
                else:
                    rest.append((idx, ev))
            self._apply_waiters = rest

    def update_peers(self, peers: list[str]) -> None:
        """Consenter-set change from a committed config block (the
        etcdraft reconfiguration path, chain.go:1115; single-server
        changes at a time, as etcd applies them)."""
        self.peers = [p for p in peers if p != self.id]
        for p in self.peers:
            self.next_index.setdefault(p, self.last_index + 1)
            self.match_index.setdefault(p, 0)
        for gone in set(self.next_index) - set(self.peers):
            self.next_index.pop(gone, None)
            self.match_index.pop(gone, None)

    def _on_vote(self, msg):
        grant = False
        if msg["term"] == self.wal.term and self.wal.voted_for in (None, msg["from"]):
            up_to_date = (msg["last_term"], msg["last_index"]) >= (self.last_term, self.last_index)
            if up_to_date:
                grant = True
                self.wal.save_meta(self.wal.term, msg["from"])
                self._reset_election_timer()
        self.send_cb(msg["from"], {
            "type": MSG_VOTE_RESP, "term": self.wal.term,
            "from": self.id, "granted": grant,
        })

    def _on_vote_resp(self, msg):
        if self.state == "candidate" and msg["term"] == self.wal.term and msg["granted"]:
            self.votes.add(msg["from"])
            self._maybe_win()

    def _send_append(self, peer: str):
        ni = self.next_index.get(peer, self.last_index + 1)
        if ni <= self.wal.snap_index:
            # the entries this follower needs are compacted away: it
            # must catch up from the block store (follower_chain.go),
            # then resume replication after the snapshot watermark
            self.send_cb(peer, {
                "type": MSG_SNAP_HINT, "term": self.wal.term,
                "from": self.id, "snap_index": self.wal.snap_index,
                "snap_term": self.wal.snap_term,
            })
            return
        prev = self._entry(ni - 1)
        prev_term = prev.term if prev else (
            self.wal.snap_term if ni - 1 == self.wal.snap_index else 0
        )
        ents = []
        idx = ni
        while True:
            e = self._entry(idx)
            if e is None or len(ents) >= 64:
                break
            ents.append({"term": e.term, "index": e.index, "data": e.data.hex()})
            idx += 1
        self.send_cb(peer, {
            "type": MSG_APPEND, "term": self.wal.term, "from": self.id,
            "prev_index": ni - 1, "prev_term": prev_term,
            "entries": ents, "commit": self.commit_index,
        })

    def _on_append(self, msg):
        ok = False
        if msg["term"] == self.wal.term:
            if self.state != "follower":
                if self._hb_task:
                    self._hb_task.cancel()
                self.state = "follower"
            self.leader_id = msg["from"]
            self._reset_election_timer()
            prev_i, prev_t = msg["prev_index"], msg["prev_term"]
            prev = self._entry(prev_i)
            if prev_i == 0 or (prev is not None and prev.term == prev_t) or (
                prev_i == self.wal.snap_index
                and prev_t == self.wal.snap_term
            ):
                ok = True
                new = []
                for em in msg["entries"]:
                    mine = self._entry(em["index"])
                    if mine is not None and mine.term != em["term"]:
                        self.wal.truncate_from(em["index"])
                        mine = None
                    if mine is None:
                        new.append(Entry(em["term"], em["index"], bytes.fromhex(em["data"])))
                if new:
                    self.wal.append(new)
                if msg["commit"] > self.commit_index:
                    self.commit_index = min(msg["commit"], self.last_index)
                    self._apply_committed()
        self.send_cb(msg["from"], {
            "type": MSG_APPEND_RESP, "term": self.wal.term, "from": self.id,
            "ok": ok, "last_index": self.last_index,
            "prev_index": msg["prev_index"], "n": len(msg["entries"]),
        })

    def _on_append_resp(self, msg):
        if self.state != "leader" or msg["term"] != self.wal.term:
            return
        peer = msg["from"]
        if msg["ok"]:
            mi = msg["prev_index"] + msg["n"]
            self.match_index[peer] = max(self.match_index.get(peer, 0), mi)
            self.next_index[peer] = self.match_index[peer] + 1
            self._advance_commit()
            if self.next_index[peer] <= self.last_index:
                self._send_append(peer)
        else:
            self.next_index[peer] = max(1, self.next_index.get(peer, 1) - 1)
            self._send_append(peer)

    def _advance_commit(self):
        n = len(self.peers) + 1
        for idx in range(self.commit_index + 1, self.last_index + 1):
            e = self._entry(idx)
            if e is None or e.term != self.wal.term:
                continue  # §5.4.2: only current-term entries commit by count
            votes = 1 + sum(1 for p in self.peers if self.match_index.get(p, 0) >= idx)
            if votes * 2 > n:
                self.commit_index = idx
        self._apply_committed()

    def _apply_committed(self):
        while self.last_applied < self.commit_index:
            self.last_applied += 1
            e = self._entry(self.last_applied)
            self.apply_cb(e)
        if self._apply_waiters:
            rest = []
            for idx, ev in self._apply_waiters:
                if self.last_applied >= idx:
                    ev.set()
                else:
                    rest.append((idx, ev))
            self._apply_waiters = rest
