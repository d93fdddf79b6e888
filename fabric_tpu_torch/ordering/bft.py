"""BFT consensus for the ordering service (counterpart:
``fabric_tpu/ordering/bft.py``; the SmartBFT-consenter analog,
orderer/consensus/smartbft/chain.go — a view-based PBFT with signed
messages, running 3f+1 nodes and tolerating f byzantine).

The messages, their signed bytes (``_signable``), the WAL entries and
the commit-proof files are the reference's, so either package's node
reads the other's files and accepts the other's messages.  A signature
is checked on the host with ``crypto/msp.py::verify_signature`` (the
port's ``ec_ref``), where the reference's identities use OpenSSL;
``verifiers`` maps a node id to an identity of the port's MSP
(``MSPManager.deserialize_identity``).

The reference outsources BFT to the hyperledger-labs/SmartBFT library
and wraps it in a Chain that assembles proposals into blocks and
verifies quorum signatures on deliver (chain.go:360, verifier.go).
This module implements the consensus core directly — same stance as
ordering/raft.py for the CFT case:

* **Normal case** (PBFT): leader(view) assigns sequence numbers and
  broadcasts PRE-PREPARE(view, seq, payload); replicas PREPARE on a
  valid pre-prepare; 2f matching PREPAREs → COMMIT; 2f+1 COMMITs →
  apply.  Entries apply strictly in sequence order.
* **Authentication**: every message carries an ECDSA-P256 signature by
  the sending node over the canonical message bytes; receivers verify
  against the cluster's known certs (the consenter-set identities from
  channel config).  Unsigned/forged traffic is dropped — this is what
  upgrades crash-fault raft to byzantine fault tolerance.
* **View change**: replicas that see no progress on pending requests
  start VIEW-CHANGE(v+1) carrying their prepared set; 2f+1 view-change
  messages install the new view, whose leader re-proposes the highest
  prepared-but-uncommitted entries (PBFT §4.4 simplified for
  sequential commitment).
* **WAL**: applied entries persist via ordering.raft.WAL (term=view,
  index=seq) for restart recovery.

Interface-compatible with RaftNode (state/leader_id/propose/handle/
wait_applied/start/stop), so OrderingChain swaps consenters via a
constructor flag — the consensus.Chain SPI seam of the reference
(orderer/consensus/consensus.go:57).
"""

from __future__ import annotations

import asyncio
import glob
import hashlib
import json
import logging
import os
from dataclasses import dataclass, field

from fabric_tpu_torch.crypto.identity import Identity
from fabric_tpu_torch.crypto.msp import verify_signature
from fabric_tpu_torch.ordering.raft import WAL, Entry

log = logging.getLogger("fabric_tpu_torch.ordering.bft")

PRE_PREPARE = "bft_pre_prepare"
PREPARE = "bft_prepare"
COMMIT = "bft_commit"
VIEW_CHANGE = "bft_view_change"
NEW_VIEW = "bft_new_view"


def _digest(payload: bytes) -> str:
    return hashlib.sha256(payload).hexdigest()


def _signable(msg: dict) -> bytes:
    """Canonical bytes covered by the message signature."""
    core = {k: v for k, v in msg.items() if k not in ("sig", "from_cert")}
    return json.dumps(core, sort_keys=True).encode()


@dataclass
class _SlotState:
    payload: bytes | None = None
    pre_prepared: bool = False
    view: int = -1                                    # pre-prepare's view
    prepares: dict = field(default_factory=dict)      # node -> digest
    prepare_msgs: dict = field(default_factory=dict)  # node -> signed msg
    commits: dict = field(default_factory=dict)       # node -> (view, digest)
    commit_msgs: dict = field(default_factory=dict)   # node -> signed msg
    committed: bool = False


class BFTNode:
    """One cluster member's consensus state machine for one channel."""

    def __init__(self, node_id: str, peers: list[str], wal: WAL,
                 apply_cb, send_cb, signer=None, verifiers=None,
                 view_timeout: float = 2.0, catchup_cb=None,
                 catchup_gap: int = 8):
        """peers: ALL cluster node ids (including self).
        signer: SigningIdentity for outbound messages (None = unsigned
        dev mode, only acceptable in tests).
        verifiers: {node_id: an identity of the port's MSP}.
        catchup_cb(target_seq, view): the replica detected a sequence
        gap it cannot close from live traffic (messages ``catchup_gap``
        past its application point, or a new-view base beyond it) —
        the chain pulls the missing BLOCKS from cluster peers,
        verifies their 2f+1 attestations, and calls install_snapshot
        (the SmartBFT synchronizer.go:40 Sync analog)."""
        self.id = node_id
        self.peers = sorted(set(peers) | {node_id})
        self.n = len(self.peers)
        self.f = (self.n - 1) // 3
        self.quorum = 2 * self.f + 1
        self.wal = wal
        self.apply_cb = apply_cb
        self.send_cb = send_cb
        self.signer = signer
        self.verifiers = verifiers or {}
        self.view_timeout = view_timeout
        self.catchup_cb = catchup_cb
        self.catchup_gap = max(1, catchup_gap)

        self.view = 0
        # a compacted WAL restarts with everything <= snap_index
        # materialized by the chain already
        self.next_seq = wal.snap_index + 1  # leader's next sequence
        self.last_applied = wal.snap_index
        self.slots: dict[int, _SlotState] = {}
        self.view_changes: dict[int, dict] = {}  # new_view -> {node: vc}
        self._applied_digest: dict[int, str] = {}  # seq -> payload digest
        self._commit_proofs: dict[int, list] = {}  # seq -> quorum COMMITs
        self._applied_ev: dict[int, asyncio.Event] = {}
        self._progress_task: asyncio.Task | None = None
        self._pending_since: float | None = None
        self._stopped = True

    # -- identity/roles ----------------------------------------------------

    @property
    def leader_id(self) -> str:
        return self.peers[self.view % self.n]

    @property
    def state(self) -> str:
        return "leader" if self.leader_id == self.id else "follower"

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        self._stopped = False
        # recover applied entries from the WAL, RE-FIRING apply_cb for
        # each (the chain counts recovered batches and skips the ones
        # already materialized as blocks — same contract as raft replay)
        for e in self.wal.entries:
            if e.index == self.last_applied + 1:
                self.last_applied = e.index
                self.view = max(self.view, e.term)
                self.apply_cb(e)
        self.next_seq = self.last_applied + 1
        self._progress_task = asyncio.ensure_future(self._progress_loop())

    def stop(self):
        self._stopped = True
        if self._progress_task:
            self._progress_task.cancel()

    # -- outbound ----------------------------------------------------------

    def _sign(self, msg: dict) -> dict:
        if self.signer is not None:
            msg["sig"] = self.signer.sign(_signable(msg)).hex()
        return msg

    def _bcast(self, msg: dict):
        msg = self._sign(msg)
        for p in self.peers:
            if p != self.id:
                self.send_cb(p, msg)
        # loopback: a node is a voter in its own quorum
        self.handle(dict(msg), verified=True)

    def _verify(self, msg: dict) -> bool:
        sender = msg.get("from")
        if sender == self.id:
            # a NETWORK message claiming to be from this very node
            # (loopback passes verified=True and never lands here) —
            # e.g. a byzantine leader fabricating a prepare "by us"
            # inside a view-change certificate.  Verify against our own
            # identity instead of rubber-stamping.
            if self.signer is None:
                return True
            sig = msg.get("sig")
            if not sig:
                return False
            try:
                return verify_signature(self._own_identity(), _signable(msg),
                                        bytes.fromhex(sig))
            except Exception:
                return False
        ver = self.verifiers.get(sender)
        if ver is None:
            # dev mode: no verifier registry → accept (tests);
            # production always configures the consenter identity set
            return not self.verifiers
        sig = msg.get("sig")
        if not sig:
            return False
        try:
            return verify_signature(ver, _signable(msg), bytes.fromhex(sig))
        except Exception:
            return False

    def _own_identity(self) -> Identity:
        """This node's public identity (the reference's
        ``signer.identity``): the signer's P-256 key."""
        if getattr(self, "_own", None) is None:
            qx, qy = self.signer.public
            self._own = Identity(self.signer.msp_id, "orderer", qx, qy)
        return self._own

    # -- client entry ------------------------------------------------------

    def propose(self, payload: bytes) -> int | None:
        """Leader assigns the next sequence and drives agreement."""
        if self.state != "leader" or self._stopped:
            return None
        seq = self.next_seq
        self.next_seq += 1
        self._bcast({
            "type": PRE_PREPARE, "from": self.id, "view": self.view,
            "seq": seq, "payload": payload.hex(),
        })
        return seq

    async def wait_applied(self, seq: int, digest: str | None = None) -> bool:
        """Wait for seq to apply; with ``digest``, additionally confirm
        THE CALLER'S payload is what got applied — after a view change
        sequences are reassigned, and an ack for a different payload
        would make the client drop a tx that was never ordered."""
        if seq > self.last_applied:
            ev = self._applied_ev.setdefault(seq, asyncio.Event())
            await ev.wait()
        if digest is None:
            return True
        return self._applied_digest.get(seq) == digest

    # -- message handling --------------------------------------------------

    def handle(self, msg: dict, verified: bool = False):
        if self._stopped:
            return
        if not verified and not self._verify(msg):
            log.debug("%s: dropping unauthenticated %s from %s",
                      self.id, msg.get("type"), msg.get("from"))
            return
        t = msg.get("type")
        # schema guard: malformed fields from a byzantine sender must
        # be dropped, not allowed to raise mid-dispatch (the Step
        # stream handler would tear down on an escaped exception)
        if t in (PRE_PREPARE, PREPARE, COMMIT):
            if not isinstance(msg.get("seq"), int) or not isinstance(
                msg.get("view"), int
            ):
                return
        if t == PRE_PREPARE:
            self._on_pre_prepare(msg)
        elif t == PREPARE:
            self._on_prepare(msg)
        elif t == COMMIT:
            self._on_commit(msg)
        elif t == VIEW_CHANGE:
            self._on_view_change(msg)
        elif t == NEW_VIEW:
            self._on_new_view(msg)

    def _slot(self, seq: int) -> _SlotState:
        return self.slots.setdefault(seq, _SlotState())

    def _on_pre_prepare(self, msg):
        if msg["view"] != self.view or msg["from"] != self.leader_id:
            return
        seq = msg["seq"]
        if seq <= self.last_applied:
            return
        payload = bytes.fromhex(msg["payload"])
        # new-view re-proposal discipline: after a justified view
        # change, the first seqs are RESERVED for the certified
        # prepared entries every replica re-derived from the 2f+1
        # VIEW-CHANGEs (PBFT §4.4) — a new leader that substitutes a
        # different payload there (or drops one, shifting later
        # payloads into its slot) is refused
        exp = getattr(self, "_expected_repro", None)
        if exp:
            want = exp.get(seq)
            if want is not None:
                if want != _digest(payload):
                    log.warning(
                        "%s: view %d leader %s violated the new-view "
                        "re-proposal set at seq %d — refusing",
                        self.id, self.view, msg["from"], seq,
                    )
                    return
                del exp[seq]
        slot = self._slot(seq)
        if slot.pre_prepared and slot.payload != payload:
            return  # equivocating leader: keep the first, view change fixes
        slot.payload = payload
        slot.pre_prepared = True
        slot.view = self.view
        self._pending_since = self._pending_since or asyncio.get_event_loop().time()
        self._bcast({
            "type": PREPARE, "from": self.id, "view": self.view,
            "seq": seq, "digest": _digest(payload),
        })

    def _on_prepare(self, msg):
        if msg["view"] != self.view:
            return
        slot = self._slot(msg["seq"])
        slot.prepares[msg["from"]] = msg["digest"]
        slot.prepare_msgs[msg["from"]] = msg  # retained for VC certificates
        if slot.payload is None or slot.committed:
            return
        d = _digest(slot.payload)
        if sum(1 for v in slot.prepares.values() if v == d) >= self.quorum \
                and self.id not in slot.commits:
            commit = {
                "type": COMMIT, "from": self.id, "view": self.view,
                "seq": msg["seq"], "digest": d,
            }
            if self.signer is not None:
                # identity rides along (excluded from the signed bytes)
                # so deliver-side quorum verification can resolve the
                # sender without a consenter-identity registry
                commit["from_cert"] = self.signer.serialized.hex()
            self._bcast(commit)

    def _on_commit(self, msg):
        # commits are STORED regardless of view (a lagging replica must
        # not discard votes it can only count after catching up); the
        # PBFT committed predicate — 2f+1 commits matching the view the
        # slot was pre-prepared in — is enforced at counting time
        slot = self._slot(msg["seq"])
        slot.commits[msg["from"]] = (msg.get("view"), msg["digest"])
        slot.commit_msgs[msg["from"]] = msg
        self._try_apply()
        self._maybe_catchup(msg["from"], msg["seq"])

    def _maybe_catchup(self, sender: str, seq_seen: int) -> None:
        """Cluster traffic references sequences well past our
        application point while the next-in-line slot has no payload:
        the pre-prepares we're missing may be gone forever (view
        changes drop uncommitted slots; the WAL compacts), so pull
        the committed BLOCKS instead (synchronizer.go:40 Sync).

        The trigger needs f+1 DISTINCT consenters claiming such
        sequences — a single byzantine node must not be able to keep
        every replica running bogus pull tasks (the synchronizer's
        corroboration requirement).  The target is the (f+1)-th
        largest claim: at least one honest node vouches for it."""
        if self.catchup_cb is None:
            return
        claims = getattr(self, "_seq_claims", None)
        if claims is None:
            claims = self._seq_claims = {}
        claims[sender] = max(claims.get(sender, 0), seq_seen)
        vouched = self._vouched_seq()
        if vouched <= self.last_applied + self.catchup_gap:
            return
        nxt = self.slots.get(self.last_applied + 1)
        if nxt is not None and nxt.payload is not None:
            return  # live traffic can still close the gap
        self.catchup_cb(vouched - 1, self.view)

    def _vouched_seq(self) -> int:
        """The highest sequence at least one HONEST consenter has
        referenced: the (f+1)-th largest per-sender claim."""
        claims = getattr(self, "_seq_claims", {})
        tops = sorted(claims.values(), reverse=True)
        return tops[self.f] if len(tops) > self.f else 0

    def install_snapshot(self, index: int, term: int) -> None:
        """The chain materialized verified blocks through sequence
        ``index`` out-of-band (catch-up pull): fast-forward the
        consensus state so agreement resumes after it — the BFT mirror
        of RaftNode.install_snapshot."""
        if index <= self.last_applied:
            return
        self.wal.install_snapshot(index, term)
        self.view = max(self.view, term)
        self.last_applied = index
        self.next_seq = max(self.next_seq, index + 1)
        self._pending_since = None
        for seq in list(self.slots):
            if seq <= index:
                del self.slots[seq]
        for seq in [s for s in self._applied_ev if s <= index]:
            # waiters learn the seq applied; digest confirmation will
            # report False (the payload identity is unknown after a
            # block-level catch-up), which the broadcast path treats
            # as an unconfirmed ack — fail-safe for the client
            self._applied_ev.pop(seq).set()
        self._try_apply()  # buffered votes past the snapshot may apply
        # residual gap: a vouched-for sequence just above the snapshot
        # whose pre-prepare is gone stalls until traffic exceeds the
        # catchup gap again — re-pull NOW rather than sit blocks
        # behind while the channel is quiet
        vouched = self._vouched_seq()
        nxt = self.slots.get(self.last_applied + 1)
        if (
            self.catchup_cb is not None
            and vouched > self.last_applied
            and (nxt is None or nxt.payload is None)
        ):
            self.catchup_cb(vouched - 1, self.view)

    def _try_apply(self):
        while True:
            seq = self.last_applied + 1
            slot = self.slots.get(seq)
            if slot is None or slot.payload is None or slot.committed:
                return
            d = _digest(slot.payload)
            votes = [
                n for n, (v, dg) in slot.commits.items()
                if dg == d and v == slot.view
            ]
            if len(votes) < self.quorum:
                return
            slot.committed = True
            entry = Entry(term=slot.view, index=seq, data=slot.payload)
            # persist the quorum COMMIT proof BEFORE the WAL entry: on
            # restart the WAL replay re-materializes the block, and a
            # proof lost to a crash window would leave that block
            # unverifiable at every peer forever
            proof = [
                slot.commit_msgs[n] for n in votes if n in slot.commit_msgs
            ]
            self._persist_proof(seq, proof)
            self.wal.append([entry])
            self._applied_digest[seq] = d
            self._commit_proofs[seq] = proof
            if len(self._applied_digest) > 4096:
                for old in sorted(self._applied_digest)[:2048]:
                    del self._applied_digest[old]
                for old in sorted(self._commit_proofs)[:2048]:
                    self._commit_proofs.pop(old, None)
            self.last_applied = seq
            self._pending_since = None
            self.apply_cb(entry)
            ev = self._applied_ev.pop(seq, None)
            if ev:
                ev.set()

    def _proof_path(self, seq: int) -> str:
        d = os.path.join(self.wal.dir, "proofs")
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, f"{seq}.json")

    def _persist_proof(self, seq: int, proof: list) -> None:
        path = self._proof_path(seq)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(proof, f)
            f.flush()
            os.fsync(f.fileno())  # the WAL append that follows is
            # fsynced; the proof must be durable FIRST or a crash
            # window leaves a replayed block permanently unattestable
        os.replace(tmp, path)
        # prune far-stale proof files (blocks are materialized at
        # apply time, so anything this old is long since embedded)
        if seq > 8192 and seq % 512 == 0:
            for old in glob.glob(os.path.join(self.wal.dir, "proofs", "*.json")):
                try:
                    if int(os.path.basename(old).split(".")[0]) < seq - 8192:
                        os.unlink(old)
                except (ValueError, OSError):
                    pass

    def update_peers(self, peers: list[str]) -> None:
        """Consenter-set change from a committed config block: refresh
        the membership and the derived fault/quorum thresholds."""
        self.peers = sorted(set(peers) | {self.id})
        self.n = len(self.peers)
        self.f = (self.n - 1) // 3
        self.quorum = 2 * self.f + 1
        # removed consenters' catch-up claims must not keep vouching
        claims = getattr(self, "_seq_claims", None)
        if claims:
            self._seq_claims = {
                k: v for k, v in claims.items() if k in self.peers
            }

    def commit_proof(self, seq: int) -> list | None:
        """The 2f+1 signed COMMIT messages that committed ``seq`` —
        the quorum attestation the block carries to peers (SmartBFT's
        signature aggregation, chain.go:360).  Survives restart via the
        WAL-side proof files (a WAL replay must re-materialize blocks
        WITH their attestation)."""
        got = self._commit_proofs.get(seq)
        if got is not None:
            return got
        try:
            with open(self._proof_path(seq)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    # -- view change -------------------------------------------------------

    async def _progress_loop(self):
        """Replica-side failure detector: pending agreement with no
        progress for view_timeout → demand a view change."""
        while not self._stopped:
            try:
                await asyncio.sleep(self.view_timeout / 4)
                if self._pending_since is None:
                    continue
                now = asyncio.get_event_loop().time()
                if now - self._pending_since > self.view_timeout:
                    self._pending_since = now  # rate-limit re-sends
                    # escalate past consecutive dead leaders: each timer
                    # expiry targets one view further (PBFT's doubling
                    # timer serves the same liveness purpose)
                    self._vc_target = max(
                        getattr(self, "_vc_target", self.view), self.view
                    ) + 1
                    self._start_view_change(self._vc_target)
            except asyncio.CancelledError:
                return

    def note_client_request(self):
        """A client demand exists (follower got a broadcast): start the
        progress clock so a dead leader triggers a view change."""
        if self._pending_since is None:
            self._pending_since = asyncio.get_event_loop().time()

    def request_view_change(self):
        """Explicit trigger (e.g. broadcast timeout at a follower)."""
        self._start_view_change(self.view + 1)

    def _start_view_change(self, new_view: int):
        self._vc_sent = getattr(self, "_vc_sent", set())
        self._vc_sent.add(new_view)
        # only PREPARED entries (2f+1 matching signed PREPAREs — the
        # certificate) ride the view change: an uncertified claim must
        # not be able to override what another node already committed
        prepared = {}
        for seq, s in self.slots.items():
            if not (s.pre_prepared and seq > self.last_applied and s.payload):
                continue
            d = _digest(s.payload)
            cert = [m for m in s.prepare_msgs.values() if m.get("digest") == d]
            if len(cert) >= self.quorum:
                prepared[str(seq)] = {
                    "payload": s.payload.hex(), "view": self.view,
                    "cert": cert,
                }
        self._bcast({
            "type": VIEW_CHANGE, "from": self.id, "new_view": new_view,
            "last_applied": self.last_applied, "prepared": prepared,
        })

    def _cert_valid(self, seq: int, payload: bytes, cert: list) -> bool:
        """2f+1 distinct, correctly signed PREPAREs for (seq, digest)."""
        d = _digest(payload)
        senders = set()
        for m in cert:
            if not isinstance(m, dict) or m.get("type") != PREPARE:
                continue
            if m.get("seq") != seq or m.get("digest") != d:
                continue
            if m.get("from") in senders:
                continue
            # NO self bypass: a fabricated unsigned PREPARE claiming to
            # be "ours" must not strengthen a certificate (_verify
            # checks self-attributed messages against our own identity)
            if self._verify(m):
                senders.add(m.get("from"))
        return len(senders) >= self.quorum

    def _on_view_change(self, msg):
        nv = msg["new_view"]
        if nv <= self.view:
            return
        self.view_changes.setdefault(nv, {})[msg["from"]] = msg
        vcs = self.view_changes[nv]
        # PBFT liveness (§4.5.2): seeing f+1 distinct view-changes for
        # a higher view proves at least one honest node timed out —
        # join even if my own clock never started
        if len(vcs) > self.f and nv not in getattr(self, "_vc_sent", set()):
            self._start_view_change(nv)
        if len(vcs) >= self.quorum and self.peers[nv % self.n] == self.id:
            # I lead the new view: install + re-propose the certified
            # prepared entries; the NEW_VIEW carries the 2f+1 signed
            # VIEW-CHANGE messages as justification so every replica
            # re-derives (and will enforce) the same re-proposal set
            self._install_view(nv)
            base, repro = self._derive_reproposals(vcs.values())
            self._bcast({
                "type": NEW_VIEW, "from": self.id, "view": nv,
                "vcs": dict(vcs),
            })
            self.next_seq = base
            for _old_seq, payload in repro:
                s = self.next_seq
                self.next_seq += 1
                self._bcast({
                    "type": PRE_PREPARE, "from": self.id, "view": nv,
                    "seq": s, "payload": payload.hex(),
                })

    def _derive_reproposals(self, vcs) -> tuple:
        """→ (base_seq, certified prepared entries) a new view MUST
        re-propose: per sequence above the quorum's highest claimed
        last_applied, the highest-view entry backed by a valid 2f+1
        prepare certificate, in old-sequence order (PBFT §4.4).

        EVERYTHING here derives from the view-change set itself — never
        from this node's own last_applied — so the leader and every
        replica verifying the NEW_VIEW compute the SAME (base, repro)
        mapping even when their application states diverge.  The base
        is the (f+1)-th LARGEST claimed last_applied: at least one
        honest node vouches for it (a single byzantine consenter
        inflating its claim cannot move it), and sequential commitment
        makes every honestly-committed entry above it a certified
        prefix that re-lands on its original sequence numbers.  A node
        whose last_applied lags base has a gap it can only close by
        catch-up (see the raft follower-chain work)."""
        vcs = list(vcs)
        claims = sorted(
            (int(vc.get("last_applied", 0)) for vc in vcs), reverse=True
        )
        L = claims[self.f] if len(claims) > self.f else (
            claims[-1] if claims else 0
        )
        repro: dict[int, tuple[int, bytes]] = {}
        for vc in vcs:
            for seq_s, info in vc.get("prepared", {}).items():
                seq = int(seq_s)
                if seq <= L:
                    continue  # committed somewhere per the quorum claims
                try:
                    payload = bytes.fromhex(info["payload"])
                    cview = int(info.get("view", 0))
                except (KeyError, ValueError, TypeError):
                    continue
                if not self._cert_valid(seq, payload, info.get("cert", [])):
                    continue
                cur = repro.get(seq)
                if cur is None or cview > cur[0]:
                    repro[seq] = (cview, payload)
        return L + 1, [(seq, repro[seq][1]) for seq in sorted(repro)]

    def _on_new_view(self, msg):
        """Install a higher view ONLY on proof: the NEW_VIEW must carry
        2f+1 correctly signed VIEW-CHANGE messages for that view.  The
        replica re-derives the certified re-proposal set from them and
        _on_pre_prepare enforces that the new leader neither drops nor
        substitutes a certified prepared entry (reference: SmartBFT's
        view-change verification, orderer/consensus/smartbft/
        verifier.go; PBFT §4.4)."""
        v = msg["view"]
        if v <= self.view or msg["from"] != self.peers[v % self.n]:
            return
        valid = {}
        for node, vc in (msg.get("vcs") or {}).items():
            if not isinstance(vc, dict) or vc.get("type") != VIEW_CHANGE:
                continue
            if vc.get("from") != node or vc.get("new_view") != v:
                continue
            if self._verify(vc):
                valid[node] = vc
        if len(valid) < self.quorum:
            log.warning(
                "%s: NEW_VIEW %d from %s lacks a 2f+1 view-change "
                "justification — refusing to install",
                self.id, v, msg["from"],
            )
            return
        base, repro = self._derive_reproposals(valid.values())
        self._install_view(v)
        self._expected_repro = {
            base + off: _digest(payload)
            for off, (_seq, payload) in enumerate(repro)
        }
        if base > self.last_applied + 1 and self.catchup_cb is not None:
            # the quorum's claims prove sequences up to base-1 are
            # committed somewhere, and we missed them — the re-proposal
            # set will never include them, so block catch-up is the
            # ONLY way back (the gap the round-4 docstring documented)
            self.catchup_cb(base - 1, v)

    def _install_view(self, view: int):
        self.view = view
        self._vc_target = view
        self._pending_since = None
        # stale reservations from an earlier view change must not block
        # this view's sequences (set fresh by the new-view handler)
        self._expected_repro = {}
        # drop uncommitted slot votes from the old view (re-proposals
        # will rebuild them under the new view's sequences)
        for seq in list(self.slots):
            if seq > self.last_applied:
                del self.slots[seq]
        self.view_changes = {
            v: vcs for v, vcs in self.view_changes.items() if v > view
        }
