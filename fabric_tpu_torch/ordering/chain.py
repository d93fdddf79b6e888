"""Per-channel ordering chain: broadcast → filters → blockcutter →
raft or BFT → deterministic block assembly → deliver (counterpart:
``fabric_tpu/ordering/chain.py``).

Reference shape: `Chain.run` propose/apply loop
(orderer/consensus/etcdraft/chain.go:614), broadcast filter chain
(orderer/common/msgprocessor/standardchannel.go:100), block writer
(orderer/common/multichannel/blockwriter.go).  Re-design notes:

* Raft entries are BATCHES (lists of envelopes), not blocks: every
  node assembles the block from the committed batch DETERMINISTICALLY
  (number = height, prev_hash = own chain tip) so the chain of blocks
  is identical on all nodes without shipping headers through raft.
  The entry's bytes and the ORDERER metadata are the reference's, so
  the same committed batches give the same block headers and hash
  chain in both packages.
* The batch timeout rides the leader's event loop; followers redirect
  Broadcast callers to the leader (the reference forwards instead —
  a client-visible difference kept deliberately: retry-with-redirect
  is simpler and the SDK contract allows it).
* Deliver is a height-watched block stream off the block store, the
  seek semantics of common/deliver/deliver.go:158.

``consensus="bft"`` runs ``ordering/bft.py``'s ``BFTNode`` in Raft's
place: its 2f+1 signed COMMIT messages ride the block's ORDERER
metadata as ``bft_proof``, a committed consenter-set change rotates
its verifier registry, and a catch-up pull accepts only blocks whose
proof verifies (``_catchup_block_ok``).

Durability coupling: the orderer's BlockStore runs with
``group_commit=1`` (fsync every block) — broadcast ACKs a batch once
raft commits it, and the block files are what WAL compaction trusts:
``_apply`` compacts the WAL back to ``wal_retention`` entries behind
the tip, so any block the store could lose in a crash must be
re-derivable from WAL replay or cluster pull.  Keep ``group_commit=1``
here unless compaction learns to lag the unsynced window.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import logging

from fabric_tpu_torch import protoutil
from fabric_tpu_torch.crypto.identity import Identity
from fabric_tpu_torch.crypto.msp import load_pem_certificate, verify_signature
from fabric_tpu_torch.ledger.blockstore import BlockStore
from fabric_tpu_torch.ordering.bft import COMMIT, BFTNode, _signable
from fabric_tpu_torch.ordering.blockcutter import BatchConfig, BlockCutter
from fabric_tpu_torch.ordering.raft import WAL, Entry, RaftNode
from fabric_tpu_torch.protos import messages as m

_log = logging.getLogger("fabric_tpu_torch.orderer")


class MsgProcessor:
    """Broadcast admission: size cap + the signature filter
    (sigfilter/sizefilter analogs, orderer/common/msgprocessor).

    ``policy_eval(signed_data_list) -> bool`` evaluates the channel's
    /Channel/Writers policy (wired from the genesis bundle by
    join_channel); with only an MSP manager the filter degrades to a
    bare valid-identity signature check; with neither (dev assemblies)
    admission is size-only."""

    def __init__(self, config: BatchConfig, msp_manager=None, policy=None,
                 policy_eval=None):
        self.config = config
        self.msp = msp_manager
        self.policy = policy
        self.policy_eval = policy_eval

    def check(self, env_bytes: bytes) -> str | None:
        """→ None if admitted, else reject reason."""
        if not env_bytes:
            return "empty envelope"
        if len(env_bytes) > self.config.absolute_max_bytes:
            return "message too large"
        if self.policy_eval is not None:
            try:
                sd = protoutil.envelope_as_signed_data(m.Envelope.parse(env_bytes))
                if not self.policy_eval([sd]):
                    return "Writers policy not satisfied"
            except Exception as e:
                return f"bad envelope: {e}"
        elif self.msp is not None and self.policy is not None:
            try:
                sd = protoutil.envelope_as_signed_data(m.Envelope.parse(env_bytes))
                ident = self.msp.deserialize_identity(sd.identity)
                if not ident.is_valid or not verify_signature(ident, sd.data, sd.signature):
                    return "signature check failed"
            except Exception as e:
                return f"bad envelope: {e}"
        return None


def _is_config(env_bytes: bytes) -> bool:
    try:
        return protoutil.channel_header(env_bytes).type == m.HEADER_CONFIG
    except Exception:
        return False


def assemble_block(number: int, prev_hash: bytes, batch: list[bytes], term: int,
                   index: int, signer=None, bft_proof: list | None = None) -> m.Block:
    """The block a committed batch becomes (the reference's ``_apply``
    :262-295): header over the batch, ORDERER metadata
    ``{"term", "index"}`` and, for BFT, ``"bft_proof"`` (the 2f+1
    signed COMMIT messages binding view, seq and the batch's digest —
    the quorum attestation peers check at deliver), the orderer's
    signature when ``signer``."""
    blk = protoutil.new_block(number, prev_hash)
    blk.data.data.extend(batch)
    blk = protoutil.finalize_block(blk)
    meta = {"term": term, "index": index}
    if bft_proof is not None:
        meta["bft_proof"] = bft_proof
    blk.metadata.metadata[m.META_ORDERER] = json.dumps(meta).encode()
    if signer is not None:
        protoutil.sign_block(blk, signer)
    return blk


def _consenter_identity(serialized: bytes) -> Identity:
    """A consenter's identity as a config block carries it (the
    reference's ``Identity.from_serialized``, taken as valid): the
    certificate's P-256 key under its MSP id."""
    sid = m.SerializedIdentity.parse(serialized)
    qx, qy = load_pem_certificate(sid.id_bytes).public_key
    return Identity(sid.mspid, "orderer", qx, qy)


class OrderingChain:
    """One channel's chain on one orderer node."""

    def __init__(self, channel_id: str, node_id: str, peers: list[str],
                 data_dir: str, send_cb, config: BatchConfig | None = None,
                 msgproc: MsgProcessor | None = None,
                 genesis_block: m.Block | None = None,
                 consensus: str = "raft", signer=None, verifiers=None,
                 view_timeout: float = 2.0, block_puller=None,
                 on_consenters=None, wal_retention: int = 256, rng=None):
        if consensus not in ("raft", "bft"):
            raise NotImplementedError(f"unknown consensus {consensus!r}")
        self.channel = channel_id
        self.config = config or BatchConfig()
        self.cutter = BlockCutter(self.config)
        self.msgproc = msgproc or MsgProcessor(self.config)
        self.signer = signer  # block attestation (blockwriter.go)
        # block_puller(channel, start, stop) → async iterator of
        # serialized blocks from cluster peers (snapshot catch-up);
        # on_consenters({id: (host, port)}) → transport re-wiring after
        # a committed consenter-set change
        self.block_puller = block_puller
        self.on_consenters = on_consenters
        self.wal_retention = wal_retention
        # group_commit=1: ACKed blocks must hit disk before WAL
        # compaction can outrun them (see module docstring)
        self.blocks = BlockStore(f"{data_dir}/chains", group_commit=1)
        if self.blocks.height == 0 and genesis_block is not None:
            self.blocks.add_block(genesis_block)
        # consenter selection — the consensus.Chain SPI seam
        # (consensus.go:57; registry main.go:635: etcdraft | BFT)
        if consensus == "bft":
            self.raft = BFTNode(node_id, peers, WAL(f"{data_dir}/wal"), apply_cb=self._apply,
                                send_cb=send_cb, signer=signer, verifiers=verifiers,
                                view_timeout=view_timeout,
                                catchup_cb=self._on_snapshot_hint)
        else:
            self.raft = RaftNode(node_id, peers, WAL(f"{data_dir}/wal"), apply_cb=self._apply,
                                 send_cb=send_cb, catchup_cb=self._on_snapshot_hint, rng=rng)
        self.consenter = self.raft  # canonical name; raft kept for compat
        self._offset = 0  # block number of raft entry 1, set at start()
        self._catchup_task: asyncio.Task | None = None
        self._catchup_pending = 0
        self._catchup_term = 0
        self._last_digest = None
        self._timer_task: asyncio.Task | None = None
        self._height_changed = asyncio.Event()

    # -- lifecycle ----------------------------------------------------------

    def _derive_offset(self) -> int:
        """Block number of raft entry 1.  Batch blocks carry ORDERER
        consensus metadata; a genesis/config block 0 doesn't — that
        distinguishes the two layouts (re-derived after catch-up too,
        in case block 0 arrived out-of-band)."""
        if self.blocks.height == 0:
            return 0
        md = self.blocks.get_block(0).metadata.metadata
        has_meta = len(md) > m.META_ORDERER and md[m.META_ORDERER]
        return 0 if has_meta else 1

    def start(self):
        # Map raft entry indices to block numbers so WAL replay skips
        # entries already materialized.
        self._offset = self._derive_offset()
        # committed membership changes must survive restart: the WAL
        # replay skips already-materialized entries (including config
        # blocks), so re-derive the consenter set from the chain
        self._reapply_config_membership()
        self.raft.start()

    def _reapply_config_membership(self) -> None:
        """Scan the chain tip-down for the most recent CONFIG block
        carrying a consenter set and re-apply it — restart replay and
        snapshot catch-up bypass _apply for materialized blocks, and a
        reverted membership would diverge from the cluster."""
        for num in range(self.blocks.height - 1, -1, -1):
            blk = self.blocks.get_block(num)
            if blk is None:
                return
            if self._maybe_reconfigure(list(blk.data.data)):
                return

    @property
    def _materialized(self) -> int:
        """Highest raft entry index already materialized as a block."""
        return max(0, self.blocks.height - self._offset)

    def stop(self):
        self.raft.stop()
        if self._timer_task:
            self._timer_task.cancel()
        self.blocks.close()

    # -- broadcast ----------------------------------------------------------

    async def broadcast(self, env_bytes: bytes) -> dict:
        """→ {status} or {status, info/redirect}."""
        reason = self.msgproc.check(env_bytes)
        if reason is not None:
            return {"status": 400, "info": reason}
        if self.raft.state != "leader":
            # BFT: a client knocking on a follower while the leader is
            # dead is the liveness signal for a view change
            if hasattr(self.raft, "note_client_request"):
                self.raft.note_client_request()
            return {"status": 503, "info": "not leader", "leader": self.raft.leader_id}
        if _is_config(env_bytes):
            # config messages cut into their OWN single-envelope block
            # (standardchannel.go): pending normal traffic flushes
            # first, and the apply path only scans 1-envelope batches
            # for consenter changes
            batches = [b for b in (self.cutter.cut(),) if b] + [[env_bytes]]
            pending = False
        else:
            batches, pending = self.cutter.ordered(env_bytes)
        last_index = None
        for batch in batches:
            last_index = self._propose_batch(batch)
        if pending:
            self._arm_timer()
        elif self._timer_task:
            self._timer_task.cancel()
            self._timer_task = None
        if last_index is not None:
            try:
                confirmed = await asyncio.wait_for(
                    self.raft.wait_applied(last_index, digest=self._last_digest),
                    timeout=10.0)
            except asyncio.TimeoutError:
                return {"status": 500, "info": "commit timeout"}
            if confirmed is False:
                # a view change reassigned the sequence: this batch was
                # NOT ordered — the client must resubmit
                return {"status": 503, "info": "reordered during view change"}
        return {"status": 200}

    def _propose_batch(self, batch: list[bytes]) -> int | None:
        # the consensus entry (the reference's :242): the batch's
        # envelopes in hex; its digest lets a BFT waiter confirm that
        # its own payload was what applied
        payload = json.dumps([b.hex() for b in batch]).encode()
        self._last_digest = hashlib.sha256(payload).hexdigest()
        return self.raft.propose(payload)

    def _arm_timer(self):
        if self._timer_task is not None and not self._timer_task.done():
            return

        async def fire():
            await asyncio.sleep(self.config.batch_timeout_s)
            if self.raft.state == "leader":
                batch = self.cutter.cut()
                if batch:
                    self._propose_batch(batch)

        self._timer_task = asyncio.ensure_future(fire())

    # -- raft apply → block assembly -----------------------------------------

    def _apply(self, entry: Entry):
        batch = [bytes.fromhex(h) for h in json.loads(entry.data.decode())]
        if entry.index <= self._materialized:
            return  # already materialized (restart replay / catch-up)
        prev = (protoutil.block_header_hash(self.blocks.get_block(self.blocks.height - 1).header)
                if self.blocks.height else b"\x00" * 32)
        # orderer metadata: consensus term/index and, for BFT, the
        # commit proof; the orderer's signature, which deliver-side
        # verification against the channel's BlockValidation policy
        # depends on
        proof_of = getattr(self.raft, "commit_proof", None)
        blk = assemble_block(self.blocks.height, prev, batch, entry.term, entry.index,
                             self.signer, proof_of(entry.index) if proof_of else None)
        self.blocks.add_block(blk)
        self._height_changed.set()
        self._height_changed = asyncio.Event()
        # consenter-set changes ride committed CONFIG envelopes
        # (etcdraft reconfiguration, chain.go:1115)
        self._maybe_reconfigure(batch)
        # WAL compaction at the retention boundary: everything this far
        # back lives in the block store (etcdraft/storage.go)
        cadence = max(1, min(64, self.wal_retention))
        if entry.index % cadence == 0 and entry.index > self.wal_retention:
            self.raft.wal.compact_to(entry.index - self.wal_retention)

    def _maybe_reconfigure(self, batch: list[bytes]) -> bool:
        """Single-envelope batches only (broadcast isolates CONFIG
        messages into their own batch, the standardchannel.go stance):
        a CONFIG envelope carrying a new ConsensusType consenter set
        applies membership + transport changes (one-server-at-a-time,
        as etcd applies them).  → True iff a consenter set was found."""
        if len(batch) != 1:
            return False
        try:
            env = m.Envelope.parse(batch[0])
            payload = m.Payload.parse(env.payload)
            ch = m.ChannelHeader.parse((payload.header or m.Header()).channel_header)
            if ch.type != m.HEADER_CONFIG:
                return False
            cfg = m.ConfigEnvelope.parse(payload.data).config or m.Config()
            ordg = (cfg.channel_group or m.ConfigGroup()).groups.get("Orderer")
            if ordg is None or "ConsensusType" not in ordg.values:
                return False
            ct = m.ConsensusType.parse(ordg.values["ConsensusType"].value)
            meta = m.RaftConfigMetadata.parse(ct.metadata)
            ids = [c.id for c in meta.consenters if c.id]
            if not ids:
                return False
            addr_map = {c.id: (c.host, c.port) for c in meta.consenters if c.id}
            if sorted(ids) != sorted({self.raft.id, *self.raft.peers}):
                if self.on_consenters is not None:
                    self.on_consenters(addr_map)
                self.raft.update_peers(ids)
                self._rotate_verifiers(meta.consenters, ids)
            return True
        except Exception:
            _log.exception("%s: consenter reconfiguration from config block failed",
                           self.channel)
        return False

    def _rotate_verifiers(self, consenters, ids: list) -> None:
        """Rotate the BFT message-verifier registry with the
        membership: an added consenter authenticates by the identity the
        config block carries; a removed one loses its vote (smartbft
        configverifier.go)."""
        vers = getattr(self.raft, "verifiers", None)
        if not vers:
            return
        for c in consenters:
            if c.id and c.identity and c.id not in vers:
                try:
                    vers[c.id] = _consenter_identity(bytes(c.identity))
                except Exception:
                    _log.warning("%s: bad identity for added consenter %s", self.channel,
                                 c.id)
        for nid in list(vers):
            if nid not in ids:
                vers.pop(nid)

    # -- snapshot catch-up (follower_chain.go) -----------------------------

    def _on_snapshot_hint(self, snap_index: int, snap_term: int) -> None:
        """The leader compacted past us (raft) or the cluster vouched
        for sequences we missed (BFT): pull the missing BLOCKS, then
        fast-forward the consensus log state.  Hints arriving while a
        pull is in flight raise the pending target instead of being
        dropped — install_snapshot itself may re-hint for a residual
        gap, and that must not be swallowed by the running-task
        guard."""
        if self.block_puller is None:
            return
        self._catchup_pending = max(self._catchup_pending, snap_index)
        self._catchup_term = snap_term
        if self._catchup_task is not None and not self._catchup_task.done():
            return

        async def go():
            while True:
                target = self._catchup_pending
                term = self._catchup_term
                target_height = self._offset + target
                h_before = self.blocks.height
                try:
                    async for raw in self.block_puller(self.channel, self.blocks.height,
                                                       target_height - 1):
                        blk = m.Block.parse(raw)
                        if blk.header.number != self.blocks.height:
                            continue
                        if not self._catchup_block_ok(blk):
                            _log.warning("%s: catch-up block %d failed attestation — refusing",
                                         self.channel, blk.header.number)
                            break
                        self.blocks.add_block(blk)
                        self._height_changed.set()
                        self._height_changed = asyncio.Event()
                        # a pulled CONFIG block rotates membership (and
                        # the BFT verifier registry) AT ITS HEIGHT, so
                        # later blocks verify against the consenter set
                        # actually in effect when they were attested
                        self._maybe_reconfigure(list(blk.data.data))
                    # block 0 may have arrived out-of-band: refresh the
                    # entry→block mapping and re-derive membership from
                    # the newest materialized config block
                    self._offset = self._derive_offset()
                    self._reapply_config_membership()
                    if self._materialized >= target:
                        self.raft.install_snapshot(target, term)
                except Exception as e:
                    _log.warning("%s: snapshot catch-up to %d failed: %s",
                                 self.channel, target_height, e)
                if self._catchup_pending <= target or self.blocks.height == h_before:
                    # no higher hint, or no progress (blocks not yet
                    # available anywhere) — stop; the next hint
                    # re-triggers
                    return

        self._catchup_task = asyncio.ensure_future(go())

    def _catchup_block_ok(self, blk) -> bool:
        """Pulled blocks must carry the attestation this round's
        deliver-side verification demands: under BFT (a byzantine
        cluster peer is IN the fault model) the 2f+1 commit proof over
        the batch digest, verified against the consenter identity
        registry; prev-hash chaining is enforced by add_block either
        way.  CFT raft trusts cluster peers for catch-up, as the
        reference's follower chain does."""
        verifiers = getattr(self.raft, "verifiers", None)
        if not verifiers:
            return True  # raft / dev mode
        try:
            meta = json.loads(bytes(blk.metadata.metadata[m.META_ORDERER]))
            proof = meta["bft_proof"]
            want = hashlib.sha256(
                json.dumps([bytes(e).hex() for e in blk.data.data]).encode()).hexdigest()
            quorum = getattr(self.raft, "quorum", 1)
            good = set()
            for msg in proof:
                if not isinstance(msg, dict) or msg.get("type") != COMMIT:
                    continue
                if msg.get("digest") != want:
                    continue
                sender = msg.get("from")
                ver = verifiers.get(sender)
                sig = msg.get("sig")
                if sender in good or ver is None or not sig:
                    continue
                if verify_signature(ver, _signable(msg), bytes.fromhex(sig)):
                    good.add(sender)
            return len(good) >= quorum
        except Exception:
            return False

    # -- deliver --------------------------------------------------------------

    async def deliver(self, start: int, stop: int | None = None):
        """Async iterator of serialized blocks [start, stop]; blocks at
        the tip until new blocks are cut (deliver.go:158 seek
        semantics: stop=None streams forever)."""
        num = start
        while stop is None or num <= stop:
            if num < self.blocks.height:
                yield self.blocks.get_block(num).serialize()
                num += 1
            else:
                # single event loop: no await between the height check
                # and this wait, so no wakeup can be missed (_apply
                # sets the event then replaces it)
                await self._height_changed.wait()

    @property
    def height(self) -> int:
        return self.blocks.height

