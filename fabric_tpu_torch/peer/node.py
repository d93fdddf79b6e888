"""Peer node assembly: ledger + validator + endorser + commit loop
+ client services, as one process (counterpart:
``fabric_tpu/peer/node.py``).

The analog of internal/peer/node/start.go:190-930 `serve()` compressed
to the components this framework has: a KVLedger per channel, the
card's ``BlockValidator`` on the commit path (``p256_verify``,
``stage2_policy``, ``stage2_mvcc``), the endorser service with its ESCC
signature on the card's sign lane (``p256_sign``) under
``sign_device=True``, and a deliver-client loop that pulls blocks from
the ordering service and drives StoreBlock through ``CommitPipeline``.

Services exposed over ``comm/rpc.py`` (the reference's names and
framing):
* ``Endorse``      — SignedProposal → ProposalResponse (unary).
* ``DeliverBlocks``— committed-block stream with TRANSACTIONS_FILTER
                     metadata set (client event stream analog).
* ``Query``        — read-only state access (qscc-style convenience).
* ``Info``, ``Discover``, ``Snapshot`` and the gateway's ``Gw*``
  methods (``peer/gateway.py``).
* ``GossipPing``, ``PvtPush``, ``PvtPull`` — ``gossip.py``: membership,
  endorsement-time private-data push, commit-time pull; anti-entropy
  and the reconciler are started per channel
  (``node.gossip_service.start_anti_entropy`` / ``start_reconciler``).

The node takes ``device="cuda"`` by default (a host without CUDA
raises unless ``device="cpu"`` is asked for) and hands it to every
channel's validator and to the sign lane.  Where the port departs from
the reference: under ``sign_device=True`` a signer without a P-256
scalar makes ``start`` raise (the reference logs and keeps the serial
signer), so no endorsement quietly signs off the card.  ``tls`` (a
``comm/rpc.py::TlsProfile``) puts mutual TLS on the listener and on
every dial (deliver, gateway endorse and submit, gossip, the sidecar
link).  ``InstallChaincode`` / ``QueryInstalled`` keep packages in a
``peer/ccpackage.py::PackageStore`` under the data dir (a size cap, and
with ``install_require_admin`` an admin-signed request of this peer's
org); a chaincode with a committed definition whose package this org
approved and installed resolves to a ``CCaaSProxy`` on first use.
``start(operations_port=)`` serves ``opsserver.py`` with the
``rpc_server``, ``ledgers`` and ``device_verify_lane`` health checks.
``PeerChannel.replay_local`` catches a channel up from a local block
store through ``peer/replay.py``.  ``start()`` arms what the node's
knobs ask for and ``stop()`` takes it down (the reference's
:1551-1810, :1880-1910): ``slos`` the process-global SLO engine
(``observe/slo.py``; with the sign lane the default endorse
objectives, with the tx-flow journal the default commit ones),
``autopilot`` a ``control.Autopilot`` whose ``apply_knob`` reaches every
channel's ``PeerChannel.apply_knob`` and the sign lane (disabled before
it is stopped), ``vitals_interval_s`` the refcounted metrics sampler
and, with it or ``blackbox_dir``, the refcounted black box
(``observe/{timeseries,blackbox}.py``).  Each channel's validator takes
``verify_chunk``.  Knobs whose module is not ported yet raise
``NotImplementedError`` naming ROADMAP Queue 1 item 9 or 10 when set to
anything but their default: ``sidecar_listen``, and the validator's
``mesh_devices``, ``mesh_topology``, ``recode_device``,
``host_stage_mode="process"`` and ``verify_deadline_ms``.  A BFT channel's blocks pass
``_verify_bft_attestation`` (2f+1 consenter COMMIT signatures over the
block's own batch, host ``ec_ref`` checks) before the card's kernels
launch.  A collection this peer's org is no member of is recorded
missing with ``eligible=0`` and never pulled (``peer/coordinator.py``).
"""

from __future__ import annotations

import asyncio
import concurrent.futures as _cf
import contextlib
import hashlib
import json
import logging
import time
from concurrent.futures import ThreadPoolExecutor

from fabric_tpu_torch import faults as _faults
from fabric_tpu_torch import observe, protoutil
from fabric_tpu_torch.channelconfig import Bundle, ConfigTxProcessor, SignedData
from fabric_tpu_torch.comm.rpc import RpcClient, RpcServer
from fabric_tpu_torch.crypto.msp import verify_signature
from fabric_tpu_torch.device import resolve_device
from fabric_tpu_torch.discovery import DiscoveryService, PeerRegistry
from fabric_tpu_torch.ledger.confighistory import ConfigHistoryDB
from fabric_tpu_torch.ledger.kvledger import KVLedger
from fabric_tpu_torch.ledger.pvtdata import encode_kv
from fabric_tpu_torch.ledger.statedb import MemVersionedDB, UpdateBatch
from fabric_tpu_torch.nodeconfig import DEFAULT_MAX_PACKAGE_SIZE
from fabric_tpu_torch.observe import txflow as _txflow
from fabric_tpu_torch.ops_metrics import global_registry
from fabric_tpu_torch.ordering.bft import COMMIT, _signable
from fabric_tpu_torch.ordering.node import DeliverClient
from fabric_tpu_torch.peer import gateway as gw
from fabric_tpu_torch.peer.acl import PROPOSE, ACLProvider
from fabric_tpu_torch.peer.chaincode import ChaincodeRuntime, LayeredRuntime
from fabric_tpu_torch.peer.coordinator import PvtDataCoordinator
from fabric_tpu_torch.peer.endorser import Endorser
from fabric_tpu_torch.peer.lifecycle import LIFECYCLE_NS, LifecycleContract, LifecyclePolicyProvider
from fabric_tpu_torch.peer.pipeline import CommitPipeline
from fabric_tpu_torch.peer.transient import TransientStore
from fabric_tpu_torch.peer.txcodes import TxValidationCode as C
from fabric_tpu_torch.peer.validator import BlockValidator, PolicyProvider
from fabric_tpu_torch.protos import messages as m
from fabric_tpu_torch.protos.wire import DecodeError
from fabric_tpu_torch.utils.backoff import Backoff
from fabric_tpu_torch.utils.locks import AsyncRWLock

_log = logging.getLogger("fabric_tpu_torch.peer")


def _not_ported(what: str, item: int = 10) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 item {item})")


def _refuse_validator_knobs(mesh_devices=0, mesh_topology=None, recode_device=False,
                            host_stage_mode="thread", verify_deadline_ms=0.0) -> None:
    """The reference validator's knobs the port's ``BlockValidator`` does
    not take: each raises when set to anything but its default."""
    if int(mesh_devices) or mesh_topology is not None:
        raise _not_ported("mesh_devices / mesh_topology (parallel/mesh.py)", 9)
    if recode_device:
        raise _not_ported("recode_device")
    if host_stage_mode != "thread":
        raise _not_ported(f"host_stage_mode={host_stage_mode!r} (the process pool)")
    if float(verify_deadline_ms):
        raise _not_ported("verify_deadline_ms (the guard's deadline on the validator)")


class PeerChannel:
    """One channel's ledger + validator + commit loop on this peer.

    With ``genesis_block`` (the production path — the reference
    requires the channel's genesis/config block at join,
    core/peer/peer.go:235), the channel derives its trust anchor from
    it: channelconfig Bundle → MSPs + policy tree, a lifecycle-backed
    policy provider over the channel's OWN state, and a config-tx
    processor.  The genesis block commits locally WITHOUT validation
    (the admin vouches for it out-of-band) and the deliver loop then
    starts at height 1, so a malicious orderer can never substitute a
    different block 0.  Without a genesis block (dev mode) the caller
    wires msp/provider explicitly and the first delivered block is
    trusted — test-network semantics only."""

    # seconds of stream silence before the in-flight tail is flushed:
    # with depth 2 the newest block stays launched-but-uncommitted
    # until the NEXT submit, and a quiet channel must not leave it
    # dangling (clients block on height for their commit ack) —
    # pipelining engages only while blocks arrive back to back
    PIPELINE_IDLE_FLUSH_S = 0.05

    def __init__(self, channel_id: str, data_dir: str, msp_manager=None,
                 policy_provider: PolicyProvider | None = None, state_db=None,
                 config_processor=None, genesis_block=None,
                 snapshot_dir: str | None = None, pipeline_depth: int = 2,
                 verify_chunk: int = 0, mesh_devices: int = 0, mesh_topology=None,
                 coalesce_blocks: int = 0, host_stage_workers: int = 0,
                 recode_device: bool = False, host_stage_mode: str = "thread",
                 trace_ring_blocks: int | None = None,
                 trace_slow_factor: float | None = None,
                 device_fail_threshold: int = 0, device_retries: int = 2,
                 device_recovery_s: float = 30.0, verify_deadline_ms: float = 0.0,
                 state_resident: bool = False, state_resident_mb: int = 64,
                 state_resident_range_bits: int = 12, sidecar_endpoint: str = "",
                 sidecar_weight: float = 1.0, sidecar_recovery_s: float = 5.0,
                 sidecar_ssl=None, async_commit: bool = True, apply_queue_blocks: int = 4,
                 device="cuda"):
        _refuse_validator_knobs(mesh_devices, mesh_topology, recode_device, host_stage_mode,
                                verify_deadline_ms)
        self.id = channel_id
        self.device = resolve_device(device)
        # block-commit span tracer knobs (nodeconfig trace_ring_blocks
        # / trace_slow_factor): configure the process-global tracer the
        # CommitPipeline, validator stage timers and host pool workers
        # share
        observe.configure(ring_blocks=trace_ring_blocks, slow_factor=trace_slow_factor)
        self.tracer = observe.global_tracer()
        # commit-path knobs: depth 2 = CommitPipeline overlap on the
        # deliver loop, N ≥ 3 = deep window, 1 = strict serial
        # commit_block per block; coalesce_blocks ≥ 2 = multi-block
        # verify-dispatch coalescing over the deliver backlog
        # (CommitPipeline.submit_many)
        self.pipeline_depth = int(pipeline_depth)
        self.coalesce_blocks = int(coalesce_blocks)
        snap_meta = None
        if snapshot_dir is not None:
            from fabric_tpu_torch.ledger.snapshot import create_from_snapshot

            self.ledger, snap_meta = create_from_snapshot(
                snapshot_dir, data_dir, state_db=state_db or MemVersionedDB(),
                async_commit=async_commit, apply_queue_blocks=apply_queue_blocks)
        else:
            # async group-commit storage engine (nodeconfig
            # ``async_commit``, default ON): state apply trails the
            # block append on the ledger's applier thread
            self.ledger = KVLedger(data_dir, state_db=state_db or MemVersionedDB(),
                                   async_commit=async_commit,
                                   apply_queue_blocks=apply_queue_blocks)
        config = None
        if genesis_block is not None:
            env = m.Envelope.parse(genesis_block.data.data[0])
            payload = m.Payload.parse(env.payload)
            config = m.ConfigEnvelope.parse(payload.data).config
        elif snap_meta is not None and snap_meta.get("config"):
            config = m.Config.parse(bytes.fromhex(snap_meta["config"]))
        self.syscc = {}
        self.acl = None  # dev mode: no policy source, no ACLs
        if config is not None:
            bundle = Bundle(channel_id, config)
            config_processor = config_processor or ConfigTxProcessor(bundle)
            self.processor = config_processor
            msp_manager = bundle.msp_manager
            if policy_provider is None:
                policy_provider = LifecyclePolicyProvider(
                    self.ledger.state,
                    ref_resolver=lambda name: self.processor.bundle.application_policy_ast(name))
            if genesis_block is not None and self.ledger.blocks.height == 0:
                self.ledger.commit_block(genesis_block.copy(), bytes([0]), UpdateBatch(), [])
            # ACLs over the live bundle (rotates with config updates)
            self.acl = ACLProvider(lambda: getattr(self.processor, "bundle", None))
            # the _lifecycle system contract scoped to THIS channel's
            # org set (system-chaincode deploy, start.go:765)
            self.syscc = {LIFECYCLE_NS: LifecycleContract(
                org_lister=lambda: self.processor.bundle.application_orgs())}
        else:
            self.processor = config_processor
            if config_processor is not None and hasattr(config_processor, "bundle"):
                self.acl = ACLProvider(lambda: getattr(self.processor, "bundle", None))
        if msp_manager is None or policy_provider is None:
            raise ValueError("join without genesis_block/snapshot requires explicit "
                             "msp_manager and policy_provider")
        if sidecar_endpoint:
            # the channel's signature batches ship to a shared
            # validation sidecar (sidecar/); its own latch takes the
            # guard's place, and it stages no pool and no resident table
            if state_resident or host_stage_workers or device_fail_threshold:
                raise ValueError("sidecar_endpoint takes none of state_resident, "
                                 "host_stage_workers, device_fail_threshold")
            from fabric_tpu_torch.sidecar.validator import SidecarValidator

            self.validator = SidecarValidator(
                policy_provider, self.ledger.state, self.ledger.blocks,
                sidecar_endpoint=sidecar_endpoint, tenant=channel_id,
                sidecar_weight=sidecar_weight, sidecar_recovery_s=sidecar_recovery_s,
                sidecar_ssl=sidecar_ssl, device=self.device, msp=msp_manager)
            self.validator.config_processor = config_processor
        else:
            self.validator = BlockValidator(
                policy_provider, self.ledger.state, block_store=self.ledger.blocks,
                device=self.device, state_resident=state_resident,
                state_resident_mb=state_resident_mb,
                state_resident_range_bits=state_resident_range_bits, msp=msp_manager,
                host_stage_workers=host_stage_workers, config_processor=config_processor,
                device_fail_threshold=device_fail_threshold, device_retries=device_retries,
                device_recovery_s=device_recovery_s, verify_chunk=verify_chunk)
        if snapshot_dir is not None and getattr(self.validator, "resident", None) is not None:
            # snapshot join + resident cache: warm the device table
            # straight from the snapshot's key ranges
            from fabric_tpu_torch.ledger.snapshot import warm_resident

            warmed = warm_resident(self.validator.resident, snapshot_dir)
            if warmed:
                _log.info("%s: resident cache warmed with %d keys from snapshot",
                          channel_id, warmed)
        self._bft_seqs: dict = {}  # block number → its verified BFT proof's seq
        self.transient = TransientStore(f"{data_dir}/transient.db")
        self.pvt_puller = None  # async callable injected by the gossip layer
        # this peer's org (set by PeerNode.join_channel): collections it
        # is no member of are recorded ineligible, never pulled
        self.member_org = None

        async def _pull(*a):
            if self.pvt_puller is None:
                return None
            return await self.pvt_puller(*a)

        self.coordinator = PvtDataCoordinator(self.transient, puller=_pull,
                                              eligible=self.eligible)
        self.confighistory = ConfigHistoryDB(f"{data_dir}/confighistory.db")
        self.transient_retention = 50  # blocks (core.yaml transientstore)
        # endorsement vs commit: simulations take the SHARED side, the
        # committer the exclusive one (lockbased_txmgr RW semantics,
        # endorser.go:379-401) — endorsements run in parallel with each
        # other and only serialize against block commits
        self.commit_lock = AsyncRWLock()
        self._height_changed = asyncio.Event()
        self._deliver_task: asyncio.Task | None = None
        self._deliver_progress = 0
        self.orderer_addrs: list = []
        self.client_ssl = None
        self.runtime = None
        # the live CommitPipeline while the deliver loop (or a local
        # replay) runs: the autopilot's apply_knob reaches it
        self.pipe = None

    # -- run-time knobs (the traffic autopilot's actuator) --------------------

    def apply_knob(self, knob: str, value) -> None:
        """One autopilot step on this channel's live commit path (the
        reference's :268-305).  Every setter latches and applies at a
        block boundary; a channel with no live pipe keeps the value the
        next deliver session starts from."""
        if knob == "verify_chunk":
            fn = getattr(self.validator, "set_verify_chunk", None)
            if fn is not None:
                fn(int(value))
        elif knob == "host_stage_workers":
            fn = getattr(self.validator, "set_host_stage_workers", None)
            if fn is not None:
                fn(int(value))
        elif knob == "coalesce_blocks":
            # the deliver loop reads this per group
            self.coalesce_blocks = int(value)
            if self.pipe is not None:
                self.pipe.set_coalesce_blocks(int(value))
        elif knob == "pipeline_depth":
            # a channel configured serial (1) never becomes pipelined
            if self.pipeline_depth > 1 and int(value) >= 2:
                self.pipeline_depth = int(value)
            if self.pipe is not None:
                self.pipe.set_depth(int(value))

    @property
    def height(self) -> int:
        return self.ledger.blocks.height

    def collection_config(self, ns: str, coll: str) -> dict | None:
        """Collection config (member orgs, peer counts, BTL) from the
        channel's policy provider — lifecycle-backed when a definition
        is committed, static otherwise; None = undefined."""
        fn = getattr(self.validator.policies, "collection", None)
        return fn(ns, coll) if fn else None

    def eligible(self, ns: str, coll: str) -> bool:
        """Whether this peer's org may hold a collection's cleartext:
        a member org of a defined collection (an undefined one is the
        endorsing org's alone, ``gossip.GossipService._members``)."""
        if self.member_org is None:
            return True
        cfg = self.collection_config(ns, coll)
        return cfg is None or self.member_org in cfg.get("member_orgs", [])

    def make_endorser(self, msp, signer, runtime):
        """Endorser over THIS channel's state, system chaincodes and
        ACLs — the single construction point shared by the Endorse RPC
        and the gateway (endorser.go:304 wiring)."""
        acl = self.acl
        return Endorser(
            msp, signer, self.ledger.state, LayeredRuntime(runtime, self.syscc),
            acl_check=((lambda _ch, creator, msg, sig: acl.check(PROPOSE, creator, msg, sig))
                       if acl is not None else None))

    async def commit_block(self, block) -> bytes:
        """Validate + commit one block, strictly serially (the
        StoreBlock path).  Direct callers and the ``pipeline_depth=1``
        deliver loop use this; depth-2 streams go through
        ``_run_deliver_pipelined``/CommitPipeline instead.  The validate
        call launches the card's kernels and syncs on them — it runs in
        a worker thread, never on the event loop's."""
        loop = asyncio.get_event_loop()

        def _verify_and_validate(b):
            self.verify_block_signature(b)
            pend = self.validator.validate_launch(b)
            return pend, self.validator.validate_finish(pend)

        async with self.commit_lock.writer():
            t0 = time.perf_counter()
            pend, (flt, batch, history) = await loop.run_in_executor(
                None, _verify_and_validate, block)
            t1 = time.perf_counter()
            await self._commit_inner(block, pend.txs, flt, batch, history, pend.hd_bytes)
            # the serial path commits outside the CommitPipeline, so its
            # write set must reach the resident table here (a card
            # scatter: off the event loop)
            await loop.run_in_executor(None, self.validator.resident_commit, batch)
            t2 = time.perf_counter()
        self._commit_metrics(flt, t1 - t0, t2 - t1, t2 - t0)
        self._signal_height()
        return flt

    async def _commit_inner(self, block, txs, flt, batch, history, hd_bytes, root=None,
                            sync=True) -> None:
        """Validated triple → committed ledger state: pvt-data phase,
        ledger commit + fsync, post-commit bookkeeping.  The caller
        holds the commit writer lock; ``root``: the block's tracer root
        span, passed explicitly (this coroutine runs on the event-loop
        thread)."""
        # pvt phase (StoreBlock, coordinator.go:190-220): cleartext
        # from transient/pull, hash-verified, into pvt namespaces
        pvt = await self.coordinator.gather(block.header.number, txs, flt)
        for hns, key, value, ver in pvt.updates:
            if value is None:
                batch.delete(hns, key, ver)
            else:
                batch.put(hns, key, value, ver)

        def _expiry(ns, coll):
            # BTL from the collection config: expiringBlk =
            # committingBlk + btl + 1 (pvtdatapolicy.BTLPolicy)
            btl = int((self.collection_config(ns, coll) or {}).get("btl", 0) or 0)
            return block.header.number + btl + 1 if btl > 0 else 0

        pvt_store = {(txnum, ns, coll): (encode_kv(kv), _expiry(ns, coll))
                     for txnum, colls in pvt.store_data.items()
                     for (ns, coll), kv in colls.items()}
        # the storage commit runs ON the event-loop thread, as the
        # reference's does: the transient/pvtdata sqlite stores share
        # single connections with loop-thread handlers
        _faults.fire("peer.ledger_commit", block=block.header.number)
        tracer = observe.global_tracer()
        with tracer.span("ledger_commit", parent=root):
            self.ledger.commit_block(block, flt, batch, history, pvt_data=pvt_store,
                                     txids=[(p.txid, p.idx) for p in txs if p.txid],
                                     hd_bytes=hd_bytes)
        if pvt.missing or pvt.ineligible:
            self.ledger.pvtdata.commit_block(
                block.header.number, {},
                [(txnum, ns, coll, True) for (txnum, _txid, ns, coll) in pvt.missing]
                + [(txnum, ns, coll, False) for (txnum, _txid, ns, coll) in pvt.ineligible])
        self.transient.purge_below(max(0, block.header.number - self.transient_retention))
        # clients key retries off commit acknowledgment: force any open
        # group-commit fsync window closed BEFORE signalling height /
        # commit status
        if sync:
            with tracer.span("fsync", parent=root):
                self.ledger.blocks.sync()
            # tx-flow durable fence (idempotent, first fence wins)
            _txflow.block_durable(block.header.number)
        self._post_commit(block, flt, batch, txs)

    def _commit_metrics(self, flt: bytes, validate_s: float, commit_s: float,
                        total_s: float) -> None:
        # the reference's commit-path breakdown (kv_ledger.go:712-727)
        reg = global_registry()
        reg.histogram("ledger_block_processing_time",
                      "full StoreBlock wall clock per block (s)").observe(total_s,
                                                                           channel=self.id)
        reg.histogram("validation_duration", "validate phase per block (s)").observe(
            validate_s, channel=self.id)
        reg.histogram("ledger_statedb_commit_time", "storage commit per block (s)").observe(
            commit_s, channel=self.id)
        reg.gauge("ledger_blockchain_height", "committed block height").set(self.height,
                                                                           channel=self.id)
        n_valid = sum(1 for c in flt if c == 0)
        tx_count = reg.counter("ledger_transaction_count", "committed txs by validity")
        tx_count.add(n_valid, channel=self.id, status="valid")
        tx_count.add(len(flt) - n_valid, channel=self.id, status="invalid")

    def _signal_height(self) -> None:
        self._height_changed.set()
        self._height_changed = asyncio.Event()

    async def _commit_from_pipeline(self, res) -> None:
        """Commit one CommittedBlock on behalf of the pipeline's
        committer thread (the pvt coordinator and the commit lock are
        loop-affine, so the thread bridges here via
        run_coroutine_threadsafe)."""
        t0 = time.perf_counter()
        # the pipe's block is the validator's parse (a ``WireBlock``);
        # the ledger commits the wire ``Block`` it came from
        block = res.pend.wire if res.pend.wire is not None else res.block
        async with self.commit_lock.writer():
            await self._commit_inner(block, res.pend.txs, res.tx_filter, res.batch,
                                     res.history, res.pend.hd_bytes, root=res.root_span)
        commit_s = time.perf_counter() - t0
        # launch + finish ≈ the serial path's validate span
        validate_s = res.stage_s.get("launch", 0.0) + res.stage_s.get("finish", 0.0)
        self._commit_metrics(res.tx_filter, validate_s, commit_s, validate_s + commit_s)
        self._signal_height()

    def _post_commit(self, block, flt: bytes, batch, txs) -> None:
        """Post-commit bookkeeping: lifecycle-cache invalidation when
        the block wrote ``_lifecycle`` (lifecycle.Cache StateListener
        analog) and channel-config bundle rotation for committed CONFIG
        txs (BundleSource update, core/peer/peer.go).  A failure to
        APPLY a committed config is a serious divergence and must be
        loud, not swallowed."""
        pol_provider = self.validator.policies
        if hasattr(pol_provider, "on_block_committed"):
            pol_provider.on_block_committed(batch)
        wrote_lifecycle = batch.touches_namespace(LIFECYCLE_NS)
        if self.runtime is not None and wrote_lifecycle:
            self.runtime.invalidate_resolved()
        if wrote_lifecycle:
            # record definition changes for point-in-time config queries
            prefix = "namespaces/fields/"
            for (ns, key), vv in batch.items():
                if (ns == LIFECYCLE_NS and key.startswith(prefix)
                        and key.endswith("/Definition") and vv.value):
                    self.confighistory.record(block.header.number,
                                              key[len(prefix):-len("/Definition")], vv.value)
        proc = self.validator.config_processor
        if proc is None or not hasattr(proc, "apply"):
            return
        for ptx in txs:
            if not ptx.is_config or flt[ptx.idx] != C.VALID:
                continue
            try:
                cfg_env = m.ConfigEnvelope.parse(ptx.config_data)
            except DecodeError:
                continue  # malformed yet VALID can only be genesis noise
            try:
                # rotate the validator onto the new membership: stale
                # cached identities must not keep validating
                self.validator.msp = proc.apply(cfg_env).msp_manager
            except Exception:
                _log.exception("%s: committed CONFIG tx %d of block %d failed to apply — "
                               "bundle is now STALE relative to the ledger", self.id,
                               ptx.idx, block.header.number)

    def verify_block_signature(self, block) -> None:
        """VerifyBlock at deliver (block_verification.go:243): a block
        arriving from ANY source must carry orderer signatures
        satisfying the channel's /Channel/Orderer/BlockValidation policy
        before it may commit.  The genesis block is the trust anchor,
        and channels whose config carries no orderer orgs (dev/test
        assemblies) have no identity set to verify against — both skip.
        A BFT channel's block also needs its quorum attestation."""
        if block.header.number == 0:
            return
        bundle = getattr(self.processor, "bundle", None)
        if bundle is None:
            return
        ordg = bundle.config.channel_group.groups.get("Orderer")
        if ordg is None or not ordg.groups:
            return  # no orderer identity set configured
        signed = [SignedData(identity=c, data=d, signature=s)
                  for c, d, s in protoutil.block_signed_data(block)]
        if not signed or not bundle.policy_manager.evaluate(
                "/Channel/Orderer/BlockValidation", signed):
            raise ValueError(f"block {block.header.number}: orderer block-signature "
                             "verification failed (BlockValidation policy not met)")
        self._verify_bft_attestation(block, bundle)

    def _verify_bft_attestation(self, block, bundle) -> None:
        """For BFT channels a single orderer signature is NOT enough —
        one byzantine orderer could sign a forged block.  The block's
        consensus metadata must carry the 2f+1 signed COMMIT messages
        for (view, seq, digest-of-batch), each by a distinct, valid
        orderer-org identity, with the digest recomputed from the
        block's own envelopes and seq strictly increasing along the
        chain (reference: BFT quorum attestations,
        common/deliverclient/block_verification.go:278).  Each
        signature is a host ``ec_ref`` check."""
        ct = bundle.orderer_value("ConsensusType", m.ConsensusType)
        if ct is None or ct.type != "bft":
            return
        meta = m.RaftConfigMetadata.parse(ct.metadata)
        n = len(meta.consenters)
        quorum = 2 * ((n - 1) // 3) + 1 if n else 1
        try:
            omd = json.loads(bytes(block.metadata.metadata[m.META_ORDERER]))
            proof = omd["bft_proof"]
            seq = int(omd["index"])
        except Exception:
            raise ValueError(f"block {block.header.number}: missing BFT commit proof")
        want_digest = hashlib.sha256(
            json.dumps([bytes(e).hex() for e in block.data.data]).encode()).hexdigest()
        # votes count only from the CONSENTER SET (identities pinned in
        # the channel config), deduped by identity — not by the
        # unauthenticated "from" label: a single compromised identity
        # cannot fabricate 2f+1 votes by inventing sender names, and no
        # non-consenter identity (app orgs, orderer-org admins/users)
        # can vote at all.  Channels whose config predates consenter
        # identities fall back to orderer-ORG membership.
        consenter_ids = {bytes(c.identity) for c in meta.consenters if c.identity}
        ordg = bundle.config.channel_group.groups.get("Orderer")
        orderer_orgs = set(ordg.groups) if ordg is not None else set()
        voters = set()  # distinct identity bytes
        for msg in proof:
            if not isinstance(msg, dict) or msg.get("type") != COMMIT:
                continue
            if msg.get("digest") != want_digest or int(msg.get("seq", -1)) != seq:
                continue
            cert = msg.get("from_cert")
            sig = msg.get("sig")
            if not cert or not sig:
                continue
            try:
                raw_cert = bytes.fromhex(cert)
                if raw_cert in voters:
                    continue
                if consenter_ids and raw_cert not in consenter_ids:
                    continue
                ident = bundle.msp_manager.deserialize_identity(raw_cert)
                if not ident.is_valid or ident.msp_id not in orderer_orgs:
                    continue
                if not verify_signature(ident, _signable(msg), bytes.fromhex(sig)):
                    continue
            except Exception as e:
                _log.debug("attestation vote rejected: %s", e)
                continue
            voters.add(raw_cert)
        if len(voters) < quorum:
            raise ValueError(f"block {block.header.number}: BFT attestation has "
                             f"{len(voters)} valid commits, quorum is {quorum}")
        # seq monotonicity along the chain: a replayed proof from an
        # older batch cannot attest a later block.  The predecessor's
        # seq is the one this channel verified for block n-1, else the
        # ledger's; a block delivered again after a pipe restart is held
        # against its predecessor, where the reference holds it against
        # the last seq it verified (itself) and refuses it for ever
        num = block.header.number
        prev_seq = self._bft_seqs.get(num - 1)
        if prev_seq is None and num >= 2:
            try:
                prev = self.ledger.blocks.get_block(num - 1)
                prev_seq = int(json.loads(bytes(prev.metadata.metadata[m.META_ORDERER]))["index"])
            except Exception:
                prev_seq = None
        if prev_seq is not None and seq <= prev_seq:
            raise ValueError(f"block {num}: BFT proof seq {seq} does "
                             f"not advance past predecessor's {prev_seq}")
        self._bft_seqs[num] = seq
        for old in [n for n in self._bft_seqs if n < num - 64]:
            del self._bft_seqs[old]

    async def run_deliver(self, orderer_addr: tuple[str, int]):
        """Pull blocks from the orderer starting at our height and
        commit them in order (deliver client failover is caller-side:
        ``start_deliver``).  With ``pipeline_depth`` ≥ 2 (the default)
        blocks stream through the CommitPipeline; depth 1 commits
        strictly serially through ``commit_block``."""
        dc = DeliverClient(*orderer_addr, ssl_ctx=self.client_ssl)
        async with contextlib.aclosing(dc.blocks(self.id, start=self.height)) as gen:
            if self.pipeline_depth > 1:
                await self._run_deliver_pipelined(gen)
                return
            async for blk in gen:
                self._deliver_progress += 1
                if blk.header.number < self.height:
                    continue  # replayed
                await self.commit_block(blk)

    def _commit_fn(self, loop):
        """The pipeline's commit_fn: committer thread → event loop (the
        pvt coordinator and the commit lock are loop-affine), polled
        with a bounded wait so a torn-down loop cannot wedge the
        committer thread."""

        def commit_fn(res):
            fut = asyncio.run_coroutine_threadsafe(self._commit_from_pipeline(res), loop)
            while True:
                try:
                    return fut.result(timeout=5.0)
                except _cf.TimeoutError:
                    if fut.done():
                        return fut.result(timeout=0)
                    if loop.is_closed():
                        fut.cancel()
                        raise RuntimeError(
                            f"{self.id}: event loop closed while committing block "
                            f"{res.block.header.number}") from None

        return commit_fn

    async def _run_deliver_pipelined(self, gen):
        """Depth-N deliver commit loop over ``peer/pipeline.py``: block
        n's validation, block n-1's ledger commit, and block n+1's parse
        + card launch overlap.  A stage failure fails the pipe closed
        (the pipe's containment): it propagates out of here, the in-flight
        tail is dropped, and ``start_deliver`` reconnects from the
        committed height."""
        loop = asyncio.get_event_loop()
        # orderer block signatures verify at LAUNCH (caller thread),
        # not at prefetch: a predecessor CONFIG block rotates the
        # orderer set at commit, and the barrier only guarantees that
        # rotation has landed by launch time
        pipe = CommitPipeline(self.validator, self._commit_fn(loop), depth=self.pipeline_depth,
                              coalesce_blocks=self.coalesce_blocks, channel=self.id,
                              tracer=self.tracer, pre_launch_fn=self.verify_block_signature)
        self.pipe = pipe
        # submit() blocks on card syncs and on the committer thread: a
        # dedicated feeder thread per channel keeps it off the event
        # loop and off the shared executor
        feeder = ThreadPoolExecutor(1, thread_name_prefix="fabtpu-feed")
        # blocks arrive through a reader task + queue so this loop
        # can flush the pipeline's in-flight tail when the stream goes
        # idle (see PIPELINE_IDLE_FLUSH_S)
        reader_exc: list = []
        q: asyncio.Queue = asyncio.Queue(maxsize=4)

        async def reader():
            try:
                async for blk in gen:
                    # chaos hook: a FaultPlan can cut the stream here
                    if _faults.plan() is not None:
                        await _faults.afire("deliver.read", block=blk.header.number)
                    await q.put(blk)
            except BaseException as e:
                reader_exc.append(e)
            finally:
                await q.put(None)

        rtask = asyncio.ensure_future(reader())
        # height lags the in-flight window, so replay detection tracks
        # the next EXPECTED number, not the committed height
        expect = self.height
        try:
            while True:
                try:
                    if pipe.inflight:
                        blk = await asyncio.wait_for(q.get(), timeout=self.PIPELINE_IDLE_FLUSH_S)
                    else:
                        blk = await q.get()
                except asyncio.TimeoutError:
                    # stream went quiet with a block in flight: commit
                    # the tail now — its clients are waiting
                    await loop.run_in_executor(feeder, pipe.flush)
                    continue
                if blk is None:
                    break  # stream ended (reader_exc carries errors)
                self._deliver_progress += 1
                expect = max(expect, self.height)
                if blk.header.number < expect:
                    continue  # replayed
                expect = blk.header.number + 1
                # launch coalescing: drain the backlog already queued so
                # their signature batches ride one card launch
                group, stream_end = [blk], False
                while self.coalesce_blocks >= 2 and len(group) < self.coalesce_blocks:
                    try:
                        nxt = q.get_nowait()
                    except asyncio.QueueEmpty:
                        break
                    if nxt is None:
                        stream_end = True
                        break
                    self._deliver_progress += 1
                    if nxt.header.number < max(expect, self.height):
                        continue  # replayed
                    expect = nxt.header.number + 1
                    group.append(nxt)
                if len(group) == 1:
                    await loop.run_in_executor(feeder, pipe.submit, blk)
                else:
                    await loop.run_in_executor(feeder, pipe.submit_many, group)
                if stream_end:
                    break
            if reader_exc:
                raise reader_exc[0]
        except BaseException:
            # drop the in-flight tail: height never advanced for it, so
            # the reconnect re-delivers from the right place
            if pipe.last_failure is not None:
                num, stage = pipe.last_failure
                _log.warning("%s: quarantining block %s after a %s-stage failure; pipe "
                             "drained, resuming deliver from committed height %d", self.id,
                             num, stage, self.height)
            await loop.run_in_executor(feeder, lambda: pipe.close(flush=False))
            raise
        else:
            # stream closed cleanly: flush the verified tail
            await loop.run_in_executor(feeder, pipe.close)
        finally:
            self.pipe = None
            rtask.cancel()
            await asyncio.gather(rtask, return_exceptions=True)
            feeder.shutdown(wait=False)

    def start_deliver(self, orderer_addrs: list[tuple[str, int]],
                      censorship_check_s: float = 2.0):
        """Background commit loop with orderer failover AND
        censorship monitoring: an orderer that keeps the Deliver
        stream open while withholding blocks is detected by
        cross-checking the OTHER orderers' reported heights
        (blocksprovider/bft_censorship_monitor.go)."""
        self.orderer_addrs = list(orderer_addrs)  # gateway Submit uses these
        log = logging.getLogger("fabric_tpu_torch.peer.deliver")

        async def probe_height(addr) -> int:
            cli = RpcClient(*addr, ssl_ctx=self.client_ssl)
            try:
                await cli.connect()
                res = json.loads(await asyncio.wait_for(
                    cli.unary("Info", json.dumps({"channel": self.id}).encode()),
                    censorship_check_s))
                return int(res.get("height", -1)) if res.get("status") == 200 else -1
            except Exception:
                return -1
            finally:
                try:
                    await cli.close()
                except (OSError, RuntimeError):
                    pass  # orderer already gone

        async def censored(current) -> bool:
            # f+1 corroboration: ONE lying orderer must not be able to
            # tear down a healthy stream
            others = [a for a in orderer_addrs if a != current]
            needed = (len(orderer_addrs) - 1) // 3 + 1
            ahead = 0
            for a in others:
                if await probe_height(a) > self.height:
                    ahead += 1
                    if ahead >= needed:
                        return True
            return False

        async def deliver_monitored(addr):
            t = asyncio.ensure_future(self.run_deliver(addr))
            idle_probes = 0
            try:
                while True:
                    p0 = self._deliver_progress
                    # quiet channels back the probing off (up to 8x)
                    await asyncio.wait({t}, timeout=censorship_check_s * min(8, 1 + idle_probes))
                    if t.done():
                        return await t  # propagate stream errors
                    if self._deliver_progress != p0:
                        idle_probes = 0  # blocks are flowing
                        continue
                    if len(orderer_addrs) > 1 and await censored(addr):
                        log.warning("%s: orderer %s serves a silent stream while the cluster "
                                    "is ahead of height %d — suspecting censorship, rotating",
                                    self.id, addr, self.height)
                        raise RuntimeError("deliver censorship suspected")
                    idle_probes += 1
            finally:
                if not t.done():
                    t.cancel()

        reconnects = global_registry().counter("deliver_reconnects_total",
                                               "deliver stream reconnect attempts by channel")

        async def loop():
            # capped exponential backoff + full jitter; progress resets
            # the cadence so a healthy stream that drops reconnects
            # promptly
            bo = Backoff(base=0.2, cap=15.0, jitter=0.5)
            i = 0
            while True:
                addr = orderer_addrs[i % len(orderer_addrs)]
                i += 1
                h0 = self.height
                try:
                    await deliver_monitored(addr)
                except Exception as e:
                    # a deterministic commit failure re-fails forever;
                    # it must at least be VISIBLE
                    if self.height > h0:
                        bo.reset()
                    reconnects.add(1, channel=self.id)
                    delay = bo.next()
                    log.warning("%s deliver from %s: %s: %s — reconnecting from height %d "
                                "in %.2fs (attempt %d)", self.id, addr, type(e).__name__, e,
                                self.height, delay, bo.attempt)
                    await asyncio.sleep(delay)

        self._deliver_task = asyncio.ensure_future(loop())

    async def snapshot(self, out_dir: str) -> dict:
        """Export a ledger snapshot at the current height, serialized
        against commits (snapshot_mgmt.go commitStart/commitDone)."""
        from fabric_tpu_torch.ledger.snapshot import generate_snapshot

        proc = self.processor
        cfg = proc.bundle.config.serialize() if hasattr(proc, "bundle") else b""
        loop = asyncio.get_event_loop()
        async with self.commit_lock.writer():
            # worker thread: a large state export must not freeze the
            # node's RPC services for its duration
            return await loop.run_in_executor(None, lambda: generate_snapshot(
                self.ledger, out_dir, channel_id=self.id, config_bytes=cfg))

    async def replay_local(self, src_dir: str, depth: int | None = None) -> dict:
        """Catch this channel up from a local block store directory (a
        serving peer's copied chain, a mirror, this peer's own pre-wipe
        store) at full pipeline depth with no time between blocks
        (``peer/replay.py``): every block's orderer signature is checked
        before its kernels launch, as on the deliver path.  Resumes from
        the committed height; returns the replay's stats."""
        from fabric_tpu_torch.ledger.blockstore import BlockStore
        from fabric_tpu_torch.peer.replay import ReplayCheckpoint, ReplayDriver

        loop = asyncio.get_event_loop()

        def hook(pipe):
            self.pipe = pipe

        src = BlockStore(src_dir)
        drv = ReplayDriver(
            self.validator, self._commit_fn(loop),
            depth=self.pipeline_depth if depth is None else depth,
            checkpoint=ReplayCheckpoint(f"{self.ledger.blocks.dir}/replay_checkpoint.json"),
            pre_launch_fn=self.verify_block_signature, channel=self.id,
            coalesce_blocks=self.coalesce_blocks, tracer=self.tracer, pipe_hook=hook)
        start = self.height
        # a dedicated feeder thread, as the deliver driver's: submit()
        # waits on card syncs and must not starve the shared pool
        feeder = ThreadPoolExecutor(1, thread_name_prefix="fabtpu-replay")
        try:
            stats = await loop.run_in_executor(
                feeder, lambda: drv.run(src.iter_blocks(start), start=start))
        finally:
            feeder.shutdown(wait=False)
            src.close()
        stats["resumed_from"] = start
        return stats

    async def wait_height(self, h: int, timeout: float = 30.0):
        loop = asyncio.get_event_loop()
        deadline = loop.time() + timeout
        while self.height < h:
            ev = self._height_changed
            remaining = deadline - loop.time()
            if remaining <= 0:
                raise asyncio.TimeoutError(f"height {self.height} < {h}")
            await asyncio.wait_for(ev.wait(), remaining)

    def stop(self):
        if self._deliver_task:
            self._deliver_task.cancel()
        self.validator.close()  # host staging pool worker threads
        self.transient.close()
        self.confighistory.close()
        self.ledger.close()


class PeerNode:
    def __init__(self, node_id: str, data_dir: str, msp_manager, signer,
                 runtime: ChaincodeRuntime | None = None,
                 host: str = "127.0.0.1", port: int = 0, tls=None,
                 max_package_size: int = DEFAULT_MAX_PACKAGE_SIZE,
                 install_require_admin: bool = False,
                 pipeline_depth: int = 2, verify_chunk: int = 0,
                 mesh_devices: int = 0, mesh_topology=None,
                 coalesce_blocks: int = 0,
                 host_stage_workers: int = 0, recode_device: bool = False,
                 host_stage_mode: str = "thread",
                 trace_ring_blocks: int | None = None,
                 trace_slow_factor: float | None = None,
                 slos: str = "",
                 vitals_interval_s: float = 0.0,
                 vitals_retention: int = 240,
                 blackbox_dir: str = "",
                 device_ledger: bool = True,
                 autopilot: bool = False,
                 autopilot_tick_s: float = 1.0,
                 autopilot_knobs: str = "",
                 sign_device: bool = False,
                 sign_batch_max: int = 256,
                 sign_batch_wait_ms: float = 2.0,
                 sign_self_check: bool = False,
                 device_fail_threshold: int = 0,
                 device_retries: int = 2,
                 device_recovery_s: float = 30.0,
                 verify_deadline_ms: float = 0.0,
                 state_resident: bool = False,
                 state_resident_mb: int = 64,
                 state_resident_range_bits: int = 12,
                 faults: str = "",
                 sidecar_endpoint: str = "",
                 sidecar_weight: float = 1.0,
                 sidecar_recovery_s: float = 5.0,
                 sidecar_listen: str = "",
                 sidecar_queue_blocks: int = 8,
                 sidecar_coalesce: int = 4,
                 async_commit: bool = True,
                 apply_queue_blocks: int = 4,
                 tx_flow: bool = True,
                 device="cuda"):
        if sidecar_listen or sidecar_queue_blocks != 8 or sidecar_coalesce != 4:
            raise _not_ported("sidecar_listen (a sidecar server hosted by the peer)")
        _refuse_validator_knobs(mesh_devices, mesh_topology, recode_device, host_stage_mode,
                                verify_deadline_ms)
        self.id = node_id
        self.dir = data_dir
        self.msp = msp_manager
        self.signer = signer
        self.runtime = runtime or ChaincodeRuntime()
        self.device = resolve_device(device)
        # commit-path knobs every joined channel inherits
        self.pipeline_depth = int(pipeline_depth)
        self.async_commit = bool(async_commit)
        self.apply_queue_blocks = int(apply_queue_blocks)
        self.coalesce_blocks = int(coalesce_blocks)
        self.host_stage_workers = int(host_stage_workers)
        self.verify_chunk = int(verify_chunk)
        # the SLO engine, the traffic autopilot and the flight recorder
        # (armed at start(), taken down at stop())
        self.slos = slos
        self.vitals_interval_s = float(vitals_interval_s)
        self.vitals_retention = int(vitals_retention)
        self.blackbox_dir = blackbox_dir
        self.autopilot = bool(autopilot)
        self.autopilot_tick_s = float(autopilot_tick_s)
        self.autopilot_knobs = autopilot_knobs
        self.autopilot_ctl = None
        self.vitals = None
        self.blackbox = None
        self.trace_ring_blocks = trace_ring_blocks
        self.trace_slow_factor = trace_slow_factor
        # device-time launch ledger and per-tx flow journal (default
        # ON): armed refcounted at start(), colocated nodes share one
        self.device_ledger = bool(device_ledger)
        self.launch_ledger = None
        self.tx_flow = bool(tx_flow)
        self.txflow_journal = None
        # the card's ESCC sign lane (peer/signlane.py): built at
        # start() so a never-started node owns no thread
        self.sign_device = bool(sign_device)
        self.sign_batch_max = int(sign_batch_max)
        self.sign_batch_wait_ms = float(sign_batch_wait_ms)
        self.sign_self_check = bool(sign_self_check)
        self.sign_batcher = None
        self.sign_signer = None
        # device-lane degradation knobs (peer/degrade.py): threshold 0
        # keeps the guard off
        self.device_fail_threshold = int(device_fail_threshold)
        self.device_retries = int(device_retries)
        self.device_recovery_s = float(device_recovery_s)
        self.state_resident = bool(state_resident)
        self.state_resident_mb = int(state_resident_mb)
        self.state_resident_range_bits = int(state_resident_range_bits)
        self.sidecar_endpoint = sidecar_endpoint
        self.sidecar_weight = float(sidecar_weight)
        self.sidecar_recovery_s = float(sidecar_recovery_s)
        if faults:
            # chaos spec: arm the process-global fault plan
            _faults.configure(faults)
        # chaincode install surface: the store always, a size cap
        # always, and optionally an admin-signed request envelope
        self.max_package_size = int(max_package_size)
        self.install_require_admin = bool(install_require_admin)
        from fabric_tpu_torch.peer.ccpackage import PackageStore

        self.packages = PackageStore(data_dir)
        if self.runtime.resolver is None:
            self.runtime.resolver = self._resolve_chaincode
        self.tls = tls  # comm.rpc.TlsProfile: mTLS on every surface
        self.channels: dict[str, PeerChannel] = {}
        self.server = RpcServer(host, port, ssl_ctx=tls.server_ctx() if tls else None)
        self.registry = PeerRegistry()  # org → endorsing peers (gateway/discovery)
        self.gateway = None
        self.gossip_service = None
        self.operations = None
        self._bg: set = set()  # strong refs: GC destroys weakly-held tasks

    def join_channel(self, channel_id: str, policy_provider: PolicyProvider | None = None,
                     state_db=None, config_processor=None, genesis_block=None,
                     snapshot_dir=None) -> PeerChannel:
        anchored = genesis_block is not None or snapshot_dir is not None
        ch = PeerChannel(
            channel_id, f"{self.dir}/{channel_id}", None if anchored else self.msp,
            policy_provider, state_db, config_processor, genesis_block=genesis_block,
            snapshot_dir=snapshot_dir, pipeline_depth=self.pipeline_depth,
            coalesce_blocks=self.coalesce_blocks, host_stage_workers=self.host_stage_workers,
            verify_chunk=self.verify_chunk, trace_ring_blocks=self.trace_ring_blocks, trace_slow_factor=self.trace_slow_factor,
            device_fail_threshold=self.device_fail_threshold,
            device_retries=self.device_retries, device_recovery_s=self.device_recovery_s,
            state_resident=self.state_resident, state_resident_mb=self.state_resident_mb,
            state_resident_range_bits=self.state_resident_range_bits,
            sidecar_endpoint=self.sidecar_endpoint, sidecar_weight=self.sidecar_weight,
            sidecar_recovery_s=self.sidecar_recovery_s,
            sidecar_ssl=self.tls.client_ctx() if self.tls else None,
            async_commit=self.async_commit, apply_queue_blocks=self.apply_queue_blocks,
            device=self.device)
        ch.client_ssl = self.tls.client_ctx() if self.tls else None
        ch.runtime = self.runtime  # resolved-binding invalidation hook
        ch.member_org = getattr(self.signer, "msp_id", None)
        self.channels[channel_id] = ch
        if self.gossip_service is not None:
            ch.pvt_puller = self.gossip_service.pull_pvt_for(channel_id)
        return ch

    # -- services ------------------------------------------------------------

    async def start(self, operations_port: int | None = None):
        if self.slos:
            # the process-global burn-rate engine on the global tracer's
            # finished roots (/slo); the spec was checked at config load
            from fabric_tpu_torch.observe import slo as _slo

            _slo.configure(self.slos)
        if self.sign_device:
            # the card's ESCC sign lane: concurrent Endorse/gateway
            # sign requests coalesce into one p256_sign launch, RFC 6979
            # nonces — bit-equal to the serial signer.  A signer with no
            # P-256 scalar raises here (the reference logs and keeps the
            # serial signer): nothing quietly signs off the card.
            from fabric_tpu_torch.peer import signlane

            try:
                d = signlane.private_scalar(self.signer)
            except ValueError as e:
                raise ValueError(f"sign_device=True needs a P-256 signer: {e}") from e
            self.sign_batcher = signlane.SignBatcher(
                signlane.device_sign_backend(d, device=self.device,
                                             verify_after=self.sign_self_check),
                batch_max=self.sign_batch_max, wait_ms=self.sign_batch_wait_ms).start()
            self.sign_signer = signlane.BatchedSigner(self.signer, self.sign_batcher)
            if self.slos:
                # the default endorse objectives (unless the spec names
                # the endorse channel), fed by the lane's per-request
                # waits and BUSY bounces
                from fabric_tpu_torch.observe import slo as _slo

                self._add_default_slos(_slo.ENDORSE_CHANNEL, _slo.DEFAULT_ENDORSE_SLOS)
                self.sign_batcher.observer = _slo.endorse_observer(_slo.global_engine())
        if self.autopilot:
            self._arm_autopilot()
        if self.vitals_interval_s > 0 or self.blackbox_dir:
            self._arm_recorder()
        if self.device_ledger:
            from fabric_tpu_torch.observe import ledger as _ledgermod

            self.launch_ledger = _ledgermod.acquire()
        if self.tx_flow:
            self.txflow_journal = _txflow.acquire()
            if self.slos:
                # the default commit objectives, one event a completed flow
                from fabric_tpu_torch.observe import slo as _slo

                self._add_default_slos(_slo.COMMIT_CHANNEL, _slo.DEFAULT_COMMIT_SLOS)
                self.txflow_journal.slo_feed = _slo.commit_feed(_slo.global_engine())
            if self.sign_batcher is not None:
                # the lane's one observer slot: the journal's sign_wait
                # stage, behind the SLO feed when there is one
                prev, txobs = self.sign_batcher.observer, _txflow.sign_observer()
                if prev is None:
                    self.sign_batcher.observer = txobs
                else:
                    def _sign_chain(wait_ms, busy, _a=prev, _b=txobs):
                        _a(wait_ms, busy)
                        _b(wait_ms, busy)

                    self.sign_batcher.observer = _sign_chain
        self.server.register_unary("Endorse", self._on_endorse)
        self.server.register("DeliverBlocks", self._on_deliver_blocks)
        self.server.register_unary("Query", self._on_query)
        self.server.register_unary("Info", self._on_info)
        self.server.register_unary("Discover", self._on_discover)
        self.server.register_unary("Snapshot", self._on_snapshot)
        self.server.register_unary("InstallChaincode", self._on_install)
        self.server.register_unary("QueryInstalled", self._on_query_installed)
        self.gateway = gw.register(self)
        from fabric_tpu_torch.gossip import GossipService

        self.gossip_service = GossipService(self).register()
        await self.server.start()
        self.port = self.server.port
        if operations_port is not None:
            from fabric_tpu_torch.opsserver import HealthRegistry, OperationsServer

            health = HealthRegistry()
            health.register("rpc_server", lambda: None if self.server._server else "down")

            def _ledgers():  # evaluated per check: covers late joins
                for cid, ch in self.channels.items():
                    if ch.height < 0:
                        return f"ledger {cid} unhealthy"
                return None

            health.register("ledgers", _ledgers)
            health.register("device_verify_lane", self._device_lanes)
            self.operations = await OperationsServer(
                port=operations_port, health=health, autopilot=self.autopilot_ctl,
                vitals=self.vitals, blackbox=self.blackbox, launches=self.launch_ledger,
                txflow=self.txflow_journal).start()
        return self

    @staticmethod
    def _add_default_slos(channel: str, spec: str) -> None:
        from fabric_tpu_torch.observe import slo as _slo

        engine = _slo.global_engine()
        if not any(o.channel == channel for o in engine.objectives):
            engine.set_objectives(tuple(engine.objectives) + tuple(_slo.parse_slos(spec)))

    def _arm_autopilot(self) -> None:
        """The traffic autopilot over the global SLO engine, the tracer,
        the launch ledger, the sign lane and the channels' apply queues;
        its steps reach every joined channel's ``apply_knob`` and the
        node's sign lane.  The peer hosts no sidecar server, so the
        weight and shed rules have nothing to act on here."""
        from types import SimpleNamespace

        from fabric_tpu_torch.control import (Autopilot, host_clamped_specs,
                                              parse_knob_specs, resolve_host_workers_initial,
                                              set_global)
        from fabric_tpu_torch.observe.slo import global_engine

        def _apply(knob, value):
            # a snapshot: join_channel changes the dict on the event loop
            for ch in list(self.channels.values()):
                ch.apply_knob(knob, value)
            if self.sign_batcher is not None:
                if knob == "sign_batch_max":
                    self.sign_batcher.set_batch_max(int(value))
                elif knob == "sign_batch_wait_ms":
                    self.sign_batcher.set_wait_ms(float(value))

        def _commit_stats():
            # the worst state-apply queue age over the async channels
            ages = [float(ch.ledger.engine.stats().get("oldest_age_ms", 0.0))
                    for ch in list(self.channels.values())
                    if getattr(ch.ledger, "engine", None) is not None]
            return {"oldest_age_ms": max(ages)} if ages else {}

        specs = host_clamped_specs(parse_knob_specs(self.autopilot_knobs or None))
        if self.sign_batch_wait_ms == 0:
            # wait_ms 0 is the operator's static flush-at-once choice
            specs = {k: v for k, v in specs.items() if k != "sign_batch_wait_ms"}
        self.autopilot_ctl = Autopilot(
            specs, _apply, slo=global_engine(), sign_source=self.sign_batcher,
            commit_source=SimpleNamespace(stats=_commit_stats), tick_s=self.autopilot_tick_s,
            initial={"coalesce_blocks": self.coalesce_blocks, "verify_chunk": self.verify_chunk,
                     "pipeline_depth": self.pipeline_depth,
                     "host_stage_workers": resolve_host_workers_initial(
                         self.host_stage_workers),
                     "sign_batch_max": self.sign_batch_max,
                     "sign_batch_wait_ms": self.sign_batch_wait_ms})
        set_global(self.autopilot_ctl)
        self.autopilot_ctl.start()

    def _arm_recorder(self) -> None:
        """The flight recorder, refcounted (colocated nodes share one
        sampler and one black box; the last ``stop`` disarms them): the
        sampler when ``vitals_interval_s`` > 0, the black box always."""
        from types import SimpleNamespace

        from fabric_tpu_torch.observe import blackbox as _blackbox
        from fabric_tpu_torch.observe import timeseries as _timeseries

        if self.vitals_interval_s > 0:
            self.vitals = _timeseries.acquire(interval_s=self.vitals_interval_s,
                                              retention=self.vitals_retention)

        def _commit_report():
            # how far state apply trails the durable chain, per channel
            out = {}
            for cid, ch in list(self.channels.items()):
                eng = getattr(ch.ledger, "engine", None)
                if eng is None:
                    continue
                st = eng.stats()
                st["appended_height"] = ch.ledger.height
                st["synced_height"] = ch.ledger.blocks.synced_height
                out[cid] = st
            return out or None

        self.blackbox = _blackbox.acquire(out_dir=self.blackbox_dir,
                                          commit_source=SimpleNamespace(report=_commit_report))

    def _device_lanes(self):
        """Health of the channels' verify lanes: a degraded lane is a
        failed check whose reason says how the channel commits meanwhile
        (the port has no CPU fallback: the card's ``p256_verify``
        launched and synced at once, or the peer's own one in place of a
        lost sidecar link)."""
        for cid, ch in self.channels.items():
            g = getattr(ch.validator, "device_guard", None)
            if g is not None and g.degraded:
                if getattr(ch.validator, "link", None) is not None:
                    return (f"channel {cid}: sidecar link DEGRADED — committing via the "
                            "peer's own p256_verify on the card, recovery probe armed")
                return (f"channel {cid}: device verify lane DEGRADED — committing via a "
                        "synchronous p256_verify on the card, recovery probe armed")
        return None

    @property
    def endorse_signer(self):
        """The ESCC signing provider endorsements flow through: the
        card's sign lane when ``sign_device`` armed one, else the
        serial signer — same ``sign``/``serialized`` surface either
        way (peer/signlane.BatchedSigner)."""
        return self.sign_signer if self.sign_signer is not None else self.signer

    async def stop(self):
        if self.autopilot_ctl is not None:
            # disabled before stopped, so /autopilot and its gauge never
            # read a dead loop as live; the global handle goes if ours
            from fabric_tpu_torch.control import global_autopilot, set_global

            self.autopilot_ctl.set_enabled(False)
            self.autopilot_ctl.stop()
            if global_autopilot() is self.autopilot_ctl:
                set_global(None)
            self.autopilot_ctl = None
        if self.sign_batcher is not None:
            self.sign_batcher.stop()
            self.sign_batcher = None
            self.sign_signer = None
        if self.vitals is not None:
            from fabric_tpu_torch.observe import timeseries as _timeseries

            _timeseries.release()
            self.vitals = None
        if self.blackbox is not None:
            from fabric_tpu_torch.observe import blackbox as _blackbox

            _blackbox.release()
            self.blackbox = None
        if self.launch_ledger is not None:
            from fabric_tpu_torch.observe import ledger as _ledgermod

            _ledgermod.release()
            self.launch_ledger = None
        if self.txflow_journal is not None:
            _txflow.release()
            self.txflow_journal = None
        if self.gateway is not None:
            await self.gateway.close()
        for ch in self.channels.values():
            ch.stop()
        if self.gossip_service is not None:
            await self.gossip_service.stop()
        if self.operations is not None:
            await self.operations.stop()
        await self.server.stop()

    # -- lifecycle install / package resolution ------------------------------

    async def _on_install(self, req: bytes) -> bytes:
        """InstallChaincode: persist a package to the install store.
        Admission: mTLS at the transport, a size cap on the wire request
        and on the package, and with ``install_require_admin`` a signed
        envelope ``{"package", "identity", "signature"}`` (hex) from a
        valid admin of this peer's org whose signature covers the
        package."""
        wire_bound = (2 * self.max_package_size + 65536 if self.install_require_admin
                      else self.max_package_size)
        if len(req) > wire_bound:
            return json.dumps({
                "status": 413,
                "message": (f"install request too large: {len(req)} bytes "
                            f"exceeds the bound of {wire_bound}"),
            }).encode()
        raw = req
        if self.install_require_admin:
            err, raw = self._check_install_auth(req)
            if err is not None:
                return err
        if len(raw) > self.max_package_size:
            return json.dumps({
                "status": 413,
                "message": (f"package too large: {len(raw)} bytes exceeds the "
                            f"configured max of {self.max_package_size}"),
            }).encode()
        try:
            info = self.packages.install(raw)
        except ValueError as e:
            return json.dumps({"status": 400, "message": str(e)}).encode()
        return json.dumps({"status": 200, **info}).encode()

    def _check_install_auth(self, req: bytes):
        """→ (error_response | None, package_bytes)."""
        from fabric_tpu_torch.crypto.identity import ROLE_ADMIN

        def deny(msg: str) -> bytes:
            return json.dumps({"status": 403, "message": msg}).encode()

        try:
            envelope = json.loads(req)
            pkg = bytes.fromhex(envelope["package"])
            ident_ser = bytes.fromhex(envelope["identity"])
            sig = bytes.fromhex(envelope["signature"])
        except Exception:
            return deny("install requires an admin-signed request envelope "
                        '{"package", "identity", "signature"} (hex fields)'), b""
        try:
            ident = self.msp.deserialize_identity(ident_ser)
        except Exception as e:
            return deny(f"unknown installer identity: {e}"), b""
        if not ident.is_valid:
            return deny("installer identity failed MSP validation"), b""
        my_msp = getattr(self.signer, "msp_id", None)
        if my_msp and ident.msp_id != my_msp:
            # the install policy is this peer's own MSP's admins
            return deny(f"installer org '{ident.msp_id}' is not this peer's "
                        f"org '{my_msp}'"), b""
        if getattr(ident, "role", None) != ROLE_ADMIN:
            return deny(f"installer '{ident.msp_id}' is not an admin"), b""
        if not verify_signature(ident, pkg, sig):
            return deny("install signature does not cover package"), b""
        return None, pkg

    async def _on_query_installed(self, req: bytes) -> bytes:
        return json.dumps({"status": 200, "installed": self.packages.list()}).encode()

    def _resolve_chaincode(self, name: str, channel: str = ""):
        """Registry miss: a namespace with a committed lifecycle
        definition on this channel whose package (the id this org's
        approval binds) is installed here resolves to a ``CCaaSProxy``
        to the endpoint its connection.json names."""
        import re

        from fabric_tpu_torch.peer.ccaas import CCaaSProxy
        from fabric_tpu_torch.peer.lifecycle import (ChaincodeDefinition, approval_key,
                                                     definition_key)

        ch = self.channels.get(channel)
        if ch is None:
            return None
        my_msp = getattr(self.signer, "msp_id", None)
        state = ch.ledger.state
        vv = state.get_state(LIFECYCLE_NS, definition_key(name))
        if vv is None:
            return None
        try:
            cd = ChaincodeDefinition.from_bytes(vv.value)
        except Exception:
            return None
        # the package THIS ORG approved for the current sequence
        av = state.get_state(LIFECYCLE_NS, approval_key(name, cd.sequence, my_msp or ""))
        if av is None:
            return None
        try:
            spec = json.loads(av.value)
            pkg_id = spec.get("package_id", "") if isinstance(spec, dict) else ""
        except Exception:
            return None
        conn = self.packages.connection(pkg_id) if pkg_id else None
        addr = (conn or {}).get("address", "")
        hp = re.fullmatch(r"(.+):(\d+)", addr)
        if hp:
            return CCaaSProxy(name, hp.group(1), int(hp.group(2)))
        return None

    async def _on_endorse(self, req: bytes) -> bytes:
        signed = m.SignedProposal.parse(req)
        prop = m.Proposal.parse(signed.proposal_bytes)
        ch_hdr = m.ChannelHeader.parse(m.Header.parse(prop.header).channel_header)
        chan = self.channels.get(ch_hdr.channel_id)
        if chan is None:
            return m.ProposalResponse(response=m.Response(
                status=404, message=f"not joined to {ch_hdr.channel_id}")).serialize()
        endorser = chan.make_endorser(self.msp, self.endorse_signer, self.runtime)
        loop = asyncio.get_event_loop()
        async with chan.commit_lock.reader():  # stable height; parallel
            # off the event loop: the host ECDSA check, chaincode
            # execution and the wait on the card's sign lane must not
            # stall Deliver/Query/commit service latency
            result = await loop.run_in_executor(None, endorser.process_proposal, signed)
        if result.pvt_cleartext and result.tx_id:
            # endorsement-time pvt data: transient store + distribution
            # to eligible peers (gossip/privdata/distributor.go)
            chan.transient.persist(result.tx_id, result.pvt_cleartext, chan.height)
            if self.gossip_service is not None:
                t = asyncio.ensure_future(self.gossip_service.push_pvt(
                    ch_hdr.channel_id, result.tx_id, result.pvt_cleartext, chan.height))
                self._bg.add(t)
                t.add_done_callback(self._bg.discard)
        return result.response.serialize()

    async def _on_deliver_blocks(self, stream):
        req = json.loads(await stream.__anext__())
        chan = self.channels.get(req["channel"])
        if chan is None:
            await stream.error("no such channel")
            return
        num = req.get("start", 0)
        stop = req.get("stop")
        while stop is None or num <= stop:
            if num < chan.height:
                blk = chan.ledger.blocks.get_block(num)
                if blk is None:
                    # snapshot-pruned range: this peer cannot serve it
                    await stream.error(f"block {num} unavailable (pre-snapshot)")
                    return
                await stream.send(blk.serialize())
                num += 1
            else:
                # single event loop: no await between the height check
                # and grabbing the event, so no wakeup can be missed
                await chan._height_changed.wait()
        await stream.end()

    async def _on_query(self, req: bytes) -> bytes:
        q = json.loads(req)
        chan = self.channels.get(q["channel"])
        if chan is None:
            return json.dumps({"status": 404}).encode()
        vv = chan.ledger.state.get_state(q["ns"], q["key"])
        return json.dumps({
            "status": 200 if vv is not None else 404,
            # empty bytes is a real committed value, distinct from absent
            "value": vv.value.hex() if vv is not None and vv.value is not None else None,
            "version": list(vv.version) if vv is not None else None,
        }).encode()

    async def _on_info(self, req: bytes) -> bytes:
        q = json.loads(req)
        chan = self.channels.get(q["channel"])
        if chan is None:
            return json.dumps({"status": 404}).encode()
        return json.dumps({"status": 200, "height": chan.height}).encode()

    async def _on_snapshot(self, req: bytes) -> bytes:
        """Admin snapshot request: {channel, out_dir} → signable
        metadata (snapshotgrpc/snapshot_service.go analog)."""
        q = json.loads(req)
        chan = self.channels.get(q["channel"])
        if chan is None:
            return json.dumps({"status": 404}).encode()
        try:
            meta = await chan.snapshot(q["out_dir"])
        except Exception as e:
            return json.dumps({"status": 500, "error": str(e)}).encode()
        return json.dumps({"status": 200, "metadata": meta}).encode()

    async def _on_discover(self, req: bytes) -> bytes:
        """Discovery queries: peers / config / endorsers per channel
        (discovery/service.go analog over the node's registry +
        channel bundles)."""
        q = json.loads(req)
        channel = q.get("channel", "")

        def bundle_for(ch_id):
            ch = self.channels.get(ch_id)
            return getattr(ch.processor, "bundle", None) if ch else None

        def policy_for(ch_id, cc):
            ch = self.channels.get(ch_id)
            if ch is None:
                return None
            info = ch.validator.policies.info(cc)
            return info.policy if info else None

        svc = DiscoveryService(self.registry, bundle_for, policy_for)
        kind = q.get("query", "peers")
        if kind == "peers":
            return json.dumps({"status": 200, "peers": svc.peers(channel)}).encode()
        if kind == "config":
            cfg = svc.config(channel)
            if cfg is None:
                return json.dumps({"status": 404}).encode()
            return json.dumps({"status": 200, "config": cfg}).encode()
        if kind == "endorsers":
            desc = svc.endorsement_descriptor(channel, q["chaincode"])
            if desc is None:
                return json.dumps({"status": 404}).encode()
            return json.dumps({"status": 200, "descriptor": desc}).encode()
        return json.dumps({"status": 400, "error": f"unknown query {kind}"}).encode()
