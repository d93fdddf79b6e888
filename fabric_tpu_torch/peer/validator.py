"""The block validator (counterpart: ``fabric_tpu/peer/validator.py``).

The port's entry takes a wire-format ``protos.messages.Block``, which
``preprocess`` decodes with the front end (``peer/frontend.py``) and the
validator's MSP (``msp=``), or a block its caller decoded already
(``peer/decoded.py::DecodedBlock``): per transaction the txid, the
creator identity and signature, the endorsements, and the read/write
set.  Each signature arrives as (digest, r, s), the digest being the
SHA-256 the reference hashes (the payload for the creator, the proposal
response payload plus the endorser for an endorsement).

Check order and codes are the reference's (creator signature → policy →
MVCC / phantom; ``_finish_device``):

* preprocess (prefetch thread): in-block duplicate txids, the signature
  batch and its verify launch, unknown namespaces → INVALID_CHAINCODE,
  one policy group per policy, the static MVCC arrays;
* validate_launch: duplicates against the ledger and the in-flight
  predecessors, committed-state range phantoms, the committed-version
  compare (through the predecessor overlay), the fused stage 2;
* validate_finish: codes from the packed stage-2 output — or, when any
  row is consumption-unsafe, the whole block redone on the exact host
  interpreter with ``ops.mvcc.mvcc_validate`` (the reference's
  ``_validate_host``) — then the update batch and history.

``state_resident=True`` keeps the committed versions of the working set
on the device (``state/residency.py``): the launch then computes the
ver_ok column with ``resident_verok`` against the resident table instead
of reading every unique read key from the state DB, and
``resident_commit`` (called by ``CommitPipeline`` at the commit
boundary; a caller committing outside the pipeline calls it after each
commit) scatters each committed write set into the table.  Blocks with
range queries, and working sets larger than the table, keep the host
read.  Errors of the resident path raise; nothing falls back.

``kernel`` selects the verify kernel through the facade ``ops/p256.py``
(None: ``FABRIC_TPU_P256``, default v3).  Under the comparison kernels
"v1" and "v2" a block builds no ``DevicePre`` and launches no stage 2:
it finishes on ``_validate_host``, as the reference's does
(``validator.py:1798``).

A block carrying what this slice lacks raises ``NotImplementedError``
naming the later slice: config transactions, idemix creators, key-level
endorsement metadata writes, private-collection (hashed) read/write
sets and custom validation plugins.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property

import numpy as np
import torch

from fabric_tpu_torch.crypto import policy as pol
from fabric_tpu_torch.device import resolve_device
from fabric_tpu_torch.ledger.rwset import TxRWSet
from fabric_tpu_torch.ledger.statedb import UpdateBatch
from fabric_tpu_torch.ops import mvcc as mvcc_ops
from fabric_tpu_torch.ops import p256
from fabric_tpu_torch.peer import frontend
from fabric_tpu_torch.peer.decoded import DecodedBlock, DecodedEndorsement, DecodedTx
from fabric_tpu_torch.peer.device_block import DeviceBlockPipeline, resident_ver_ok
from fabric_tpu_torch.peer.txcodes import TxValidationCode as C
from fabric_tpu_torch.protos.messages import Block
from fabric_tpu_torch.state.residency import ResidencyManager, build_launch_pack
from fabric_tpu_torch.utils.batching import next_pow2

_NV = int(C.NOT_VALIDATED)

__all__ = ["BlockValidator", "DecodedBlock", "DecodedEndorsement", "DecodedTx",
           "NamespaceInfo", "PolicyProvider"]

# ---------------------------------------------------------------------------
# Policies


@dataclass
class NamespaceInfo:
    policy: object  # crypto.policy AST
    plugin: str = "default"


class PolicyProvider:
    """namespace → NamespaceInfo."""

    def __init__(self, infos: dict):
        self.infos = dict(infos)

    def info(self, namespace: str) -> NamespaceInfo | None:
        return self.infos.get(namespace)


# ---------------------------------------------------------------------------
# Per-block state


@dataclass(slots=True)
class ParsedTx:
    idx: int
    code: int = _NV
    txid: str = ""
    namespaces: tuple = ()
    rwset: TxRWSet | None = None
    creator_item_idx: int = -1
    endo_item_idx: list = field(default_factory=list)
    endorsers: list = field(default_factory=list)  # [Identity], deduplicated

    @property
    def undetermined(self) -> bool:
        return self.code == _NV


@dataclass
class DevicePre:
    """State-independent stage-2 inputs built at preprocess time."""

    groups: list          # [(plan, gp tensor [Eb, S*P+S+1], Eb, S)]
    group_entries: list   # [[(ptx, info)]] per group
    static: object        # ops.mvcc.StaticBlock
    static_t: torch.Tensor
    has_range: bool
    read_pv: torch.Tensor | None = None  # [T, R, 3] expected reads (resident path)


@dataclass
class Preprocessed:
    block: DecodedBlock
    txs: list
    items: list           # [(digest, r, s, qx, qy)]
    handle: object        # VerifyHandle (or the sidecar's RemoteVerifyHandle)
    dpre: DevicePre | None  # None: the block takes the host path


@dataclass
class PendingBlock:
    """A launched block between validate_launch and validate_finish."""

    block: DecodedBlock
    txs: list
    items: list
    handle: object
    dpre: DevicePre | None
    overlay: object = None
    fetch2: object = None
    range_phantom: frozenset = frozenset()

    @cached_property
    def txids(self) -> set:
        return {ptx.txid for ptx in self.txs if ptx.txid}


def _refuse_unsupported(block: DecodedBlock, policies: PolicyProvider) -> None:
    for dtx in block.txs:
        if dtx.is_config:
            raise NotImplementedError(
                "config transactions: a later slice of the port (config processing)")
        if dtx.creator is not None and not dtx.creator.has_ec_key:
            raise NotImplementedError(
                "idemix creators: a later slice of the port (host-verified creators)")
        if dtx.rwset is None:
            continue
        for ns, n in dtx.rwset.ns.items():
            if n.metadata_writes:
                raise NotImplementedError(
                    "key-level endorsement metadata writes: a later slice of the port (SBE)")
            if n.hashed:
                raise NotImplementedError(
                    "private-collection read/write sets: a later slice of the port (pvtdata)")
            info = policies.info(ns)
            if info is not None and (info.plugin or "default") != "default":
                raise NotImplementedError(
                    f"validation plugin {info.plugin!r}: a later slice of the port "
                    "(custom plugins)")


class BlockValidator:
    """validate(block) → (tx_filter bytes, UpdateBatch, history).
    ``block``: a wire ``Block`` (decoded with ``msp``, a
    ``crypto.msp.MSPManager``) or a ``DecodedBlock``."""

    def __init__(self, policy_provider: PolicyProvider, state_db, block_store=None,
                 device="cuda", state_resident: bool = False, state_resident_mb: int = 64,
                 state_resident_range_bits: int = 12, msp=None, kernel: str | None = None):
        self.msp = msp
        self.kernel = p256.selected(kernel)
        self.policies = policy_provider
        self.state = state_db
        self.blocks = block_store  # anything with tx_exists(txid)
        self.device = resolve_device(device)
        self._plans: dict = {}
        self._stage2 = DeviceBlockPipeline()
        self.resident = (ResidencyManager(state_resident_mb, state_resident_range_bits,
                                          device=self.device)
                         if state_resident else None)

    def _plan(self, policy) -> pol.BatchPlan:
        plan = self._plans.get(policy)
        if plan is None:
            plan = self._plans[policy] = pol.compile_plan(policy)
        return plan

    # -- preprocess (prefetch thread) ---------------------------------------

    def _parse(self, block: DecodedBlock):
        _refuse_unsupported(block, self.policies)
        txs, items, seen = [], [], set()
        for i, dtx in enumerate(block.txs):
            ptx = ParsedTx(idx=i, code=int(dtx.code), txid=dtx.txid, rwset=dtx.rwset)
            txs.append(ptx)
            if dtx.txid_bound and dtx.txid:
                # in-block duplicates (v20/validator.go:460-481)
                if dtx.txid in seen:
                    ptx.code = int(C.DUPLICATE_TXID)
                    continue
                seen.add(dtx.txid)
            if not ptx.undetermined:
                continue
            cr = dtx.creator
            if cr is None or not cr.is_valid or dtx.creator_sig is None:
                ptx.code = int(C.BAD_CREATOR_SIGNATURE)
                continue
            ptx.creator_item_idx = len(items)
            items.append((*dtx.creator_sig, cr.qx, cr.qy))
            # a repeated endorser counts once (policy.go:360-363), keyed
            # by its serialized bytes as the reference's is
            # (validator.py:1085-1095): two encodings of one identity
            # count twice.  An endorser without an EC key contributes
            # nothing.
            seen_endorsers = set()
            for end in dtx.endorsements:
                ident = end.endorser
                if end.serialized in seen_endorsers or not ident.has_ec_key:
                    continue
                seen_endorsers.add(end.serialized)
                ptx.endo_item_idx.append(len(items))
                items.append((end.digest, end.r, end.s, ident.qx, ident.qy))
                ptx.endorsers.append(ident)
            if dtx.rwset is not None:
                ptx.namespaces = tuple(sorted(dtx.rwset.ns))
        return txs, items

    def _device_preprocess(self, txs) -> DevicePre:
        entries = []
        for ptx in txs:
            if not ptx.undetermined:
                continue
            infos = [self.policies.info(ns) for ns in ptx.namespaces]
            if not ptx.namespaces or any(i is None for i in infos):
                ptx.code = int(C.INVALID_CHAINCODE)
                continue
            for info in infos:
                entries.append((ptx, info))
        by_policy: dict = {}
        for ptx, info in entries:
            by_policy.setdefault(id(info.policy), []).append((ptx, info))
        groups, group_entries = [], []
        for ents in by_policy.values():
            plan = self._plan(ents[0][1].policy)
            P = len(plan.principals)
            S = max(4, next_pow2(max((len(p.endorsers) for p, _ in ents), default=1) or 1))
            E = max(16, next_pow2(len(ents)))
            rows: dict = {}
            gp = np.zeros((E, S * P + S + 1), np.int32)
            gp[:, S * P:] = -1
            for e, (ptx, _) in enumerate(ents):
                gp[e, -1] = ptx.idx
                gp[e, S * P:S * P + len(ptx.endo_item_idx)] = ptx.endo_item_idx
                for s, ident in enumerate(ptx.endorsers):
                    row = rows.get(ident)
                    if row is None:
                        row = rows[ident] = [p.matched_by(ident) for p in plan.principals]
                    gp[e, s * P:(s + 1) * P] = row
            groups.append((plan, torch.from_numpy(gp).to(self.device), E, S))
            group_entries.append(ents)
        mvcc_txs, has_range = [], False
        for ptx in txs:
            if ptx.rwset is None or not ptx.undetermined:
                mvcc_txs.append(mvcc_ops.TxRWSet(reads=[], writes=[], range_reads=[]))
                continue
            if any(n.range_queries for n in ptx.rwset.ns.values()):
                has_range = True
            reads, writes, rqs = ptx.rwset.mvcc_form()
            mvcc_txs.append(mvcc_ops.TxRWSet(reads=reads, writes=writes, range_reads=rqs))
        static = mvcc_ops.prepare_block_static(mvcc_txs, bucketed=True,
                                               unique=self.resident is not None)
        static_t = torch.from_numpy(static.packed_static()).to(self.device)
        read_pv = None
        if static.u_pairs is not None:
            read_pv = torch.from_numpy(static.packed_read_pv()).to(self.device)
        return DevicePre(groups=groups, group_entries=group_entries, static=static,
                         static_t=static_t, has_range=has_range, read_pv=read_pv)

    def decode(self, block) -> DecodedBlock:
        """A wire ``Block`` through the front end with this validator's
        MSP; a ``DecodedBlock`` as it is."""
        if isinstance(block, DecodedBlock):
            return block
        if not isinstance(block, Block):
            raise TypeError(f"expected a Block or DecodedBlock, got {type(block).__name__}")
        if self.msp is None:
            raise ValueError("a wire Block needs the validator's msp= (an MSPManager)")
        return frontend.decode_block(block, self.msp)

    def preprocess(self, block) -> Preprocessed:
        """Decode, parse, launch the block's signature verify without
        waiting, and build the state-independent stage-2 inputs.  Touches
        no ledger state, so it may run while the predecessor commits."""
        block = self.decode(block)
        txs, items = self._parse(block)
        handle = self.verify_launch(items)
        # the fused stage 2 reads v3's verdicts on this device; under v1,
        # v2 or a remote verify (kernel None) the block takes the host path
        dpre = self._device_preprocess(txs) if self.kernel == "v3" else None
        return Preprocessed(block=block, txs=txs, items=items, handle=handle, dpre=dpre)

    def verify_launch(self, items):
        """Launch the block's signature verify without waiting."""
        return p256.verify_launch(items, kernel=self.kernel, device=self.device)

    # -- launch -------------------------------------------------------------

    def validate(self, block):
        return self.validate_finish(self.validate_launch(block))

    def validate_launch(self, block, pre: Preprocessed | None = None,
                        overlay=None, extra_txids=None) -> PendingBlock:
        """Everything up to the stage-2 dispatch.  ``overlay``: the
        merged UpdateBatch of in-flight predecessors whose commits may not
        have landed (its entries override committed-state reads);
        ``extra_txids``: their txids, for the duplicate check."""
        if pre is None:
            pre = self.preprocess(block)
        txs = pre.txs
        if self.blocks is not None or extra_txids:
            for ptx in txs:
                if ptx.undetermined and (
                        (extra_txids is not None and ptx.txid in extra_txids)
                        or (self.blocks is not None and self.blocks.tx_exists(ptx.txid))):
                    ptx.code = int(C.DUPLICATE_TXID)
        pending = PendingBlock(block=pre.block, txs=txs, items=pre.items, handle=pre.handle,
                               dpre=pre.dpre, overlay=overlay)
        if txs and pre.dpre is not None:
            pending.fetch2, pending.range_phantom = self._launch_device(
                txs, pre.handle, pre.dpre, overlay)
        return pending

    def _launch_device(self, txs, handle, dpre: DevicePre, overlay):
        # committed-range phantoms: the code is assigned at finish, after
        # the policy verdict; here the tx only leaves the writer set
        range_phantom = set()
        if dpre.has_range:
            for ptx in txs:
                if ptx.undetermined and ptx.rwset is not None and (
                        self._committed_range_phantom(ptx, overlay)
                        or (overlay is not None and _overlay_range_phantom(ptx, overlay))):
                    range_phantom.add(ptx.idx)
        static = dpre.static
        T = int(static.read_keys.shape[0])
        launch_vec = np.zeros((T, 3), np.int32)
        launch_vec[:, 0] = -1
        for ptx in txs:
            if ptx.undetermined:
                launch_vec[ptx.idx, 0] = ptx.creator_item_idx
                launch_vec[ptx.idx, 1] = ptx.idx not in range_phantom
        lv = self._resident_launch_vec(launch_vec, dpre, overlay)
        if lv is None:
            committed = self._committed_versions(static.read_key_set, overlay)
            launch_vec[:, 2] = static.host_ver_ok(committed)
            lv = torch.from_numpy(launch_vec).to(self.device)
        fetch2 = self._stage2.run(handle, lv, dpre.groups, dpre.static_t, static.dims, T)
        return fetch2, frozenset(range_phantom)

    # -- device-resident state ------------------------------------------------

    def _resident_launch_vec(self, launch_vec, dpre: DevicePre, overlay):
        """The launch vector on the device with its ver_ok column
        computed by ``resident_ver_ok`` against the resident table, or
        None when the block takes the host read (no resident state, range
        queries, a working set larger than the table)."""
        res = self.resident
        if res is None:
            return None
        static = dpre.static
        if static.u_pairs is None:
            res.route_host("range")
            return None
        launch_vec[:, 2] = 0
        lv = torch.from_numpy(launch_vec).to(self.device)
        R = static.dims[0]

        def read(table, u_pack):
            resident_ver_ok(dpre.static_t, table, u_pack, dpre.read_pv, R, lv)

        pack = build_launch_pack(res, static.u_pairs, self.state, overlay=overlay,
                                 u_index=static.u_index, read=read)
        return None if pack is None else lv

    def resident_commit(self, batch) -> None:
        """Scatter one committed block's write set into the resident
        table; ``CommitPipeline`` calls it at the commit boundary, before
        the block's commit future resolves.  A no-op without resident
        state; a failure raises."""
        if self.resident is not None:
            self.resident.apply_batch(batch)

    # -- finish ---------------------------------------------------------------

    def validate_finish(self, pending: PendingBlock):
        if pending.fetch2 is not None:
            result = self._finish_device(pending)
            if result is not None:
                return result
        return self._validate_host(pending)

    def _finish_device(self, pending: PendingBlock):
        """Codes from the packed stage-2 output; None sends the block to
        the exact host path (a consumption-unsafe policy row)."""
        txs, dpre = pending.txs, pending.dpre
        out = pending.fetch2()
        for safe_bits, ents in zip(out["safe"], dpre.group_entries):
            if not np.all(safe_bits[:len(ents)]):
                return None
        sig_valid = out["sig_valid"]
        n_sig = len(sig_valid)
        nT = len(txs)
        final = np.fromiter((ptx.code for ptx in txs), np.int32, nT)
        und = final == _NV
        ci = np.fromiter((ptx.creator_item_idx for ptx in txs), np.int64, nT)
        svF = np.concatenate([sig_valid, [False]])
        creator_fail = und & (ci >= 0) & ~svF[np.where((ci >= 0) & (ci < n_sig), ci, n_sig)]
        rp = np.zeros(nT, bool)
        rp[list(pending.range_phantom)] = True
        sel = np.select(
            [~out["policy_ok"][:nT], rp, out["valid"][:nT], out["phantom"][:nT]],
            [int(C.ENDORSEMENT_POLICY_FAILURE), int(C.PHANTOM_READ_CONFLICT),
             int(C.VALID), int(C.PHANTOM_READ_CONFLICT)],
            default=int(C.MVCC_READ_CONFLICT))
        upd = und & ~creator_fail
        final[upd] = sel[upd]
        final[creator_fail] = int(C.BAD_CREATOR_SIGNATURE)
        for ptx, c in zip(txs, final.tolist()):
            ptx.code = c
        batch, history = self._build_updates(pending.block.number, txs)
        return bytes(final.tolist()), batch, history

    def _validate_host(self, pending: PendingBlock):
        """The exact path: signature bits from the verify handle, the
        consumption interpreter per (tx, namespace), ``mvcc_validate``."""
        txs = pending.txs
        sig_valid = (np.asarray(pending.handle.fetch(), bool) if pending.items
                     else np.zeros(0, bool))
        for ptx in txs:
            if ptx.undetermined and ptx.creator_item_idx >= 0 \
                    and not sig_valid[ptx.creator_item_idx]:
                ptx.code = int(C.BAD_CREATOR_SIGNATURE)
        for ptx in txs:
            if not ptx.undetermined:
                continue
            infos = [self.policies.info(ns) for ns in ptx.namespaces]
            if not ptx.namespaces or any(i is None for i in infos):
                ptx.code = int(C.INVALID_CHAINCODE)
                continue
            for info in infos:
                plan = self._plan(info.policy)
                m = np.zeros((len(ptx.endorsers), len(plan.principals)), bool)
                for s, ident in enumerate(ptx.endorsers):
                    if sig_valid[ptx.endo_item_idx[s]]:
                        m[s] = [p.matched_by(ident) for p in plan.principals]
                if not pol.evaluate(info.policy, m):
                    ptx.code = int(C.ENDORSEMENT_POLICY_FAILURE)
                    break
        mvcc_txs, committed = self._mvcc_inputs(txs, pending.overlay)
        pre_ok = np.array([ptx.undetermined for ptx in txs], bool)
        if txs:
            valid, _, phantom = mvcc_ops.mvcc_validate_block(mvcc_txs, committed, pre_ok,
                                                             device=self.device)
            for ptx, v, ph in zip(txs, valid, phantom):
                if ptx.undetermined:
                    ptx.code = int(C.VALID if v else
                                   C.PHANTOM_READ_CONFLICT if ph else C.MVCC_READ_CONFLICT)
        batch, history = self._build_updates(pending.block.number, txs)
        return bytes(ptx.code for ptx in txs), batch, history

    # -- state reads ----------------------------------------------------------

    def _mvcc_inputs(self, txs, overlay=None):
        mvcc_txs, all_read_keys = [], set()
        empty = lambda: mvcc_ops.TxRWSet(reads=[], writes=[], range_reads=[])
        for ptx in txs:
            if ptx.rwset is None or not ptx.undetermined:
                mvcc_txs.append(empty())
                continue
            if self._committed_range_phantom(ptx, overlay) or (
                    overlay is not None and _overlay_range_phantom(ptx, overlay)):
                ptx.code = int(C.PHANTOM_READ_CONFLICT)
                mvcc_txs.append(empty())
                continue
            reads, writes, rqs = ptx.rwset.mvcc_form()
            mvcc_txs.append(mvcc_ops.TxRWSet(reads=reads, writes=writes, range_reads=rqs))
            all_read_keys.update(k for k, _ in reads)
        return mvcc_txs, self._committed_versions(all_read_keys, overlay)

    def _committed_versions(self, keys, overlay=None) -> dict:
        """{('pub', ns, key): Version} for the present keys — the
        in-flight predecessors' writes override the state read."""
        committed: dict = {}
        if not keys:
            return committed
        vers = self.state.get_versions_bulk([(k[1], k[2]) for k in keys])
        for k in keys:
            v = vers.get((k[1], k[2]))
            if v is not None:
                committed[k] = v
        if overlay is not None:
            for k in keys:
                vv = overlay.updates.get((k[1], k[2]))
                if vv is None:
                    continue
                if vv.value is None:
                    committed.pop(k, None)
                else:
                    committed[k] = vv.version
        return committed

    def _committed_range_phantom(self, ptx, overlay=None) -> bool:
        """A committed key inside a recorded range but missing from its
        recorded results ('' end = unbounded); keys an in-flight
        predecessor deleted do not count."""
        for ns_name, n in ptx.rwset.ns.items():
            for start, end, results in n.range_queries:
                recorded = {k for k, _ in results}
                for key, _vv in self.state.get_state_range(ns_name, start, end):
                    if key in recorded:
                        continue
                    if overlay is not None:
                        ov = overlay.updates.get((ns_name, key))
                        if ov is not None and ov.value is None:
                            continue
                    return True
        return False

    def _build_updates(self, block_num: int, txs):
        """Update batch + history for the VALID transactions, in tx
        order, namespaces and keys sorted; version (block, tx index)."""
        batch = UpdateBatch()
        history = []
        for ptx in txs:
            if ptx.code != int(C.VALID) or ptx.rwset is None:
                continue
            ver = (block_num, ptx.idx)
            for ns_name in sorted(ptx.rwset.ns):
                n = ptx.rwset.ns[ns_name]
                for key in sorted(n.writes):
                    val = n.writes[key]
                    if val is None:
                        batch.delete(ns_name, key, ver)
                    else:
                        batch.put(ns_name, key, val, ver)
                    history.append((ns_name, key, ptx.idx))
        return batch, history


def _overlay_range_phantom(ptx, overlay) -> bool:
    """An in-flight predecessor's write inside a recorded range but
    missing from its recorded results."""
    for ns_name, n in ptx.rwset.ns.items():
        for start, end, results in n.range_queries:
            recorded = {k for k, _ in results}
            for (ns, key), vv in overlay.updates.items():
                if ns != ns_name or vv.value is None:
                    continue
                if key >= start and (not end or key < end) and key not in recorded:
                    return True
    return False
