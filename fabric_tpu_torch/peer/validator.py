"""The block validator (counterpart: ``fabric_tpu/peer/validator.py``).

The port's entry takes a wire-format ``protos.messages.Block`` with the
validator's MSP (``msp=``), or a block its caller decoded already
(``peer/decoded.py::DecodedBlock``: per transaction the txid, the
creator identity and signature, the endorsements, and the read/write
set, each signature as (digest, r, s), the digest being the SHA-256 the
reference hashes).

A wire block takes the columnar parse (``_parse_wire``, the
reference's ``_parse_columnar``, validator.py:716-957): one
``native.blockparse`` call walks every envelope, hashes every signed
message and splits every DER signature; each distinct serialized
identity resolves once through the MSP; the tx id binding and the codes
are array work, the in-block duplicates one ordered pass; the signature
batch is column gathers (``ops/p256v3.SigColumns``: creators, then
endorsers); one
``native.mvccprep`` call flattens the read/write sets, from which
``ops/mvcc.prepare_block_from_flat`` builds the static MVCC arrays and
``_build_updates`` the update batch.  Envelopes the walk does not carry
(config transactions, malformed bytes, an odd endorsement: ``ok == 0``)
take the front end (``peer/frontend.py::decode_envelope``) one by one,
in block order, sharing the duplicate registry, as the reference's
``_parse_one_py`` lane; a set ``mvccprep`` does not cover (status 1: a
range query, a hashed collection, a metadata write, bytes that do not
parse) is parsed with ``TxRWSet.from_bytes``.  Other sets stay as bytes
until a host path reads ``ParsedTx.rwset``.  The reference takes the
native walk from 16 envelopes up (validator.py:658); the port takes it
for every wire block.

A column row's endorsers stay in ``WireBlock``'s ``[n, S]`` matrices
(``uid_mat``: the identity's row + 1, 0 for an empty slot;
``endo_idx_mat``: the signature item, -1 empty; ``ecnt``), the
reference's lazy shells (validator.py:880-978): ``_device_pre_columnar``
(validator.py:1926-2039) builds each policy group from them with array
gathers, and ``_materialize_for_host`` fills the per-tx ``endorsers``
and ``endo_item_idx`` lists only for a reader that needs them (the host
path, the generic ``_device_preprocess``).  A live envelope the front
end decoded joins them when the walk reached its set and that set is
flat (an envelope the walk left at an odd endorsement, such as an idemix
endorser's): its set goes into the one ``mvccprep`` call and its
endorsers, identities the walk interned, into the matrices.  A block
whose every live transaction is flat takes the columnar groups; any
other takes ``_device_preprocess``.

``host_stage_workers`` (0 off, -1 one a core, n; ``parallel/hostpool.py``)
gives the validator a staging pool, on which ``preprocess_many``
(validator.py:1265-1350) parses several blocks at once and starts each
block's device preprocessing as its parse lands; all their signatures
then go to the card in one ``verify_launch_many``, each block's frame
staged by one C call.  Pool tasks that copy to the card do so on the
stream of the thread that called ``preprocess_many``.

Every phase timer (``_t``, the reference's :541-546) observes
``validator_stage_seconds{stage}`` in the metrics registry and adds the
stage's span under the span the calling thread is attached to (the
pipeline's ``prefetch``, ``launch`` and ``finish``; nothing off a traced
path), whether or not ``timings`` is on.  ``timings`` (None: off) sums
each phase's seconds over the blocks under the reference's keys
(validator.py:460, :541-544): ``host_parse``,
``sig_prepare_launch`` and ``device_pre`` on the prefetch thread (under
``preprocess_many`` with a pool: the prefetch thread's wait for each);
``state_fill``, ``stage2_dispatch``, ``device_wait`` and ``postprocess``
on the caller's; ``hd_frame`` on the prefetch thread serializes a wire
block's header and data for the ledger commit (``PendingBlock.hd_bytes``,
the reference's :1258) when its ``block_store`` is a ledger's
``BlockStore`` (a tx-id index alone, as the smoke's runs attach, takes
no frame).

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
read.  A failed admission or commit scatter disables the cache
(``ResidencyManager``'s latch): every later block reads on the host.

The device lane's guard (``device_fail_threshold`` > 0;
``peer/degrade.py``; the reference's :215-281, :560-640, :1436-1515):
each verify launch goes through ``DeviceLaneGuard.run_launch``, which
retries, latches after consecutive failures and probes for recovery.  A
block whose lane failed gets a ``_SyncedHandle`` from
``_host_verify_fallback``: the verify kernel on this device, launched
and synced at once, whose ``device_out`` feeds the fused stage 2 as a
lane launch's would; if that launch fails too, the block raises.  A
launched block's handle is a ``_GuardedHandle``, whose failed fetch
re-verifies the block on the fallback.  A stage-2 dispatch or sync
failure is dispatched again on the card within the guard's retries
(``DeviceLaneGuard.retry``), then raises: no failure moves a block's
kernel work to the host.  Without a guard, the default, each of these
failures raises at once.  The ``validator.stage2`` fault point fires
before every stage-2 dispatch.

``kernel`` selects the verify kernel through the facade ``ops/p256.py``
(None: ``FABRIC_TPU_P256``, default v3).  Under the comparison kernels
"v1" and "v2" a block builds no ``DevicePre`` and launches no stage 2:
it finishes on ``_validate_host``, as the reference's does
(``validator.py:1798``).

Config transactions (``is_config``; the reference's :1005-1023,
:2454-2474) leave the endorsement pipeline: the genesis block's is
VALID, a later one's creator signature rides the block's batch and the
envelope goes to ``config_processor.validate_config_tx``
(``channelconfig.py``; VALID without a processor).  A pipelined caller
commits a config block fully before the next block launches
(``peer/pipeline.py``'s barrier); a ``pre`` staged under an MSP
manager or policy provider that has since rotated is preprocessed
again at launch (:1393-1400).  ``last_parsed`` holds the last launched
block's ``ParsedTx`` list.

Validation plugins (``ValidationPlugin``, ``plugins={name: plugin}``;
``NamespaceInfo.plugin``; :59-66, :1541-1583): on the host path every
(transaction, namespace) pair goes to its namespace's plugin, and a
transaction is valid only if every plugin approves it; a namespace
naming an unregistered plugin makes the transaction
INVALID_OTHER_REASON.  A block whose live transaction reaches a custom
plugin takes the host path.

Key-level endorsement (SBE, :1452-1790): a key whose committed (or
in-flight predecessor's) metadata holds a ``VALIDATION_PARAMETER``
policy is judged by that policy instead of its namespace's.  A block
that writes such a key (the launch veto, ``_sbe_launch_veto``) or
writes key metadata itself takes the host path, where ``_sbe_pass``
walks the block in order, an earlier plugin-valid transaction's
metadata update taking effect for later ones; the update batch then
commits metadata writes (a metadata-only write re-puts the value with a
new version, a no-op on an absent key), keeps a key's metadata across
plain writes and clears it on deletes (``_build_updates(sbe=True)``).

Private-collection read/write sets: hashed keys are MVCC keys
``('pvt', ns, coll, key_hash)`` beside the public ones (a disjoint id
range of the same key table), their committed versions read from the
state namespace ``ns$coll#hashed`` under the hash's hex (through the
overlay too), and a valid transaction's hashed writes enter the update
batch there.  Such a block takes the fused path; under
``state_resident=True`` its committed versions are read on the host, as
the reference's resident path does.

Idemix creators (``crypto/idemix.py``; the reference's :1054-1069,
:1202-1208, :2082-2095) carry no EC key, so their signatures take no
lane of the card's batch: each presentation proof is verified on the
host while the block parses, a failure is BAD_CREATOR_SIGNATURE, and a
verified creator (``host_creator_ok``) takes the creator sentinel -2,
which ``stage2`` gathers as True.  A wire block keeps such rows in the
columnar parse (the C walk parses them whole; the proof is checked over
the envelope's payload and signature bytes), so a few anonymous
creators keep the block on the columnar group builder; the front end
verifies the ones it decodes (``DecodedBlock``s, ``ok == 0``
envelopes).  The reference sends such rows to its Python parser
instead; the verdicts are the same.  An idemix endorser contributes
nothing, as in the reference.  The proofs are verified again whenever a
block is preprocessed again (a rotated MSP manager, the pipeline's
stale re-preprocess), so a block staged before an epoch-record rotation
is judged under the new record.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from functools import cached_property

import numpy as np
import torch

from fabric_tpu_torch import faults, protoutil
from fabric_tpu_torch.crypto import policy as pol
from fabric_tpu_torch.crypto.msp import policy_from_proto
from fabric_tpu_torch.device import resolve_device
from fabric_tpu_torch.ledger.blockstore import BlockStore
from fabric_tpu_torch.ledger.rwset import (
    VALIDATION_PARAMETER, TxRWSet, decode_metadata, encode_metadata,
)
from fabric_tpu_torch.ledger.statedb import UpdateBatch
from fabric_tpu_torch.native import blockparse, mvccprep
from fabric_tpu_torch.observe import global_tracer
from fabric_tpu_torch.observe import ledger as _ledger
from fabric_tpu_torch.ops import mvcc as mvcc_ops
from fabric_tpu_torch.ops import p256, p256v3
from fabric_tpu_torch.ops_metrics import global_registry
from fabric_tpu_torch.parallel.hostpool import clamp_workers, resolve_host_pool
from fabric_tpu_torch.peer import frontend
from fabric_tpu_torch.peer.decoded import DecodedBlock, DecodedEndorsement, DecodedTx
from fabric_tpu_torch.peer.degrade import DeviceLaneGuard
from fabric_tpu_torch.peer.device_block import DeviceBlockPipeline, resident_ver_ok
from fabric_tpu_torch.peer.txcodes import TxValidationCode as C
from fabric_tpu_torch.protos import messages as pm
from fabric_tpu_torch.protos.messages import Block
from fabric_tpu_torch.protos.wire import DecodeError
from fabric_tpu_torch.state.residency import ResidencyManager, build_launch_pack
from fabric_tpu_torch.utils.batching import next_pow2

_NV = int(C.NOT_VALIDATED)

_log = logging.getLogger("fabric_tpu_torch.validator")

__all__ = ["BlockValidationCtx", "BlockValidator", "DecodedBlock", "DecodedEndorsement",
           "DecodedTx", "NamespaceInfo", "PolicyProvider", "ValidationPlugin"]

LIFECYCLE_NS = "_lifecycle"

# ---------------------------------------------------------------------------
# Policies


@dataclass
class NamespaceInfo:
    policy: object  # crypto.policy AST
    plugin: str = "default"
    # {coll: {"member_orgs": [...], "required_peer_count": int,
    #  "max_peer_count": int, "btl": int}} — static assemblies;
    # lifecycle-backed providers read the committed definition instead
    collections: dict = field(default_factory=dict)


class PolicyProvider:
    """namespace → NamespaceInfo."""

    def __init__(self, infos: dict):
        self.infos = dict(infos)

    def info(self, namespace: str) -> NamespaceInfo | None:
        return self.infos.get(namespace)

    def collection(self, namespace: str, coll: str) -> dict | None:
        """Collection config for (namespace, coll), or None when
        undefined — undefined collections are treated as
        maximally-private (own org only) by the dissemination layer."""
        info = self.info(namespace)
        if info is None:
            return None
        return getattr(info, "collections", {}).get(coll)


@dataclass
class BlockValidationCtx:
    txs: list              # [ParsedTx]
    sig_valid: np.ndarray  # [n_items] bool: the block's signature batch
    msp_manager: object
    policy_provider: PolicyProvider


class ValidationPlugin:
    """A namespace's validation plugin (validation.Plugin,
    api/validation.go:26-38), batch-shaped: ``validate_batch_group(ctx,
    group)`` → one bool a (ParsedTx, namespace) pair of ``group``, or
    the older ``validate_batch(ctx)`` → one bool a transaction of the
    block.  ``ParsedTx.endorsers`` and ``endo_item_idx`` give a
    transaction's endorsers and their signature items in
    ``ctx.sig_valid``."""

    def validate_batch(self, ctx: BlockValidationCtx) -> np.ndarray:
        raise NotImplementedError


class DefaultValidation(ValidationPlugin):
    """The built-in plugin: each pair's namespace policy over the
    transaction's verified endorsers (the exact interpreter)."""

    def __init__(self):
        self._plans: dict = {}

    def validate_batch_group(self, ctx: BlockValidationCtx, group) -> list:
        out = []
        for ptx, ns in group:
            policy = ctx.policy_provider.info(ns).policy
            plan = self._plans.get(policy)
            if plan is None:
                plan = self._plans[policy] = pol.compile_plan(policy)
            out.append(_endorsed(policy, plan, ptx, ctx.sig_valid))
        return out


def _endorsed(policy, plan, ptx, sig_valid) -> bool:
    """``policy`` over the transaction's sig-valid endorsers."""
    mat = np.zeros((len(ptx.endorsers), len(plan.principals)), bool)
    for s, ident in enumerate(ptx.endorsers):
        if sig_valid[ptx.endo_item_idx[s]]:
            mat[s] = [p.matched_by(ident) for p in plan.principals]
    return bool(pol.evaluate(policy, mat, plan))


# ---------------------------------------------------------------------------
# Per-block state


@dataclass(slots=True)
class ParsedTx:
    idx: int
    code: int = _NV
    txid: str = ""
    namespaces: tuple = ()
    creator_item_idx: int = -1
    endo_item_idx: list = field(default_factory=list)
    endorsers: list = field(default_factory=list)  # [Identity], deduplicated
    rwset_bytes: bytes | None = None  # a wire block's set, parsed at first use
    _rwset: TxRWSet | None = None
    is_config: bool = False
    config_data: bytes = b""  # a config transaction's ConfigEnvelope bytes
    host_creator_ok: bool = False  # an idemix creator, its proof verified on the host

    @property
    def undetermined(self) -> bool:
        return self.code == _NV

    @property
    def creator_lane(self) -> int:
        """The creator's lane of stage 2's gather: its signature item,
        -2 for a host-verified creator (always true), -1 for none."""
        return -2 if self.host_creator_ok else self.creator_item_idx

    @property
    def rwset(self) -> TxRWSet | None:
        """The read/write set; a wire block's is parsed at first use
        (the reference's lazy ``rwset``, validator.py:115-135).  The
        walk accepted those bytes, so a parse failure is unreachable;
        it fails closed (BAD_RWSET) all the same."""
        if self._rwset is None and self.rwset_bytes is not None:
            try:
                self._rwset = TxRWSet.from_bytes(self.rwset_bytes)
            except DecodeError:
                if self.undetermined:
                    self.code = int(C.BAD_RWSET)
                self._rwset = TxRWSet()
        return self._rwset

    @rwset.setter
    def rwset(self, value: TxRWSet | None) -> None:
        self._rwset, self.rwset_bytes = value, None


@dataclass
class WireBlock:
    """A wire block after the columnar parse: the C arrays the later
    stages read.  ``flat[i]``: transaction i's set is in ``rwp``'s flat
    arrays (status 0); ``keys``, ``lex_rank``: each interned key's
    ('pub', ns, key) and its rank in that order; ``ns_names``: ``rwp``'s
    namespace table.  ``uid_mat``, ``endo_idx_mat`` [n, S] and ``ecnt``
    [n]: each flat row's endorsers (``idents[uid - 1]``) and their
    signature items, slots 0..ecnt-1 (see the module docstring);
    ``materialized``: ``_materialize_for_host`` filled the lists.
    ``n_front_end``: envelopes the front end decoded;
    ``n_rwset_parsed``: sets parsed with ``TxRWSet.from_bytes``."""

    number: int
    pb: blockparse.ParsedBlock
    rwp: mvccprep.MvccPrep
    flat: np.ndarray
    keys: list
    lex_rank: np.ndarray
    ns_names: list
    idents: list
    uid_mat: np.ndarray
    endo_idx_mat: np.ndarray
    ecnt: np.ndarray
    n_front_end: int
    n_rwset_parsed: int
    materialized: bool = False


@dataclass
class DevicePre:
    """State-independent stage-2 inputs built at preprocess time."""

    groups: list          # [(plan, gp tensor [Eb, S*P+S+1], Eb, S)], views of frames
    group_entries: list   # per group its E entries: [(ptx, info)] or [E] tx indices
    static: object        # ops.mvcc.StaticBlock
    static_t: torch.Tensor
    has_range: bool
    read_pv: torch.Tensor | None = None  # [T, R, 3] expected reads (resident path)
    has_pvt: bool = False  # private-collection keys (host read under residency)
    frames: torch.Tensor | None = None  # every group's frame, one after another


@dataclass
class Preprocessed:
    block: object         # DecodedBlock or WireBlock
    txs: list
    items: object         # [(digest, r, s, qx, qy)] or p256v3.SigColumns
    handle: object        # VerifyHandle (or the sidecar's RemoteVerifyHandle)
    dpre: DevicePre | None  # None: the block takes the host path
    msp: object = None      # the MSP manager and policy provider it was staged
    policies: object = None  # under (a rotated one redoes the preprocess)
    wire: object = None     # the wire Block given (None for a DecodedBlock)
    hd_bytes: bytes | None = None  # its header and data fields, serialized


@dataclass
class PendingBlock:
    """A launched block between validate_launch and validate_finish."""

    block: object
    txs: list
    items: object
    handle: object
    dpre: DevicePre | None
    overlay: object = None
    fetch2: object = None
    range_phantom: frozenset = frozenset()
    wire: object = None             # the wire Block (the ledger commits it)
    hd_bytes: bytes | None = None   # protoutil.block_header_data_bytes(wire)

    @cached_property
    def txids(self) -> set:
        return {ptx.txid for ptx in self.txs if ptx.txid}


class _SyncedHandle:
    """A completed verify in the shape of a verify handle: the degraded
    lane's route (``_host_verify_fallback``).  ``device_out`` is the
    kernel's accept vector on the card, so the block's stage 2 runs as
    on the lane."""

    __slots__ = ("device_out", "n_real", "result")

    def __init__(self, device_out, n_real: int, result: list):
        self.device_out = device_out
        self.n_real = n_real
        self.result = result

    def fetch(self) -> list:
        return self.result

    def __call__(self) -> list:
        return self.result


class _GuardedHandle:
    """A lane's verify handle with the guard's accounting at the fetch:
    ``device_out`` passes through, so the fused stage 2 is unchanged; a
    failed fetch counts toward the latch and re-verifies this block on
    the fallback (``fell_back``).  ``validate_finish`` records the
    block's success."""

    __slots__ = ("_h", "_guard", "_validator", "_items", "_result", "fell_back")

    def __init__(self, handle, guard, validator, items):
        self._h = handle
        self._guard = guard
        self._validator = validator
        self._items = items
        self._result = None
        self.fell_back = False

    @property
    def device_out(self):
        return getattr(self._h, "device_out", None)

    @property
    def n_real(self) -> int:
        return getattr(self._h, "n_real", 0)

    @property
    def rec(self):
        return getattr(self._h, "rec", None)

    def fetch(self) -> list:
        if self._result is not None:
            return self._result
        try:
            self._result = self._h.fetch()
        except Exception as e:
            self._guard.record_failure(e)
            self._guard.count_fallback()
            self.fell_back = True
            _log.warning("verify sync failed (%s); this block is verified again on the "
                         "fallback", e)
            self._result = self._validator._host_verify_fallback(self._items).fetch()
        return self._result

    def __call__(self) -> list:
        return self.fetch()


def _has_meta_writes(rwset) -> bool:
    return rwset is not None and any(n.metadata_writes for n in rwset.ns.values())


def _custom(info) -> bool:
    return info is not None and (info.plugin or "default") != "default"


class BlockValidator:
    """validate(block) → (tx_filter bytes, UpdateBatch, history).
    ``block``: a wire ``Block`` (decoded with ``msp``, a
    ``crypto.msp.MSPManager``) or a ``DecodedBlock``.
    ``host_stage_workers``: the staging pool's size (0 off, -1 one
    worker per core); ``close()`` shuts it down.  ``verify_chunk``: the
    signatures a ``p256_verify`` launch takes (0: the whole batch in
    one).  ``set_verify_chunk`` and ``set_host_stage_workers`` change
    either at the next block boundary.  ``plugins``: {name:
    ValidationPlugin} beside the built-in "default";
    ``config_processor``: a ``channelconfig.ConfigTxProcessor``.

    ``device_fail_threshold`` (0: no guard, the default),
    ``device_retries`` and ``device_recovery_s`` build ``device_guard``
    (``peer/degrade.py``), the reference's knobs with its defaults: the
    verify launches go through it, a block whose lane failed takes
    ``_host_verify_fallback`` (the same kernel, launched and synced at
    once), and a stage-2 dispatch or sync failure is dispatched again on
    the card within the retries.  Without a guard each of those
    failures raises."""

    def __init__(self, policy_provider: PolicyProvider, state_db, block_store=None,
                 device="cuda", state_resident: bool = False, state_resident_mb: int = 64,
                 state_resident_range_bits: int = 12, msp=None, kernel: str | None = None,
                 host_stage_workers: int = 0, plugins: dict | None = None,
                 config_processor=None, device_fail_threshold: int = 0,
                 device_retries: int = 2, device_recovery_s: float = 30.0,
                 verify_chunk: int = 0):
        self.msp = msp
        # signature-batch microbatching: each block's verify launches in
        # chunks of this many signatures (ops/p256v3.py); 0 = one launch
        self.verify_chunk = max(0, int(verify_chunk))
        # latched by set_verify_chunk / set_host_stage_workers (the
        # autopilot's actuators), applied at the next block boundary
        # (_apply_pending_knobs); locked, since the controller thread
        # sets while the prefetch thread applies
        self._knob_lock = threading.Lock()
        self._pending_verify_chunk: int | None = None
        self._pending_host_workers: int | None = None
        self.plugins = {"default": DefaultValidation(), **(plugins or {})}
        self.config_processor = config_processor
        self.last_parsed: list = []
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
        # seconds per phase, summed over blocks (validator.py:460); None: off
        self.timings: dict | None = None
        self._timings_lock = threading.Lock()
        # the same stages feed the registry and the span tracer always
        # (validator.py:463-475)
        self._stage_hist = global_registry().histogram(
            "validator_stage_seconds",
            "per-block validator stage time (s), bench-breakdown stages",
        )
        self._tracer = global_tracer()
        self.host_stage_workers = int(host_stage_workers)
        self.host_pool = resolve_host_pool(self.host_stage_workers)
        self.device_guard = (DeviceLaneGuard(retries=device_retries,
                                             fail_threshold=device_fail_threshold,
                                             recovery_s=device_recovery_s)
                             if device_fail_threshold > 0 else None)

    def close(self) -> None:
        """Shut the staging pool down (its threads outlive the
        validator otherwise).  Idempotent."""
        pool, self.host_pool = self.host_pool, None
        if pool is not None:
            pool.shutdown()

    # -- run-time knobs (the autopilot's actuators) ----------------------------

    def set_verify_chunk(self, n: int) -> None:
        """A new verify chunk size (0: one launch), applied at the next
        block boundary, the top of ``preprocess`` / ``preprocess_many``,
        so a block's verify always runs under one chunk size."""
        with self._knob_lock:
            self._pending_verify_chunk = max(0, int(n))

    def set_host_stage_workers(self, n: int) -> None:
        """A new staging pool size, applied at the next block boundary:
        n >= 2 resizes the live pool (``HostStagePool.set_workers``, at
        its next idle task boundary) or builds one; n < 2 closes it back
        to serial staging.  The verdicts are the same either way."""
        with self._knob_lock:
            self._pending_host_workers = max(0, int(n))

    def _apply_pending_knobs(self) -> None:
        with self._knob_lock:
            n, self._pending_verify_chunk = self._pending_verify_chunk, None
            w, self._pending_host_workers = self._pending_host_workers, None
        if n is not None:
            self.verify_chunk = n
        if w is None:
            return
        if w < 2:
            pool, self.host_pool = self.host_pool, None
            self.host_stage_workers = 0
            if pool is not None:
                pool.shutdown()
        elif self.host_pool is not None:
            self.host_pool.set_workers(w)
            # the size the pool takes at its idle-boundary swap
            self.host_stage_workers = clamp_workers(w)
        else:
            self.host_pool = resolve_host_pool(w)
            self.host_stage_workers = self.host_pool.workers if self.host_pool else 0

    def _t(self, key: str, t0: float) -> float:
        """The stage since ``t0``: observed in ``validator_stage_seconds``,
        added as a span under the thread's current span, and added to
        ``timings[key]`` when the timers are on; returns now.  The
        prefetch thread (``preprocess``) and the caller's thread
        (launch, finish) add to the dict at once, so each addition
        takes ``_timings_lock``."""
        t1 = time.perf_counter()
        if self.timings is not None:
            with self._timings_lock:
                self.timings[key] = self.timings.get(key, 0.0) + (t1 - t0)
        self._stage_hist.observe(t1 - t0, stage=key)
        self._tracer.add(key, t0, t1)  # a no-op off the traced paths
        return t1

    def _plan(self, policy) -> pol.BatchPlan:
        plan = self._plans.get(policy)
        if plan is None:
            plan = self._plans[policy] = pol.compile_plan(policy)
        return plan

    # -- preprocess (prefetch thread) ---------------------------------------

    def _parse(self, block: DecodedBlock):
        txs, items, seen = [], [], set()
        for i, dtx in enumerate(block.txs):
            txs.append(self._parse_tx(i, dtx, seen, items, block.number == 0))
        return txs, items

    @staticmethod
    def _parse_tx(i: int, dtx: DecodedTx, seen: set, items: list,
                  genesis: bool = False) -> ParsedTx:
        """One decoded envelope → ``ParsedTx``; its signatures go onto
        ``items``, its tx id into ``seen`` (the block's claimed ids).
        A config transaction's creator is checked unless the block is
        the genesis block (the channel's trust anchor)."""
        ptx = ParsedTx(idx=i, code=int(dtx.code), txid=dtx.txid, _rwset=dtx.rwset)
        if dtx.is_config:
            ptx.is_config, ptx.config_data = True, dtx.config_data
            if genesis or not ptx.undetermined:
                return ptx
            cr = dtx.creator
            if cr is None or not cr.is_valid or dtx.creator_sig is None:
                ptx.code = int(C.BAD_CREATOR_SIGNATURE)
            else:
                ptx.creator_item_idx = len(items)
                items.append((*dtx.creator_sig, cr.qx, cr.qy))
            return ptx
        if dtx.txid_bound and dtx.txid:
            # in-block duplicates (v20/validator.go:460-481)
            if dtx.txid in seen:
                ptx.code = int(C.DUPLICATE_TXID)
                return ptx
            seen.add(dtx.txid)
        if not ptx.undetermined:
            return ptx
        cr = dtx.creator
        if cr is None or not cr.is_valid or (dtx.creator_sig is None
                                             and not dtx.host_creator_ok):
            ptx.code = int(C.BAD_CREATOR_SIGNATURE)
            return ptx
        if dtx.host_creator_ok:
            ptx.host_creator_ok = True
        else:
            ptx.creator_item_idx = len(items)
            items.append((*dtx.creator_sig, cr.qx, cr.qy))
        # a repeated endorser counts once (policy.go:360-363), keyed by
        # its serialized bytes as the reference's is
        # (validator.py:1085-1095): two encodings of one identity count
        # twice.  An endorser without an EC key contributes nothing.
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
        return ptx

    def _parse_wire(self, block: Block):
        """The columnar parse of a wire block (see the module docstring)
        → (WireBlock, [ParsedTx], SigColumns)."""
        if self.msp is None:
            raise ValueError("a wire Block needs the validator's msp= (an MSPManager)")
        envs = list(block.data.data) if block.data is not None else []
        number = block.header.number if block.header is not None else 0
        n = len(envs)
        pb = blockparse.parse_envelopes(envs)
        blob = pb.blob

        # -- each distinct serialized identity, once
        n_ids = pb.n_ids
        idents = [None] * n_ids
        known, ivalid, has_ec, idemix = (np.zeros(n_ids + 1, bool) for _ in range(4))
        for u, (o, ln) in enumerate(pb.ident_span[:n_ids].tolist()):
            try:
                ident = self.msp.deserialize_identity(blob[o:o + ln])
            except ValueError:
                continue
            idents[u] = ident
            known[u], ivalid[u], idemix[u] = True, ident.is_valid, ident.idemix
            has_ec[u] = ident.has_ec_key
        q_pool = np.zeros((n_ids, 64), np.uint8)
        q_ok = np.zeros(n_ids, bool)
        ec_u = np.flatnonzero(has_ec[:n_ids])
        if len(ec_u):
            qx, qx_in = p256v3.pack256([idents[u].qx for u in ec_u.tolist()])
            qy, qy_in = p256v3.pack256([idents[u].qy for u in ec_u.tolist()])
            q_pool[ec_u] = np.concatenate([qx, qy], axis=1)
            q_ok[ec_u] = p256v3.q_admit(q_pool[ec_u]) & qx_in & qy_in

        col = pb.ok.astype(bool)
        front = ~col  # decoded by the front end
        cu = pb.creator_uid.astype(np.int64)
        cu_valid = cu >= 0
        cuc = np.where(cu_valid, cu, n_ids)

        # -- tx id binding: tx_id == hex(sha256(nonce || creator))
        t_off, t_len = pb.txid_span[:, 0], pb.txid_span[:, 1]
        blob_u8 = np.frombuffer(blob, np.uint8)
        bind = np.zeros(n, bool)
        rows = np.flatnonzero(col & (t_off >= 0) & (t_len == 64))
        if len(rows):
            txh = blob_u8[t_off[rows][:, None] + np.arange(64)]
            dg = pb.txid_digest[rows]
            hx = np.empty((len(rows), 64), np.uint8)
            for k, nib in ((0, dg >> 4), (1, dg & 15)):
                hx[:, k::2] = np.where(nib < 10, nib + 48, nib + 87)
            bind[rows] = (txh == hx).all(axis=1)
        txids = [""] * n
        off_l, len_l = t_off.tolist(), t_len.tolist()
        for i in np.flatnonzero(col & (t_off >= 0)).tolist():
            txids[i] = blob[off_l[i]:off_l[i] + len_l[i]].decode()

        # -- in-block duplicates, and the front end's envelopes, in block
        # order: both claim tx ids in one registry
        dup = np.zeros(n, bool)
        txs: list = [None] * n
        front_items: list = []
        front_idx = np.flatnonzero(front).tolist()
        seen: set = set()
        for i, (fr, bd) in enumerate(zip(front.tolist(), bind.tolist())):
            if fr:
                dtx = frontend.decode_envelope(envs[i], self.msp)
                txs[i] = self._parse_tx(i, dtx, seen, front_items, number == 0)
            elif bd:
                if txids[i] in seen:
                    dup[i] = True
                else:
                    seen.add(txids[i])

        codes = np.full(n, _NV, np.int32)
        codes[col & ~bind] = int(C.BAD_PROPOSAL_TXID)
        codes[dup] = int(C.DUPLICATE_TXID)
        cred = (cu_valid & known[cuc] & ivalid[cuc] & has_ec[cuc]
                & pb.creator_sig_ok.astype(bool))
        live = col & bind & ~dup
        # a live row's idemix creator: its proof over the payload, on the
        # host (the walk reads the JSON proof as no DER signature)
        host_ok = np.zeros(n, bool)
        for i in np.flatnonzero(live & idemix[cuc] & ivalid[cuc]).tolist():
            try:
                env = pm.Envelope.parse(envs[i])
            except DecodeError:
                continue
            host_ok[i] = idents[cu[i]].verify(env.payload, env.signature)
        c_ok = live & (cred | host_ok)
        codes[live & ~c_ok] = int(C.BAD_CREATOR_SIGNATURE)

        # -- the signature batch: creators, then endorsers, as column gathers
        m = pb.n_endorsements
        tx_of_e = np.repeat(np.arange(n), pb.endo_count)
        eu = pb.e_uid[:m].astype(np.int64)
        eu_valid = eu >= 0
        euc = np.where(eu_valid, eu, n_ids)
        mask_e = (c_ok[tx_of_e] & (pb.e_ok[:m] == 1) & (pb.e_dup[:m] == 0) & eu_valid
                  & known[euc] & has_ec[euc])
        c_rows, e_rows = np.flatnonzero(live & cred), np.flatnonzero(mask_e)
        nc, ne = len(c_rows), len(e_rows)
        items = p256v3.SigColumns(
            np.concatenate([pb.payload_digest[c_rows], pb.e_digest[e_rows]]),
            np.concatenate([pb.creator_r[c_rows], pb.e_r[e_rows]]),
            np.concatenate([pb.creator_s[c_rows], pb.e_s[e_rows]]),
            np.concatenate([cu[c_rows], eu[e_rows]]).astype(np.int32), q_pool, q_ok, idents)
        creator_item = np.full(n, -1, np.int64)
        creator_item[c_rows] = np.arange(nc)
        # each column row's endorsers in slots 0..ecnt-1 (validator.py:880-894)
        e_tx = tx_of_e[e_rows]
        ecnt = np.bincount(e_tx, minlength=n)
        S = max(4, next_pow2(int(ecnt.max()) if ne else 1))
        uid_mat = np.zeros((n, S), np.int64)
        endo_idx_mat = np.full((n, S), -1, np.int32)
        if ne:
            slot = np.arange(ne) - (np.cumsum(ecnt) - ecnt)[e_tx]
            uid_mat[e_tx, slot] = eu[e_rows] + 1
            endo_idx_mat[e_tx, slot] = nc + np.arange(ne)
        code_l, ci_l, hv_l = codes.tolist(), creator_item.tolist(), host_ok.tolist()
        for i in np.flatnonzero(col).tolist():
            txs[i] = ParsedTx(idx=i, code=code_l[i], txid=txids[i], creator_item_idx=ci_l[i],
                              host_creator_ok=hv_l[i])
        base = len(items)
        for i in front_idx:  # the front end's items follow the columns
            ptx = txs[i]
            if ptx.creator_item_idx >= 0:
                ptx.creator_item_idx += base
            ptx.endo_item_idx = [j + base for j in ptx.endo_item_idx]
        items.extra = front_items

        # -- read/write sets: one C call over the sets the front end would
        # decode (duplicates included) and the sets of the live front-end
        # rows the walk reached (it stops at an odd endorsement, such as
        # an idemix endorser's); the rest parse in Python
        front_live = np.zeros(n, bool)
        for i in front_idx:
            ptx = txs[i]
            front_live[i] = ptx.undetermined and not ptx.is_config and ptx._rwset is not None
        front_live &= pb.results_span[:, 0] >= 0
        rw_use = (col & bind & (cred | host_ok)) | front_live
        rwp = mvccprep.prep(pb, rw_use)
        ns_names, _, keys, lex_rank = rwp.key_table()
        st = rwp.status.tolist()
        flat = rw_use & (rwp.status == 0)
        ns_start, ns_count = rwp.tx_ns_start.tolist(), rwp.tx_ns_count.tolist()
        ns_flat = rwp.ns_ids_flat.tolist()
        res_span = pb.results_span.tolist()
        ns_memo: dict = {}
        n_parsed = 0
        for i in np.flatnonzero(rw_use).tolist():
            ptx = txs[i]
            o, ln = res_span[i]
            raw = blob[o:o + ln] if o >= 0 else b""
            if st[i] == 0:
                ptx.rwset_bytes = raw
                ids = tuple(ns_flat[ns_start[i]:ns_start[i] + ns_count[i]])
                names = ns_memo.get(ids)
                if names is None:
                    names = ns_memo[ids] = tuple(sorted(ns_names[j] for j in ids))
                ptx.namespaces = names
                continue
            if front_live[i]:
                continue  # the front end parsed it
            n_parsed += 1
            try:
                rw = TxRWSet.from_bytes(raw)
            except DecodeError:
                if ptx.undetermined:
                    ptx.code = int(C.BAD_RWSET)
                continue
            ptx.rwset = rw
            ptx.namespaces = tuple(sorted(rw.ns))
        # a flat front-end row joins the endorser matrices (each endorser
        # is an identity the walk interned), so the block keeps the
        # columnar groups; a row whose endorser is not found stays off
        # them, and the block takes the entry-by-entry builder
        front_flat = [i for i in front_idx if flat[i]]
        if front_flat:
            uid_of = {id(x): u for u, x in enumerate(idents) if x is not None}
            need = max(4, next_pow2(max(len(txs[i].endorsers) for i in front_flat) or 1))
            if need > S:
                uid_mat = np.pad(uid_mat, ((0, 0), (0, need - S)))
                endo_idx_mat = np.pad(endo_idx_mat, ((0, 0), (0, need - S)), constant_values=-1)
            for i in front_flat:
                ptx = txs[i]
                uids = [uid_of.get(id(x)) for x in ptx.endorsers]
                if None in uids:
                    flat[i] = False
                    continue
                k = len(uids)
                uid_mat[i, :k] = np.asarray(uids, np.int64) + 1
                endo_idx_mat[i, :k] = ptx.endo_item_idx
                ecnt[i] = k
        wb = WireBlock(number=number, pb=pb, rwp=rwp, flat=flat, keys=keys, lex_rank=lex_rank,
                       ns_names=ns_names, idents=idents, uid_mat=uid_mat,
                       endo_idx_mat=endo_idx_mat, ecnt=ecnt, n_front_end=len(front_idx),
                       n_rwset_parsed=n_parsed)
        return wb, txs, items

    @staticmethod
    def _materialize_for_host(txs, wb: WireBlock) -> None:
        """Fill the column rows' ``endorsers`` and ``endo_item_idx`` from
        the block's matrices (validator.py:959-978), before any reader
        of those lists; a second call does nothing."""
        if wb.materialized:
            return
        ecnt, em, um, idents = wb.ecnt.tolist(), wb.endo_idx_mat, wb.uid_mat, wb.idents
        for i in np.flatnonzero(wb.ecnt).tolist():
            k = ecnt[i]
            ptx = txs[i]
            ptx.endo_item_idx = em[i, :k].tolist()
            ptx.endorsers = [idents[u - 1] for u in um[i, :k].tolist()]
        wb.materialized = True

    def _device_pre(self, txs, block) -> DevicePre | None:
        """The block's state-independent stage-2 inputs: the columnar
        groups for a wire block whose every live transaction is a flat
        column row, else ``_device_preprocess``; None (the host path)
        when a live transaction writes key metadata or reaches a custom
        plugin (:1813-1827, :1976-1980)."""
        if self._needs_host(txs):
            return None
        if isinstance(block, WireBlock):
            dpre = self._device_pre_columnar(txs, block)
            if dpre is not None:
                return dpre
        return self._device_preprocess(txs, block)

    def _needs_host(self, txs) -> bool:
        if type(self.plugins.get("default")) is not DefaultValidation:
            return True
        custom: dict = {}  # namespaces tuple → a custom plugin among them
        for ptx in txs:
            if not ptx.undetermined or ptx.is_config:
                continue
            if _has_meta_writes(ptx._rwset):
                return True
            c = custom.get(ptx.namespaces)
            if c is None:
                c = custom[ptx.namespaces] = any(
                    _custom(self.policies.info(ns)) for ns in ptx.namespaces)
            if c:
                return True
        return False

    def _device_preprocess(self, txs, block=None) -> DevicePre:
        """Policy groups entry by entry from the per-tx lists (a wire
        block's are filled first), then the static MVCC arrays."""
        if isinstance(block, WireBlock):
            self._materialize_for_host(txs, block)
        entries = []
        for ptx in txs:
            if not ptx.undetermined or ptx.is_config:
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
            groups.append((plan, gp, E, S))
            group_entries.append(ents)
        return self._static_pre(txs, block, groups, group_entries)

    def _device_pre_columnar(self, txs, wb: WireBlock) -> DevicePre | None:
        """The policy groups from the columnar arrays (validator.py:
        1926-2039): entries from ``rwp``'s flat (tx, namespace) pairs,
        each namespace's info looked up once, INVALID_CHAINCODE by array
        masks, each group's gp array gathered from a per-identity
        match-row pool through ``uid_mat`` and ``endo_idx_mat``; the
        same layout, entry order and group order as
        ``_device_preprocess``.  None when a live
        transaction is not flat (a set parsed in Python, a front-end
        envelope the walk did not reach the set of)."""
        n = len(txs)
        live = np.fromiter((ptx.code == _NV and not ptx.is_config for ptx in txs), bool, n)
        if (live & ~wb.flat).any():
            return None
        rwp, names = wb.rwp, wb.ns_names
        etx, ens = rwp.tx_ns(live)
        infos = [self.policies.info(nm) for nm in names]
        unknown = np.array([i is None for i in infos], bool)
        bad = live & (np.bincount(etx, minlength=n) == 0)  # no namespace
        bad[etx[unknown[ens]]] = True  # an unknown one
        for i in np.flatnonzero(bad).tolist():
            txs[i].code = int(C.INVALID_CHAINCODE)
        keep = ~bad[etx]
        etx, ens = etx[keep], ens[keep]
        # entries in tx order, each tx's namespaces by name; groups in
        # the order their policy first appears
        rank = np.empty(len(names), np.int64)
        rank[sorted(range(len(names)), key=names.__getitem__)] = np.arange(len(names))
        order = np.lexsort((rank[ens], etx))
        etx, ens = etx[order], ens[order]
        group_of: dict = {}  # id(policy) → group
        ns_group = np.array([group_of.setdefault(id(i.policy), len(group_of))
                             if i is not None else -1 for i in infos], np.int64)
        policy_of = {group_of[id(i.policy)]: i.policy for i in infos if i is not None}
        eg = ns_group[ens]
        ecnt, um, em, idents = wb.ecnt, wb.uid_mat, wb.endo_idx_mat, wb.idents
        groups, group_entries = [], []
        for g in dict.fromkeys(eg.tolist()):
            gtx = etx[eg == g]
            plan = self._plan(policy_of[g])
            P = len(plan.principals)
            E = len(gtx)
            S = max(4, next_pow2(max(int(ecnt[gtx].max()), 1)))
            uids = um[gtx, :S]
            row_pool = np.zeros((len(idents) + 1, P), np.int32)
            for u in np.unique(uids[uids > 0]).tolist():
                row_pool[u] = [p.matched_by(idents[u - 1]) for p in plan.principals]
            Eb = max(16, next_pow2(E))
            gp = np.zeros((Eb, S * P + S + 1), np.int32)
            gp[:, S * P:] = -1
            gp[:E, :S * P] = row_pool[uids].reshape(E, S * P)
            gp[:E, S * P:S * P + S] = em[gtx, :S]
            gp[:E, -1] = gtx
            groups.append((plan, gp, Eb, S))
            group_entries.append(gtx)
        return self._static_pre(txs, wb, groups, group_entries)

    def _static_pre(self, txs, block, groups, group_entries) -> DevicePre:
        """The static MVCC arrays (from the flat arrays when every live
        set is there) and the H2D copies: the groups' host frames
        ([(plan, gp array, Eb, S)]) in one buffer, one copy, each group's
        tensor a view of it → ``DevicePre``."""
        host_frames = (np.concatenate([g[1].reshape(-1) for g in groups]) if groups
                       else np.zeros(0, np.int32))
        # prefetch-thread upload: the ledger's stage2_prefetch h2d lane
        _ledger.note_h2d("stage2_prefetch", host_frames.nbytes)
        frames = torch.from_numpy(host_frames).to(self.device)
        off, dev_groups = 0, []
        for plan, gp, Eb, S in groups:
            dev_groups.append((plan, frames[off:off + gp.size].view(gp.shape), Eb, S))
            off += gp.size
        und = np.fromiter((ptx.undetermined and not ptx.is_config for ptx in txs), bool,
                          len(txs))
        has_range = has_pvt = False
        if isinstance(block, WireBlock) and not (und & ~block.flat).any():
            # every live set is in the flat arrays: no range query
            static = mvcc_ops.prepare_block_from_flat(block.rwp, und, block.lex_rank,
                                                      block.keys,
                                                      unique=self.resident is not None)
        else:
            mvcc_txs = []
            for ptx in txs:
                if ptx.rwset is None or not ptx.undetermined:
                    mvcc_txs.append(mvcc_ops.TxRWSet(reads=[], writes=[], range_reads=[]))
                    continue
                if any(n.range_queries for n in ptx.rwset.ns.values()):
                    has_range = True
                has_pvt |= any(n.hashed for n in ptx.rwset.ns.values())
                reads, writes, rqs = ptx.rwset.mvcc_form()
                mvcc_txs.append(mvcc_ops.TxRWSet(reads=reads, writes=writes,
                                                 range_reads=rqs))
            static = mvcc_ops.prepare_block_static(mvcc_txs, bucketed=True,
                                                   unique=self.resident is not None)
        static_t = torch.from_numpy(static.packed_static()).to(self.device)
        read_pv = None
        if static.u_pairs is not None:
            read_pv = torch.from_numpy(static.packed_read_pv()).to(self.device)
        return DevicePre(groups=dev_groups, group_entries=group_entries, static=static,
                         static_t=static_t, has_range=has_range, read_pv=read_pv,
                         has_pvt=has_pvt, frames=frames)

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

    def _parse_any(self, block):
        """A wire ``Block`` through the columnar parse, anything else
        through ``decode`` and ``_parse`` → (block, txs, items)."""
        if isinstance(block, Block):
            return self._parse_wire(block)
        block = self.decode(block)
        return (block, *self._parse(block))

    def preprocess(self, block) -> Preprocessed:
        """Decode, parse, launch the block's signature verify without
        waiting, and build the state-independent stage-2 inputs.  Touches
        no ledger state, so it may run while the predecessor commits."""
        self._apply_pending_knobs()
        t0 = time.perf_counter()
        wire = block
        block, txs, items = self._parse_any(block)
        t0 = self._t("host_parse", t0)
        handle = self.verify_launch(items)
        t0 = self._t("sig_prepare_launch", t0)
        # the fused stage 2 reads v3's verdicts on this device; under v1,
        # v2 or a remote verify (kernel None) the block takes the host path
        dpre = None
        if self.kernel == "v3":
            dpre = self._device_pre(txs, block)
            self._t("device_pre", t0)
        return self._staged(wire, block, txs, items, handle, dpre)

    def _staged(self, wire, block, txs, items, handle, dpre) -> Preprocessed:
        """The ``Preprocessed`` of a block, with the serialized header
        and data of a wire block when a ledger's ``BlockStore`` is
        attached (the reference's :1258, which builds it for every
        block: the ledger commit splices the metadata on, off the
        committer's time)."""
        hd_bytes = None
        if not isinstance(wire, Block):
            wire = None
        elif isinstance(self.blocks, BlockStore):
            t0 = time.perf_counter()
            hd_bytes = protoutil.block_header_data_bytes(wire)
            self._t("hd_frame", t0)
        return Preprocessed(block=block, txs=txs, items=items, handle=handle, dpre=dpre,
                            msp=self.msp, policies=self.policies, wire=wire,
                            hd_bytes=hd_bytes)

    def preprocess_many(self, blocks) -> list:
        """``preprocess`` over several blocks with ONE verify launch for
        all their signatures (``verify_launch_many``; each handle a slice
        with a solo launch's lane layout), so each result is a drop-in
        ``pre`` for ``validate_launch``.  With a staging pool the blocks
        parse at once (``_preprocess_many_pooled``)."""
        blocks = list(blocks)
        self._apply_pending_knobs()
        if len(blocks) <= 1:
            return [self.preprocess(b) for b in blocks]
        if self.host_pool is not None:
            return self._preprocess_many_pooled(blocks)
        parsed = []
        for block in blocks:
            t0 = time.perf_counter()
            parsed.append(self._parse_any(block))
            self._t("host_parse", t0)
        t0 = time.perf_counter()
        handles = self.verify_launch_many([items for _, _, items in parsed])
        self._t("sig_prepare_launch", t0)
        out = []
        for wire, (block, txs, items), handle in zip(blocks, parsed, handles):
            dpre = None
            if self.kernel == "v3":
                t0 = time.perf_counter()
                dpre = self._device_pre(txs, block)
                self._t("device_pre", t0)
            out.append(self._staged(wire, block, txs, items, handle, dpre))
        return out

    def _preprocess_many_pooled(self, blocks) -> list:
        """``preprocess_many`` on the staging pool: every block's parse
        at once, each block's ``_device_pre`` submitted as soon as its
        parse lands, then the one verify launch.  Every task touches only its own block (the
        shared memos, ``_plans`` and the MSP's identity caches, can at
        worst compute an entry twice), so the result is the serial one.
        The timers record the calling thread's wait for each stage, its
        critical path; a failed task raises here, labelled with its
        stage and worker."""
        pool = self.host_pool
        stream = (torch.cuda.current_stream(self.device) if self.device.type == "cuda"
                  else None)
        t0 = time.perf_counter()
        parse_futs = [pool.submit(self._parse_any, b, stage="host_parse") for b in blocks]
        parsed, pre_futs = [], []
        for f in parse_futs:
            block, txs, items = f.result()
            parsed.append((block, txs, items))
            if self.kernel == "v3":
                pre_futs.append(pool.submit(self._device_pre_on, stream, txs, block,
                                            stage="device_pre"))
        self._t("host_parse", t0)
        t0 = time.perf_counter()
        handles = self.verify_launch_many([items for _, _, items in parsed])
        self._t("sig_prepare_launch", t0)
        out = []
        for k, ((block, txs, items), handle) in enumerate(zip(parsed, handles)):
            dpre = None
            if pre_futs:
                t0 = time.perf_counter()
                dpre = pre_futs[k].result()
                self._t("device_pre", t0)
            out.append(self._staged(blocks[k], block, txs, items, handle, dpre))
        return out

    def _device_pre_on(self, stream, txs, block) -> DevicePre:
        """``_device_pre`` in a pool worker, its H2D copies on ``stream``
        (the stream of the thread that submitted it), so a stage-2 launch
        ordered after that thread's work reads them whole."""
        if stream is None:
            return self._device_pre(txs, block)
        with torch.cuda.stream(stream):
            return self._device_pre(txs, block)

    def verify_launch(self, items):
        """Launch the block's signature verify without waiting, through
        ``device_guard`` when there is one (the reference's
        ``_verify_launch_guarded``)."""
        return self._guarded(lambda: self._launch_one(items), [items], many=False)

    def _launch_one(self, items):
        return p256.verify_launch(items, kernel=self.kernel, device=self.device,
                                  chunk=self.verify_chunk or None, pool=self.host_pool)

    def verify_launch_many(self, itemsets) -> list:
        """Several blocks' signatures in one launch (v3; one launch a
        block under v1 and v2) → one handle a block; through the guard,
        one attempt covers the group and a fallback verifies each
        block's batch (each counted)."""
        itemsets = list(itemsets)
        return self._guarded(
            lambda: p256.verify_launch_many(itemsets, kernel=self.kernel, device=self.device,
                                            chunk=self.verify_chunk or None,
                                            pool=self.host_pool),
            itemsets, many=True)

    def _guarded(self, launch, itemsets: list, many: bool):
        """``launch()`` on the lane, or its fallback, under
        ``device_guard`` (None: the bare launch) → a handle, or one a
        batch when ``many``."""
        guard = self.device_guard
        if guard is None:
            return launch()
        if many:
            fallback = lambda: [self._host_verify_fallback(it) for it in itemsets]
        else:
            fallback = lambda: self._host_verify_fallback(itemsets[0])
        out = guard.run_launch(launch, fallback, fallback_count=len(itemsets))
        handles = out if many else [out]
        wrapped = [h if isinstance(h, _SyncedHandle) else _GuardedHandle(h, guard, self, it)
                   for h, it in zip(handles, itemsets)]
        return wrapped if many else wrapped[0]

    def _host_verify_fallback(self, items) -> _SyncedHandle:
        """A block's signatures off the failed lane (the reference's
        name): the verify kernel on this validator's device, launched
        and synced at once under ``faults.shield()`` → a completed
        handle whose ``device_out`` the fused stage 2 reads.  A failure
        raises: the block fails closed, and nothing is verified on the
        host."""
        with faults.shield():
            h = self._launch_one(items)
            return _SyncedHandle(h.device_out, h.n_real, [bool(v) for v in h.fetch()])

    # -- launch -------------------------------------------------------------

    def validate(self, block):
        return self.validate_finish(self.validate_launch(block))

    def validate_launch(self, block, pre: Preprocessed | None = None,
                        overlay=None, extra_txids=None) -> PendingBlock:
        """Everything up to the stage-2 dispatch.  ``overlay``: the
        merged UpdateBatch of in-flight predecessors whose commits may not
        have landed (its entries override committed-state reads);
        ``extra_txids``: their txids, for the duplicate check.

        A caller commits a config block, or one that writes
        ``_lifecycle``, before launching its successor with no overlay
        (``peer/pipeline.py``'s barrier); an overlay that writes
        ``_lifecycle`` raises.  A ``pre`` staged under an MSP manager or
        policy provider that has since rotated is redone here."""
        if overlay is not None and overlay.touches_namespace(LIFECYCLE_NS):
            raise ValueError("pipelined launch across a lifecycle-writing block: "
                             "commit the predecessor before launching this block")
        if pre is None or pre.msp is not self.msp or (
                pre.dpre is not None and pre.policies is not self.policies):
            pre = self.preprocess(block)
        txs = pre.txs
        self.last_parsed = txs
        if self.blocks is not None or extra_txids:
            for ptx in txs:
                if ptx.undetermined and not ptx.is_config and (
                        (extra_txids is not None and ptx.txid in extra_txids)
                        or (self.blocks is not None and self.blocks.tx_exists(ptx.txid))):
                    ptx.code = int(C.DUPLICATE_TXID)
        pending = PendingBlock(block=pre.block, txs=txs, items=pre.items, handle=pre.handle,
                               dpre=pre.dpre, overlay=overlay, wire=pre.wire,
                               hd_bytes=pre.hd_bytes)
        if txs and pre.dpre is not None and not self._sbe_launch_veto(pending):
            if self.device_guard is None:
                self._dispatch_stage2(pending)
            else:
                self.device_guard.retry(lambda: self._dispatch_stage2(pending),
                                        "stage-2 dispatch")
        return pending

    def _dispatch_stage2(self, pending: PendingBlock) -> None:
        pending.fetch2, pending.range_phantom = self._launch_device(
            pending.txs, pending.handle, pending.dpre, pending.overlay)

    # -- key-level endorsement ------------------------------------------------

    def _sbe_launch_veto(self, pending: PendingBlock) -> bool:
        """A written key of the block carries key metadata in committed
        state or the overlay: the fused program has no key-level lanes,
        so the block takes the host path (:1452-1479).  Free while no
        key carries metadata."""
        overlay = pending.overlay
        if not self._metaful(overlay):
            return False
        block = pending.block
        flat = block.flat if isinstance(block, WireBlock) else np.zeros(len(pending.txs), bool)
        if flat.any():
            rwp = block.rwp
            for u in np.unique(rwp.w_uid[:rwp.n_writes]).tolist():
                _, ns, key = block.keys[u]
                if self._committed_key_has_meta(ns, key, overlay):
                    return True
        for ptx in pending.txs:
            if not ptx.undetermined or ptx.is_config or flat[ptx.idx] or ptx.rwset is None:
                continue
            for ns, n in ptx.rwset.ns.items():
                for k in n.writes:
                    if self._committed_key_has_meta(ns, k, overlay):
                        return True
        return False

    def _sbe_active(self, txs, overlay) -> bool:
        """Key-level endorsement applies to the block: a transaction
        writes key metadata, or writes a key that carries metadata
        (:1610-1639)."""
        metaful = self._metaful(overlay)
        for ptx in txs:
            rw = ptx._rwset  # a set still in bytes carries no metadata write
            if rw is None:
                if not metaful:
                    continue
                rw = ptx.rwset
                if rw is None:
                    continue
            for ns, n in rw.ns.items():
                if n.metadata_writes:
                    return True
                if metaful:
                    for k in n.writes:
                        if self._committed_key_has_meta(ns, k, overlay):
                            return True
        return False

    def _metaful(self, overlay) -> bool:
        """Any key metadata the block could see: committed, or in the
        in-flight predecessors' batches."""
        return getattr(self.state, "meta_count", 0) > 0 or (
            overlay is not None and overlay.has_meta)

    def _committed_key_has_meta(self, ns: str, key: str, overlay) -> bool:
        if overlay is not None:
            vv = overlay.updates.get((ns, key))
            if vv is not None:
                return bool(vv.value is not None and vv.metadata)
        vv = self.state.get_state(ns, key)
        return vv is not None and bool(vv.metadata)

    def _committed_key_policy(self, ns: str, key: str, overlay):
        """The committed ``VALIDATION_PARAMETER`` of (ns, key), the
        overlay overriding the state read; None without one."""
        vv = None
        if overlay is not None:
            vv = overlay.updates.get((ns, key))
        if vv is None:
            vv = self.state.get_state(ns, key)
        if vv is None or vv.value is None or not vv.metadata:
            return None
        return decode_metadata(vv.metadata).get(VALIDATION_PARAMETER)

    def _sbe_pass(self, txs, sig_valid, ns_verdicts, overlay) -> None:
        """Key-level endorsement in block order (:1675-1734): each
        written key (value or metadata) of a transaction is judged by
        the key policy in effect at its position — committed, or set by
        an earlier plugin-valid transaction of the block, even one MVCC
        later kills — and a key without one by its namespace's verdict;
        a namespace with no written key by its namespace's verdict."""
        pending: dict = {}     # (ns, key) → policy bytes | None (cleared)
        pol_cache: dict = {}   # policy bytes → (ast, plan) | None
        comm_cache: dict = {}  # (ns, key) → committed policy
        for ptx in txs:
            if not ptx.undetermined or ptx.is_config or ptx.rwset is None:
                continue
            tx_ok = True
            for ns in ptx.namespaces:
                n = ptx.rwset.ns.get(ns)
                if n is None:
                    continue
                keys = sorted(set(n.writes) | set(n.metadata_writes))
                if not keys:
                    tx_ok = ns_verdicts.get((ptx.idx, ns), False)
                else:
                    for k in keys:
                        if (ns, k) in pending:
                            pb = pending[(ns, k)]
                        elif (ns, k) in comm_cache:
                            pb = comm_cache[(ns, k)]
                        else:
                            pb = comm_cache[(ns, k)] = self._committed_key_policy(ns, k, overlay)
                        tx_ok = (ns_verdicts.get((ptx.idx, ns), False) if pb is None
                                 else self._eval_key_policy(pb, ptx, sig_valid, pol_cache))
                        if not tx_ok:
                            break
                if not tx_ok:
                    break
            if not tx_ok:
                ptx.code = int(C.ENDORSEMENT_POLICY_FAILURE)
                continue
            for ns, n in ptx.rwset.ns.items():
                for k, entries in n.metadata_writes.items():
                    pending[(ns, k)] = entries.get(VALIDATION_PARAMETER)

    def _eval_key_policy(self, policy_bytes, ptx, sig_valid, cache) -> bool:
        """One key policy over the transaction's sig-valid endorsers; a
        policy that does not parse fails closed."""
        got = cache.get(policy_bytes, False)
        if got is False:
            try:
                ast = policy_from_proto(pm.SignaturePolicyEnvelope.parse(policy_bytes))
                got = (ast, pol.compile_plan(ast))
            except NotImplementedError:
                raise
            except Exception:
                got = None
            cache[policy_bytes] = got
        if got is None or not ptx.endorsers:
            return False
        ast, plan = got
        valid = np.array([bool(sig_valid[i]) for i in ptx.endo_item_idx], bool)
        mat = pol.match_matrix(ptx.endorsers, plan.principals) & valid[:, None]
        return bool(pol.evaluate(ast, mat, plan))

    def _launch_device(self, txs, handle, dpre: DevicePre, overlay):
        t0 = time.perf_counter()
        # committed-range phantoms: the code is assigned at finish, after
        # the policy verdict; here the tx only leaves the writer set
        range_phantom = set()
        if dpre.has_range:
            for ptx in txs:
                if ptx.undetermined and not ptx.is_config and ptx.rwset is not None and (
                        self._committed_range_phantom(ptx, overlay)
                        or (overlay is not None and _overlay_range_phantom(ptx, overlay))):
                    range_phantom.add(ptx.idx)
        static = dpre.static
        T = int(static.read_keys.shape[0])
        launch_vec = np.zeros((T, 3), np.int32)
        launch_vec[:, 0] = -1
        for ptx in txs:
            if ptx.undetermined and not ptx.is_config:
                launch_vec[ptx.idx, 0] = ptx.creator_lane
                launch_vec[ptx.idx, 1] = ptx.idx not in range_phantom
        lv = self._resident_launch_vec(launch_vec, dpre, overlay)
        if lv is None:
            committed = self._committed_versions(static.read_key_set, overlay)
            launch_vec[:, 2] = static.host_ver_ok(committed)
            lv = torch.from_numpy(launch_vec).to(self.device)
        t0 = self._t("state_fill", t0)
        faults.fire("validator.stage2")
        fetch2 = self._stage2.run(handle, lv, dpre.groups, dpre.static_t, static.dims, T,
                                  dpre.frames)
        self._t("stage2_dispatch", t0)
        return fetch2, frozenset(range_phantom)

    # -- device-resident state ------------------------------------------------

    def _resident_launch_vec(self, launch_vec, dpre: DevicePre, overlay):
        """The launch vector on the device with its ver_ok column
        computed by ``resident_ver_ok`` against the resident table, or
        None when the block takes the host read (no resident state, a
        disabled cache, range queries, a working set larger than the
        table)."""
        res = self.resident
        if res is None or not res.enabled:
            return None
        static = dpre.static
        if static.u_pairs is None:
            res.route_host("hashed" if dpre.has_pvt and not dpre.has_range else "range")
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
        state; a failed scatter disables the cache."""
        if self.resident is not None:
            self.resident.apply_batch(batch)

    # -- finish ---------------------------------------------------------------

    def validate_finish(self, pending: PendingBlock):
        """The block's (filter, batch, history): from the fused stage 2,
        or from ``_validate_host``.  Under a guard, a block whose verify
        went over the lane without a fallback records the lane's success
        here, once."""
        result = self._finish_device(pending) if pending.fetch2 is not None else None
        if result is None:
            result = self._validate_host(pending)
        h = pending.handle
        if isinstance(h, _GuardedHandle) and not h.fell_back:
            self.device_guard.record_success()
        return result

    def _stage2_out(self, pending: PendingBlock) -> dict:
        """The block's stage-2 output.  Under a guard a failed sync
        counts toward the latch and the next attempt dispatches the
        stage 2 again on the card, within the guard's retries; then the
        error raises."""
        if self.device_guard is None:
            return pending.fetch2()

        def sync():
            if pending.fetch2 is None:
                self._dispatch_stage2(pending)
            fetch2, pending.fetch2 = pending.fetch2, None
            out = fetch2()
            pending.fetch2 = fetch2
            return out

        return self.device_guard.retry(sync, "stage-2 sync")

    def _finish_device(self, pending: PendingBlock):
        """Codes from the packed stage-2 output; None sends the block to
        the exact host path (a consumption-unsafe policy row)."""
        txs, dpre = pending.txs, pending.dpre
        t0 = time.perf_counter()
        out = self._stage2_out(pending)
        t0 = self._t("device_wait", t0)
        for safe_bits, ents in zip(out["safe"], dpre.group_entries):
            if not np.all(safe_bits[:len(ents)]):
                return None
        sig_valid = out["sig_valid"]
        n_sig = len(sig_valid)
        nT = len(txs)
        final = np.fromiter((ptx.code for ptx in txs), np.int32, nT)
        und = final == _NV
        cfg = np.fromiter((ptx.is_config for ptx in txs), bool, nT)
        ci = np.fromiter((ptx.creator_lane for ptx in txs), np.int64, nT)
        # a lane's verdict as stage 2 gathered it: -2 true, -1 false
        svF = np.concatenate([sig_valid, [False, True]])
        cok = svF[np.where((ci >= 0) & (ci < n_sig), ci, np.where(ci == -2, n_sig + 1, n_sig))]
        creator_fail = und & ~cok & ((ci != -1) | ~cfg)
        rp = np.zeros(nT, bool)
        rp[list(pending.range_phantom)] = True
        sel = np.select(
            [~out["policy_ok"][:nT], rp, out["valid"][:nT], out["phantom"][:nT]],
            [int(C.ENDORSEMENT_POLICY_FAILURE), int(C.PHANTOM_READ_CONFLICT),
             int(C.VALID), int(C.PHANTOM_READ_CONFLICT)],
            default=int(C.MVCC_READ_CONFLICT))
        upd = und & ~cfg & ~creator_fail
        final[upd] = sel[upd]
        final[creator_fail] = int(C.BAD_CREATOR_SIGNATURE)
        for i in np.flatnonzero(cfg & und & ~creator_fail).tolist():
            final[i] = self._validate_config(pending.block, txs[i])
        for ptx, c in zip(txs, final.tolist()):
            ptx.code = c
        batch, history = self._build_updates(pending.block, txs, pending.overlay)
        self._t("postprocess", t0)
        return bytes(final.tolist()), batch, history

    def _validate_host(self, pending: PendingBlock):
        """The exact path (:1516-1606): signature bits from the verify
        handle, config transactions, the plugin dispatch per (tx,
        namespace), the key-level endorsement pass, ``mvcc_validate``."""
        txs, overlay = pending.txs, pending.overlay
        if isinstance(pending.block, WireBlock):
            self._materialize_for_host(txs, pending.block)
        t0 = time.perf_counter()
        sig_valid = (np.asarray(pending.handle.fetch(), bool) if pending.items
                     else np.zeros(0, bool))
        self._t("device_wait", t0)
        # a host-verified creator (-2) passed when the block parsed; a
        # live endorser transaction always has a lane, so -1 fails closed
        for ptx in txs:
            lane = ptx.creator_lane
            if ptx.undetermined and (not sig_valid[lane] if lane >= 0
                                     else lane == -1 and not ptx.is_config):
                ptx.code = int(C.BAD_CREATOR_SIGNATURE)
        for ptx in txs:
            if ptx.is_config and ptx.undetermined:
                ptx.code = self._validate_config(pending.block, ptx)
        # each (tx, namespace) to its namespace's plugin; a tx is valid
        # only if every plugin approves it (dispatcher.go:190-217)
        ctx = BlockValidationCtx(txs=txs, sig_valid=sig_valid, msp_manager=self.msp,
                                 policy_provider=self.policies)
        by_plugin: dict = {}
        for ptx in txs:
            if not ptx.undetermined or ptx.is_config:
                continue
            infos = [self.policies.info(ns) for ns in ptx.namespaces]
            if not ptx.namespaces or any(i is None for i in infos):
                ptx.code = int(C.INVALID_CHAINCODE)
                continue
            for ns, info in zip(ptx.namespaces, infos):
                by_plugin.setdefault(info.plugin or "default", []).append((ptx, ns))
        # under key-level endorsement the namespace verdicts become the
        # per-key fallbacks of the SBE pass
        sbe = self._sbe_active(txs, overlay)
        ns_verdicts: dict | None = {} if sbe else None
        for name, group in by_plugin.items():
            plug = self.plugins.get(name)
            if plug is None:
                for ptx, _ in group:
                    ptx.code = int(C.INVALID_OTHER_REASON)
                continue
            if hasattr(plug, "validate_batch_group"):
                ok = plug.validate_batch_group(ctx, group)
            else:
                per_tx = plug.validate_batch(ctx)
                ok = [per_tx[ptx.idx] for ptx, _ in group]
            for (ptx, ns), good in zip(group, ok):
                if ns_verdicts is not None:
                    ns_verdicts[(ptx.idx, ns)] = bool(good)
                elif not good and ptx.undetermined:
                    ptx.code = int(C.ENDORSEMENT_POLICY_FAILURE)
        if sbe:
            self._sbe_pass(txs, sig_valid, ns_verdicts, overlay)
        mvcc_txs, committed = self._mvcc_inputs(txs, overlay)
        pre_ok = np.array([ptx.undetermined for ptx in txs], bool)
        if txs:
            valid, _, phantom = mvcc_ops.mvcc_validate_block(mvcc_txs, committed, pre_ok,
                                                             device=self.device)
            for ptx, v, ph in zip(txs, valid, phantom):
                if ptx.undetermined:
                    ptx.code = int(C.VALID if v else
                                   C.PHANTOM_READ_CONFLICT if ph else C.MVCC_READ_CONFLICT)
        batch, history = self._build_updates(pending.block, txs, overlay, sbe=sbe)
        return bytes(ptx.code for ptx in txs), batch, history

    def _validate_config(self, block, ptx) -> int:
        """A config transaction's code (:2454-2474): its payload must be
        a ConfigEnvelope (else BAD_PAYLOAD); the genesis block's is
        VALID; a later one is the ``config_processor``'s verdict
        (VALID without one)."""
        try:
            cfg_env = pm.ConfigEnvelope.parse(ptx.config_data)
        except DecodeError:
            return int(C.BAD_PAYLOAD)
        if block.number == 0 or self.config_processor is None:
            return int(C.VALID)
        return int(self.config_processor.validate_config_tx(ptx, cfg_env))

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
            # a metadata-only write writes iff it applies: the key
            # exists (:2371-2381)
            for ns, n in ptx.rwset.ns.items():
                for k in n.metadata_writes:
                    if k not in n.writes and self._key_exists(ns, k, overlay):
                        writes.append(("pub", ns, k))
            mvcc_txs.append(mvcc_ops.TxRWSet(reads=reads, writes=writes, range_reads=rqs))
            all_read_keys.update(k for k, _ in reads)
        return mvcc_txs, self._committed_versions(all_read_keys, overlay)

    def _key_exists(self, ns: str, key: str, overlay) -> bool:
        if overlay is not None:
            vv = overlay.updates.get((ns, key))
            if vv is not None:
                return vv.value is not None
        return self.state.get_state(ns, key) is not None

    def _committed_versions(self, keys, overlay=None) -> dict:
        """{mvcc key: Version} for the present keys — a hashed key
        ('pvt', ns, coll, hash) read at (``ns$coll#hashed``, hex(hash)),
        the in-flight predecessors' writes overriding the state read."""
        committed: dict = {}
        if not keys:
            return committed
        at = {k: (k[1], k[2]) if k[0] == "pub" else (f"{k[1]}${k[2]}#hashed", k[3].hex())
              for k in keys}
        vers = self.state.get_versions_bulk(list(at.values()))
        for k, sk in at.items():
            v = vers.get(sk)
            if v is not None:
                committed[k] = v
        if overlay is not None:
            for k, sk in at.items():
                vv = overlay.updates.get(sk)
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

    def _build_updates(self, block, txs, overlay=None, sbe: bool = False):
        """Update batch + history for the VALID transactions, in tx
        order, namespaces and keys sorted; version (block, tx index).
        A wire block's set in the flat arrays is read from them
        (``_build_updates_flat``, validator.py:2292); any other from its
        parsed ``rwset``, its hashed writes into ``ns$coll#hashed``.
        With ``sbe`` every set is read parsed (:2476-2543): a metadata
        write commits with the value written beside it, or alone
        re-puts the key's value with a new version (nothing on an
        absent key, and no history entry); a plain write keeps the
        key's metadata, a delete clears it."""
        batch = UpdateBatch()
        history = []
        block_num = block.number
        valid = np.fromiter((ptx.code == int(C.VALID) for ptx in txs), bool, len(txs))
        flat = np.zeros(len(txs), bool)
        if isinstance(block, WireBlock) and not sbe:
            flat = valid & block.flat
            rwp, blob, keys = block.rwp, block.pb.blob, block.keys
            _, rows, wc = rwp.tx_rows("w", flat, block.lex_rank)
            ends = np.cumsum(wc).tolist()
            w_uid, w_del = rwp.w_uid[rows].tolist(), rwp.w_is_del[rows].tolist()
            w_val = rwp.w_val_span[rows].tolist()
        flat_l = flat.tolist()

        def prev(ns, key):
            vv = batch.updates.get((ns, key))
            if vv is None and overlay is not None:
                vv = overlay.updates.get((ns, key))
            return vv if vv is not None else self.state.get_state(ns, key)

        for ptx in txs:
            if ptx.code != int(C.VALID):
                continue
            i = ptx.idx
            ver = (block_num, i)
            if flat_l[i]:
                for j in range(ends[i] - int(wc[i]), ends[i]):
                    _, ns_name, key = keys[w_uid[j]]
                    vo, vl = w_val[j]
                    if w_del[j]:
                        batch.delete(ns_name, key, ver)
                    else:
                        batch.put(ns_name, key, blob[vo:vo + vl] if vo >= 0 else b"", ver)
                    history.append((ns_name, key, i))
                continue
            if ptx.rwset is None:
                continue
            for ns_name in sorted(ptx.rwset.ns):
                n = ptx.rwset.ns[ns_name]
                mws = n.metadata_writes if sbe else {}
                for key in sorted(n.writes):
                    val = n.writes[key]
                    if val is None:
                        batch.delete(ns_name, key, ver)
                    elif not sbe:
                        batch.put(ns_name, key, val, ver)
                    else:
                        if key in mws:
                            md = encode_metadata(mws[key])
                        else:
                            pv = prev(ns_name, key)
                            md = pv.metadata if pv is not None and pv.value is not None else None
                        batch.put(ns_name, key, val, ver, metadata=md)
                    history.append((ns_name, key, i))
                for key in sorted(mws):
                    if key in n.writes:
                        continue
                    pv = prev(ns_name, key)
                    if pv is None or pv.value is None:
                        continue
                    batch.put(ns_name, key, pv.value, ver, metadata=encode_metadata(mws[key]))
                for coll in sorted(n.hashed):
                    hns = f"{ns_name}${coll}#hashed"
                    for kh, (vh, is_del) in sorted(n.hashed[coll].get("writes", {}).items()):
                        if is_del:
                            batch.delete(hns, kh.hex(), ver)
                        else:
                            batch.put(hns, kh.hex(), vh, ver)
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
