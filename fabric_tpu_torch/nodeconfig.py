"""Typed node configuration with defaults, validation and env-var
overrides (counterpart: ``fabric_tpu/nodeconfig.py``).

The schema is the reference's, field for field and default for
default: unknown keys are errors that name the key (with a
did-you-mean), type mismatches name the key and both types, and every
scalar knob can be overridden by a ``FABTPU_<KEY>`` environment
variable (``FABTPU_TLS_<KEY>`` for the tls section).  The on-disk
format is JSON.

The port adds one key: ``PeerConfig.device`` (default ``"cuda"``,
``FABTPU_DEVICE``), the device the peer's kernels run on; a peer asks
for ``"cpu"`` to run the plain versions.  It stands where the
reference's processes read ``JAX_PLATFORMS``.  Keys whose module the
port has not ported yet (``slos``, ``autopilot*``, ``vitals_*``,
``blackbox_dir``, ``mesh_*``, ``verify_chunk``, ``recode_device``,
``verify_deadline_ms``, ``sidecar_listen`` and its queue knobs,
``host_stage_mode="process"``) raise ``ConfigError`` naming their
ROADMAP item when set to anything but their default; every other
``ConfigError`` has the reference's text.
"""

from __future__ import annotations

import dataclasses
import difflib
import json
import os
from dataclasses import dataclass, field


class ConfigError(ValueError):
    """A configuration problem, phrased so the operator can fix it."""


#: install-store admission cap (peer/node.py _on_install; the
#: reference's MaxRecvMsgSize is 100MB — ccaas packages are a few KB
#: of tar, 16MB is generous).  Defined here so PeerConfig and direct
#: PeerNode constructions share ONE default.
DEFAULT_MAX_PACKAGE_SIZE = 16 * 1024 * 1024


# -- leaf sections ----------------------------------------------------------


@dataclass
class TlsConfig:
    """Node mTLS material (cryptogen's nodes/<name>/tls layout)."""

    cert: str = ""
    key: str = ""
    ca: str = ""


@dataclass
class ChannelRef:
    name: str = ""
    genesis: str = ""            # path to the genesis block
    snapshot_dir: str = ""       # join-from-snapshot directory
    # local catch-up replay source (peer/replay.py): a block-store
    # directory holding the chain (a serving peer's copied store, an
    # anti-entropy mirror, this peer's own pre-wipe store).  On start
    # the channel replays it at full pipeline depth — resuming from
    # the committed height — BEFORE the deliver loop attaches.
    # Composes with snapshot_dir: snapshot bootstraps state at H,
    # replay validates H+1.. from the store.
    replay_from: str = ""
    orderers: list = field(default_factory=list)  # [[host, port], ...]
    anti_entropy: bool = False   # background gossip catch-up pulls


@dataclass
class ChaincodeRef:
    """Statically registered ccaas endpoint (the lifecycle install
    flow resolves chaincodes dynamically; this is the operator
    shortcut)."""

    name: str = ""
    host: str = "127.0.0.1"
    port: int = 0


@dataclass
class PeerRef:
    msp_id: str = ""
    host: str = "127.0.0.1"
    port: int = 0


# -- node configs -----------------------------------------------------------


@dataclass
class PeerConfig:
    """The peer's knob surface (core/peer/config.go analog)."""

    id: str = ""
    data_dir: str = ""
    msp_id: str = ""
    msp_dir: str = ""
    host: str = "127.0.0.1"
    port: int = 0
    operations_port: int | None = None
    org_msps: list = field(default_factory=list)      # org MSP dirs
    chaincodes: list = field(default_factory=list)    # [ChaincodeRef]
    peers: list = field(default_factory=list)         # [PeerRef]
    channels: list = field(default_factory=list)      # [ChannelRef]
    tls: TlsConfig | None = None
    # ledger/commit knobs
    group_commit: int = 8            # blockstore fsync window (blocks)
    # async group-commit storage engine (ledger/committer.py): block
    # append stays synchronous (the durability boundary), state-DB
    # apply trails on a dedicated applier thread behind a pending-batch
    # read overlay — verdicts stay bit-equal to the serial engine.
    # False = serial fallback (state applied before commit_block
    # returns, the pre-PR-17 critical path).
    async_commit: bool = True
    # apply-queue bound in BLOCKS: commit_block backpressures at the
    # block boundary once this many batches trail, so apply lag (and
    # crash-recovery replay) stays bounded
    apply_queue_blocks: int = 4
    transient_retention: int = 100   # transient-store purge horizon
    deliver_censorship_check_s: float = 2.0
    # commit pipeline (peer/pipeline.py CommitPipeline): depth 2 =
    # deliver prefetch + committer-thread overlap with the predecessor
    # batch as a launch overlay; N >= 3 = deep window (block n on
    # device while n-1 commits and n-2 fsyncs — up to N-1 in-flight
    # predecessors, their batches MERGED into the launch overlay, the
    # dup-txid window widened to all of them, and mid-window fsyncs
    # deferred to the blockstore's group commit); 1 = strict serial
    # launch→finish→commit per block (the correctness oracle).  Depth
    # 3+ needs a real accelerator to win — the default stays 2 so
    # CPU-only hosts keep the exact classic path.
    pipeline_depth: int = 2
    # signature-verify microbatch: signatures per device chunk with
    # double-buffered dispatch (ops/p256v3.py); 0 = one monolithic
    # launch per block
    verify_chunk: int = 0
    # device-mesh sharding of the production dispatch (parallel/mesh):
    # verify batches and the fused stage-2 lanes shard axis 0 over the
    # first N local devices; -1 = all local devices (the multi-chip
    # default: sharding engages whenever n_devices > 1), 0 = off.
    # A 1-device resolution is a no-op, so CPU-only hosts pay nothing.
    mesh_devices: int = 0
    # declarative mesh topology (parallel/topology.py): "" = off (the
    # bare mesh_devices count above rules), "8" = 1-D data mesh over 8
    # devices, "2x4" = data x replica grid.  When the shape doesn't fit
    # the visible device count the node degrades to the local auto mesh
    # with a warning rather than refusing to start.
    mesh_shape: str = ""
    # span the mesh across distributed processes (pod slices):
    # every participating process runs the same config with its own
    # mesh_process_id; requires mesh_coordinator on all of them.  A
    # failed coordinator handshake degrades to the local mesh.
    mesh_distributed: bool = False
    # coordinator "host:port" of the distributed rendezvous (process 0
    # listens there); required when mesh_distributed is on
    mesh_coordinator: str = ""
    # this process's rank in the distributed mesh, in [0, n_processes)
    mesh_process_id: int = 0
    # total process count in the distributed mesh
    mesh_num_processes: int = 1
    # multi-block launch coalescing (CommitPipeline.submit_many): when
    # the deliver backlog holds ≥ 2 blocks, concatenate up to N blocks'
    # signature batches into one padded verify dispatch.  0/1 = off.
    # Like verify_chunk, wins need a real accelerator.
    coalesce_blocks: int = 0
    # host staging pool (parallel/hostpool.py): shard the per-block
    # HOST pipeline — envelope parse fan-out, per-signature admission +
    # Montgomery batch inversion + residue dgemm, device-path
    # preprocessing — across N worker threads per validator.  0 = off
    # (serial staging), -1 = one worker per core, n = n workers.
    # Bit-equal to serial staging; enable on multi-core hosts whose
    # sharded device outruns its single-threaded feeder.
    host_stage_workers: int = 0
    # host staging pool flavor: "thread" (default — the staging hot
    # loops are numpy/hashlib/native-C and release the GIL) or
    # "process" for Python-bound CUSTOM staging workloads on a
    # directly-constructed HostStagePool.  The validator's built-in
    # staging is shared-memory (in-place slab writes) and always runs
    # on threads — it coerces "process" back with a warning.
    host_stage_mode: str = "thread"
    # window recoding location (ops/p256v3.py): ship u1/u2 as 16-bit
    # scalar limbs and derive the 4-bit window digits ON DEVICE, so
    # the packed verify H2D frame shrinks (window planes 4×, whole
    # frame ~1.4×).  Default False = host recoding (the native
    # ec_prepare path computes windows for free; CPU-only hosts have
    # no H2D frame worth shrinking).  Bit-equal either way.
    recode_device: bool = False
    # block-commit span tracer (fabric_tpu_torch/observe): flight-recorder
    # ring holding the span trees of the last N committed blocks,
    # served at /trace on the operations server and exportable as
    # Chrome trace JSON (Perfetto).  Always-on and cheap (perf_counter
    # pairs + one ring append per block); 0 disables tracing entirely
    # (overhead measurement / paranoia).
    trace_ring_blocks: int = 32
    # slow-block watchdog: WARN with the full span breakdown when a
    # block's submit→commit time exceeds this multiple of the trailing
    # median (armed after 8 committed blocks); 0 disables the watchdog
    # while keeping the flight recorder.
    trace_slow_factor: float = 5.0
    # declarative latency/error SLOs (fabric_tpu/observe/slo.py):
    # faults-style spec string, e.g.
    # 'commit:latency:ms=250;busy:busy:pct=5' — per-channel rolling
    # burn rates over the tracer's finished-block stream, served at
    # /slo on the operations server with slo_burn_rate{slo,window,
    # channel} gauges and a fast-burn WARN.  Empty = no objectives.
    # The engine rides the tracer, so trace_ring_blocks=0 silences
    # SLOs too.  FABTPU_SLOS overrides like any scalar.
    slos: str = ""
    # flight-data recorder (fabric_tpu/observe/timeseries.py +
    # blackbox.py): with vitals_interval_s > 0, a daemon sampler walks
    # the metrics registry every interval and keeps per-metric bounded
    # rings of (t, value) points — delta-aware for counters and
    # histograms — served at /vitals on the operations server and
    # frozen into black-box incident bundles when an incident edge
    # fires (degrade latch, autopilot shed, SLO fast burn, pipeline
    # fail-closed, injected crash).  0 = recorder OFF (the default):
    # no sampler thread exists and every incident hook is one global
    # read.  vitals_retention bounds each series ring.
    vitals_interval_s: float = 0.0
    vitals_retention: int = 240
    # black-box bundle directory: each incident writes one bounded
    # JSON bundle here (blackbox-<seq>-<kind>.json) in addition to the
    # in-memory index /vitals serves.  "" keeps bundles in memory only
    # (still served at /vitals?incident=K while the recorder is
    # armed).  Setting blackbox_dir WITHOUT vitals_interval_s arms the
    # incident recorder alone — bundles then carry trace/SLO/autopilot
    # context but no metric trails.
    blackbox_dir: str = ""
    # device-time launch ledger (fabric_tpu_torch/observe/ledger.py): wraps
    # every device dispatch (stage-2 verify/MVCC, the sign-kernel
    # flush, resident-table scatters, sidecar batches) and decomposes
    # device_wait into compile / queue / execute / transfer per
    # launch, with program-cache hit rates and per-owner HBM
    # watermarks — served at /launches, mirrored as dev:* child spans
    # in /trace, and read by the autopilot's device_queue_ms signal.
    # Default ON: an armed ledger is a few perf_counter reads per
    # launch (no thread); OFF makes every dispatch hook one global
    # read + None check and registers no instruments.
    device_ledger: bool = True
    # per-transaction flow journal (fabric_tpu_torch/observe/txflow.py):
    # endorse → sign flush → submit → order → durable append → state
    # visibility milestones on one monotonic clock, keyed by tx_id —
    # served at /txflow, recorded as tx_flow_* histograms with trace
    # exemplars, frozen into blackbox bundles, and (with ``slos``)
    # feeding the default commit_e2e / commit_valid objectives one
    # event per completed flow.  Default ON: an armed journal is a
    # few perf_counter reads + one small dict per tx; OFF makes every
    # milestone hook one global read + None check and registers no
    # instruments.
    tx_flow: bool = True
    # device-lane degradation (peer/degrade.py DeviceLaneGuard): after
    # device_fail_threshold CONSECUTIVE device-verify failures the
    # validator latches a degraded mode (each block's p256_verify
    # launched and synced at once on the card — correctness identical,
    # the channel stays live) with a recovery probe every
    # device_recovery_s.  0 = guard off entirely (failures raise
    # through and the pipe fails closed).
    device_fail_threshold: int = 0
    # device-launch attempts retried (capped exponential backoff +
    # jitter) before a block takes the degraded lane; counts on
    # device_verify_retries_total.  Only meaningful with the guard on.
    device_retries: int = 2
    # seconds between recovery probes while degraded: one block rides
    # the device lane; success re-arms it (validator_degraded gauge 0)
    device_recovery_s: float = 30.0
    # device verify deadline (ms): a device launch/sync slower than
    # this COUNTS AS A FAILURE toward the degraded latch.  The result
    # is still used — a blocked XLA sync cannot be preempted from
    # Python — so this is a latch signal for future blocks, not a
    # per-block abort.  0 = no deadline.
    verify_deadline_ms: float = 0.0
    # device-resident MVCC state (fabric_tpu_torch/state): keep an LRU
    # key-range cache of committed versions resident in DEVICE memory
    # across blocks — the fused stage-2 program reads them there, the
    # per-block host state_fill shrinks to the miss set, and each
    # committed block's write-set applies as a delta scatter at the
    # commit boundary.  Default OFF: CPU/tier-1 hosts keep the exact
    # host state_fill path (which also stays as the bit-equal
    # per-block fallback for misses, range queries, eviction pressure
    # and device failures).
    state_resident: bool = False
    # resident version-table budget in MiB of device memory (12 bytes
    # per cached key; the slot count rounds down to a power of two so
    # mesh shards divide it exactly)
    state_resident_mb: int = 64
    # key-range granularity: keys hash into 2^bits ranges, the LRU
    # admission/eviction unit — fewer bits = coarser ranges (bulkier
    # evictions, cheaper bookkeeping), more bits = finer working-set
    # tracking
    state_resident_range_bits: int = 12
    # validation sidecar, client side (fabric_tpu_torch/sidecar): with an
    # endpoint set, every channel's validator ships its signature
    # batches to the sidecar's shared device fabric instead of owning
    # a local device lane (SidecarValidator); "" = in-process device
    # lane, today's behavior.  Weight is this peer's fair-share claim
    # in the sidecar's weighted-deficit-round-robin scheduler, and
    # sidecar_recovery_s paces the degrade latch's re-attach probes
    # after a sidecar loss (blocks ride the peer's own p256_verify
    # while detached — latency degrades, liveness never does).
    sidecar_endpoint: str = ""
    sidecar_weight: float = 1.0
    sidecar_recovery_s: float = 5.0
    # validation sidecar, server side: a host:port makes THIS process
    # also serve a validation sidecar from its device fabric (the
    # many-peers-one-pod shape; `python -m fabric_tpu_torch.cli
    # sidecar-serve` runs it standalone).  queue_blocks bounds each
    # tenant's admission queue (a full queue answers a typed BUSY
    # frame — explicit backpressure, not unbounded buffering) and
    # sidecar_coalesce caps how many cross-tenant batches merge into
    # one padded device dispatch.
    sidecar_listen: str = ""
    sidecar_queue_blocks: int = 8
    sidecar_coalesce: int = 4
    # traffic autopilot (fabric_tpu/control/autopilot.py): closed-loop
    # overload control — a periodic controller reads trailing SLO burn
    # rates, scheduler queue-age/BUSY telemetry and pipeline overlap
    # coverage, and actuates coalesce_blocks / verify_chunk /
    # pipeline_depth / sidecar tenant weights + shed mode through
    # their runtime setters, governed by hysteresis bands, per-knob
    # cooldowns, a max-one-step-per-tick rule and hard clamps.  OFF by
    # default: tier-1 and CPU hosts keep the exact static path.
    autopilot: bool = False
    # seconds between controller ticks (the decision cadence; each
    # tick actuates at most one knob step)
    autopilot_tick_s: float = 1.0
    # per-knob min/max clamp spec (autopilot.parse_knob_specs), e.g.
    # 'coalesce_blocks:min=0:max=8;verify_chunk:min=512:max=4096;
    # pipeline_depth:min=2:max=4;weight:min=0.125:max=8'.  Empty =
    # the validated defaults; named knobs override per-key.
    autopilot_knobs: str = ""
    # device-batched endorsement signing (peer/signlane.py SignBatcher
    # + ops/p256sign.py): with sign_device on, concurrent ESCC sign
    # requests from the Endorse RPC and the gateway coalesce into ONE
    # padded device sign dispatch (fixed-base k·G comb ladder, RFC 6979
    # deterministic nonces — bit-equal to the serial signer).  A full
    # admission queue answers a typed BUSY (429 proposal response with
    # a retry hint) instead of buffering.  Default OFF: CPU/tier-1
    # hosts keep the exact serial crypto/identity.py signing path.
    sign_device: bool = False
    # most sign requests coalesced per device flush (the autopilot's
    # `sign_batch_max` knob actuates this at flush boundaries)
    sign_batch_max: int = 256
    # ms the flusher lingers after the first pending request before
    # dispatching a partial batch (0 = dispatch immediately)
    sign_batch_wait_ms: float = 2.0
    # verify-after-sign self-check: every fresh sign batch re-verifies
    # through the device verify lane (ops/p256v3.verify_launch) before
    # any signature leaves the peer — one extra device dispatch per
    # sign batch buys a hard guarantee against corrupt signatures
    sign_self_check: bool = False
    # chaos fault plan (fabric_tpu_torch/faults): spec string arming named
    # injection points, e.g.
    # 'validator.verify_launch:raise:n=3;deliver.read:disconnect:n=1'.
    # Staging/soak rigs only; empty = no injection (and fire() costs
    # one attribute read).  FABTPU_FAULTS overrides like any scalar.
    faults: str = ""
    # chaincode install surface (peer/node.py _on_install)
    max_package_size: int = DEFAULT_MAX_PACKAGE_SIZE
    install_require_admin: bool = False
    # the device the peer's kernels run on ("cuda" by default; "cpu"
    # runs their plain versions) — the port's counterpart of the
    # reference processes' JAX_PLATFORMS
    device: str = "cuda"


@dataclass
class OrdererConfig:
    """The orderer's knob surface (orderer/common/localconfig)."""

    id: str = ""
    data_dir: str = ""
    msp_id: str = ""
    msp_dir: str = ""
    host: str = "127.0.0.1"
    port: int = 0
    operations_port: int | None = None
    cluster: dict = field(default_factory=dict)   # id -> [host, port]
    channels: list = field(default_factory=list)  # [ChannelRef | name]
    tls: TlsConfig | None = None
    # blockcutter (orderer.yaml BatchSize/BatchTimeout)
    max_message_count: int = 500
    batch_timeout_s: float = 0.2
    # consensus
    consensus: str = "raft"          # "raft" | "bft"
    view_timeout: float = 2.0
    wal_retention: int = 256
    broadcast_rate: float = 0.0      # msgs/s per channel; 0 = unlimited


_REQUIRED = {"id", "data_dir"}


def _is_union(origin) -> bool:
    import types
    import typing

    # PEP 604 unions (int | None) have origin types.UnionType, NOT
    # typing.Union — missing that silently skipped Optional fields
    return origin is typing.Union or origin is types.UnionType


def _coerce(name: str, val, typ):
    """Type-check/coerce one scalar with an operator-grade error."""
    import typing

    origin = typing.get_origin(typ)
    if _is_union(origin):  # Optional[...]
        args = [a for a in typing.get_args(typ) if a is not type(None)]
        if val is None:
            return None
        return _coerce(name, val, args[0])
    if typ is float and isinstance(val, int):
        return float(val)
    if typ is int and isinstance(val, bool):
        raise ConfigError(f"key '{name}': expected int, got bool")
    if typ in (int, float, str, bool) and not isinstance(val, typ):
        # env vars arrive as strings: coerce them
        if isinstance(val, str) and typ in (int, float):
            try:
                return typ(val)
            except ValueError:
                raise ConfigError(
                    f"key '{name}': cannot parse {val!r} as {typ.__name__}"
                ) from None
        if isinstance(val, str) and typ is bool:
            if val.lower() in ("true", "1", "yes"):
                return True
            if val.lower() in ("false", "0", "no"):
                return False
            raise ConfigError(
                f"key '{name}': cannot parse {val!r} as bool"
            )
        raise ConfigError(
            f"key '{name}': expected {typ.__name__}, "
            f"got {type(val).__name__} ({val!r})"
        )
    return val


def _build(cls, raw: dict, prefix: str = ""):
    """dict → dataclass with unknown-key / type errors naming keys."""
    if not isinstance(raw, dict):
        raise ConfigError(
            f"section '{prefix or cls.__name__}': expected an object, "
            f"got {type(raw).__name__}"
        )
    fields = {f.name: f for f in dataclasses.fields(cls)}
    out = {}
    for key, val in raw.items():
        if key not in fields:
            hint = difflib.get_close_matches(key, fields, n=1)
            did = f" — did you mean '{hint[0]}'?" if hint else ""
            raise ConfigError(
                f"unknown key '{prefix}{key}' in {cls.__name__}{did}"
            )
        f = fields[key]
        qual = f"{prefix}{key}"
        if key == "tls":
            out[key] = None if val in (None, {}) else _build(
                TlsConfig, val, prefix=f"{qual}."
            )
        elif key == "channels":
            out[key] = [
                c if isinstance(c, str)
                else _build(ChannelRef, c, prefix=f"{qual}[].")
                for c in _want_list(qual, val)
            ]
        elif key == "chaincodes":
            out[key] = [
                _build(ChaincodeRef, c, prefix=f"{qual}[].")
                for c in _want_list(qual, val)
            ]
        elif key == "peers":
            out[key] = [
                _build(PeerRef, c, prefix=f"{qual}[].")
                for c in _want_list(qual, val)
            ]
        elif key in ("org_msps",):
            out[key] = _want_list(qual, val)
        elif key == "cluster":
            if not isinstance(val, dict):
                raise ConfigError(f"key '{qual}': expected an object")
            out[key] = {k: tuple(v) for k, v in val.items()}
        else:
            out[key] = _coerce(qual, val, f.type if not isinstance(
                f.type, str) else _ANNOT[cls.__name__][key])
    return cls(**out)


def _want_list(name, val):
    if not isinstance(val, list):
        raise ConfigError(f"key '{name}': expected a list")
    return val


# dataclass annotations arrive as strings under
# `from __future__ import annotations` — resolve them once
import typing as _t

_ANNOT = {
    cls.__name__: _t.get_type_hints(cls)
    for cls in (PeerConfig, OrdererConfig, TlsConfig, ChannelRef,
                ChaincodeRef, PeerRef)
}

ENV_PREFIX = "FABTPU_"


def _apply_env(cfg, environ=None):
    """FABTPU_<FIELD> (and FABTPU_TLS_<FIELD>) override scalars —
    the CORE_/ORDERER_ env-override convention."""
    env = os.environ if environ is None else environ
    hints = _ANNOT[type(cfg).__name__]
    for f in dataclasses.fields(cfg):
        typ = hints[f.name]
        key = ENV_PREFIX + f.name.upper()
        if _is_union(_t.get_origin(typ)):
            # only SCALAR unions (Optional[int] etc.) are env-settable:
            # an env string can never construct Optional[TlsConfig] —
            # letting it through would assign the raw string (the
            # ADVICE round-5 bug) and crash far away with
            # AttributeError instead of an error naming the key
            args = [a for a in _t.get_args(typ) if a is not type(None)]
            if len(args) != 1 or args[0] not in (int, float, str, bool):
                if key in env:
                    raise ConfigError(
                        f"env override '{key}' cannot set non-scalar "
                        f"field '{f.name}' — use the config file (or "
                        f"{ENV_PREFIX}TLS_* for the tls section)"
                    )
                continue
        elif typ not in (int, float, str, bool):
            if key in env:
                raise ConfigError(
                    f"env override '{key}' cannot set non-scalar "
                    f"field '{f.name}' — use the config file"
                )
            continue
        if key in env:
            setattr(cfg, f.name, _coerce(f"${key}", env[key], typ))
    tls_hints = _ANNOT["TlsConfig"]
    tls_envs = {
        k: v for k, v in env.items()
        if k.startswith(ENV_PREFIX + "TLS_")
    }
    if tls_envs:
        if cfg.tls is None:
            cfg.tls = TlsConfig()
        for k, v in tls_envs.items():
            fname = k[len(ENV_PREFIX) + 4:].lower()
            if fname not in tls_hints:
                raise ConfigError(f"unknown env override '{k}'")
            setattr(cfg.tls, fname, v)
    return cfg


def _load(cls, source, environ=None):
    if isinstance(source, str):
        try:
            with open(source) as f:
                raw = json.load(f)
        except json.JSONDecodeError as e:
            raise ConfigError(f"{source}: invalid JSON: {e}") from None
    else:
        raw = source
    cfg = _build(cls, raw)
    _apply_env(cfg, environ)
    required = set(_REQUIRED)
    if cls is PeerConfig:
        # the peer cannot start without a signing identity (the
        # orderer can — unsigned dev channels exist)
        required |= {"msp_dir", "msp_id"}
    missing = [k for k in required if not getattr(cfg, k)]
    if missing:
        raise ConfigError(
            f"{cls.__name__}: missing required key(s): "
            + ", ".join(sorted(missing))
        )
    if cfg.tls is not None:
        tmiss = [k for k in ("cert", "key", "ca")
                 if not getattr(cfg.tls, k)]
        if tmiss and len(tmiss) < 3:
            raise ConfigError(
                "tls section: cert, key, and ca must be set together; "
                "missing: " + ", ".join(tmiss)
            )
        if len(tmiss) == 3:
            cfg.tls = None  # an all-empty section means no TLS
    if isinstance(cfg, PeerConfig) and cfg.pipeline_depth < 1:
        raise ConfigError(
            f"key 'pipeline_depth': must be >= 1 (1 = serial, 2 = "
            f"classic overlap, N = deep window), got {cfg.pipeline_depth}"
        )
    if isinstance(cfg, PeerConfig) and cfg.apply_queue_blocks < 1:
        raise ConfigError(
            f"key 'apply_queue_blocks': must be >= 1 trailing batch "
            f"(the bound is what keeps apply lag and crash-recovery "
            f"replay finite), got {cfg.apply_queue_blocks}"
        )
    if isinstance(cfg, PeerConfig) and cfg.host_stage_mode not in (
            "thread", "process"):
        raise ConfigError(
            f"key 'host_stage_mode': must be 'thread' or 'process', "
            f"got {cfg.host_stage_mode!r}"
        )
    if isinstance(cfg, PeerConfig) and cfg.vitals_interval_s < 0:
        raise ConfigError(
            f"key 'vitals_interval_s': must be >= 0 seconds (0 = "
            f"recorder off), got {cfg.vitals_interval_s}"
        )
    if isinstance(cfg, PeerConfig) and cfg.vitals_retention < 1:
        raise ConfigError(
            f"key 'vitals_retention': must be >= 1 points per series, "
            f"got {cfg.vitals_retention}"
        )
    if isinstance(cfg, PeerConfig) and cfg.sign_batch_max < 1:
        raise ConfigError(
            f"key 'sign_batch_max': must be >= 1 sign request per "
            f"device flush, got {cfg.sign_batch_max}"
        )
    if isinstance(cfg, PeerConfig) and cfg.sign_batch_wait_ms < 0:
        raise ConfigError(
            f"key 'sign_batch_wait_ms': must be >= 0 ms (0 = flush "
            f"immediately), got {cfg.sign_batch_wait_ms}"
        )
    if isinstance(cfg, PeerConfig) and cfg.state_resident_mb < 1:
        raise ConfigError(
            f"key 'state_resident_mb': must be >= 1 MiB of device "
            f"memory for the resident version table, "
            f"got {cfg.state_resident_mb}"
        )
    if isinstance(cfg, PeerConfig) and not (
            1 <= cfg.state_resident_range_bits <= 24):
        raise ConfigError(
            f"key 'state_resident_range_bits': must be in [1, 24] "
            f"(keys hash into 2^bits LRU ranges), "
            f"got {cfg.state_resident_range_bits}"
        )
    if isinstance(cfg, PeerConfig) and cfg.mesh_shape:
        raise _unported("mesh_shape", "parallel/topology.py", 9)
    if isinstance(cfg, PeerConfig) and cfg.mesh_distributed \
            and not cfg.mesh_coordinator:
        raise ConfigError(
            "key 'mesh_distributed': requires 'mesh_coordinator' "
            "(host:port of the jax.distributed rendezvous)"
        )
    if isinstance(cfg, PeerConfig) and cfg.mesh_num_processes < 1:
        raise ConfigError(
            f"key 'mesh_num_processes': must be >= 1 process, "
            f"got {cfg.mesh_num_processes}"
        )
    if isinstance(cfg, PeerConfig) and not (
            0 <= cfg.mesh_process_id < cfg.mesh_num_processes):
        raise ConfigError(
            f"key 'mesh_process_id': must be in [0, "
            f"mesh_num_processes={cfg.mesh_num_processes}), "
            f"got {cfg.mesh_process_id}"
        )
    if isinstance(cfg, PeerConfig) and cfg.autopilot_tick_s <= 0:
        raise ConfigError(
            f"key 'autopilot_tick_s': must be > 0 seconds, "
            f"got {cfg.autopilot_tick_s}"
        )
    if isinstance(cfg, PeerConfig) and (cfg.autopilot
                                        or cfg.autopilot_knobs):
        raise _unported("autopilot" if cfg.autopilot else "autopilot_knobs",
                        "control/autopilot.py", 10)
    if isinstance(cfg, PeerConfig) and cfg.slos:
        raise _unported("slos", "observe/slo.py", 10)
    if isinstance(cfg, PeerConfig):
        _refuse_unported(cfg)
    if isinstance(cfg, OrdererConfig) and cfg.consensus not in (
            "raft", "bft"):
        raise ConfigError(
            f"key 'consensus': must be 'raft' or 'bft', "
            f"got {cfg.consensus!r}"
        )
    return cfg


#: PeerConfig keys whose module the port has not ported yet: the
#: module and its ROADMAP Queue 1 item (set to their default they pass)
_UNPORTED = {
    "mesh_devices": ("parallel/mesh.py", 9),
    "mesh_distributed": ("parallel/topology.py", 9),
    "mesh_coordinator": ("parallel/topology.py", 9),
    "mesh_process_id": ("parallel/topology.py", 9),
    "mesh_num_processes": ("parallel/topology.py", 9),
    "verify_chunk": ("the mesh's chunked verify", 9),
    "recode_device": ("on-card window recoding", 10),
    "verify_deadline_ms": ("the guard's verify deadline", 10),
    "host_stage_mode": ("the process staging pool", 10),
    "autopilot_tick_s": ("control/autopilot.py", 10),
    "vitals_interval_s": ("observe/timeseries.py", 10),
    "vitals_retention": ("observe/timeseries.py", 10),
    "blackbox_dir": ("observe/blackbox.py", 10),
    "sidecar_listen": ("a sidecar server hosted by the peer", 10),
    "sidecar_queue_blocks": ("a sidecar server hosted by the peer", 10),
    "sidecar_coalesce": ("a sidecar server hosted by the peer", 10),
}

_PEER_DEFAULTS = PeerConfig()


def _unported(key: str, module: str, item: int) -> ConfigError:
    return ConfigError(f"key '{key}': {module} is not ported yet "
                       f"(ROADMAP Queue 1 item {item})")


def _refuse_unported(cfg: PeerConfig) -> None:
    for key, (module, item) in _UNPORTED.items():
        if getattr(cfg, key) != getattr(_PEER_DEFAULTS, key):
            raise _unported(key, module, item)


def load_peer_config(source, environ=None) -> PeerConfig:
    """``source``: path to a JSON file or an already-loaded dict."""
    return _load(PeerConfig, source, environ)


def load_orderer_config(source, environ=None) -> OrdererConfig:
    return _load(OrdererConfig, source, environ)
