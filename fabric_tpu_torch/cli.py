"""The operator CLI: the cmd/{peer,orderer,configtxgen,cryptogen,
osnadmin,discover,ledgerutil} surface in one program (counterpart:
``fabric_tpu/cli.py``; the same verbs, flags and exit codes).

Usage: python -m fabric_tpu_torch.cli [--tls-ca F --tls-cert F --tls-key F] <command> ...

Commands:
  cryptogen       org crypto material onto disk (certificates signed on
                  the card with --device cuda, the default)
  configtxgen     genesis block from a JSON profile
  orderer / peer  run a node from its JSON config (nodeconfig.py); a peer
                  validates every block with the card's kernels
  sidecar-serve   run a standalone validation sidecar
  chaincode       run a sample chaincode-as-a-service server
  osnadmin        orderer channel participation (join)
  invoke / query  gateway client round trips
  ccpackage / ccinstall / ccqueryinstalled
                  chaincode packages and their install on a peer
  snapshot        request a ledger snapshot from a peer
  discover        discovery queries against a peer
  replay          offline catch-up of a channel from a block store
  ledgerutil      verify / compare ledger directories offline
  configtxlator   config proto <-> JSON and update deltas
  node            offline channel ops on a stopped peer

A config error exits 2, as does a device the host does not have (a
peer or ``cryptogen`` asked for ``cuda`` where CUDA is not available:
set ``"device": "cpu"`` / ``FABTPU_DEVICE=cpu``, or ``--device cpu``,
to run the plain versions).  ``ledgerutil`` exits 1 when a ledger is
not ok or two are not identical.  A peer on the card builds (or loads
from ``fabric_tpu_torch/_build/``) every kernel before it serves, so a
kernel that does not build stops the daemon with a non-zero exit.
Client verbs speak mutual TLS when the global ``--tls-*`` flags are
given; daemons take their config's ``tls`` section.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

#: sidecar-serve flags whose module the port has not ported yet:
#: flag → (its default, the module, its ROADMAP Queue 1 item)
_SIDECAR_UNPORTED = {
    "mesh_devices": (0, "parallel/mesh.py", 9),
    "mesh_shape": ("", "parallel/topology.py", 9),
    "mesh_distributed": (False, "parallel/topology.py", 9),
    "mesh_coordinator": ("", "parallel/topology.py", 9),
    "mesh_process_id": (0, "parallel/topology.py", 9),
    "mesh_num_processes": (1, "parallel/topology.py", 9),
    "verify_chunk": (0, "the mesh's chunked verify", 9),
    "recode_device": (False, "on-card window recoding", 10),
    "slos": ("", "observe/slo.py", 10),
    "vitals_interval_s": (0.0, "observe/timeseries.py", 10),
    "vitals_retention": (240, "observe/timeseries.py", 10),
    "blackbox_dir": ("", "observe/blackbox.py", 10),
    "autopilot": (False, "control/autopilot.py", 10),
    "autopilot_tick_s": (1.0, "control/autopilot.py", 10),
    "autopilot_knobs": ("", "control/autopilot.py", 10),
}


def _device_or_exit(device: str):
    """``device`` → torch.device; a device the host lacks exits 2."""
    from fabric_tpu_torch.device import resolve_device

    try:
        return resolve_device(device)
    except RuntimeError as e:
        print(f"device error: {e}", file=sys.stderr)
        sys.exit(2)


def _cmd_cryptogen(args):
    import functools
    import secrets

    import numpy as np

    from fabric_tpu_torch.crypto import cryptogen as cg

    dev = _device_or_exit(args.device)
    sign_batch = cg.ec_ref_signer
    if dev.type == "cuda":
        from fabric_tpu_torch.ops import p256sign

        sign_batch = functools.partial(p256sign.sign_digests, device=dev)
    rng = np.random.default_rng(secrets.randbits(128))
    for spec in args.org:
        msp_id, _, domain = spec.partition(":")
        org = cg.generate_org(msp_id, domain or f"{msp_id.lower()}.example.com", rng,
                              peers=args.peers, orderers=args.orderers, users=args.users,
                              sign_batch=sign_batch)
        out = cg.write_org(org, args.output)
        print(f"wrote {msp_id} material to {out}")


def _cmd_configtxgen(args):
    from fabric_tpu_torch.crypto import cryptogen as cg
    from fabric_tpu_torch.tools import configtxgen as ctg

    with open(args.profile) as f:
        prof = json.load(f)
    app_orgs = [ctg.OrgProfile(o["msp_id"], cg.load_org_msp(o["dir"]),
                               [tuple(a) for a in o.get("anchor_peers", [])])
                for o in prof.get("application_orgs", [])]
    orderer_orgs = [ctg.OrgProfile(o["msp_id"], cg.load_org_msp(o["dir"]), [])
                    for o in prof.get("orderer_orgs", [])]
    profile = ctg.Profile(prof["channel"], application_orgs=app_orgs,
                          orderer_orgs=orderer_orgs,
                          consensus_type=prof.get("consensus", "raft"),
                          raft_consenters=[tuple(c) for c in prof.get("consenters", [])],
                          max_message_count=prof.get("max_message_count", 500),
                          batch_timeout_ms=prof.get("batch_timeout_ms", 200))
    blk = ctg.genesis_block(profile)
    with open(args.output, "wb") as f:
        f.write(blk.serialize())
    print(f"wrote genesis block for {prof['channel']} to {args.output}")


def _node_tls(cfg):
    """Node mTLS material from the typed ``tls`` section."""
    t = cfg.tls
    if t is None or not t.cert:
        return None
    from fabric_tpu_torch.comm.rpc import TlsProfile

    return TlsProfile.load(t.cert, t.key, t.ca)


def _read_block(path: str):
    from fabric_tpu_torch.protos import messages as m

    with open(path, "rb") as f:
        return m.Block.parse(f.read())


async def _run_orderer(cfg):
    from fabric_tpu_torch.crypto import cryptogen as cg
    from fabric_tpu_torch.ordering.blockcutter import BatchConfig
    from fabric_tpu_torch.ordering.node import OrdererNode

    signer = cg.load_signing_identity(cfg.msp_dir, cfg.msp_id) if cfg.msp_dir else None
    node = OrdererNode(cfg.id, cfg.data_dir, cfg.cluster, host=cfg.host, port=cfg.port,
                       batch_config=BatchConfig(max_message_count=cfg.max_message_count,
                                                batch_timeout_s=cfg.batch_timeout_s),
                       consensus=cfg.consensus, view_timeout=cfg.view_timeout,
                       signer=signer, tls=_node_tls(cfg))
    node.broadcast_rate = cfg.broadcast_rate
    await node.start(operations_port=cfg.operations_port)
    print(f"orderer {node.id} serving on :{node.port}", flush=True)
    for ch in cfg.channels:
        name = ch if isinstance(ch, str) else ch.name
        genesis = None if isinstance(ch, str) or not ch.genesis else _read_block(ch.genesis)
        chain = node.join_channel(name, genesis)
        chain.wal_retention = cfg.wal_retention
    await asyncio.Event().wait()


def _build_peer(cfg):
    """The PeerNode of a validated PeerConfig — shared by the serving
    ``peer`` command and the offline ``replay`` (which never starts the
    server)."""
    from fabric_tpu_torch.crypto import cryptogen as cg
    from fabric_tpu_torch.crypto.msp import MSPManager
    from fabric_tpu_torch.peer.ccaas import CCaaSProxy
    from fabric_tpu_torch.peer.chaincode import ChaincodeRuntime
    from fabric_tpu_torch.peer.node import PeerNode

    signer = cg.load_signing_identity(cfg.msp_dir, cfg.msp_id)
    mgr = MSPManager()
    for org_dir in cfg.org_msps:
        mgr.add(cg.load_org_msp(org_dir))
    runtime = ChaincodeRuntime()
    for cc in cfg.chaincodes:
        runtime.register(cc.name, CCaaSProxy(cc.name, cc.host, cc.port))
    return PeerNode(
        cfg.id, cfg.data_dir, mgr, signer, runtime, host=cfg.host, port=cfg.port,
        tls=_node_tls(cfg), max_package_size=cfg.max_package_size,
        install_require_admin=cfg.install_require_admin,
        pipeline_depth=cfg.pipeline_depth, coalesce_blocks=cfg.coalesce_blocks,
        host_stage_workers=cfg.host_stage_workers,
        trace_ring_blocks=cfg.trace_ring_blocks, trace_slow_factor=cfg.trace_slow_factor,
        device_ledger=cfg.device_ledger, sign_device=cfg.sign_device,
        sign_batch_max=cfg.sign_batch_max, sign_batch_wait_ms=cfg.sign_batch_wait_ms,
        sign_self_check=cfg.sign_self_check,
        device_fail_threshold=cfg.device_fail_threshold, device_retries=cfg.device_retries,
        device_recovery_s=cfg.device_recovery_s, state_resident=cfg.state_resident,
        state_resident_mb=cfg.state_resident_mb,
        state_resident_range_bits=cfg.state_resident_range_bits, faults=cfg.faults,
        sidecar_endpoint=cfg.sidecar_endpoint, sidecar_weight=cfg.sidecar_weight,
        sidecar_recovery_s=cfg.sidecar_recovery_s, async_commit=cfg.async_commit,
        apply_queue_blocks=cfg.apply_queue_blocks, tx_flow=cfg.tx_flow, device=cfg.device)


def _build_kernels(device) -> None:
    """On the card, build or load every kernel and host library before
    the node serves: a kernel that does not build raises here."""
    from fabric_tpu_torch import native

    native.build()
    if device.type == "cuda":
        from fabric_tpu_torch import kernels

        kernels.build()


def _join_config_channel(node, cfg, ch):
    """Join one configured channel (genesis / snapshot anchored) and
    apply the per-channel ledger knobs."""
    name = ch if isinstance(ch, str) else ch.name
    genesis = None if isinstance(ch, str) or not ch.genesis else _read_block(ch.genesis)
    chan = node.join_channel(
        name, genesis_block=genesis,
        snapshot_dir=None if isinstance(ch, str) or not ch.snapshot_dir else ch.snapshot_dir)
    chan.ledger.blocks.group_commit = cfg.group_commit
    chan.transient_retention = cfg.transient_retention
    return chan


async def _run_peer(cfg):
    from fabric_tpu_torch.discovery import PeerInfo

    node = _build_peer(cfg)
    _build_kernels(node.device)
    await node.start(operations_port=cfg.operations_port)
    print(f"peer {node.id} serving on :{node.port}", flush=True)
    for p in cfg.peers:
        node.registry.add(PeerInfo(p.msp_id, p.host, p.port))
    for ch in cfg.channels:
        name = ch if isinstance(ch, str) else ch.name
        chan = _join_config_channel(node, cfg, ch)
        if not isinstance(ch, str) and ch.replay_from:
            # local catch-up before the deliver loop attaches
            stats = await chan.replay_local(ch.replay_from)
            print(f"channel {name} replayed {stats['blocks']} blocks to height "
                  f"{chan.height} ({stats['blocks_per_s']} blocks/s)", flush=True)
        orderers = [] if isinstance(ch, str) else [tuple(o) for o in ch.orderers]
        if orderers:
            chan.start_deliver(orderers, censorship_check_s=cfg.deliver_censorship_check_s)
        if not isinstance(ch, str) and ch.anti_entropy:
            node.gossip_service.start_anti_entropy(name)
        node.gossip_service.start_reconciler(name)
    await asyncio.Event().wait()


def _load_config(args, peer: bool):
    from fabric_tpu_torch.nodeconfig import ConfigError, load_orderer_config, load_peer_config

    try:
        cfg = (load_peer_config if peer else load_orderer_config)(args.config)
    except ConfigError as e:
        print(f"config error: {e}", file=sys.stderr)
        sys.exit(2)
    if peer:
        _device_or_exit(cfg.device)
    return cfg


def _cmd_node(args, runner):
    cfg = _load_config(args, runner is _run_peer)
    try:
        asyncio.run(runner(cfg))
    except KeyboardInterrupt:
        pass


async def _run_sidecar(args):
    """A standalone validation sidecar: one card serving many peer
    processes' signature batches (peers set ``sidecar_endpoint``)."""
    from fabric_tpu_torch.sidecar.client import parse_endpoint
    from fabric_tpu_torch.sidecar.server import SidecarServer

    if args.device_ledger:
        from fabric_tpu_torch.observe import ledger as ledger_mod

        ledger_mod.configure()
    ssl_ctx = None
    if args.tls_cert and args.tls_key:
        from fabric_tpu_torch.comm.rpc import make_server_tls

        with open(args.tls_cert, "rb") as f:
            cert = f.read()
        with open(args.tls_key, "rb") as f:
            key = f.read()
        ca = None
        if args.tls_ca:
            with open(args.tls_ca, "rb") as f:
                ca = f.read()
        ssl_ctx = make_server_tls(cert, key, ca)
    host, port = parse_endpoint(args.listen)
    srv = SidecarServer(host, port, queue_blocks=args.queue_blocks, coalesce=args.coalesce,
                        ssl_ctx=ssl_ctx, device=args.device)
    await srv.start()
    print(f"validation sidecar serving on {srv.host}:{srv.port}", flush=True)
    if args.operations_port is not None:
        from fabric_tpu_torch.opsserver import HealthRegistry, OperationsServer

        health = HealthRegistry()
        health.register("sidecar", srv.health_check)
        ops = await OperationsServer(port=args.operations_port, health=health).start()
        print(f"operations on :{ops.port}", flush=True)
    await asyncio.Event().wait()


def _cmd_sidecar(args):
    for flag, (default, module, item) in _SIDECAR_UNPORTED.items():
        if getattr(args, flag) != default:
            print(f"--{flag.replace('_', '-')}: {module} is not ported yet "
                  f"(ROADMAP Queue 1 item {item})", file=sys.stderr)
            sys.exit(2)
    _device_or_exit(args.device)
    try:
        asyncio.run(_run_sidecar(args))
    except KeyboardInterrupt:
        pass


async def _run_chaincode(args):
    from fabric_tpu_torch.peer.ccaas import ChaincodeServer
    from fabric_tpu_torch.peer.chaincode import KVContract, MarblesContract

    server = ChaincodeServer(port=args.port)
    await server.start()
    contract = {"kv": KVContract, "marbles": MarblesContract}[args.contract]()
    server.register(args.name, contract)
    print(f"chaincode {args.name} ({args.contract}) serving on :{server.port}", flush=True)
    await asyncio.Event().wait()


def _cli_ssl(args):
    """Client TLS context from the global --tls-* flags (mutual when a
    certificate and key are given), or None for plaintext."""
    if not getattr(args, "tls_ca", None):
        return None
    from fabric_tpu_torch.comm.rpc import make_client_tls

    with open(args.tls_ca, "rb") as f:
        ca = f.read()
    cert = key = None
    if getattr(args, "tls_cert", None) and getattr(args, "tls_key", None):
        with open(args.tls_cert, "rb") as f:
            cert = f.read()
        with open(args.tls_key, "rb") as f:
            key = f.read()
    return make_client_tls(ca, cert, key)


def _unary_print(args, method: str, request: bytes, timeout: float = 10.0) -> None:
    """One unary RPC to ``--host:--port``; prints the answer."""
    from fabric_tpu_torch.comm.rpc import RpcClient

    async def go():
        cli = RpcClient(args.host, args.port, ssl_ctx=_cli_ssl(args))
        await cli.connect()
        try:
            return await cli.unary(method, request, timeout=timeout)
        finally:
            await cli.close()

    print(asyncio.run(go()).decode())


def _cmd_osnadmin(args):
    blk = b""
    if args.genesis:
        with open(args.genesis, "rb") as f:
            blk = f.read()
    hdr = json.dumps({"channel": args.channel}).encode()
    _unary_print(args, "Join", len(hdr).to_bytes(4, "big") + hdr + blk)


def _cmd_invoke(args, evaluate=False):
    from fabric_tpu_torch.crypto import cryptogen as cg
    from fabric_tpu_torch.peer.gateway import GatewayClient

    signer = cg.load_signing_identity(args.msp_dir, args.msp_id)

    async def go():
        gw = GatewayClient(args.host, args.port, signer, ssl_ctx=_cli_ssl(args))
        try:
            cc_args = [a.encode() for a in args.args]
            if evaluate:
                resp = await gw.evaluate(args.channel, args.chaincode, cc_args)
                print(json.dumps({"status": resp.status,
                                  "payload": resp.payload.decode("utf-8", "replace")}))
            else:
                tx_id, status = await gw.submit_transaction(args.channel, args.chaincode,
                                                            cc_args)
                print(json.dumps({"tx_id": tx_id, **(status or {})}))
        finally:
            await gw.close()

    asyncio.run(go())


def _cmd_ccpackage(args):
    from fabric_tpu_torch.peer import ccpackage

    raw = ccpackage.package_ccaas(args.label, args.address)
    with open(args.output, "wb") as f:
        f.write(raw)
    print(json.dumps({"package_id": ccpackage.package_id(args.label, raw),
                      "path": args.output}))


def _cmd_ccinstall(args):
    with open(args.package, "rb") as f:
        raw = f.read()
    if args.sign_msp_dir:
        # the admin-signed envelope install_require_admin peers demand
        if not args.sign_msp_id:
            print("ccinstall: --sign-msp-dir requires --sign-msp-id "
                  "(an identity without its MSP id can never validate)", file=sys.stderr)
            sys.exit(2)
        from fabric_tpu_torch.crypto.cryptogen import load_signing_identity

        signer = load_signing_identity(args.sign_msp_dir, args.sign_msp_id)
        raw = json.dumps({"package": raw.hex(), "identity": signer.serialized.hex(),
                          "signature": signer.sign(raw).hex()}).encode()
    _unary_print(args, "InstallChaincode", raw, timeout=60.0)


def _cmd_ccqueryinstalled(args):
    _unary_print(args, "QueryInstalled", b"{}")


def _cmd_ledgerutil(args):
    from fabric_tpu_torch.tools import ledgerutil as lu

    if args.action == "verify":
        res = lu.verify_ledger(args.dirs[0])
        print(json.dumps({"height": res.height, "ok": res.ok, "errors": res.errors}))
        sys.exit(0 if res.ok else 1)
    res = lu.compare_ledgers(args.dirs[0], args.dirs[1])
    print(json.dumps(res))
    sys.exit(0 if res["identical"] else 1)


def _cmd_replay(args):
    """Offline catch-up (``peer/replay.py``): validate a staged block
    store into one configured channel's ledger at full pipeline depth
    on the config's device, print the replay stats as JSON, and exit.
    A killed run resumes from the committed height."""
    cfg = _load_config(args, True)

    async def go():
        node = _build_peer(cfg)
        ref = None
        for ch in cfg.channels:
            if (ch if isinstance(ch, str) else ch.name) == args.channel:
                ref = ch
                break
        if ref is None:
            print(f"channel {args.channel} not in config", file=sys.stderr)
            sys.exit(2)
        src = args.source or ("" if isinstance(ref, str) else ref.replay_from)
        if not src:
            print("no replay source: pass --source or set the channel's replay_from",
                  file=sys.stderr)
            sys.exit(2)
        _build_kernels(node.device)
        chan = _join_config_channel(node, cfg, ref)
        try:
            stats = await chan.replay_local(src, depth=args.depth)
            stats["height"] = chan.height
            print(json.dumps(stats))
        finally:
            chan.stop()

    asyncio.run(go())


def _cmd_snapshot(args):
    _unary_print(args, "Snapshot", json.dumps({"channel": args.channel,
                                               "out_dir": args.output}).encode(),
                 timeout=600.0)


def _cmd_discover(args):
    q = {"query": args.query, "channel": args.channel}
    if args.chaincode:
        q["chaincode"] = args.chaincode
    _unary_print(args, "Discover", json.dumps(q).encode())


def _cmd_configtxlator(args):
    from fabric_tpu_torch.tools import configtxlator as ctl

    def out(data: bytes):
        if args.output:
            with open(args.output, "wb") as f:
                f.write(data)
        else:
            sys.stdout.buffer.write(data)
            if not data.endswith(b"\n"):
                sys.stdout.buffer.write(b"\n")

    if args.action == "proto_decode":
        with open(args.input, "rb") as f:
            out(ctl.proto_decode(args.type, f.read()).encode())
    elif args.action == "proto_encode":
        with open(args.input, "rb") as f:
            out(ctl.proto_encode(args.type, f.read().decode()))
    else:  # compute_update
        with open(args.original, "rb") as f:
            original = f.read()
        with open(args.updated, "rb") as f:
            updated = f.read()
        out(ctl.compute_update(args.channel, original, updated))


def _cmd_nodeops(args):
    from fabric_tpu_torch.tools import nodeops

    if args.action == "reset":
        res = nodeops.reset(args.channel_dir)
    elif args.action == "rebuild-dbs":
        res = nodeops.rebuild_dbs(args.channel_dir)
    elif args.action == "unjoin":
        res = nodeops.unjoin(args.channel_dir)
    else:  # rollback
        if args.block_number is None:
            print("rollback requires --block-number", file=sys.stderr)
            sys.exit(2)
        res = nodeops.rollback(args.channel_dir, args.block_number)
    print(json.dumps(res))


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fabric-tpu-torch")
    p.add_argument("--tls-ca", help="trusted TLS CA bundle (enables TLS)")
    p.add_argument("--tls-cert", help="client TLS certificate (mTLS)")
    p.add_argument("--tls-key", help="client TLS key (mTLS)")
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("cryptogen", help="generate org crypto material")
    c.add_argument("--org", action="append", required=True, metavar="MSPID:domain")
    c.add_argument("--peers", type=int, default=1)
    c.add_argument("--orderers", type=int, default=0)
    c.add_argument("--users", type=int, default=1)
    c.add_argument("--output", default="crypto-config")
    c.add_argument("--device", default="cuda",
                   help="where the certificates are signed ('cuda': the card's "
                        "p256_sign; 'cpu': its plain version)")

    c = sub.add_parser("configtxgen", help="genesis block from profile")
    c.add_argument("--profile", required=True)
    c.add_argument("--output", required=True)

    c = sub.add_parser("orderer", help="run an ordering node")
    c.add_argument("--config", required=True)

    c = sub.add_parser("peer", help="run a peer node")
    c.add_argument("--config", required=True)

    c = sub.add_parser("sidecar-serve", help="run a standalone validation sidecar")
    c.add_argument("--listen", default="127.0.0.1:7054",
                   help="host:port to serve the validate stream on")
    c.add_argument("--device", default="cuda",
                   help="the card the sidecar verifies on ('cpu': the plain versions)")
    c.add_argument("--mesh-devices", type=int, default=0,
                   help="device-mesh sharding (not ported: exits 2 when set)")
    c.add_argument("--mesh-shape", default="",
                   help="device grid, 'N' or 'NxM' (not ported: exits 2 when set)")
    c.add_argument("--mesh-distributed", action="store_true",
                   help="span the mesh across processes (not ported: exits 2 when set)")
    c.add_argument("--mesh-coordinator", default="",
                   help="host:port rendezvous for the distributed mesh (not ported)")
    c.add_argument("--mesh-process-id", type=int, default=0,
                   help="this process's rank in the distributed mesh (not ported)")
    c.add_argument("--mesh-num-processes", type=int, default=1,
                   help="total process count in the distributed mesh (not ported)")
    c.add_argument("--verify-chunk", type=int, default=0)
    c.add_argument("--recode-device", action="store_true")
    c.add_argument("--queue-blocks", type=int, default=8,
                   help="per-tenant admission queue bound (BUSY past it)")
    c.add_argument("--coalesce", type=int, default=4,
                   help="max cross-tenant batches per device dispatch")
    c.add_argument("--operations-port", type=int, default=None)
    c.add_argument("--slos", default="", help="SLO spec string (not ported: exits 2 when set)")
    c.add_argument("--vitals-interval-s", type=float, default=0.0,
                   help="flight-data recorder sample interval (not ported: exits 2 when set)")
    c.add_argument("--vitals-retention", type=int, default=240,
                   help="points retained per metric series (not ported)")
    c.add_argument("--blackbox-dir", default="",
                   help="black-box incident bundles (not ported: exits 2 when set)")
    c.add_argument("--device-ledger", type=int, default=1,
                   help="per-launch device-time ledger at /launches (1 = on, the default)")
    c.add_argument("--autopilot", action="store_true",
                   help="a sidecar-local traffic autopilot (not ported: exits 2 when set)")
    c.add_argument("--autopilot-tick-s", type=float, default=1.0)
    c.add_argument("--autopilot-knobs", default="",
                   help="per-knob min/max clamp spec (not ported: exits 2 when set)")

    c = sub.add_parser("chaincode", help="run a sample ccaas chaincode server")
    c.add_argument("--name", required=True)
    c.add_argument("--port", type=int, default=0)
    c.add_argument("--contract", default="kv", choices=["kv", "marbles"])

    c = sub.add_parser("osnadmin", help="orderer channel participation")
    c.add_argument("--host", default="127.0.0.1")
    c.add_argument("--port", type=int, required=True)
    c.add_argument("--channel", required=True)
    c.add_argument("--genesis")

    for name in ("invoke", "query"):
        c = sub.add_parser(name, help=f"gateway {name}")
        c.add_argument("--host", default="127.0.0.1")
        c.add_argument("--port", type=int, required=True)
        c.add_argument("--channel", required=True)
        c.add_argument("--chaincode", required=True)
        c.add_argument("--msp-dir", required=True)
        c.add_argument("--msp-id", required=True)
        c.add_argument("args", nargs="+")

    c = sub.add_parser("ccpackage", help="build a ccaas chaincode package")
    c.add_argument("--label", required=True)
    c.add_argument("--address", required=True,
                   help="ccaas endpoint host:port (connection.json)")
    c.add_argument("--output", required=True)

    c = sub.add_parser("ccinstall", help="install a chaincode package on a peer")
    c.add_argument("--host", default="127.0.0.1")
    c.add_argument("--port", type=int, required=True)
    c.add_argument("--package", required=True)
    c.add_argument("--sign-msp-dir", default=None,
                   help="admin MSP dir: sign the install request (required when the "
                        "peer enforces install_require_admin)")
    c.add_argument("--sign-msp-id", default=None,
                   help="MSP id of the signing admin identity")

    c = sub.add_parser("ccqueryinstalled", help="list packages installed on a peer")
    c.add_argument("--host", default="127.0.0.1")
    c.add_argument("--port", type=int, required=True)

    c = sub.add_parser("ledgerutil", help="offline ledger forensics")
    c.add_argument("action", choices=["verify", "compare"])
    c.add_argument("dirs", nargs="+")

    c = sub.add_parser("snapshot", help="request a ledger snapshot")
    c.add_argument("--host", default="127.0.0.1")
    c.add_argument("--port", type=int, required=True)
    c.add_argument("--channel", required=True)
    c.add_argument("--output", required=True)

    c = sub.add_parser("replay", help="offline catch-up: validate a staged block store "
                                      "into a channel's ledger at full pipeline depth")
    c.add_argument("--config", required=True,
                   help="peer config (the channel's genesis/snapshot anchors, pipeline "
                        "knobs and device come from here)")
    c.add_argument("--channel", required=True)
    c.add_argument("--source", help="block-store directory to replay from "
                                    "(default: the channel's replay_from)")
    c.add_argument("--depth", type=int, default=None,
                   help="pipeline depth override (default: the config's pipeline_depth)")

    c = sub.add_parser("discover", help="discovery queries")
    c.add_argument("--host", default="127.0.0.1")
    c.add_argument("--port", type=int, required=True)
    c.add_argument("--channel", required=True)
    c.add_argument("--query", default="peers", choices=["peers", "config", "endorsers"])
    c.add_argument("--chaincode")

    c = sub.add_parser("configtxlator", help="config proto<->JSON + update deltas")
    c.add_argument("action", choices=["proto_decode", "proto_encode", "compute_update"])
    c.add_argument("--type", help="message type, e.g. common.Config")
    c.add_argument("--input", help="input file (proto or JSON)")
    c.add_argument("--original", help="compute_update: original config pb")
    c.add_argument("--updated", help="compute_update: updated config pb")
    c.add_argument("--channel", help="compute_update: channel id")
    c.add_argument("--output", help="output file (default stdout)")

    c = sub.add_parser("node", help="offline channel ops on a STOPPED peer")
    c.add_argument("action", choices=["reset", "rollback", "unjoin", "rebuild-dbs"])
    c.add_argument("--channel-dir", required=True)
    c.add_argument("--block-number", type=int, help="rollback: last block to keep")
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    cmd = args.cmd
    if cmd in ("orderer", "peer"):
        _cmd_node(args, _run_peer if cmd == "peer" else _run_orderer)
    elif cmd == "sidecar-serve":
        _cmd_sidecar(args)
    elif cmd == "chaincode":
        try:
            asyncio.run(_run_chaincode(args))
        except KeyboardInterrupt:
            pass
    elif cmd in ("invoke", "query"):
        _cmd_invoke(args, evaluate=cmd == "query")
    else:
        {"cryptogen": _cmd_cryptogen, "configtxgen": _cmd_configtxgen,
         "osnadmin": _cmd_osnadmin, "ccpackage": _cmd_ccpackage,
         "ccinstall": _cmd_ccinstall, "ccqueryinstalled": _cmd_ccqueryinstalled,
         "ledgerutil": _cmd_ledgerutil, "snapshot": _cmd_snapshot, "replay": _cmd_replay,
         "discover": _cmd_discover, "configtxlator": _cmd_configtxlator,
         "node": _cmd_nodeops}[cmd](args)


if __name__ == "__main__":
    main()
