"""Gossip layer: membership, private-data dissemination, anti-entropy
state transfer, org-leader election (counterpart:
``fabric_tpu/gossip.py``).

Reference mapping (SURVEY §2.6):
* membership heartbeats (gossip/discovery/discovery_impl.go) →
  ``GossipPing`` probes refreshing alive/height in the PeerRegistry;
* pvtdata distribution at endorsement
  (gossip/privdata/distributor.go) → ``PvtPush`` into peers' transient
  stores; commit-time pulls (pull.go) → ``PvtPull`` answered from the
  transient store or the committed pvtdata store;
* state transfer / anti-entropy (gossip/state/state.go:584-610) → a
  per-channel task comparing heights with members and pulling missing
  block ranges over the peers' DeliverBlocks stream;
* leader election (gossip/election) → deterministic lowest-endpoint
  election among the org's ALIVE peers — the reference's static
  org-leader mode (useLeaderElection=false) made automatic.

Block dissemination itself stays pull-based (peers pull from the
orderer or from each other), which the reference also supports.

The wire JSON of ``GossipPing``, ``PvtPush`` and ``PvtPull`` is the
reference's byte for byte, so either package's peer serves the other.
Where the port departs: the pull's request signature (a host ``ec_ref``
signature) and the responder's check of it run in a worker thread, not
on the event loop.  Every dial presents the node's ``tls`` profile
(mutual TLS) when the node has one.
"""

from __future__ import annotations

import asyncio
import json
import logging

from fabric_tpu_torch import protoutil
from fabric_tpu_torch.comm.rpc import RpcClient
from fabric_tpu_torch.crypto.msp import verify_signature
from fabric_tpu_torch.ledger.pvtdata import decode_kv, encode_kv
from fabric_tpu_torch.ledger.rwset import TxRWSet
from fabric_tpu_torch.ledger.statedb import UpdateBatch
from fabric_tpu_torch.peer.coordinator import _match_cleartext
from fabric_tpu_torch.protos import messages as m

log = logging.getLogger("fabric_tpu_torch.gossip")


def _enc_cleartext(cleartext: dict) -> dict:
    return {
        f"{ns}\x00{coll}": {
            k: (v.hex() if v is not None else None) for k, v in kv.items()
        }
        for (ns, coll), kv in cleartext.items()
    }


def _dec_cleartext(data: dict) -> dict:
    out = {}
    for nscoll, kv in data.items():
        ns, _, coll = nscoll.partition("\x00")
        out[(ns, coll)] = {
            k: (bytes.fromhex(v) if v is not None else None)
            for k, v in kv.items()
        }
    return out


class GossipService:
    def __init__(self, node):
        self.node = node
        self._tasks: list[asyncio.Task] = []
        self._clients: dict[tuple, RpcClient] = {}
        # what dissemination did, for the operator's log:
        # pushes/acks by collection, pulls served/received, entries
        # reconciled, blocks anti-entropy committed
        self.stats = {"pushes": {}, "acks": {}, "pulls": 0, "pulled": 0,
                      "reconciled": 0, "ae_blocks": 0}

    # -- wiring ------------------------------------------------------------

    def register(self) -> "GossipService":
        s = self.node.server
        s.register_unary("GossipPing", self._on_ping)
        s.register_unary("PvtPush", self._on_pvt_push)
        s.register_unary("PvtPull", self._on_pvt_pull)
        for chan in self.node.channels.values():
            chan.pvt_puller = self.pull_pvt_for(chan.id)
        return self

    def _ssl(self):
        tls = getattr(self.node, "tls", None)
        return tls.client_ctx() if tls else None

    async def _client(self, host, port) -> RpcClient:
        key = (host, port)
        cli = self._clients.get(key)
        if cli is None or cli.conn is None or cli.conn.closed.is_set():
            cli = RpcClient(host, port, ssl_ctx=self._ssl())
            await cli.connect()
            self._clients[key] = cli
        return cli

    async def stop(self):
        for t in self._tasks:
            t.cancel()
        for cli in self._clients.values():
            try:
                await cli.close()
            except (OSError, RuntimeError):
                pass  # peer already gone

    # -- membership --------------------------------------------------------

    async def _on_ping(self, req: bytes) -> bytes:
        return json.dumps({
            "alive": True,
            "id": self.node.id,
            "heights": {cid: ch.height for cid, ch in self.node.channels.items()},
        }).encode()

    async def probe_members(self) -> dict:
        """Ping every registered peer; refresh alive/height state —
        a failed probe marks the peer DEAD (the reference's alive/dead
        expiration, gossip/discovery/discovery_impl.go) so election
        and dissemination stop counting on it.
        → {(host, port): ping-result | None}."""
        out = {}
        loop = asyncio.get_event_loop()
        for org, peers in self.node.registry.peers.items():
            for p in peers:
                try:
                    cli = await self._client(p.host, p.port)
                    raw = await asyncio.wait_for(
                        cli.unary("GossipPing", b"{}"), 3.0
                    )
                    res = json.loads(raw)
                    p.heights = dict(res.get("heights", {}))
                    p.height = max(p.heights.values(), default=0)
                    p.alive = True
                    p.last_seen = loop.time()
                    out[(p.host, p.port)] = res
                except Exception:
                    p.alive = False
                    self._clients.pop((p.host, p.port), None)
                    out[(p.host, p.port)] = None
        return out

    def elect_leader(self, my_org_peers: list, my_endpoint: tuple) -> bool:
        """Deterministic org-leader election: lowest (host, port) among
        ALIVE org peers + self wins (gossip/election analog).  Peers
        whose last probe failed are excluded — a dead lowest-endpoint
        peer must not win forever."""
        candidates = [my_endpoint] + [
            (p.host, p.port) for p in my_org_peers if p.alive is not False
        ]
        return min(candidates) == my_endpoint

    # -- pvtdata dissemination --------------------------------------------

    def _my_org(self) -> str | None:
        signer = getattr(self.node, "signer", None)
        return getattr(signer, "msp_id", None)

    @staticmethod
    def _members(chan, ns: str, coll: str, own_org: str | None) -> set:
        """Eligible orgs for a collection (distributor.go:180-235
        AccessFilter).  An UNDEFINED collection is maximally private:
        only the endorsing org itself may hold the cleartext — never
        'everyone', which would void the confidentiality feature."""
        cfg = chan.collection_config(ns, coll) if chan is not None else None
        if cfg is None:
            return {own_org} if own_org else set()
        return set(cfg.get("member_orgs", []))

    async def _on_pvt_push(self, req: bytes) -> bytes:
        q = json.loads(req)
        chan = self.node.channels.get(q["channel"])
        if chan is None:
            return b'{"status": 404}'
        # receiver-side eligibility: never STORE cleartext this org is
        # not a collection member of, whatever the sender claims
        my = self._my_org()
        data = {
            (ns, coll): kv
            for (ns, coll), kv in _dec_cleartext(q["data"]).items()
            if my in self._members(chan, ns, coll, my)
        }
        if not data:
            return b'{"status": 403}'
        chan.transient.persist(q["txid"], data, int(q.get("height", 0)))
        return b'{"status": 200}'

    @staticmethod
    def _pull_signable(q: dict) -> bytes:
        core = {k: v for k, v in q.items() if k not in ("sig",)}
        return json.dumps(core, sort_keys=True).encode()

    def _pull_caller_ok(self, chan, q: dict) -> None:
        """Raises unless the pull is signed by a valid channel member of
        a collection member org (pull.go access checks)."""
        ident = chan.validator.msp.deserialize_identity(bytes.fromhex(q["identity"]))
        if not ident.is_valid:
            raise ValueError("invalid identity")
        if not verify_signature(ident, self._pull_signable(q), bytes.fromhex(q["sig"])):
            raise ValueError("bad signature")
        if ident.msp_id not in self._members(chan, q["ns"], q["coll"], self._my_org()):
            raise ValueError("org not a collection member")

    async def _on_pvt_pull(self, req: bytes) -> bytes:
        q = json.loads(req)
        chan = self.node.channels.get(q["channel"])
        if chan is None:
            return b'{"status": 404}'
        ns, coll = q["ns"], q["coll"]
        # caller eligibility: the pull is signed by the requesting
        # peer's identity; the host signature check runs in a worker
        # thread so the loop keeps serving
        try:
            await asyncio.get_event_loop().run_in_executor(
                None, self._pull_caller_ok, chan, q)
        except Exception as e:
            log.debug("pvt pull refused: %s", e)
            return b'{"status": 403}'
        # transient store first (endorsement-time data)
        clear = chan.transient.get(q["txid"]).get((ns, coll))
        if clear is None and "block" in q:
            stored = chan.ledger.pvtdata.get_pvt_data(int(q["block"])).get(
                (int(q["txnum"]), ns, coll)
            )
            if stored is not None:
                clear = decode_kv(stored)
        if clear is None:
            return b'{"status": 404}'
        self.stats["pulls"] += 1
        return json.dumps({
            "status": 200,
            "data": {k: (v.hex() if v is not None else None)
                     for k, v in clear.items()},
        }).encode()

    async def push_pvt(self, channel: str, txid: str, cleartext: dict,
                       height: int) -> None:
        """Distribute endorsement-time pvt data to ELIGIBLE peers only
        (distributor.go:180-235: AccessFilter + required/maximum peer
        counts): per collection, push to member-org peers up to
        max_peer_count; fewer than required_peer_count successful
        deliveries is logged as a dissemination shortfall."""
        chan = self.node.channels.get(channel)
        my = self._my_org()
        for (ns, coll), kv in cleartext.items():
            members = self._members(chan, ns, coll, my)
            cfg = chan.collection_config(ns, coll) if chan else None
            max_peers = int((cfg or {}).get("max_peer_count", 0) or 0)
            required = int((cfg or {}).get("required_peer_count", 0) or 0)
            if cfg is not None and max_peers == 0:
                # maximumPeerCount 0 means NO endorsement-time
                # dissemination (reconciliation-only delivery), not
                # "unlimited" (pvtdata/distributor.go contract)
                if required > 0:
                    # misconfigured (reference rejects max < required
                    # at definition time): surface the zero-push risk
                    log.warning(
                        "collection %s/%s requires %d peers but "
                        "max_peer_count=0 disables eager push — "
                        "skipping dissemination", ns, coll, required,
                    )
                continue
            # alive members first (probe liveness); max_peer_count caps
            # SUCCESSFUL deliveries, not attempts — a dead peer must
            # not consume the cap while a live member goes untried
            targets = sorted(
                (p for org, peers in self.node.registry.peers.items()
                 if org in members for p in peers),
                key=lambda p: (p.alive is False, p.host, p.port),
            )
            payload = json.dumps({
                "channel": channel, "txid": txid, "height": height,
                "data": _enc_cleartext({(ns, coll): kv}),
            }).encode()
            acks = 0
            for p in targets:
                if max_peers > 0 and acks >= max_peers:
                    break
                try:
                    cli = await self._client(p.host, p.port)
                    self.stats["pushes"][coll] = self.stats["pushes"].get(coll, 0) + 1
                    res = json.loads(await asyncio.wait_for(
                        cli.unary("PvtPush", payload), 3.0
                    ))
                    if res.get("status") == 200:
                        acks += 1
                        self.stats["acks"][coll] = self.stats["acks"].get(coll, 0) + 1
                except Exception as e:
                    log.debug("pvt push to %s:%s failed: %s", p.host, p.port, e)
            if acks < required:
                log.warning(
                    "pvt dissemination shortfall for %s/%s: %d acks, "
                    "required %d", ns, coll, acks, required,
                )

    def pull_pvt_for(self, channel: str):
        signer = getattr(self.node, "signer", None)

        async def pull(txid, block_num, txnum, ns, coll):
            q = {
                "channel": channel, "txid": txid, "block": block_num,
                "txnum": txnum, "ns": ns, "coll": coll,
            }
            if signer is not None:
                q["identity"] = signer.serialized.hex()
                # the host signature (ec_ref) runs in a worker thread
                sig = await asyncio.get_event_loop().run_in_executor(
                    None, signer.sign, self._pull_signable(q))
                q["sig"] = sig.hex()
            req = json.dumps(q).encode()
            for org, peers in self.node.registry.peers.items():
                for p in peers:
                    try:
                        cli = await self._client(p.host, p.port)
                        raw = await asyncio.wait_for(
                            cli.unary("PvtPull", req), 3.0
                        )
                        res = json.loads(raw)
                        if res.get("status") == 200:
                            self.stats["pulled"] += 1
                            return {
                                k: (bytes.fromhex(v) if v is not None else None)
                                for k, v in res["data"].items()
                            }
                    except Exception as e:
                        log.debug("pvt pull from peer failed: %s", e)
                        continue
            return None

        return pull

    # -- anti-entropy state transfer ---------------------------------------

    async def _pull_blocks_from_peer(self, chan, host, port, stop_at: int):
        cli = RpcClient(host, port, ssl_ctx=self._ssl())
        await cli.connect()
        try:
            stream = await cli.open_stream("DeliverBlocks")
            await stream.send(json.dumps({
                "channel": chan.id, "start": chan.height, "stop": stop_at,
            }).encode())
            async for raw in stream:
                blk = m.Block.parse(raw)
                if blk.header.number < chan.height:
                    continue
                await chan.commit_block(blk)
                self.stats["ae_blocks"] += 1
        finally:
            await cli.close()

    def start_anti_entropy(self, channel: str, interval: float = 1.0):
        """Per-channel catch-up loop (state.go:584 antiEntropy): probe
        members; when behind, pull the missing range from the peer
        that has it.

        Anti-entropy commits through ``commit_block`` concurrently
        with the deliver driver, so the channel is pinned to SERIAL
        commit mode: a depth-2 deliver pipeline validates outside the
        commit lock, and a concurrent anti-entropy commit would race
        its state reads (and collide at the ledger with in-flight
        heights).  Serializing both paths through the writer lock is
        the safe composition."""
        chan = self.node.channels[channel]
        chan.pipeline_depth = 1

        async def loop():
            while True:
                try:
                    await asyncio.sleep(interval)
                    await self.probe_members()
                    best, best_h = None, chan.height
                    for org, peers in self.node.registry.peers.items():
                        for p in peers:
                            ph = p.heights.get(channel, 0)
                            if ph > best_h:
                                best, best_h = p, ph
                    if best is not None:
                        await self._pull_blocks_from_peer(
                            chan, best.host, best.port, best_h - 1
                        )
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    log.debug("anti-entropy %s: %s", channel, e)

        task = asyncio.ensure_future(loop())
        self._tasks.append(task)
        return task

    def start_reconciler(self, channel: str, interval: float = 2.0):
        """Background pvtdata reconciler (reconcile.go): retry pulling
        collections recorded missing at commit time."""
        chan = self.node.channels[channel]
        pull = self.pull_pvt_for(channel)

        async def loop():
            while True:
                try:
                    await asyncio.sleep(interval)
                    missing = chan.ledger.pvtdata.missing_data(chan.height)
                    for block, txnum, ns, coll in missing:
                        blk = chan.ledger.blocks.get_block(block)
                        if blk is None:
                            continue
                        got = await pull("", block, txnum, ns, coll)
                        if got is None:
                            continue
                        ok = self._verify_and_apply(
                            chan, blk, block, txnum, ns, coll, got
                        )
                        if ok:
                            self.stats["reconciled"] += 1
                            log.info(
                                "reconciled pvt (%d,%d,%s,%s)",
                                block, txnum, ns, coll,
                            )
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    log.debug("reconciler %s: %s", channel, e)

        task = asyncio.ensure_future(loop())
        self._tasks.append(task)
        return task

    def _verify_and_apply(self, chan, blk, block, txnum, ns, coll, clear) -> bool:
        """Hash-verify pulled data against the committed block's rwset,
        then commit it to pvt state + pvtdata store."""
        try:
            env = m.Envelope.parse(blk.data.data[txnum])
            _, _, cap, prp, cca = protoutil.extract_action(env)
            rw = TxRWSet.from_bytes(cca.results)
        except Exception:
            return False
        writes = rw.ns.get(ns, None)
        if writes is None:
            return False
        hashed = writes.hashed.get(coll, {}).get("writes", {})
        kv = _match_cleartext(hashed, clear)
        if kv is None:
            return False
        batch = UpdateBatch()
        for key, value in kv.items():
            if value is None:
                batch.delete(f"{ns}${coll}", key, (block, txnum))
            else:
                batch.put(f"{ns}${coll}", key, value, (block, txnum))
        chan.ledger.state.apply_updates(batch, None)
        chan.ledger.pvtdata.resolve_missing(block, txnum, ns, coll, encode_kv(kv))
        return True
