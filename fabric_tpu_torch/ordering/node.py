"""Orderer node assembly: registrar + RPC services (counterpart:
``fabric_tpu/ordering/node.py``).

The analog of orderer/common/server/main.go:69-222 plus the
multichannel registrar (registrar.go:93): one process hosts N
channels, each with its own Raft or BFT chain (``consensus=``; BFT
takes the node's ``signer`` and the consenters' ``verifiers``);
exposed services:

* ``Broadcast``  — submit an envelope to a channel (unary; non-leader
  answers 503 with a leader hint and the client retries there).
* ``Deliver``    — stream blocks from a seek position (server-stream).
* ``Step``       — orderer↔orderer Raft/BFT transport (fire-and-forget
  messages; the cluster-comm analog, orderer/common/cluster/comm.go).
* ``Join``       — channel participation: create a chain from a
  genesis block (channelparticipation/restapi.go analog).
* ``Info``       — a channel's height, raft state and leader.

Wire format: tiny JSON headers + raw envelope/block bytes — the
content payloads themselves are the canonical protos.  Method names and
framing are the reference's, so either package's clients talk to
either package's node.  ``tls`` (a ``comm/rpc.py::TlsProfile``) puts
mutual TLS on the listener and on every orderer-to-orderer dial;
``start(operations_port=)`` serves ``opsserver.py`` with the
``consensus`` health check.
"""

from __future__ import annotations

import asyncio
import json
import logging
import random

from fabric_tpu_torch.comm.rpc import RpcClient, RpcServer
from fabric_tpu_torch.ordering.blockcutter import BatchConfig
from fabric_tpu_torch.ordering.chain import MsgProcessor, OrderingChain
from fabric_tpu_torch.protos import messages as m

_log = logging.getLogger("fabric_tpu_torch.orderer")


class OrdererNode:
    def __init__(self, node_id: str, data_dir: str,
                 cluster: dict[str, tuple[str, int]],
                 host: str = "127.0.0.1", port: int = 0,
                 batch_config: BatchConfig | None = None,
                 msp_manager=None, consensus: str = "raft",
                 signer=None, verifiers=None, view_timeout: float = 2.0,
                 tls=None, rng: random.Random | None = None):
        self.id = node_id
        self.dir = data_dir
        self.cluster = dict(cluster)  # node_id -> (host, port)
        self.host, self.port = host, port
        self.batch_config = batch_config or BatchConfig()
        self.msp = msp_manager
        self.consensus = consensus
        self.broadcast_rate = 0.0  # msgs/s per channel; 0 = unthrottled
        self._throttle: dict[str, list] = {}  # channel -> [tokens, last_ts]
        self.signer = signer
        # BFT: {consenter id: identity} the chains verify messages by,
        # and the replicas' no-progress timeout before a view change
        self.verifiers = verifiers or {}
        self.view_timeout = view_timeout
        # the election timers' draws (raft.py): one generator for the
        # node's chains, which a caller may seed
        self.rng = rng if rng is not None else random.Random()
        self.chains: dict[str, OrderingChain] = {}
        self.tls = tls  # comm.rpc.TlsProfile: mTLS on every surface
        self.server = RpcServer(host, port, ssl_ctx=tls.server_ctx() if tls else None)
        self.operations = None
        self._peer_clients: dict[str, asyncio.Task] = {}
        self._bg: set = set()  # strong refs: GC destroys weakly-held tasks

    # -- raft transport -------------------------------------------------------

    def _send(self, channel: str):
        def send(peer_id: str, msg: dict):
            t = asyncio.ensure_future(self._send_async(peer_id, channel, msg))
            self._bg.add(t)
            t.add_done_callback(self._bg.discard)
        return send

    async def _peer_client(self, peer_id: str) -> RpcClient:
        """Connect-once per peer: the dict holds a Task so concurrent
        senders (a heartbeat round fans out) share ONE connection
        instead of racing to create and leak several."""
        task = self._peer_clients.get(peer_id)
        if task is None:
            addr = self.cluster[peer_id]

            async def connect():
                return await RpcClient(
                    *addr, ssl_ctx=self.tls.client_ctx() if self.tls else None).connect()

            task = asyncio.ensure_future(connect())
            self._peer_clients[peer_id] = task
        return await asyncio.shield(task)

    async def _send_async(self, peer_id: str, channel: str, msg: dict):
        if peer_id not in self.cluster:
            return
        try:
            cli = await self._peer_client(peer_id)
            st = await cli.open_stream("Step")
            await st.send(json.dumps({"channel": channel, "msg": msg}).encode())
            await st.end()
            st.dispose()  # fire-and-forget: the peer never answers
        except (OSError, ConnectionError):
            task = self._peer_clients.pop(peer_id, None)
            if task is not None and task.done() and not task.cancelled():
                try:
                    cli = task.result()
                except Exception:
                    cli = None
                if cli is not None:
                    try:
                        await cli.close()
                    except (OSError, RuntimeError):
                        pass  # peer already gone

    # -- channel lifecycle ------------------------------------------------------

    def join_channel(self, channel_id: str, genesis_block: m.Block | None = None,
                     start: bool = True) -> OrderingChain:
        if channel_id in self.chains:
            return self.chains[channel_id]
        # broadcast signature filter: with a genesis config the channel
        # Writers policy gates every submitted envelope (sigfilter,
        # orderer/common/msgprocessor/standardchannel.go:100); dev
        # channels without a genesis degrade to size-only admission
        msgproc = MsgProcessor(self.batch_config, self.msp)
        if genesis_block is not None:
            try:
                from fabric_tpu_torch.channelconfig import bundle_from_genesis

                bundle = bundle_from_genesis(channel_id, genesis_block)
                msgproc = MsgProcessor(
                    self.batch_config, bundle.msp_manager,
                    policy_eval=lambda sds: bundle.policy_manager.evaluate("/Channel/Writers",
                                                                          sds))
            except Exception:
                _log.exception("%s: genesis config unusable for the broadcast signature "
                               "filter on %s — size-only admission", self.id, channel_id)
        chain = OrderingChain(
            channel_id, self.id, list(self.cluster), data_dir=f"{self.dir}/{channel_id}",
            send_cb=self._send(channel_id), config=self.batch_config, msgproc=msgproc,
            genesis_block=genesis_block, consensus=self.consensus, signer=self.signer,
            verifiers=self.verifiers, view_timeout=self.view_timeout, block_puller=self._pull_blocks, on_consenters=self._on_consenters, rng=self.rng)
        self.chains[channel_id] = chain
        if start:
            chain.start()
        return chain

    def _on_consenters(self, addr_map: dict) -> None:
        """Committed consenter-set change: make new members reachable.
        The cluster map is NODE-wide (shared by every channel this
        registrar hosts), so entries are only added/updated here —
        per-channel membership exclusion happens in each chain's
        update_peers, never by dropping another channel's transport."""
        for nid, addr in addr_map.items():
            self.cluster[nid] = tuple(addr)

    async def _pull_blocks(self, channel: str, start: int, stop: int):
        """Pull serialized blocks [start, stop] from ANY cluster peer's
        Deliver — the follower-chain catch-up source
        (orderer/common/follower/follower_chain.go)."""
        hdr = json.dumps({"channel": channel, "start": start, "stop": stop}).encode()
        for peer_id in list(self.cluster):
            if peer_id == self.id:
                continue
            try:
                cli = await self._peer_client(peer_id)
                st = await cli.open_stream("Deliver")
                await st.send(hdr)
                got = False
                async for raw in st:
                    got = True
                    yield raw
                if got:
                    return
            except Exception as e:
                _log.debug("block pull from %s failed: %s", peer_id, e)
                continue

    # -- services -----------------------------------------------------------------

    async def start(self, operations_port: int | None = None):
        self.server.register_unary("Broadcast", self._on_broadcast)
        self.server.register("Deliver", self._on_deliver)
        self.server.register("Step", self._on_step)
        self.server.register_unary("Join", self._on_join)
        self.server.register_unary("Info", self._on_info)
        await self.server.start()
        self.port = self.server.port
        if operations_port is not None:
            from fabric_tpu_torch.opsserver import HealthRegistry, OperationsServer

            health = HealthRegistry()

            def _chains():  # evaluated per check: covers late joins
                for cid, chain in self.chains.items():
                    if chain.raft.state not in ("leader", "follower", "candidate"):
                        return f"consensus {cid} stopped"
                return None

            health.register("consensus", _chains)
            self.operations = await OperationsServer(port=operations_port,
                                                     health=health).start()
        return self

    async def stop(self):
        if self.operations is not None:
            await self.operations.stop()
        for chain in self.chains.values():
            chain.stop()
        for task in self._peer_clients.values():
            if task.done() and not task.cancelled():
                try:
                    await task.result().close()
                except (OSError, RuntimeError):
                    pass  # already closed
            else:
                task.cancel()
        await self.server.stop()

    def _throttled(self, channel: str) -> bool:
        """Token-bucket broadcast rate limit per channel
        (orderer/common/throttle/ratelimit.go)."""
        if self.broadcast_rate <= 0:
            return False
        now = asyncio.get_event_loop().time()
        cap = max(1.0, self.broadcast_rate)  # rates < 1/s must still pass
        bucket = self._throttle.setdefault(channel, [cap, now])
        tokens, last = bucket
        tokens = min(cap, tokens + (now - last) * self.broadcast_rate)
        if tokens < 1.0:
            bucket[0], bucket[1] = tokens, now
            return True
        bucket[0], bucket[1] = tokens - 1.0, now
        return False

    async def _on_broadcast(self, req: bytes) -> bytes:
        hdr_len = int.from_bytes(req[:4], "big")
        hdr = json.loads(req[4:4 + hdr_len])
        env = req[4 + hdr_len:]
        chain = self.chains.get(hdr["channel"])
        if chain is None:
            return json.dumps({"status": 404, "info": "no such channel"}).encode()
        if self._throttled(hdr["channel"]):
            return json.dumps({"status": 429, "info": "broadcast rate limit"}).encode()
        res = await chain.broadcast(env)
        if res.get("leader") and res["leader"] in self.cluster:
            res["leader_addr"] = list(self.cluster[res["leader"]])
        return json.dumps(res).encode()

    async def _on_deliver(self, stream):
        req = await stream.__anext__()
        hdr = json.loads(req)
        chain = self.chains.get(hdr["channel"])
        if chain is None:
            await stream.error("no such channel")
            return
        async for blk in chain.deliver(hdr.get("start", 0), hdr.get("stop")):
            await stream.send(blk)
        await stream.end()

    async def _on_step(self, stream):
        async for payload in stream:
            msg = json.loads(payload)
            chain = self.chains.get(msg["channel"])
            if chain is not None:
                chain.raft.handle(msg["msg"])

    async def _on_join(self, req: bytes) -> bytes:
        hdr_len = int.from_bytes(req[:4], "big")
        hdr = json.loads(req[4:4 + hdr_len])
        blk_bytes = req[4 + hdr_len:]
        self.join_channel(hdr["channel"], m.Block.parse(blk_bytes) if blk_bytes else None)
        return json.dumps({"status": 201}).encode()

    async def _on_info(self, req: bytes) -> bytes:
        hdr = json.loads(req)
        chain = self.chains.get(hdr["channel"])
        if chain is None:
            return json.dumps({"status": 404}).encode()
        return json.dumps({"status": 200, "height": chain.height, "state": chain.raft.state,
                           "leader": chain.raft.leader_id}).encode()


class BroadcastClient:
    """Client-side submit with leader-redirect retry (the SDK-facing
    behavior the reference gets from leader forwarding).  Concurrent
    broadcasts share one connection an endpoint: the dict holds the
    connecting task, so callers racing on a first use await the same
    one (the reference's client is used by one caller at a time)."""

    def __init__(self, endpoints: list[tuple[str, int]], ssl_ctx=None):
        self.endpoints = list(endpoints)
        self.ssl_ctx = ssl_ctx
        self._clients: dict[tuple[str, int], asyncio.Task] = {}

    async def _client(self, addr) -> RpcClient:
        addr = tuple(addr)
        task = self._clients.get(addr)
        if task is None:
            task = asyncio.ensure_future(RpcClient(*addr, ssl_ctx=self.ssl_ctx).connect())
            self._clients[addr] = task
        return await asyncio.shield(task)

    async def broadcast(self, channel: str, env_bytes: bytes, retries: int = 20) -> dict:
        hdr = json.dumps({"channel": channel}).encode()
        req = len(hdr).to_bytes(4, "big") + hdr + env_bytes
        last = {"status": 503, "info": "no endpoints"}
        hint = None  # leader address learned from the last redirect
        for attempt in range(retries):
            addr = hint or self.endpoints[attempt % len(self.endpoints)]
            hint = None
            try:
                cli = await self._client(addr)
                resp = json.loads(await cli.unary("Broadcast", req, timeout=15))
            except Exception as e:  # connection refused / reset / rpc error
                self._clients.pop(tuple(addr), None)
                last = {"status": 503, "info": str(e)}
                await asyncio.sleep(0.1)
                continue
            if resp["status"] == 200:
                return resp
            if 400 <= resp["status"] < 500 and resp["status"] != 429:
                return resp  # deterministic rejection — retrying can't help
            if resp["status"] == 429:  # backpressure: retry after a beat
                last = resp
                await asyncio.sleep(0.1 * min(attempt + 1, 6))
                continue
            if resp.get("leader_addr"):
                hint = tuple(resp["leader_addr"])
            last = resp
            if resp["status"] == 503:
                await asyncio.sleep(0.05 * min(attempt + 1, 6))
        return last

    async def close(self):
        for task in self._clients.values():
            if task.done() and not task.cancelled() and task.exception() is None:
                await task.result().close()
            else:
                task.cancel()
        self._clients = {}


class DeliverClient:
    """Pull a block stream from an orderer (peer side)."""

    def __init__(self, host: str, port: int, ssl_ctx=None):
        self.addr = (host, port)
        self.ssl_ctx = ssl_ctx

    async def blocks(self, channel: str, start: int = 0, stop: int | None = None):
        cli = RpcClient(*self.addr, ssl_ctx=self.ssl_ctx)
        await cli.connect()
        try:
            st = await cli.open_stream("Deliver")
            await st.send(json.dumps({"channel": channel, "start": start,
                                      "stop": stop}).encode())
            async for payload in st:
                yield m.Block.parse(payload)
        finally:
            await cli.close()
