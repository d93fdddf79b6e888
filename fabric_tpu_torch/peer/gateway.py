"""Gateway service: the v2.4+ single-endpoint transaction API
(counterpart: ``fabric_tpu/peer/gateway.py``; the same method names and
framing, so either package's client talks to either package's peer).

Reference: internal/pkg/gateway — Evaluate (endorse.go sibling,
evaluate.go:23), Endorse (endorse.go:170, returns a PREPARED
transaction for the client to sign — the gateway never holds client
keys), Submit (submit.go:31, orderer broadcast incl. retry over the
orderer set), CommitStatus (commitstatus.go:26, ledger commit
notifications), ChaincodeEvents (event stream from committed blocks).

The endorsement plan comes from the discovery layouts
(``discovery.layouts_for_policy`` == discovery/endorsement/
endorsement.go:84 PeersForEndorsement); per-org peers come from the
node's PeerRegistry.  The tx-flow journal (``observe/txflow.py``) is
stamped at the reference's sites: endorse begin/end, submit, broadcast.
"""

from __future__ import annotations

import asyncio
import json
import logging

from fabric_tpu_torch import protoutil
from fabric_tpu_torch.comm.rpc import RpcClient
from fabric_tpu_torch.discovery import layouts_for_policy
from fabric_tpu_torch.observe import txflow as _txflow
from fabric_tpu_torch.ordering.node import BroadcastClient
from fabric_tpu_torch.peer import txassembly as txa
from fabric_tpu_torch.peer.endorser import response_status
from fabric_tpu_torch.peer.txcodes import TxValidationCode
from fabric_tpu_torch.protos import messages as m

_log = logging.getLogger("fabric_tpu_torch.gateway")


class GatewayError(Exception):
    def __init__(self, status: int, msg: str):
        super().__init__(msg)
        self.status = status


def _envelope_tx_id(env_bytes: bytes) -> str:
    """tx_id from a signed Envelope's channel header, for the tx-flow
    submit/broadcast stamps — contained: an unparsable envelope is the
    orderer's problem to reject, not the journal's."""
    try:
        return protoutil.channel_header(env_bytes).tx_id
    except Exception:
        return ""


def _message(pr: m.ProposalResponse) -> str:
    return pr.response.message if pr.response is not None else ""


class Gateway:
    """Bound to one PeerNode; registered on its RPC server.  Submit keeps
    one ``BroadcastClient`` a channel (its connections reused across
    submits; the reference opens one a submit), closed by ``close``."""

    def __init__(self, node):
        self.node = node
        self._broadcast: dict[str, BroadcastClient] = {}

    async def close(self) -> None:
        clients, self._broadcast = self._broadcast, {}
        for cli in clients.values():
            await cli.close()

    # -- helpers -----------------------------------------------------------

    def _ssl(self):
        """The node's mTLS client context for its dials, None without TLS."""
        tls = getattr(self.node, "tls", None)
        return tls.client_ctx() if tls else None

    def _parse_proposal(self, req: bytes):
        signed = m.SignedProposal.parse(req)
        prop = m.Proposal.parse(signed.proposal_bytes)
        ch = m.ChannelHeader.parse(m.Header.parse(prop.header).channel_header)
        ext = m.ChaincodeHeaderExtension.parse(ch.extension)
        chan = self.node.channels.get(ch.channel_id)
        if chan is None:
            raise GatewayError(404, f"not joined to {ch.channel_id}")
        return signed, prop, ch, (ext.chaincode_id or m.ChaincodeID()).name, chan

    async def _endorse_local(self, chan, signed):
        # endorse_signer: the node's card sign lane when sign_device
        # armed one — concurrent client streams then fill p256_sign
        # launches; the serial signer otherwise (bit-equal signatures
        # either way, RFC 6979)
        endorser = chan.make_endorser(self.node.msp, self.node.endorse_signer,
                                      self.node.runtime)
        loop = asyncio.get_event_loop()
        async with chan.commit_lock.reader():
            return await loop.run_in_executor(None, endorser.process_proposal, signed)

    async def _endorse_remote(self, host, port, req: bytes):
        """One remote Endorse RPC; transport/parse failures surface as
        a retryable GatewayError(503) so the layout loop fails over to
        the next layout instead of tearing the whole Endorse down."""
        try:
            cli = RpcClient(host, port, ssl_ctx=self._ssl())
            await cli.connect()
            try:
                raw = await cli.unary("Endorse", req)
            finally:
                await cli.close()
            return m.ProposalResponse.parse(raw)
        except Exception as e:
            raise GatewayError(503, f"remote endorse {host}:{port} failed: {e}") from e

    # -- service methods ---------------------------------------------------

    async def evaluate(self, req: bytes) -> bytes:
        """Run the proposal on THIS peer; return the chaincode Response
        (no ordering) — read-only queries."""
        signed, _, _, _, chan = self._parse_proposal(req)
        pr = (await self._endorse_local(chan, signed)).response
        if response_status(pr) >= 400 or not pr.payload:
            return (pr.response or m.Response()).serialize()
        # the chaincode's Response lives inside prp.extension
        prp = m.ProposalResponsePayload.parse(pr.payload)
        cca = m.ChaincodeAction.parse(prp.extension)
        return (cca.response or m.Response()).serialize()

    async def endorse(self, req: bytes) -> bytes:
        """Collect endorsements per the discovery layout; return the
        PREPARED transaction payload for the client to sign.

        Endorsement failures (simulation errors, a 429 from a full
        sign batcher, remote transport failures wrapped as 503) fail
        the CURRENT layout and the loop tries the next one; when no
        layout survives, the last error propagates."""
        signed, prop, ch, cc_name, chan = self._parse_proposal(req)
        # tx-flow journal: the endorse stage opens the per-tx record
        _txflow.endorse_begin(ch.tx_id)
        try:
            payload = await self._endorse_inner(req, signed, prop, cc_name, chan)
        except BaseException:
            _txflow.endorse_end(ch.tx_id, ok=False)
            raise
        _txflow.endorse_end(ch.tx_id)
        return payload

    async def _endorse_inner(self, req, signed, prop, cc_name, chan) -> bytes:
        info = chan.validator.policies.info(cc_name)
        if info is None:
            raise GatewayError(404, f"no validation info for {cc_name}")
        layouts = layouts_for_policy(info.policy)
        my_org = self.node.signer.msp_id
        responses = []
        last_err = None
        local_res = None  # simulate locally ONCE across layout attempts
        for layout in sorted(layouts, key=lambda lay: (my_org not in lay, sum(lay.values()))):
            try:
                responses = []
                for org, count in sorted(layout.items()):
                    if org == my_org:
                        if local_res is None:
                            local_res = await self._endorse_local(chan, signed)
                        pr = local_res.response
                        if response_status(pr) >= 400:
                            raise GatewayError(response_status(pr), _message(pr))
                        responses.append(pr)
                        count -= 1
                    peers = self.node.registry.for_org(org)
                    if count > len(peers):
                        raise GatewayError(503, f"not enough peers for {org}")
                    for p in peers[:count]:
                        pr = await self._endorse_remote(p.host, p.port, req)
                        if response_status(pr) >= 400:
                            raise GatewayError(response_status(pr), _message(pr))
                        responses.append(pr)
                break
            except GatewayError as e:
                last_err = e
                responses = []
        if not responses:
            raise last_err or GatewayError(503, "no viable endorsement layout")
        return txa.prepare_transaction(prop, responses)

    async def submit(self, req: bytes) -> bytes:
        """req: JSON{channel} ‖ 0x00 ‖ signed Envelope bytes → orderer
        broadcast with failover across the channel's orderer set."""
        hdr, env_bytes = req.split(b"\x00", 1)
        channel = json.loads(hdr)["channel"]
        chan = self.node.channels.get(channel)
        if chan is None:
            raise GatewayError(404, f"not joined to {channel}")
        addrs = chan.orderer_addrs
        if not addrs:
            raise GatewayError(503, "no orderers known for channel")
        # the envelope parse to recover tx_id is only paid when the
        # journal is armed
        tx_id = _envelope_tx_id(env_bytes) if _txflow.enabled() else ""
        if tx_id:
            _txflow.submit_begin(tx_id)
        cli = self._broadcast.get(channel)
        if cli is None or cli.endpoints != list(addrs):
            cli = self._broadcast[channel] = BroadcastClient(list(addrs),
                                                             ssl_ctx=self._ssl())
        res = await cli.broadcast(channel, env_bytes)
        if res.get("status") != 200:
            raise GatewayError(res.get("status", 500), res.get("info", "broadcast failed"))
        if tx_id:
            _txflow.broadcast_done(tx_id)
        return json.dumps({"status": 200}).encode()

    async def commit_status(self, req: bytes) -> bytes:
        """req: JSON{channel, tx_id, timeout?} → {code, block} once the
        tx commits (ledger commit notification analog).  ``applied`` is
        the read-your-writes bit (state apply has passed the tx's
        block), beside the channel's ``durable_height`` and
        ``applied_height``."""
        q = json.loads(req)
        chan = self.node.channels.get(q["channel"])
        if chan is None:
            raise GatewayError(404, f"not joined to {q['channel']}")
        loop = asyncio.get_event_loop()
        deadline = loop.time() + float(q.get("timeout", 30.0))
        txid = q["tx_id"]
        while True:
            loc = chan.ledger.blocks.get_tx_loc(txid)
            if loc is not None:
                num, _txnum, code = loc
                ledger = chan.ledger
                if ledger.engine is not None:
                    applied_height = int(ledger.engine.stats().get("applied_num", -1)) + 1
                else:
                    # serial commit: state apply completes inside
                    # commit_block, so applied tracks block height
                    applied_height = int(ledger.blocks.height)
                return json.dumps({
                    "tx_id": txid, "code": int(code), "block": int(num),
                    "code_name": TxValidationCode(int(code)).name,
                    "applied": applied_height > int(num), "applied_height": applied_height,
                    "durable_height": int(ledger.blocks.synced_height)}).encode()
            remaining = deadline - loop.time()
            if remaining <= 0:
                raise GatewayError(408, f"timeout waiting for {txid}")
            try:
                await asyncio.wait_for(chan._height_changed.wait(), remaining)
            except asyncio.TimeoutError:
                raise GatewayError(408, f"timeout waiting for {txid}") from None

    async def chaincode_events(self, stream):
        """stream request: JSON{channel, chaincode, start?} → one JSON
        event per message from committed VALID txs."""
        req = json.loads(await stream.__anext__())
        chan = self.node.channels.get(req["channel"])
        if chan is None:
            await stream.error("no such channel")
            return
        want_cc = req["chaincode"]
        num = int(req.get("start", 0))
        while True:
            if num >= chan.height:
                await chan._height_changed.wait()
                continue
            blk = chan.ledger.blocks.get_block(num)
            if blk is None:
                await stream.error(f"block {num} unavailable (pre-snapshot)")
                return
            flags = protoutil.get_tx_filter(blk)
            for i, env_bytes in enumerate(blk.data.data):
                if i < len(flags) and flags[i] != 0:
                    continue
                try:
                    _, _, _, _, cca = protoutil.extract_action(m.Envelope.parse(env_bytes))
                except Exception as e:
                    _log.debug("event stream: tx %d of block %d not an endorser action: %s",
                               i, blk.header.number, e)
                    continue
                if not cca.events:
                    continue
                ev = m.ChaincodeEvent.parse(cca.events)
                if ev.chaincode_id != want_cc:
                    continue
                await stream.send(json.dumps({"block": num, "tx_id": ev.tx_id,
                                              "event_name": ev.event_name,
                                              "payload": ev.payload.hex()}).encode())
            num += 1


def register(node) -> Gateway:
    """Attach gateway services to a PeerNode's RPC server.

    Unary responses are framed: 0x00 ‖ payload on success,
    0x01 ‖ JSON{status, error} on failure."""
    gw = Gateway(node)

    def unary(fn):
        async def handler(req: bytes) -> bytes:
            try:
                return b"\x00" + await fn(req)
            except GatewayError as e:
                return b"\x01" + json.dumps({"error": str(e), "status": e.status}).encode()
        return handler

    node.server.register_unary("GwEvaluate", unary(gw.evaluate))
    node.server.register_unary("GwEndorse", unary(gw.endorse))
    node.server.register_unary("GwSubmit", unary(gw.submit))
    node.server.register_unary("GwCommitStatus", unary(gw.commit_status))
    node.server.register("GwChaincodeEvents", gw.chaincode_events)
    return gw


class GatewayClient:
    """SDK-side convenience over the gateway surface (the
    fabric-gateway client analog): sign → endorse → sign → submit →
    await commit.  ``signer`` signs proposals and envelopes: a
    ``SigningIdentity``, or a ``peer/signlane.py::BatchedSigner`` over
    the card's sign lane."""

    def __init__(self, host: str, port: int, signer, ssl_ctx=None):
        self.host, self.port = host, port
        self.signer = signer
        self.ssl_ctx = ssl_ctx
        self._cli: asyncio.Task | None = None  # the connecting task, shared by racing callers

    async def _client(self) -> RpcClient:
        if self._cli is None:
            self._cli = asyncio.ensure_future(
                RpcClient(self.host, self.port, ssl_ctx=self.ssl_ctx).connect())
        return await asyncio.shield(self._cli)

    async def close(self):
        if self._cli is not None:
            if self._cli.done() and not self._cli.cancelled() and self._cli.exception() is None:
                await self._cli.result().close()
            else:
                self._cli.cancel()
            self._cli = None

    @staticmethod
    def _unwrap(raw: bytes) -> bytes:
        if raw[:1] == b"\x01":
            err = json.loads(raw[1:])
            raise GatewayError(err.get("status", 500), err.get("error", ""))
        return raw[1:]

    async def _off_loop(self, fn, *args):
        """Signing runs off the event loop: the host signer takes
        milliseconds, and a sign lane waits for its batch."""
        return await asyncio.get_event_loop().run_in_executor(None, fn, *args)

    async def evaluate(self, channel: str, chaincode: str, args: list[bytes]) -> m.Response:
        signed, _, _ = await self._off_loop(txa.create_signed_proposal, self.signer, channel,
                                            chaincode, args)
        cli = await self._client()
        raw = self._unwrap(await cli.unary("GwEvaluate", signed.serialize(), timeout=120.0))
        return m.Response.parse(raw)

    async def endorse(self, channel: str, chaincode: str, args: list[bytes],
                      transient: dict | None = None) -> tuple[str, bytes]:
        """Endorse, then sign the prepared transaction: → (tx_id, the
        signed envelope's bytes) — the first half of
        ``submit_transaction``, for a client that submits later."""
        signed, tx_id, _ = await self._off_loop(txa.create_signed_proposal, self.signer,
                                                channel, chaincode, args, transient)
        cli = await self._client()
        payload_bytes = self._unwrap(await cli.unary("GwEndorse", signed.serialize(),
                                                     timeout=120.0))
        env = m.Envelope(payload=payload_bytes,
                         signature=await self._off_loop(self.signer.sign, payload_bytes))
        return tx_id, env.serialize()

    async def submit(self, channel: str, env_bytes: bytes) -> None:
        cli = await self._client()
        hdr = json.dumps({"channel": channel}).encode()
        self._unwrap(await cli.unary("GwSubmit", hdr + b"\x00" + env_bytes, timeout=60.0))

    async def commit_status(self, channel: str, tx_id: str, timeout: float = 120.0) -> dict:
        cli = await self._client()
        raw = self._unwrap(await cli.unary(
            "GwCommitStatus",
            json.dumps({"channel": channel, "tx_id": tx_id, "timeout": timeout}).encode(),
            timeout=timeout + 10.0))
        return json.loads(raw)

    async def submit_transaction(self, channel: str, chaincode: str, args: list[bytes],
                                 wait: bool = True, transient: dict | None = None):
        """The full gateway round trip; returns (tx_id, status dict)."""
        tx_id, env = await self.endorse(channel, chaincode, args, transient)
        await self.submit(channel, env)
        if not wait:
            return tx_id, None
        return tx_id, await self.commit_status(channel, tx_id)
