"""Chaincode as a service: contracts in a process of their own, the
state calls of each invocation round-tripping to the peer (counterpart:
``fabric_tpu/peer/ccaas.py``).

Wire format on the ``CCInvoke`` stream (JSON, values hex), the
reference's, so either package's proxy talks to either package's server:
  peer → cc   {"chaincode", "args": [...], "transient": {...},
               "creator": "..."}
  cc  → peer  {"op": "get_state"|"put_state"|"del_state"|"get_range"|
               "get_private"|"put_private"|"set_event", ...}
  peer → cc   {"result": ...}
  cc  → peer  {"done": {"status", "payload", "message"}}

``ChaincodeServer`` hosts contracts; ``CCaaSProxy`` is the peer-side
contract that forwards an invocation and serves its state calls against
the peer's simulator, on one background event loop shared by every
proxy of the process.
"""

from __future__ import annotations

import asyncio
import json
import threading

from fabric_tpu_torch.comm.rpc import RpcClient, RpcServer
from fabric_tpu_torch.peer.chaincode import Contract, Response


def _hx(b: bytes | None) -> str | None:
    return b.hex() if b is not None else None


def _unhx(s: str | None) -> bytes | None:
    return bytes.fromhex(s) if s is not None else None


# ---------------------------------------------------------------------------
# Chaincode-process side


class _RemoteStub:
    """The stub a ccaas contract sees: every state op round-trips to
    the peer over the stream (handler.go HandleGetState etc.)."""

    def __init__(self, loop, stream, invocation: dict):
        self._loop = loop
        self._stream = stream
        self.args = [bytes.fromhex(a) for a in invocation["args"]]
        self.transient = {
            k: bytes.fromhex(v) for k, v in invocation.get("transient", {}).items()
        }
        self.creator = bytes.fromhex(invocation.get("creator", ""))
        self.events: list = []

    def _roundtrip(self, msg: dict):
        async def go():
            await self._stream.send(json.dumps(msg).encode())
            reply = await self._stream.__anext__()
            return json.loads(reply)["result"]

        return asyncio.run_coroutine_threadsafe(go(), self._loop).result(30)

    def get_state(self, key: str):
        return _unhx(self._roundtrip({"op": "get_state", "key": key}))

    def put_state(self, key: str, value: bytes):
        self._roundtrip({"op": "put_state", "key": key, "value": _hx(value)})

    def del_state(self, key: str):
        self._roundtrip({"op": "del_state", "key": key})

    def get_state_range(self, start: str, end: str, limit: int = 0):
        rows = self._roundtrip({
            "op": "get_range", "start": start, "end": end, "limit": limit,
        })
        return [(k, _unhx(v)) for k, v in rows]

    def get_private(self, coll: str, key: str):
        return _unhx(self._roundtrip({
            "op": "get_private", "coll": coll, "key": key,
        }))

    def put_private(self, coll: str, key: str, value: bytes):
        self._roundtrip({
            "op": "put_private", "coll": coll, "key": key, "value": _hx(value),
        })

    def set_event(self, name: str, payload: bytes):
        self.events.append((name, payload))
        self._roundtrip({
            "op": "set_event", "name": name, "payload": _hx(payload),
        })


class ChaincodeServer:
    """Hosts contracts in the chaincode process (the ccaas server)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.server = RpcServer(host, port)
        self._contracts: dict[str, Contract] = {}
        self.port = port

    def register(self, name: str, contract: Contract) -> None:
        self._contracts[name] = contract

    async def start(self):
        self.server.register("CCInvoke", self._on_invoke)
        await self.server.start()
        self.port = self.server.port
        return self

    async def stop(self):
        await self.server.stop()

    async def _on_invoke(self, stream):
        inv = json.loads(await stream.__anext__())
        contract = self._contracts.get(inv["chaincode"])
        if contract is None:
            await stream.send(json.dumps({
                "done": {"status": 404,
                         "message": f"chaincode {inv['chaincode']} not served"}
            }).encode())
            return
        loop = asyncio.get_event_loop()
        stub = _RemoteStub(loop, stream, inv)
        resp = await loop.run_in_executor(None, contract.invoke, stub)
        await stream.send(json.dumps({
            "done": {"status": resp.status, "payload": _hx(resp.payload),
                     "message": resp.message}
        }).encode())


# ---------------------------------------------------------------------------
# Peer side: proxy contract forwarding to the ccaas server


class _CCaaSLoop:
    """One shared background event loop for all ccaas connections —
    peer-side chaincode execution happens in executor threads, so the
    RPC round trips need a loop of their own."""

    _instance = None

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(
            target=self.loop.run_forever, name="ccaas-client", daemon=True
        )
        self.thread.start()

    @classmethod
    def get(cls) -> "_CCaaSLoop":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance


class CCaaSProxy(Contract):
    """Registered in the peer's ChaincodeRuntime under the chaincode
    name; forwards invocations to the external server and serves state
    callbacks against the PEER-side simulator stub (so the rwset is
    built exactly as with in-process contracts)."""

    def __init__(self, chaincode: str, host: str, port: int):
        self.chaincode = chaincode
        self.host, self.port = host, port

    def invoke(self, stub) -> Response:
        runner = _CCaaSLoop.get()

        async def session():
            cli = RpcClient(self.host, self.port)
            await cli.connect()
            try:
                stream = await cli.open_stream("CCInvoke")
                await stream.send(json.dumps({
                    "chaincode": self.chaincode,
                    "args": [a.hex() for a in stub.args],
                    "transient": {k: v.hex() for k, v in stub.transient.items()},
                    "creator": stub.creator.hex(),
                }).encode())
                async for raw in stream:
                    msg = json.loads(raw)
                    if "done" in msg:
                        d = msg["done"]
                        return Response(
                            status=int(d.get("status", 500)),
                            payload=_unhx(d.get("payload")) or b"",
                            message=d.get("message", ""),
                        )
                    result = self._serve(stub, msg)
                    await stream.send(json.dumps({"result": result}).encode())
                return Response(status=500, message="chaincode stream ended early")
            finally:
                await cli.close()

        fut = asyncio.run_coroutine_threadsafe(session(), runner.loop)
        return fut.result(60)

    @staticmethod
    def _serve(stub, msg: dict):
        op = msg["op"]
        if op == "get_state":
            return _hx(stub.get_state(msg["key"]))
        if op == "put_state":
            stub.put_state(msg["key"], _unhx(msg["value"]) or b"")
            return True
        if op == "del_state":
            stub.del_state(msg["key"])
            return True
        if op == "get_range":
            return [
                [k, _hx(v.value if hasattr(v, "value") else v)]
                for k, v in stub.get_state_range(
                    msg["start"], msg["end"], msg.get("limit", 0)
                )
            ]
        if op == "get_private":
            return _hx(stub.get_private(msg["coll"], msg["key"]))
        if op == "put_private":
            stub.put_private(msg["coll"], msg["key"], _unhx(msg["value"]) or b"")
            return True
        if op == "set_event":
            stub.set_event(msg["name"], _unhx(msg["payload"]) or b"")
            return True
        raise ValueError(f"unknown chaincode op {op}")
