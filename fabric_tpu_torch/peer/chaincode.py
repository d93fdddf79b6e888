"""Chaincode runtime: contract execution building rwsets via the
simulator (counterpart: ``fabric_tpu/peer/chaincode.py``).

The reference launches chaincode out-of-process (Docker or external
service) and speaks a duplex gRPC FSM
(core/chaincode/chaincode_support.go:160 Execute, handler.go:364
ProcessStream — GetState/PutState round-trips per call).  Two modes
here, matching its external-chaincode direction but without Docker:

* **In-process contracts** (devmode analog): a `Contract` subclass is
  registered with the runtime and invoked directly against the
  simulator — zero IPC, the mode benchmarks and tests use.
* **Chaincode-as-a-service** (ccaas analog): the reference's contract
  runs in its own process behind an RPC server.  Its proxy and the
  package store it resolves through are not ported yet (ROADMAP Queue 1
  item 10); the ``resolver`` hook is kept, so a later module plugs in
  here.

Either way the runtime owns namespace scoping: a contract only touches
its own namespace unless it explicitly invokes another chaincode
(InvokeChaincode semantics — same-channel read-write)."""

from __future__ import annotations

import json
from dataclasses import dataclass


class ChaincodeError(Exception):
    pass


@dataclass
class Response:
    status: int = 200
    payload: bytes = b""
    message: str = ""


class ContractStub:
    """The API a contract sees (shim/stub analog), bound to one
    (simulator, namespace, invocation)."""

    def __init__(self, runtime: "ChaincodeRuntime", sim, namespace: str,
                 args: list[bytes], transient: dict | None = None,
                 creator: bytes = b"", channel: str = ""):
        self._rt = runtime
        self._sim = sim
        self.namespace = namespace
        self.args = args
        self.transient = transient or {}
        self.creator = creator
        self.channel = channel
        self.events: list[tuple[str, bytes]] = []

    # state ---------------------------------------------------------------
    def get_state(self, key: str) -> bytes | None:
        return self._sim.get_state(self.namespace, key)

    def put_state(self, key: str, value: bytes) -> None:
        self._sim.set_state(self.namespace, key, value)

    def del_state(self, key: str) -> None:
        self._sim.delete_state(self.namespace, key)

    def get_state_range(self, start: str, end: str, limit: int = 0):
        return self._sim.get_state_range(self.namespace, start, end, limit)

    def set_state_validation_parameter(self, key: str,
                                       policy_bytes: bytes) -> None:
        """Key-level endorsement policy (shim
        SetStateValidationParameter): a serialized
        SignaturePolicyEnvelope that the commit-path SBE pass enforces
        for every later write to ``key``."""
        self._sim.set_state_validation_parameter(
            self.namespace, key, policy_bytes
        )

    def get_state_validation_parameter(self, key: str) -> bytes | None:
        return self._sim.get_state_validation_parameter(self.namespace, key)

    def set_state_metadata(self, key: str, metadata: dict) -> None:
        self._sim.set_state_metadata(self.namespace, key, metadata)

    def get_private(self, coll: str, key: str) -> bytes | None:
        return self._sim.get_private_data(self.namespace, coll, key)

    def put_private(self, coll: str, key: str, value: bytes) -> None:
        self._sim.set_private_data(self.namespace, coll, key, value)

    # events / cross-chaincode --------------------------------------------
    def set_event(self, name: str, payload: bytes) -> None:
        self.events.append((name, payload))

    def invoke_chaincode(self, chaincode: str, args: list[bytes]) -> Response:
        """Same-channel chaincode-to-chaincode call: the callee builds
        its rwset into the SAME simulator under its own namespace
        (handler.go HandleInvokeChaincode semantics)."""
        return self._rt.execute(self._sim, chaincode, args,
                                transient=self.transient,
                                creator=self.creator, channel=self.channel)


class Contract:
    """Subclass and register: dispatches args[0] as the method name."""

    def invoke(self, stub: ContractStub) -> Response:
        if not stub.args:
            return Response(400, message="no function")
        fn_name = stub.args[0].decode()
        # only subclass-defined public methods are invocable — base
        # machinery (invoke itself) would recurse unboundedly
        if fn_name.startswith("_") or hasattr(Contract, fn_name):
            return Response(400, message=f"unknown function {fn_name}")
        fn = getattr(self, fn_name, None)
        if not callable(fn):
            return Response(400, message=f"unknown function {fn_name}")
        try:
            out = fn(stub, *stub.args[1:])
        except ChaincodeError as e:
            return Response(500, message=str(e))
        if isinstance(out, Response):
            return out
        return Response(200, payload=out if isinstance(out, bytes) else b"")


class ChaincodeRuntime:
    """namespace → executable contract (the ChaincodeSupport registry
    analog; launchers register in-process or ccaas-backed handlers)."""

    def __init__(self, resolver=None):
        self._contracts: dict[str, object] = {}
        # resolver(name, channel) → Contract | None: called on a
        # registry miss — the peer binds it to the lifecycle install
        # store so a COMMITTED definition whose approved package is
        # installed launches without manual registration (the
        # reference's lifecycle → external chaincode launch path).
        # Resolutions cache PER (channel, name) — the same name on two
        # channels may bind different packages — and are dropped when
        # a committed block writes the lifecycle namespace (upgrades
        # must rebind).
        self.resolver = resolver
        self._resolved: dict[tuple, object] = {}

    def register(self, name: str, contract) -> None:
        self._contracts[name] = contract

    def registered(self, name: str) -> bool:
        return name in self._contracts

    def invalidate_resolved(self) -> None:
        """Lifecycle state changed (commit/upgrade): re-resolve on the
        next invoke instead of serving a stale endpoint."""
        self._resolved.clear()

    def execute(self, sim, name: str, args: list[bytes],
                transient: dict | None = None, creator: bytes = b"",
                channel: str = "") -> Response:
        contract = self._contracts.get(name)
        if contract is None:
            contract = self._resolved.get((channel, name))
        if contract is None and self.resolver is not None:
            contract = self.resolver(name, channel)
            if contract is not None:
                self._resolved[(channel, name)] = contract
        if contract is None:
            raise ChaincodeError(f"chaincode {name} not installed")
        stub = ContractStub(self, sim, name, args, transient, creator,
                            channel=channel)
        resp = contract.invoke(stub)
        resp.events = stub.events  # type: ignore[attr-defined]
        return resp


# ---------------------------------------------------------------------------
# sample contracts (integration/chaincode analogs, used by tests/bench)


class KVContract(Contract):
    """simple key-value chaincode (integration/chaincode/simple)."""

    def put(self, stub, key: bytes, value: bytes):
        stub.put_state(key.decode(), value)
        return b"ok"

    def get(self, stub, key: bytes):
        v = stub.get_state(key.decode())
        if v is None:
            return Response(404, message="not found")
        return v

    def delete(self, stub, key: bytes):
        stub.del_state(key.decode())
        return b"ok"

    def transfer(self, stub, frm: bytes, to: bytes, amount: bytes):
        if frm == to:
            return Response(400, message="self-transfer")
        a = int(stub.get_state(frm.decode()) or b"0")
        b = int(stub.get_state(to.decode()) or b"0")
        amt = int(amount)
        if a < amt:
            return Response(500, message="insufficient funds")
        stub.put_state(frm.decode(), str(a - amt).encode())
        stub.put_state(to.decode(), str(b + amt).encode())
        return b"ok"

    def range_sum(self, stub, start: bytes, end: bytes):
        total = sum(
            int(v) for _, v in stub.get_state_range(start.decode(), end.decode())
        )
        return str(total).encode()

    def put_private(self, stub, coll: bytes, key: bytes):
        value = stub.transient.get("value")
        if value is None:
            return Response(400, message="missing transient value")
        stub.put_private(coll.decode(), key.decode(), value)
        return b"ok"


class MarblesContract(Contract):
    """JSON-document chaincode exercising rich state (statecouchdb
    analog paths: execute_query over JSON values)."""

    def create(self, stub, name: bytes, color: bytes, size: bytes, owner: bytes):
        doc = {"docType": "marble", "name": name.decode(),
               "color": color.decode(), "size": int(size), "owner": owner.decode()}
        stub.put_state(name.decode(), json.dumps(doc).encode())
        stub.set_event("marble_created", name)
        return b"ok"

    def transfer(self, stub, name: bytes, new_owner: bytes):
        raw = stub.get_state(name.decode())
        if raw is None:
            return Response(404, message="no such marble")
        doc = json.loads(raw)
        doc["owner"] = new_owner.decode()
        stub.put_state(name.decode(), json.dumps(doc).encode())
        return b"ok"


class LayeredRuntime(ChaincodeRuntime):
    """Per-channel view over a shared runtime: system chaincodes
    (``_lifecycle`` with the channel's org set, qscc-style helpers)
    resolve first, user chaincodes fall through to the node-wide
    registry (the reference's system-chaincode deploy loop,
    internal/peer/node/start.go:765)."""

    def __init__(self, base: ChaincodeRuntime, overlays: dict | None = None):
        super().__init__()
        self._base = base
        self._contracts.update(overlays or {})

    def registered(self, name: str) -> bool:
        return name in self._contracts or self._base.registered(name)

    def execute(self, sim, name: str, args, transient=None, creator=b"",
                channel: str = ""):
        if name in self._contracts:
            contract = self._contracts[name]
            stub = ContractStub(self, sim, name, args, transient, creator,
                                channel=channel)
            resp = contract.invoke(stub)
            resp.events = stub.events  # type: ignore[attr-defined]
            return resp
        return self._base.execute(sim, name, args, transient=transient,
                                  creator=creator, channel=channel)
