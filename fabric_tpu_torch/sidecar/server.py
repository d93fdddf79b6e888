"""The validation sidecar service: one card, many peers (counterpart:
``fabric_tpu/sidecar/server.py``).

Flow per connection: the client's first frame (hello) registers a
tenant with a weight and the server answers a welcome; every later
frame is one block's signature batch (``sidecar/wire.py``), admitted to
the tenant's bounded queue in the weighted-deficit-round-robin
scheduler, or answered BUSY when the queue is full.  A later frame that
is a JSON object (a request frame leads with a u32 header length, whose
first byte is 0) is an in-stream re-hello: it changes the tenant's
weight in place, deficit and stats kept, and is answered with an ack
(``_re_hello``).  One dispatcher
task drains up to ``coalesce`` cross-tenant requests at a time into ONE
``ops.p256.verify_launch_many`` call on a single executor thread (the
card serializes dispatches anyway) and streams each request's verdict
vector back on its tenant's stream.  A dispatch failure answers each
request of the group with a typed ERROR frame; the streams survive.
``set_coalesce`` and ``set_verify_chunk`` (the sidecar-local traffic
autopilot's actuators, the reference's :154-197) are applied at the
next drain boundary, never between a group's pop and its dispatch;
``verify_chunk`` makes each dispatch a chunked
``verify_launch_many(chunk=)``.  ``autopilot``: a
``control.Autopilot`` told each tenant's hello and re-hello weight
(``observe_hello``, its re-weight rule's restore target); while the
autopilot sheds a tenant, the scheduler turns its arrivals away and the
server answers BUSY with the longer ``SHED_RETRY_MS`` retry-after.

``stats()`` holds requests by tenant and status, the per-stage latency
samples (queue_wait, dispatch, total), coalesce occupancy in requests
and in signatures, and the dispatch count; the registry (``registry=``,
else the global one) gets the reference's ``sidecar_request_seconds
{tenant,stage}``, ``sidecar_requests_total{tenant,status}``,
``sidecar_tenants`` and ``sidecar_coalesce_occupancy{unit}``.  Each
request is a trace root in the global tracer's ``"sidecar"`` namespace
with ``queue_wait`` and ``dispatch``
children; the coalesced dispatch runs under its leader's root, so the
launch ledger's device spans land there.  A request that carries the
peer's ``trace`` context is answered with its finished subtree in the
``remote`` field (``_remote``), which the client stitches onto its
block.  The fault points: ``sidecar.request`` by ``afire`` at each
frame's admission, ``sidecar.dispatch`` in the coalesced dispatch.
Left out: mesh and topology resolution and device recoding.

``verify_fn(itemsets) -> list[list[bool]]`` replaces the card dispatch
(tests); ``kernel`` and ``device`` select the facade's kernel and card.
"""

from __future__ import annotations

import asyncio
import json
import logging
import threading
from collections import Counter, deque
from concurrent.futures import ThreadPoolExecutor

from fabric_tpu_torch import faults
from fabric_tpu_torch.comm.rpc import RpcServer
from fabric_tpu_torch.device import resolve_device
from fabric_tpu_torch.observe import global_tracer
from fabric_tpu_torch.ops import p256
from fabric_tpu_torch.sidecar import wire
from fabric_tpu_torch.sidecar.scheduler import Request, WeightedScheduler

_log = logging.getLogger("fabric_tpu_torch.sidecar")

#: suggested client backoff base when BUSY (the client's Backoff decides)
BUSY_RETRY_MS = 20.0
#: suggested retry-after while a tenant is shed
SHED_RETRY_MS = 250.0
#: latency samples kept per tenant and stage
SAMPLES = 4096


class SidecarServer:
    """See module docstring."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *, queue_blocks: int = 8,
                 coalesce: int = 4, quantum: int | None = None, ssl_ctx=None, verify_fn=None,
                 kernel: str | None = None, device="cuda", registry=None,
                 verify_chunk: int = 0, autopilot=None):
        self.host, self.port = host, port
        self.coalesce = max(1, int(coalesce))
        self.verify_chunk = max(0, int(verify_chunk))
        self.autopilot = autopilot
        self.kernel = kernel
        self.device = resolve_device(device)
        self._verify_fn = verify_fn
        self._rpc = RpcServer(host, port, ssl_ctx=ssl_ctx)
        self.tracer = tracer = global_tracer()
        kw = {} if quantum is None else {"quantum": int(quantum)}
        self.scheduler = WeightedScheduler(queue_limit=queue_blocks, registry=registry,
                                           clock=tracer.clock, **kw)
        if registry is None:
            from fabric_tpu_torch.ops_metrics import global_registry

            registry = global_registry()
        self._req_hist = registry.histogram(
            "sidecar_request_seconds",
            "per-request sidecar time (s) by tenant and stage",
        )
        self._req_ctr = registry.counter(
            "sidecar_requests_total",
            "sidecar validate requests by tenant and outcome",
        )
        self._tenants_gauge = registry.gauge(
            "sidecar_tenants", "tenant connections currently attached"
        )
        self._coalesce_hist = registry.histogram(
            "sidecar_coalesce_occupancy",
            "cross-tenant batches merged per device dispatch "
            "(unit=requests) and their total cost (unit=signatures)",
            buckets=(1, 2, 4, 8, 16, 32, 64, 256, 1024, 4096,
                     float("inf")),
        )
        self._req_counter = 0  # the request roots' numbers
        self._device = ThreadPoolExecutor(1, thread_name_prefix="fabtpu-sidecar-dev")
        self._work: asyncio.Event | None = None
        self._dispatcher: asyncio.Task | None = None
        self._conns = 0
        self._stopped = False
        self._knob_lock = threading.Lock()
        self._pending_coalesce: int | None = None
        self._pending_verify_chunk: int | None = None
        self._stats_lock = threading.Lock()
        self._requests: Counter = Counter()  # (tenant, status) → n
        self._latency: dict = {}             # tenant → stage → deque of seconds
        self._occupancy = {"requests": [], "signatures": []}
        self._dispatches = 0
        self._thread: threading.Thread | None = None
        self._loop: asyncio.AbstractEventLoop | None = None

    # -- knobs ---------------------------------------------------------------

    def set_coalesce(self, n: int) -> None:
        """A new cross-tenant coalescing cap (>= 1), applied at the next
        drain boundary."""
        with self._knob_lock:
            self._pending_coalesce = max(1, int(n))

    def set_verify_chunk(self, n: int) -> None:
        """A new verify chunk for the server's own dispatches (0: one
        launch), applied at the next drain boundary."""
        with self._knob_lock:
            self._pending_verify_chunk = max(0, int(n))

    def _apply_pending_knobs(self) -> None:
        with self._knob_lock:
            c, self._pending_coalesce = self._pending_coalesce, None
            v, self._pending_verify_chunk = self._pending_verify_chunk, None
        if c is not None and c != self.coalesce:
            _log.info("sidecar coalesce re-knobbed %d -> %d", self.coalesce, c)
            self.coalesce = c
        if v is not None and v != self.verify_chunk:
            _log.info("sidecar verify_chunk re-knobbed %d -> %d", self.verify_chunk, v)
            self.verify_chunk = v

    # -- lifecycle -------------------------------------------------------------

    async def start(self) -> "SidecarServer":
        self._work = asyncio.Event()
        self._rpc.register("validate", self._on_validate)
        await self._rpc.start()
        self.port = self._rpc.port
        self._stopped = False
        self._dispatcher = asyncio.ensure_future(self._dispatch_loop())
        return self

    async def stop(self) -> None:
        self._stopped = True
        if self._dispatcher is not None:
            self._dispatcher.cancel()
            await asyncio.gather(self._dispatcher, return_exceptions=True)
            self._dispatcher = None
        await self._rpc.stop()
        self._device.shutdown(wait=False)

    def start_background(self) -> "SidecarServer":
        """Serve from a daemon thread running its own event loop; returns
        once the port is bound."""
        ready = threading.Event()
        failed: list = []

        def run():
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            self._loop = loop
            try:
                loop.run_until_complete(self.start())
            except BaseException as e:  # reported to the starting thread
                failed.append(e)
                ready.set()
                loop.close()
                return
            ready.set()
            try:
                loop.run_forever()
            finally:
                loop.close()

        self._thread = threading.Thread(target=run, name="fabtpu-sidecar", daemon=True)
        self._thread.start()
        ready.wait()
        if failed:
            raise failed[0]
        return self

    def stop_background(self) -> None:
        loop, thread = self._loop, self._thread
        if loop is None or thread is None:
            return
        asyncio.run_coroutine_threadsafe(self.stop(), loop).result(timeout=10.0)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=10.0)
        self._loop = self._thread = None

    def health_check(self):
        """None while serving, else a reason; a tenant pinned at its
        queue bound is reported."""
        if self._stopped or self._rpc._server is None:
            return "sidecar rpc server down"
        limit = self.scheduler.queue_limit
        pinned = [name for name, s in self.scheduler.stats().items() if s["depth"] >= limit]
        if pinned:
            return (f"tenant queue(s) full ({', '.join(pinned)}): the card is saturated "
                    "or wedged; affected tenants are answered BUSY")
        return None

    def stats(self) -> dict:
        """requests {tenant: {status: n}}, latency_s {tenant: {stage:
        [seconds]}}, coalesce {"requests": [...], "signatures": [...]},
        dispatches, connections, tenants (the scheduler's stats)."""
        with self._stats_lock:
            req: dict = {}
            for (tenant, status), n in sorted((+self._requests).items()):  # n > 0
                req.setdefault(tenant, {})[status] = n
            lat = {t: {s: list(v) for s, v in st.items()} for t, st in self._latency.items()}
            occ = {k: list(v) for k, v in self._occupancy.items()}
            disp = self._dispatches
        return {"requests": req, "latency_s": lat, "coalesce": occ, "dispatches": disp,
                "connections": self._conns, "tenants": self.scheduler.stats()}

    def _count(self, tenant: str, status: str) -> None:
        with self._stats_lock:
            self._requests[(tenant, status)] += 1
        self._req_ctr.add(1, tenant=tenant, status=status)

    def _next_req_id(self) -> int:
        self._req_counter += 1
        return self._req_counter

    # -- the validate stream ---------------------------------------------------

    async def _on_validate(self, stream) -> None:
        try:
            hello_raw = await stream.__anext__()
        except StopAsyncIteration:
            return
        try:
            hello = json.loads(hello_raw)
            tenant = str(hello["tenant"])
            weight = float(hello.get("weight", 1.0))
            self.scheduler.register(tenant, weight)  # raises on weight <= 0
        except (ValueError, KeyError, TypeError) as e:
            await stream.error(f"bad hello: {e}")
            return
        if self.autopilot is not None:
            self.autopilot.observe_hello(tenant, weight)
        self._conns += 1
        self._tenants_gauge.set(self._conns)
        try:
            await stream.send(wire.encode_welcome(tenant, self.coalesce))
            async for payload in stream:
                if faults.plan() is not None:
                    await faults.afire("sidecar.request", tenant=tenant)
                if payload[:1] == b"{":
                    err = self._re_hello(tenant, payload)
                    if err is not None:
                        await stream.error(err)
                        return
                    await stream.send(json.dumps(
                        {"ok": True, "tenant": tenant, "weight": self.scheduler.weight(tenant),
                         "rehello": True}).encode())
                    continue
                try:
                    hdr, items = wire.decode_request(payload)
                except (ValueError, KeyError) as e:
                    await stream.error(f"bad request: {e}")
                    return
                seq = int(hdr["seq"])
                trace = hdr.get("trace")
                if not isinstance(trace, dict):
                    trace = None
                extra = ({} if trace is None else
                         {"peer_block": trace.get("block"), "peer_root": trace.get("root")})
                # the "sidecar" ring: request trees neither evict nor
                # collide with a colocated peer's block trees
                root = self.tracer.begin_block(self._next_req_id(), ns="sidecar",
                                               channel=f"sidecar:{tenant}", seq=seq, **extra)
                req = Request(tenant=tenant, seq=seq, items=items, stream=stream, root=root,
                              trace=trace, t_enqueue=self.tracer.clock())
                if not self.scheduler.submit(req):
                    shed = self.scheduler.is_shed(tenant)
                    self._count(tenant, "shed" if shed else "busy")
                    self.tracer.set_attrs(root, busy=True, **({"shed": True} if shed else {}))
                    self.tracer.finish_block(root)
                    await stream.send(wire.encode_busy(seq, SHED_RETRY_MS if shed
                                                       else BUSY_RETRY_MS))
                    continue
                self._work.set()
        finally:
            self._conns -= 1
            self._tenants_gauge.set(self._conns)
            for req in self.scheduler.unregister(tenant):
                self._count(req.tenant, "dropped")  # their reply stream is gone
                self.tracer.finish_block(req.root)

    def _re_hello(self, tenant: str, payload: bytes) -> str | None:
        """An in-stream weight update → an error text, or None.  The
        frame must name the stream's own tenant."""
        try:
            hello = json.loads(payload)
            who = str(hello["tenant"])
            weight = float(hello.get("weight", 1.0))
        except (ValueError, KeyError, TypeError) as e:
            return f"bad re-hello: {e}"
        if who != tenant:
            return f"bad re-hello: stream is registered as {tenant!r}, not {who!r}"
        try:
            self.scheduler.set_weight(tenant, weight)
        except ValueError as e:
            return f"bad re-hello: {e}"
        if self.autopilot is not None:
            self.autopilot.observe_hello(tenant, weight)
        return None

    # -- the dispatcher ----------------------------------------------------------

    async def _dispatch_loop(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            await self._work.wait()
            self._work.clear()
            while True:
                self._apply_pending_knobs()  # the drain boundary
                batch = self.scheduler.next_batch(self.coalesce)
                if not batch:
                    break
                with self._stats_lock:
                    self._occupancy["requests"].append(len(batch))
                    self._occupancy["signatures"].append(sum(r.cost for r in batch))
                    self._dispatches += 1
                self._coalesce_hist.observe(len(batch), unit="requests")
                self._coalesce_hist.observe(sum(r.cost for r in batch), unit="signatures")
                t0 = self.tracer.clock()
                try:
                    verdicts = await loop.run_in_executor(
                        self._device, self._dispatch_traced, [r.items for r in batch],
                        batch[0].root)
                    if len(verdicts) != len(batch):
                        raise ValueError(f"verify returned {len(verdicts)} verdict vectors "
                                         f"for {len(batch)} requests")
                    await self._answer(batch, verdicts, t0, self.tracer.clock())
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    # typed errors; the dispatcher itself must survive
                    _log.warning("sidecar dispatch of %d request(s) failed: %s", len(batch), e)
                    try:
                        await self._answer_error(batch, e)
                    except asyncio.CancelledError:
                        raise
                    except Exception as e2:
                        _log.warning("sidecar error answers failed too: %s", e2)
                        for req in batch:
                            self._count(req.tenant, "dropped")
                            self.tracer.finish_block(req.root)

    def _dispatch_traced(self, itemsets: list, root) -> list:
        """Executor-thread shim: the group's leader request tree is the
        thread's current span for the verify, so the launch ledger's
        device spans attach to it."""
        tok = self.tracer.attach(root) if root is not None else None
        try:
            return self._verify_batch(itemsets)
        finally:
            if root is not None:
                self.tracer.detach(tok)

    def _verify_batch(self, itemsets: list) -> list:
        faults.fire("sidecar.dispatch", n=len(itemsets))
        if self._verify_fn is not None:
            return self._verify_fn(itemsets)
        handles = p256.verify_launch_many(itemsets, kernel=self.kernel, device=self.device,
                                          chunk=self.verify_chunk or None)
        return [h.fetch() for h in handles]

    async def _answer(self, batch: list, verdicts: list, t0: float, t1: float) -> None:
        for req, ok in zip(batch, verdicts):
            self._req_hist.observe(t0 - req.t_enqueue, tenant=req.tenant, stage="queue_wait")
            self._req_hist.observe(t1 - t0, tenant=req.tenant, stage="dispatch")
            self._req_hist.observe(t1 - req.t_enqueue, tenant=req.tenant, stage="total")
            self.tracer.add("queue_wait", req.t_enqueue, t0, parent=req.root)
            self.tracer.add("dispatch", t0, t1, parent=req.root, coalesced=len(batch),
                            n_sigs=req.cost)
            with self._stats_lock:
                st = self._latency.setdefault(
                    req.tenant, {s: deque(maxlen=SAMPLES) for s in ("queue_wait", "dispatch",
                                                                     "total")})
                st["queue_wait"].append(t0 - req.t_enqueue)
                st["dispatch"].append(t1 - t0)
                st["total"].append(t1 - req.t_enqueue)
                # counted before the send, so a tenant holding its answer
                # finds it counted; moved to "dropped" if the send fails
                self._requests[(req.tenant, "ok")] += 1
            sent = await self._send(req, wire.encode_response(req.seq, ok,
                                                              remote=self._remote(req)))
            if not sent:
                with self._stats_lock:
                    self._requests[(req.tenant, "ok")] -= 1
                    self._requests[(req.tenant, "dropped")] += 1
            self._req_ctr.add(1, tenant=req.tenant, status="ok" if sent else "dropped")
            self.tracer.finish_block(req.root)

    def _remote(self, req: Request) -> dict | None:
        """The finished request subtree and the receive and send times
        the client stitches it with; only for a request that carried a
        trace context, with tracing on here."""
        if req.trace is None or req.root is None:
            return None
        self.tracer.end(req.root)  # the shipped tree has its whole window
        return {"spans": req.root.to_dict(0.0),
                "t_rx": round(req.t_enqueue * 1000.0, 3),
                "t_tx": round(self.tracer.clock() * 1000.0, 3)}

    async def _answer_error(self, batch: list, err: Exception) -> None:
        msg = f"{type(err).__name__}: {err}"
        for req in batch:
            self._count(req.tenant, "error")
            await self._send(req, wire.encode_error(req.seq, msg))
            self.tracer.set_attrs(req.root, error=msg[:120])
            self.tracer.finish_block(req.root)

    @staticmethod
    async def _send(req: Request, payload: bytes) -> bool:
        try:
            await req.stream.send(payload)
            return True
        except (ConnectionError, OSError, RuntimeError, EOFError):
            return False  # the tenant went away first
