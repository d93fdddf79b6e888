"""Client side of the validation sidecar (counterpart:
``fabric_tpu/sidecar/client.py``).

``SidecarLink`` owns one connection per tenant: a daemon thread runs a
private asyncio loop with the ``comm.rpc`` client, one ``validate``
bidi stream, and a reader task that matches responses to requests by
``seq``.  ``submit(tuples)`` returns a ``RemoteVerifyHandle`` at once;
the verdicts arrive at ``fetch()``.

* a BUSY answer is retried with capped exponential backoff
  (``utils.backoff.Backoff``) up to ``busy_retries`` times, then
  ``SidecarUnavailable``;
* connection loss, an ERROR answer, a timeout or a verdict vector of
  the wrong length raise ``SidecarUnavailable`` from ``fetch()``;
* a ``submit`` while detached connects anew, so the next block after a
  sidecar restart re-attaches (the validator's recovery probe is such a
  submit); ``attached`` says whether a stream is open;
* ``set_weight`` changes the tenant's weight in place by an in-stream
  re-hello, which the server acknowledges; detached, the new weight
  rides the next hello.

Telemetry (the reference's :94-135, :160-320): ``busy_total`` and
``attach_total`` are attributes and the registry's
``sidecar_client_busy_total`` and ``sidecar_client_attach_total``; a
``submit`` from a thread attached to a traced block ships the block's
context in the request's ``trace`` field, and ``_stitch`` hangs the
server's returned subtree under that block's root as a
``sidecar_request`` span (process ``sidecar``), shifted by the NTP-style
clock-offset estimate of the send and receive times.
"""

from __future__ import annotations

import asyncio
import json
import logging
import threading

from fabric_tpu_torch.comm.rpc import RpcClient, RpcError
from fabric_tpu_torch.observe import global_tracer, span_from_dict
from fabric_tpu_torch.sidecar import wire
from fabric_tpu_torch.utils.backoff import Backoff

_log = logging.getLogger("fabric_tpu_torch.sidecar.client")

#: seconds granted to connect + hello before a submit gives up
CONNECT_TIMEOUT_S = 5.0


class SidecarUnavailable(RuntimeError):
    """The sidecar could not serve this batch: down, saturated past the
    busy-retry budget, errored, or answered a malformed verdict vector."""


def parse_endpoint(endpoint: str) -> tuple[str, int]:
    """'host:port' (or ':port' / 'port') → (host, port)."""
    host, _, port = str(endpoint).rpartition(":")
    if not port.isdigit():
        raise ValueError(f"sidecar endpoint {endpoint!r}: expected 'host:port'")
    return host or "127.0.0.1", int(port)


class RemoteVerifyHandle:
    """One in-flight batch's verdicts; ``fetch()`` blocks until the
    response lands or raises ``SidecarUnavailable``.  It has no
    ``device_out``: a sidecar-verified block takes the host path."""

    __slots__ = ("_fut", "_timeout", "n_real")

    def __init__(self, fut, timeout_s: float, n_real: int = 0):
        self._fut = fut
        self._timeout = timeout_s
        self.n_real = n_real

    def fetch(self) -> list:
        try:
            return self._fut.result(timeout=self._timeout)
        except SidecarUnavailable:
            raise
        except Exception as e:  # timeout, cancelled, loop torn down
            raise SidecarUnavailable(f"sidecar fetch failed: {e}") from e

    def __call__(self) -> list:
        return self.fetch()


class SidecarLink:
    """See module docstring."""

    def __init__(self, host: str, port: int, tenant: str, weight: float = 1.0, ssl_ctx=None,
                 timeout_s: float = 30.0, busy_retries: int = 6, backoff: Backoff | None = None,
                 registry=None):
        self.host, self.port = host, int(port)
        self.tenant = tenant
        self.weight = float(weight)
        self.ssl_ctx = ssl_ctx
        self.timeout_s = float(timeout_s)
        self.busy_retries = int(busy_retries)
        self._backoff_proto = backoff
        self.busy_total = 0    # BUSY answers absorbed by backoff
        self.attach_total = 0  # stream (re)attachments
        self._client: RpcClient | None = None
        self._stream = None
        self._reader_task: asyncio.Task | None = None
        self._conn_lock: asyncio.Lock | None = None  # created on the loop
        self._pending: dict[int, asyncio.Future] = {}
        self._hello_ack: asyncio.Future | None = None
        self._seq = 0
        self._closed = False
        self.tracer = global_tracer()
        if registry is None:
            from fabric_tpu_torch.ops_metrics import global_registry

            registry = global_registry()
        self._busy_ctr = registry.counter(
            "sidecar_client_busy_total",
            "BUSY backpressure frames absorbed by client backoff",
        )
        self._reattach_ctr = registry.counter(
            "sidecar_client_attach_total",
            "sidecar stream (re)attachments by tenant",
        )
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._run_loop, name=f"fabtpu-sidecar-{tenant}",
                                        daemon=True)
        self._thread.start()

    def _run_loop(self) -> None:
        asyncio.set_event_loop(self._loop)
        try:
            self._loop.run_forever()
        finally:
            self._loop.close()

    # -- sync surface (validator threads) ------------------------------------

    @property
    def attached(self) -> bool:
        """A stream to the sidecar is open."""
        return self._stream is not None

    def submit(self, tuples) -> RemoteVerifyHandle:
        """Queue one signature batch; raises ``SidecarUnavailable`` only
        when the link is closed (transport errors surface at fetch)."""
        if self._closed or not self._thread.is_alive():
            raise SidecarUnavailable("sidecar link is closed")
        tuples = list(tuples)
        # the caller's trace context, read here: the link loop's thread
        # has no current span of ours
        cur = self.tracer.current()
        stitch_root = trace = None
        if cur is not None:
            stitch_root = cur.root if cur.root is not None else cur
            trace = {"block": stitch_root.attrs.get("block"),
                     "root": id(stitch_root) & 0xFFFFFFFF, "tenant": self.tenant}
        fut = asyncio.run_coroutine_threadsafe(self._asubmit(tuples, trace, stitch_root),
                                               self._loop)
        # worst case: every attempt burns its timeout, plus the backoff
        bound = (self.busy_retries + 1) * self.timeout_s + 10.0
        return RemoteVerifyHandle(fut, bound, n_real=len(tuples))

    def submit_many(self, tuple_sets) -> list:
        """One handle a batch; the server's scheduler coalesces them."""
        return [self.submit(t) for t in tuple_sets]

    def set_weight(self, weight: float, timeout_s: float = 5.0) -> bool:
        """Change this tenant's weight in place by an in-stream re-hello
        → True on the server's ack; False when detached or refused (the
        weight then rides the next hello)."""
        self.weight = float(weight)
        if self._closed or self._stream is None:
            return False
        try:
            return bool(asyncio.run_coroutine_threadsafe(
                self._arehello(self.weight), self._loop).result(timeout_s))
        except Exception:
            return False

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._thread.is_alive():
            asyncio.run_coroutine_threadsafe(self._aclose(), self._loop).result(timeout=5.0)
            self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=5.0)

    # -- async internals (link loop only) -------------------------------------

    async def _asubmit(self, tuples: list, trace: dict | None = None,
                       stitch_root=None) -> list:
        bo = self._backoff_proto or Backoff(base=0.02, cap=0.5, jitter=0.5)
        busy = 0
        while True:
            st = await self._ensure_attached()
            self._seq += 1
            seq = self._seq
            fut = self._loop.create_future()
            self._pending[seq] = fut
            try:
                t_send = self.tracer.clock()
                await st.send(wire.encode_request(seq, tuples, trace=trace))
                hdr, verdicts = await asyncio.wait_for(fut, self.timeout_s)
                t_recv = self.tracer.clock()
            except (RpcError, ConnectionError, OSError, asyncio.TimeoutError,
                    asyncio.IncompleteReadError) as e:
                self._pending.pop(seq, None)
                self._detach()
                raise SidecarUnavailable(f"sidecar {self.host}:{self.port}: {e}") from e
            finally:
                self._pending.pop(seq, None)
            status = hdr.get("status")
            if status == "BUSY":
                busy += 1
                self.busy_total += 1
                self._busy_ctr.add(1, tenant=self.tenant)
                if busy > self.busy_retries:
                    raise SidecarUnavailable(f"sidecar still BUSY after {busy} attempts")
                await asyncio.sleep(bo.next())
                continue
            if status is not None:
                raise SidecarUnavailable(f"sidecar dispatch error: {hdr.get('error', status)}")
            if len(verdicts) != len(tuples):
                # a remote trust boundary: a short (or long) vector is refused
                raise SidecarUnavailable(f"sidecar answered {len(verdicts)} verdicts for a "
                                         f"{len(tuples)}-signature batch")
            if stitch_root is not None:
                self._stitch(stitch_root, hdr.get("remote"), t_send, t_recv)
            return verdicts

    def _stitch(self, root, remote, t_send: float, t_recv: float) -> None:
        """Hang the sidecar's finished request subtree under the block
        root, on the local timeline: offset (server clock − local) =
        ((t_rx − t_send) + (t_tx − t_recv)) / 2, NTP's estimate, good
        to half the round trip's asymmetry (``clock_offset_ms`` and
        ``rtt_ms`` on the stitched span).  A malformed payload is
        dropped with a debug line: it never fails the verify."""
        if not isinstance(remote, dict) or "spans" not in remote:
            return
        try:
            t_rx = float(remote["t_rx"]) / 1000.0
            t_tx = float(remote["t_tx"]) / 1000.0
            offset = ((t_rx - t_send) + (t_tx - t_recv)) / 2.0
            sp = span_from_dict(remote["spans"], offset_s=offset, proc="sidecar")
            sp.name = "sidecar_request"
            # the server's request number must not shadow the block's
            if "block" in sp.attrs:
                sp.attrs["req"] = sp.attrs.pop("block")
            sp.attrs["clock_offset_ms"] = round(offset * 1000.0, 3)
            sp.attrs["rtt_ms"] = round(max(0.0, (t_recv - t_send) - (t_tx - t_rx)) * 1000.0, 3)
            sp.root = root
            root.children.append(sp)  # GIL-atomic; the root may be live
        except (TypeError, ValueError, KeyError, AttributeError) as e:
            _log.debug("sidecar trace stitch failed: %s", e)

    async def _ensure_attached(self):
        if self._conn_lock is None:
            self._conn_lock = asyncio.Lock()
        async with self._conn_lock:
            if self._stream is not None:
                return self._stream
            cli = RpcClient(self.host, self.port, ssl_ctx=self.ssl_ctx)
            try:
                await asyncio.wait_for(cli.connect(), CONNECT_TIMEOUT_S)
                st = await cli.open_stream("validate")
                await st.send(wire.encode_hello(self.tenant, self.weight))
                welcome = json.loads(await asyncio.wait_for(st.__anext__(), CONNECT_TIMEOUT_S))
            except (RpcError, ConnectionError, OSError, asyncio.TimeoutError,
                    StopAsyncIteration, asyncio.IncompleteReadError, ValueError) as e:
                await self._close_client(cli)
                raise SidecarUnavailable(f"sidecar {self.host}:{self.port} unreachable: {e}") from e
            if not welcome.get("ok"):
                await self._close_client(cli)
                raise SidecarUnavailable(f"sidecar refused hello: {welcome}")
            self._client, self._stream = cli, st
            self._reader_task = asyncio.ensure_future(self._reader(st))
            self.attach_total += 1
            self._reattach_ctr.add(1, tenant=self.tenant)
            return st

    async def _arehello(self, weight: float) -> bool:
        st = self._stream
        if st is None:
            return False
        ack = self._loop.create_future()
        self._hello_ack = ack
        try:
            await st.send(wire.encode_hello(self.tenant, weight))
            got = await asyncio.wait_for(ack, CONNECT_TIMEOUT_S)
            return bool(got.get("ok"))
        finally:
            self._hello_ack = None

    async def _reader(self, st) -> None:
        try:
            async for payload in st:
                if payload[:1] == b"{":  # a re-hello's ack (see server.py)
                    ack = self._hello_ack
                    if ack is not None and not ack.done():
                        try:
                            ack.set_result(json.loads(payload))
                        except ValueError:
                            ack.set_result({})
                    continue
                hdr, verdicts = wire.decode_response(payload)
                fut = self._pending.pop(int(hdr.get("seq", -1)), None)
                if fut is not None and not fut.done():
                    fut.set_result((hdr, verdicts))
        except (RpcError, ConnectionError, OSError, asyncio.IncompleteReadError):
            pass  # the connection is gone; _detach fails what is in flight
        finally:
            if self._stream is st:
                self._detach()

    def _detach(self) -> None:
        """Drop the dead connection and fail everything in flight; the
        next submit reconnects."""
        cli, self._client = self._client, None
        self._stream = None
        task, self._reader_task = self._reader_task, None
        if task is not None and not task.done():
            task.cancel()
        pending, self._pending = dict(self._pending), {}
        for fut in pending.values():
            if not fut.done():
                fut.set_exception(SidecarUnavailable("sidecar connection lost"))
        ack, self._hello_ack = self._hello_ack, None
        if ack is not None and not ack.done():
            ack.set_exception(SidecarUnavailable("sidecar connection lost"))
        if cli is not None:
            t = asyncio.ensure_future(self._close_client(cli))
            t.add_done_callback(lambda _t: None)

    @staticmethod
    async def _close_client(cli) -> None:
        try:
            await cli.close()
        except (OSError, RuntimeError):
            pass  # transport already gone

    async def _aclose(self) -> None:
        self._detach()
