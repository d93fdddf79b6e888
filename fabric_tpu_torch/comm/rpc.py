"""Framed-message RPC over asyncio TCP with optional TLS (counterpart:
``fabric_tpu/comm/rpc.py``).

A minimal multiplexed-stream protocol with gRPC's shape (unary and
bidi-streaming methods over one TCP connection):

    frame   := u32 length | u32 stream_id | u8 kind | payload
    kind    := CALL (payload = method name utf-8)
             | MSG  (payload = one message, caller-defined bytes)
             | END  (half-close)
             | ERR  (payload = utf-8 error text, prefixed with the method)

Handlers are ``async def handler(stream)``: iterate the stream for
request payloads, ``await stream.send(...)`` to reply.  Frames longer
than ``MAX_FRAME`` are refused on send (``FrameTooLargeError``) and on
read.  ``ssl_ctx`` goes to ``asyncio``'s server and connection:
``make_server_tls`` / ``make_client_tls`` build the mutual-TLS contexts
(Python's ``ssl`` over OpenSSL; a server given a CA bundle requires a
client certificate, a client checks the chain but not the host name),
and ``TlsProfile`` carries one node's material to every listener and
dial, as the reference's do.  Every
frame sent passes the ``rpc.frame`` fault point by ``afire``, so an
armed latency slows one stream and a ``disconnect`` cuts it.
"""

from __future__ import annotations

import asyncio
import ssl
import struct

from fabric_tpu_torch import faults

KIND_CALL = 1
KIND_MSG = 2
KIND_END = 3
KIND_ERR = 4

_HDR = struct.Struct(">IIB")
MAX_FRAME = 64 * 1024 * 1024


class RpcError(Exception):
    pass


class FrameTooLargeError(RpcError):
    """A frame exceeding ``MAX_FRAME``, refused on the sending side."""


async def _write_frame(writer, stream_id: int, kind: int, payload: bytes = b""):
    if len(payload) > MAX_FRAME:
        raise FrameTooLargeError(f"frame too large to send: {len(payload)} bytes exceeds "
                                 f"MAX_FRAME ({MAX_FRAME})")
    if faults.plan() is not None:
        await faults.afire("rpc.frame", kind=kind, stream=stream_id)
    writer.write(_HDR.pack(len(payload), stream_id, kind) + payload)
    await writer.drain()


async def _read_frame(reader):
    hdr = await reader.readexactly(_HDR.size)
    length, stream_id, kind = _HDR.unpack(hdr)
    if length > MAX_FRAME:
        raise RpcError(f"frame too large: {length}")
    payload = await reader.readexactly(length) if length else b""
    return stream_id, kind, payload


_END = object()


class _Stream:
    """One logical RPC stream (either side); ERR frames carry ``method``."""

    def __init__(self, conn: "_Conn", stream_id: int, method: str = ""):
        self.conn = conn
        self.id = stream_id
        self.method = method
        self.inbox: asyncio.Queue = asyncio.Queue()
        self.closed = False

    async def send(self, payload: bytes):
        await _write_frame(self.conn.writer, self.id, KIND_MSG, payload)

    async def end(self):
        if not self.closed:
            self.closed = True
            await _write_frame(self.conn.writer, self.id, KIND_END)

    async def error(self, msg: str):
        if not self.closed:
            self.closed = True
            if self.method and not msg.startswith(self.method):
                msg = f"{self.method}: {msg}"
            await _write_frame(self.conn.writer, self.id, KIND_ERR, msg.encode())

    def dispose(self):
        """Stop routing frames to this stream."""
        self.conn.streams.pop(self.id, None)

    def __aiter__(self):
        return self

    async def __anext__(self):
        item = await self.inbox.get()
        if item is _END:
            raise StopAsyncIteration
        if isinstance(item, RpcError):
            raise item
        return item


class _Conn:
    def __init__(self, reader, writer):
        self.reader = reader
        self.writer = writer
        self.streams: dict[int, _Stream] = {}
        self.next_id = 1
        self.lock = asyncio.Lock()
        self.closed = asyncio.Event()
        self._tasks: set = set()  # handler tasks, strongly referenced

    async def pump(self, dispatch=None):
        """Read frames and route them to streams; ``dispatch`` handles
        new CALL frames (server side)."""
        try:
            while True:
                stream_id, kind, payload = await _read_frame(self.reader)
                if kind == KIND_CALL:
                    if dispatch is None:
                        continue
                    st = _Stream(self, stream_id, method=payload.decode())
                    self.streams[stream_id] = st
                    t = asyncio.ensure_future(dispatch(st.method, st))
                    self._tasks.add(t)
                    t.add_done_callback(self._tasks.discard)
                elif stream_id in self.streams:
                    st = self.streams[stream_id]
                    if kind == KIND_MSG:
                        st.inbox.put_nowait(payload)
                    elif kind == KIND_END:
                        st.inbox.put_nowait(_END)
                        self.streams.pop(stream_id, None)
                    elif kind == KIND_ERR:
                        st.inbox.put_nowait(RpcError(payload.decode()))
                        self.streams.pop(stream_id, None)
        except (asyncio.IncompleteReadError, ConnectionError, OSError, RpcError):
            pass
        finally:
            self.closed.set()
            for st in self.streams.values():
                st.inbox.put_nowait(_END)
            try:
                self.writer.close()
            except (OSError, RuntimeError):
                pass  # transport already torn down


class RpcServer:
    """method name → async handler(stream)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 ssl_ctx: ssl.SSLContext | None = None):
        self.host, self.port = host, port
        self.ssl_ctx = ssl_ctx
        self.handlers: dict[str, object] = {}
        self._server: asyncio.AbstractServer | None = None
        self._conns: set[_Conn] = set()

    def register(self, method: str, handler):
        self.handlers[method] = handler

    def register_unary(self, method: str, fn):
        """fn: async (request_bytes) -> response_bytes."""

        async def handler(stream: _Stream):
            try:
                req = await stream.__anext__()
                resp = await fn(req)
                await stream.send(resp)
                await stream.end()
            except RpcError as e:
                await stream.error(str(e))
            except Exception as e:  # a handler fault reaches the client as ERR
                await stream.error(f"{type(e).__name__}: {e}")

        self.register(method, handler)

    async def start(self):
        async def on_conn(reader, writer):
            conn = _Conn(reader, writer)
            self._conns.add(conn)

            async def dispatch(method: str, st: _Stream):
                h = self.handlers.get(method)
                if h is None:
                    await st.error(f"unknown method {method}")
                    st.dispose()
                    return
                try:
                    await h(st)
                except RpcError as e:
                    await st.error(str(e))
                except (ConnectionError, OSError):
                    pass
                except Exception as e:
                    try:
                        await st.error(f"{type(e).__name__}: {e}")
                    except (ConnectionError, OSError, RuntimeError):
                        pass  # the client went away first
                finally:
                    st.dispose()

            try:
                await conn.pump(dispatch)
            finally:
                self._conns.discard(conn)

        self._server = await asyncio.start_server(on_conn, self.host, self.port,
                                                  ssl=self.ssl_ctx)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def stop(self):
        if self._server is not None:
            self._server.close()
            for conn in list(self._conns):
                try:
                    conn.writer.close()
                except (OSError, RuntimeError):
                    pass  # already closed
            try:
                await asyncio.wait_for(self._server.wait_closed(), 2.0)
            except asyncio.TimeoutError:
                pass


class RpcClient:
    """One connection to a server; ``open_stream()`` / ``unary()`` per call."""

    def __init__(self, host: str, port: int, ssl_ctx: ssl.SSLContext | None = None):
        self.host, self.port = host, port
        self.ssl_ctx = ssl_ctx
        self.conn: _Conn | None = None
        self._pump_task = None

    async def connect(self):
        reader, writer = await asyncio.open_connection(self.host, self.port, ssl=self.ssl_ctx)
        self.conn = _Conn(reader, writer)
        self._pump_task = asyncio.ensure_future(self.conn.pump())
        return self

    async def open_stream(self, method: str) -> _Stream:
        if self.conn is None or self.conn.closed.is_set():
            await self.connect()
        async with self.conn.lock:
            stream_id = self.conn.next_id
            self.conn.next_id += 1
        st = _Stream(self.conn, stream_id, method=method)
        self.conn.streams[stream_id] = st
        await _write_frame(self.conn.writer, stream_id, KIND_CALL, method.encode())
        return st

    async def unary(self, method: str, request: bytes, timeout: float = 10.0) -> bytes:
        st = await self.open_stream(method)
        try:
            await st.send(request)
            await st.end()
            return await asyncio.wait_for(st.__anext__(), timeout)
        except StopAsyncIteration:
            raise RpcError(f"{method}: stream closed without response")
        finally:
            st.dispose()

    async def close(self):
        if self.conn is not None:
            try:
                self.conn.writer.close()
            except (OSError, RuntimeError):
                pass  # already closed
            self.conn = None
        if self._pump_task:
            self._pump_task.cancel()


def _load_chain(ctx: ssl.SSLContext, cert_pem: bytes, key_pem: bytes) -> None:
    import tempfile

    with tempfile.NamedTemporaryFile(suffix=".pem") as cf, \
            tempfile.NamedTemporaryFile(suffix=".pem") as kf:
        cf.write(cert_pem)
        cf.flush()
        kf.write(key_pem)
        kf.flush()
        ctx.load_cert_chain(cf.name, kf.name)


def make_server_tls(cert_pem: bytes, key_pem: bytes, ca_pem: bytes | None = None):
    """Server-side TLS context; with ``ca_pem`` a client certificate
    that chains to it is required (mutual TLS)."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    _load_chain(ctx, cert_pem, key_pem)
    if ca_pem:
        ctx.load_verify_locations(cadata=ca_pem.decode())
        ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx


def make_client_tls(ca_pem: bytes, cert_pem: bytes | None = None,
                    key_pem: bytes | None = None):
    """Client-side TLS context trusting ``ca_pem``, presenting
    ``cert_pem``/``key_pem`` when given."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.check_hostname = False
    ctx.load_verify_locations(cadata=ca_pem.decode())
    if cert_pem and key_pem:
        _load_chain(ctx, cert_pem, key_pem)
    return ctx


class TlsProfile:
    """One node's TLS material: its certificate and key and the CA
    bundle it trusts.  Every listener built from it requires client
    certificates and every dial presents one."""

    def __init__(self, cert_pem: bytes, key_pem: bytes, ca_pem: bytes):
        self.cert_pem = cert_pem
        self.key_pem = key_pem
        self.ca_pem = ca_pem
        self._server = None
        self._client = None

    @classmethod
    def load(cls, cert_path: str, key_path: str, ca_path: str) -> "TlsProfile":
        with open(cert_path, "rb") as f:
            cert = f.read()
        with open(key_path, "rb") as f:
            key = f.read()
        with open(ca_path, "rb") as f:
            ca = f.read()
        return cls(cert, key, ca)

    def server_ctx(self) -> ssl.SSLContext:
        if self._server is None:
            self._server = make_server_tls(self.cert_pem, self.key_pem, self.ca_pem)
        return self._server

    def client_ctx(self) -> ssl.SSLContext:
        if self._client is None:
            self._client = make_client_tls(self.ca_pem, self.cert_pem, self.key_pem)
        return self._client
