"""Wire format of the validation sidecar's ``validate`` stream
(counterpart: ``fabric_tpu/sidecar/wire.py``).

The unit on the wire is one block's signature batch, a list of
``(e, r, s, qx, qy)`` integer tuples; the reply is its verdict vector.
Frames ride ``comm.rpc`` MSG payloads:

    hello    := JSON {"tenant": str, "weight": float}
    welcome  := JSON {"ok": true, "tenant": str, "coalesce": int}
    request  := u32 hdr_len | JSON {"seq": int, "n": int
                [, "trace": {"block", "root", "tenant"}]} | items
    response := u32 hdr_len | JSON {"seq": int [, "status", "error",
                "retry_ms"] [, "remote": {"spans", "t_rx", "t_tx"}]}
                | verdict bytes (one 0/1 byte per item)

Every frame the port encodes is byte for byte the reference's.  The
optional ``trace`` request field carries the peer's trace context (its
block number, root span and tenant), under which the sidecar roots its
``queue_wait`` and ``dispatch`` spans; the optional ``remote`` response
field ships that finished subtree back (``spans``: ``Span.to_dict(0.0)``,
absolute times on the sidecar's clock; ``t_rx``/``t_tx``: the request's
receipt and the response's send on that clock), from which the client
estimates the clock offset and stitches the subtree onto its block.

``items`` packs each tuple as five 32-byte big-endian integers; a
component that does not fit becomes the all-zero item, which every
verifier rejects (r = 0), so an unpackable lane turns invalid, never
into a protocol error.  ``status == "BUSY"``: the tenant's queue is
full, retry after backoff.  ``status == "ERROR"``: the dispatch failed.
"""

from __future__ import annotations

import json
import struct

INT_BYTES = 32
ITEM_BYTES = 5 * INT_BYTES
_LEN = struct.Struct(">I")

#: the item every unpackable tuple degrades to (r = 0: always rejected)
INVALID_ITEM = (0, 0, 0, 0, 0)

_MAX = 1 << (8 * INT_BYTES)


def pack_items(tuples) -> bytes:
    out = bytearray()
    for item in tuples:
        vals = tuple(int(v) for v in item)
        if len(vals) != 5 or any(v < 0 or v >= _MAX for v in vals):
            vals = INVALID_ITEM
        for v in vals:
            out += v.to_bytes(INT_BYTES, "big")
    return bytes(out)


def unpack_items(buf: bytes) -> list:
    if len(buf) % ITEM_BYTES:
        raise ValueError(f"packed item buffer of {len(buf)} bytes is not a multiple "
                         f"of {ITEM_BYTES}")
    return [tuple(int.from_bytes(buf[off + i * INT_BYTES:off + (i + 1) * INT_BYTES], "big")
                  for i in range(5))
            for off in range(0, len(buf), ITEM_BYTES)]


def _frame(hdr: dict, body: bytes = b"") -> bytes:
    raw = json.dumps(hdr).encode()
    return _LEN.pack(len(raw)) + raw + body


def _unframe(payload: bytes) -> tuple[dict, bytes]:
    (n,) = _LEN.unpack_from(payload)
    hdr = json.loads(payload[_LEN.size:_LEN.size + n])
    return hdr, payload[_LEN.size + n:]


def encode_hello(tenant: str, weight: float) -> bytes:
    return json.dumps({"tenant": tenant, "weight": weight}).encode()


def encode_welcome(tenant: str, coalesce: int) -> bytes:
    return json.dumps({"ok": True, "tenant": tenant, "coalesce": coalesce}).encode()


def encode_request(seq: int, tuples, trace: dict | None = None) -> bytes:
    hdr = {"seq": int(seq), "n": len(tuples)}
    if trace:
        hdr["trace"] = trace
    return _frame(hdr, pack_items(tuples))


def decode_request(payload: bytes) -> tuple[dict, list]:
    hdr, body = _unframe(payload)
    items = unpack_items(body)
    if len(items) != int(hdr.get("n", len(items))):
        raise ValueError(f"request {hdr.get('seq')}: header says {hdr.get('n')} items, "
                         f"payload carries {len(items)}")
    return hdr, items


def encode_response(seq: int, verdicts, remote: dict | None = None) -> bytes:
    hdr = {"seq": int(seq)}
    if remote:
        hdr["remote"] = remote
    return _frame(hdr, bytes(1 if v else 0 for v in verdicts))


def encode_busy(seq: int, retry_ms: float) -> bytes:
    return _frame({"seq": int(seq), "status": "BUSY", "retry_ms": round(float(retry_ms), 3)})


def encode_error(seq: int, msg: str) -> bytes:
    return _frame({"seq": int(seq), "status": "ERROR", "error": msg[:500]})


def decode_response(payload: bytes) -> tuple[dict, list]:
    """→ (header, verdicts); verdicts empty for BUSY/ERROR headers."""
    hdr, body = _unframe(payload)
    return hdr, [bool(b) for b in body]
