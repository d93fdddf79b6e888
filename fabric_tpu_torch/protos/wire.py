"""The protobuf wire codec the port reads and writes blocks with
(counterpart: the ``fabric_tpu/protos/*_pb2`` modules as
``google.protobuf``'s upb runtime parses and serializes them; the
strictness rules are those ``fabric_tpu/native/blockparse.cpp:455-660``
copies from upb).

A message is a ``Message`` subclass whose ``FIELDS`` list its proto3
schema.  Decoding accepts exactly what upb accepts:

* varints of at most 10 bytes (bits past the 64th dropped); tags of at
  most 5 bytes, at most 2^32 - 1, never field number 0;
* length prefixes below 2^31 - 1 that stay inside the buffer;
* wire types 0, 1, 2 and 5, and well-framed groups (3 ... 4, matching
  field numbers) in unknown fields; an end-group tag outside its group
  is an error; sub-messages and groups nest at most 100 deep;
* unknown fields are kept (re-encoded after the known ones, as upb
  does); a known field with the wrong wire type is such an unknown
  field;
* a proto3 ``string`` that is not valid UTF-8 is an error;
* singular scalars: the last occurrence wins; repeated fields
  concatenate; a singular sub-message that occurs twice is MERGED (the
  second occurrence is parsed into the first), so two ``action``
  occurrences concatenate their endorsements; a oneof member clears
  the other members;
* a oneof member may be a scalar (``SignaturePolicy.signed_by``): it is
  None while unset, and set it is written even at its zero value;
* a map field (string keys; bytes values, or sub-message values for a
  field given ``message=``, as ``ConfigGroup.groups``) is a repeated
  entry message (key = 1, value = 2; the last entry of a key wins; a
  missing value is the empty bytes or message); an entry carrying
  unknown fields stays out of the map and goes, re-encoded, to the
  message's unknown fields, as in upb.

Encoding is ``SerializeToString()``'s: fields in number order, proto3
scalar defaults left out, a present sub-message written even when
empty, map entries with both key and value in the order
``deterministic=True`` gives (bytewise by key, a key after the longer
keys it is a prefix of; upb's default order for a map of two or more
entries is its hash table's).  Integer kinds are int32 (also an open
proto3 enum), int64, uint32, uint64 and bool; no schema of the port
has fixed-width, zigzag, float or packed fields, and ``Field`` refuses
them.
"""

from __future__ import annotations

_MASK64 = (1 << 64) - 1
_MAX_DEPTH = 100

INT32, INT64, UINT32, UINT64, BOOL, STRING, BYTES, MESSAGE, MAP = range(9)
_VARINT_KINDS = (INT32, INT64, UINT32, UINT64, BOOL)
_LEN_KINDS = (STRING, BYTES, MESSAGE, MAP)
_DEFAULTS = {INT32: 0, INT64: 0, UINT32: 0, UINT64: 0, BOOL: False, STRING: "", BYTES: b""}


class DecodeError(ValueError):
    """The bytes are not a valid encoding of the message."""


class Field:
    """One field of a schema.  ``message``: the sub-message class of a
    MESSAGE field; ``oneof``: the name of the oneof the field belongs to."""

    __slots__ = ("number", "name", "kind", "repeated", "message", "oneof", "tag")

    def __init__(self, number, name, kind, repeated=False, message=None, oneof=None):
        if kind not in _VARINT_KINDS + _LEN_KINDS:
            raise ValueError(f"field {name}: unsupported kind {kind}")
        if repeated and kind in _VARINT_KINDS:
            raise ValueError(f"field {name}: repeated numeric fields (packed) are not supported")
        if oneof is not None and (kind == MAP or repeated):
            raise ValueError(f"field {name}: only singular fields may be oneof members")
        self.number, self.name, self.kind = number, name, kind
        self.repeated, self.message, self.oneof = repeated, message, oneof
        self.tag = (number << 3) | (0 if kind in _VARINT_KINDS else 2)

    def default(self):
        if self.oneof is not None:
            return None
        if self.repeated:
            return []
        if self.kind == MAP:
            return {}
        if self.kind == MESSAGE:
            return None
        return _DEFAULTS[self.kind]


class Message:
    """Base of the port's messages.  Scalars default to their proto3
    zero value, repeated fields to ``[]``, maps to ``{}``, singular
    sub-messages to None (absent)."""

    FIELDS: tuple = ()

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        cls.set_fields(cls.FIELDS)

    @classmethod
    def set_fields(cls, fields) -> None:
        """Install the schema ``fields``; a recursive message (one whose
        fields name its own class) is declared first and given its
        fields after."""
        cls.FIELDS = tuple(fields)
        cls._ORDER = tuple(sorted(cls.FIELDS, key=lambda f: f.number))
        cls._BY_TAG = {f.tag: f for f in cls.FIELDS}
        cls._NAMES = frozenset(f.name for f in cls.FIELDS)
        oneofs: dict = {}
        for f in cls.FIELDS:
            if f.oneof is not None:
                oneofs.setdefault(f.oneof, []).append(f.name)
        cls._ONEOF_PEERS = {f.name: tuple(n for n in oneofs[f.oneof] if n != f.name)
                            for f in cls.FIELDS if f.oneof is not None}
        cls._FIXED = {f.name: f.default() for f in cls.FIELDS
                      if not f.repeated and f.kind != MAP}
        cls._LISTS = tuple(f.name for f in cls.FIELDS if f.repeated)
        cls._MAPS = tuple(f.name for f in cls.FIELDS if f.kind == MAP)

    def __init__(self, **kw):
        d = self.__dict__
        d.update(self._FIXED)
        for name in self._LISTS:
            d[name] = []
        for name in self._MAPS:
            d[name] = {}
        d["_unknown"] = []
        for k, v in kw.items():
            if k not in self._NAMES:
                raise TypeError(f"{type(self).__name__} has no field {k!r}")
            d[k] = v

    def __eq__(self, other):
        if type(other) is not type(self):
            return NotImplemented
        return all(getattr(self, f.name) == getattr(other, f.name) for f in self.FIELDS) \
            and b"".join(self._unknown) == b"".join(other._unknown)

    def __repr__(self):
        inner = ", ".join(f"{f.name}={getattr(self, f.name)!r}" for f in self.FIELDS
                          if getattr(self, f.name) != f.default())
        return f"{type(self).__name__}({inner})"

    @classmethod
    def parse(cls, data) -> "Message":
        """``data`` → a new message; raises ``DecodeError``."""
        msg = cls()
        data = bytes(data)
        _merge(msg, data, 0, len(data), _MAX_DEPTH)
        return msg

    def serialize(self) -> bytes:
        out = bytearray()
        _encode(self, out)
        return bytes(out)

    def copy(self) -> "Message":
        """A deep copy (the reference's ``CopyFrom``)."""
        return type(self).parse(self.serialize())


# ---------------------------------------------------------------------------
# Decoding


def _varint(buf: bytes, pos: int, end: int):
    if pos >= end:
        raise DecodeError("truncated varint")
    b = buf[pos]
    if b < 0x80:
        return b, pos + 1
    result, shift = b & 0x7F, 7
    pos += 1
    while True:
        if pos >= end:
            raise DecodeError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result & _MASK64, pos
        shift += 7
        if shift >= 70:
            raise DecodeError("varint longer than 10 bytes")


def _tag(buf: bytes, pos: int, end: int):
    start = pos
    tag, pos = _varint(buf, pos, end)
    if pos - start > 5 or tag > 0xFFFFFFFF:
        raise DecodeError("bad tag")
    if tag < 8:
        raise DecodeError("field number 0")
    return tag, pos


def _length(buf: bytes, pos: int, end: int):
    """A length prefix at ``pos`` → (start, end) of the bytes it frames."""
    n, pos = _varint(buf, pos, end)
    if n >= 0x7FFFFFFF or n > end - pos:
        raise DecodeError("length prefix past the end of the buffer")
    return pos, pos + n


def _skip(buf: bytes, pos: int, end: int, tag: int, depth: int) -> int:
    """Skip the value of an unknown field whose tag ends at ``pos``."""
    wt = tag & 7
    if wt == 0:
        return _varint(buf, pos, end)[1]
    if wt == 2:
        return _length(buf, pos, end)[1]
    if wt == 5 or wt == 1:
        n = 4 if wt == 5 else 8
        if end - pos < n:
            raise DecodeError("truncated fixed-width value")
        return pos + n
    if wt == 3:
        depth -= 1
        if depth < 0:
            raise DecodeError("nesting deeper than 100")
        number = tag >> 3
        while True:
            if pos >= end:
                raise DecodeError("unterminated group")
            t, pos = _tag(buf, pos, end)
            if t & 7 == 4:
                if t >> 3 != number:
                    raise DecodeError("mismatched end-group tag")
                return pos
            pos = _skip(buf, pos, end, t, depth)
    raise DecodeError(f"wire type {wt} outside a group" if wt == 4 else f"wire type {wt}")


def _utf8(raw: bytes) -> str:
    try:
        return raw.decode("utf-8")
    except UnicodeDecodeError as e:
        raise DecodeError("invalid UTF-8 in a string field") from e


def _scalar(kind: int, v: int):
    if kind == UINT64:
        return v
    if kind == BOOL:
        return v != 0
    if kind == INT64:
        return v - (1 << 64) if v >> 63 else v
    v &= 0xFFFFFFFF
    if kind == UINT32:
        return v
    return v - (1 << 32) if v >> 31 else v  # INT32


def _merge(msg: Message, buf: bytes, pos: int, end: int, depth: int) -> None:
    by_tag = msg._BY_TAG
    while pos < end:
        start = pos
        b = buf[pos]
        if 8 <= b < 0x80:
            tag = b
            pos += 1
        else:
            tag, pos = _tag(buf, pos, end)
        f = by_tag.get(tag)
        if f is None:
            pos = _skip(buf, pos, end, tag, depth)
            msg._unknown.append(buf[start:pos])
            continue
        kind = f.kind
        if f.oneof is not None:
            _clear_peers(msg, f)
        if kind <= BOOL:
            v, pos = _varint(buf, pos, end)
            setattr(msg, f.name, _scalar(kind, v))
            continue
        pos, nxt = _length(buf, pos, end)
        if kind == BYTES:
            v = buf[pos:nxt]
        elif kind == STRING:
            v = _utf8(buf[pos:nxt])
        elif kind == MESSAGE:
            if depth <= 0:
                raise DecodeError("nesting deeper than 100")
            if f.repeated:
                sub = f.message()
                _merge(sub, buf, pos, nxt, depth - 1)
                getattr(msg, f.name).append(sub)
            else:
                sub = getattr(msg, f.name)
                if sub is None:
                    sub = f.message()
                    setattr(msg, f.name, sub)
                _merge(sub, buf, pos, nxt, depth - 1)
            pos = nxt
            continue
        else:  # MAP
            if depth <= 0:
                raise DecodeError("nesting deeper than 100")
            k, val, raw = _map_entry(buf, pos, nxt, depth - 1, f.message)
            if raw is None:
                getattr(msg, f.name)[k] = val
            else:
                msg._unknown.append(varint(f.tag) + varint(len(raw)) + raw)
            pos = nxt
            continue
        pos = nxt
        if f.repeated:
            getattr(msg, f.name).append(v)
        else:
            setattr(msg, f.name, v)


def _clear_peers(msg: Message, f: Field) -> None:
    for name in msg._ONEOF_PEERS[f.name]:
        setattr(msg, name, None)


def _map_entry(buf: bytes, pos: int, end: int, depth: int, vmsg=None):
    """One map entry (key = 1, value = 2, both optional; the last
    occurrence of the key wins, a repeated message value merges) →
    (key, value, None), or (None, None, entry bytes re-encoded) for an
    entry with unknown fields.  ``vmsg``: the value's message class,
    None for bytes."""
    key, unknown = "", []
    val = b"" if vmsg is None else vmsg()
    while pos < end:
        start = pos
        tag, pos = _tag(buf, pos, end)
        if tag == 0x0A:
            pos, nxt = _length(buf, pos, end)
            key, pos = _utf8(buf[pos:nxt]), nxt
        elif tag == 0x12:
            pos, nxt = _length(buf, pos, end)
            if vmsg is None:
                val = buf[pos:nxt]
            else:
                if depth <= 0:
                    raise DecodeError("nesting deeper than 100")
                _merge(val, buf, pos, nxt, depth - 1)
            pos = nxt
        else:
            pos = _skip(buf, pos, end, tag, depth)
            unknown.append(buf[start:pos])
    if not unknown:
        return key, val, None
    entry = bytearray()
    if key:
        entry += b"\x0a"
        _encode_value(STRING, key, entry)
    if vmsg is not None:
        entry += b"\x12"
        _encode_value(MESSAGE, val, entry)
    elif val:
        entry += b"\x12"
        _encode_value(BYTES, val, entry)
    return None, None, bytes(entry) + b"".join(unknown)


# ---------------------------------------------------------------------------
# Encoding


def varint(n: int) -> bytes:
    """The unsigned varint of ``n`` (negative: its 64-bit two's complement)."""
    n &= _MASK64
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _encode_value(kind: int, v, out: bytearray) -> None:
    if kind <= BOOL:
        out += varint(int(v))
    elif kind == STRING:
        raw = v.encode("utf-8")
        out += varint(len(raw))
        out += raw
    elif kind == BYTES:
        out += varint(len(v))
        out += v
    else:
        raw = v.serialize()
        out += varint(len(raw))
        out += raw


def _map_order(k: str):
    """upb's deterministic order of string map keys: bytewise, except
    that a key sorts after the longer keys it is a prefix of."""
    return (*k.encode("utf-8"), 256)


def _encode(msg: Message, out: bytearray) -> None:
    for f in msg._ORDER:
        v = getattr(msg, f.name)
        kind = f.kind
        if f.repeated:
            t = varint(f.tag)
            for item in v:
                out += t
                _encode_value(kind, item, out)
        elif kind == MAP:
            t = varint(f.tag)
            vkind = BYTES if f.message is None else MESSAGE
            for k in sorted(v, key=_map_order):
                entry = bytearray(b"\x0a")
                _encode_value(STRING, k, entry)
                entry += b"\x12"
                _encode_value(vkind, v[k], entry)
                out += t
                out += varint(len(entry))
                out += entry
        elif kind == MESSAGE or f.oneof is not None:
            if v is not None:
                out += varint(f.tag)
                _encode_value(kind, v, out)
        elif v != _DEFAULTS[kind]:
            out += varint(f.tag)
            _encode_value(kind, v, out)
    for raw in msg._unknown:
        out += raw
