"""Proto3 JSON over the port's ``Message`` (counterpart:
``google.protobuf.json_format`` as ``fabric_tpu/tools/configtxlator.py``
calls it: ``MessageToJson(preserving_proto_field_name=True,
sort_keys=True)`` and ``Parse``).

``to_json`` writes the proto3 JSON mapping with the proto field names:
64-bit integers as strings, 32-bit ones as numbers, bytes as padded
standard base64, an enum field by its value's name (the port stores an
enum as its int32, so ``ENUMS`` names the values of the enum fields of
the configtxlator's messages; a number no name has stays a number),
maps as objects, sub-messages as objects.  A proto3 scalar at its
default value, an empty list and an empty map are left out; a
sub-message that is present is written even when empty, and a oneof
member that is set is written even at its zero value
(``SignaturePolicy.signed_by = 0``).  The text is ``json.dumps`` with an
indent of 2, sorted keys and ASCII escapes, as ``MessageToJson``'s is.

``from_json`` is ``Parse``: a field by its proto name or its lowerCamel
JSON name, an integer as a number or a decimal string, bytes as
standard or URL-safe base64 with or without padding, an enum by name or
number, ``null`` as the field's default; an unknown field raises
``JsonFormatError``.
"""

from __future__ import annotations

import base64
import binascii
import json

from fabric_tpu_torch.protos import messages as m
from fabric_tpu_torch.protos.wire import (BOOL, BYTES, INT32, INT64, MAP, MESSAGE, STRING,
                                          UINT32, UINT64)


class JsonFormatError(ValueError):
    """JSON that does not map onto the message."""


#: (message class, field) → {number: name} of the enum fields the
#: configtxlator's messages reach (orderer.ConsensusType.State,
#: common.MSPPrincipal.Classification)
ENUMS = {
    (m.ConsensusType, "state"): {0: "STATE_NORMAL", 1: "STATE_MAINTENANCE"},
    (m.MSPPrincipal, "principal_classification"): {
        0: "ROLE", 1: "ORGANIZATION_UNIT", 2: "IDENTITY", 3: "ANONYMITY", 4: "COMBINED"},
}

_RANGES = {INT32: (-(1 << 31), (1 << 31) - 1), INT64: (-(1 << 63), (1 << 63) - 1),
           UINT32: (0, (1 << 32) - 1), UINT64: (0, (1 << 64) - 1)}


def _scalar_out(cls, f, v):
    if f.kind in (INT64, UINT64):
        return str(v)
    if f.kind == BYTES:
        return base64.b64encode(v).decode("ascii")
    if f.kind == INT32 and (cls, f.name) in ENUMS:
        return ENUMS[(cls, f.name)].get(v, v)
    return v


def _value_out(cls, f, v):
    if f.kind == MESSAGE:
        return to_dict(v)
    return _scalar_out(cls, f, v)


def to_dict(msg) -> dict:
    """The message as the proto3 JSON object (proto field names)."""
    cls = type(msg)
    out = {}
    for f in cls.FIELDS:
        v = getattr(msg, f.name)
        if f.repeated:
            if v:
                out[f.name] = [_value_out(cls, f, x) for x in v]
        elif f.kind == MAP:
            if v:
                out[f.name] = {k: (to_dict(x) if f.message is not None
                                   else base64.b64encode(x).decode("ascii"))
                               for k, x in v.items()}
        elif f.kind == MESSAGE:
            if v is not None:
                out[f.name] = to_dict(v)
        elif f.oneof is not None:
            if v is not None:
                out[f.name] = _scalar_out(cls, f, v)
        elif v != f.default():
            out[f.name] = _scalar_out(cls, f, v)
    return out


def to_json(msg) -> str:
    """``MessageToJson(msg, preserving_proto_field_name=True,
    sort_keys=True)``."""
    return json.dumps(to_dict(msg), indent=2, sort_keys=True)


def _camel(name: str) -> str:
    head, *rest = name.split("_")
    return head + "".join(p[:1].upper() + p[1:] for p in rest)


def _int_in(cls, f, v):
    if isinstance(v, str) and (cls, f.name) in ENUMS:
        names = {n: k for k, n in ENUMS[(cls, f.name)].items()}
        if v in names:
            return names[v]
    if isinstance(v, bool):
        raise JsonFormatError(f"{cls.__name__}.{f.name}: expected an integer, got {v!r}")
    if isinstance(v, float) and v.is_integer():
        v = int(v)
    if isinstance(v, str):
        try:
            v = int(v)
        except ValueError:
            raise JsonFormatError(f"{cls.__name__}.{f.name}: not an integer: {v!r}") from None
    if not isinstance(v, int):
        raise JsonFormatError(f"{cls.__name__}.{f.name}: expected an integer, got {v!r}")
    lo, hi = _RANGES[f.kind]
    if not lo <= v <= hi:
        raise JsonFormatError(f"{cls.__name__}.{f.name}: {v} out of range")
    return v


def _bytes_in(cls, name, v) -> bytes:
    if not isinstance(v, str):
        raise JsonFormatError(f"{cls.__name__}.{name}: expected base64 text")
    raw = v.encode("ascii", "replace")
    try:
        return base64.urlsafe_b64decode(raw + b"=" * (-len(raw) % 4))
    except (binascii.Error, ValueError) as e:
        raise JsonFormatError(f"{cls.__name__}.{name}: bad base64: {e}") from None


def _scalar_in(cls, f, v):
    if f.kind == MESSAGE:
        if not isinstance(v, dict):
            raise JsonFormatError(f"{cls.__name__}.{f.name}: expected an object")
        return from_dict(f.message, v)
    if f.kind == BYTES:
        return _bytes_in(cls, f.name, v)
    if f.kind == STRING:
        if not isinstance(v, str):
            raise JsonFormatError(f"{cls.__name__}.{f.name}: expected a string")
        return v
    if f.kind == BOOL:
        if not isinstance(v, bool):
            raise JsonFormatError(f"{cls.__name__}.{f.name}: expected a bool")
        return v
    return _int_in(cls, f, v)


def from_dict(cls, obj: dict):
    """A proto3 JSON object → a new ``cls`` message."""
    by_name = {}
    for f in cls.FIELDS:
        by_name[f.name] = f
        by_name.setdefault(_camel(f.name), f)
    msg = cls()
    for key, v in obj.items():
        f = by_name.get(key)
        if f is None:
            raise JsonFormatError(f'Message type "{cls.__name__}" has no field named "{key}"')
        if v is None:
            continue
        if f.repeated:
            if not isinstance(v, list):
                raise JsonFormatError(f"{cls.__name__}.{f.name}: expected a list")
            setattr(msg, f.name, [_scalar_in(cls, f, x) for x in v])
        elif f.kind == MAP:
            if not isinstance(v, dict):
                raise JsonFormatError(f"{cls.__name__}.{f.name}: expected an object")
            setattr(msg, f.name, {
                k: (from_dict(f.message, x) if f.message is not None
                    else _bytes_in(cls, f.name, x)) for k, x in v.items()})
        else:
            setattr(msg, f.name, _scalar_in(cls, f, v))
    return msg


def from_json(cls, text: str):
    """``json_format.Parse(text, cls())``."""
    try:
        obj = json.loads(text)
    except json.JSONDecodeError as e:
        raise JsonFormatError(f"bad JSON: {e}") from None
    if not isinstance(obj, dict):
        raise JsonFormatError("expected a JSON object")
    return from_dict(cls, obj)
