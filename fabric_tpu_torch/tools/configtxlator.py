"""configtxlator: config proto ↔ JSON and config-update deltas
(counterpart: ``fabric_tpu/tools/configtxlator.py``).

``proto_decode`` / ``proto_encode`` translate the message types of
``_TYPES`` through ``protos/jsonfmt.py`` (the text of
``json_format.MessageToJson(preserving_proto_field_name=True,
sort_keys=True)``); ``compute_update`` is ``tools/configtxgen.py``'s
read/write-set delta between two serialized configs.
"""

from __future__ import annotations

from fabric_tpu_torch.protos import jsonfmt
from fabric_tpu_torch.protos import messages as m

_TYPES = {
    "common.Config": m.Config,
    "common.ConfigEnvelope": m.ConfigEnvelope,
    "common.ConfigUpdate": m.ConfigUpdate,
    "common.ConfigUpdateEnvelope": m.ConfigUpdateEnvelope,
    "common.Block": m.Block,
    "common.Envelope": m.Envelope,
    "common.Payload": m.Payload,
    "orderer.ConsensusType": m.ConsensusType,
    "orderer.RaftConfigMetadata": m.RaftConfigMetadata,
    "policies.SignaturePolicyEnvelope": m.SignaturePolicyEnvelope,
}


def message_type(name: str):
    try:
        return _TYPES[name]
    except KeyError:
        raise ValueError(f"unknown message type {name!r}; known: {sorted(_TYPES)}") from None


def proto_decode(type_name: str, data: bytes) -> str:
    """Serialized proto → canonical JSON."""
    return jsonfmt.to_json(message_type(type_name).parse(data))


def proto_encode(type_name: str, json_text: str) -> bytes:
    """JSON → serialized proto (round-trips ``proto_decode``)."""
    return jsonfmt.from_json(message_type(type_name), json_text).serialize()


def compute_update(channel_id: str, original: bytes, updated: bytes) -> bytes:
    """Two serialized ``common.Config``s → the serialized
    ``common.ConfigUpdate`` delta (read set with version pins + write
    set)."""
    from fabric_tpu_torch.tools import configtxgen as ctg

    return ctg.compute_update(channel_id, m.Config.parse(original),
                              m.Config.parse(updated)).serialize()
