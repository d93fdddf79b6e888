"""Carry a plain-data dump of the reference's world state, namespace
policies and identities into the port's objects, so both packages
validate against the same state.

    state rows:  (ns, key, value, (block, txnum)[, metadata])
                 (a private collection's hashed keys as rows of the
                 namespace ``ns$coll#hashed``; metadata: the encoded
                 key metadata, None without)
    namespaces:  {ns: policy DSL string}
    identities:  (msp_id, role, qx, qy)
    idemix MSPs: (msp_id, the issuer key's JSON, the epoch record's
                 JSON or None), as the reference's ``IssuerPublicKey``
                 and ``EpochRecord`` write them (``to_json``)
    a cryptogen org: its MSP id, its CA certificate's DER and its
                 members {name: (certificate DER, private scalar as an
                 int or 32 big-endian bytes)} (``from_cryptogen``)
"""

from __future__ import annotations

import json

from fabric_tpu_torch.crypto import der
from fabric_tpu_torch.crypto import policy as pol
from fabric_tpu_torch.crypto.cryptogen import SigningIdentity
from fabric_tpu_torch.crypto.idemix import IdemixMSP
from fabric_tpu_torch.crypto.identity import Identity
from fabric_tpu_torch.crypto.msp import MSP
from fabric_tpu_torch.ledger.statedb import MemVersionedDB, UpdateBatch
from fabric_tpu_torch.peer.validator import NamespaceInfo, PolicyProvider


def from_reference(state_rows, namespaces: dict, identities):
    """→ (MemVersionedDB, PolicyProvider, [Identity]) — identities are
    taken as valid (the reference's MSP validated them)."""
    db = MemVersionedDB()
    seed = UpdateBatch()
    for ns, key, value, version, *meta in state_rows:
        seed.put(ns, key, value, (int(version[0]), int(version[1])),
                 metadata=meta[0] if meta else None)
    db.apply_updates(seed)
    provider = PolicyProvider({ns: NamespaceInfo(policy=pol.from_dsl(dsl))
                               for ns, dsl in namespaces.items()})
    idents = [Identity(msp_id, role, int(qx), int(qy), True)
              for msp_id, role, qx, qy in identities]
    return db, provider, idents


def idemix_msp(msp_id: str, ipk_json: str, epoch_record_json: str | None = None) -> IdemixMSP:
    """The port's ``IdemixMSP`` over a reference MSP's issuer key and
    epoch record, read as the channel config's payload is (a record that
    does not verify against the key raises)."""
    return IdemixMSP.from_config(json.dumps({
        "msp_id": msp_id, "ipk": json.loads(ipk_json),
        "epoch_record": json.loads(epoch_record_json) if epoch_record_json else None}))


def from_cryptogen(msp_id: str, ca_cert_der: bytes, members: dict):
    """A reference cryptogen org's material → ({name: SigningIdentity},
    MSP).  Each certificate is carried as PEM in the reference's form
    (64 base64 characters a line), so a carried identity serializes to
    the reference's bytes and signs with the same key; the MSP is the
    reference's ``OrgMaterial.msp()``: the CA as its one root, NodeOUs
    on."""
    signers = {}
    for name, (cert_der, d) in members.items():
        d = int.from_bytes(d, "big") if isinstance(d, (bytes, bytearray)) else int(d)
        signers[name] = SigningIdentity(msp_id, d, der.pem_encode(bytes(cert_der)))
    return signers, MSP(msp_id, root_certs=[der.pem_encode(bytes(ca_cert_der))], node_ous=True)
