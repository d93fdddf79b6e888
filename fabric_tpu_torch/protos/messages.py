"""The message schemas the port reads and writes (counterparts:
``fabric_tpu/protos/common.proto``, ``proposal.proto``,
``transaction.proto``, ``rwset.proto``, ``timestamp.proto``,
``configtx.proto``, ``policies.proto`` and the channel-config part of
``orderer.proto``; same field numbers, kinds and names; an enum field
is its int32).  ``Block`` takes the place of ``common_pb2.Block`` on
the port's entry.  A config tree's maps (``ConfigGroup.groups``,
``values``, ``policies``) serialize in ``deterministic=True`` order, so
the bytes a config hash or an update delta is taken over are the same
in both packages; ``copy()`` is a deep copy (the reference's
``CopyFrom``)."""

from __future__ import annotations

from fabric_tpu_torch.protos.wire import (
    BOOL, BYTES, INT32, INT64, MAP, MESSAGE, STRING, UINT32, UINT64, Field, Message,
)

# common.HeaderType values the front end tells apart
HEADER_CONFIG, HEADER_ENDORSER_TRANSACTION = 1, 3
# common.BlockMetadataIndex: five slots, SIGNATURES the first,
# TRANSACTIONS_FILTER the third, ORDERER the fourth, COMMIT_HASH the fifth
META_SIGNATURES, META_TRANSACTIONS_FILTER, META_ORDERER, META_COMMIT_HASH = 0, 2, 3, 4
N_METADATA = 5
# protos.ChaincodeSpec.Type
CHAINCODE_EXTERNAL = 5


class Timestamp(Message):
    FIELDS = (Field(1, "seconds", INT64), Field(2, "nanos", INT32))


# -- common.proto -------------------------------------------------------------


class Header(Message):
    FIELDS = (Field(1, "channel_header", BYTES), Field(2, "signature_header", BYTES))


class ChannelHeader(Message):
    FIELDS = (Field(1, "type", INT32), Field(2, "version", INT32),
              Field(3, "timestamp", MESSAGE, message=Timestamp),
              Field(4, "channel_id", STRING), Field(5, "tx_id", STRING),
              Field(6, "epoch", UINT64), Field(7, "extension", BYTES),
              Field(8, "tls_cert_hash", BYTES))


class SignatureHeader(Message):
    FIELDS = (Field(1, "creator", BYTES), Field(2, "nonce", BYTES))


class SerializedIdentity(Message):
    FIELDS = (Field(1, "mspid", STRING), Field(2, "id_bytes", BYTES))


class Payload(Message):
    FIELDS = (Field(1, "header", MESSAGE, message=Header), Field(2, "data", BYTES))


class Envelope(Message):
    FIELDS = (Field(1, "payload", BYTES), Field(2, "signature", BYTES))


class BlockHeader(Message):
    FIELDS = (Field(1, "number", UINT64), Field(2, "previous_hash", BYTES),
              Field(3, "data_hash", BYTES))


class BlockData(Message):
    FIELDS = (Field(1, "data", BYTES, repeated=True),)


class BlockMetadata(Message):
    FIELDS = (Field(1, "metadata", BYTES, repeated=True),)


class Block(Message):
    FIELDS = (Field(1, "header", MESSAGE, message=BlockHeader),
              Field(2, "data", MESSAGE, message=BlockData),
              Field(3, "metadata", MESSAGE, message=BlockMetadata))


class MetadataSignature(Message):
    FIELDS = (Field(1, "signature_header", BYTES), Field(2, "signature", BYTES),
              Field(3, "identifier_header", BYTES))


class Metadata(Message):
    FIELDS = (Field(1, "value", BYTES),
              Field(2, "signatures", MESSAGE, repeated=True, message=MetadataSignature))


# -- proposal.proto -----------------------------------------------------------


class ChaincodeID(Message):
    FIELDS = (Field(1, "path", STRING), Field(2, "name", STRING), Field(3, "version", STRING))


class SignedProposal(Message):
    FIELDS = (Field(1, "proposal_bytes", BYTES), Field(2, "signature", BYTES))


class Proposal(Message):
    FIELDS = (Field(1, "header", BYTES), Field(2, "payload", BYTES), Field(3, "extension", BYTES))


class ChaincodeHeaderExtension(Message):
    FIELDS = (Field(2, "chaincode_id", MESSAGE, message=ChaincodeID),)


class ChaincodeInput(Message):
    FIELDS = (Field(1, "args", BYTES, repeated=True), Field(2, "decorations", MAP),
              Field(3, "is_init", BOOL))


class ChaincodeSpec(Message):
    FIELDS = (Field(1, "type", INT32), Field(2, "chaincode_id", MESSAGE, message=ChaincodeID),
              Field(3, "input", MESSAGE, message=ChaincodeInput), Field(4, "timeout", INT32))


class ChaincodeInvocationSpec(Message):
    FIELDS = (Field(1, "chaincode_spec", MESSAGE, message=ChaincodeSpec),)


class ChaincodeProposalPayload(Message):
    FIELDS = (Field(1, "input", BYTES), Field(2, "TransientMap", MAP))


class Response(Message):
    FIELDS = (Field(1, "status", INT32), Field(2, "message", STRING), Field(3, "payload", BYTES))


class Endorsement(Message):
    FIELDS = (Field(1, "endorser", BYTES), Field(2, "signature", BYTES))


class ProposalResponse(Message):
    FIELDS = (Field(1, "version", INT32), Field(2, "timestamp", MESSAGE, message=Timestamp),
              Field(4, "response", MESSAGE, message=Response), Field(5, "payload", BYTES),
              Field(6, "endorsement", MESSAGE, message=Endorsement),
              Field(7, "interest", STRING))


class ChaincodeEvent(Message):
    FIELDS = (Field(1, "chaincode_id", STRING), Field(2, "tx_id", STRING),
              Field(3, "event_name", STRING), Field(4, "payload", BYTES))


class ProposalResponsePayload(Message):
    FIELDS = (Field(1, "proposal_hash", BYTES), Field(2, "extension", BYTES))


class ChaincodeAction(Message):
    FIELDS = (Field(1, "results", BYTES), Field(2, "events", BYTES),
              Field(3, "response", MESSAGE, message=Response),
              Field(4, "chaincode_id", MESSAGE, message=ChaincodeID))


# -- transaction.proto ----------------------------------------------------------


class TransactionAction(Message):
    FIELDS = (Field(1, "header", BYTES), Field(2, "payload", BYTES))


class Transaction(Message):
    FIELDS = (Field(1, "actions", MESSAGE, repeated=True, message=TransactionAction),)


class ChaincodeEndorsedAction(Message):
    FIELDS = (Field(1, "proposal_response_payload", BYTES),
              Field(2, "endorsements", MESSAGE, repeated=True, message=Endorsement))


class ChaincodeActionPayload(Message):
    FIELDS = (Field(1, "chaincode_proposal_payload", BYTES),
              Field(2, "action", MESSAGE, message=ChaincodeEndorsedAction))


# -- rwset.proto ----------------------------------------------------------------


class Version(Message):
    FIELDS = (Field(1, "block_num", UINT64), Field(2, "tx_num", UINT64))


class KVRead(Message):
    FIELDS = (Field(1, "key", STRING), Field(2, "version", MESSAGE, message=Version))


class KVWrite(Message):
    FIELDS = (Field(1, "key", STRING), Field(2, "is_delete", BOOL), Field(3, "value", BYTES))


class KVMetadataEntry(Message):
    FIELDS = (Field(1, "name", STRING), Field(2, "value", BYTES))


class KVMetadataWrite(Message):
    FIELDS = (Field(1, "key", STRING),
              Field(2, "entries", MESSAGE, repeated=True, message=KVMetadataEntry))


class KVReadHash(Message):
    FIELDS = (Field(1, "key_hash", BYTES), Field(2, "version", MESSAGE, message=Version))


class KVWriteHash(Message):
    FIELDS = (Field(1, "key_hash", BYTES), Field(2, "is_delete", BOOL),
              Field(3, "value_hash", BYTES))


class KVMetadataWriteHash(Message):
    FIELDS = (Field(1, "key_hash", BYTES),
              Field(2, "entries", MESSAGE, repeated=True, message=KVMetadataEntry))


class QueryReads(Message):
    FIELDS = (Field(1, "kv_reads", MESSAGE, repeated=True, message=KVRead),)


class QueryReadsMerkleSummary(Message):
    FIELDS = (Field(1, "max_degree", UINT32), Field(2, "max_level", UINT32),
              Field(3, "max_level_hashes", BYTES, repeated=True))


class RangeQueryInfo(Message):
    FIELDS = (Field(1, "start_key", STRING), Field(2, "end_key", STRING),
              Field(3, "itr_exhausted", BOOL),
              Field(4, "raw_reads", MESSAGE, message=QueryReads, oneof="reads_info"),
              Field(5, "reads_merkle_hashes", MESSAGE, message=QueryReadsMerkleSummary,
                    oneof="reads_info"))


class KVRWSet(Message):
    FIELDS = (Field(1, "reads", MESSAGE, repeated=True, message=KVRead),
              Field(2, "range_queries_info", MESSAGE, repeated=True, message=RangeQueryInfo),
              Field(3, "writes", MESSAGE, repeated=True, message=KVWrite),
              Field(4, "metadata_writes", MESSAGE, repeated=True, message=KVMetadataWrite))


class HashedRWSet(Message):
    FIELDS = (Field(1, "hashed_reads", MESSAGE, repeated=True, message=KVReadHash),
              Field(2, "hashed_writes", MESSAGE, repeated=True, message=KVWriteHash),
              Field(3, "metadata_writes", MESSAGE, repeated=True, message=KVMetadataWriteHash))


class CollectionHashedReadWriteSet(Message):
    FIELDS = (Field(1, "collection_name", STRING), Field(2, "hashed_rwset", BYTES),
              Field(3, "pvt_rwset_hash", BYTES))


class NsReadWriteSet(Message):
    FIELDS = (Field(1, "namespace", STRING), Field(2, "rwset", BYTES),
              Field(3, "collection_hashed_rwset", MESSAGE, repeated=True,
                    message=CollectionHashedReadWriteSet))


class TxReadWriteSet(Message):
    FIELDS = (Field(1, "data_model", INT32),
              Field(2, "ns_rwset", MESSAGE, repeated=True, message=NsReadWriteSet))


class CollectionPvtReadWriteSet(Message):
    FIELDS = (Field(1, "collection_name", STRING), Field(2, "rwset", BYTES))


class NsPvtReadWriteSet(Message):
    FIELDS = (Field(1, "namespace", STRING),
              Field(2, "collection_pvt_rwset", MESSAGE, repeated=True,
                    message=CollectionPvtReadWriteSet))


class TxPvtReadWriteSet(Message):
    FIELDS = (Field(1, "data_model", INT32),
              Field(2, "ns_pvt_rwset", MESSAGE, repeated=True, message=NsPvtReadWriteSet))


# -- policies.proto -------------------------------------------------------------

# Policy.PolicyType
POLICY_SIGNATURE, POLICY_MSP, POLICY_IMPLICIT_META = 1, 2, 3
# ImplicitMetaPolicy.Rule
IMPLICIT_ANY, IMPLICIT_ALL, IMPLICIT_MAJORITY = 0, 1, 2
# MSPPrincipal.Classification
PRINCIPAL_ROLE, PRINCIPAL_ORGANIZATION_UNIT, PRINCIPAL_IDENTITY = 0, 1, 2
# MSPRole.MSPRoleType
MSP_ROLE_MEMBER, MSP_ROLE_ADMIN, MSP_ROLE_CLIENT, MSP_ROLE_PEER, MSP_ROLE_ORDERER = range(5)
# MSPConfig.type
MSP_TYPE_FABRIC, MSP_TYPE_IDEMIX = 0, 1
# common.HeaderType.CONFIG_UPDATE
HEADER_CONFIG_UPDATE = 2


class Policy(Message):
    FIELDS = (Field(1, "type", INT32), Field(2, "value", BYTES))


class MSPPrincipal(Message):
    FIELDS = (Field(1, "principal_classification", INT32), Field(2, "principal", BYTES))


class MSPRole(Message):
    FIELDS = (Field(1, "msp_identifier", STRING), Field(2, "role", INT32))


class OrganizationUnit(Message):
    FIELDS = (Field(1, "msp_identifier", STRING),
              Field(2, "organizational_unit_identifier", STRING),
              Field(3, "certifiers_identifier", BYTES))


class SignaturePolicyNOutOf(Message):
    """``SignaturePolicy.NOutOf``."""


class SignaturePolicy(Message):
    FIELDS = (Field(1, "signed_by", INT32, oneof="Type"),
              Field(2, "n_out_of", MESSAGE, message=SignaturePolicyNOutOf, oneof="Type"))


SignaturePolicyNOutOf.set_fields((Field(1, "n", INT32),
                                  Field(2, "rules", MESSAGE, repeated=True,
                                        message=SignaturePolicy)))


class SignaturePolicyEnvelope(Message):
    FIELDS = (Field(1, "version", INT32), Field(2, "rule", MESSAGE, message=SignaturePolicy),
              Field(3, "identities", MESSAGE, repeated=True, message=MSPPrincipal))


class ImplicitMetaPolicy(Message):
    FIELDS = (Field(1, "sub_policy", STRING), Field(2, "rule", INT32))


class ApplicationPolicy(Message):
    FIELDS = (Field(1, "signature_policy", MESSAGE, message=SignaturePolicyEnvelope,
                    oneof="Type"),
              Field(2, "channel_config_policy_reference", STRING, oneof="Type"))


# -- configtx.proto -------------------------------------------------------------


class ConfigValue(Message):
    FIELDS = (Field(1, "version", UINT64), Field(2, "value", BYTES),
              Field(3, "mod_policy", STRING))


class ConfigPolicy(Message):
    FIELDS = (Field(1, "version", UINT64), Field(2, "policy", MESSAGE, message=Policy),
              Field(3, "mod_policy", STRING))


class ConfigGroup(Message):
    """``groups`` holds ConfigGroups: the schema is completed below."""


ConfigGroup.set_fields((Field(1, "version", UINT64),
                        Field(2, "groups", MAP, message=ConfigGroup),
                        Field(3, "values", MAP, message=ConfigValue),
                        Field(4, "policies", MAP, message=ConfigPolicy),
                        Field(5, "mod_policy", STRING)))


class Config(Message):
    FIELDS = (Field(1, "sequence", UINT64),
              Field(2, "channel_group", MESSAGE, message=ConfigGroup))


class ConfigEnvelope(Message):
    FIELDS = (Field(1, "config", MESSAGE, message=Config),
              Field(2, "last_update", MESSAGE, message=Envelope))


class ConfigSignature(Message):
    FIELDS = (Field(1, "signature_header", BYTES), Field(2, "signature", BYTES))


class ConfigUpdateEnvelope(Message):
    FIELDS = (Field(1, "config_update", BYTES),
              Field(2, "signatures", MESSAGE, repeated=True, message=ConfigSignature))


class ConfigUpdate(Message):
    FIELDS = (Field(1, "channel_id", STRING),
              Field(2, "read_set", MESSAGE, message=ConfigGroup),
              Field(3, "write_set", MESSAGE, message=ConfigGroup),
              Field(5, "isolated_data", MAP))


class Capability(Message):
    FIELDS = ()


class Capabilities(Message):
    FIELDS = (Field(1, "capabilities", MAP, message=Capability),)


class MSPConfig(Message):
    FIELDS = (Field(1, "type", INT32), Field(2, "config", BYTES))


class FabricOUIdentifier(Message):
    FIELDS = (Field(1, "certificate", BYTES),
              Field(2, "organizational_unit_identifier", STRING))


class FabricNodeOUs(Message):
    FIELDS = (Field(1, "enable", BOOL),
              Field(2, "client_ou_identifier", MESSAGE, message=FabricOUIdentifier),
              Field(3, "peer_ou_identifier", MESSAGE, message=FabricOUIdentifier),
              Field(4, "admin_ou_identifier", MESSAGE, message=FabricOUIdentifier),
              Field(5, "orderer_ou_identifier", MESSAGE, message=FabricOUIdentifier))


class FabricMSPConfig(Message):
    FIELDS = (Field(1, "name", STRING), Field(2, "root_certs", BYTES, repeated=True),
              Field(3, "intermediate_certs", BYTES, repeated=True),
              Field(4, "admins", BYTES, repeated=True),
              Field(5, "revocation_list", BYTES, repeated=True),
              Field(6, "fabric_node_ous", MESSAGE, message=FabricNodeOUs),
              Field(7, "tls_root_certs", BYTES, repeated=True),
              Field(8, "tls_intermediate_certs", BYTES, repeated=True))


class AnchorPeer(Message):
    FIELDS = (Field(1, "host", STRING), Field(2, "port", INT32))


class AnchorPeers(Message):
    FIELDS = (Field(1, "anchor_peers", MESSAGE, repeated=True, message=AnchorPeer),)


class OrdererAddresses(Message):
    FIELDS = (Field(1, "addresses", STRING, repeated=True),)


class BlockDataHashingStructure(Message):
    FIELDS = (Field(1, "width", UINT32),)


class HashingAlgorithm(Message):
    FIELDS = (Field(1, "name", STRING),)


# -- orderer.proto (the channel config's orderer values) ----------------------------


class ConsensusType(Message):
    FIELDS = (Field(1, "type", STRING), Field(2, "metadata", BYTES), Field(3, "state", INT32))


class BatchSize(Message):
    FIELDS = (Field(1, "max_message_count", UINT32), Field(2, "absolute_max_bytes", UINT32),
              Field(3, "preferred_max_bytes", UINT32))


class BatchTimeout(Message):
    FIELDS = (Field(1, "timeout", STRING),)


class RaftConsenter(Message):
    FIELDS = (Field(1, "host", STRING), Field(2, "port", UINT32),
              Field(3, "client_tls_cert", BYTES), Field(4, "server_tls_cert", BYTES),
              Field(5, "identity", BYTES), Field(6, "id", STRING))


class RaftOptions(Message):
    FIELDS = (Field(1, "tick_interval_ms", UINT32), Field(2, "election_tick", UINT32),
              Field(3, "heartbeat_tick", UINT32), Field(4, "max_inflight_blocks", UINT32),
              Field(5, "snapshot_interval_size", UINT64))


class RaftConfigMetadata(Message):
    FIELDS = (Field(1, "consenters", MESSAGE, repeated=True, message=RaftConsenter),
              Field(2, "options", MESSAGE, message=RaftOptions))
