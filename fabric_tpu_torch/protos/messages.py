"""The message schemas the port reads and writes (counterparts:
``fabric_tpu/protos/common.proto``, ``proposal.proto``,
``transaction.proto``, ``rwset.proto`` and ``timestamp.proto``; same
field numbers, kinds and names; an enum field is its int32).
``Block`` takes the place of ``common_pb2.Block`` on the port's
entry."""

from __future__ import annotations

from fabric_tpu_torch.protos.wire import (
    BOOL, BYTES, INT32, INT64, MAP, MESSAGE, STRING, UINT32, UINT64, Field, Message,
)

# common.HeaderType values the front end tells apart
HEADER_CONFIG, HEADER_ENDORSER_TRANSACTION = 1, 3
# common.BlockMetadataIndex: five slots, TRANSACTIONS_FILTER the third
META_TRANSACTIONS_FILTER, N_METADATA = 2, 5
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
