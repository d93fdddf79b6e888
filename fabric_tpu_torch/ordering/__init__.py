"""The ordering service (counterpart: ``fabric_tpu/ordering/``): the
block cutter, Raft, BFT, the per-channel chain and the orderer node."""

from fabric_tpu_torch.ordering.bft import BFTNode  # noqa: F401
from fabric_tpu_torch.ordering.blockcutter import BatchConfig, BlockCutter  # noqa: F401
from fabric_tpu_torch.ordering.chain import MsgProcessor, OrderingChain  # noqa: F401
from fabric_tpu_torch.ordering.node import (  # noqa: F401
    BroadcastClient,
    DeliverClient,
    OrdererNode,
)
from fabric_tpu_torch.ordering.raft import WAL, RaftNode  # noqa: F401
