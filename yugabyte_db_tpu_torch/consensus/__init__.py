"""Per-tablet Raft consensus.

Reference analog: src/yb/consensus/ — RaftConsensus (raft_consensus.cc),
the peer replication queue (consensus_queue.cc, consensus_peers.cc), leader
election (leader_election.cc), leader leases (leader_lease.h), and the
consensus metadata file (consensus_meta.cc). The WAL (tablet.wal.Log) is the
Raft log — "this replicated consistent log also plays the role of the WAL"
(consensus/README).

The port's copy of the JAX package's ``consensus`` package, whole, over
the port's WAL (``tablet.wal.Log``): the same ``consensus-meta.json`` and
the same log entries (terms, no-ops, config changes) byte for byte, so
either package's replica starts on the other's directory.
"""

from yugabyte_db_tpu_torch.consensus.metadata import (ConsensusMetadata,
                                                      RaftConfig)
from yugabyte_db_tpu_torch.consensus.raft import (NotLeader, RaftConsensus,
                                                  RaftOptions, Role)
from yugabyte_db_tpu_torch.consensus.transport import (LocalTransport,
                                                       Transport,
                                                       TransportError)

__all__ = [
    "ConsensusMetadata", "RaftConfig", "RaftConsensus", "RaftOptions",
    "Role", "NotLeader", "LocalTransport", "Transport", "TransportError",
]
