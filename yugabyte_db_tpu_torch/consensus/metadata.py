"""Durable consensus metadata: current term, vote, and the Raft config.

Reference analog: src/yb/consensus/consensus_meta.{h,cc} — the cmeta file a
peer must persist *before* responding to a vote request, and
src/yb/consensus/metadata.proto (RaftConfigPB / RaftPeerPB).

The port's copy of the JAX package's ``consensus/metadata.py``: the file
is the JAX file byte for byte.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field


@dataclass
class RaftConfig:
    """The replica set: voter uuids, versioned by the log index that
    committed it (reference: RaftConfigPB.opid_index)."""

    peers: list[str] = field(default_factory=list)
    opid_index: int = 0

    def majority_size(self) -> int:
        return len(self.peers) // 2 + 1

    def has_peer(self, uuid: str) -> bool:
        return uuid in self.peers

    def to_dict(self) -> dict:
        return {"peers": list(self.peers), "opid_index": self.opid_index}

    @staticmethod
    def from_dict(d: dict) -> "RaftConfig":
        return RaftConfig(list(d["peers"]), d.get("opid_index", 0))


class ConsensusMetadata:
    """Durable (term, voted_for, config); fsynced before any vote/term bump
    takes effect, the Raft persistence requirement."""

    def __init__(self, path: str, peer_uuid: str,
                 config: RaftConfig | None = None):
        self.path = path
        self.peer_uuid = peer_uuid
        self.current_term = 0
        self.voted_for: str | None = None
        self.committed_config = config or RaftConfig()
        # A pending (replicated-but-uncommitted) config, active immediately
        # per Raft config-change rules.
        self.pending_config: RaftConfig | None = None
        if os.path.exists(path):
            self._load()
        else:
            self.flush()

    @property
    def active_config(self) -> RaftConfig:
        return self.pending_config or self.committed_config

    def set_term(self, term: int, voted_for: str | None = None) -> None:
        assert term >= self.current_term, (term, self.current_term)
        if term > self.current_term:
            self.current_term = term
            self.voted_for = voted_for
        elif voted_for is not None:
            self.voted_for = voted_for
        self.flush()

    def flush(self) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({
                "peer_uuid": self.peer_uuid,
                "current_term": self.current_term,
                "voted_for": self.voted_for,
                "committed_config": self.committed_config.to_dict(),
                "pending_config":
                    self.pending_config.to_dict() if self.pending_config else None,
            }, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    def _load(self) -> None:
        with open(self.path) as f:
            d = json.load(f)
        self.peer_uuid = d["peer_uuid"]
        self.current_term = d["current_term"]
        self.voted_for = d["voted_for"]
        self.committed_config = RaftConfig.from_dict(d["committed_config"])
        pc = d.get("pending_config")
        self.pending_config = RaftConfig.from_dict(pc) if pc else None
