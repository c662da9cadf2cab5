"""Integration harnesses: in-process clusters for tests and tools.

Reference analog: src/yb/integration-tests/ — MiniCluster
(mini_cluster.h:92-106) runs real masters + tservers in one process;
ExternalMiniCluster adds kill/restart. Here LocalTransport isolation plays
the kill role, and the socket transport runs the same daemons over real
loopback TCP.

The port's copy of the JAX package's ``integration/__init__.py`` as far
as ``MiniCluster``; the fault and traffic sweeps are ROADMAP.md §1 item
16.
"""

from yugabyte_db_tpu_torch.integration.mini_cluster import MiniCluster

__all__ = ["MiniCluster"]
