"""Vendored thin wire-protocol clients (stock-driver analogs).

The reference proves its YQL frontends against real drivers — the Java
CQL driver (java/yb-cql), Jedis (java/yb-jedis-tests), and libpq
(src/yb/yql/pgwrapper/pg_libpq-test.cc). Stock drivers cannot be
installed in this environment, so these are the thinnest faithful
client-side implementations of each protocol, written INDEPENDENTLY of
the server wire modules (own framing, own value codecs) so interop
tests exercise the server's bytes the way a foreign driver would —
including the control-connection schema-discovery handshake a DataStax
driver performs against system.local / system.peers / system_schema.*.

They are usable components, not test fixtures: the CLI tools can speak
to a remote cluster through them.

The port's copy of the JAX package's ``drivers/``: the CQL driver
(``minicql``) and the PostgreSQL driver (``minipg``). ``miniredis``
comes with the YEDIS frontend (ROADMAP.md §1 item 16).
"""

from yugabyte_db_tpu_torch.drivers.minicql import CqlConnection, CqlError
from yugabyte_db_tpu_torch.drivers.minipg import PgConnection, PgError

__all__ = ["CqlConnection", "CqlError", "PgConnection", "PgError"]
