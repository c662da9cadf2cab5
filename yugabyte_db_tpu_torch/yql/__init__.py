"""YQL API frontends: cql/ (Cassandra QL), redis/ (RESP), pgsql/ (YSQL).

Reference analog: src/yb/yql — the query-language layer above the client
(cql/ql parser+analyzer+executor, redisserver, pggate/postgres).

The port's copy of the JAX package's ``yql/``: ``common``, ``cql`` and
``pgsql``. ``redis`` comes with its slice (ROADMAP.md §1 item 16).
"""
