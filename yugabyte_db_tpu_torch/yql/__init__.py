"""YQL API frontends: cql/ (Cassandra QL), redis/ (RESP), pgsql/ (YSQL).

Reference analog: src/yb/yql — the query-language layer above the client
(cql/ql parser+analyzer+executor, redisserver, pggate/postgres).

The port's copy of the JAX package's ``yql/``: ``common`` and ``cql``.
``pgsql`` and ``redis`` come with their slices (ROADMAP.md §1 item 16).
"""
