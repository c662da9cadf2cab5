"""Shared daemon scaffolding: webserver, daemon metrics.

Reference analog: src/yb/server/ — RpcAndWebServerBase (server_base.cc)
and the embedded Webserver with its path handlers (/metrics, /varz,
/tablets, default-path-handlers.cc).

The port's copy of the JAX package's ``server/__init__.py`` less
``options.py`` (the typed option objects that no daemon of the port
constructs yet; ROADMAP.md §1 item 12.4).
"""

from yugabyte_db_tpu_torch.server.webserver import Webserver

__all__ = ["Webserver"]
