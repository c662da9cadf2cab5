"""Shared daemon scaffolding: webserver, daemon metrics.

Reference analog: src/yb/server/ — RpcAndWebServerBase (server_base.cc)
and the embedded Webserver with its path handlers (/metrics, /varz,
/tablets, default-path-handlers.cc), and the structured option objects
(server_base_options.h) layered over flags.

The port's copy of the JAX package's ``server/__init__.py``, whole.
"""

from yugabyte_db_tpu_torch.server.options import (MasterOptions,
                                                  ServerOptions,
                                                  TabletServerOptions)
from yugabyte_db_tpu_torch.server.webserver import Webserver

__all__ = ["MasterOptions", "ServerOptions", "TabletServerOptions",
           "Webserver"]
