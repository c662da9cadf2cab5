"""FsManager: data-directory identity.

Reference analog: src/yb/fs/fs_manager.cc + fs.proto's
InstanceMetadataPB — every data directory carries an instance-metadata
record naming the server that owns it, written once at format time and
verified on every open. A data dir restored from the wrong machine, or
two daemons pointed at one directory, is detected instead of silently
serving another server's tablets.

The port's copy of the JAX package's ``fs.py``, whole.
"""

from __future__ import annotations

import os
import uuid as uuid_mod

from yugabyte_db_tpu_torch.utils import codec
from yugabyte_db_tpu_torch.utils.status import IllegalState

INSTANCE_FILE = "instance"
_MAGIC = "ybtpu-instance-v1"


class FsMismatch(IllegalState):
    """The data directory belongs to a different server instance."""


def format_or_open(data_dir: str, server_uuid: str) -> dict:
    """First open formats the directory (writes instance metadata);
    later opens verify the owning server uuid. Returns the metadata
    dict {server_uuid, instance_uuid, format_time_us}."""
    os.makedirs(data_dir, exist_ok=True)
    path = os.path.join(data_dir, INSTANCE_FILE)
    if os.path.exists(path):
        with open(path, "rb") as f:
            rec = codec.decode(f.read())
        if not isinstance(rec, list) or len(rec) < 4 or rec[0] != _MAGIC:
            raise IllegalState(f"{path}: not an instance metadata file")
        meta = {"server_uuid": rec[1], "instance_uuid": rec[2],
                "format_time_us": rec[3]}
        if meta["server_uuid"] != server_uuid:
            raise FsMismatch(
                f"data dir {data_dir} belongs to server "
                f"{meta['server_uuid']!r}, not {server_uuid!r} "
                "(swapped or restored data directory?)")
        return meta
    import time

    meta = {"server_uuid": server_uuid,
            "instance_uuid": uuid_mod.uuid4().hex,
            "format_time_us": int(time.time() * 1e6)}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(codec.encode([_MAGIC, meta["server_uuid"],
                              meta["instance_uuid"],
                              meta["format_time_us"]]))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return meta
