"""Sorted-run persistence: save/load runs as codec files.

Reference analog: SSTable files on disk (block_based_table_builder.cc) +
MANIFEST tracking. Both engines persist the same logical content (key ->
MVCC versions); the TPU engine rebuilds its columnar planes from it at load
time. Columnar plane snapshots (zero-rebuild load) come later; this format
is the durable source of truth either way.

The port's copy of the JAX package's ``storage/run_io.py``, whole: the
files are the JAX engine's, byte for byte, so either package's engine
loads the other's run directory.

File format: codec.encode of
  ["run1", [ [key, [ [ht, tombstone, liveness, {col: val}, expire_ht], ...ht-desc ], ...key-asc ] ]
"""

from __future__ import annotations

import gc
import os

from yugabyte_db_tpu_torch.storage.row_version import RowVersion
from yugabyte_db_tpu_torch.utils import codec

_MAGIC = "run1"


def save_run(path: str, entries: list[tuple[bytes, list[RowVersion]]]) -> None:
    """Write ``entries`` as ``codec.encode(["run1", payload])`` (see the
    module docstring): the JAX module's bytes, through ``codec.encode_run``
    (straight from the versions)."""
    data = codec.encode_run(_MAGIC, entries)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class RunPersistence:
    """Tracks a directory of numbered run files for one engine instance.
    ``None`` data_dir = in-memory engine (tests, caches)."""

    def __init__(self, data_dir: str | None):
        self.data_dir = data_dir
        self._seq = 0
        self.files: list[str] = []
        if data_dir:
            os.makedirs(data_dir, exist_ok=True)
            names = sorted(n for n in os.listdir(data_dir)
                           if n.startswith("run-") and n.endswith(".dat"))
            self.files = [os.path.join(data_dir, n) for n in names]
            if names:
                self._seq = max(int(n[4:-4]) for n in names) + 1

    @property
    def enabled(self) -> bool:
        return self.data_dir is not None

    def load_all(self):
        return [load_run(p) for p in self.files]

    def save_new(self, entries) -> None:
        if not self.enabled:
            return
        path = os.path.join(self.data_dir, f"run-{self._seq:010d}.dat")
        self._seq += 1
        save_run(path, entries)
        self.files.append(path)

    def replace_all(self, entries) -> None:
        """Atomically-ish swap every run file for one merged run (compaction).
        New file is durable before old ones are unlinked, so a crash leaves
        either the old set or a superset — load_all after a crash between
        steps would see duplicated data, which the version-merge semantics
        absorb (identical versions merge idempotently)."""
        if not self.enabled:
            return
        old = list(self.files)
        self.files = []
        if entries:
            self.save_new(entries)
        for p in old:
            try:
                os.unlink(p)
            except FileNotFoundError:
                pass


def load_run(path: str) -> list[tuple[bytes, list[RowVersion]]]:
    """Read a run file: ``codec.decode_run`` of it, read straight into
    (key, versions) entries; a file of another layout (an older record
    without the write id) takes the generic ``codec.decode``."""
    with open(path, "rb") as f:
        buf = f.read()
    # A million version objects in one go make the cyclic GC fire on
    # allocation and rescan the heap; none of them is in a cycle, so it
    # pauses for the read (as the engines' compaction does).
    gc_was = gc.isenabled()
    gc.disable()
    try:
        out = codec.decode_run(buf, _MAGIC, RowVersion.stored)
    finally:
        if gc_was:
            gc.enable()
    if out is not None:
        return out
    magic, payload = codec.decode(buf)
    if magic != _MAGIC:
        raise ValueError(f"{path}: bad run file magic {magic!r}")
    out = []
    for key, versions in payload:
        out.append((key, [
            RowVersion(key, ht=rec[0], tombstone=rec[1], liveness=rec[2],
                       columns={int(c): val for c, val in rec[3].items()},
                       expire_ht=rec[4],
                       write_id=rec[5] if len(rec) > 5 else 0)
            for rec in versions
        ]))
    return out
