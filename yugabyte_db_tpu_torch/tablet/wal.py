"""The write-ahead log: segmented, group-committed, CRC-protected.

Reference analog: src/yb/consensus/log.{h,cc} — "this replicated consistent
log also plays the role of the WAL for the tablet" (consensus/README). The
log stores consensus records (term, index) with opaque payloads; it is the
ONLY durability mechanism (the storage engine never fsyncs its own WAL).

Format per segment file (``wal-<first_index>.seg``):
  repeated records: [u32 len][u32 crc32(payload)][payload]
  payload = codec.encode([term, index, ht, op_type, body])

Group commit: append() buffers; sync() writes+fsyncs once per batch —
callers (the tablet's operation pipeline / Raft) batch many operations per
sync, the reference's Log::AsyncAppend + TaskStream pattern.

The port's copy of the JAX package's ``tablet/wal.py``, whole: the
segments are the JAX WAL's byte for byte (``utils.codec``), so either
package replays the other's log. ``sync`` records its latency in
``yb_wal_sync_ms`` (``utils.metrics``) and runs under the stall watchdog
(``wal.sync``); the fsyncs report to the resource witness
(``utils.resources.note_blocking``).
"""

from __future__ import annotations

import os
import struct
import threading
import time
import zlib
from dataclasses import dataclass

from yugabyte_db_tpu_torch.utils import codec
from yugabyte_db_tpu_torch.utils.locking import guarded_by

_HEADER = struct.Struct("<II")


@dataclass(frozen=True, order=True)
class OpId:
    """Consensus operation id (term, index) — reference consensus.proto OpId."""

    term: int
    index: int

    @staticmethod
    def min() -> "OpId":
        return OpId(0, 0)


@dataclass
class LogEntry:
    op_id: OpId
    ht: int           # hybrid time of the operation
    op_type: str      # "write" | "no_op" | "change_config" | ...
    body: object      # codec-encodable payload
    committed: int = 0  # commit index known when this entry was appended
    # ``committed`` mirrors the reference piggybacking the committed op id on
    # every replicate message (consensus.proto UpdateConsensus); bootstrap
    # replays only entries known committed and hands the tail back to
    # consensus as pending (tablet_bootstrap.cc).

    def to_record(self) -> list:
        """The single canonical record layout (WAL payload == wire format)."""
        return [self.op_id.term, self.op_id.index, self.ht,
                self.op_type, self.body, self.committed]

    @staticmethod
    def from_record(rec: list) -> "LogEntry":
        return LogEntry(OpId(rec[0], rec[1]), rec[2], rec[3], rec[4],
                        rec[5] if len(rec) > 5 else 0)


@guarded_by("_lock", "_file", "_file_path", "_file_size", "_buffer",
            "_buffer_bytes", "last_appended")
class Log:
    """A tablet's durable log of replicated operations."""

    def __init__(self, wal_dir: str, segment_bytes: int = 8 * 1024 * 1024,
                 fsync: bool = True):
        self.wal_dir = wal_dir
        self.segment_bytes = segment_bytes
        self.fsync = fsync
        # Appends are serialized by the caller (one writer: the consensus
        # pipeline); this lock only guards append/sync/gc/truncate racing
        # each other (e.g. flush-triggered GC vs an append).
        self._lock = threading.RLock()
        os.makedirs(wal_dir, exist_ok=True)
        self._file = None
        self._file_path = None
        self._file_size = 0
        self._buffer: list[bytes] = []
        self._buffer_bytes = 0
        self.last_appended = OpId.min()
        # Recover last_appended from the tail segments only (newest first);
        # the full log is decoded once, by bootstrap replay, not here.
        for path in reversed(self.segment_paths()):
            entries, _ = self._read_segment(path, 0)
            if entries:
                self.last_appended = entries[-1].op_id
                break

    # -- segments ----------------------------------------------------------
    def segment_paths(self) -> list[str]:
        names = sorted(n for n in os.listdir(self.wal_dir)
                       if n.startswith("wal-") and n.endswith(".seg"))
        return [os.path.join(self.wal_dir, n) for n in names]

    def _open_segment_locked(self, first_index: int) -> None:
        self._close_file_locked()
        name = f"wal-{first_index:020d}.seg"
        self._file_path = os.path.join(self.wal_dir, name)
        self._file = open(self._file_path, "ab")
        self._file_size = self._file.tell()

    def _close_file_locked(self) -> None:
        # A closed segment must be durable before sync() reports the group
        # durable: roll-over flushes buffered records into the OLD segment,
        # and the subsequent sync() only fsyncs the NEW file — without this
        # fsync, entries in the closed segment would count toward Raft
        # majority while still sitting in the page cache.
        if self._file is not None:
            self._file.flush()
            if self.fsync:
                # Roll-over happens mid-append, so the old segment must be
                # durable before the lock drops — a sync() racing past
                # would only fsync the NEW file.
                from yugabyte_db_tpu_torch.utils.resources import note_blocking
                note_blocking("fsync")
                os.fsync(self._file.fileno())
            self._file.close()
            self._file = None

    # -- append ------------------------------------------------------------
    def append(self, entry: LogEntry) -> None:
        """Buffer an entry; durable after the next sync()."""
        with self._lock:
            self._append_locked(entry)

    def _append_locked(self, entry: LogEntry) -> None:
        if entry.op_id <= self.last_appended:
            raise ValueError(
                f"non-monotonic append {entry.op_id} after {self.last_appended}")
        payload = codec.encode(entry.to_record())
        rec = _HEADER.pack(len(payload), zlib.crc32(payload)) + payload
        if self._file is None or \
                self._file_size + self._buffer_bytes >= self.segment_bytes:
            # Roll BEFORE buffering this record so the new segment's name
            # (its first index) truthfully covers it — GC relies on that.
            self._flush_buffer_locked()
            self._open_segment_locked(entry.op_id.index)
        self._buffer.append(rec)
        self._buffer_bytes += len(rec)
        self.last_appended = entry.op_id

    def _flush_buffer_locked(self) -> None:
        if not self._buffer or self._file is None:
            return
        data = b"".join(self._buffer)
        self._buffer.clear()
        self._buffer_bytes = 0
        self._file.write(data)
        self._file_size += len(data)

    def sync(self) -> None:
        """Group commit: flush buffered records and fsync the segment."""
        from yugabyte_db_tpu_torch.utils.fault_injection import (
            FaultInjected, maybe_fault)

        if maybe_fault("fault.wal_sync_failed"):
            raise FaultInjected("injected WAL sync failure")
        from yugabyte_db_tpu_torch.utils.metrics import observe_wal_sync_ms
        from yugabyte_db_tpu_torch.utils.watchdog import watchdog

        # Standing stall check (reference: kernel_stack_watchdog.h):
        # a wedged fsync surfaces as a flagged stall, not silence.
        with watchdog().watch("wal.sync", threshold_s=2.0):
            start = time.monotonic()
            f = None
            with self._lock:
                if self._file is None and self._buffer:
                    self._open_segment_locked(max(1, self.last_appended.index))
                self._flush_buffer_locked()
                f = self._file
                if f is not None:
                    # flush() stays under the lock: BufferedWriter is not
                    # thread-safe against a concurrent _flush_buffer_locked.
                    f.flush()
            if f is not None and self.fsync:
                try:
                    from yugabyte_db_tpu_torch.utils.resources import (
                        note_blocking)
                    note_blocking("fsync")
                    # fsync OUTSIDE the lock — the group-commit shape:
                    # appenders keep buffering into the next group while
                    # this one reaches disk.
                    os.fsync(f.fileno())
                except (ValueError, OSError):
                    # A concurrent roll-over closed this segment after we
                    # snapshotted it; _close_file_locked flushed AND fsynced
                    # it before closing, so the group is durable anyway.
                    pass
            observe_wal_sync_ms((time.monotonic() - start) * 1e3)

    # -- read / replay -----------------------------------------------------
    def read_all(self, min_index: int = 0):
        """Yield entries with index >= min_index, tolerating a torn tail
        (a partial last record after a crash is dropped, matching WAL
        recovery semantics)."""
        for path in self.segment_paths():
            entries, clean = self._read_segment(path, min_index)
            yield from entries
            if not clean:
                return  # stop replay at first torn/corrupt record globally

    @staticmethod
    def _read_segment(path: str, min_index: int) -> tuple[list, bool]:
        """-> (entries, clean). clean=False on torn tail or CRC mismatch."""
        with open(path, "rb") as f:
            data = f.read()
        pos = 0
        out: list[LogEntry] = []
        while pos + _HEADER.size <= len(data):
            length, crc = _HEADER.unpack_from(data, pos)
            start = pos + _HEADER.size
            end = start + length
            if end > len(data):
                return out, False  # torn tail
            payload = data[start:end]
            if zlib.crc32(payload) != crc:
                return out, False  # corruption: stop at last good record
            entry = LogEntry.from_record(codec.decode(payload))
            if entry.op_id.index >= min_index:
                out.append(entry)
            pos = end
        return out, True

    # -- truncation --------------------------------------------------------
    def truncate_after(self, last_kept_index: int) -> int:
        """Drop every entry with index > last_kept_index (a follower erasing
        a conflicting suffix on divergence from a new leader). Returns the
        number of entries dropped. Rewrites only the segments that contain
        dropped entries; earlier segments are untouched."""
        with self._lock:
            return self._truncate_after_locked(last_kept_index)

    def _truncate_after_locked(self, last_kept_index: int) -> int:
        self.sync()
        self._close_file_locked()
        dropped = 0
        # Newest-first so a crash mid-truncation always leaves a CONTIGUOUS
        # prefix (a tail segment is fully gone before an earlier one is
        # rewritten) — recovery then sees a valid, if longer, log.
        for path in reversed(self.segment_paths()):
            entries, _ = self._read_segment(path, 0)
            if not entries or entries[-1].op_id.index <= last_kept_index:
                continue
            kept = [e for e in entries if e.op_id.index <= last_kept_index]
            dropped += len(entries) - len(kept)
            if kept:
                tmp = path + ".tmp"
                with open(tmp, "wb") as f:
                    for e in kept:
                        payload = codec.encode(e.to_record())
                        f.write(_HEADER.pack(len(payload),
                                             zlib.crc32(payload)) + payload)
                    f.flush()
                    # Divergence repair rewrites segments in place; an
                    # append interleaving with the rewrite would corrupt
                    # the log, so the whole repair stays locked (the rare
                    # follower-conflict path, never the write path).
                    os.fsync(f.fileno())
                os.replace(tmp, path)
            else:
                os.unlink(path)
        self.last_appended = OpId.min()
        for path in reversed(self.segment_paths()):
            entries, _ = self._read_segment(path, 0)
            if entries:
                self.last_appended = entries[-1].op_id
                break
        return dropped

    # -- GC ----------------------------------------------------------------
    def gc(self, min_retained_index: int) -> int:
        """Delete whole segments whose every entry index < min_retained_index.
        Returns segments deleted. (Reference: Log::GC after flushed frontier
        advances.)"""
        with self._lock:
            return self._gc_locked(min_retained_index)

    def _gc_locked(self, min_retained_index: int) -> int:
        paths = self.segment_paths()
        deleted = 0
        # A segment's name carries its first index; a segment can be deleted
        # when the NEXT segment's first index is still <= min_retained.
        for i, path in enumerate(paths[:-1]):  # never delete the active tail
            nxt_first = int(os.path.basename(paths[i + 1])[4:-4])
            if nxt_first <= min_retained_index:
                os.unlink(path)
                deleted += 1
            else:
                break
        return deleted

    def close(self) -> None:
        self.sync()
        with self._lock:
            self._close_file_locked()
