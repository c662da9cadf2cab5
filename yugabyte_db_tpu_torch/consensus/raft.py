"""RaftConsensus: per-tablet leader election + log replication.

Reference analog: src/yb/consensus/raft_consensus.cc (the role state
machine + vote handling), consensus_queue.cc (PeerMessageQueue — tracking
per-peer next/match indexes and advancing the majority-replicated
watermark), consensus_peers.cc (per-peer replication), leader_election.cc,
and leader_lease.h (leader leases so reads never need a quorum round-trip).

Structure: one lock per instance; three kinds of background threads —
a timer (election timeouts + heartbeat pacing), one replication thread per
remote peer (the reference's Peer + its thread-pool tokens), and an apply
thread that invokes ``apply_cb(entry)`` strictly in log order once entries
commit (the reference's OperationDriver::ApplyTask stage). The WAL is the
Raft log: every entry is fsynced before it counts toward majority.

Simplifications vs the reference, called out honestly:
- Leader leases are MESSAGE-BORNE (leader_lease.h): every AppendEntries
  carries a lease duration; the follower promises (vote withholding until
  a monotonic deadline) and echoes the grant in its ack; the leader holds
  the lease while a majority's grants — measured from each request's SEND
  time — are still running. All lease arithmetic is monotonic-clock
  durations, so wall-clock jumps cannot extend or break a lease.
- The in-memory entry cache (LogCache analog) is bounded by the engine's
  flushed frontier: every flush evicts entries below it (evict_cache,
  keeping two anchor entries for peer consistency probes), and a peer
  lagging past the eviction floor is re-seeded via remote bootstrap
  instead of log catchup — the same handoff consensus_queue.cc makes.
  Unlike the reference's LogCache there is no disk read-back path for
  peer catchup (log_cache.cc falls back to LogReader); the cache floor
  therefore never exceeds the flushed frontier.

The port's copy of the JAX package's ``consensus/raft.py``, whole. It
calls no device code: the ``gpu`` engine is reached through ``apply_cb``
(the tablet peer's apply), on the apply and replication threads; every
kernel launch names its device, so those threads launch on the engine's
card.
"""

from __future__ import annotations

import enum
import logging
import random
import threading
import time
from dataclasses import dataclass

from yugabyte_db_tpu_torch.consensus.metadata import (ConsensusMetadata,
                                                      RaftConfig)
from yugabyte_db_tpu_torch.consensus.transport import Transport, TransportError
from yugabyte_db_tpu_torch.tablet.wal import Log, LogEntry, OpId
from yugabyte_db_tpu_torch.utils.flags import FLAGS
from yugabyte_db_tpu_torch.utils.hybrid_time import HybridTime
from yugabyte_db_tpu_torch.utils.locking import guarded_by
from yugabyte_db_tpu_torch.utils.metrics import (count_fault_fired,
                                                 count_swallowed,
                                                 observe_group_commit_batch)
from yugabyte_db_tpu_torch.utils.retry import Deadline


def _as_deadline(timeout) -> Deadline:
    """Normalize a float-seconds timeout or a Deadline to a Deadline —
    the PR-7 propagation convention: callers that already carry a
    deadline pass it through so every wait debits ONE budget instead of
    restarting a fresh 10 s at each layer."""
    if isinstance(timeout, Deadline):
        return timeout
    return Deadline.after(float(timeout))


class Role(enum.Enum):
    FOLLOWER = "FOLLOWER"
    CANDIDATE = "CANDIDATE"
    LEADER = "LEADER"


class NotLeader(Exception):
    """Raised on writes/reads addressed to a non-leader replica; carries the
    best-known leader hint (reference: TabletServerErrorPB::NOT_THE_LEADER)."""

    def __init__(self, uuid: str, leader_hint: str | None):
        super().__init__(f"{uuid} is not the leader (leader={leader_hint})")
        self.leader_hint = leader_hint


@dataclass
class RaftOptions:
    election_timeout_s: float = 0.5     # base; actual is jittered 1-2x
    heartbeat_interval_s: float = 0.1
    lease_s: float = 0.5                # leader lease window
    max_batch_entries: int = 64         # per UpdateConsensus request
    rpc_timeout_s: float = 2.0

    @property
    def effective_lease_s(self) -> float:
        """The lease window a leader may trust. Clamped to the MINIMUM
        election delay: followers withhold votes only for
        election_timeout_s after the last heartbeat, so a lease longer
        than that could outlive a successor's election and serve stale
        reads. The 0.8 factor keeps a margin from the exact boundary."""
        return min(self.lease_s, 0.8 * self.election_timeout_s)


class _PeerState:
    """Leader-side view of one remote peer (consensus_queue.cc tracking)."""

    def __init__(self, uuid: str, next_index: int):
        self.uuid = uuid
        self.next_index = next_index
        self.match_index = 0
        self.last_ack_monotonic = 0.0
        # monotonic deadline of the lease this peer GRANTED (ack of a
        # message carrying lease_s): the peer promised not to vote for
        # anyone else before it (leader_lease.h message-borne leases)
        self.lease_until = 0.0
        self.needs_remote_bootstrap = False
        self.signal = threading.Event()
        self.thread: threading.Thread | None = None


@guarded_by("_lock", "_gc_handled_index", "_gc_last_dispatch")
class RaftConsensus:
    def __init__(self, tablet_id: str, cmeta: ConsensusMetadata, log: Log,
                 transport: Transport, clock, apply_cb,
                 opts: RaftOptions | None = None,
                 initial_applied_index: int = 0,
                 preloaded_entries: list[LogEntry] | None = None):
        self.tablet_id = tablet_id
        self.cmeta = cmeta
        self.uuid = cmeta.peer_uuid
        self.log = log
        self.transport = transport
        self.clock = clock
        self.apply_cb = apply_cb
        self.opts = opts or RaftOptions()

        self._lock = threading.RLock()
        self._apply_cond = threading.Condition(self._lock)
        self._stall_watch = None  # open watchdog scope on an apply hole
        self._commit_cond = threading.Condition(self._lock)
        self._role = Role.FOLLOWER
        self._leader_uuid: str | None = None
        self._rng = random.Random(hash((self.uuid, tablet_id)) & 0xFFFF)
        self._election_timeout = self._next_timeout()
        self._last_heartbeat_recv = time.monotonic()
        # monotonic deadline of the vote-withholding promise made to the
        # current leader (message-borne lease grants)
        self._vote_withhold_until = 0.0
        self._last_broadcast = 0.0
        self._leader_since = 0.0  # when this node last won an election
        self._own_term_noop = (0, 0)  # (term, index) of our election no_op
        self._running = False

        # Log state: full in-memory entry cache (LogCache analog).
        self._entries: dict[int, LogEntry] = {}
        self._sync_lock = threading.Lock()  # serializes fsyncs (group commit)
        self._last_index = 0
        self._commit_index = 0
        self._applied_index = initial_applied_index
        entries = (preloaded_entries if preloaded_entries is not None
                   else self.log.read_all(0))
        for e in entries:
            self._entries[e.op_id.index] = e
            self._last_index = max(self._last_index, e.op_id.index)
            self._commit_index = max(self._commit_index, e.committed)
            if e.op_type == "change_config":
                cfg = RaftConfig.from_dict(e.body)
                cfg.opid_index = e.op_id.index
                if e.op_id.index <= self._commit_index:
                    if cfg.opid_index > self.cmeta.committed_config.opid_index:
                        self.cmeta.committed_config = cfg
                        self.cmeta.pending_config = None
                else:
                    self.cmeta.pending_config = cfg
        self._commit_index = min(self._commit_index, self._last_index)
        self._applied_index = min(self._applied_index, self._last_index)
        self._durable_index = self._last_index  # on-disk log is durable

        self._peers: dict[str, _PeerState] = {}
        self._applying = False  # single-applier guard (inline + thread)
        # Cross-request group commit (the reference's Log::AsyncAppend
        # batching across independent requests): leader appends park in
        # the log buffer and set _gc_event; the pipeline thread wakes,
        # waits out --raft_group_commit_window_us, then issues ONE peer
        # signal (one AppendEntries round per peer) and ONE WAL sync for
        # everything admitted in the window. _gc_handled_index is the
        # high-water mark of entries already handed to a window.
        self._gc_event = threading.Event()
        self._gc_handled_index = self._last_index
        self._gc_last_dispatch = 0.0  # monotonic time of the last round
        self._threads: list[threading.Thread] = []
        # Invoked (tablet_id, peer_uuid) when a peer needs entries evicted
        # from the cache — wired by the tserver to kick remote bootstrap.
        self.on_needs_bootstrap = None
        # Invoked (entries) when a log suffix is truncated (definite
        # aborts) — wired by the TabletPeer to resolve MVCC pendings.
        self.on_entries_truncated = None

    # ------------------------------------------------------------------ api
    def start(self) -> None:
        with self._lock:
            self._running = True
        t = threading.Thread(target=self._run_timer,
                             name=f"raft-timer-{self.uuid}", daemon=True)
        a = threading.Thread(target=self._run_apply,
                             name=f"raft-apply-{self.uuid}", daemon=True)
        g = threading.Thread(target=self._run_group_commit,
                             name=f"raft-gc-{self.uuid}", daemon=True)
        self._threads += [t, a, g]
        t.start()
        a.start()
        g.start()

    def shutdown(self) -> None:
        with self._lock:
            self._running = False
            self._role = Role.FOLLOWER
            peers = list(self._peers.values())
            self._peers.clear()
            self._apply_cond.notify_all()
            self._commit_cond.notify_all()
        self._gc_event.set()
        for p in peers:
            p.signal.set()
        for t in self._threads:
            t.join(timeout=5.0)
        self.log.sync()

    # -- role/introspection -------------------------------------------------
    @property
    def role(self) -> Role:
        return self._role

    def is_leader(self) -> bool:
        return self._role == Role.LEADER

    def leader_ready(self) -> bool:
        """True once this leader has APPLIED an entry of its own term (the
        election no_op). Before that, the local commit/applied watermarks
        may lag the true cluster commit — destructive control-plane
        decisions (orphan-replica GC) must wait for this gate (reference:
        CatalogManager's leader-ready / sys-catalog-loaded check)."""
        with self._lock:
            if self._role != Role.LEADER:
                return False
            term, idx = self._own_term_noop
            return (term == self.cmeta.current_term and idx > 0 and
                    self._applied_index >= idx)

    def has_lease(self) -> bool:
        """Majority-ack leader lease: safe to serve reads locally."""
        with self._lock:
            if self._role != Role.LEADER:
                return False
            now = time.monotonic()
            cfg = self.cmeta.active_config
            # A fresh leader first waits out any predecessor's lease window
            # (the reference's "old leader lease expiry" wait) — except the
            # trivial single-member group, which has no predecessor reads.
            if len(cfg.peers) > 1 and \
                    now < self._leader_since + self.opts.effective_lease_s:
                return False
            acked = 0
            for uuid in cfg.peers:
                if uuid == self.uuid:
                    acked += 1  # self counts only while still a member
                    continue
                p = self._peers.get(uuid)
                if p is not None and p.lease_until > now:
                    acked += 1  # explicit grant still running
            return acked >= cfg.majority_size()

    def leader_uuid(self) -> str | None:
        return self._leader_uuid

    def stats(self) -> dict:
        with self._lock:
            return {
                "uuid": self.uuid,
                "role": self._role.value,
                "term": self.cmeta.current_term,
                "leader": self._leader_uuid,
                "last_index": self._last_index,
                "commit_index": self._commit_index,
                "applied_index": self._applied_index,
                "config": self.cmeta.active_config.to_dict(),
            }

    # -- write path ----------------------------------------------------------
    def replicate(self, op_type: str, body, ht: int | None = None,
                  timeout: float | Deadline = 10.0) -> LogEntry:
        """Leader-only: append, replicate to a majority, apply; returns the
        committed entry (with its assigned op id + hybrid time)."""
        deadline = _as_deadline(timeout)
        entry = self.append_leader(op_type, body, ht, deadline=deadline)
        self.wait_applied(entry.op_id, deadline)
        return entry

    def append_leader(self, op_type: str, body, ht: int | None = None,
                      decoded_rows=None, on_append=None,
                      deadline: Deadline | None = None) -> LogEntry:
        """Leader append + durability, without waiting for commit. Callers
        that need the outcome follow with wait_committed()/wait_applied().
        ``decoded_rows`` rides on the in-memory entry so the leader's own
        apply skips re-decoding the body (followers decode from wire).

        Multi-peer groups DEFER the leader's own fsync off the admission
        path: the entry only counts toward the majority once synced, but
        two follower disks already form a majority (standard Raft — a
        leader may lose its unsynced tail), and the group-commit pipeline
        plus each replication thread sync the log off the admission path
        (amortized group commit), so a majority that needs the leader's
        disk (one follower down) is never more than one replication round
        away. Single-peer groups sync inline — there is nobody else to
        carry durability."""
        with self._lock:
            self._wait_inflight_room_locked(deadline)
            entry = self._leader_append_locked(op_type, body, ht,
                                               decoded_rows)
            if on_append is not None:
                # Runs under the raft lock: applies/truncations of this
                # entry are ordered strictly after it, so per-entry
                # bookkeeping (the peer's MVCC-resolution registry) can
                # never miss its own entry.
                on_append(entry)
            defer = len(self.cmeta.active_config.peers) > 1
        if not defer:
            self._ensure_durable(entry.op_id.index)
        return entry

    def _wait_inflight_room_locked(self, deadline: Deadline | None) -> None:
        """Backpressure: block admission while the append->apply window
        is full (--raft_max_inflight_ops). Bounds the commit-ack apply
        queue — a stalled apply stage pushes back on writers instead of
        buffering unboundedly."""
        try:
            limit = int(FLAGS.get("raft_max_inflight_ops"))
        except KeyError:
            limit = 0
        if limit <= 0 or self._last_index - self._applied_index < limit:
            return
        dl = deadline if deadline is not None else Deadline.after(5.0)
        while self._last_index - self._applied_index >= limit:
            if self._role != Role.LEADER:
                raise NotLeader(self.uuid, self._leader_uuid)
            if not self._running or dl.expired():
                raise TimeoutError(
                    f"write backpressure: {self._last_index - self._applied_index} "
                    f"ops in flight (limit {limit})")
            self._commit_cond.wait(timeout=dl.timeout(0.05))

    def _leader_append_locked(self, op_type: str, body, ht: int | None,
                              decoded_rows=None) -> LogEntry:
        if self._role != Role.LEADER:
            raise NotLeader(self.uuid, self._leader_uuid)
        if ht is None:
            ht = self.clock.now().value
        entry = LogEntry(OpId(self.cmeta.current_term, self._last_index + 1),
                         ht, op_type, body, self._commit_index)
        if decoded_rows is not None:
            entry.decoded_rows = decoded_rows
        # No fsync under the lock: durability is established by
        # _ensure_durable OUTSIDE it, and the entry only counts toward the
        # majority (self's match = _durable_index) once synced. Concurrent
        # appends share one fsync — the WAL's group-commit design.
        self._append_local_locked(entry, sync=False)
        window_s = self._gc_window_s()
        if window_s > 0:
            now = time.monotonic()
            if now - self._gc_last_dispatch >= window_s:
                # Pipeline idle: dispatch this append's round inline —
                # the same latency as the no-window path (no thread
                # handoff for a lone writer).
                batch = self._last_index - self._gc_handled_index
                self._gc_handled_index = self._last_index
                self._gc_last_dispatch = now
                self._signal_peers_locked()
                observe_group_commit_batch(batch)
            else:
                # A round just went out: park the append; the pipeline
                # thread coalesces everything admitted within the window
                # into one WAL sync + one AppendEntries round per peer.
                self._gc_event.set()
        else:
            self._signal_peers_locked()
        return entry

    @staticmethod
    def _gc_window_s() -> float:
        try:
            return FLAGS.get("raft_group_commit_window_us") / 1e6
        except KeyError:
            return 0.0

    # -- group-commit pipeline ----------------------------------------------
    def _run_group_commit(self) -> None:
        try:
            self._group_commit_loop()
        except Exception:  # a dead pipeline must never be silent
            logging.getLogger(__name__).exception(
                "raft %s: group-commit thread died", self.uuid)

    def _group_commit_loop(self) -> None:
        while True:
            self._gc_event.wait(timeout=0.5)
            with self._lock:
                if not self._running:
                    return
            if not self._gc_event.is_set():
                continue
            # Conveyor pacing: appends only land here while a round is
            # already hot (idle appends dispatch inline in
            # _leader_append_locked), so hold back until the window since
            # the last dispatch elapses — everything admitted meanwhile
            # shares this round.
            window_s = self._gc_window_s()
            with self._lock:
                since = time.monotonic() - self._gc_last_dispatch
            if 0 < since < window_s:
                time.sleep(window_s - since)
            self._gc_event.clear()
            with self._lock:
                if self._role != Role.LEADER:
                    continue
                last = self._last_index
                batch = last - self._gc_handled_index
                if batch <= 0:
                    continue
                self._gc_handled_index = last
                self._gc_last_dispatch = time.monotonic()
                # One AppendEntries round per peer for the whole window.
                self._signal_peers_locked()
            observe_group_commit_batch(batch)
            try:
                # One WAL sync for the window, concurrent with the peer
                # sends (the replication threads re-check durability
                # after their round, so a failure here only defers
                # self's vote toward the majority).
                self._ensure_durable(last)
            except Exception as e:  # noqa: BLE001 — retried by peers/timer
                count_swallowed("raft.group_commit_sync", e)
                with self._lock:
                    self._gc_handled_index = min(self._gc_handled_index,
                                                 self._durable_index)

    def _ensure_durable(self, index: int) -> None:
        """Fsync the log up to at least ``index`` (batched across callers),
        then let the commit watermark advance with self counted."""
        with self._sync_lock:
            with self._lock:
                if self._durable_index >= index:
                    return
                target = self._last_index
            # Justified hold: _sync_lock IS the fsync serializer — it exists
            # only to batch concurrent durability requests into one sync
            # (contenders WANT to wait; their entries ride this fsync). The
            # state lock `_lock` is NOT held here, so appends/peer sends
            # proceed concurrently — this is the group-commit shape itself.
            self.log.sync()
            with self._lock:
                self._durable_index = max(self._durable_index, target)
                if self._role == Role.LEADER:
                    # Justified hold: _advance_commit_locked only touches
                    # in-memory watermarks here; the fsync the summary sees
                    # is a rare divergence-repair sub-path, not steady state.
                    self._advance_commit_locked()

    def change_config(self, new_peers: list[str],
                      timeout: float | Deadline = 10.0) -> LogEntry:
        """Replicate a new replica set (one-at-a-time membership change).
        Validation and append are atomic under the lock so two racing
        changes cannot both enter flight."""
        with self._lock:
            if self._role != Role.LEADER:
                raise NotLeader(self.uuid, self._leader_uuid)
            if self.cmeta.pending_config is not None:
                raise RuntimeError("config change already pending")
            cur = set(self.cmeta.committed_config.peers)
            if len(cur.symmetric_difference(new_peers)) > 1:
                raise ValueError("only one-server-at-a-time config changes")
            entry = self._leader_append_locked(
                "change_config", {"peers": list(new_peers), "opid_index": 0},
                None)
        self._ensure_durable(entry.op_id.index)
        self.wait_applied(entry.op_id, timeout)
        return entry

    def transfer_leadership(self, target: str) -> None:
        """Ask ``target`` to start an immediate election (leader stepdown;
        reference: RunLeaderElection RPC, consensus.proto:592)."""
        resp = self.transport.send(target, "raft.run_election",
                                   {"tablet_id": self.tablet_id},
                                   timeout=self.opts.rpc_timeout_s)
        if resp.get("code") != "ok":
            # Best effort — the target may simply lose the election — but
            # an outright refusal should not vanish.
            count_swallowed("raft.transfer_leadership", resp.get("code"))

    # -- rpc dispatch --------------------------------------------------------
    def handle(self, method: str, payload: dict) -> dict:
        if method == "raft.request_vote":
            return self.handle_request_vote(payload)
        if method == "raft.update_consensus":
            return self.handle_update_consensus(payload)
        if method == "raft.run_election":
            self._start_election(ignore_live_leader=True)
            return {"ok": True}
        raise ValueError(f"unknown consensus method {method}")

    # ----------------------------------------------------------------- votes
    def handle_request_vote(self, req: dict) -> dict:
        with self._lock:
            term = self.cmeta.current_term
            if req["term"] < term:
                return {"term": term, "granted": False}
            # Vote withholding while a live leader exists (lease guard):
            # prevents a rejoining partitioned node from disrupting the
            # group (reference: leader leases / pre-elections).
            if not req.get("ignore_live_leader"):
                now = time.monotonic()
                # the explicit message-borne promise first, then the
                # live-leader recency guard
                if now < self._vote_withhold_until:
                    return {"term": term, "granted": False}
                since = now - self._last_heartbeat_recv
                if self._leader_uuid is not None and \
                        since < self.opts.election_timeout_s:
                    return {"term": term, "granted": False}
            if req["term"] > term:
                self._step_down_locked(req["term"])
            granted = False
            up_to_date = ((req["last_log_term"], req["last_log_index"])
                          >= self._last_log_key())
            if up_to_date and self.cmeta.voted_for in (None, req["candidate"]):
                # Justified hold: Raft safety — the vote must be durable
                # (cmeta fsync) BEFORE any other vote/term decision can
                # read voted_for, or a crash-revote double-grants the term.
                self.cmeta.set_term(self.cmeta.current_term,
                                    voted_for=req["candidate"])
                self._last_heartbeat_recv = time.monotonic()
                self._election_timeout = self._next_timeout()
                granted = True
            return {"term": self.cmeta.current_term, "granted": granted}

    def _last_log_key(self) -> tuple[int, int]:
        e = self._entries.get(self._last_index)
        return (e.op_id.term if e else 0, self._last_index)

    # ----------------------------------------------------------- replication
    def handle_update_consensus(self, req: dict) -> dict:
        """Follower side of AppendEntries (reference: UpdateConsensus)."""
        with self._lock:
            term = self.cmeta.current_term
            if req["term"] < term:
                return {"term": term, "success": False,
                        "last_index": self._last_index}
            if req["term"] > term:
                self._step_down_locked(req["term"])
            elif self._role != Role.FOLLOWER:
                self._become_follower_locked()
            self._leader_uuid = req["leader"]
            self._last_heartbeat_recv = time.monotonic()
            self._election_timeout = self._next_timeout()
            granted = float(req.get("lease_s", 0.0))
            if granted > 0:
                self._vote_withhold_until = max(
                    self._vote_withhold_until,
                    time.monotonic() + granted)

            prev_index, prev_term = req["prev_index"], req["prev_term"]
            if prev_index > 0:
                pe = self._entries.get(prev_index)
                if prev_index > self._last_index or \
                        (pe is not None and pe.op_id.term != prev_term):
                    # Divergence: tell the leader to back off.
                    return {"term": self.cmeta.current_term, "success": False,
                            "last_index": min(self._last_index,
                                              prev_index - 1)}
            appended = False
            for rec in req["entries"]:
                e = LogEntry.from_record(rec)
                existing = self._entries.get(e.op_id.index)
                if existing is not None:
                    if existing.op_id.term == e.op_id.term:
                        continue  # already have it
                    self._truncate_suffix_locked(e.op_id.index - 1)
                self._append_local_locked(e, sync=False)
                appended = True
            if appended or self._durable_index < self._last_index:
                # ALSO when nothing new appended: a retried request whose
                # first attempt buffered entries but failed its sync must
                # not ack (and grant a lease) over unsynced entries —
                # every success response implies everything is durable.
                # Justified hold: the follower ack (and the lease grant it
                # carries) must imply durability, and the next request's
                # prev-entry check must see this one's entries — releasing
                # `_lock` mid-request would let a reordered retry ack over
                # unsynced state. Leader-side latency hides behind the
                # leader's own pipelined sends, not this path.
                self.log.sync()  # one fsync per request (group commit)
                self._durable_index = self._last_index
            new_commit = min(req["commit_index"], self._last_index)
            if new_commit > self._commit_index:
                self._commit_index = new_commit
                self._on_commit_advanced_locked()
            return {"term": self.cmeta.current_term, "success": True,
                    "last_index": self._last_index,
                    "lease_s_granted": granted}

    def _append_local_locked(self, e: LogEntry, sync: bool = True) -> None:
        self.log.append(e)
        if sync:
            self.log.sync()
        self._entries[e.op_id.index] = e
        self._last_index = e.op_id.index
        self.clock.update(HybridTime(e.ht))
        if e.op_type == "change_config":
            cfg = RaftConfig.from_dict(e.body)
            cfg.opid_index = e.op_id.index
            self.cmeta.pending_config = cfg
            self.cmeta.flush()
            if self._role == Role.LEADER:
                self._sync_peer_threads_locked()

    def _truncate_suffix_locked(self, last_kept: int) -> None:
        """Erase a conflicting log suffix (follower divergence)."""
        self.log.truncate_after(last_kept)
        self._durable_index = min(self._durable_index, last_kept)
        dropped = []
        for idx in range(last_kept + 1, self._last_index + 1):
            e = self._entries.pop(idx, None)
            if e is None:
                continue
            dropped.append(e)
            if e.op_type == "change_config" and \
                    self.cmeta.pending_config is not None and \
                    self.cmeta.pending_config.opid_index == idx:
                self.cmeta.pending_config = None
                self.cmeta.flush()
        self._last_index = last_kept
        if dropped and self.on_entries_truncated is not None:
            # Definite aborts: these entries will never apply here.
            self.on_entries_truncated(dropped)

    # -- leader-side peer loop ----------------------------------------------
    def _peer_loop(self, peer: _PeerState) -> None:
        try:
            self._peer_loop_impl(peer)
        except Exception:  # a dead replication thread must never be silent
            import logging
            logging.getLogger(__name__).exception(
                "raft peer loop %s->%s died", self.uuid, peer.uuid)

    def _peer_loop_impl(self, peer: _PeerState) -> None:
        while True:
            peer.signal.wait(timeout=self.opts.heartbeat_interval_s)
            peer.signal.clear()
            with self._lock:
                if not self._running or self._role != Role.LEADER or \
                        peer.uuid not in self._peers:
                    return
                term = self.cmeta.current_term
                min_cached = min(self._entries, default=self._last_index + 1)
                if peer.next_index < min_cached:
                    # The peer needs entries already evicted from the
                    # cache: it must be re-seeded by remote bootstrap
                    # (§5.3); keep heartbeating from the cache floor so it
                    # stays quiet, and nudge the bootstrap notifier
                    # (rate-limited) so the re-seed actually happens.
                    peer.needs_remote_bootstrap = True
                    peer.next_index = min_cached
                    now = time.monotonic()
                    if self.on_needs_bootstrap is not None and \
                            now - getattr(peer, "last_rb_request", 0) > 5.0:
                        peer.last_rb_request = now
                        cb, target = self.on_needs_bootstrap, peer.uuid
                        threading.Thread(
                            target=cb, args=(self.tablet_id, target),
                            daemon=True).start()
                prev_index = peer.next_index - 1
                pe = self._entries.get(prev_index)
                prev_term = pe.op_id.term if pe else 0
                batch = []
                idx = peer.next_index
                while idx <= self._last_index and \
                        len(batch) < self.opts.max_batch_entries:
                    batch.append(self._entries[idx].to_record())
                    idx += 1
                req = {
                    "tablet_id": self.tablet_id, "term": term,
                    "leader": self.uuid, "prev_index": prev_index,
                    "prev_term": prev_term, "entries": batch,
                    "commit_index": self._commit_index,
                    # message-borne lease: the follower promises not to
                    # vote for this duration (measured from OUR send
                    # time; its ack makes the grant effective)
                    "lease_s": self.opts.effective_lease_s,
                }
            send_time = time.monotonic()
            try:
                resp = self.transport.send(peer.uuid, "raft.update_consensus",
                                           req, timeout=self.opts.rpc_timeout_s)
            except Exception as e:
                # ANY send/remote failure (not just TransportError — e.g. a
                # remote handler error surfacing as RpcCallError) must leave
                # this replication thread alive; retry on the next tick.
                count_swallowed("raft.update_consensus", e)
                continue
            if batch and self._durable_index < batch[-1][1]:
                # Deferred leader durability (append_leader): sync once
                # per replication round, off the admission path. Shared
                # across both peer threads via the group-commit sync
                # lock. A sync failure must not kill the replication
                # thread — self simply keeps not counting toward the
                # majority (the two followers carry it).
                try:
                    self._ensure_durable(batch[-1][1])
                except Exception as e:  # noqa: BLE001
                    count_swallowed("raft.leader_sync", e)
            need_apply = False
            with self._lock:
                if not self._running or self._role != Role.LEADER or \
                        self.cmeta.current_term != term:
                    return
                if resp["term"] > term:
                    self._step_down_locked(resp["term"])
                    return
                if resp["success"]:
                    peer.last_ack_monotonic = send_time
                    peer.lease_until = max(
                        peer.lease_until,
                        send_time + float(resp.get("lease_s_granted", 0.0)))
                    if batch:
                        peer.match_index = max(peer.match_index,
                                               batch[-1][1])
                        peer.next_index = peer.match_index + 1
                        peer.needs_remote_bootstrap = False
                    self._advance_commit_locked()
                    need_apply = self._applied_index < self._commit_index
                    if peer.next_index <= self._last_index:
                        peer.signal.set()  # keep streaming the backlog
                else:
                    peer.next_index = max(1, min(resp["last_index"] + 1,
                                                 peer.next_index - 1))
                    peer.signal.set()
            if need_apply:
                # Apply inline: the ack that advanced the commit point
                # finishes the write without an apply-thread hop. Bounded
                # so this replication thread keeps heartbeating its
                # follower; any remainder falls to the apply thread.
                self._drain_applies(max_entries=4 * self.opts.max_batch_entries)

    def _advance_commit_locked(self) -> None:
        """Advance the majority-replicated watermark (current-term entries
        only — the standard Raft commit rule)."""
        cfg = self.cmeta.active_config
        matches = []
        for uuid in cfg.peers:
            if uuid == self.uuid:
                matches.append(self._durable_index)  # only once fsynced
                continue
            p = self._peers.get(uuid)
            matches.append(p.match_index if p else 0)
        if not matches:
            return
        matches.sort(reverse=True)
        candidate = matches[cfg.majority_size() - 1]
        if candidate > self._commit_index:
            e = self._entries.get(candidate)
            if e is not None and e.op_id.term == self.cmeta.current_term:
                self._commit_index = candidate
                self._on_commit_advanced_locked()

    def _on_commit_advanced_locked(self) -> None:
        # Commit a pending config change.
        pc = self.cmeta.pending_config
        if pc is not None and pc.opid_index <= self._commit_index:
            self.cmeta.committed_config = pc
            self.cmeta.pending_config = None
            self.cmeta.flush()
            if self._role == Role.LEADER:
                self._sync_peer_threads_locked()
                if not self.cmeta.committed_config.has_peer(self.uuid):
                    self._become_follower_locked()  # we were removed
        self._apply_cond.notify_all()
        self._commit_cond.notify_all()

    def _signal_peers_locked(self) -> None:
        for p in self._peers.values():
            p.signal.set()

    # -- log cache eviction + bootstrap handoff ------------------------------
    def evict_cache(self, up_to: int) -> int:
        """Bound the in-memory entry cache: drop entries strictly below
        min(up_to, applied) — the floor entry itself is retained as the
        prev-term anchor for peer probing. Lagging peers whose next entry
        was evicted are re-seeded via remote bootstrap instead of log
        catchup (reference: LogCache eviction + the remote-bootstrap
        trigger in consensus_queue.cc)."""
        with self._lock:
            limit = min(up_to, self._applied_index)
            # Keep TWO anchors (limit-1 and limit): a peer whose next
            # entry is the floor still needs prev_term of floor-1 for its
            # consistency probe — evicting it would bounce that peer into
            # a needless full bootstrap.
            victims = [i for i in self._entries if i < limit - 1]
            for i in victims:
                del self._entries[i]
            return len(victims)

    def log_tail_snapshot(self) -> dict:
        """Everything a lagging peer needs beyond a storage snapshot:
        the cached log tail (with the commit watermark stamped on the
        records), current term, and the committed config — the payload
        of a remote-bootstrap session (remote_bootstrap_session.cc)."""
        with self._lock:
            records = []
            for i in sorted(self._entries):
                rec = self._entries[i].to_record()
                rec[5] = min(self._commit_index, i)  # stamp committed
                records.append(rec)
            return {
                "log": records,
                "term": self.cmeta.current_term,
                "config": self.cmeta.committed_config.to_dict(),
                "commit_index": self._commit_index,
            }

    # -- apply ---------------------------------------------------------------
    def _run_apply(self) -> None:
        try:
            self._apply_loop()
        except Exception:  # a silently-dead applier halts the state machine
            logging.getLogger(__name__).exception(
                "raft %s: apply thread died", self.uuid)

    def _apply_loop(self) -> None:
        while True:
            with self._lock:
                while self._running and \
                        (self._applying or
                         self._applied_index >= self._commit_index):
                    self._apply_cond.wait(timeout=0.5)
                if not self._running:
                    if self._stall_watch is not None:
                        self._stall_watch.__exit__(None, None, None)
                        self._stall_watch = None
                    return
            self._drain_applies()
            with self._lock:
                # A hole (possible transiently after an interrupted
                # truncation) must stall the apply, not busy-spin.
                if not self._applying and \
                        self._applied_index < self._commit_index:
                    # A hole that persists is an apply stall (standing
                    # watchdog check, kernel_stack_watchdog.h analog).
                    if self._stall_watch is None:
                        from yugabyte_db_tpu_torch.utils.watchdog import (
                            watchdog)

                        self._stall_watch = watchdog().watch(
                            "raft.apply_hole", threshold_s=5.0)
                        self._stall_watch.__enter__()
                    self._apply_cond.wait(timeout=0.2)
                elif self._stall_watch is not None:
                    self._stall_watch.__exit__(None, None, None)
                    self._stall_watch = None

    def _drain_applies(self, max_entries: int | None = None) -> None:
        """Apply committed entries in strict log order, from WHATEVER
        thread reached the commit point first (single applier at a
        time). Leader-side, the replication thread that advanced the
        commit watermark applies inline — the writer waiting in
        wait_applied wakes exactly once, with the result ready, instead
        of paying an extra thread hop through the apply loop (the same
        motive as the reference running ApplyTask on the prepare
        thread's token when it can, operation_driver.cc). The apply
        thread remains for entries nobody is waiting on (followers).

        ``max_entries`` bounds an inline drain: a replication thread
        must not disappear into a huge committed backlog (its follower
        would miss heartbeats long enough to start an election) — it
        applies a bounded slice and hands the rest to the apply thread."""
        try:
            if FLAGS.get("fault.raft_apply_stall") > 0:
                # Deterministic widening of the commit-ack/apply window
                # (the commit_ack_crash sweep round): committed entries
                # stay queued; acks still go out at commit.
                count_fault_fired("fault.raft_apply_stall")
                return
        except KeyError:
            pass
        with self._lock:
            if self._applying:
                return
            self._applying = True
        applied = 0
        try:
            while True:
                with self._lock:
                    # Strictly contiguous: stop at any hole.
                    batch = []
                    i = self._applied_index + 1
                    while i <= self._commit_index and i in self._entries:
                        if max_entries is not None and \
                                applied + len(batch) >= max_entries:
                            break
                        batch.append(self._entries[i])
                        i += 1
                    if not batch:
                        return
                for e in batch:
                    if e.op_type not in ("no_op", "change_config"):
                        self.apply_cb(e)
                    with self._lock:
                        self._applied_index = e.op_id.index
                        self._commit_cond.notify_all()
                applied += len(batch)
                if max_entries is not None and applied >= max_entries:
                    return
        finally:
            with self._lock:
                self._applying = False
                self._apply_cond.notify_all()

    def wait_applied(self, op_id: OpId, timeout: float | Deadline) -> None:
        """Block until the entry is applied. Raises NotLeader if it was
        truncated (definitely aborted) and TimeoutError if the outcome is
        still UNKNOWN — a timed-out entry may yet commit."""
        self._wait_watermark(op_id, _as_deadline(timeout), applied=True)

    def wait_committed(self, op_id: OpId, timeout: float | Deadline) -> None:
        """Block until the entry is majority-durable (commit-time ack —
        the pipelined-apply write path acks here). The entry may not yet
        be APPLIED locally: the apply stage drains asynchronously behind
        the MVCC read fence (safe time cannot pass an unapplied write).
        Raises NotLeader if the entry was truncated and TimeoutError
        while the outcome is still unknown."""
        self._wait_watermark(op_id, _as_deadline(timeout), applied=False)

    def wait_apply_drained(self, timeout: float | Deadline = 10.0) -> bool:
        """Block until the apply stage catches up with the commit
        watermark observed at entry — the barrier maintenance operations
        (flush, snapshot) take so a commit-acked write can't be missing
        from the memtable they capture. False on timeout/shutdown."""
        dl = _as_deadline(timeout)
        with self._lock:
            target = self._commit_index
            while self._applied_index < target:
                remaining = dl.remaining()
                if remaining <= 0 or not self._running:
                    return False
                # Justified hold: callers are maintenance barriers that
                # take _maintenance_lock precisely to EXCLUDE flush/
                # snapshot while apply drains — holding it across the
                # wait is the barrier's purpose (`_commit_cond` releases
                # the state lock `_lock` itself for the duration).
                self._commit_cond.wait(timeout=remaining)
        return True

    def _wait_watermark(self, op_id: OpId, deadline: Deadline,
                        applied: bool) -> None:
        with self._lock:
            while True:
                e = self._entries.get(op_id.index)
                if e is None:
                    if op_id.index <= self._applied_index:
                        return  # applied, then evicted from the cache
                    raise NotLeader(self.uuid, self._leader_uuid)  # truncated
                if e.op_id.term != op_id.term:
                    raise NotLeader(self.uuid, self._leader_uuid)  # truncated
                watermark = (self._applied_index if applied
                             else self._commit_index)
                if watermark >= op_id.index:
                    return
                remaining = deadline.remaining()
                if remaining <= 0 or not self._running:
                    raise TimeoutError(f"commit timeout for {op_id}")
                self._commit_cond.wait(timeout=remaining)

    # -- elections -----------------------------------------------------------
    def _next_timeout(self) -> float:
        return self.opts.election_timeout_s * (1.0 + self._rng.random())

    def _run_timer(self) -> None:
        try:
            self._timer_loop()
        except Exception:  # a silently-dead timer wedges heartbeats/elections
            logging.getLogger(__name__).exception(
                "raft %s: timer thread died", self.uuid)

    def _timer_loop(self) -> None:
        # Deadline-based, not fixed-tick: sleep until the next event
        # (heartbeat due / election timeout) and recompute on wake. A
        # node hosts one Raft instance PER TABLET, so idle tick storms
        # scale with tablet count — the reference amortizes this with a
        # shared timer wheel (rpc/scheduler.cc); sleeping to the exact
        # deadline gets the same effect per-instance.
        min_sleep = min(0.02, self.opts.heartbeat_interval_s / 2)
        while True:
            start_election = False
            retry_sync = 0
            with self._lock:
                if not self._running:
                    return
                now = time.monotonic()
                if self._role == Role.LEADER:
                    due = self._last_broadcast + \
                        self.opts.heartbeat_interval_s
                    if now >= due:
                        self._last_broadcast = now
                        self._signal_peers_locked()
                        due = now + self.opts.heartbeat_interval_s
                        if self._durable_index < self._last_index and \
                                len(self.cmeta.active_config.peers) == 1:
                            # A failed group-commit sync left a buffered
                            # tail; only SINGLE-peer groups need the
                            # heartbeat retry (multi-peer leaders defer
                            # fsync to the replication threads by design
                            # — syncing here would block the timer).
                            retry_sync = self._last_index
                    sleep_s = due - now
                elif self.cmeta.active_config.has_peer(self.uuid):
                    deadline = self._last_heartbeat_recv + \
                        self._election_timeout
                    if now > deadline:
                        start_election = True
                        sleep_s = min_sleep
                    else:
                        sleep_s = deadline - now
                else:
                    sleep_s = self.opts.election_timeout_s
            if retry_sync:
                try:
                    self._ensure_durable(retry_sync)
                except Exception as e:  # noqa: BLE001 — retried next beat
                    count_swallowed("raft.follower_sync_retry", e)
            if start_election:
                self._start_election()
            time.sleep(max(min_sleep, min(sleep_s, 0.5)))

    def _start_election(self, ignore_live_leader: bool = False) -> None:
        with self._lock:
            if not self._running or self._role == Role.LEADER:
                return
            if not self.cmeta.active_config.has_peer(self.uuid):
                return
            self._role = Role.CANDIDATE
            self._leader_uuid = None
            term = self.cmeta.current_term + 1
            # Justified hold: Raft safety — the self-vote and term bump
            # must hit disk before any concurrent request_vote can read
            # voted_for, or this node could double-vote in the new term.
            self.cmeta.set_term(term, voted_for=self.uuid)
            self._last_heartbeat_recv = time.monotonic()
            self._election_timeout = self._next_timeout()
            last_term, last_index = self._last_log_key()
            peers = [u for u in self.cmeta.active_config.peers
                     if u != self.uuid]
            majority = self.cmeta.active_config.majority_size()
        votes = {self.uuid}
        votes_lock = threading.Lock()
        req = {"tablet_id": self.tablet_id, "term": term,
               "candidate": self.uuid, "last_log_term": last_term,
               "last_log_index": last_index,
               "ignore_live_leader": ignore_live_leader}

        def ask(peer_uuid: str) -> None:
            try:
                resp = self.transport.send(peer_uuid, "raft.request_vote",
                                           req, timeout=self.opts.rpc_timeout_s)
            except Exception:  # any delivery failure = a vote not received
                return
            with self._lock:
                if resp["term"] > self.cmeta.current_term:
                    self._step_down_locked(resp["term"])
                    return
                if not (self._role == Role.CANDIDATE and
                        self.cmeta.current_term == term and resp["granted"]):
                    return
            with votes_lock:
                votes.add(peer_uuid)
                won = len(votes) >= majority
            if won:
                self._become_leader(term)

        threads = [threading.Thread(target=ask, args=(u,), daemon=True)
                   for u in peers]
        for t in threads:
            t.start()
        if majority == 1:
            self._become_leader(term)

    def _become_leader(self, term: int) -> None:
        with self._lock:
            if not self._running or self._role != Role.CANDIDATE or \
                    self.cmeta.current_term != term:
                return
            self._role = Role.LEADER
            self._leader_uuid = self.uuid
            self._last_broadcast = time.monotonic()
            self._leader_since = self._last_broadcast
            self._gc_handled_index = self._last_index
            self._peers.clear()
            self._sync_peer_threads_locked()
            # Assert leadership with a no_op; committing it commits all
            # prior-term entries (reference appends a NO_OP on election).
            entry = self._leader_append_locked("no_op", None, None)
            self._own_term_noop = (term, entry.op_id.index)
        try:
            self._ensure_durable(entry.op_id.index)
        except Exception:  # noqa: BLE001 — e.g. an injected sync fault
            # The no_op stays buffered; leadership stands (leader_ready
            # remains false until it lands) and the timer loop retries
            # durability — an election thread must never die on a
            # transient storage error.
            import logging

            logging.getLogger(__name__).warning(
                "%s: leader no_op durability deferred", self.uuid)

    def _sync_peer_threads_locked(self) -> None:
        """Make replication threads match the active config."""
        want = {u for u in self.cmeta.active_config.peers if u != self.uuid}
        for uuid in list(self._peers):
            if uuid not in want:
                self._peers.pop(uuid).signal.set()
        for uuid in want:
            if uuid not in self._peers:
                p = _PeerState(uuid, self._last_index + 1)
                self._peers[uuid] = p
                p.thread = threading.Thread(
                    target=self._peer_loop, args=(p,),
                    name=f"raft-peer-{self.uuid}->{uuid}", daemon=True)
                p.thread.start()

    def _step_down_locked(self, new_term: int) -> None:
        self.cmeta.set_term(new_term)
        self._become_follower_locked()

    def _become_follower_locked(self) -> None:
        if self._role == Role.LEADER:
            self._peers.clear()
        self._role = Role.FOLLOWER
        self._leader_uuid = None
        self._last_heartbeat_recv = time.monotonic()
        self._election_timeout = self._next_timeout()
