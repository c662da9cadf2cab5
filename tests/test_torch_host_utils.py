"""The port's host utilities: watchdog, metrics, flags, trace, retry, the
consensus transport's ``send_with_retry``, and the resource and lock
witnesses.

Mirrors, on the port's modules, of the cases of the JAX tests that need
only ported modules:

- ``tests/test_watchdog.py`` (both tests; the WAL is the port's);
- ``tests/test_metrics.py``: the registry's Prometheus text (also equal
  to the JAX registry's text for the same operations), the flag
  registry, the counter hammer;
- ``tests/test_trace.py``: ``TRACE`` plumbing, ``RpczStore``, trace
  events and stacks (the webserver cases wait for the tserver);
- ``tests/test_retry.py``: ``Deadline`` and ``RetryPolicy``, every case;
  ``send_with_retry`` over a ``LocalTransport`` that drops;
- ``tests/test_resource_witness.py``: hold observations (a demo class,
  the WAL's roll-over and its unlocked group-commit fsync), the hold
  histogram on the process registry, the dump loader;
- ``tests/test_lock_witness.py``: the declaration and observation cases.

And the WAL's sync histogram ``yb_wal_sync_ms`` (``observe_wal_sync_ms``).
"""

from __future__ import annotations

import json
import random
import tempfile
import threading
import time

import pytest

from yugabyte_db_tpu_torch.consensus.transport import (LocalTransport,
                                                       TransportError,
                                                       send_with_retry)
from yugabyte_db_tpu_torch.tablet.wal import Log, LogEntry, OpId
from yugabyte_db_tpu_torch.utils import locking, metrics, resources
from yugabyte_db_tpu_torch.utils.flags import FLAGS
from yugabyte_db_tpu_torch.utils.locking import guarded_by
from yugabyte_db_tpu_torch.utils.metrics import MetricRegistry
from yugabyte_db_tpu_torch.utils.retry import (RETRIABLE_WIRE_CODES,
                                               Deadline, DeadlineExpired,
                                               RetryPolicy)
from yugabyte_db_tpu_torch.utils.status import Code, Status, StatusError
from yugabyte_db_tpu_torch.utils.trace import (TRACE, TRACE_EVENTS,
                                               RpczStore, Trace,
                                               dump_stacks, trace_event,
                                               trace_request)
from yugabyte_db_tpu_torch.utils.watchdog import StallWatchdog, watchdog


@pytest.fixture(autouse=True)
def _witness_reset():
    locking.witness().clear()
    resources.witness().clear()
    yield
    locking.disable_lock_witness()
    locking.witness().clear()
    resources.disable_resource_witness()
    resources.witness().clear()


# -- tests/test_watchdog.py --------------------------------------------------

def test_flags_inflight_and_late_sections():
    wd = StallWatchdog(interval_s=0.05)
    with wd.watch("fast", threshold_s=1.0):
        pass
    assert wd.stalls() == []
    # In-flight past threshold: sampler flags while still running.
    with wd.watch("slow.sampled", threshold_s=0.1):
        time.sleep(0.4)
    recs = wd.stalls("slow.sampled")
    assert recs and recs[0]["seconds"] >= 0.1
    assert any(not r["completed"] for r in recs)
    # Late completion between samples: flagged post-hoc, once.
    wd2 = StallWatchdog(interval_s=30.0)
    with wd2.watch("slow.late", threshold_s=0.01):
        time.sleep(0.05)
    recs = wd2.stalls("slow.late")
    assert len(recs) == 1 and recs[0]["completed"]
    assert wd2.stall_count == 1
    wd2.reset()
    assert wd2.stalls() == []


def test_wal_sync_is_watched(tmp_path):
    """The WAL's group-commit sync registers with the process watchdog
    (a normal sync produces no stall records) and records its latency."""
    h = metrics._write_path_entity().histogram(
        "yb_wal_sync_ms", buckets=metrics.WAL_SYNC_MS_BUCKETS)
    before = h.count
    watchdog().reset()
    log = Log(str(tmp_path), fsync=True)
    log.append(LogEntry(OpId(1, 1), 5, "write", {"x": 1}))
    log.sync()
    assert watchdog().stalls("wal.sync") == []
    assert h.count == before + 1


# -- tests/test_metrics.py ---------------------------------------------------

def _registry_text(metrics_mod):
    reg = metrics_mod.MetricRegistry()
    ent = reg.entity(daemon="x")
    ent.counter("reqs_total").increment(3)
    ent.gauge("temp").set(42)
    h = ent.histogram("lat_us")
    for v in (100, 1000, 100000):
        h.observe(v)
    return reg.prometheus_text(), h


def test_registry_prometheus_text():
    import yugabyte_db_tpu.utils.metrics as j_metrics

    text, h = _registry_text(metrics)
    assert '# TYPE reqs_total counter' in text
    assert 'reqs_total{daemon="x"} 3' in text
    assert 'temp{daemon="x"} 42' in text
    assert 'lat_us_count{daemon="x"} 3' in text
    assert 'lat_us_sum{daemon="x"} 101100' in text
    assert 'le="+Inf"' in text
    assert h.percentile(0.5) >= 100
    assert text == _registry_text(j_metrics)[0]


def test_flags_registry():
    FLAGS.define("test_only_flag", 7, "testing", ("runtime",))
    assert FLAGS.get("test_only_flag") == 7
    FLAGS.set("test_only_flag", 9)
    assert FLAGS.get("test_only_flag") == 9
    FLAGS.define("test_unsafe_flag", 1, "danger", ("unsafe",))
    with pytest.raises(PermissionError):
        FLAGS.set("test_unsafe_flag", 2)
    FLAGS.set("test_unsafe_flag", 2, force=True)
    assert FLAGS.get("test_unsafe_flag") == 2


def test_slice_flags_match_the_jax_flags():
    """The flags the consensus slice reads: the JAX names, defaults,
    help texts and tags."""
    from yugabyte_db_tpu.utils.flags import FLAGS as JFLAGS

    names = ("fault.wal_sync_failed", "raft_group_commit_window_us",
             "raft_max_inflight_ops", "fault.raft_apply_stall")
    port = {f.name: f for f in FLAGS.all()}
    jax = {f.name: f for f in JFLAGS.all()}
    for n in names:
        assert (port[n].default, port[n].help, port[n].tags) == \
            (jax[n].default, jax[n].help, jax[n].tags), n


def test_registry_hammer_counts_are_exact():
    """8 threads hammering one registry's counters/histograms/gauges:
    every increment lands."""
    reg = MetricRegistry()
    ent = reg.entity(role="hammer")
    c = ent.counter("hammer_total")
    h = ent.histogram("hammer_us", buckets=(10, 100, 1000))
    g = ent.gauge("hammer_last")
    n_threads, n_ops = 8, 2000
    barrier = threading.Barrier(n_threads)

    def worker(tid):
        barrier.wait()
        for i in range(n_ops):
            c.increment()
            h.observe(i % 1000)
            g.set(tid)

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.get() == n_threads * n_ops
    assert h.count == n_threads * n_ops
    assert g.get() in range(n_threads)


# -- tests/test_trace.py -----------------------------------------------------

def test_trace_collects_messages_below_dispatch():
    def nested():
        TRACE("deep %d", 42)

    with trace_request("svc.method") as t:
        TRACE("start")
        nested()
    assert t.duration_us >= 0
    msgs = [m for _dt, m in t.entries]
    assert msgs == ["start", "deep 42"]
    d = t.dump()
    assert d["method"] == "svc.method" and len(d["messages"]) == 2


def test_trace_without_active_request_is_noop():
    TRACE("nobody listening")  # must not raise


def test_trace_is_context_isolated():
    errs = []

    def worker(i):
        with trace_request(f"m{i}") as t:
            for j in range(10):
                TRACE(f"w{i}-{j}")
        if [m for _d, m in t.entries] != [f"w{i}-{j}" for j in range(10)]:
            errs.append(i)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errs


def test_trace_message_cap():
    with trace_request("m") as t:
        for i in range(200):
            TRACE(f"msg{i}")
    assert len(t.entries) == 64
    assert t.dump()["dropped_messages"] == 136


def test_rpcz_store_recent_and_slow():
    store = RpczStore(recent_per_method=2, slow_threshold_us=1000)
    for _ in range(5):
        t = Trace("a.b")
        t.finish()
        store.record(t)
    slow = Trace("a.b")
    slow.finish()
    slow.duration_us = 5000
    store.record(slow)
    d = store.dump()
    assert len(d["methods"]["a.b"]) == 2  # bounded per method
    assert len(d["slow"]) == 1 and d["slow"][0]["duration_us"] == 5000


def test_trace_events_and_stacks():
    with trace_event("unit-span", tablet="t1"):
        pass
    events = TRACE_EVENTS.dump()["traceEvents"]
    mine = [e for e in events if e["name"] == "unit-span"]
    assert mine and mine[-1]["ph"] == "X" and mine[-1]["dur"] >= 0
    assert mine[-1]["args"] == {"tablet": "t1"}
    stacks = dump_stacks()
    assert "MainThread" in stacks and "test_trace_events_and_stacks" in stacks


# -- tests/test_retry.py -----------------------------------------------------

def no_sleep_policy(**kw):
    kw.setdefault("sleep", lambda s: None)
    kw.setdefault("rng", random.Random(7))
    return RetryPolicy(**kw)


def test_deadline_after_and_remaining():
    d = Deadline.after(10.0)
    assert 9.0 < d.remaining() <= 10.0
    assert not d.expired()
    d.check("op")  # no raise


def test_deadline_expired_raises_timed_out():
    d = Deadline.after(-1.0)
    assert d.expired()
    with pytest.raises(DeadlineExpired) as ei:
        d.check("scan")
    assert ei.value.status.code == Code.TIMED_OUT
    assert "scan" in str(ei.value)


def test_deadline_timeout_caps_at_remaining():
    d = Deadline.after(0.5)
    assert d.timeout(2.0) <= 0.5
    assert d.timeout(0.1) == pytest.approx(0.1, abs=0.01)
    expired = Deadline.after(-5.0)
    assert expired.timeout(2.0) == 0.0  # floored, never negative


def test_infinite_deadline_never_expires():
    d = Deadline.infinite()
    assert not d.expired()
    assert d.timeout(3.0) == 3.0
    assert d.remaining() == float("inf")


def test_retriable_accepts_every_failure_shape():
    p = no_sleep_policy(max_attempts=3)
    assert p.retriable(Code.TIMED_OUT)
    assert p.retriable(Status(Code.SERVICE_UNAVAILABLE, "x"))
    assert p.retriable("timed_out")
    assert p.retriable({"code": "not_leader"})
    assert p.retriable(StatusError(Status(Code.NETWORK_ERROR, "x")))
    assert p.retriable(TimeoutError("slow"))
    assert p.retriable(ConnectionError("refused"))


def test_terminal_failures_are_not_retriable():
    p = no_sleep_policy(max_attempts=3)
    assert not p.retriable(None)
    assert not p.retriable(Code.INVALID_ARGUMENT)
    assert not p.retriable(Code.EXPIRED)  # the budget itself — never retried
    assert not p.retriable("conflict")
    assert not p.retriable({"code": "ok"})
    assert not p.retriable(ValueError("bug"))


def test_wire_codes_mirror_the_rpc_payload_convention():
    assert "timed_out" in RETRIABLE_WIRE_CODES
    assert "not_leader" in RETRIABLE_WIRE_CODES
    assert "conflict" not in RETRIABLE_WIRE_CODES


def test_backoff_grows_exponentially_within_jitter_bounds():
    p = no_sleep_policy(max_attempts=10, initial_backoff_s=0.1,
                        max_backoff_s=10.0, multiplier=2.0, jitter=0.25)
    for n, base in [(1, 0.1), (2, 0.2), (3, 0.4), (4, 0.8)]:
        for _ in range(20):
            s = p.backoff_s(n)
            assert base * 0.75 <= s <= base * 1.25


def test_backoff_is_capped_at_max():
    p = no_sleep_policy(max_attempts=10, initial_backoff_s=0.1,
                        max_backoff_s=0.5, multiplier=2.0, jitter=0.0)
    assert p.backoff_s(10) == pytest.approx(0.5)


def test_unbounded_policy_is_rejected_at_construction():
    with pytest.raises(ValueError):
        RetryPolicy()


def test_attempts_stop_at_max_attempts():
    p = no_sleep_policy(max_attempts=4)
    assert [a.number for a in p.attempts()] == [1, 2, 3, 4]


def test_attempts_sleep_between_iterations_but_not_after_last():
    slept = []
    p = RetryPolicy(max_attempts=3, sleep=slept.append,
                    rng=random.Random(7))
    list(p.attempts())
    assert len(slept) == 2  # n attempts -> n-1 backoffs


def test_attempts_stop_when_deadline_expires():
    p = no_sleep_policy(max_attempts=100)
    d = Deadline.after(-1.0)
    # The first attempt is always yielded, then the exhausted deadline
    # stops the loop.
    assert [a.number for a in p.attempts(deadline=d)] == [1]


def test_attempts_never_sleep_past_the_deadline():
    slept = []
    p = RetryPolicy(max_attempts=50, initial_backoff_s=5.0,
                    sleep=slept.append, rng=random.Random(7))
    d = Deadline.after(0.2)
    list(p.attempts(deadline=d))
    assert all(s <= 0.2 for s in slept)


def test_attempt_note_carries_the_last_failure():
    p = no_sleep_policy(max_attempts=2)
    seen = None
    for attempt in p.attempts():
        attempt.note({"code": "timed_out"})
        seen = attempt.last
    assert seen == {"code": "timed_out"}


def test_attempts_timeout_s_overrides_policy_budget():
    p = no_sleep_policy(timeout_s=100.0, initial_backoff_s=0.001)
    count = sum(1 for _ in p.attempts(timeout_s=-1.0))
    assert count == 1  # the explicit (already expired) budget wins


def test_call_returns_first_success():
    p = no_sleep_policy(max_attempts=5)
    calls = []

    def fn(attempt):
        calls.append(attempt.number)
        if attempt.number < 3:
            raise TimeoutError("not yet")
        return "ok"

    assert p.call(fn) == "ok"
    assert calls == [1, 2, 3]


def test_call_propagates_terminal_errors_immediately():
    p = no_sleep_policy(max_attempts=5)
    calls = []

    def fn(attempt):
        calls.append(attempt.number)
        raise ValueError("a bug, not weather")

    with pytest.raises(ValueError):
        p.call(fn)
    assert calls == [1]


def test_call_reraises_last_retriable_failure_on_exhaustion():
    p = no_sleep_policy(max_attempts=2)

    def fn(attempt):
        raise ConnectionError(f"attempt {attempt.number}")

    with pytest.raises(ConnectionError, match="attempt 2"):
        p.call(fn)


def test_call_raises_deadline_expired_when_nothing_ran():
    p = no_sleep_policy(max_attempts=5)
    d = Deadline.after(-1.0)

    def fn(attempt):
        raise TimeoutError("x")

    with pytest.raises(TimeoutError):
        p.call(fn, deadline=d)


def test_send_with_retry_outwaits_drops_and_retriable_codes():
    """``send_with_retry``: transport failures and retriable wire codes
    back off and retry; a terminal response returns at once; a node that
    never answers raises TransportError once the policy gives up."""
    t = LocalTransport(seed=3)
    answers = [{"code": "not_leader"}, {"code": "try_again"},
               {"code": "ok", "v": 7}]
    calls = []

    def handler(method, payload):
        calls.append((method, payload))
        return answers[min(len(calls) - 1, len(answers) - 1)]

    t.register("n1", handler)
    policy = no_sleep_policy(max_attempts=10)
    t.drop_rate = 0.5
    resp = send_with_retry(t.bind("n0"), "n1", "m", {"x": 1}, policy=policy)
    assert resp == {"code": "ok", "v": 7}
    assert len(calls) == 3 and calls[0] == ("m", {"x": 1})
    t.drop_rate = 0.0
    assert send_with_retry(t.bind("n0"), "n1", "m", {},
                           policy=policy)["code"] == "ok"
    t.isolate("n1")
    with pytest.raises(TransportError, match="unreachable before deadline"):
        send_with_retry(t.bind("n0"), "n1", "m", {},
                        policy=no_sleep_policy(max_attempts=3))


# -- tests/test_resource_witness.py ------------------------------------------

@guarded_by("_lock", "_n")
class _Demo:
    def __init__(self):
        self._lock = threading.RLock()
        self._n = 0

    def poke(self, blocking=None):
        with self._lock:
            self._n += 1
            if blocking:
                resources.note_blocking(blocking)


def test_hold_across_blocking_recorded_with_class():
    resources.enable_resource_witness()
    d = _Demo()  # constructed under the witness: guard lock wrapped
    d.poke(blocking="fsync")
    d.poke(blocking="fsync")
    d.poke()
    (h,) = resources.witness().holds()
    assert h["cls"] == "_Demo" and h["blocking"] == "fsync"
    assert h["count"] == 2
    assert "test_torch_host_utils" in h["site"]


def test_wal_rollover_fsync_is_a_hold_and_the_dump_loads(tmp_path):
    """The WAL's segment roll-over fsyncs the old segment under
    ``Log._lock``: the witness records (Log, fsync), and the dump reads
    back through the loader."""
    resources.enable_resource_witness()
    with tempfile.TemporaryDirectory() as d:
        log = Log(d, segment_bytes=1, fsync=True)
        for i in range(1, 4):
            log.append(LogEntry(OpId(1, i), i, "write", {"i": i}))
            log.sync()
        log.close()
    holds = {(h["cls"], h["blocking"])
             for h in resources.witness().holds()}
    assert ("Log", "fsync") in holds
    path = str(tmp_path / "wal_hold.json")
    resources.dump_resource_witness(path)
    dump = resources.load_resource_witness_dump(path)
    assert dump["leaks"] == [] and any(
        h["cls"] == "Log" for h in dump["holds"])


def test_group_commit_fsync_runs_unlocked():
    """The steady-state sync() path fsyncs OUTSIDE ``_lock``: no hold
    observation without a roll-over."""
    resources.enable_resource_witness()
    with tempfile.TemporaryDirectory() as d:
        log = Log(d, fsync=True)  # default segments: no roll-over
        for i in range(1, 4):
            log.append(LogEntry(OpId(1, i), i, "write", {"i": i}))
            log.sync()
        holds = {(h["cls"], h["blocking"])
                 for h in resources.witness().holds()}
        assert ("Log", "fsync") not in holds
        log.close()


def test_hold_histogram_and_counters_on_the_process_registry():
    """yb_lock_hold_seconds{cls} and the witness counters render on the
    process registry (what a daemon's /metrics scrape renders)."""
    resources.enable_resource_witness()
    d = _Demo()
    d.poke()                               # one hold interval observed
    resources.witness().pin_acquired(1, label="m")
    resources.witness().pin_released(1)
    text = metrics.process_registry().prometheus_text()
    assert "yb_lock_hold_seconds_bucket" in text
    assert 'cls="_Demo"' in text
    assert "yb_resource_pin_acquires" in text
    assert "yb_resource_pin_releases" in text


def test_loader_rejects_other_dump_kinds(tmp_path):
    p = tmp_path / "lock.json"
    p.write_text(json.dumps({"kind": "yb-lock-witness",
                             "observations": []}))
    with pytest.raises(ValueError):
        resources.load_resource_witness_dump(str(p))


# -- tests/test_lock_witness.py ----------------------------------------------

def _obs(cls_name, field):
    for row in locking.witness().observations():
        if row["class"] == cls_name and row["field"] == field:
            return row
    return None


@guarded_by("_lock", "_n", "_state")
class _Guarded:
    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0
        self._state = "closed"

    def bump_locked_path(self):
        with self._lock:
            self._n += 1

    def bump_racy_path(self):
        self._n += 1


def test_declaration_is_recorded_on_class():
    assert _Guarded.__guarded_by__ == {"_n": "_lock", "_state": "_lock"}
    assert _Guarded.__guard_locks__ == frozenset({"_lock"})


def test_declarations_stack():
    @guarded_by("_a", "_x")
    @guarded_by("_b", "_y")
    class Two:
        pass

    assert Two.__guarded_by__ == {"_x": "_a", "_y": "_b"}
    assert Two.__guard_locks__ == frozenset({"_a", "_b"})


def test_non_literal_declaration_rejected():
    with pytest.raises(TypeError):
        guarded_by("_lock")  # no fields
    with pytest.raises(TypeError):
        guarded_by(3, "_x")


def test_disabled_witness_records_nothing():
    g = _Guarded()
    g.bump_racy_path()
    assert locking.witness().observations() == []


def test_witness_sees_held_and_unheld_writes():
    locking.enable_lock_witness()
    g = _Guarded()  # constructed under the witness: lock gets wrapped
    g.bump_locked_path()
    g.bump_locked_path()
    g.bump_racy_path()
    row = _obs("_Guarded", "_n")
    assert row["held"] == 2 and row["unheld"] == 1
    assert row["lock"] == "_lock"
    assert any("test_torch_host_utils" in s for s in row["unheld_sites"])


def test_init_writes_are_not_observations():
    locking.enable_lock_witness()
    _Guarded()  # only construction writes
    assert _obs("_Guarded", "_n") is None


def test_rlock_ownership_probed_without_wrapping():
    """Instances that predate enable_lock_witness still witness
    correctly when the guard is an RLock; plain-Lock instances are
    skipped, never misreported."""

    @guarded_by("_lock", "_v")
    class R:
        def __init__(self):
            self._lock = threading.RLock()
            self._v = 0

        def set_locked(self, v):
            with self._lock:
                self._v = v

        def set_racy(self, v):
            self._v = v

    r = R()  # BEFORE enable: no wrapper
    locking.enable_lock_witness()
    r.set_locked(1)
    r.set_racy(2)
    row = _obs("R", "_v")
    assert row["held"] == 1 and row["unheld"] == 1

    g = _Guarded()  # plain Lock, but constructed after enable: wrapped
    g.bump_locked_path()
    assert _obs("_Guarded", "_n")["held"] == 1


def test_plain_lock_created_before_enable_is_undecidable():
    g = _Guarded()
    locking.enable_lock_witness()
    g.bump_racy_path()
    assert _obs("_Guarded", "_n") is None


def test_cross_thread_writes_attributed_per_thread():
    locking.enable_lock_witness()
    g = _Guarded()
    threads = [threading.Thread(target=g.bump_locked_path)
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    row = _obs("_Guarded", "_n")
    assert row["held"] == 8 and row["unheld"] == 0


def test_lock_witness_dump_round_trips(tmp_path):
    locking.enable_lock_witness()
    g = _Guarded()
    g.bump_racy_path()
    path = locking.dump_lock_witness(str(tmp_path / "lock.json"))
    data = locking.load_witness_dump(path)
    assert data["observations"] == locking.witness().observations()
    (tmp_path / "other.json").write_text(json.dumps({"kind": "x"}))
    with pytest.raises(ValueError):
        locking.load_witness_dump(str(tmp_path / "other.json"))
