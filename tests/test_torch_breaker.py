"""The port's circuit breaker and the ``gpu`` engine's fault domain against
the JAX package's.

Unit half: the seven state-machine cases of ``tests/test_breaker.py``
(:59-135) on a fake clock, run over both modules' ``CircuitBreaker`` and
compared step for step (states, admissions, trips); the JAX
``yb_engine_degraded`` gauge's case reads ``degraded()`` on both sides
(the port's metrics registry is ROADMAP.md §1 item 16).

Engine half: ``tests/test_breaker.py:186`` and ``:239`` on the ``gpu``
engine (CPU tensors), with the port's ``arm_fault_once
("fault.gpu_dispatch")``: the faulted batch and every batch while the
breaker is open are re-served from the host with the JAX ``cpu``
engine's rows, the breaker opens and closes after its half-open probe,
and no residency pin or device-tracker byte leaks. Then what is not a
device fault: a kernel wrapper that raises a ``TypeError`` or a plain
``RuntimeError`` propagates out of ``scan_batch`` with no host re-serve
(recorded on the breaker, which stays closed under the default
threshold), while one that raises ``torch.cuda.OutOfMemoryError`` is
re-served.
"""

import random
import time

import pytest
import torch

import yugabyte_db_tpu.storage as J
import yugabyte_db_tpu.storage.breaker as j_breaker
import yugabyte_db_tpu_torch.storage as T
import yugabyte_db_tpu_torch.storage.breaker as t_breaker
from test_torch_data import JAX, PORT, jax_rows, make_schema
from yugabyte_db_tpu_torch.ops import row_gather
from yugabyte_db_tpu_torch.storage.residency import hbm_cache
from yugabyte_db_tpu_torch.utils.fault_injection import (FaultInjected,
                                                         arm_fault_once,
                                                         clear_faults)


class FakeClock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now

    def advance(self, dt):
        self.now += dt


def make_breaker(B, threshold=3, cooldown=1.0):
    clock = FakeClock()
    return B.CircuitBreaker("test", failure_threshold=threshold,
                            cooldown_s=cooldown, clock=clock), clock


def snap(B, b, log, *extra):
    log.append((b.state, b.trips, b.consecutive_failures, b.is_degraded,
                b in B.degraded(), *extra))


# Each case drives one breaker module ``B`` and returns its trace.
def case_stays_closed_below_threshold(B):
    b, _ = make_breaker(B, threshold=3)
    log = []
    for _ in range(2):
        snap(B, b, log, b.allow())
        b.record_failure(RuntimeError("x"))
    snap(B, b, log, b.allow())
    assert b.state == B.CLOSED and not b.is_degraded
    return log


def case_success_resets_failure_streak(B):
    b, _ = make_breaker(B, threshold=3)
    log = []
    for step in ("f", "f", "s", "f", "f"):
        (b.record_failure(RuntimeError("x")) if step == "f"
         else b.record_success())
        snap(B, b, log)
    assert b.state == B.CLOSED  # the streak broke; never 3 in a row
    return log


def case_trips_open_and_blocks_until_cooldown(B):
    b, clock = make_breaker(B, threshold=2, cooldown=5.0)
    log = []
    b.record_failure(RuntimeError("a"))
    b.record_failure(RuntimeError("b"))
    snap(B, b, log, b.allow())
    clock.advance(4.9)
    snap(B, b, log, b.allow())
    clock.advance(0.2)
    snap(B, b, log, b.allow())  # cooldown elapsed: half-open, the probe
    assert b.state == B.HALF_OPEN and b.trips == 1
    return log


def case_half_open_admits_exactly_one_probe(B):
    b, clock = make_breaker(B, threshold=1, cooldown=1.0)
    log = []
    b.record_failure(RuntimeError("x"))
    clock.advance(1.5)
    snap(B, b, log, b.allow(), b.allow(), b.allow())  # probe, then no
    b.record_success()
    snap(B, b, log, b.allow())
    assert b.state == B.CLOSED
    return log


def case_failed_probe_reopens_with_fresh_cooldown(B):
    b, clock = make_breaker(B, threshold=1, cooldown=2.0)
    log = []
    b.record_failure(RuntimeError("x"))
    clock.advance(2.5)
    snap(B, b, log, b.allow())
    b.record_failure(RuntimeError("probe died"))
    snap(B, b, log, b.allow())  # a fresh cooldown from the probe failure
    clock.advance(1.9)
    snap(B, b, log, b.allow())
    clock.advance(0.2)
    snap(B, b, log, b.allow())
    assert b.trips == 2
    return log


def case_trip_opens_immediately_and_reset_closes(B):
    b, _ = make_breaker(B, threshold=5)
    exc = RuntimeError("native module gone")
    b.trip(exc)
    log = []
    report = B.health_report()
    snap(B, b, log, b.last_error is exc, report["status"],
         any(d["breaker"] == "test" for d in report["degraded"]))
    b.reset()
    snap(B, b, log)
    assert b.state == B.CLOSED and b not in B.degraded()
    return log


def case_degraded_counts_open_breakers(B):
    base = len(B.degraded())
    b, clock = make_breaker(B, threshold=1, cooldown=1.0)
    log = []
    b.record_failure(RuntimeError("x"))
    snap(B, b, log, len(B.degraded()) - base)
    clock.advance(1.5)
    # HALF_OPEN still counts as degraded: only a successful probe clears.
    snap(B, b, log, b.allow(), len(B.degraded()) - base)
    b.record_success()
    snap(B, b, log, len(B.degraded()) - base)
    return log


CASES = [case_stays_closed_below_threshold,
         case_success_resets_failure_streak,
         case_trips_open_and_blocks_until_cooldown,
         case_half_open_admits_exactly_one_probe,
         case_failed_probe_reopens_with_fresh_cooldown,
         case_trip_opens_immediately_and_reset_closes,
         case_degraded_counts_open_breakers]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_breaker_matches_jax_step_for_step(case):
    assert t_breaker.CLOSED == j_breaker.CLOSED
    assert t_breaker.OPEN == j_breaker.OPEN
    assert t_breaker.HALF_OPEN == j_breaker.HALF_OPEN
    assert case(t_breaker) == case(j_breaker)


def test_what_is_a_device_fault():
    """The port's narrowing of the JAX tuple ``(FaultInjected,
    RuntimeError)``: an injected fault and exhausted device memory only.
    The CUDA runtime's errors are how a faulty kernel shows up, so they
    propagate like any other bug."""
    fault = t_breaker.is_device_fault
    assert fault(FaultInjected("x"))
    assert fault(torch.cuda.OutOfMemoryError("CUDA out of memory."))
    assert not fault(RuntimeError("CUDA error: an illegal memory access "
                                  "was encountered"))
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None:
        assert not fault(accel("CUDA error: misaligned address"))
    assert not fault(RuntimeError("shape mismatch"))
    assert not fault(RuntimeError("nvcc not found: the CUDA kernels are "
                                  "built with the CUDA toolkit"))
    assert not fault(OSError("cannot open shared object file"))
    assert not fault(TypeError("bad argument"))
    assert not fault(ValueError("x"))


# -- engine integration ------------------------------------------------------

def load(schema, engines, n=120, seed=11):
    """``tests/test_breaker.py``'s ``_load``: random rows of two hash
    values and 53 range values (overwrites included), applied to every
    engine of ``engines`` as (engine, package side)."""
    rnd = random.Random(seed)
    cids = {c.name: c.col_id for c in schema.value_columns}
    RowVersion = PORT.row_version.RowVersion
    rows, ht = [], 0
    for i in range(n):
        ht += rnd.randrange(1, 3)
        k = rnd.choice(["p", "q"])
        key = schema.encode_primary_key(
            {"k": k, "r": i % 53},
            PORT.partition.compute_hash_code(schema,
                                             {"k": rnd.choice(["p", "q"])}))
        rows.append(RowVersion(key, ht=ht, liveness=True, columns={
            cids["a"]: rnd.randrange(-100, 100), cids["b"]: f"v{i}"}))
    for eng, side in engines:
        eng.apply(rows if side is PORT else jax_rows(rows))
    return ht


def engines(opts=None):
    opts = dict(opts or {})
    ps, js = make_schema(PORT, "breaker"), make_schema(JAX, "breaker")
    cpu = J.make_engine("cpu", js, dict(opts))
    gpu = T.make_engine("gpu", ps, dict(opts, rows_per_block=32,
                                        device="cpu"))
    return ps, cpu, gpu


def assert_identical(cpu, gpu, kw):
    a = cpu.scan(J.ScanSpec(**kw))
    b = gpu.scan(T.ScanSpec(**kw))
    assert a.columns == b.columns
    assert a.rows == b.rows
    assert a.resume_key == b.resume_key
    return b


@pytest.fixture
def faults():
    clear_faults()
    yield
    clear_faults()


def test_engine_degrade_and_recover(faults):
    """A device dispatch fault opens the threshold-1 breaker; the faulted
    batch and the batches while it is open are re-served from the host
    with the JAX ``cpu`` engine's rows; after the cooldown the probe
    succeeds and the breaker closes; no pin or device-tracker byte
    leaks."""
    opts = {"breaker_failure_threshold": 1, "breaker_cooldown_s": 0.05}
    ps, cpu, gpu = engines(opts)
    max_ht = load(ps, [(cpu, JAX), (gpu, PORT)])
    cpu.flush()
    gpu.flush()
    kw = dict(read_ht=max_ht + 1, limit=1000)
    agg = dict(read_ht=max_ht + 1, aggregates=[J.AggSpec("count", None),
                                               J.AggSpec("sum", "a")])

    def quiesce():
        gpu._drop_overlay_cache()
        hbm_cache().evict_unpinned()

    assert_identical(cpu, gpu, kw)  # healthy baseline
    quiesce()
    pins0 = hbm_cache().pinned_bytes()
    dev0 = gpu.device_tracker.consumption
    degraded0 = len(t_breaker.degraded())

    arm_fault_once("fault.gpu_dispatch")
    assert_identical(cpu, gpu, kw)
    assert gpu.breaker.state == t_breaker.OPEN
    assert gpu.stats()["host_reserves"] == 1
    assert len(t_breaker.degraded()) == degraded0 + 1
    assert gpu.breaker in t_breaker.degraded()

    # While quarantined, every batch is served from the host.
    assert_identical(cpu, gpu, kw)
    got = gpu.scan(T.ScanSpec(read_ht=agg["read_ht"], aggregates=[
        T.AggSpec("count", None), T.AggSpec("sum", "a")]))
    assert got.rows == cpu.scan(J.ScanSpec(**agg)).rows
    assert gpu.breaker.state == t_breaker.OPEN
    assert gpu.stats()["host_reserves"] == 3

    # The cooldown elapses; the next batch is the probe, and it succeeds.
    time.sleep(0.06)
    assert_identical(cpu, gpu, kw)
    assert gpu.breaker.state == t_breaker.CLOSED
    assert gpu.stats()["breaker"] == {"state": "closed", "trips": 1}
    assert gpu.stats()["host_reserves"] == 3
    assert len(t_breaker.degraded()) == degraded0

    quiesce()
    assert hbm_cache().pinned_bytes() == pins0
    assert gpu.device_tracker.consumption == dev0
    gpu.close()
    assert gpu.device_tracker.consumption == 0


def test_engine_open_breaker_serves_writes_made_during_degrade(faults):
    """Writes applied while the device path is quarantined are read by the
    host re-serve and, after recovery, by the device path."""
    opts = {"breaker_failure_threshold": 1, "breaker_cooldown_s": 0.05}
    ps, cpu, gpu = engines(opts)
    max_ht = load(ps, [(cpu, JAX), (gpu, PORT)], n=40)
    cpu.flush()
    gpu.flush()

    arm_fault_once("fault.gpu_dispatch")
    gpu.scan(T.ScanSpec(read_ht=max_ht + 1, limit=10))
    assert gpu.breaker.state == t_breaker.OPEN

    cids = {c.name: c.col_id for c in ps.value_columns}
    key = ps.encode_primary_key(
        {"k": "zz", "r": 1}, PORT.partition.compute_hash_code(ps, {"k": "zz"}))
    row = PORT.row_version.RowVersion(key, ht=max_ht + 2, liveness=True,
                                      columns={cids["a"]: 777,
                                               cids["b"]: "late"})
    cpu.apply(jax_rows([row]))
    gpu.apply([row])
    kw = dict(read_ht=max_ht + 3, limit=1000)
    assert_identical(cpu, gpu, kw)  # the host re-serve reads the new row
    time.sleep(0.06)
    assert_identical(cpu, gpu, kw)  # the probe succeeds: the device again
    assert gpu.breaker.state == t_breaker.CLOSED
    gpu.close()


@pytest.mark.parametrize("exc", [TypeError("bad argument"),
                                 RuntimeError("shape mismatch")],
                         ids=["TypeError", "RuntimeError"])
def test_a_bug_is_not_a_device_fault(exc, monkeypatch, faults):
    """A kernel wrapper that raises a bug's exception: it propagates out
    of ``scan_batch``, no host re-serve answers the batch, the pins are
    let go, and the breaker records it (as the JAX engine does) but stays
    closed under the default threshold."""
    ps, cpu, gpu = engines()
    max_ht = load(ps, [(cpu, JAX), (gpu, PORT)])
    gpu.flush()
    kw = dict(read_ht=max_ht + 1, limit=1000)
    gpu.scan(T.ScanSpec(**kw))
    pins0 = hbm_cache().pinned_bytes()

    def broken(*_a, **_k):
        raise exc

    monkeypatch.setattr(row_gather, "gather_rows", broken)
    with pytest.raises(type(exc), match=str(exc)):
        gpu.scan_batch([T.ScanSpec(**kw)])
    st = gpu.stats()
    assert st["host_reserves"] == 0
    assert st["breaker"] == {"state": "closed", "trips": 0}
    assert gpu.breaker.consecutive_failures == 1
    assert hbm_cache().pinned_bytes() == pins0
    monkeypatch.undo()
    cpu.flush()
    assert_identical(cpu, gpu, kw)
    assert gpu.breaker.consecutive_failures == 0
    gpu.close()


def test_a_bug_in_a_probes_finish_retires_the_probe(monkeypatch, faults):
    """The half-open probe's batch raises a bug's exception while it
    finishes (K9's candidate scan, which the several-source row scan
    launches in ``finish``): it propagates, the breaker records it and
    goes back to OPEN rather than staying HALF_OPEN with its probe slot
    taken, and the next probe after the cooldown closes it."""
    opts = {"breaker_failure_threshold": 1, "breaker_cooldown_s": 0.05}
    ps, cpu, gpu = engines(opts)
    max_ht = load(ps, [(cpu, JAX), (gpu, PORT)])
    cpu.flush()
    gpu.flush()
    cids = {c.name: c.col_id for c in ps.value_columns}
    key = ps.encode_primary_key(
        {"k": "zz", "r": 1}, PORT.partition.compute_hash_code(ps, {"k": "zz"}))
    row = PORT.row_version.RowVersion(key, ht=max_ht + 1, liveness=True,
                                      columns={cids["a"]: 5,
                                               cids["b"]: "mem"})
    cpu.apply(jax_rows([row]))
    gpu.apply([row])  # a live memtable: the scan reads several sources
    kw = dict(read_ht=max_ht + 2, limit=1000)
    assert_identical(cpu, gpu, kw)

    arm_fault_once("fault.gpu_dispatch")
    assert_identical(cpu, gpu, kw)  # re-served from the host
    assert gpu.breaker.state == t_breaker.OPEN
    pins0 = hbm_cache().pinned_bytes()

    def broken(*_a, **_k):
        raise RuntimeError("shape mismatch")

    monkeypatch.setattr(row_gather, "scan_candidates", broken)
    time.sleep(0.06)
    batch = gpu.scan_batch_async([T.ScanSpec(**kw)])
    assert isinstance(batch, T.gpu_engine._AsyncBatch)  # the probe launched
    with pytest.raises(RuntimeError, match="shape mismatch"):
        batch.finish()
    assert gpu.breaker.state == t_breaker.OPEN
    assert gpu.stats()["breaker"]["trips"] == 2
    assert gpu.stats()["host_reserves"] == 1
    assert hbm_cache().pinned_bytes() == pins0
    monkeypatch.undo()
    time.sleep(0.06)
    assert_identical(cpu, gpu, kw)  # the next probe succeeds
    assert gpu.breaker.state == t_breaker.CLOSED
    assert gpu.stats()["host_reserves"] == 1
    gpu.close()


def test_device_memory_exhausted_is_re_served(monkeypatch, faults):
    """A kernel wrapper that raises ``torch.cuda.OutOfMemoryError`` (the
    device's own error) is a device fault: the batch is re-served from
    the host with the JAX ``cpu`` engine's rows and the threshold-1
    breaker opens."""
    ps, cpu, gpu = engines({"breaker_failure_threshold": 1,
                            "breaker_cooldown_s": 60.0})
    max_ht = load(ps, [(cpu, JAX), (gpu, PORT)])
    cpu.flush()
    gpu.flush()

    def exhausted(*_a, **_k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory.")

    monkeypatch.setattr(row_gather, "gather_rows", exhausted)
    kw = dict(read_ht=max_ht + 1, limit=1000)
    assert_identical(cpu, gpu, kw)
    assert gpu.stats()["host_reserves"] == 1
    assert gpu.breaker.state == t_breaker.OPEN
    gpu.close()


def test_breaker_flags_are_the_engines_defaults():
    """The flags ``gpu_breaker_failure_threshold`` / ``gpu_breaker_cooldown_s``
    (JAX ``tpu_breaker_*``) configure an engine built after they are set;
    the engine options override them."""
    from yugabyte_db_tpu_torch.utils.flags import FLAGS as TF

    old = (TF.get("gpu_breaker_failure_threshold"),
           TF.get("gpu_breaker_cooldown_s"))
    try:
        TF.set("gpu_breaker_failure_threshold", 1)
        TF.set("gpu_breaker_cooldown_s", 0.25)
        _ps, _cpu, gpu = engines()
        assert (gpu.breaker.failure_threshold, gpu.breaker.cooldown_s) == \
            (1, 0.25)
        _ps, _cpu, gpu2 = engines({"breaker_failure_threshold": 4,
                                   "breaker_cooldown_s": 2.0})
        assert (gpu2.breaker.failure_threshold, gpu2.breaker.cooldown_s) \
            == (4, 2.0)
        gpu.close()
        gpu2.close()
    finally:
        TF.set("gpu_breaker_failure_threshold", old[0])
        TF.set("gpu_breaker_cooldown_s", old[1])


def test_fault_probability_draws_match_jax():
    """``maybe_fault``'s probability route: the same ``fault.seed`` and
    probability draw the same fires as the JAX ``maybe_fault`` (the port's
    flag is ``fault.gpu_dispatch``, the JAX one ``fault.tpu_dispatch``);
    probability 0 never fires, and an armed fault fires once."""
    from yugabyte_db_tpu.utils import fault_injection as jf
    from yugabyte_db_tpu.utils.flags import FLAGS as JF
    from yugabyte_db_tpu_torch.utils import fault_injection as tf
    from yugabyte_db_tpu_torch.utils.flags import FLAGS as TF

    old = (JF.get("fault.seed"), JF.get("fault.tpu_dispatch"),
           TF.get("fault.seed"), TF.get("fault.gpu_dispatch"))
    # The draws' state is module-wide: put it back for the other tests.
    rngs = [(m, m._rng.getstate(), m._applied_seed) for m in (jf, tf)]
    try:
        for seed in (7, 11):
            JF.set("fault.seed", seed, force=True)
            TF.set("fault.seed", seed)
            JF.set("fault.tpu_dispatch", 0.4, force=True)
            TF.set("fault.gpu_dispatch", 0.4)
            want = [jf.maybe_fault("fault.tpu_dispatch") for _ in range(64)]
            got = [tf.maybe_fault("fault.gpu_dispatch") for _ in range(64)]
            assert got == want and 0 < sum(got) < 64
        TF.set("fault.gpu_dispatch", 0.0)
        assert not any(tf.maybe_fault("fault.gpu_dispatch")
                       for _ in range(32))
        tf.arm_fault_once("fault.gpu_dispatch")
        assert tf.maybe_fault("fault.gpu_dispatch")
        assert not tf.maybe_fault("fault.gpu_dispatch")
        assert not tf.maybe_fault("fault.unknown")
    finally:
        JF.set("fault.seed", old[0], force=True)
        JF.set("fault.tpu_dispatch", old[1], force=True)
        TF.set("fault.seed", old[2])
        TF.set("fault.gpu_dispatch", old[3])
        tf.clear_faults()
        for m, state, applied in rngs:
            m._rng.setstate(state)
            m._applied_seed = applied
