#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Drives the port (``yugabyte_db_tpu_torch``) and only the port, from the
root of a checkout, in phases; any failure exits non-zero before the last
line is printed:

1. build: prints the card (``nvidia-smi`` name and power limit) and
   compiles every CUDA kernel of the main path from ``csrc/``;
2. kernel: 16,777,216 rows at R = 2048 of flat-run planes made from a
   numpy seed (~5% tombstones, NULLs, unset values, expired TTLs, invalid
   rows), resident on the card; for each signature (COUNT, i32/i64
   SUM/MIN/MAX, every predicate op on i32 and i64, a bounded row range, a
   mid-history read point, a 32-spec batch) the kernel must equal its
   plain PyTorch version exactly; prints times (CUDA events, median of
   12 launches), the bandwidth bound and the launch count;
3. engine: ``make_engine("gpu")`` on the bench table at 1,000,000 keys,
   apply -> flush, the headline aggregate alone and as depth-pipelined
   ``scan_batch_async`` batches of 32 specs; every result must equal an
   exact Python-integer oracle over the generated rows, and the kernel's
   launch count must have advanced during that run; then the kernel is
   timed and held against its plain version at the engine's shapes;
4. one JSON line listing every kernel of the path, then as the last line
   ``{"ok": true, "device": {...}}``.

Exits 2 without a result when no CUDA device is visible.
"""

from __future__ import annotations

import bisect
import collections
import json
import statistics
import subprocess
import sys
import time

import numpy as np

KERNEL_ROWS = 16 * 1024 * 1024
KERNEL_R = 2048
ENGINE_KEYS = 1_000_000
BATCH = 32
DEPTH = 6
N_BATCHES = 12
KERNEL_REPS = 12
PLAIN_REPS = 3

# Device-memory bandwidth by card (NVIDIA data sheets), bytes/s; and the
# table's CUDA-core (non-tensor) rate the integer work is held against.
_BANDWIDTH = (("H200", 4.8e12), ("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12),
              ("H100", 3.35e12))
_CORE_OPS_PER_S = 67e12


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip smoke check failed: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bandwidth(name: str) -> float:
    for key, rate in _BANDWIDTH:
        if key in name:
            return rate
    raise RuntimeError(f"no memory bandwidth on record for {name!r}")


def cuda_ms(fn, reps: int, queue_ahead: bool = False) -> float:
    """Median device time of ``fn`` over ``reps`` calls, each between its
    own pair of CUDA events (two warm-up calls first). ``queue_ahead``
    parks the stream behind a sleeping kernel while the calls are
    enqueued, so that the host's launch overhead stays out of the device
    time (only for functions that do not synchronise)."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    if queue_ahead:
        torch.cuda._sleep(50_000_000)  # ~25 ms of clock cycles
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def covered_rows(params: np.ndarray, n_rows: int) -> int:
    """Rows in the union of the specs' [row_lo, row_hi) ranges."""
    cover = np.zeros(n_rows + 1, np.int64)
    for lo, hi in params[:, :2].tolist():
        lo, hi = max(0, lo), min(n_rows, hi)
        if lo < hi:
            cover[lo] += 1
            cover[hi] -= 1
    return int((np.cumsum(cover)[:n_rows] > 0).sum())


def ops_per_row(plan) -> int:
    """Integer operations per row and spec: visibility, expiry and
    existence, one compare chain per predicate, the aggregate updates."""
    per_agg = {"count": 1, "sum": 10, "min": 3, "max": 3}
    return (10 + 3 * len(plan.col_ids) + 3 * len(plan.preds)
            + sum(per_agg[a.fn] for a in plan.aggs))


def measure(plan, table, params_np, device, bw: float) -> dict:
    """Kernel vs plain version on the same inputs: exact comparison of the
    folded partial rows, times, and the bound."""
    import torch

    from yugabyte_db_tpu_torch.ops import flat_agg

    params = torch.from_numpy(params_np).to(device)
    launches0 = flat_agg.flat_aggregate.launches
    got = flat_agg.fold_partials(
        plan, flat_agg.flat_aggregate(plan, table, params))
    want = flat_agg.fold_partials(
        plan, flat_agg.flat_aggregate_plain(plan, table, params))
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    check(torch.equal(got, want), f"kernel != plain version (max |diff| "
                                  f"{err}) for {plan.aggs} {plan.preds}")
    ms = cuda_ms(lambda: flat_agg.flat_aggregate(plan, table, params),
                 KERNEL_REPS, queue_ahead=True)
    plain_ms = cuda_ms(
        lambda: flat_agg.flat_aggregate_plain(plan, table, params),
        PLAIN_REPS)
    launches = flat_agg.flat_aggregate.launches - launches0
    rows = covered_rows(params_np, table[0].numel())
    # Inputs read once (the planes of the rows in range, the parameter
    # rows), the folded [N, S] int64 result written once.
    nbytes = (rows * plan.bytes_per_row(table) + params_np.nbytes
              + params_np.shape[0] * plan.n_out * 8)
    ops = params_np.shape[0] * rows * ops_per_row(plan)
    bytes_ms = nbytes / bw * 1e3
    ops_ms = ops / _CORE_OPS_PER_S * 1e3
    return {"specs": params_np.shape[0], "rows": rows,
            "bytes_per_row": plan.bytes_per_row(table), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "max_abs_err": err, "launches": launches,
            "count": int(got[0, 0]),
            "scanned": int(got[0, 1])}


# -- phase 2: the kernel at 16M rows ---------------------------------------

def kernel_planes(n_rows: int, R: int, seed: int = 11):
    """Flat-run planes in the DeviceRun.arrays layout, and read points.
    Columns: 1 = a (INT64, two order planes), 2 = d (INT32)."""
    from yugabyte_db_tpu_torch.storage.row_version import MAX_HT
    from yugabyte_db_tpu_torch.utils import planes as P

    rng = np.random.default_rng(seed)
    B = n_rows // R
    ht = ((10**15 + rng.integers(0, 10**7, n_rows)) << 12).astype(np.int64)
    valid = rng.random(n_rows) > 0.002
    tomb = valid & (rng.random(n_rows) < 0.05)
    # Rows with no liveness exist only through a set, non-NULL column.
    live = valid & ~tomb & (rng.random(n_rows) < 0.95)
    has_ttl = ~tomb & (rng.random(n_rows) < 0.03)
    exp = np.full(n_rows, MAX_HT, np.int64)
    exp[has_ttl] = ht[has_ttl] + (rng.integers(1, 10**7, has_ttl.sum())
                                  << 12)

    def shaped(x, *extra):
        return np.ascontiguousarray(x.reshape((B, R) + extra))

    def column(values_hi, values_lo, p_set, p_null):
        set_ = valid & ~tomb & (rng.random(n_rows) < p_set)
        isnull = set_ & (rng.random(n_rows) < p_null)
        keep = set_ & ~isnull
        planes = [np.where(keep, values_hi, 0).astype(np.int32)]
        if values_lo is not None:
            planes.append(np.where(keep, values_lo, 0).astype(np.int32))
        return {"set": shaped(set_), "isnull": shaped(isnull),
                "cmp": shaped(np.stack(planes, axis=-1), len(planes))}

    a_hi, a_lo = P.i64_to_ordered_planes(
        rng.integers(-10**12, 10**12, n_rows, dtype=np.int64))
    d = rng.integers(-10**6, 10**6, n_rows, dtype=np.int32)
    ht_hi, ht_lo = P.ht_to_planes(ht)
    exp_hi, exp_lo = P.ht_to_planes(exp)
    planes = {
        "valid": shaped(valid), "group_start": shaped(np.ones(n_rows, bool)),
        "tomb": shaped(tomb), "live": shaped(live),
        "ht_hi": shaped(ht_hi), "ht_lo": shaped(ht_lo),
        "exp_hi": shaped(exp_hi), "exp_lo": shaped(exp_lo),
        "cols": {1: column(a_hi, a_lo, 0.99, 0.02),
                 2: column(d, None, 0.97, 0.03)},
    }
    read_all = int(ht.max()) + 1
    read_mid = int(np.median(ht))
    return planes, read_all, read_mid


def kernel_signatures(planes, read_all: int, read_mid: int, n_rows: int):
    """(label, aggs, preds, [N, P] params) per signature."""
    from yugabyte_db_tpu_torch.ops import flat_agg
    from yugabyte_db_tpu_torch.ops.scan import AggSig, PredSig
    from yugabyte_db_tpu_torch.storage.row_version import MAX_HT
    from yugabyte_db_tpu_torch.utils import planes as P

    A, D = 1, 2
    cnt = AggSig("count", None, None)
    headline = (cnt, AggSig("sum", A, "i64"), AggSig("min", A, "i64"),
                AggSig("max", A, "i64"), AggSig("sum", D, "i32"))
    # Literals that hit a stored value, so '=' matches rows.
    a_cmp = planes["cols"][A]["cmp"].reshape(-1, 2)
    d_cmp = planes["cols"][D]["cmp"].reshape(-1)
    ok = (planes["cols"][A]["set"] & ~planes["cols"][A]["isnull"]
          & planes["cols"][D]["set"] & ~planes["cols"][D]["isnull"])
    hit = int(np.flatnonzero(ok.reshape(-1))[777])
    a_lit = (int(a_cmp[hit, 0]), int(a_cmp[hit, 1]))
    d_lit = int(d_cmp[hit])

    def reads(read_ht):
        r = P.scalar_ht_planes(min(read_ht, MAX_HT))
        e = P.scalar_ht_planes(min(read_ht, MAX_HT - 1))
        return (*r, *e)

    def params(plan, rows):
        return np.array([plan.param_row(lo, hi, reads(rd), lits)
                         for lo, hi, rd, lits in rows], np.int32)

    sigs = [
        ("count", (cnt, AggSig("count", A, "i64"), AggSig("count", D, "i32")),
         (), [(0, n_rows, read_all, ())]),
        ("i32_sum_min_max", (cnt, AggSig("sum", D, "i32"),
                             AggSig("min", D, "i32"),
                             AggSig("max", D, "i32")),
         (), [(0, n_rows, read_all, ())]),
        ("i64_sum_min_max", (cnt, AggSig("sum", A, "i64"),
                             AggSig("min", A, "i64"),
                             AggSig("max", A, "i64")),
         (), [(0, n_rows, read_all, ())]),
    ]
    for op in ("=", "!=", "<", "<=", ">", ">="):
        sigs.append((f"pred_i32_{op}", headline, (PredSig(D, "i32", op),),
                     [(0, n_rows, read_all, (np.int32(d_lit),))]))
        sigs.append((f"pred_i64_{op}", headline, (PredSig(A, "i64", op),),
                     [(0, n_rows, read_all, (np.array(a_lit, np.int32),))]))
    ge = (PredSig(D, "i32", ">="),)
    lo_lit = (np.int32(-500_000),)
    sigs.append(("headline", headline, ge, [(0, n_rows, read_all, lo_lit)]))
    sigs.append(("bounded_range", headline, ge,
                 [(n_rows // 5, 3 * n_rows // 5, read_all, lo_lit)]))
    sigs.append(("mid_history_read", headline, ge,
                 [(0, n_rows, read_mid, lo_lit)]))
    rng = np.random.default_rng(5)
    batch = []
    for i in range(BATCH):
        lo = int(rng.integers(0, n_rows // 4)) if i % 4 == 1 else 0
        hi = n_rows - int(rng.integers(0, n_rows // 4)) if i % 4 == 2 \
            else n_rows
        rd = read_mid if i % 4 == 3 else read_all
        batch.append((lo, hi, rd, (np.int32(-500_000 - 7 * i),)))
    sigs.append(("batch32", headline, ge, batch))
    out = []
    for label, aggs, preds, rows in sigs:
        plan = flat_agg.make_plan(aggs, preds, (A, D))
        out.append((label, plan, params(plan, rows)))
    return out


def kernel_phase(device, bw: float) -> list[dict]:
    from yugabyte_db_tpu_torch.ops.device_run import DeviceRun

    t0 = time.perf_counter()
    planes, read_all, read_mid = kernel_planes(KERNEL_ROWS, KERNEL_R)
    run = DeviceRun.from_reference_planes(planes, KERNEL_R, device)
    print(f"kernel phase: {KERNEL_ROWS} rows resident, {run.nbytes} bytes "
          f"of planes, made and uploaded in "
          f"{time.perf_counter() - t0:.1f} s")
    out = []
    for label, plan, params in kernel_signatures(planes, read_all, read_mid,
                                                 KERNEL_ROWS):
        table = plan.plane_table(run.arrays)
        row = {"signature": label, **measure(plan, table, params, device,
                                             bw)}
        check(row["scanned"] > 0, f"{label}: no row exists in range")
        out.append(row)
        print("kernel_signature " + json.dumps(row))
    return out


# -- phase 3: the engine at 1M keys -----------------------------------------

class Oracle:
    """Exact answers of the headline spec ``d >= lo`` over the generated
    rows, in Python integers: live rows sorted by d, suffix sums."""

    def __init__(self, schema, rows):
        cid = {c.name: c.col_id for c in schema.columns}
        live = sorted((r.columns[cid["d"]], r.columns[cid["a"]],
                       r.columns[cid["c"]])
                      for r in rows if not r.tombstone)
        self.d = [t[0] for t in live]
        n = len(live)
        self.sum_a = [0] * (n + 1)
        self.sum_d = [0] * (n + 1)
        self.min_a = [None] * (n + 1)
        self.max_a = [None] * (n + 1)
        self.abs_c = [0.0] * (n + 1)
        self.c = [t[2] for t in live]
        for i in range(n - 1, -1, -1):
            d, a, c = live[i]
            self.sum_a[i] = self.sum_a[i + 1] + a
            self.sum_d[i] = self.sum_d[i + 1] + d
            self.min_a[i] = a if self.min_a[i + 1] is None else \
                min(a, self.min_a[i + 1])
            self.max_a[i] = a if self.max_a[i + 1] is None else \
                max(a, self.max_a[i + 1])
            self.abs_c[i] = self.abs_c[i + 1] + abs(c)

    def headline(self, lo: int) -> tuple:
        i = bisect.bisect_left(self.d, lo)
        if i == len(self.d):
            return (0, None, None, None, None)
        return (len(self.d) - i, self.sum_a[i], self.min_a[i], self.max_a[i],
                self.sum_d[i])

    def c_aggs(self, lo: int) -> tuple:
        i = bisect.bisect_left(self.d, lo)
        cs = self.c[i:]
        return sum(cs), min(cs), max(cs), self.abs_c[i]


def engine_phase(device, bw: float) -> dict:
    import torch

    from yugabyte_db_tpu_torch import workload
    from yugabyte_db_tpu_torch.ops import flat_agg
    from yugabyte_db_tpu_torch.storage import AggSpec, Predicate, ScanSpec
    from yugabyte_db_tpu_torch.storage import make_engine

    t0 = time.perf_counter()
    schema = workload.make_schema()
    rows, max_ht = workload.make_rows(schema, ENGINE_KEYS)
    oracle = Oracle(schema, rows)
    gen_s = time.perf_counter() - t0
    eng = make_engine("gpu", schema, {"rows_per_block": 2048,
                                      "device": device})
    t0 = time.perf_counter()
    eng.apply(rows)
    eng.flush()
    load_s = time.perf_counter() - t0
    versions = eng.runs[0].crun.num_versions
    read = max_ht + 1
    print(f"engine phase: {versions} versions generated in {gen_s:.1f} s, "
          f"applied and flushed in {load_s:.1f} s, "
          f"{eng.stats()['device_bytes']} bytes on the card")

    def spec(lo):
        return workload.headline_spec(read, lo)

    # The main path, counted.
    flat_agg.flat_aggregate.launches = 0
    got = eng.scan(spec(-500_000)).rows[0]
    check(got == oracle.headline(-500_000),
          f"headline scan {got} != oracle {oracle.headline(-500_000)}")
    lat = []
    for _ in range(10):
        t = time.perf_counter()
        eng.scan(spec(-500_000))
        lat.append(time.perf_counter() - t)
    batches = [[-500_000 - 7 * (b * BATCH + i) for i in range(BATCH)]
               for b in range(N_BATCHES)]

    def pipeline(bs):
        q = collections.deque()
        for lits in bs:
            q.append((lits, eng.scan_batch_async([spec(lo) for lo in lits])))
            if len(q) > DEPTH:
                done.append(q.popleft())
        done.extend(q)

    done: list = []
    pipeline(batches[:DEPTH + 2])  # warm-up
    for lits, b in done:
        b.finish()
    done = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipeline(batches)
    results = [(lits, b.finish()) for lits, b in done]
    tput_s = time.perf_counter() - t0
    launches = flat_agg.flat_aggregate.launches
    check(launches > 0, "the main path launched the flat_agg kernel 0 times")
    for lits, res in results:
        for lo, r in zip(lits, res):
            check(r.rows[0] == oracle.headline(lo),
                  f"batched scan d >= {lo}: {r.rows[0]} != "
                  f"{oracle.headline(lo)}")

    # The plain-PyTorch flat fold on the card: float aggregates.
    fspec = ScanSpec(read_ht=read, predicates=[Predicate("d", ">=", 0)],
                     aggregates=[AggSpec("sum", "c"), AggSpec("min", "c"),
                                 AggSpec("max", "c")])
    fs, fmin, fmax = eng.scan(fspec).rows[0]
    want_s, want_min, want_max, abs_sum = oracle.c_aggs(0)
    # f32 sums over the arith plane: error within 2^-17 of sum(|c|).
    check(abs(fs - want_s) <= abs_sum * 2.0 ** -17,
          f"sum(c) {fs} vs {want_s}")
    check((fmin, fmax) == (want_min, want_max), "min/max(c)")

    n_scans = BATCH * N_BATCHES
    eng_row = {
        "versions": versions, "load_s": load_s,
        "single_scan_latency_ms": statistics.median(lat) * 1e3,
        "rows_per_s": versions * n_scans / tput_s,
        "scans": n_scans, "batch": BATCH, "depth": DEPTH,
        "launches": launches,
    }
    print("engine " + json.dumps(eng_row))

    # The kernel at the main path's shapes: the engine's run and one
    # batch of its parameter rows, timed and held against the plain
    # version (outside the counted run).
    preps = [eng._plan_scan(spec(lo)) for lo in batches[0]]
    p0 = preps[0]
    plan = flat_agg.make_plan(p0.sig.aggs, p0.sig.preds,
                              tuple(cs.col_id for cs in p0.sig.cols))
    params = np.array([plan.param_row(p.row_lo, p.row_hi, p.read_planes,
                                      p.lits) for p in preps], np.int32)
    table = plan.plane_table(eng.runs[0].dev.arrays)
    eng_row["kernel"] = measure(plan, table, params, device, bw)
    print("engine_kernel " + json.dumps(eng_row["kernel"]))
    return eng_row


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    from yugabyte_db_tpu_torch.ops import native

    device = torch.device("cuda")
    card = nvidia_smi()
    print(card)  # nvidia-smi: name, power limit
    bw = bandwidth(card)
    t0 = time.perf_counter()
    native.build(["flat_agg"])
    print(f"build: flat_agg in {time.perf_counter() - t0:.1f} s")
    for line in native.build_logs.get("flat_agg", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    kernel_rows = kernel_phase(device, bw)
    eng = engine_phase(device, bw)
    k = eng["kernel"]
    err = max([k["max_abs_err"]] + [r["max_abs_err"] for r in kernel_rows])
    print(json.dumps({"kernels": [{
        "name": "flat_agg", "route": "cuda",
        "source": "yugabyte_db_tpu_torch/csrc/flat_agg.cu",
        "replaces": "yugabyte_db_tpu/ops/pallas_agg.py:76",
        "launches": eng["launches"], "max_abs_err": err,
        "max_abs_diff": err, "ms": k["ms"], "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
