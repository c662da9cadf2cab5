#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Drives the port (``yugabyte_db_tpu_torch``) and only the port, from the
root of a checkout, in phases; any failure exits non-zero before the last
line is printed:

1. build: prints the card (``nvidia-smi`` name and power limit) and
   compiles every CUDA kernel of the main path from ``csrc/``, one
   ``nvcc`` each, all at once (``ptxas:`` lines: registers and spills),
   while the tablet phase (run first) generates its rows and writes its
   WAL; every phase after it runs alone, one after another;
1b. tablet (``tablet_phase``): the port's ``Tablet`` on the ``gpu``
   engine at TABLET_KEYS (500,000) keys of the bench table in a
   temporary data directory (fsync on, the default plane encoding): 50
   ``Tablet.write`` batches of 10,000 rows, the device flush (K12) with
   its run saved, 20,000 zipfian updates left in the WAL, ``close()``
   (the device bytes released, no cache entry left), ``Tablet.open``
   (the run loaded from disk, the WAL replayed), the headline 32-spec
   batch, 256 YCSB-E pages in "cql" and "pg" (bytes) and 1,000 point
   reads against an exact oracle, ALTER ADD COLUMN (a counted
   re-upload), a snapshot around 1,000 deletes and its restore, and
   compaction (K11); every launch counted, K12, K7 and K9 held against
   their plain versions (``tablet`` line, ``--tablet`` alone);
1c. raft (``raft_phase``): three ``TabletPeer``s (``node-0..2``) of the
   port over its ``LocalTransport``, each its own ``gpu`` engine in a
   temporary data directory (fsync on, the default ``RaftOptions``), on
   the tablet phase's rows, updates and oracle: a leader elected with a
   lease, 50 writes of 10,000 rows and the 20,000 updates (100 a write)
   through it, retried on ``NotLeader`` as a client does (rows/s, the
   commit latency's p50 and p99), each replica's ``TabletPeer.flush``
   (the device route, its run saved), the headline batch and 256 YCSB-E
   pages in "cql" and "pg" on the leader (lease), the headline batch on
   each follower (stale, once it applied the leader's commit index), the
   leader isolated (ms to a new lease), 1,000 unflushed writes and reads
   (the overlay) through the new leader, the heal (the old leader's
   catch-up and stale read), ``snapshot_for_bootstrap``'s entries
   restored into a fresh engine; every answer equal to the exact oracle,
   the terms and any election besides the deliberate one printed, every
   launch counted, K12, K7 and K9 held against their plain versions
   (``raft`` line, ``--raft`` alone);
2. kernel: 16,777,216 rows at R = 2048 of flat-run planes made from a
   numpy seed (~5% tombstones, NULLs, unset values, expired TTLs, invalid
   rows, values at the i32 and i64 extremes, an all-NULL and a never-set
   column), resident on the card; for each signature (COUNT, i32/i64
   SUM/MIN/MAX, every predicate op on i32 and i64, a bounded row range, a
   mid-history read point, a 32-spec batch) the kernel must equal its
   plain PyTorch version exactly; prints times (CUDA events, median of
   12 launches), the bound and the launch count, and the 32-spec batch
   beside 32 x the single spec's time. Then the edges, checked exactly
   and not timed: row ranges with ends off the tile and vector width
   (empty ones too), more distinct read points than a block masks per
   tile, batches of 33, SPEC_CHUNK + 1 and 512 specs that
   differ in read point, range and literal, literals at the i32/i64
   extremes, all-NULL columns, and a table of MAX_COLS value columns at
   1,048,576 rows;
   Every flush of the phases below goes through ``flush``: it must take
   the device route (``stats()["flush_paths"]``) and launch K12
   (``ops.flush``, ``csrc/flush.cu``), whose launch is held byte for byte
   against its plain version; a ``flush`` line prints its parts (staging,
   sort, upload, K12, readback, the host scatter of keys and objects);
3. engine: ``make_engine("gpu")`` on the bench table at 1,000,000 keys,
   apply -> flush (the device route; the same versions built again by
   the host route must give equal host and device planes, byte for
   byte: ``flush_engine``, both flushes' parts; K12 timed beside its
   plain version and bound: ``flush_kernel``; K12's edges held byte for
   byte: 34 columns in two calls, and ``workload.replay_inputs`` at R =
   100, at a slot count that is not a multiple of 4, at R = 8, and a
   chunk of 32 columns with a 2-word order column), the headline aggregate
   alone and as depth-pipelined
   ``scan_batch_async`` batches of 32 specs; every result must equal an
   exact Python-integer oracle over the generated rows, and the kernel's
   launch count must have advanced during that run; ``torch.profiler``
   over 4 pipelined batches gives the device's busy share, its time by
   kernel and the host's time per batch ("not measured" where the trace
   holds no device event); then the kernel is timed and held against its
   plain version at the engine's shapes;
4. mvcc: the bench table at 1,000,000 keys plus 1,000,000 updates
   (``workload.make_update_rows``: zipfian keys and one field per update
   as YCSB workload A's updates, plus deletes with same-hybrid-time
   writes, TTLs and NULLs for coverage), one multi-version run of ~2M
   versions at R = 2048 with keys past 32 versions. The resolve kernel (``ops.mvcc_resolve``) at
   the newest and a mid-history read point, and on
   ``workload.long_group_planes`` (2,097,152 rows, R = 2048, key groups
   of 1 to 2048 versions): its view must equal its plain version byte for
   byte; times and the bytes bound. Its edges, byte for byte and untimed:
   18 value columns (two launches), R = 48, and groups filling whole
   blocks of 2048 rows. Then the
   engine: one scan, pipelined 32-spec batches at one read point (depth
   6), one batch at 32 distinct read points (six pairs across TTL
   expiries; checked once, with the device memory it takes beyond its
   start held under two views, then timed as the median of 3 calls,
   each resolving its 32 views) and one float spec (the plain flat fold
   over the view);
   every result must equal an exact oracle built on the port's host merge
   (``storage/merge.py``), and both kernels' launch counts must have
   advanced. ``mvcc_trace`` profiles 4 batches that each resolve a view;
   K1 is held against its plain version on the newest view;
5. rows: row scans on one run, reusing the engine and mvcc phases'
   tables (``rows_phase``). YCSB-E batches (``workload.ycsb_e_batch``,
   ``bench.py:179 bench_ycsb_e``'s 256 LIMIT-100 pages from random keys
   under ``d >= -500000``, projecting k, r, a, d) on the flat run (host
   pages, no K7) and on the multi-version run through K7 at the newest
   and a mid read point: 4 batches checked, then 3 pipelined runs of them
   at depth 6 timed (median ms a batch, pages a second, K7's share); a
   full range scan of each run (chunks mode, rows a second); a selective
   paged scan (~1% of the rows, several continuation rounds); pages with
   a string and a float predicate (superset masks the host verifies) on
   a table of 100,000 keys made here, the bench table having neither
   column. Every page's rows, resume key and ``rows_scanned`` equal a host
   oracle built from the run's key groups with ``merge_versions``
   (``RunOracle``, which walks K7's windows to count as the gather
   counts); every K7 launch equals its plain version byte for byte; K7
   timed alone (CUDA events) beside its plain version and its bound;
   then ``rows_edges``: K7 (paged and chunks) and K9 on
   ``workload.row_edge_planes`` at 9 geometries of the cluster design
   (K of 1, 2, 8, 12; R of 48, 64, 100, 2048, 4096; a flat layout),
   every launch byte for byte; both kernels' ptxas reports must show no
   spill and no stack frame;
6. overlay: post-write scans through the delta overlay, on both engines
   above. The flat one takes 4 waves of ``workload.make_wave_rows``
   (20,000 uniform updates of d each, ``bench.py:740
   bench_multisource``'s shape), flushed after the first 3 (4 runs and a
   live memtable); the multi-version one takes a live wave of 20,000
   ``make_update_rows`` updates. Every result (between and after the
   waves, floats of c too) must equal an exact oracle, K1 and the resolve
   must have launched on the masked primaries and no spec may have been
   served by the memtable-only host fold. Prints the first scan, the
   steady scan, throughput, the delta apply after a fifth wave, the K13
   scatter and its bound, K1 and the resolve on the masked planes held
   exactly against their plain versions (and the resolve on the
   long-group planes with 20% of their groups cleared, and byte-exact on
   cleared edges at R = 48, 2048 and 4096), the host fold per miss and
   hit, and an 8-spec batch of new literals traced (host plan, host
   fold, device, finish);
7. rows over several sources (``rows_sources_phase``): the flat engine
   after the overlay phase (4 runs, a live memtable): 64 YCSB-E pages and
   a GROUP BY r over 20,000 keys through the row scan, whose candidates
   K9 gives; each result against a host oracle of every source
   (``SourcesOracle``), every K9 launch byte for byte against its plain
   version, K9 timed alone;
8. compact: compaction with history GC (``compact_phase``). The engine
   phase's rows and 3 waves of 350,000 one-column updates (10% DELETEs,
   ``bench.py:1458 bench_compact``'s shape), each flushed: 4 runs of
   2,050,000 versions, past ``HOST_GC_MASK_MAX``, compacted at the newest
   hybrid time through K11 (``ops.compact``, ``csrc/compact.cu``): its
   launch against its plain version and the numpy twin, the merged
   versions of 4,000 keys against ``gc_versions`` over their history,
   the headline spec at and past the cutoff against ``HistoryOracle``, a
   YCSB-E batch of 256 pages against the merged run's oracle; the
   compaction's parts, K11 timed beside its plain version, the numpy
   twin on the same union and its bound; K11's edges held byte for byte
   against its plain version and the twin (pad rows, 42 columns, a drawn
   union with a group of 5,000 versions whose kept span of equal hybrid
   time crosses a tile edge, 256 columns); K11's and K12's ptxas reports
   must show no spill and no stack frame. Then the flat engine of the
   overlay phase (after 7): its memtable flushed, its 5 runs compacted
   at the newest hybrid time (the numpy twin's route), and 64 YCSB-E
   pages against every source's history (``SourcesOracle``), on a route
   that is no longer the row scan over several sources;
9. full: the windowed fold K5 (``ops.full_agg``, ``csrc/full_agg.cu``)
   past the flat fold's bounds. ``workload.flat_planes`` at 16,896
   blocks of R = 2048 (34,603,008 rows: two i32, an i64, an f32, an f64
   and a never-set column; made from a seed in numpy and uploaded,
   seconds printed): COUNT(*), f64 and f32 SUM/MIN/MAX, an f64 range
   predicate, 9 aggregates, a bounded range starting mid-window, a
   mid-history read point and a 32-spec batch, each held against the
   plain version (ivec exactly, float sums within 1e-5 x the sum of |x|,
   f32 extremes exactly) and timed beside its bound
   (``full_signature``); the launch shape the library reports must equal
   ``full_agg.launch_geometry``. Edges, exact and untimed: an empty range
   and a first window past 0; a batch of one spec chunk + 1 (65) specs
   at 12 read points (more than a chunk stages), each with a range and a
   literal of its own; 4 specs over disjoint window ranges; 18 value
   columns at 1,048,576 rows, alone and with every SUM, MIN, MAX and
   COUNT of 5 columns (several aggregates a pass, 5 passes); R = 64
   planes of 524,288 rows (several windows a block); R = 33 planes of
   540,672 rows (windows of 264 rows: plain loads, not the asynchronous
   copy); and the view of the mvcc phase's run at its newest read
   point. Then the
   engine: the bench table at 1,100,000 keys and ``rows_per_block`` 64
   (17,188 blocks), a float and an f64-predicate aggregate alone and in
   a 32-spec batch on route ``full`` (``stats()["agg_routes"]``), equal
   to an exact oracle; the batch traced twice (``full_trace``: the
   device's busy share, K5's device time and the host's time a batch);
   1,000 rows written to the memtable, the overlay's
   masked primary on the same route, equal to the history's oracle. K5's
   launches are counted over that run; K5 is held and timed at the
   engine's batch (``full_engine_kernel``); K5's ptxas report must show
   no spill and no stack frame;
10. residency: the residency budget and the fault domain
   (``residency_phase``) on the flat table (compacted, encoded, read at
   the fifth wave's read point) and the multi-version one (one encoded run
   of every version, read at the newest and a mid read point). The
   budget (``gpu_hbm_budget_bytes``) is 1.25 x the larger run's entry
   (payload, K10's side-car, a view), so 4 rounds of the headline 32-spec
   batch and of a 32-spec mvcc batch at two read points evict each
   other's run: every result against the earlier phases' oracles, each
   miss's upload timed beside a pinned host-to-device copy of the same
   bytes, each re-read run's side-car rebuilt by one K10 launch (held byte
   for byte against its plain version once); then both runs resident and
   evicted, ``torch.cuda.memory_allocated()`` against the allocator's
   blocks of the bytes the cache released (exact) and every evicted
   tensor freed. Then faults on a range of 20,000 keys of the flat table: an
   armed ``fault.gpu_dispatch`` and one real ``torch.cuda.OutOfMemoryError``
   (K1's wrapper wrapped here to allocate past the free device memory);
   each faulted batch re-served on the host equal to the oracle, the
   breaker (threshold 1, from the flag the smoke sets before it builds
   an engine) open, then closed by the probe, no pin leaked.
   Every other phase must end with no host re-serve and every breaker
   closed and never tripped;
11. grouped: TPC-H lineitem at SF1 / 4 (1,500,303 rows of
   ``workload.generate_lineitem``) applied and flushed into one flat run
   (generation and load seconds printed). Q1 and Q6 through the engine
   must equal numpy oracles exactly; the single-scan latency (median of
   5), ``bench.py:1003 bench_tpch``'s 10 pipelined batches of 8 Q1 specs
   at depth 4 (rows/s) and one traced batch; K8 held byte for byte
   against its plain version and timed (``k8_cases``: Q1 alone, 8 copies
   of one Q1 spec, 8 Q1 specs at distinct cut-offs and read points, Q1
   grouped by tax and return flag past a block's slots, Q6) beside its
   bound; no Q1/Q6 spec may be re-served on the host. Then
   250,000 rows and 250,000 zipfian one-field updates in one
   multi-version run: Q1 exact at the newest and a mid read point
   through the resolve and K8. Then K8's edges at 20,000 rows, each
   result against the port's host oracle and each launch against the
   plain version: NULL group values, a group column of more than 512
   values (a collision, re-served on the host), negative bases (the
   same), COUNT(col), an empty range, and 8 specs of distinct literals
   and read points in one launch; then ``group_enc_edges``: K8's encoded
   build over lineitem edge tables whose leaves take every kind in every
   staged role (bits flags; const, delta16 of one and two planes and rle
   predicate, group and sum columns; dictionaries as predicate, group
   column and promoted code predicate; delta16 hybrid times) at R = 64,
   96 and 2048, a dictionary past the shared cap (read through the
   read-only cache, as the launch reports) and a delta16 leaf whose
   offsets are not 16-byte aligned (loaded, not copied); every K8
   launch's reported shape must equal ``group_agg.launch_geometry``;
12. ``phases_s`` (each phase's wall seconds), one JSON line listing every
   kernel of the path, then as the last line
   ``{"ok": true, "device": {...}}``.

Exits 2 without a result when no CUDA device is visible.

``python3 chip_smoke.py --full-ab OTHER.cu[,...]`` times this tree's K5
against other sources of it in turns on one card, on every
``full_signature`` and on the engine's 16-spec launch (``full_ab``
lines), each call held against the plain version; a source whose C
interface differs is called through the wrapper saved beside it as
``OTHER.py``. K5's first design (commit 4fa9bb3): ``git show
4fa9bb3:yugabyte_db_tpu_torch/csrc/full_agg.cu > build/ab/full_first.cu``
and ``git show 4fa9bb3:yugabyte_db_tpu_torch/ops/full_agg.py >
build/ab/full_first.py``.
``python3 chip_smoke.py --resolve-ab OTHER.cu[,OTHER2.cu...]`` builds the
kernels, then times this tree's resolve kernel against each other source
of it (the same C interface) in turns on one card, on the mvcc run and
the long-group planes (also with 20% of their groups cleared), each held
byte for byte against the plain version (``resolve_ab`` lines), and
exits. ``--group-enc-ab OTHER.cu[,...]`` times this tree's K8 against
other sources of it in turns on one card (``group_enc_ab`` lines): every
``k8_cases`` case on the flushed lineitem (dictionary leaves: the
encoded build), Q1, Q6 and a promoted Q1 on it compacted (every leaf
kind), each beside the same planes uploaded plain (the plain build), and
Q1 on a multi-version lineitem's view; ``--decode-ab OTHER.cu[,...]``
does the same for K10 on the compact phase's merged run and the
compacted lineitem (``decode_ab`` lines). Each call is held byte for
byte against the plain version; a source whose C interface differs is
called through the wrapper saved beside it as ``OTHER.py``: the first
encoded design's sources are ``git show
3550883:yugabyte_db_tpu_torch/csrc/group_agg.cu >
build/ab/group_agg_enc_first.cu`` with ``ops/group_agg.py`` as
``build/ab/group_agg_enc_first.py``, and ``csrc/decode.cu`` /
``ops/decode.py`` as ``build/ab/decode_first.cu`` / ``.py``. ``--rows``
builds the kernels, makes the flat and
multi-version tables, runs the rows phase, applies the overlay phase's
waves and runs the rows phase over several sources, and exits.
``--compact`` builds the kernels, makes the engine phase's table (its
flush held against the host build, K12 timed), applies the overlay
phase's waves to it as there, runs the compact phase, prints the K12
and K11 entries of the kernels line, and exits.
``--residency`` builds the kernels, makes the engine phase's flat table
and the mvcc phase's multi-version one, compacts each into one encoded
run, runs the residency phase and exits.
``--full`` builds the kernels, makes a multi-version table of 200,000
keys and 200,000 updates (for the view edge), runs the full phase,
prints the K5 entry of the kernels line, and exits.
``--rows-ab OTHER.cu[,...]`` times this tree's K7 and K9 against other
sources of them (the same C interface) in turns on one card, on the
engine's own launches (``rows_ab`` lines), each held byte for byte;
PR 9's source: ``git show
37f133e:yugabyte_db_tpu_torch/csrc/row_gather.cu >
build/row_gather_pr9.cu``.
``--flush-ab OTHER.cu[,...]`` times this tree's K12 against other sources
of it in turns on one card, on the engine phase's flush and on its
columns repeated to 34 (``flush_ab`` lines), each call held byte for
byte; a source whose C interface differs is called through the wrapper
saved beside it as ``OTHER.py``. The first design's: ``git show
51fb244:yugabyte_db_tpu_torch/csrc/flush.cu > build/ab/flush_first.cu``
and ``git show 51fb244:yugabyte_db_tpu_torch/ops/flush.py >
build/ab/flush_first.py``. ``--compact-ab OTHER.cu[,...]`` does the same
for K11 on the compact phase's union and on it at 42 columns
(``compact_ab`` lines); the first design's: ``git show
51fb244:yugabyte_db_tpu_torch/csrc/compact.cu > build/ab/compact_first.cu``.
``--run-io`` builds no kernel: on the card's host it times a run file of
the bench table's TABLET_KEYS rows (one version each, as the tablet's
flush saves them) written and read by the codec's record functions
(``codec.encode_run`` / ``decode_run``) against the generic codec over
the record lists (``codec.encode`` / ``decode`` and the RowVersion
constructor, the JAX module's way), each in turns, the bytes and the
versions equal (``run_io`` line), and exits.
"""

from __future__ import annotations

import bisect
import collections
import json
import random
import statistics
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np

KERNEL_ROWS = 16 * 1024 * 1024
KERNEL_R = 2048
ENGINE_KEYS = 1_000_000
BATCH = 32
DEPTH = 6
N_BATCHES = 12
KERNEL_REPS = 12
PLAIN_REPS = 1  # timed calls of a plain version (3 until PR 15)

TRACE_BATCHES = 4
# The CUDA kernels of the main path.
KERNELS = ("flat_agg", "mvcc_resolve", "group_agg", "row_gather", "compact",
           "flush", "full_agg", "decode")

# Device-memory bandwidth by card (NVIDIA data sheets), bytes/s.
_BANDWIDTH = (("H200", 4.8e12), ("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12),
              ("H100", 3.35e12))
# 32-bit integer ALU lanes per SM on Hopper (CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0: 64 results
# per clock per SM for 32-bit integer add, compare, min/max, logical ops
# and shifts); the integer work is held against lanes x SMs x SM clock.
_INT32_LANES_PER_SM = 64


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip smoke check failed: {what}")


def nvidia_smi(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bandwidth(name: str) -> float:
    for key, rate in _BANDWIDTH:
        if key in name:
            return rate
    raise RuntimeError(f"no memory bandwidth on record for {name!r}")


def int32_ops_per_s() -> float:
    """The card's 32-bit integer rate: 64 lanes per SM x its SMs
    (``torch.cuda.get_device_properties``) x its maximum SM clock
    (``nvidia-smi --query-gpu=clocks.max.sm``)."""
    import torch

    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return _INT32_LANES_PER_SM * sms * mhz * 1e6


def cuda_ms(fn, reps: int, queue_ahead: bool = False) -> float:
    """Median device time of ``fn`` over ``reps`` calls, each between its
    own pair of CUDA events (two warm-up calls first; one for a single
    timed call, as the plain versions get). ``queue_ahead``
    parks the stream behind a sleeping kernel while the calls are
    enqueued, so that the host's launch overhead stays out of the device
    time (only for functions that do not synchronise)."""
    import torch

    for _ in range(2 if reps > 1 else 1):
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


def rows_in_ranges(params: np.ndarray, n_rows: int) -> int:
    """Rows summed over the specs' [row_lo, row_hi) ranges."""
    lo = np.clip(params[:, 0].astype(np.int64), 0, n_rows)
    hi = np.clip(params[:, 1].astype(np.int64), 0, n_rows)
    return int(np.maximum(hi - lo, 0).sum())


def decode_ops(plan) -> float:
    """Integer operations per row in range that no spec changes, as the
    function needs them: the bool planes hold one 0/1 byte a row, so one
    32-bit logic op serves four rows: one three-input op for valid, tomb
    and live, and one per value column for its set and isnull."""
    return (1 + len(plan.col_ids)) / 4


# Integer operations per row and distinct read point (read and expiry
# hybrid times): its two 64-bit compares, two 32-bit ops each. Specs that
# share a read point share the row's visibility.
VISIBILITY_OPS = 4


def spec_ops(plan) -> float:
    """Integer operations per row and spec in the spec's range, as the
    function needs them: one compare per order plane of each predicate;
    SUM two adds per order-plane word (its 16-bit limbs, or the word into
    an int64), MIN/MAX one min/max op on an i32 column and a 64-bit compare
    and select (4) on an i64 one; COUNT nothing per row. The count slots
    (COUNT(*), the scanned rows, each aggregate's count or n) cost a
    popcount and an add per 32-row mask word, and the row range nothing
    per row (it is decided per 32-row word but at a spec's two edges)."""
    n = sum(1 if p.kind == "i32" else 2 for p in plan.preds)
    for a in plan.aggs:
        width = 1 if a.kind == "i32" else 2
        if a.fn == "sum":
            n += 2 * width
        elif a.fn != "count":
            n += 1 if width == 1 else 4
    return n + 2 * (2 + len(plan.aggs)) / 32


def visibility_rows(params: np.ndarray, n_rows: int) -> tuple:
    """(distinct read points, rows summed over each read point's union of
    ranges): the rows whose visibility the specs need."""
    reads = {tuple(r) for r in params[:, 2:6].tolist()}
    return len(reads), sum(
        covered_rows(params[(params[:, 2:6] == r).all(axis=1)], n_rows)
        for r in reads)


def exact(plan, table, params):
    """The kernel's folded rows, held exactly against the plain version
    on the same inputs: (folded rows on the host, max |diff|)."""
    import torch

    from yugabyte_db_tpu_torch.ops import flat_agg

    got = flat_agg.fold_partials(
        plan, flat_agg.flat_aggregate(plan, table, params))
    want = flat_agg.fold_partials(
        plan, flat_agg.flat_aggregate_plain(plan, table, params))
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    check(torch.equal(got, want), f"kernel != plain version (max |diff| "
                                  f"{err}) for {plan.aggs} {plan.preds}")
    return got.cpu(), err


def measure(plan, table, params_np, device, bw: float, rate: float) -> dict:
    """Kernel vs plain version on the same inputs: exact comparison of the
    folded partial rows, times, and the bound."""
    import torch

    from yugabyte_db_tpu_torch.ops import flat_agg

    params = torch.from_numpy(params_np).to(device)
    launches0 = flat_agg.flat_aggregate.launches
    got, err = exact(plan, table, params)
    ms = cuda_ms(lambda: flat_agg.flat_aggregate(plan, table, params),
                 KERNEL_REPS, queue_ahead=True)
    plain_ms = cuda_ms(
        lambda: flat_agg.flat_aggregate_plain(plan, table, params),
        PLAIN_REPS)
    launches = flat_agg.flat_aggregate.launches - launches0
    n_rows = table[0].numel()
    rows = covered_rows(params_np, n_rows)
    n_reads, vis_rows = visibility_rows(params_np, n_rows)
    # Inputs read once (the planes of the rows in range, the parameter
    # rows), the folded [N, S] int64 result written once; the decode once
    # per row in range, visibility once per row and read point, the
    # per-spec work once per row in each range.
    nbytes = (rows * plan.bytes_per_row(table) + params_np.nbytes
              + params_np.shape[0] * plan.n_out * 8)
    ops = (rows * decode_ops(plan) + vis_rows * VISIBILITY_OPS
           + rows_in_ranges(params_np, n_rows) * spec_ops(plan))
    bytes_ms = nbytes / bw * 1e3
    ops_ms = ops / rate * 1e3
    return {"specs": params_np.shape[0], "rows": rows,
            "bytes_per_row": plan.bytes_per_row(table),
            "ops_per_row": decode_ops(plan), "read_points": n_reads,
            "ops_per_row_and_spec": spec_ops(plan), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "max_abs_err": err, "launches": launches,
            "count": int(got[0, 0]),
            "scanned": int(got[0, 1])}


# -- phase 2: the kernel at 16M rows ---------------------------------------

I32_MIN, I32_MAX = int(np.iinfo(np.int32).min), int(np.iinfo(np.int32).max)
I64_MIN, I64_MAX = int(np.iinfo(np.int64).min), int(np.iinfo(np.int64).max)
# The kernel table's value columns: (col_id, kind, P(set), P(NULL | set)).
# 1 = a (INT64) and 2 = d (INT32) as the bench table's; 3 (INT32) is NULL
# wherever it is set, 4 (INT64) is never set.
MAIN_COLUMNS = ((1, "i64", 0.99, 0.02), (2, "i32", 0.97, 0.03),
                (3, "i32", 0.9, 1.0), (4, "i64", 0.0, 0.0))
WIDE_ROWS = 1 << 20


def kernel_planes(n_rows: int, R: int, columns, seed: int = 11):
    """Flat-run planes in the DeviceRun.arrays layout, and read points
    (latest, median and 5th-percentile hybrid time). About 0.1% of the
    set values sit at their type's extremes."""
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

    def column(kind, p_set, p_null):
        if kind == "i64":
            values = rng.integers(-10**12, 10**12, n_rows, dtype=np.int64)
            lo_hi = (I64_MIN, I64_MAX)
        else:
            values = rng.integers(-10**6, 10**6, n_rows).astype(np.int32)
            lo_hi = (I32_MIN, I32_MAX)
        ext = rng.random(n_rows) < 0.001
        values[ext] = np.where(rng.random(int(ext.sum())) < 0.5, *lo_hi)
        set_ = valid & ~tomb & (rng.random(n_rows) < p_set)
        isnull = set_ & (rng.random(n_rows) < p_null)
        keep = set_ & ~isnull
        if kind == "i64":
            hi, lo = P.i64_to_ordered_planes(values)
            cmp = np.stack([np.where(keep, hi, 0), np.where(keep, lo, 0)],
                           axis=-1).astype(np.int32)
        else:
            cmp = np.where(keep, values, 0).astype(np.int32)[:, None]
        return {"set": shaped(set_), "isnull": shaped(isnull),
                "cmp": shaped(cmp, cmp.shape[1])}

    ht_hi, ht_lo = P.ht_to_planes(ht)
    exp_hi, exp_lo = P.ht_to_planes(exp)
    planes = {
        "valid": shaped(valid), "group_start": shaped(np.ones(n_rows, bool)),
        "tomb": shaped(tomb), "live": shaped(live),
        "ht_hi": shaped(ht_hi), "ht_lo": shaped(ht_lo),
        "exp_hi": shaped(exp_hi), "exp_lo": shaped(exp_lo),
        "cols": {cid: column(kind, p_set, p_null)
                 for cid, kind, p_set, p_null in columns},
    }
    reads = {"all": int(ht.max()) + 1, "mid": int(np.median(ht)),
             "early": int(np.percentile(ht, 5)),
             "spread": [int(np.percentile(ht, q)) for q in range(10, 100, 10)]}
    return planes, reads


def read_params(read_ht: int) -> tuple:
    from yugabyte_db_tpu_torch.storage.row_version import MAX_HT
    from yugabyte_db_tpu_torch.utils import planes as P

    r = P.scalar_ht_planes(min(read_ht, MAX_HT))
    e = P.scalar_ht_planes(min(read_ht, MAX_HT - 1))
    return (*r, *e)


def lit_i64(v: int) -> np.ndarray:
    from yugabyte_db_tpu_torch.utils import planes as P

    hi, lo = P.i64_to_ordered_planes(np.array([v], np.int64))
    return np.array([hi[0], lo[0]], np.int32)


def make_params(plan, rows) -> np.ndarray:
    """[N, P] parameter rows of (row_lo, row_hi, read_ht, literals)."""
    return np.array([plan.param_row(lo, hi, read_params(rd), lits)
                     for lo, hi, rd, lits in rows], np.int32)


A, D, E, F = 1, 2, 3, 4


def headline_aggs():
    from yugabyte_db_tpu_torch.ops.scan import AggSig

    return (AggSig("count", None, None), AggSig("sum", A, "i64"),
            AggSig("min", A, "i64"), AggSig("max", A, "i64"),
            AggSig("sum", D, "i32"))


def kernel_signatures(planes, reads: dict, n_rows: int):
    """(label, plan, [N, P] params) of every timed signature."""
    from yugabyte_db_tpu_torch.ops import flat_agg
    from yugabyte_db_tpu_torch.ops.scan import AggSig, PredSig

    cnt = AggSig("count", None, None)
    headline = headline_aggs()
    read_all, read_mid = reads["all"], reads["mid"]
    # Literals that hit a stored value, so '=' matches rows.
    a_cmp = planes["cols"][A]["cmp"].reshape(-1, 2)
    d_cmp = planes["cols"][D]["cmp"].reshape(-1)
    ok = (planes["cols"][A]["set"] & ~planes["cols"][A]["isnull"]
          & planes["cols"][D]["set"] & ~planes["cols"][D]["isnull"])
    hit = int(np.flatnonzero(ok.reshape(-1))[777])
    a_lit = (int(a_cmp[hit, 0]), int(a_cmp[hit, 1]))
    d_lit = int(d_cmp[hit])

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
    return [(label, flat_agg.make_plan(aggs, preds, (A, D)),
             make_params(flat_agg.make_plan(aggs, preds, (A, D)), rows))
            for label, aggs, preds, rows in sigs]


def varied_rows(count: int, n_rows: int, reads: dict, lits, seed: int):
    """``count`` specs whose row ranges (odd ends, some empty), read
    points and literals differ; ``lits(rng)`` draws one spec's literals."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(count):
        lo = (int(rng.integers(0, n_rows // 3)) | 1) if i % 3 else 0
        hi = n_rows - (int(rng.integers(0, n_rows // 3)) | 1) if i % 5 \
            else n_rows
        if i % 11 == 7:
            hi = lo  # empty
        rd = (reads["all"], reads["mid"], reads["early"])[i % 3]
        rows.append((lo, hi, rd, lits(rng)))
    return rows


def edge_signatures(reads: dict, n_rows: int):
    """(label, plan, [N, P] params, check of the folded rows) of the
    edges the kernel is held at, untimed."""
    from yugabyte_db_tpu_torch.ops import flat_agg
    from yugabyte_db_tpu_torch.ops.scan import AggSig, PredSig

    headline = headline_aggs()
    ge = (PredSig(D, "i32", ">="),)
    read_all = reads["all"]
    n = n_rows

    def d_lit(rng):
        return (np.int32(int(rng.integers(-10**6, 10**6))),)

    def any_rows(plan, folded):
        return int(folded[:, 1].sum()) > 0

    out = []
    plan = flat_agg.make_plan(headline, ge, (A, D))
    odd = [(1, n - 3), (3, 1027), (1021, 1029), (2047, 2049), (4097, 4097),
           (5001, 4999), (n - 5, n), (0, 1), (n // 2 + 1, n // 2 + 1023)]
    out.append(("odd_bounds", plan, make_params(plan, [
        (lo, hi, (reads["all"], reads["mid"])[k % 2],
         (np.int32(-500_000 + k),)) for k, (lo, hi) in enumerate(odd)]),
        any_rows))
    # More distinct read points than a block masks per tile: the specs
    # past READ_CLASSES compare hybrid times row by row.
    out.append(("read_points_past_classes", plan, make_params(plan, [
        (k % 2, n - k, rd, (np.int32(-500_000 + k),))
        for k, rd in enumerate(reads["spread"])]), any_rows))
    for count in (33, flat_agg.SPEC_CHUNK + 1, 512):
        out.append((f"batch{count}", plan, make_params(
            plan, varied_rows(count, n, reads, d_lit, count)), any_rows))
    extremes = [(I32_MIN, I64_MAX), (I32_MAX, I64_MIN), (0, 0),
                (I32_MIN, I64_MIN), (I32_MAX, I64_MAX)]
    for ops in ((">=", "<="), ("=", "!="), ("<", ">")):
        plan_x = flat_agg.make_plan(
            headline, (PredSig(D, "i32", ops[0]), PredSig(A, "i64", ops[1])),
            (A, D))
        out.append((f"extreme_literals_{ops[0]}_{ops[1]}", plan_x,
                    make_params(plan_x, [
                        (1, n - 1, read_all, (np.int32(x), lit_i64(y)))
                        for x, y in extremes]), lambda p, f: True))
    null_aggs = (AggSig("count", None, None), AggSig("count", E, "i32"),
                 AggSig("sum", E, "i32"), AggSig("min", E, "i32"),
                 AggSig("max", E, "i32"), AggSig("sum", F, "i64"),
                 AggSig("min", F, "i64"), AggSig("max", F, "i64"))
    plan_n = flat_agg.make_plan(null_aggs, ge, (A, D, E, F))

    def all_null(plan, folded):
        return all(plan.combine(row)[2][1:] == [0] + [None] * 6
                   for row in folded.tolist()) and any_rows(plan, folded)

    out.append(("all_null_columns", plan_n, make_params(
        plan_n, varied_rows(5, n, reads, d_lit, 3)), all_null))
    return out


def wide_signature(reads: dict, n_rows: int):
    """MAX_COLS value columns (odd col_ids INT64, even INT32, the last
    one all NULL): MAX_PREDS predicates on columns 1..8 and MAX_AGGS
    aggregates on columns 9..16."""
    from yugabyte_db_tpu_torch.ops import flat_agg
    from yugabyte_db_tpu_torch.ops.scan import AggSig, PredSig

    kind = {c: "i64" if c % 2 else "i32"
            for c in range(1, flat_agg.MAX_COLS + 1)}
    ops = ("!=", ">=", "<=", ">", "<", "!=", ">=", "<=")
    low, high = -10**6 - 1, 10**6 + 1
    lit = {"!=": 0, ">=": low, ">": low, "<=": high, "<": high}
    preds = tuple(PredSig(c, kind[c], op) for c, op in zip(range(1, 9), ops))
    fns = ("sum", "min", "max", "count", "sum", "min", "max", "sum")
    aggs = tuple(AggSig(fn, c, kind[c]) for c, fn in zip(range(9, 17), fns))
    plan = flat_agg.make_plan(aggs, preds, tuple(range(1, 17)))

    def lits(rng):
        return tuple(lit_i64(lit[p.op]) if p.kind == "i64"
                     else np.int32(lit[p.op]) for p in preds)

    return plan, make_params(plan, varied_rows(5, n_rows, reads, lits, 9))


def kernel_phase(device, bw: float, rate: float) -> int:
    """Times every signature and checks every edge; returns the largest
    |diff| of every comparison (0, or a check has already failed)."""
    import torch

    from yugabyte_db_tpu_torch.ops import flat_agg
    from yugabyte_db_tpu_torch.ops.device_run import DeviceRun

    t0 = time.perf_counter()
    planes, reads = kernel_planes(KERNEL_ROWS, KERNEL_R, MAIN_COLUMNS)
    run = DeviceRun.from_reference_planes(planes, KERNEL_R, device)
    print(f"kernel phase: {KERNEL_ROWS} rows resident, {run.nbytes} bytes "
          f"of planes, made and uploaded in "
          f"{time.perf_counter() - t0:.1f} s")
    out = []
    for label, plan, params in kernel_signatures(planes, reads,
                                                 KERNEL_ROWS):
        table = plan.plane_table(run.arrays)
        row = {"signature": label,
               **measure(plan, table, params, device, bw, rate)}
        check(row["scanned"] > 0, f"{label}: no row exists in range")
        out.append(row)
        print("kernel_signature " + json.dumps(row))
    by = {r["signature"]: r for r in out}
    single, batch = by["headline"]["ms"], by["batch32"]["ms"]
    print("kernel_batch_vs_single " + json.dumps({
        "batch32_ms": batch, "single_ms": single,
        "32x_single_ms": BATCH * single,
        "batch32_over_32x_single": batch / (BATCH * single)}))
    errs = [r["max_abs_err"] for r in out]

    def edge(label, plan, table, params_np, ok):
        folded, err = exact(plan, table, torch.from_numpy(params_np).to(
            device))
        check(ok(plan, folded), f"edge {label}: unexpected result")
        errs.append(err)
        print(f"kernel_edge {label}: {params_np.shape[0]} specs, "
              f"{table[0].numel()} rows, "
              f"{len(plan.col_ids)} columns, exact")

    for label, plan, params, ok in edge_signatures(reads, KERNEL_ROWS):
        edge(label, plan, plan.plane_table(run.arrays), params, ok)
    del run, planes
    kinds = tuple((c, "i64" if c % 2 else "i32", 0.99,
                   1.0 if c == flat_agg.MAX_COLS else 0.01)
                  for c in range(1, flat_agg.MAX_COLS + 1))
    planes, reads = kernel_planes(WIDE_ROWS, KERNEL_R, kinds, seed=12)
    run = DeviceRun.from_reference_planes(planes, KERNEL_R, device)
    plan, params = wide_signature(reads, WIDE_ROWS)
    edge("max_cols_preds_aggs", plan, plan.plane_table(run.arrays), params,
         lambda p, f: int(f[:, 0].sum()) > 0)
    return max(errs)


# -- phase 3: the engine at 1M keys -----------------------------------------

class Oracle:
    """Exact answers of the headline spec ``d >= lo``, and of sum, min and
    max of c under it, over the rows that exist with a non-NULL d, given
    as arrays of d, a, c and the masks of non-NULL a and c: suffix counts,
    sums and extremes over the rows sorted by d. The int64 sums are exact: fewer
    than 2^22 rows of |a| < 2^40."""

    def __init__(self, d, a, a_ok, c, c_ok):
        order = np.argsort(d, kind="stable")
        self.d = d[order]
        a, a_ok, c, c_ok = a[order], a_ok[order], c[order], c_ok[order]

        def suffix(x, op, fill):
            x = np.append(x, fill)
            return op.accumulate(x[::-1])[::-1]

        self.n_a = suffix(a_ok.astype(np.int64), np.add, 0)
        self.sum_a = suffix(np.where(a_ok, a, 0), np.add, 0)
        self.min_a = suffix(np.where(a_ok, a, I64_MAX), np.minimum, I64_MAX)
        self.max_a = suffix(np.where(a_ok, a, I64_MIN), np.maximum, I64_MIN)
        self.sum_d = suffix(self.d, np.add, 0)
        self.n_c = suffix(c_ok.astype(np.int64), np.add, 0)
        self.sum_c = suffix(np.where(c_ok, c, 0.0), np.add, 0.0)
        self.abs_c = suffix(np.where(c_ok, np.abs(c), 0.0), np.add, 0.0)
        self.min_c = suffix(np.where(c_ok, c, np.inf), np.minimum, np.inf)
        self.max_c = suffix(np.where(c_ok, c, -np.inf), np.maximum, -np.inf)

    @staticmethod
    def arrays(triples) -> tuple:
        """(d, a, a_ok, c, c_ok) arrays of (d, a, c) triples."""
        d = np.array([t[0] for t in triples], np.int64)
        a_ok = np.array([t[1] is not None for t in triples], bool)
        a = np.array([t[1] or 0 for t in triples], np.int64)
        c_ok = np.array([t[2] is not None for t in triples], bool)
        c = np.array([t[2] or 0.0 for t in triples], np.float64)
        return d, a, a_ok, c, c_ok

    @classmethod
    def of_rows(cls, schema, rows):
        """Over flat rows (one version per key, no NULLs)."""
        cid = {c.name: c.col_id for c in schema.columns}
        return cls(*cls.arrays([(r.columns[cid["d"]], r.columns[cid["a"]],
                                 r.columns[cid["c"]])
                                for r in rows if not r.tombstone]))

    def headline(self, lo: int) -> tuple:
        i = int(np.searchsorted(self.d, lo, side="left"))
        if i == len(self.d):
            return (0, None, None, None, None)
        has_a = bool(self.n_a[i])
        return (len(self.d) - i,
                int(self.sum_a[i]) if has_a else None,
                int(self.min_a[i]) if has_a else None,
                int(self.max_a[i]) if has_a else None,
                int(self.sum_d[i]))

    def c_aggs(self, lo: int) -> tuple:
        """(sum, min, max, sum of |c|) of c under ``d >= lo``."""
        i = int(np.searchsorted(self.d, lo, side="left"))
        if not self.n_c[i]:
            return None, None, None, 0.0
        return (float(self.sum_c[i]), float(self.min_c[i]),
                float(self.max_c[i]), float(self.abs_c[i]))


_BENCH_ROWS: dict = {}  # make_rows of the bench table, made once


def bench_rows(schema, n: int) -> tuple:
    """``workload.make_rows(schema, n)``, made once a process: the engine,
    mvcc and compact phases' tables hold the same rows (same seed)."""
    from yugabyte_db_tpu_torch import workload

    if n not in _BENCH_ROWS:
        _BENCH_ROWS[n] = workload.make_rows(schema, n)
    return _BENCH_ROWS[n]


def flat_engine(device) -> SimpleNamespace:
    """The bench table at ENGINE_KEYS keys, applied and flushed into one
    flat run of a ``gpu`` engine: schema, rows, max_ht, engine, generate
    and apply+flush seconds."""
    from yugabyte_db_tpu_torch import workload
    from yugabyte_db_tpu_torch.storage import make_engine

    t0 = time.perf_counter()
    schema = workload.make_schema()
    rows, max_ht = bench_rows(schema, ENGINE_KEYS)
    gen_s = time.perf_counter() - t0
    eng = make_engine("gpu", schema, {"rows_per_block": 2048,
                                      "device": device})
    t0 = time.perf_counter()
    eng.apply(rows)
    flush(eng, "engine")
    return SimpleNamespace(schema=schema, rows=rows, max_ht=max_ht, eng=eng,
                           gen_s=gen_s, load_s=time.perf_counter() - t0)


def engine_phase(device, bw: float, rate: float) -> tuple:
    """(measurements, the engine's ``flat_engine`` namespace)."""
    import torch

    from yugabyte_db_tpu_torch import workload
    from yugabyte_db_tpu_torch.ops import flat_agg
    from yugabyte_db_tpu_torch.storage import AggSpec, Predicate, ScanSpec

    ctx = flat_engine(device)
    schema, rows, max_ht, eng = ctx.schema, ctx.rows, ctx.max_ht, ctx.eng
    k12_launch = write_log().last_flush
    flush_cmp = flush_against_host_build(ctx, device)
    t0 = time.perf_counter()
    oracle = Oracle.of_rows(schema, rows)
    gen_s = ctx.gen_s + time.perf_counter() - t0
    load_s = ctx.load_s
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

    eng_trace = trace_batches(eng, [[spec(lo) for lo in lits]
                                     for lits in batches[:TRACE_BATCHES]])
    print("engine_trace " + json.dumps(eng_trace))

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
    eng_row["kernel"] = measure(plan, table, params, device, bw, rate)
    print("engine_kernel " + json.dumps(eng_row["kernel"]))
    # K12 at the flush of this table, timed and held (outside the counted
    # flush).
    eng_row["k12"] = measure_k12(k12_launch, bw, rate)
    eng_row["k12"]["edges"] = k12_edges(k12_launch)
    eng_row["flush"] = flush_cmp
    del k12_launch
    print("flush_kernel " + json.dumps(eng_row["k12"]))
    return eng_row, ctx


def trace_batches(eng, batches) -> dict:
    """``torch.profiler`` (CPU + CUDA) over pipelined ``scan_batch_async``
    batches: the device's busy share of the wall time (union of its
    kernel and copy intervals), its time by kernel name, and the host's
    time per batch in ``scan_batch_async`` (planning and launches) and in
    ``finish`` (waiting and unpacking)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    plan_s = finish_s = 0.0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        inflight = []
        for specs in batches:
            t = time.perf_counter()
            inflight.append(eng.scan_batch_async(specs))
            plan_s += time.perf_counter() - t
        for b in inflight:
            t = time.perf_counter()
            b.finish()
            finish_s += time.perf_counter() - t
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    spans, by_name = [], collections.Counter()
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        by_name[e.name[:90]] += (end - start) / 1e3
    n = len(batches)
    out = {"batches": n, "wall_ms_per_batch": wall_s * 1e3 / n,
           "host_plan_ms_per_batch": plan_s * 1e3 / n,
           "host_finish_ms_per_batch": finish_s * 1e3 / n}
    if not spans:
        out["device_busy_share"] = "not measured"
        out["device_ms_by_kernel"] = "not measured"
        return out
    busy, end_at = 0.0, float("-inf")
    for start, end in sorted(spans):  # union of the device intervals, us
        if end > end_at:
            busy += end - max(start, end_at)
            end_at = end
    out["device_busy_share"] = busy / (wall_s * 1e6)
    out["device_ms_per_batch"] = busy / 1e3 / n
    out["device_ms_by_kernel"] = dict(by_name.most_common(12))
    return out


# -- phase 4: multi-version runs at 1M keys + 1M updates ----------------------

MVCC_KEYS = 1_000_000
MVCC_UPDATES = 1_000_000
# Integer operations per valid row of the resolve that the function
# needs: the row's group-start and validity test, its visibility and
# expiry compares (VISIBILITY_OPS), its tombstone and shadowing tests (a
# 64-bit compare, 2) and its alive test; then one set test and one select
# per column.
RESOLVE_ROW_OPS = 2 + VISIBILITY_OPS + 2 + 2
RESOLVE_COL_OPS = 2
MIXED_REPS = 3  # timed calls of the 32-read-point batch


class HistoryOracle:
    """Exact headline answers over a multi-version history at any read
    point: every updated key merged by the port's host merge
    (``storage/merge.py`` ``merge_versions``, the merge the JAX package's
    ``cpu`` engine serves from); a key never updated holds its one
    version, visible from its hybrid time on (no TTL, no NULL)."""

    def __init__(self, schema, rows, updates):
        cid = {c.name: c.col_id for c in schema.columns}
        self.a, self.c, self.d = cid["a"], cid["c"], cid["d"]
        by_key: dict = {}
        for u in updates:
            by_key.setdefault(u.key, []).append(u)
        self.multi = [(r.key, [r] + by_key[r.key]) for r in rows
                      if r.key in by_key]
        single = [r for r in rows if r.key not in by_key and
                  not r.tombstone]
        self.s_ht = np.array([r.ht for r in single], np.int64)
        self.single = Oracle.arrays([
            (r.columns[self.d], r.columns[self.a], r.columns[self.c])
            for r in single])

    def merged(self, reads: list, part: int = 0, parts: int = 1) -> list:
        """For each read point of ``reads``, ``Oracle.arrays`` of the rows
        there of the ``part``-th of ``parts`` slices of the updated keys. A
        key none of whose versions has a TTL merges to the same row at
        every read point that sees the same versions: merged once for
        each."""
        from bisect import bisect_right

        from yugabyte_db_tpu_torch.storage.merge import merge_versions

        def row(key, versions, read_ht):
            m = merge_versions(key, versions, read_ht)
            d = m.get(self.d)
            if d is None:  # a NULL value: the row does not exist
                return None
            return (d, m.get(self.a), m.get(self.c))

        out = [[] for _ in reads]
        n = len(self.multi)
        for key, versions in self.multi[part * n // parts:
                                        (part + 1) * n // parts]:
            ttl = any(v.has_ttl for v in versions)
            hts = sorted(v.ht for v in versions)
            seen = {}
            for j, rd in enumerate(reads):
                if ttl:
                    got = row(key, versions, rd)
                else:
                    c = bisect_right(hts, rd)
                    if c not in seen:
                        seen[c] = row(key, versions, rd)
                    got = seen[c]
                if got is not None:
                    out[j].append(got)
        return [Oracle.arrays(rows) for rows in out]

    def arrays(self, read_ht: int, merged: tuple | None = None) -> tuple:
        """``Oracle.arrays`` of every row with a non-NULL d at ``read_ht``
        (``merged``: the updated keys' arrays, ``merge_reads``' when
        None)."""
        if merged is None:
            merged = self.merge_reads([read_ht])[0]
        vis = self.s_ht <= read_ht
        parts = zip(merged, (x[vis] for x in self.single))
        return tuple(np.concatenate(p) for p in parts)

    def at(self, read_ht: int, merged: tuple | None = None) -> Oracle:
        return Oracle(*self.arrays(read_ht, merged))

    def merge_reads(self, reads: list) -> list:
        """``merged`` at every read point of ``reads``, the updated keys
        in ORACLE_PROCS slices, each merged (pure Python, no device) at
        every read point in a forked process of its own."""
        import multiprocessing

        global _FORKED_HISTORY
        jobs = [(list(reads), k, ORACLE_PROCS) for k in range(ORACLE_PROCS)]
        _FORKED_HISTORY = self
        try:
            with multiprocessing.get_context("fork").Pool(
                    ORACLE_PROCS) as pool:
                done = pool.map(_forked_merge, jobs, chunksize=1)
        finally:
            _FORKED_HISTORY = None
        return [tuple(np.concatenate([part[j][i] for part in done])
                      for i in range(5)) for j in range(len(reads))]

    def at_reads(self, reads: list) -> dict:
        """``at`` for every read point of ``reads`` (``merge_reads``)."""
        return {rd: self.at(rd, m)
                for rd, m in zip(reads, self.merge_reads(reads))}


ORACLE_PROCS = 8  # processes that merge a history's read points
_FORKED_HISTORY = None  # the history a forked merge reads (merge_reads)


def _forked_merge(job: tuple) -> list:
    return _FORKED_HISTORY.merged(*job)


def view_planes(view: dict) -> dict:
    """A view's (or plane tree's) planes by name, flat; an encoded leaf's
    arrays under the leaf's name and kind."""
    out = {}

    def walk(prefix, node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(f"{prefix}{k}.", v)
            else:
                out[f"{prefix}{k}"] = v

    walk("", view)
    return out


def view_diff(got: dict, want: dict) -> int:
    """Largest |difference| between two views' planes, read as integers
    (float planes by their bits): 0 when they are equal byte for byte."""
    import torch

    err = 0
    g, w = view_planes(got), view_planes(want)
    check(g.keys() == w.keys(), "view planes differ in name")
    for k in w:
        check(g[k].dtype == w[k].dtype and g[k].shape == w[k].shape,
              f"view plane {k}: {g[k].dtype} {tuple(g[k].shape)} vs "
              f"{w[k].dtype} {tuple(w[k].shape)}")
        a, b = g[k], w[k]
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        err = max(err, int((a.long() - b.long()).abs().max()))
    return err


def measure_resolve(arrays: dict, const: dict, read_ht: int, bw: float,
                    rate: float) -> dict:
    """The resolve kernel against its plain version at one read point of
    a run's planes (``DeviceRun.arrays``, constant view planes ``const``):
    the views byte for byte, times, and the bound."""
    import torch

    from yugabyte_db_tpu_torch.ops import mvcc_resolve

    planes = read_params(read_ht)
    launches0 = mvcc_resolve.resolve_view.launches
    got = mvcc_resolve.resolve_view(arrays, *planes, const)
    want = mvcc_resolve.resolve_view_plain(arrays, *planes, const)
    torch.cuda.synchronize()
    err = view_diff(got, want)
    check(err == 0, f"resolve kernel != plain version at {read_ht} "
                    f"(max |diff| {err})")
    ms = cuda_ms(lambda: mvcc_resolve.resolve_view(arrays, *planes, const),
                 KERNEL_REPS, queue_ahead=True)
    plain_ms = cuda_ms(
        lambda: mvcc_resolve.resolve_view_plain(arrays, *planes, const),
        PLAIN_REPS)
    n_rows = arrays["valid"].numel()
    nbytes = mvcc_resolve.view_bytes(arrays, *planes)
    ops = int(arrays["valid"].sum()) * (
        RESOLVE_ROW_OPS + RESOLVE_COL_OPS * len(arrays["cols"]))
    bytes_ms, ops_ms = nbytes / bw * 1e3, ops / rate * 1e3
    return {"read_ht": read_ht, "rows": n_rows, "bytes": nbytes, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bytes_ms": bytes_ms,
            "ops_ms": ops_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "max_abs_err": err,
            "launches": mvcc_resolve.resolve_view.launches - launches0,
            "representatives": int(want["valid"].sum()),
            "live": int(want["live"].sum())}


def run_pipelined(eng, batches: list) -> list:
    """``scan_batch_async`` over ``batches`` (lists of specs), finishing
    the oldest whenever more than DEPTH are in flight: their results, in
    order."""
    q, out = collections.deque(), []
    for specs in batches:
        q.append(eng.scan_batch_async(specs))
        if len(q) > DEPTH:
            out.append(q.popleft().finish())
    out.extend(b.finish() for b in q)
    return out


LONG_ROWS = 2_097_152  # long-group planes: the mvcc run's row count
LONG_R = 2048
# Byte-exact edges of the resolve, untimed: (label, rows, R).
RESOLVE_EDGES = (("R48", 48 * 4096, 48),
                 ("full_block_groups", 2048 * 64, 2048))


def group_lengths(planes: dict) -> np.ndarray:
    """Versions of each key group of valid rows (a group ends at the next
    group start or at its block's end)."""
    valid = planes["valid"].reshape(-1)
    starts = planes["group_start"].reshape(-1).copy()
    starts[::planes["valid"].shape[1]] = True
    first = np.flatnonzero(starts & valid)
    ends = np.append(np.flatnonzero(starts), valid.size)
    return ends[np.searchsorted(ends, first, side="right")] - first


def long_group_resolve(device, bw: float, rate: float) -> dict:
    """The resolve on ``workload.long_group_planes`` (groups of 1 to R
    versions straddling warp steps and filling blocks) at LONG_ROWS rows,
    R = LONG_R: held byte for byte against its plain version and timed at
    the newest read point; then the edges of RESOLVE_EDGES, held byte for
    byte at the newest and a mid read point."""
    from yugabyte_db_tpu_torch import workload
    from yugabyte_db_tpu_torch.ops import mvcc_resolve
    from yugabyte_db_tpu_torch.ops.device_run import DeviceRun
    from yugabyte_db_tpu_torch.utils import planes as P

    def upload(n_rows, R, seed):
        planes = workload.long_group_planes(n_rows, R, seed)
        run = DeviceRun.from_reference_planes(planes, R, device)
        valid = planes["valid"]
        ht = P.planes_to_u64(planes["ht_hi"][valid],
                             planes["ht_lo"][valid]).astype(np.int64)
        const = mvcc_resolve.constant_planes(run.B, R, device)
        return planes, run.arrays, const, int(ht.max()) + 1, \
            int(np.median(ht))

    t0 = time.perf_counter()
    planes, arrays, const, newest, mid = upload(LONG_ROWS, LONG_R, 7)
    lengths = group_lengths(planes)
    setup = {"rows": LONG_ROWS, "R": LONG_R, "groups": int(lengths.size),
             "versions": int(lengths.sum()),
             "groups_over_32": int((lengths > 32).sum()),
             "versions_in_groups_over_32": int(lengths[lengths > 32].sum()),
             "full_block_groups": int((lengths == LONG_R).sum()),
             "made_s": time.perf_counter() - t0}
    row = dict(measure_resolve(arrays, const, newest, bw, rate), **setup)
    print("mvcc_resolve_long " + json.dumps(row))
    del arrays, const
    for label, n_rows, R in RESOLVE_EDGES:
        planes, arrays, const, e_newest, e_mid = upload(n_rows, R, 8)
        lengths = group_lengths(planes)
        check((lengths == R).any(), f"edge {label}: no group fills a block")
        for rd in (e_newest, e_mid):
            got = mvcc_resolve.resolve_view(arrays, *read_params(rd), const)
            want = mvcc_resolve.resolve_view_plain(arrays, *read_params(rd),
                                                   const)
            check(view_diff(got, want) == 0,
                  f"resolve edge {label} at {rd}: kernel != plain version")
        print(f"mvcc_resolve_edge {label}: {n_rows} rows, R = {R}, "
              f"{int((lengths == R).sum())} groups of R versions, the "
              f"longest {int(lengths.max())}, newest and mid, exact")
        del arrays, const
    return row


def mvcc_engine(device) -> tuple:
    """The bench table at MVCC_KEYS keys plus MVCC_UPDATES updates, applied
    and flushed into one multi-version run of a ``gpu`` engine: (schema,
    rows, updates, load_ht, max_ht, engine, generate s, apply+flush s)."""
    from yugabyte_db_tpu_torch import workload
    from yugabyte_db_tpu_torch.storage import make_engine

    t0 = time.perf_counter()
    schema = workload.make_schema()
    rows, load_ht = bench_rows(schema, MVCC_KEYS)
    updates, max_ht = workload.make_update_rows(schema, rows, load_ht,
                                                MVCC_UPDATES)
    gen_s = time.perf_counter() - t0
    eng = make_engine("gpu", schema, {"rows_per_block": 2048,
                                      "device": device})
    t0 = time.perf_counter()
    eng.apply(rows)
    eng.apply(updates)
    flush(eng, "mvcc")
    return (schema, rows, updates, load_ht, max_ht, eng, gen_s,
            time.perf_counter() - t0)


def resolve_ab(device, bw: float, others: list) -> None:
    """This tree's resolve kernel (A) against other sources of it (B1, B2,
    ..., each with the same C interface), on one card: the mvcc run at its
    newest and mid read points and the long-group planes (as they are and
    with CLEARED_SHARE of their groups cleared), each kernel held
    byte for byte against the plain version, then timed in turns A B1 ..
    Bn Bn .. B1 A (``cuda_ms``)."""
    import torch

    from yugabyte_db_tpu_torch import workload
    from yugabyte_db_tpu_torch.ops import mvcc_resolve
    from yugabyte_db_tpu_torch.ops.device_run import DeviceRun
    from yugabyte_db_tpu_torch.utils import planes as P

    libs = {"A": mvcc_resolve._library()}
    for other, lib in build_libs("mvcc_resolve", others).items():
        libs[other] = mvcc_resolve.bind(lib)
    own = mvcc_resolve._library

    *_, load_ht, max_ht, eng, _gen, _load = mvcc_engine(device)
    trun = eng.runs[0]
    planes = workload.long_group_planes(LONG_ROWS, LONG_R, 7)
    long_run = DeviceRun.from_reference_planes(planes, LONG_R, device)
    valid = planes["valid"]
    long_read = int(P.planes_to_u64(planes["ht_hi"][valid],
                                    planes["ht_lo"][valid]).max()) + 1
    cleared = DeviceRun.from_reference_planes(
        clear_groups(planes, CLEARED_SHARE)[0], LONG_R, device)
    long_const = mvcc_resolve.constant_planes(long_run.B, LONG_R, device)
    const = trun.resident().const
    cases = {"newest": (trun.dev.arrays, const, max_ht + 1),
             "mid": (trun.dev.arrays, const, (load_ht + max_ht) // 2),
             "long": (long_run.arrays, long_const, long_read),
             "long_cleared": (cleared.arrays, long_const, long_read)}
    order = ["A", *others, *others[::-1], "A"]
    try:
        for label, (arrays, const, rd) in cases.items():
            rp = read_params(rd)
            want = mvcc_resolve.resolve_view_plain(arrays, *rp, const)
            times = {name: [] for name in libs}
            for name in order:
                mvcc_resolve._library = lambda lib=libs[name]: lib
                got = mvcc_resolve.resolve_view(arrays, *rp, const)
                torch.cuda.synchronize()
                check(view_diff(got, want) == 0,
                      f"resolve {name} at {label} != plain version")
                del got
                times[name].append(cuda_ms(
                    lambda: mvcc_resolve.resolve_view(arrays, *rp, const),
                    KERNEL_REPS, queue_ahead=True))
            nbytes = mvcc_resolve.view_bytes(arrays, *rp)
            print("resolve_ab " + json.dumps({
                "case": label, "read_ht": rd,
                "rows": arrays["valid"].numel(), "bytes": nbytes,
                "bytes_ms": nbytes / bw * 1e3, "ms": times}))
    finally:
        mvcc_resolve._library = own


def mvcc_phase(device, bw: float, rate: float) -> tuple:
    """A multi-version history over the bench table: the resolve
    kernel timed and checked at two read points and on the long-group
    planes (with its edges), then the engine's
    multi-version routes (resolve, then K1 or the plain flat fold)
    against an exact oracle over the history. Returns (measurements, a
    namespace of the engine, its history and the newest read point's
    oracle)."""
    import torch

    from yugabyte_db_tpu_torch import workload
    from yugabyte_db_tpu_torch.ops import flat_agg, mvcc_resolve
    from yugabyte_db_tpu_torch.storage import AggSpec, Predicate, ScanSpec

    schema, rows, updates, load_ht, max_ht, eng, gen_s, load_s = \
        mvcc_engine(device)
    t0 = time.perf_counter()
    history = HistoryOracle(schema, rows, updates)
    trun = eng.runs[0]
    crun = trun.crun
    sizes = collections.Counter(len(v) for _k, v in history.multi)
    setup = {"keys": MVCC_KEYS, "updates": len(updates),
             "versions": crun.num_versions,
             "rows": trun.dev.arrays["valid"].numel(),
             "max_group_versions": crun.max_group_versions,
             "keys_2_to_32_versions": sum(n for v, n in sizes.items()
                                          if v <= 32),
             "keys_over_32_versions": sum(n for v, n in sizes.items()
                                          if v > 32),
             "generate_s": gen_s, "apply_flush_s": load_s,
             "device_bytes": eng.stats()["device_bytes"]}
    print("mvcc_setup " + json.dumps(setup))
    check(crun.max_group_versions > 32, "no key past 32 versions")

    newest, mid = max_ht + 1, (load_ht + max_ht) // 2
    resolve = {}
    for label, rd in (("newest", newest), ("mid", mid)):
        resolve[label] = dict(
            measure_resolve(trun.dev.arrays, trun.resident().const, rd, bw,
                            rate),
            view_key=list(trun.view_key(rd)))
        print(f"mvcc_resolve_{label} " + json.dumps(resolve[label]))
    resolve["long"] = long_group_resolve(device, bw, rate)
    # Past MAX_COLS value columns the wrapper launches once per chunk of
    # columns: the run's three columns repeated under 18 ids.
    arrays = trun.dev.arrays
    cids = list(arrays["cols"])
    wide = dict(arrays, cols={100 + i: arrays["cols"][cids[i % len(cids)]]
                              for i in range(mvcc_resolve.MAX_COLS + 2)})
    launches0 = mvcc_resolve.resolve_view.launches
    got = mvcc_resolve.resolve_view(wide, *read_params(mid),
                                    trun.resident().const)
    want = mvcc_resolve.resolve_view_plain(wide, *read_params(mid),
                                           trun.resident().const)
    torch.cuda.synchronize()
    check(view_diff(got, want) == 0, "resolve over 18 value columns")
    n = mvcc_resolve.resolve_view.launches - launches0
    check(n == 2, f"18 value columns launched the resolve {n} times, not 2")
    print(f"mvcc_resolve_edge {len(wide['cols'])} value columns, {n} "
          "launches, exact")
    del got, want

    def spec(read, lo):
        return workload.headline_spec(read, lo)

    # Read points across the history, six pairs across a TTL expiry.
    expiries = sorted({u.expire_ht for u in updates if u.has_ttl
                       and u.expire_ht <= max_ht})
    ttl = [expiries[len(expiries) * k // 7] for k in range(1, 7)]
    reads = set(ttl) | {e - 1 for e in ttl}
    for r in np.linspace(100, max_ht, BATCH).astype(int).tolist():
        while len(reads) < BATCH and r in reads:
            r += 1
        if len(reads) < BATCH:
            reads.add(r)
    reads = sorted(reads)
    oracle_s = time.perf_counter()
    oracles = history.at_reads([newest] + reads)
    oracle_s = time.perf_counter() - oracle_s

    # The main path, counted.
    mvcc_resolve.resolve_view.launches = 0
    flat_agg.flat_aggregate.launches = 0
    trun.drop_view()
    want = oracles[newest]
    got = eng.scan(spec(newest, -500_000)).rows[0]
    check(got == want.headline(-500_000),
          f"mvcc scan {got} != oracle {want.headline(-500_000)}")
    lat = []
    for _ in range(10):
        t = time.perf_counter()
        eng.scan(spec(newest, -500_000))
        lat.append(time.perf_counter() - t)
    batches = [[-500_000 - 7 * (b * BATCH + i) for i in range(BATCH)]
               for b in range(N_BATCHES)]
    run_pipelined(eng, [[spec(newest, lo) for lo in lits]
                        for lits in batches[:DEPTH + 2]])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = run_pipelined(eng, [[spec(newest, lo) for lo in lits]
                                  for lits in batches])
    tput_s = time.perf_counter() - t0
    for lits, res in zip(batches, results):
        for lo, r in zip(lits, res):
            check(r.rows[0] == want.headline(lo),
                  f"mvcc batched d >= {lo}: {r.rows[0]} != "
                  f"{want.headline(lo)}")
    lits = [-500_000 + 9_000 * i for i in range(BATCH)]
    mixed_specs = [spec(rd, lo) for rd, lo in zip(reads, lits)]
    # Device memory the batch takes beyond what it starts with: a view is
    # let go before the next one is resolved, so it must stay under two
    # views however many read points the batch holds.
    view_nbytes = sum(t.nbytes for t in view_planes(
        {"valid": arrays["valid"], "live": arrays["live"],
         "cols": arrays["cols"]}).values())  # what a resolve writes
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mixed = eng.scan_batch(mixed_specs)
    peak = torch.cuda.max_memory_allocated()
    check(peak - base < 2 * view_nbytes,
          f"the 32-read-point batch took {peak - base} bytes beyond its "
          f"start, a view is {view_nbytes}")
    for rd, lo, r in zip(reads, lits, mixed):
        check(r.rows[0] == oracles[rd].headline(lo),
              f"mvcc read point {rd}, d >= {lo}: {r.rows[0]} != "
              f"{oracles[rd].headline(lo)}")
    mixed_ms = []  # each call resolves its 32 views anew
    for _ in range(MIXED_REPS):
        t0 = time.perf_counter()
        eng.scan_batch(mixed_specs)
        mixed_ms.append((time.perf_counter() - t0) * 1e3)
    fspec = ScanSpec(read_ht=newest, predicates=[Predicate("d", ">=", 0)],
                     aggregates=[AggSpec("sum", "c"), AggSpec("min", "c"),
                                 AggSpec("max", "c")])
    check(eng._plan_scan(fspec).route == "mv_flat", "float spec route")
    fs, fmin, fmax = eng.scan(fspec).rows[0]
    want_s, want_min, want_max, abs_sum = want.c_aggs(0)
    # f32 sums over the arith plane: error within 2^-17 of sum(|c|).
    check(abs(fs - want_s) <= abs_sum * 2.0 ** -17,
          f"mvcc sum(c) {fs} vs {want_s}")
    check((fmin, fmax) == (want_min, want_max), "mvcc min/max(c)")
    launches = {"mvcc_resolve": mvcc_resolve.resolve_view.launches,
                "flat_agg": flat_agg.flat_aggregate.launches}
    check(launches["mvcc_resolve"] > 0,
          "the multi-version path launched the resolve kernel 0 times")
    check(launches["flat_agg"] > 0,
          "the multi-version path launched the flat_agg kernel 0 times")

    # Where a batch's time goes when each batch resolves its own view.
    trace_reads = reads[-TRACE_BATCHES:]
    mv_trace = trace_batches(eng, [[spec(rd, lo) for lo in batches[0]]
                                   for rd in trace_reads])
    print("mvcc_trace " + json.dumps(mv_trace))

    n_scans = BATCH * N_BATCHES
    row = {"single_scan_latency_ms": statistics.median(lat) * 1e3,
           "rows_per_s": crun.num_versions * n_scans / tput_s,
           "scans": n_scans, "batch": BATCH, "depth": DEPTH,
           "mixed_read_batch_ms": statistics.median(mixed_ms),
           "mixed_read_batch_ms_each": mixed_ms,
           "mixed_read_batch_peak_bytes": peak,
           "mixed_read_batch_extra_bytes": peak - base,
           "view_nbytes": view_nbytes, "oracle_s": oracle_s,
           "launches": launches}
    print("mvcc " + json.dumps(row))

    # K1 at this path's shapes: the newest view and one batch's
    # parameter rows, timed and held against its plain version.
    preps = [eng._plan_scan(spec(newest, lo)) for lo in batches[0]]
    p0 = preps[0]
    plan = flat_agg.make_plan(p0.sig.aggs, p0.sig.preds,
                              tuple(cs.col_id for cs in p0.sig.cols))
    params = np.array([plan.param_row(p.row_lo, p.row_hi, p.read_planes,
                                      p.lits) for p in preps], np.int32)
    table = plan.plane_table(p0.arrays())
    row["kernel"] = measure(plan, table, params, device, bw, rate)
    print("mvcc_kernel " + json.dumps(row["kernel"]))
    row["resolve"] = resolve
    return row, SimpleNamespace(schema=schema, rows=rows, updates=updates,
                                max_ht=max_ht, eng=eng, history=history,
                                before=want, oracles=oracles,
                                mid_read=reads[len(reads) // 2])


# -- phase 5: post-write scans through the delta overlay ---------------------

WAVES = 4  # update waves on the flat primary, flushed between the first 3
OVERLAY_BATCH = 4  # specs of the batch that misses the host-partial cache
CLEARED_SHARE = 0.2  # key groups cleared from the long-group planes


def clear_groups(planes: dict, share: float, seed: int = 13) -> tuple:
    """(a copy of ``planes``, numpy ``DeviceRun.arrays`` layout, with the
    valid flags of about ``share`` of its key groups cleared, every
    version of each, as the overlay clears its dirty keys; groups cleared;
    of them, groups that fill a whole block)."""
    valid = planes["valid"].reshape(-1)
    R = planes["valid"].shape[1]
    starts = planes["group_start"].reshape(-1).copy()
    starts[::R] = True
    first = np.flatnonzero(starts & valid)
    ends = np.append(np.flatnonzero(starts), valid.size)
    lengths = ends[np.searchsorted(ends, first, side="right")] - first
    pick = np.random.default_rng(seed).random(first.size) < share
    offsets = np.cumsum(lengths[pick]) - lengths[pick]
    rows = (np.repeat(first[pick] - offsets, lengths[pick])
            + np.arange(int(lengths[pick].sum())))
    out = dict(planes, valid=valid.copy())
    out["valid"][rows] = False
    out["valid"] = out["valid"].reshape(planes["valid"].shape)
    return out, int(pick.sum()), int((pick & (lengths == R)).sum())


def scatter_ms(valid, idx, bw: float) -> dict:
    """K13 (``gpu_engine.scatter_invalid``, a torch op) event-timed on the
    masked primary's plane and dirty rows, and its bytes bound: the plane
    read and its copy written once, the row indices read once."""
    from yugabyte_db_tpu_torch.storage import gpu_engine

    ms = cuda_ms(lambda: gpu_engine.scatter_invalid(valid, idx),
                 KERNEL_REPS)
    nbytes = 2 * valid.numel() + idx.nbytes
    return {"rows": valid.numel(), "cleared": int(idx.size), "ms": ms,
            "bytes": nbytes, "bound_ms": nbytes / bw * 1e3,
            "bound_by": "bytes"}


def host_fold_ms(eng, spec_of) -> dict:
    """The dirty keys' host fold (``_overlay_host_partial``) on the engine's
    overlay state, in ms: the first miss at the read point (the dirty keys
    merged there, after the state's merges are dropped), then a miss (a
    literal not folded before, the keys already merged) and a hit (the
    same spec again), medians of 3."""
    ov = eng._overlay(eng.memtable)
    ov.merged.clear()
    miss, hit = [], []
    for k in range(4):
        spec = spec_of(-123_457 - 1_001 * k)
        for out in (miss, hit):
            t = time.perf_counter()
            eng._overlay_host_partial(ov, spec)
            out.append((time.perf_counter() - t) * 1e3)
    return {"dirty_keys": len(ov.rows), "merge_miss_ms": miss[0],
            "miss_ms": statistics.median(miss[1:]),
            "hit_ms": statistics.median(hit[1:])}


def timed_overlay_batch(eng, specs) -> dict:
    """One ``scan_batch_async`` batch traced (``trace_batches``), with the
    time of its host folds split out of its planning: host planning and
    launching, host fold, device busy, finish (ms)."""
    folds = []
    partial = eng._overlay_host_partial

    def timed(ov, spec):
        t = time.perf_counter()
        out = partial(ov, spec)
        folds.append(time.perf_counter() - t)
        return out

    eng._overlay_host_partial = timed
    try:
        tr = trace_batches(eng, [specs])
    finally:
        del eng._overlay_host_partial
    fold_ms = sum(folds) * 1e3
    return dict(tr, specs=len(specs), host_folds=len(folds),
                host_fold_ms=fold_ms,
                host_plan_launch_ms=tr["host_plan_ms_per_batch"] - fold_ms)


def check_overlay_scan(eng, spec, want, label: str) -> None:
    prep = eng._plan_scan(spec)
    check(prep.overlay is not None, f"{label}: not an overlay plan")
    got = eng.scan(spec).rows[0]
    check(got == want, f"{label}: {got} != oracle {want}")


def check_c_aggs(eng, read: int, oracle, label: str) -> None:
    from yugabyte_db_tpu_torch.storage import AggSpec, Predicate, ScanSpec

    fspec = ScanSpec(read_ht=read, predicates=[Predicate("d", ">=", 0)],
                     aggregates=[AggSpec("sum", "c"), AggSpec("min", "c"),
                                 AggSpec("max", "c")])
    fs, fmin, fmax = eng.scan(fspec).rows[0]
    want_s, want_min, want_max, abs_sum = oracle.c_aggs(0)
    # f32 sums over the arith plane: error within 2^-17 of sum(|c|).
    check(abs(fs - want_s) <= abs_sum * 2.0 ** -17,
          f"{label} sum(c) {fs} vs {want_s}")
    check((fmin, fmax) == (want_min, want_max), f"{label} min/max(c)")


def overlay_flat(ctx, device, bw: float, rate: float) -> dict:
    """``bench_multisource``'s shape on the flat primary: WAVES waves of
    2% of the keys, flushed between the first three (4 runs and a live
    memtable), each result held against an exact oracle; then the
    latencies, a fifth memtable-only wave and its delta, the scatter, K1
    on the masked primary and the host fold, timed."""
    import torch

    from yugabyte_db_tpu_torch import workload
    from yugabyte_db_tpu_torch.ops import flat_agg

    eng, schema, rows = ctx.eng, ctx.schema, ctx.rows
    per_wave = ENGINE_KEYS // 50
    t0 = time.perf_counter()
    waves, ht, ends = [], ctx.max_ht, []
    for w in range(WAVES + 1):
        wave, ht = workload.make_wave_rows(schema, ENGINE_KEYS, per_wave, ht,
                                           seed=21 + w)
        waves.append(wave)
        ends.append(ht)
    updates = [r for wave in waves[:WAVES] for r in wave]
    history = HistoryOracle(schema, rows, updates)
    newest, between, before = ends[WAVES - 1] + 1, ends[1] + 1, \
        ctx.max_ht + 1
    oracles = history.at_reads([newest, between, before])
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for w in range(WAVES):
        eng.apply(waves[w])
        if w < WAVES - 1:
            flush(eng, "overlay")
    apply_s = time.perf_counter() - t0
    versions = (sum(t.crun.num_versions for t in eng.runs)
                + eng.memtable.num_versions)
    setup = {"keys": ENGINE_KEYS, "waves": WAVES, "per_wave": per_wave,
             "runs": len(eng.runs), "memtable_versions":
             eng.memtable.num_versions, "versions": versions,
             "generate_and_oracle_s": gen_s, "apply_flush_s": apply_s}

    def spec(read, lo):
        return workload.headline_spec(read, lo)

    # The overlay path on the flat primary, counted.
    flat_agg.flat_aggregate.launches = 0
    memtable_scans = eng.memtable_scans
    t = time.perf_counter()
    got = eng.scan(spec(newest, -500_000)).rows[0]
    first_ms = (time.perf_counter() - t) * 1e3
    check(got == oracles[newest].headline(-500_000),
          f"flat overlay first scan {got} != "
          f"{oracles[newest].headline(-500_000)}")
    ov = eng._overlay(eng.memtable)
    check(ov is not None and eng._plan_scan(spec(newest, 0)).route ==
          "kernel", "the flat overlay does not take K1")
    lat = []
    for _ in range(10):
        t = time.perf_counter()
        eng.scan(spec(newest, -500_000))
        lat.append((time.perf_counter() - t) * 1e3)
    for lo in (-900_000, 0, 400_000):
        check_overlay_scan(eng, spec(newest, lo),
                           oracles[newest].headline(lo), f"flat d >= {lo}")
        check_overlay_scan(eng, spec(between, lo),
                           oracles[between].headline(lo),
                           f"flat between waves, d >= {lo}")
    check_c_aggs(eng, newest, oracles[newest], "flat overlay")
    batch = eng.scan_batch([spec(newest, -500_000 - 7 * i)
                            for i in range(BATCH)])
    for i, r in enumerate(batch):
        want = oracles[newest].headline(-500_000 - 7 * i)
        check(r.rows[0] == want, f"flat overlay batch {i}: {r.rows[0]}")
    mixed = eng.scan_batch([spec(rd, 1) for rd in (between, newest,
                                                   before)])
    check([r.rows[0] for r in mixed] == [
        oracles[rd].headline(1) for rd in (between, newest, before)],
        "flat overlay batch at three read points")
    launches = flat_agg.flat_aggregate.launches
    check(launches > 0, "the flat overlay launched the flat_agg kernel 0 "
                        "times")
    check(eng.memtable_scans == memtable_scans,
          "an overlay spec was served by the memtable-only host fold")

    # Outside the counted run: a fifth wave, memtable only, and the delta
    # apply alone (as bench_multisource isolates it).
    eng.apply(waves[WAVES])
    t = time.perf_counter()
    ov5 = eng._overlay(eng.memtable)
    delta_ms = (time.perf_counter() - t) * 1e3
    check(ov5 is not ov and ov5.mem_count == eng.memtable.num_versions,
          "the fifth wave did not advance the overlay incrementally")
    newest5 = ends[WAVES] + 1
    want5 = HistoryOracle(schema, rows, updates + waves[WAVES]).at(newest5)
    check_overlay_scan(eng, spec(newest5, -500_000),
                       want5.headline(-500_000), "flat after the fifth wave")
    ctx.sources_read_ht = newest5  # the rows phase's several sources
    # The residency phase reads the compacted table at newest5.
    ctx.updates5, ctx.oracle5 = updates + waves[WAVES], want5
    lits = [-400_000 + 97_531 * i for i in range(OVERLAY_BATCH)]
    batch_trace = timed_overlay_batch(eng, [spec(newest5, lo)
                                            for lo in lits])
    fold = host_fold_ms(eng, lambda lo: spec(newest5, lo))

    # K1 on the masked primary: the headline batch of 32 specs, timed and
    # held against its plain version.
    preps = [eng._plan_scan(spec(newest5, -500_000 - 7 * i))
             for i in range(BATCH)]
    p0 = preps[0]
    plan = flat_agg.make_plan(p0.sig.aggs, p0.sig.preds,
                              tuple(cs.col_id for cs in p0.sig.cols))
    params = np.array([plan.param_row(p.row_lo, p.row_hi, p.read_planes,
                                      p.lits) for p in preps], np.int32)
    masked = p0.trun.dev.arrays
    kernel = measure(plan, plan.plane_table(masked), params, device, bw,
                     rate)
    print("overlay_flat_kernel " + json.dumps(kernel))
    scatter = scatter_ms(eng.runs[0].dev.arrays["valid"], ov5.idx, bw)
    print("overlay_scatter " + json.dumps(scatter))
    torch.cuda.synchronize()
    steady = statistics.median(lat)
    row = dict(setup, card=nvidia_smi(), first_scan_ms=first_ms,
               steady_scan_ms=steady,
               steady_scan_ms_each=lat,
               rows_per_s=versions / (steady / 1e3),
               dirty_keys=len(ov.rows), cleared_rows=int(ov.idx.size),
               delta_apply_ms=delta_ms,
               fifth_wave_dirty_keys=len(ov5.rows), host_fold=fold,
               batch=batch_trace, launches=launches)
    print("overlay_flat " + json.dumps(row))
    row["kernel"], row["scatter"] = kernel, scatter
    return row


def overlay_mvcc(ctx, device, bw: float, rate: float) -> dict:
    """One wave of YCSB A's zipfian updates (``make_update_rows``, the
    history's key popularity, so the hot keys' long groups go dirty) in
    the memtable over the multi-version run: each result held against an
    exact oracle, the resolve and K1 on the masked run held against their
    plain versions and timed, and the resolve on the long-group planes
    with CLEARED_SHARE of their groups cleared."""
    import torch

    from yugabyte_db_tpu_torch import workload
    from yugabyte_db_tpu_torch.ops import flat_agg, mvcc_resolve
    from yugabyte_db_tpu_torch.ops.device_run import DeviceRun
    from yugabyte_db_tpu_torch.utils import planes as P

    eng, schema = ctx.eng, ctx.schema
    t0 = time.perf_counter()
    wave, ht = workload.make_update_rows(schema, ctx.rows, ctx.max_ht,
                                         MVCC_KEYS // 50)
    newest, before = ht + 1, ctx.max_ht + 1
    want = HistoryOracle(schema, ctx.rows, ctx.updates + wave).at(newest)
    gen_s = time.perf_counter() - t0
    eng.apply(wave)
    # The encoded phase compacts the run with the wave and reads it there.
    ctx.wave, ctx.wave_newest, ctx.wave_oracle = wave, newest, want
    trun = eng.runs[0]

    def spec(read, lo):
        return workload.headline_spec(read, lo)

    # The overlay path on the multi-version primary, counted.
    flat_agg.flat_aggregate.launches = 0
    mvcc_resolve.resolve_view.launches = 0
    memtable_scans = eng.memtable_scans
    t = time.perf_counter()
    got = eng.scan(spec(newest, -500_000)).rows[0]
    first_ms = (time.perf_counter() - t) * 1e3
    check(got == want.headline(-500_000),
          f"mvcc overlay first scan {got} != {want.headline(-500_000)}")
    ov = eng._overlay(eng.memtable)
    check(eng._plan_scan(spec(newest, 0)).route == "mv_kernel",
          "the multi-version overlay does not take K1 over a view")
    lat = []
    for _ in range(10):
        t = time.perf_counter()
        eng.scan(spec(newest, -500_000))
        lat.append((time.perf_counter() - t) * 1e3)
    for lo in (-900_000, 0, 400_000):
        check_overlay_scan(eng, spec(newest, lo), want.headline(lo),
                           f"mvcc overlay d >= {lo}")
        check_overlay_scan(eng, spec(before, lo), ctx.before.headline(lo),
                           f"mvcc overlay before the wave, d >= {lo}")
    check_c_aggs(eng, newest, want, "mvcc overlay")
    batch = eng.scan_batch([spec(newest, -500_000 - 7 * i)
                            for i in range(BATCH)])
    for i, r in enumerate(batch):
        check(r.rows[0] == want.headline(-500_000 - 7 * i),
              f"mvcc overlay batch {i}: {r.rows[0]}")
    launches = {"flat_agg": flat_agg.flat_aggregate.launches,
                "mvcc_resolve": mvcc_resolve.resolve_view.launches}
    check(launches["mvcc_resolve"] > 0,
          "the multi-version overlay launched the resolve 0 times")
    check(launches["flat_agg"] > 0,
          "the multi-version overlay launched the flat_agg kernel 0 times")
    check(eng.memtable_scans == memtable_scans,
          "an overlay spec was served by the memtable-only host fold")

    # The resolve and K1 on the masked run, held and timed.
    masked = ov.masked
    hot = trun.crun.max_group_versions
    hot_rows = [k for k, v in ov.rows if len(v) > 32]
    resolve = {}
    for label, rd in (("newest", newest), ("mid", (before + newest) // 2)):
        resolve[label] = measure_resolve(masked.dev.arrays,
                                         masked.resident().const, rd, bw,
                                         rate)
        print(f"overlay_resolve_{label} " + json.dumps(resolve[label]))
    planes = workload.long_group_planes(LONG_ROWS, LONG_R, 7)
    planes, cleared, whole = clear_groups(planes, CLEARED_SHARE)
    check(whole > 0, "no whole-block group cleared")
    long_run = DeviceRun.from_reference_planes(planes, LONG_R, device)
    valid = planes["valid"]
    long_read = int(P.planes_to_u64(planes["ht_hi"][valid],
                                    planes["ht_lo"][valid]).max()) + 1
    resolve["long"] = dict(measure_resolve(
        long_run.arrays, mvcc_resolve.constant_planes(long_run.B, LONG_R,
                                                      device),
        long_read, bw, rate), groups_cleared=cleared,
        whole_block_groups_cleared=whole)
    print("overlay_resolve_long " + json.dumps(resolve["long"]))
    del long_run, planes
    # Byte-exact, untimed: the edges with groups cleared, and R = 4096,
    # where a group of R versions runs past the kernel's tile.
    for label, n_rows, R in RESOLVE_EDGES + (("R4096", 4096 * 128, 4096),):
        planes, cleared, whole = clear_groups(
            workload.long_group_planes(n_rows, R, 8), CLEARED_SHARE)
        arrays = DeviceRun.from_reference_planes(planes, R, device).arrays
        const = mvcc_resolve.constant_planes(n_rows // R, R, device)
        valid = planes["valid"]
        ht = P.planes_to_u64(planes["ht_hi"][valid],
                             planes["ht_lo"][valid]).astype(np.int64)
        for rd in (int(ht.max()) + 1, int(np.median(ht))):
            got = mvcc_resolve.resolve_view(arrays, *read_params(rd), const)
            want = mvcc_resolve.resolve_view_plain(arrays, *read_params(rd),
                                                   const)
            check(view_diff(got, want) == 0,
                  f"cleared resolve edge {label} at {rd}: kernel != plain "
                  "version")
        check(whole > 0, f"cleared edge {label}: no whole block cleared")
        print(f"overlay_resolve_edge {label}: {n_rows} rows, R = {R}, "
              f"{cleared} groups cleared, {whole} of them whole blocks, "
              "newest and mid, exact")
        del arrays, const, got, want
    preps = [eng._plan_scan(spec(newest, -500_000 - 7 * i))
             for i in range(BATCH)]
    p0 = preps[0]
    plan = flat_agg.make_plan(p0.sig.aggs, p0.sig.preds,
                              tuple(cs.col_id for cs in p0.sig.cols))
    params = np.array([plan.param_row(p.row_lo, p.row_hi, p.read_planes,
                                      p.lits) for p in preps], np.int32)
    kernel = measure(plan, plan.plane_table(p0.arrays()), params, device, bw,
                     rate)
    print("overlay_mvcc_kernel " + json.dumps(kernel))
    scatter = scatter_ms(trun.dev.arrays["valid"], ov.idx, bw)
    print("overlay_mvcc_scatter " + json.dumps(scatter))
    fold = host_fold_ms(eng, lambda lo: spec(newest, lo))
    torch.cuda.synchronize()
    steady = statistics.median(lat)
    versions = trun.crun.num_versions + eng.memtable.num_versions
    row = {"card": nvidia_smi(), "wave": len(wave),
           "generate_and_oracle_s": gen_s,
           "max_group_versions": hot, "dirty_keys": len(ov.rows),
           "dirty_keys_over_32_versions": len(hot_rows),
           "cleared_rows": int(ov.idx.size), "versions": versions,
           "first_scan_ms": first_ms, "steady_scan_ms": steady,
           "steady_scan_ms_each": lat,
           "rows_per_s": versions / (steady / 1e3), "host_fold": fold,
           "launches": launches}
    print("overlay_mvcc " + json.dumps(row))
    row.update(kernel=kernel, scatter=scatter, resolve=resolve)
    return row


def overlay_phase(device, bw: float, rate: float, flat=None,
                  mvcc=None) -> dict:
    """Post-write scans on the flat primary (``flat``: ``flat_engine``'s
    namespace, after the engine phase) and on the multi-version one
    (``mvcc``: ``mvcc_phase``'s namespace); without them, both engines
    are built here."""
    if flat is None:
        flat = flat_engine(device)
    out = {"flat": overlay_flat(flat, device, bw, rate)}
    if mvcc is None:
        schema, rows, updates, _l, max_ht, eng, _g, _a = mvcc_engine(device)
        history = HistoryOracle(schema, rows, updates)
        mvcc = SimpleNamespace(schema=schema, rows=rows, updates=updates,
                               max_ht=max_ht, eng=eng, history=history,
                               before=history.at(max_ht + 1))
    out["mvcc"] = overlay_mvcc(mvcc, device, bw, rate)
    return out


# -- phase 5 and 7: row scans (K7 and K9) ------------------------------------

YCSB_BATCHES = 2     # batches a pipelined run, at depth 6 (bench_ycsb_e: 6)
YCSB_REPS = 3        # pipelined runs a configuration; the median is kept
SELECTIVE_LO = 980_000  # d >= this: about 1% of the rows
SUPERSET_KEYS = 100_000
SUPERSET_PAGES = 32
SOURCE_PAGES = 64
SOURCE_GROUP_KEYS = 20_000  # keys of the grouped scan over several sources
# (the row scan merges each candidate key in Python, ~33 us a key: the
# whole table would take ~33 s)
WIDE_SCAN_SHARE = 50  # the wide scan reads where 1 key in 50 was written
K7_SPILL_CEILING = 0  # bytes of spill stores, and of loads, K7 and K9 may
                      # have (ptxas must also report no stack frame)
ROW_OPS = 48  # integer operations a walked row's resolve needs (flags,
              # visibility, expiry, existence, bounds, predicates, ranks)
FLOAT_CHOICES = (0.5, 1.25, -3.0, 7.75, 0.1, 16777216.0, 16777217.0, 0.0)
STRING_CHOICES = ("xy", "xyz", "zz", "commonprefix-aa", "commonprefix-ab")


class SmokePred:
    """One predicate of the rows phase: its exact test on a merged value
    and the device's superset test (an 8-byte prefix for strings, float32
    rounding for floats)."""

    def __init__(self, column: str, op: str, value, kind: str):
        self.column, self.op, self.value, self.kind = column, op, value, kind

    def spec(self):
        from yugabyte_db_tpu_torch.storage import Predicate

        return Predicate(self.column, self.op, self.value)

    def real(self, v) -> bool:
        return self.spec().matches(v)

    def superset(self, v) -> bool:
        if v is None:
            return False
        if self.kind == "f32":
            a, b = np.float32(v), np.float32(self.value)
            return {"=": a == b, "!=": True, "<": a <= b, "<=": a <= b,
                    ">": a >= b, ">=": a >= b}[self.op]
        if self.kind == "str":
            a = v.encode()[:8].ljust(8, b"\0")
            b = self.value.encode()[:8].ljust(8, b"\0")
            return {"=": a == b, "!=": True, "<": a <= b, "<=": a <= b,
                    ">": a >= b, ">=": a >= b}[self.op]
        return self.real(v)


def merge_groups(schema, groups, read_ht: int, columns, part: int,
                 parts: int) -> tuple:
    """The ``part``-th of ``parts`` slices of a run's single-version and
    multi-version key groups (``RunOracle.at_reads``' ``groups``) merged
    at ``read_ht``: (exists of the singles, their values by column name,
    exists of the others, their values by column name)."""
    from yugabyte_db_tpu_torch.storage.merge import merge_versions

    cid = {c.name: c.col_id for c in schema.value_columns}
    _keys, _starts, (_idx, vs), multis = groups
    vs = vs[part * len(vs) // parts:(part + 1) * len(vs) // parts]
    multis = multis[part * len(multis) // parts:
                    (part + 1) * len(multis) // parts]
    # One version and no TTL: the merge's rule inline.
    ok = [not v.tombstone and v.ht <= read_ht and
          (v.liveness or any(x is not None for x in v.columns.values()))
          for v in vs]
    vals = {name: [v.columns.get(cid[name]) if o else None
                   for v, o in zip(vs, ok)] for name in columns}
    exists, mvals = [], {name: [] for name in columns}
    for _i, key, versions in multis:
        m = merge_versions(key, versions, read_ht)
        exists.append(m.exists)
        for name in columns:
            mvals[name].append(m.get(cid[name]) if m.exists else None)
    return ok, vals, exists, mvals


_FORKED_GROUPS = None  # (schema, groups, columns) a forked merge reads


def _forked_groups(job: tuple) -> tuple:
    read_ht, part = job
    schema, groups, columns = _FORKED_GROUPS
    return merge_groups(schema, groups, read_ht, columns, part,
                        ORACLE_PROCS)


class RunOracle:
    """A run's key groups merged at one read point, from the run's own
    host rows (key, versions) with the port's ``merge_versions`` (a
    single version without a TTL merged inline, by the same rule) and
    ``RowMaterializer``: each group's key, first row, whether it exists,
    and its values by column name. ``key_vals``: each key's key-column
    values as the generator wrote them (else decoded). ``merged``: the
    groups' (exists, values by column name), ``merge_groups``' parts."""

    def __init__(self, schema, crun, groups, read_ht: int, columns,
                 key_vals=None, merged=None):
        from yugabyte_db_tpu_torch.storage.cpu_engine import RowMaterializer

        self.schema, self.crun, self.R = schema, crun, crun.R
        self.mat = RowMaterializer(schema)
        self.key_vals = key_vals
        self.key_pos = {c.name: j for j, c in enumerate(schema.key_columns)}
        self.keys, self.starts, singles, multis = groups
        if merged is None:
            merged = [merge_groups(schema, groups, read_ht, columns, 0, 1)]
        exists = np.zeros(len(self.keys), bool)
        cols = {name: np.empty(len(self.keys), object) for name in columns}
        one = np.asarray(singles[0], np.int64)
        many = np.fromiter((i for i, _k, _v in multis), np.int64,
                           len(multis))
        exists[one] = [o for part in merged for o in part[0]]
        exists[many] = [e for part in merged for e in part[2]]
        for name in columns:
            cols[name][one] = [v for part in merged for v in part[1][name]]
            cols[name][many] = [v for part in merged
                                for v in part[3][name]]
        self.vals = {name: v.tolist() for name, v in cols.items()}
        self.exists = exists
        self.cum_exists = np.concatenate([[0], np.cumsum(self.exists)])
        self._masks: dict = {}

    @classmethod
    def at_reads(cls, schema, crun, reads, columns, key_vals=None) -> list:
        """One oracle a read point of ``reads``, the run's key groups
        read once: every valid row's key and version in run order, a
        group wherever the key changes; each read point's merges (pure
        Python, no device) in ORACLE_PROCS slices of the groups, spread
        over as many forked processes."""
        import multiprocessing

        global _FORKED_GROUPS
        keys, versions, rows = [], [], []
        for b in range(crun.B):
            n = crun.blocks[b].num_valid
            keys.append(crun.row_keys[b][:n])
            versions.append(crun.row_versions[b][:n])
            rows.append(b * crun.R + np.arange(n, dtype=np.int64))
        keys = np.concatenate(keys)
        versions = np.concatenate(versions)
        rows = np.concatenate(rows)
        first = np.ones(len(keys), bool)
        first[1:] = keys[1:] != keys[:-1]
        starts = np.nonzero(first)[0]
        ends = np.append(starts[1:], len(keys))
        one = (ends - starts) == 1
        ttl = np.fromiter((v.has_ttl for v in versions[starts]), bool,
                          len(starts))
        single = np.nonzero(one & ~ttl)[0]
        multis = [(int(i), keys[starts[i]],
                   list(versions[starts[i]:ends[i]]))
                  for i in np.nonzero(~(one & ~ttl))[0]]
        groups = (keys[starts].tolist(), rows[starts],
                  (single, versions[starts[single]].tolist()), multis)
        jobs = [(rd, k) for rd in reads for k in range(ORACLE_PROCS)]
        _FORKED_GROUPS = (schema, groups, tuple(columns))
        try:
            with multiprocessing.get_context("fork").Pool(
                    ORACLE_PROCS) as pool:
                parts = pool.map(_forked_groups, jobs, chunksize=1)
        finally:
            _FORKED_GROUPS = None
        return [cls(schema, crun, groups, rd, columns, key_vals,
                    parts[j * ORACLE_PROCS:(j + 1) * ORACLE_PROCS])
                for j, rd in enumerate(reads)]

    def row(self, i: int, projection) -> tuple:
        key = self.keys[i]
        kv = (self.key_vals[key] if self.key_vals is not None
              else self.mat.key_values(key))
        return tuple(kv[self.key_pos[nm]] if nm in self.key_pos
                     else self.vals[nm][i] for nm in projection)

    def mask(self, preds, superset: bool = False) -> tuple:
        """(mask, indexes) of the groups that exist and pass ``preds``
        (or their superset tests), cached."""
        key = (tuple((p.column, p.op, p.value) for p in preds), superset)
        if key not in self._masks:
            m = self.exists.copy()
            for p in preds:
                test = p.superset if superset else p.real
                m &= np.fromiter(map(test, self.vals[p.column]), bool,
                                 len(self.keys))
            self._masks[key] = (m, np.nonzero(m)[0])
        return self._masks[key]

    def page(self, spec, preds, route: str, M: int = 0) -> tuple:
        """(rows, resume key, rows_scanned) of the spec on ``route``:
        "page" (the host page index: existing rows through the last row
        taken), "chunks" (every window of the range) or "gather" (K7's
        window walk: it stops after the window that holds the M-th
        superset match, the host takes the real matches of the buffer,
        and a full buffer continues after its last row)."""
        i0 = bisect.bisect_left(self.keys, spec.lower)
        i1 = (bisect.bisect_left(self.keys, spec.upper) if spec.upper
              else len(self.keys))
        row_lo = self.crun.lower_row(spec.lower)
        row_hi = self.crun.upper_row(spec.upper)
        proj, limit = spec.projection, spec.limit
        real, real_idx = self.mask(preds)
        cum = self.cum_exists
        if route in ("page", "chunks"):
            take = real_idx[np.searchsorted(real_idx, i0):
                            np.searchsorted(real_idx, i1)]
            take = take[:limit] if limit is not None else take
            hit = limit is not None and len(take) >= limit > 0
            if route == "page":
                hi = (int(take[-1]) + 1 if len(take) else i1)
                scanned = int(cum[hi] - cum[i0])
            else:
                scanned = int(cum[i1] - cum[i0])
            resume = self.keys[take[-1]] + b"\0" if hit else None
            return [self.row(i, proj) for i in take.tolist()], resume, \
                scanned
        sup_idx = self.mask(preds, superset=True)[1]
        KR = 8 * self.R
        w_last = (row_hi - 1) // KR
        rows, scanned, lo, scan_from = [], 0, row_lo, row_lo
        while True:
            a = int(np.searchsorted(self.starts, lo))
            end_range = int(np.searchsorted(self.starts, row_hi))
            j = int(np.searchsorted(sup_idx, a))
            if j + M - 1 < len(sup_idx) and sup_idx[j + M - 1] < end_range:
                w_end = int(self.starts[sup_idx[j + M - 1]]) // KR + 1
            else:
                w_end = w_last + 1
            e = min(int(np.searchsorted(self.starts, w_end * KR)), end_range)
            count = int(np.searchsorted(sup_idx, e)) - j
            f = max(a, int(np.searchsorted(self.starts, scan_from)))
            scanned += int(cum[e] - cum[min(f, e)])
            buf = sup_idx[j:j + min(count, M)].tolist()
            for i in buf:
                if not real[i]:
                    continue
                rows.append(self.row(i, proj))
                if limit is not None and len(rows) >= limit:
                    return rows, self.keys[i] + b"\0", scanned
            if count <= M and w_end > w_last:
                return rows, None, scanned
            nxt = (int(self.starts[buf[-1]]) + 1 if count > M
                   else max(lo, w_end * KR))
            if nxt >= row_hi:
                return rows, None, scanned
            lo, scan_from = nxt, max(nxt, w_end * KR)


def check_page(got, want, label: str) -> None:
    rows, resume, scanned = want
    check(got.rows == rows, f"{label}: rows differ from the oracle's "
          f"({len(got.rows)} against {len(rows)})")
    check(got.resume_key == resume, f"{label}: resume key")
    check(got.rows_scanned == scanned,
          f"{label}: rows_scanned {got.rows_scanned} != {scanned}")


class LaunchLog:
    """The engine's row path with every K7 and K9 launch recorded (its
    signature, planes, parameters and output), to be held byte for byte
    against the plain versions after the timed runs: the row path module
    reads ``row_gather`` through this proxy."""

    def __init__(self):
        from yugabyte_db_tpu_torch.ops import row_gather

        self.rg = row_gather
        self.gathers, self.cands = [], []
        self.record = True

        def gather(sig, run, ip, fp):
            out = row_gather.gather_rows(sig, run, ip, fp)
            if self.record:
                self.gathers.append((sig, run, ip, fp, out))
            return out

        def cands(sig, run, ip, fp, n):
            out = row_gather.scan_candidates(sig, run, ip, fp, n)
            if self.record:
                self.cands.append((sig, run, ip, fp, n, out))
            return out

        self.proxy = SimpleNamespace(**vars(row_gather))
        self.proxy.gather_rows, self.proxy.scan_candidates = gather, cands

    def __enter__(self):
        from yugabyte_db_tpu_torch.storage import gpu_rows

        gpu_rows.row_gather = self.proxy
        return self

    def __exit__(self, *exc):
        from yugabyte_db_tpu_torch.storage import gpu_rows

        gpu_rows.row_gather = self.rg

    def verify(self) -> dict:
        """Every recorded launch against its plain version: the number of
        launches held and the largest |difference| (0: byte for byte)."""
        import torch

        err = 0
        for sig, run, ip, fp, out in self.gathers:
            want = self.rg.gather_rows_plain(sig, run, ip, fp)
            err = max(err, int((out.long() - want.long()).abs().max()))
        for sig, run, ip, fp, n, out in self.cands:
            want = self.rg.scan_candidates_plain(sig, run, ip, fp, n)
            for a, b in zip(out, want):
                err = max(err, int((a.long() - b.long()).abs().max()))
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        check(err == 0, f"a row-path kernel differs from its plain version "
                        f"by {err}")
        n = (len(self.gathers), len(self.cands))
        self.gathers, self.cands = [], []
        return {"gather_rows": n[0], "scan_candidates": n[1],
                "max_abs_err": err}


def row_bound(kind: str, launch, bw: float, rate: float) -> dict:
    """The least time of one recorded launch: its bytes (``gather_bytes``
    / ``candidates_bytes``) over the card's bandwidth, or ROW_OPS a
    walked row over its integer rate, whichever is larger."""
    rg = __import__("yugabyte_db_tpu_torch.ops.row_gather",
                    fromlist=["x"])
    if kind == "gather":
        sig, run, ip, _fp, out = launch
        ipn, outn = ip.cpu().numpy(), out.cpu().numpy()
        nbytes = rg.gather_bytes(sig, run, ipn, outn)
        walked = (np.maximum(outn[:, sig.M, 2] - ipn[:, 0], 0).sum()
                  if sig.packed else ipn.shape[0])
    else:
        sig, run, _ip, _fp, n, _out = launch
        nbytes = rg.candidates_bytes(sig, run, n)
        walked = n
    ops = float(walked) * sig.K * sig.R * ROW_OPS
    t_bytes, t_ops = nbytes / bw * 1e3, ops / rate * 1e3
    return {"bytes": int(nbytes), "operations": ops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def time_launch(kind: str, launch, bw: float, rate: float) -> dict:
    """One recorded launch timed (CUDA events, median of 12, the calls
    queued behind a sleeping kernel: a launch of a few windows takes less
    device time than its wrapper takes on the host) beside its plain
    version (median of 3) and its bound; ``geometry`` is the shape the
    library reports for the timed launch, which must be the one
    ``launch_geometry`` mirrors."""
    from yugabyte_db_tpu_torch.ops import row_gather as rg

    if kind == "gather":
        sig, run, ip, fp, _out = launch
        ms = cuda_ms(lambda: rg.gather_rows(sig, run, ip, fp), KERNEL_REPS,
                     queue_ahead=True)
        launched, G = rg.last_launch(), int(ip.shape[0])
        plain = cuda_ms(lambda: rg.gather_rows_plain(sig, run, ip, fp),
                        PLAIN_REPS)
        shape = {"pages": G, "M": sig.M, "flat": sig.flat,
                 "packed": sig.packed}
    else:
        sig, run, ip, fp, G, _out = launch
        ms = cuda_ms(lambda: rg.scan_candidates(sig, run, ip, fp, G),
                     KERNEL_REPS, queue_ahead=True)
        launched = rg.last_launch()
        plain = cuda_ms(lambda: rg.scan_candidates_plain(sig, run, ip, fp,
                                                         G), PLAIN_REPS)
        shape = {"windows": G, "flat": sig.flat,
                 "apply_preds": sig.apply_preds}
    check(launched == rg.launch_geometry(sig, G),
          f"{kind} launched {launched}, launch_geometry says "
          f"{rg.launch_geometry(sig, G)}")
    return dict(shape, geometry=launched, ms=ms, plain_ms=plain,
                library_ms=None, **row_bound(kind, launch, bw, rate))


def pipelined_ms(eng, batches) -> tuple:
    """``bench_ycsb_e``'s pipeline (``scan_batch_async`` at depth DEPTH)
    over ``batches``: (its results, ms a batch)."""
    import torch

    torch.cuda.synchronize() if torch.cuda.is_available() else None
    t0 = time.perf_counter()
    results = run_pipelined(eng, batches)
    return results, (time.perf_counter() - t0) * 1e3 / len(batches)


def ycsb_e(eng, oracle, route: str, read_ht: int, label: str, seed: int,
           log: LaunchLog) -> dict:
    """YCSB-E batches of LIMIT-100 pages from random keys: every page of
    YCSB_BATCHES batches held against the oracle, then YCSB_REPS timed
    pipelined runs of them (median ms a batch, pages a second). Returns
    them and the first batch's K7 launch (None on host pages)."""
    from yugabyte_db_tpu_torch import workload

    rng = random.Random(seed)
    n_keys = len(oracle.keys)
    batches = [workload.ycsb_e_batch(eng.schema, ENGINE_KEYS, read_ht, rng)
               for _ in range(YCSB_BATCHES)]
    preds = [SmokePred("d", ">=", -500_000, "i32")]
    first = len(log.gathers)
    results, _ms = pipelined_ms(eng, batches)  # checked, and warm
    k7_launch = log.gathers[first] if len(log.gathers) > first else None
    for b, (specs, res) in enumerate(zip(batches, results)):
        for j, (s, r) in enumerate(zip(specs, res)):
            check_page(r, oracle.page(s, preds, route, 104),
                       f"{label} batch {b} page {j}")
    times = []
    for _ in range(YCSB_REPS):
        _r, ms = pipelined_ms(eng, batches)
        times.append(ms)
    ms = statistics.median(times)
    row = {"route": route, "keys": n_keys, "batch_ms": ms,
           "batch_ms_each": times,
           "pages_per_s": workload.YCSB_E_PAGES / (ms / 1e3),
           "rows_per_page": statistics.mean(len(r.rows) for res in results
                                            for r in res),
           "rows_scanned_per_page": statistics.mean(
               r.rows_scanned for res in results for r in res)}
    return row, k7_launch


def scan_rows_per_s(eng, spec, oracle, preds, route, label, M=0) -> dict:
    """One scan checked against the oracle, then timed (median of 3 host
    clocks): rows a second and its gather rounds."""
    import torch

    want = oracle.page(spec, preds, route, M)
    check_page(eng.scan(spec), want, label)
    times = []
    for _ in range(3):
        torch.cuda.synchronize() if torch.cuda.is_available() else None
        t = time.perf_counter()
        eng.scan(spec)
        times.append((time.perf_counter() - t) * 1e3)
    ms = statistics.median(times)
    return {"rows": len(want[0]), "rows_scanned": want[2], "ms": ms,
            "ms_each": times, "rows_per_s": len(want[0]) / (ms / 1e3),
            "scanned_rows_per_s": want[2] / (ms / 1e3)}


def superset_engine(device):
    """A table of SUPERSET_KEYS keys with a STRING and a FLOAT value
    column (the bench table has neither), applied and flushed into one
    flat run: the pages whose predicates the device can only narrow
    down."""
    from yugabyte_db_tpu_torch.models.datatypes import DataType
    from yugabyte_db_tpu_torch.models.partition import compute_hash_code
    from yugabyte_db_tpu_torch.models.schema import (ColumnKind,
                                                     ColumnSchema, Schema)
    from yugabyte_db_tpu_torch.storage import make_engine
    from yugabyte_db_tpu_torch.storage.row_version import RowVersion

    schema = Schema([
        ColumnSchema("k", DataType.STRING, ColumnKind.HASH),
        ColumnSchema("a", DataType.INT64), ColumnSchema("b", DataType.STRING),
        ColumnSchema("f", DataType.FLOAT), ColumnSchema("d", DataType.INT32),
    ], table_id="superset")
    cid = {c.name: c.col_id for c in schema.columns}
    rng = random.Random(17)
    rows = []
    for i in range(SUPERSET_KEYS):
        key = schema.encode_primary_key(
            {"k": f"user{i:06d}"},
            compute_hash_code(schema, {"k": f"user{i:06d}"}))
        rows.append(RowVersion(key, ht=100 + i, liveness=True, columns={
            cid["a"]: rng.randrange(-10**12, 10**12),
            cid["b"]: rng.choice(STRING_CHOICES),
            cid["f"]: rng.choice(FLOAT_CHOICES),
            cid["d"]: rng.randrange(-10**6, 10**6)}))
    eng = make_engine("gpu", schema, {"rows_per_block": 2048,
                                      "device": device})
    eng.apply(rows)
    flush(eng, "rows")
    return eng, 100 + SUPERSET_KEYS


def row_ptxas() -> dict:
    """K7's and K9's entries (``gather_kernel``, ``candidates_kernel``) as
    ptxas reported them in this process's build: registers, stack frame
    and spills; fails on spills past K7_SPILL_CEILING or on a stack frame.
    "not measured" where the library was built by an earlier process."""
    usage = ptxas_usage("row_gather")
    if not usage:
        return {"ptxas": "not measured"}
    out = {}
    for key, name in (("k7", "gather_kernel"), ("k9", "candidates_kernel")):
        found = [u for u in usage if name in u["function"]]
        check(bool(found), f"ptxas reported no {name}: {usage}")
        for u in found:
            spill = max(u.get("spill_store_bytes", 0),
                        u.get("spill_load_bytes", 0))
            check(spill <= K7_SPILL_CEILING,
                  f"{name}'s build spills {spill} bytes, past the ceiling "
                  f"of {K7_SPILL_CEILING}: {u}")
            check(u.get("stack_bytes", 0) == 0,
                  f"{name}'s build has a stack frame: {u}")
        out[key] = found
    return dict(out, spill_ceiling_bytes=K7_SPILL_CEILING)


# Geometries of the edge planes (label, R, K, windows, flat): K of 1, 2, 8
# and 12 (two run blocks a block of the cluster), R not a multiple of 16
# (staged row by row), the main path's R = 2048 with groups filling whole
# blocks, and R = 4096 (staged in pieces, groups crossing them).
ROW_EDGE_CASES = (("R64_K1", 64, 1, 4, False), ("R64_K2", 64, 2, 4, False),
                  ("R64_K8", 64, 8, 3, False), ("R64_K8_flat", 64, 8, 3, True),
                  ("R48_K8", 48, 8, 2, False), ("R100_K2", 100, 2, 3, False),
                  ("R64_K12", 64, 12, 2, False),
                  ("R2048_K8", 2048, 8, 2, False),
                  ("R4096_K2", 4096, 2, 2, False))
ROW_EDGE_PREDS = ((), (("a", ">=", -10**11),),
                  (("d", "<", 300_000), ("c", "!=", 5.0),
                   ("a", ">=", -10**11)))


def edge_sigs(R: int, K: int, B: int, flat: bool, preds, M: int,
              packed: bool = True, apply_preds: bool = True) -> tuple:
    """``workload.row_edge_sigs`` with the port's signatures."""
    from yugabyte_db_tpu_torch import workload
    from yugabyte_db_tpu_torch.ops import row_gather as rg
    from yugabyte_db_tpu_torch.ops import scan as S

    return workload.row_edge_sigs(S, rg, B, R, K, flat, preds, M,
                                  packed=packed, apply_preds=apply_preds)


def rows_edges(device) -> dict:
    """K7 (paged and chunks) and K9 on ``workload.row_edge_planes`` (groups
    of 1 to R versions straddling warp steps, tombstone ties, cleared
    groups, column d unset in each window's last block, stand-in rows with
    their own planes) at each geometry of ROW_EDGE_CASES, under each
    predicate set of ROW_EDGE_PREDS, each launch held byte for byte
    against its plain version. K7 paged at M = 1, at the M whose M-th
    match is the first window's last (in its last run block where that
    block has a match) and at 104, over pages that walk several windows,
    start and count (``scan_from``) inside windows, or walk one; chunks
    mode on every window; K9 over every window and over the last alone,
    predicates applied and not."""
    import torch

    from yugabyte_db_tpu_torch import workload
    from yugabyte_db_tpu_torch.ops import row_gather as rg
    from yugabyte_db_tpu_torch.ops.device_run import DeviceRun

    t0 = time.perf_counter()
    launches, in_last_block, cases = 0, 0, {}

    def params(pages, ints):
        rows = [rg.pack_params(wf, wl, lo, hi, read_params(rd), ints, [],
                               scan_from=sf)
                for wf, wl, lo, hi, rd, sf in pages]
        return (torch.from_numpy(np.stack([r[i] for r in rows])).to(device)
                for i in (0, 1))

    def held(got, want, what):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"rows edge {what}: kernel != plain version")

    for label, R, K, windows, flat in ROW_EDGE_CASES:
        n_rows, N = windows * K * R, K * R
        B, last = n_rows // R, windows - 1
        planes = workload.row_edge_planes(n_rows, R, K, seed=R + K,
                                          flat=flat)
        run = DeviceRun.from_reference_planes(planes, R, device).arrays
        reads = workload.row_edge_reads(planes)
        newest = reads[0]
        pages = workload.row_edge_pages(R, K, windows, reads)
        row_lo, row_hi, k9_read = pages["candidates"]
        m_last = {}
        for k, preds in enumerate(ROW_EDGE_PREDS):
            sig, _s, ints = edge_sigs(R, K, B, flat, preds, N)
            ip, fp = params([(0, 0, 0, N, newest, None)], ints)
            first = rg.gather_rows_plain(sig, run, ip, fp)
            m = int(first[0, N, 0])
            m_last[k] = m
            if m and int(first[0, m - 1, 0]) >= (K - 1) * R:
                in_last_block += 1
            for M in sorted({1, max(m, 1), 104}):
                sig = edge_sigs(R, K, B, flat, preds, M)[0]
                ip, fp = params(pages["paged"], ints)
                held([rg.gather_rows(sig, run, ip, fp)],
                     [rg.gather_rows_plain(sig, run, ip, fp)],
                     f"{label} paged M = {M}, preds {preds}")
                launches += 1
            sig = edge_sigs(R, K, B, flat, preds, N, packed=False)[0]
            ip, fp = params(pages["chunks"], ints)
            held([rg.gather_rows(sig, run, ip, fp)],
                 [rg.gather_rows_plain(sig, run, ip, fp)],
                 f"{label} chunks, preds {preds}")
            launches += 1
            for apply_preds in (True, False):
                ssig, ints = edge_sigs(R, K, B, flat, preds, 1,
                                       apply_preds=apply_preds)[1:]
                for wf, n in ((0, windows), (last, 1)):
                    ip, fp = (t[0] for t in params(
                        [(wf, last, row_lo, row_hi, k9_read, None)], ints))
                    held(rg.scan_candidates(ssig, run, ip, fp, n),
                         rg.scan_candidates_plain(ssig, run, ip, fp, n),
                         f"{label} candidates of {n} windows, preds {preds}, "
                         f"apply {apply_preds}")
                    launches += 1
        cases[label] = {"rows": n_rows, "R": R, "K": K, "flat": flat,
                        "m_last": m_last}
    check(in_last_block > 0, "no edge case put a page's M-th match in a "
                             "window's last run block")
    return {"cases": cases, "launches": launches,
            "m_last_in_last_run_block": in_last_block,
            "s": time.perf_counter() - t0}


def rows_phase(device, bw: float, rate: float, flat, mvcc) -> dict:
    """Row scans on one run: YCSB-E batches on the flat run (host pages)
    and on the multi-version run through K7 (newest and mid read points),
    a full range scan of each run (chunks), a selective paged scan with
    continuation rounds, and superset-predicate pages; every page against
    the oracle, every K7 launch byte for byte against its plain version.
    ``flat`` / ``mvcc``: the engine and mvcc phases' namespaces."""
    import torch

    from yugabyte_db_tpu_torch.ops import row_gather as rg
    from yugabyte_db_tpu_torch.storage import ScanSpec

    t_phase = time.perf_counter()
    out = {"card": nvidia_smi()}
    fe, me = flat.eng, mvcc.eng
    newest_f = flat.max_ht + 1
    newest_m = mvcc.max_ht + 1
    mid_m = (max(r.ht for r in mvcc.rows) + mvcc.max_ht) // 2
    t0 = time.perf_counter()
    cols = ("a", "c", "d")
    # Both runs hold make_rows' keys: key i is (user%06d, i % 7).
    kv = {r.key: [f"user{i:06d}", i % 7] for i, r in enumerate(flat.rows)}
    oracles = {"flat": RunOracle.at_reads(flat.schema, fe.runs[0].crun,
                                          [newest_f], cols, kv)[0]}
    oracles["mv_newest"], oracles["mv_mid"] = RunOracle.at_reads(
        mvcc.schema, me.runs[0].crun, [newest_m, mid_m], cols, kv)
    out["oracle_s"] = time.perf_counter() - t0
    rg.gather_rows.launches = rg.scan_candidates.launches = 0
    log = LaunchLog()
    parts = {}  # seconds of each part of the phase
    with log:
        t0 = time.perf_counter()
        ycsb, k7_launches, chunk_launches = {}, {}, {}
        for label, eng, oracle, route, rd in (
                ("flat", fe, oracles["flat"], "page", newest_f),
                ("mv_newest", me, oracles["mv_newest"], "gather", newest_m),
                ("mv_mid", me, oracles["mv_mid"], "gather", mid_m)):
            ycsb[label], k7_launches[label] = ycsb_e(
                eng, oracle, route, rd, f"ycsb_e {label}", 11, log)
        check(k7_launches["flat"] is None,
              "a flat-run YCSB-E page launched K7 (host pages expected)")
        out["ycsb_e"] = ycsb
        held = log.verify()
        parts["ycsb_e_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        proj = ["k", "r", "a", "d"]
        full = {}
        for label, eng, oracle, rd in (
                ("flat", fe, oracles["flat"], newest_f),
                ("mv", me, oracles["mv_newest"], newest_m)):
            full[label] = scan_rows_per_s(
                eng, ScanSpec(read_ht=rd, projection=proj), oracle, [],
                "chunks", f"full scan {label}")
            chunk_launches[label] = log.gathers[-1]
        out["full_scan"] = full
        held_full = log.verify()
        parts["full_scan_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        pred = SmokePred("d", ">=", SELECTIVE_LO, "i32")
        sel = scan_rows_per_s(
            fe, ScanSpec(read_ht=newest_f, projection=proj,
                         predicates=[pred.spec()]),
            oracles["flat"], [pred], "gather", "selective scan", 4096)
        sel["rounds"] = len(log.gathers) // 4  # 1 checked + 3 timed scans
        check(sel["rounds"] > 1, "the selective scan took one round")
        print("rows_selective " + json.dumps(sel))
        out["selective"] = sel
        held_sel = log.verify()
        parts["selective_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        seng, s_read = superset_engine(device)
        parts["superset_table_s"] = time.perf_counter() - t0
        s_oracle = RunOracle.at_reads(seng.schema, seng.runs[0].crun,
                                      [s_read], ("a", "b", "f", "d"))[0]
        rng = random.Random(5)
        sup = {}
        for label, p in (("str", SmokePred("b", "=", "commonprefix-ab",
                                           "str")),
                         ("f32", SmokePred("f", "<", 1.25, "f32"))):
            specs = []
            for _ in range(SUPERSET_PAGES):
                k = s_oracle.keys[rng.randrange(len(s_oracle.keys))]
                specs.append(ScanSpec(lower=k, read_ht=s_read, limit=100,
                                      predicates=[p.spec()],
                                      projection=["k", "b", "f", "d"]))
            res, ms = pipelined_ms(seng, [specs])
            for j, (s, r) in enumerate(zip(specs, res[0])):
                check_page(r, s_oracle.page(s, [p], "gather", 4096),
                           f"superset {label} page {j}")
            sup[label] = {"pages": SUPERSET_PAGES, "batch_ms": ms,
                          "superset_share": float(np.mean([
                              p.superset(v) for v in s_oracle.vals[p.column]
                          ])), "real_share": float(np.mean([
                              p.real(v) for v in s_oracle.vals[p.column]]))}
        print("rows_superset " + json.dumps(sup))
        out["superset"] = sup
        held_sup = log.verify()
        parts["superset_pages_s"] = (time.perf_counter() - t0
                                     - parts["superset_table_s"])
        launches = {"gather_rows": rg.gather_rows.launches,
                    "scan_candidates": rg.scan_candidates.launches}
    check(launches["gather_rows"] > 0, "the row path launched K7 0 times")
    out["held"] = [held, held_full, held_sel, held_sup]
    # Outside the counted run: K7 alone at the path's shapes.
    t0 = time.perf_counter()
    out["k7"] = time_launch("gather", k7_launches["mv_newest"], bw, rate)
    out["k7"]["mid"] = time_launch("gather", k7_launches["mv_mid"], bw,
                                   rate)
    for label in ("mv_newest", "mv_mid"):
        k7 = out["k7"] if label == "mv_newest" else out["k7"]["mid"]
        ycsb[label].update(k7_ms=k7["ms"],
                           k7_share=k7["ms"] / ycsb[label]["batch_ms"])
    ycsb["flat"].update(k7_ms=None, k7_share=0.0)
    for label, launch in chunk_launches.items():
        full[label]["k7_chunks_launch"] = time_launch("gather", launch, bw,
                                                      rate)
    parts["k7_timing_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["edges"] = rows_edges(device)
    print("rows_edges " + json.dumps(out["edges"]))
    parts["rows_edges_s"] = time.perf_counter() - t0
    out["parts_s"] = parts
    out["row_ptxas"] = row_ptxas()
    for label in ycsb:
        print(f"rows_ycsb_e_{label} " + json.dumps(ycsb[label]))
    for label in full:
        print(f"rows_full_scan_{label} " + json.dumps(full[label]))
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    del seng
    torch.cuda.synchronize() if torch.cuda.is_available() else None
    print("rows " + json.dumps({k: v for k, v in out.items()
                                if k in ("card", "oracle_s", "parts_s", "held",
                                         "k7", "row_ptxas", "launches",
                                         "phase_s")}))
    return out


class SourcesOracle:
    """The flat engine after the overlay phase: the base rows and every
    wave, merged per key at one read point over all sources (the row
    scan's rows), and per source whether the key exists there alone (a
    run's K9 candidates) or is in the memtable (every memtable key in
    range is a candidate)."""

    def __init__(self, schema, eng, base_rows, read_ht: int):
        from yugabyte_db_tpu_torch.storage.cpu_engine import RowMaterializer
        from yugabyte_db_tpu_torch.storage.merge import merge_versions

        self.mat = RowMaterializer(schema)
        self.schema = schema
        self.cid = {c.name: c.col_id for c in schema.value_columns}
        self.keys = sorted(r.key for r in base_rows)
        self.read_ht = read_ht
        self.merge = merge_versions
        self.base = {r.key: r for r in base_rows}
        self.extra = [{} for _ in eng.runs[1:]]
        for src, t in zip(self.extra, eng.runs[1:]):
            for key, versions in t.crun.iter_entries():
                src[key] = versions
        self.mem = {}
        for key in eng.memtable.scan_keys(b"", b""):
            self.mem[key] = eng.memtable.versions(key)

    def _candidate(self, key) -> bool:
        b = self.base[key]
        if not b.tombstone and b.ht <= self.read_ht:
            return True
        if key in self.mem:
            return True
        return any(key in src and self.merge(key, src[key],
                                             self.read_ht).exists
                   for src in self.extra)

    def merged(self, key):
        versions = [self.base[key]] + [v for src in self.extra
                                       for v in src.get(key, [])]
        return self.merge(key, versions + self.mem.get(key, []),
                          self.read_ht)

    def scan(self, spec, preds, fold=None) -> tuple:
        """(rows, resume, rows_scanned) of the row scan over the sources;
        with ``fold``, its Aggregator fed instead of rows."""
        i0 = bisect.bisect_left(self.keys, spec.lower)
        i1 = (bisect.bisect_left(self.keys, spec.upper) if spec.upper
              else len(self.keys))
        rows, scanned = [], 0
        for key in self.keys[i0:i1]:
            if not self._candidate(key):
                continue
            scanned += 1
            m = self.merged(key)
            if not m.exists:
                continue
            kv = self.mat.key_values(key)
            if not all(p.real(self.mat.value(p.column, kv, m))
                       for p in preds):
                continue
            if fold is not None:
                fold.add(lambda nm, _kv=kv, _m=m: self.mat.value(nm, _kv, _m))
                continue
            rows.append(tuple(self.mat.value(nm, kv, m)
                              for nm in spec.projection))
            if spec.limit is not None and len(rows) >= spec.limit:
                return rows, key + b"\0", scanned
        return rows, None, scanned


def rows_sources_phase(device, bw: float, rate: float, flat,
                       mvcc) -> dict:
    """Row scans over several sources: the flat engine after the overlay
    phase (4 runs and a live memtable) and the multi-version one (its run
    and a live memtable). YCSB-E pages and one grouped aggregate over a
    key range of the flat engine, and a scan of the whole multi-version
    table at a read point where 1 key in WIDE_SCAN_SHARE was written (its
    run's 123 windows: K9 launches of 1, 4, 16, 64 and 38 windows), go
    through the row scan, whose candidates K9 gives; every result against
    the oracle, every K9 launch byte for byte against its plain version,
    the widest launch timed."""
    from yugabyte_db_tpu_torch import workload
    from yugabyte_db_tpu_torch.ops import row_gather as rg
    from yugabyte_db_tpu_torch.storage import AggSpec, ScanSpec
    from yugabyte_db_tpu_torch.storage.cpu_engine import Aggregator

    t_phase = time.perf_counter()
    eng = flat.eng
    read = flat.sources_read_ht
    check(len(eng.runs) > 1 and not eng.memtable.is_empty,
          "the flat engine holds one source")
    t0 = time.perf_counter()
    oracle = SourcesOracle(flat.schema, eng, flat.rows, read)
    oracle_s = time.perf_counter() - t0
    rg.gather_rows.launches = rg.scan_candidates.launches = 0
    preds = [SmokePred("d", ">=", -500_000, "i32")]
    log = LaunchLog()
    with log:
        specs = workload.ycsb_e_batch(flat.schema, ENGINE_KEYS, read,
                                      random.Random(23), SOURCE_PAGES)
        t = time.perf_counter()
        got = eng.scan_batch(specs)
        pages_ms = (time.perf_counter() - t) * 1e3
        for j, (s, r) in enumerate(zip(specs, got)):
            check_page(r, oracle.scan(s, preds), f"sources page {j}")
        first = len(oracle.keys) // 10
        lo = oracle.keys[first]
        hi = oracle.keys[first + SOURCE_GROUP_KEYS]
        gspec = ScanSpec(lower=lo, upper=hi, read_ht=read, group_by=["r"],
                         aggregates=[AggSpec("count", None),
                                     AggSpec("sum", "d"),
                                     AggSpec("max", "a")])
        t = time.perf_counter()
        res = eng.scan(gspec)
        group_ms = (time.perf_counter() - t) * 1e3
        agg = Aggregator(gspec.aggregates, gspec.group_by)
        _r, _s, scanned = oracle.scan(gspec, [], fold=agg)
        check(res.rows == agg.results() and res.rows_scanned == scanned,
              "grouped scan over several sources differs from the oracle")
        check(len(mvcc.eng.runs) == 1 and not mvcc.eng.memtable.is_empty,
              "the multi-version engine holds one source")
        early = mvcc.rows[len(mvcc.rows) // WIDE_SCAN_SHARE].ht
        t = time.perf_counter()
        w_oracle = SourcesOracle(mvcc.schema, mvcc.eng, mvcc.rows, early)
        oracle_s += time.perf_counter() - t
        wspec = ScanSpec(read_ht=early, projection=["k", "r", "a", "d"])
        t = time.perf_counter()
        wide = mvcc.eng.scan(wspec)
        wide_ms = (time.perf_counter() - t) * 1e3
        check_page(wide, w_oracle.scan(wspec, []), "wide scan over "
                   "several sources")
        launches = {"gather_rows": rg.gather_rows.launches,
                    "scan_candidates": rg.scan_candidates.launches}
        widths = sorted({c[4] for c in log.cands})
        widest = max(log.cands, key=lambda c: c[4])
        narrow = {n: next(c for c in log.cands if c[4] == n)
                  for n in (1, 4) if n in widths}
        held = log.verify()
    check(launches["scan_candidates"] > 0,
          "the row scan over several sources launched K9 0 times")
    check(widest[4] == 64, f"no 64-window K9 launch: widths {widths}")
    k9 = time_launch("cands", widest, bw, rate)
    k9["narrow"] = {n: time_launch("cands", c, bw, rate)
                    for n, c in narrow.items()}
    row = {"card": nvidia_smi(), "runs": len(eng.runs),
           "memtable_versions": eng.memtable.num_versions,
           "oracle_s": oracle_s, "pages": SOURCE_PAGES,
           "pages_batch_ms": pages_ms, "group_keys": SOURCE_GROUP_KEYS,
           "group_ms": group_ms, "group_rows_scanned": res.rows_scanned,
           "wide_read_ht": early, "wide_rows": len(wide.rows),
           "wide_rows_scanned": wide.rows_scanned, "wide_ms": wide_ms,
           "k9_widths": widths, "held": held, "launches": launches,
           "k9": k9,
           "phase_s": time.perf_counter() - t_phase}
    print("rows_sources " + json.dumps(row))
    return row


# -- the write side: K12 on every flush, K11 in compactions -----------------

K12_LAUNCHES: dict = {}  # K12 launches of each path's flushes
FLUSHES: list = []       # every flush of the smoke's tables, with its parts
FLUSH_SLOT_OPS = 8       # integer operations an output slot needs (its
# block's test, the inverted dst's lookup, the fill's selects)
GC_ROW_OPS = 24          # integer operations a union row of the mask needs
GC_COL_OPS = 2           # (visibility, shadowing, alive, the contributor
# ballots, the span and keep tests; a set test and a select a column)
COMPACT_WAVES = 3        # bench.py:1458 bench_compact: 3 update waves of
COMPACT_SHARE = 0.35     # 35% of the keys each, 10% of them DELETEs
COMPACT_SAMPLE = 4000    # keys whose merged versions are held against GC
TWIN_REPS = 1            # timed runs of the numpy twin on the K11 union
_WRITE_LOG = None


class WriteLog:
    """The engine's K12 and K11 launches, recorded (inputs and output)
    through proxies of ``ops.flush`` / ``ops.compact`` that the engine
    module reads, to be held byte for byte against the plain versions
    after the flush or compaction that made them; ``last_flush`` keeps
    the latest K12 launch for timing."""

    def __init__(self):
        from yugabyte_db_tpu_torch.ops import compact, flush as dflush
        from yugabyte_db_tpu_torch.storage import gpu_engine

        self.dflush, self.compact = dflush, compact
        self.flushes, self.masks = [], []
        self.last_flush = None

        def replay(*args):
            out = dflush.replay_flush(*args)
            self.flushes.append((args, out))
            self.last_flush = (args, out)
            return out

        def mask(*args):
            keep = compact.resident_gc_mask(*args)
            self.masks.append((args, keep))
            return keep

        fp = SimpleNamespace(**vars(dflush))
        fp.replay_flush = replay
        cp = SimpleNamespace(**vars(compact))
        cp.resident_gc_mask = mask
        gpu_engine.dflush, gpu_engine.dcompact = fp, cp

    def verify_flushes(self) -> int:
        """Every recorded K12 launch against ``replay_flush_plain`` on the
        same inputs: the number held (the phase fails on any difference)."""
        import torch

        err = 0
        for args, out in self.flushes:
            err = max(err, view_diff(out, self.dflush.replay_flush_plain(
                *args)))
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        check(err == 0, f"K12 differs from its plain version by {err}")
        n = len(self.flushes)
        self.flushes = []
        return n


def write_log() -> WriteLog:
    global _WRITE_LOG
    if _WRITE_LOG is None:
        _WRITE_LOG = WriteLog()
    return _WRITE_LOG


def flush(eng, path: str) -> dict:
    """``eng.flush()`` of one of the smoke's tables: it must take the
    device route and launch K12 (its count set to 0 just before, read
    just after, added to ``K12_LAUNCHES[path]``), and the launch must equal
    the plain version byte for byte. Prints the flush's parts (ms)."""
    from yugabyte_db_tpu_torch.ops import flush as dflush

    log = write_log()
    before = dict(eng.flush_paths)
    dflush.replay_flush.launches = 0
    t0 = time.perf_counter()
    eng.flush()
    wall = time.perf_counter() - t0
    n = dflush.replay_flush.launches
    check(eng.flush_paths == {"device": before["device"] + 1,
                              "host": before["host"]},
          f"a flush of the {path} phase's table took the host route")
    check(n > 0, f"a flush of the {path} phase's table launched K12 0 times")
    K12_LAUNCHES[path] = K12_LAUNCHES.get(path, 0) + n
    rec = {"path": path, "versions": eng.runs[-1].crun.num_versions,
           "launches": n, "wall_ms": wall * 1e3,
           **{k[:-2] + "_ms": v * 1e3 for k, v in eng.last_flush.items()
              if k.endswith("_s")}}
    t0 = time.perf_counter()
    rec["held"] = log.verify_flushes()
    rec["hold_ms"] = (time.perf_counter() - t0) * 1e3
    FLUSHES.append(rec)
    print("flush " + json.dumps(rec))
    return rec


def runs_differ(a, b) -> list:
    """The fields in which two ColumnarRuns differ: every host plane, the
    row keys and versions, the block bounds, the metadata."""
    bad = []
    for name in ("valid", "group_start", "tomb", "live", "ht_hi", "ht_lo",
                 "exp_hi", "exp_lo", "key_planes", "row_keys"):
        if not np.array_equal(getattr(a, name), getattr(b, name)):
            bad.append(name)
    if not all(x is y for x, y in zip(a.row_versions.ravel(),
                                      b.row_versions.ravel())):
        bad.append("row_versions")
    for cid, ca in a.cols.items():
        cb = b.cols[cid]
        for f in ("set_", "isnull", "cmp_planes", "arith"):
            x, y = getattr(ca, f), getattr(cb, f)
            if (x is None) != (y is None) or (
                    x is not None and not np.array_equal(x.view(np.uint8),
                                                         y.view(np.uint8))):
                bad.append(f"{cid}.{f}")
        if ca.varlen != cb.varlen:
            bad.append(f"{cid}.varlen")
    if [(m.min_key, m.max_key, m.num_valid) for m in a.blocks] != \
            [(m.min_key, m.max_key, m.num_valid) for m in b.blocks]:
        bad.append("blocks")
    for f in ("B", "R", "num_versions", "min_key", "max_key", "max_ht",
              "max_group_versions", "max_key_len", "varlen_max_len"):
        if getattr(a, f) != getattr(b, f):
            bad.append(f)
    return bad


def flush_against_host_build(ctx, device) -> dict:
    """The engine phase's table built again from the same versions by the
    host route (``drain_sorted`` + ``ColumnarRun.build``, then the
    upload): every host plane and every device plane of the two runs must
    be equal byte for byte. Both flushes' parts (ms)."""
    import torch

    from yugabyte_db_tpu_torch.ops.device_run import DeviceRun
    from yugabyte_db_tpu_torch.storage.columnar import ColumnarRun
    from yugabyte_db_tpu_torch.storage.gpu_engine import PAD_BLOCKS
    from yugabyte_db_tpu_torch.storage.memtable import MemTable

    trun = ctx.eng.runs[0]
    mem = MemTable()
    mem.apply(ctx.rows)
    t0 = time.perf_counter()
    entries = mem.drain_sorted()
    t1 = time.perf_counter()
    crun = ColumnarRun.build(ctx.schema, entries, trun.crun.R)
    t2 = time.perf_counter()
    dev = DeviceRun(crun, PAD_BLOCKS, device=device)
    torch.cuda.synchronize() if torch.cuda.is_available() else None
    t3 = time.perf_counter()
    bad = runs_differ(trun.crun, crun)
    check(not bad, f"the device flush's host planes differ from the host "
                   f"build's: {bad}")
    err = view_diff(trun.dev.arrays, dev.arrays)
    check(err == 0, f"the device flush's device planes differ from the "
                    f"host build's upload by {err}")
    device_parts = next(f for f in FLUSHES if f["path"] == "engine")
    out = {"versions": crun.num_versions, "device": device_parts,
           "host": {"drain_ms": (t1 - t0) * 1e3, "build_ms": (t2 - t1) * 1e3,
                    "upload_ms": (t3 - t2) * 1e3,
                    "wall_ms": (t3 - t0) * 1e3},
           "host_planes_equal": True, "device_planes_equal": True}
    print("flush_engine " + json.dumps(out))
    return out


def measure_k12(launch, bw: float, rate: float) -> dict:
    """One recorded K12 launch timed (CUDA events, median of KERNEL_REPS,
    queued behind a sleeping kernel) beside its plain version and its
    bound: ``replay_bytes`` over the bandwidth, or FLUSH_SLOT_OPS an
    output slot over the integer rate, whichever is larger."""
    from yugabyte_db_tpu_torch.ops import flush as dflush

    args, _out = launch
    staged, perm, dst, _gs, is_real, _eh, _el, R = args
    Bp = int(is_real.shape[0])
    n = int((dst < Bp * R).sum())
    ms = cuda_ms(lambda: dflush.replay_flush(*args), KERNEL_REPS,
                 queue_ahead=True)
    plain = cuda_ms(lambda: dflush.replay_flush_plain(*args), PLAIN_REPS)
    nbytes = dflush.replay_bytes(staged, n, int(perm.shape[0]), Bp, R)
    ops = float(FLUSH_SLOT_OPS) * Bp * R
    t_bytes, t_ops = nbytes / bw * 1e3, ops / rate * 1e3
    return {"rows": n, "slots": Bp * R, "columns": len(staged["cols"]),
            "ms": ms, "plain_ms": plain, "library_ms": None,
            "bytes": int(nbytes), "operations": ops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "max_abs_err": 0}


def k12_wide_edge(launch) -> dict:
    """K12 past MAX_COLS value columns (the recorded launch's columns
    repeated under MAX_COLS + 2 ids: two launches, the second writing its
    columns only), byte for byte against the plain version; untimed."""
    import torch

    from yugabyte_db_tpu_torch.ops import flush as dflush

    (staged, *rest), _out = launch
    cids = list(staged["cols"])
    wide = dict(staged, cols={100 + i: staged["cols"][cids[i % len(cids)]]
                              for i in range(dflush.MAX_COLS + 2)})
    before = dflush.replay_flush.launches
    got = dflush.replay_flush(wide, *rest)
    n = dflush.replay_flush.launches - before
    err = view_diff(got, dflush.replay_flush_plain(wide, *rest))
    torch.cuda.synchronize() if torch.cuda.is_available() else None
    check(err == 0 and n == 2, f"K12 over {len(wide['cols'])} value "
                               f"columns: {n} launches, difference {err}")
    return {"columns": len(wide["cols"]), "launches": n, "max_abs_err": err}


# K12 on drawn inputs (label, staged rows, R, value columns, pad entries,
# a 2-word order column last, an odd block count): R not a multiple of 4
# and a slot count that is not either, R = 8, and a chunk of 32 columns
# whose last has two order words.
K12_EDGES = (("R100", 300_000, 100, 3, 4096, False, False),
             ("R100_odd_blocks", 300_001, 100, 3, 0, False, True),
             ("R8", 50_000, 8, 2, 100, False, False),
             ("cols32_two_words", 100_000, 100, 32, 77, True, False))


def k12_edges(launch) -> dict:
    """K12 past MAX_COLS value columns (``k12_wide_edge``) and on
    ``workload.replay_inputs`` at each of K12_EDGES, each byte for byte
    against the plain version (one call each); untimed."""
    import torch

    from yugabyte_db_tpu_torch import workload
    from yugabyte_db_tpu_torch.ops import flush as dflush

    out = {"cols34": k12_wide_edge(launch)}
    dev = launch[0][1].device
    for k, (label, n, R, cols, pads, two, odd) in enumerate(K12_EDGES):
        staged, perm, dst, gs, real = workload.replay_inputs(
            n, R, cols, pads, seed=31 + k, two_word_last=two,
            odd_blocks=odd)

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        tree = {name: (up(v) if name != "cols" else
                       {cid: {f: up(x) for f, x in c.items()}
                        for cid, c in v.items()})
                for name, v in staged.items()}
        args = (tree, up(perm), up(dst), up(gs), up(real), 2**31 - 1, -1, R)
        before = dflush.replay_flush.launches
        got = dflush.replay_flush(*args)
        calls = dflush.replay_flush.launches - before
        err = view_diff(got, dflush.replay_flush_plain(*args))
        torch.cuda.synchronize() if torch.cuda.is_available() else None
        check(err == 0 and calls == 1, f"K12 edge {label}: {calls} calls, "
                                       f"difference {err}")
        out[label] = {"rows": n, "R": R, "columns": cols, "pads": pads,
                      "slots": int(real.size) * R, "launches": calls,
                      "max_abs_err": err}
    return out


# K11 on drawn unions: a key group of 5,000 versions that crosses tiles
# (and the rows a block stages) with spans of 70 equal hybrid times, the
# cutoff at the span over a tile edge; and 256 value columns.
K11_LONG = 5000


def k11_union(device, s: dict, pads: int, cut) -> tuple:
    """``workload.gc_union``'s planes spread over 4 runs at R = 2048
    (``scatter_union``) and uploaded: the arguments of
    ``resident_gc_mask``."""
    import torch

    from yugabyte_db_tpu_torch import workload

    runs, idx = workload.scatter_union(s, 4, 2048, pads)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    runs_t = tuple({k: (tuple(up(x) for x in v) if k == "sets" else up(v))
                    for k, v in r.items()} for r in runs)
    starts = np.flatnonzero(s["new_group"]).astype(np.int32)
    return (runs_t, up(idx), up(s["new_group"]), up(starts), cut)


def k11_drawn_edges(device) -> dict:
    """K11 on drawn unions, byte for byte against its plain version and
    the numpy twin: ``long_tile_edge`` (3 columns; a group of K11_LONG
    versions from ~1,300 rows on, its span over the first tile edge
    inside it made alive and holding a liveness contributor, the cutoff
    at that span: the kept span is checked to cross the edge) and
    ``cols256`` (256 columns, a group of 1,500 versions, the cutoff
    mid-history); untimed."""
    from yugabyte_db_tpu_torch import workload
    from yugabyte_db_tpu_torch.ops import compact
    from yugabyte_db_tpu_torch.utils import planes as P

    out = {}
    s, _top = workload.gc_union(150, 3, ((150, K11_LONG),), pads=50,
                                seed=17)
    starts = np.flatnonzero(s["new_group"])
    g0 = int(starts[150])
    tile = compact.tile_rows(3)[0]
    edge = (g0 // tile + 1) * tile
    check(g0 + 40 < edge < g0 + K11_LONG - 40,
          f"the long group [{g0}, {g0 + K11_LONG}) holds no tile edge")
    span = (s["ht_hi"] == s["ht_hi"][edge]) & (s["ht_lo"] == s["ht_lo"][edge])
    span[:g0] = False
    span[g0 + K11_LONG:] = False
    s["tomb"] = s["tomb"] & ~span
    first = int(np.flatnonzero(span)[0])
    s["live"][first] = True
    s["exp_hi"][first], s["exp_lo"][first] = P.scalar_ht_planes(
        workload.MAX_HT)
    cut = (int(s["ht_hi"][edge]), int(s["ht_lo"][edge]),
           int(s["ht_hi"][edge]), int(s["ht_lo"][edge]))
    keep = compact.gc_mask_host(3, s, cut)
    check(bool(keep[edge - 1] and keep[edge] and span[edge - 1]),
          "the drawn union's kept span does not cross the tile edge")
    s256, top = workload.gc_union(2000, 256, ((500, 1500),), pads=10,
                                  seed=19)
    c_hi, c_lo = P.scalar_ht_planes(top // 2)
    for label, (u, pads, c) in (("long_tile_edge", (s, 50, cut)),
                                ("cols256", (s256, 10,
                                             (c_hi, c_lo, c_hi, c_lo)))):
        args = k11_union(device, u, pads, c)
        before = compact.resident_gc_mask.launches
        got = compact.resident_gc_mask(*args)
        check(compact.resident_gc_mask.launches - before == 1,
              f"K11 edge {label}: not one launch")
        out[label] = {"rows": int(args[1].shape[0]),
                      "groups": int(args[3].shape[0]),
                      "columns": len(args[0][0]["sets"]),
                      "max_abs_err": hold_mask((args, got))}
    return out


def k11_edges(launch) -> dict:
    """K11 on the recorded launch's union with pad rows appended (idx -1,
    a group of their own) and with its columns repeated to 42 (the
    kernel's second word of column flags), then ``k11_drawn_edges``,
    each byte for byte against the plain version and the numpy twin;
    untimed."""
    import torch

    from yugabyte_db_tpu_torch.ops import compact

    (runs, idx, new_group, starts, cut), _keep = launch
    pads = 1000
    dev = idx.device
    padded = (runs, torch.cat([idx, torch.full((pads,), -1, dtype=idx.dtype,
                                               device=dev)]),
              torch.cat([new_group, torch.arange(pads, device=dev) == 0]),
              torch.cat([starts, torch.tensor([idx.shape[0]],
                                              dtype=starts.dtype,
                                              device=dev)]), cut)
    wide_runs = tuple(dict(r, sets=tuple(r["sets"][i % len(r["sets"])]
                                         for i in range(42))) for r in runs)
    out = {}
    for label, args in (("pads", padded),
                        ("cols42", (wide_runs, idx, new_group, starts, cut))):
        before = compact.resident_gc_mask.launches
        keep = compact.resident_gc_mask(*args)
        check(compact.resident_gc_mask.launches - before == 1,
              f"K11 edge {label}: not one launch")
        out[label] = {"rows": int(args[1].shape[0]),
                      "columns": len(args[0][0]["sets"]),
                      "max_abs_err": hold_mask((args, keep))}
    out.update(k11_drawn_edges(dev))
    return out


def hold_mask(launch) -> int:
    """A recorded K11 launch against its plain version on the card and
    against the numpy twin on the host: the largest difference (0 or the
    phase fails)."""
    import torch

    from yugabyte_db_tpu_torch.ops import compact

    (runs_planes, idx, new_group, _starts, cut), keep = launch
    s = compact.gather_union(runs_planes, idx)
    s["new_group"] = new_group
    num_cols = len(runs_planes[0]["sets"])
    plain = compact.gc_mask_plain(num_cols, s, cut)
    host = {k: (v.cpu().numpy() if k != "set_" else
                [x.cpu().numpy() for x in v]) for k, v in s.items()}
    twin = compact.gc_mask_host(num_cols, host, cut)
    torch.cuda.synchronize() if torch.cuda.is_available() else None
    got = keep.cpu().numpy()
    err = int((got != plain.cpu().numpy()).sum()) + int((got != twin).sum())
    check(err == 0, f"K11 differs from its plain version or the numpy twin "
                    f"in {err} rows")
    return err


def measure_k11(launch, bw: float, rate: float) -> dict:
    """One recorded K11 launch timed (CUDA events, median of KERNEL_REPS)
    beside its plain version on the card, the numpy twin on the same
    union (host clock, median of TWIN_REPS, the union's planes gathered
    beforehand) and its bound: ``mask_bytes`` over the bandwidth, or the
    integer operations over the rate, whichever is larger."""
    from yugabyte_db_tpu_torch.ops import compact

    (runs_planes, idx, new_group, starts, cut), _keep = launch
    num_cols = len(runs_planes[0]["sets"])
    N, G = int(idx.shape[0]), int(starts.shape[0])
    ms = cuda_ms(lambda: compact.resident_gc_mask(*launch[0]), KERNEL_REPS,
                 queue_ahead=True)

    def plain():
        s = compact.gather_union(runs_planes, idx)
        s["new_group"] = new_group
        return compact.gc_mask_plain(num_cols, s, cut)

    plain_ms = cuda_ms(plain, PLAIN_REPS)
    s = compact.gather_union(runs_planes, idx)
    s["new_group"] = new_group
    host = {k: (v.cpu().numpy() if k != "set_" else
                [x.cpu().numpy() for x in v]) for k, v in s.items()}
    twin = []
    for _ in range(TWIN_REPS):
        t0 = time.perf_counter()
        compact.gc_mask_host(num_cols, host, cut)
        twin.append((time.perf_counter() - t0) * 1e3)
    nbytes = compact.mask_bytes(num_cols, N, G)
    ops = float(N) * (GC_ROW_OPS + GC_COL_OPS * num_cols)
    t_bytes, t_ops = nbytes / bw * 1e3, ops / rate * 1e3
    return {"rows": N, "groups": G, "columns": num_cols, "ms": ms,
            "plain_ms": plain_ms, "twin_ms": statistics.median(twin),
            "twin_ms_each": twin, "library_ms": None, "bytes": int(nbytes),
            "operations": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "max_abs_err": 0}


def check_pages(eng, specs, oracle, route: str, label: str,
                sources=None) -> dict:
    """A batch of pages through the engine, each against the run oracle
    (rows, resume key and ``rows_scanned`` on ``route``) and, given
    ``sources`` (a SourcesOracle of the history), its rows and resume key
    against that too. Returns the batch's ms and route."""
    preds = [SmokePred("d", ">=", -500_000, "i32")]
    t0 = time.perf_counter()
    got = eng.scan_batch(specs)
    ms = (time.perf_counter() - t0) * 1e3
    for j, (s, r) in enumerate(zip(specs, got)):
        check_page(r, oracle.page(s, preds, route, 104), f"{label} page {j}")
        if sources is not None:
            rows, resume, _scanned = sources.scan(s, preds)
            check(r.rows == rows and r.resume_key == resume,
                  f"{label} page {j}: rows differ from the history's")
    return {"pages": len(specs), "batch_ms": ms, "route": route}


def compact_table(device, flat) -> SimpleNamespace:
    """``bench.py:1458 bench_compact``'s table: the engine phase's rows
    (``flat``) and COMPACT_WAVES waves of one-column updates of
    COMPACT_SHARE of the keys (10% DELETEs) on a new ``gpu`` engine, each
    flushed by the device route: COMPACT_WAVES + 1 runs past
    HOST_GC_MASK_MAX versions, whose compaction takes K11."""
    from yugabyte_db_tpu_torch import workload
    from yugabyte_db_tpu_torch.storage import gpu_engine, make_engine

    t0 = time.perf_counter()
    waves, max_ht = workload.make_compact_waves(
        [r.key for r in flat.rows], flat.schema, flat.max_ht, COMPACT_WAVES,
        COMPACT_SHARE)
    gen_s = time.perf_counter() - t0
    eng = make_engine("gpu", flat.schema, {"rows_per_block": 2048,
                                           "device": device})
    t0 = time.perf_counter()
    eng.apply(flat.rows)
    flush(eng, "compact")
    for wave in waves:
        eng.apply(wave)
        flush(eng, "compact")
    load_s = time.perf_counter() - t0
    N = sum(t.crun.num_versions for t in eng.runs)
    check(len(eng.runs) == COMPACT_WAVES + 1 and
          N > gpu_engine.HOST_GC_MASK_MAX,
          f"{len(eng.runs)} runs of {N} versions: the union does not take "
          "K11")
    return SimpleNamespace(eng=eng, waves=waves, max_ht=max_ht, N=N,
                           gen_s=gen_s, load_s=load_s)


def compact_phase(device, bw: float, rate: float, flat) -> dict:
    """Compaction with history GC. First ``bench.py:1458 bench_compact``'s
    shape on the bench table: ENGINE_KEYS keys (the engine phase's rows)
    and COMPACT_WAVES waves of one-column updates (10% DELETEs), each
    flushed by the device route: 4 runs past HOST_GC_MASK_MAX versions,
    compacted at the newest hybrid time (full history GC) through K11.
    K11's launch against its plain version and the numpy twin; the
    merged entries of COMPACT_SAMPLE keys against ``gc_versions`` over
    the history; the headline spec at read points at and past the cutoff
    against the history oracle, a YCSB-E batch of 256 pages against the
    merged run's oracle. Then the overlay phase's flat engine (4 runs and
    a live memtable, after the rows over several sources): flushed,
    compacted at its newest hybrid time (the numpy twin's route), and 64
    YCSB-E pages against the history (``SourcesOracle``)."""
    import torch

    from yugabyte_db_tpu_torch import workload
    from yugabyte_db_tpu_torch.ops import compact, decode
    from yugabyte_db_tpu_torch.storage.cpu_engine import gc_versions

    t_phase = time.perf_counter()
    out = {"card": nvidia_smi()}
    schema, rows = flat.schema, flat.rows
    table = compact_table(device, flat)
    eng, waves, max_ht, N = table.eng, table.waves, table.max_ht, table.N
    gen_s, load_s = table.gen_s, table.load_s
    t0 = time.perf_counter()
    updates = [r for wave in waves for r in wave]
    history = HistoryOracle(schema, rows, updates)
    cutoff = max_ht
    reads = [cutoff, cutoff + 1 + (1 << 20)]
    oracles = history.at_reads(reads)
    oracle_s = time.perf_counter() - t0

    log = write_log()
    log.masks = []
    compact.resident_gc_mask.launches = 0
    decode.decode_tree.launches = 0  # the merged run's first reads: K10
    t0 = time.perf_counter()
    eng.compact(cutoff)
    wall = time.perf_counter() - t0
    launches = compact.resident_gc_mask.launches
    check(launches > 0, "the compaction launched K11 0 times")
    check(eng.compact_paths == {"k11": 1, "twin": 0, "host": 0},
          f"compaction routes {eng.compact_paths}")
    parts = {k[:-2] + "_ms": v * 1e3 for k, v in eng.last_compact.items()
             if k.endswith("_s")}
    launch = log.masks[-1]
    log.masks = []
    t0 = time.perf_counter()
    held_err = hold_mask(launch)
    crun = eng.runs[0].crun
    steps = {"hold_k11_s": time.perf_counter() - t0}
    t0 = time.perf_counter()

    # The merged entries of a sample of keys against the GC rule over
    # each key's whole history.
    by_key: dict = {}
    for r in updates:
        by_key.setdefault(r.key, []).append(r)
    rng = random.Random(3)
    sample = rng.sample(range(ENGINE_KEYS), COMPACT_SAMPLE)
    for i in sample:
        key = rows[i].key
        versions = sorted([rows[i]] + by_key.get(key, []),
                          key=lambda v: (-v.ht, -v.write_id))
        want = gc_versions(key, versions, cutoff)
        got = crun.find_versions(key)
        check([id(v) for v in got] == [id(v) for v in want],
              f"merged versions of key {i} differ from the GC rule's")
    sizes = collections.Counter(
        len(v) for v in (crun.find_versions(rows[i].key) for i in sample))
    steps["sample_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # Reads at and past the cutoff.
    route = eng._plan_scan(workload.headline_spec(cutoff)).route
    for rd in reads:
        for lo in (-500_000, 0, 400_000):
            got = eng.scan(workload.headline_spec(rd, lo)).rows[0]
            check(got == oracles[rd].headline(lo),
                  f"compacted scan at {rd}, d >= {lo}: {got} != "
                  f"{oracles[rd].headline(lo)}")
    read = reads[-1]
    steps["headline_s"] = time.perf_counter() - t0
    K10_LAUNCHES["compact"] = decode.decode_tree.launches
    check(K10_LAUNCHES["compact"] == 1,
          f"the merged run's reads launched K10 {K10_LAUNCHES['compact']} "
          "times")
    t0 = time.perf_counter()
    kv = {r.key: [f"user{i:06d}", i % 7] for i, r in enumerate(rows)}
    r_oracle = RunOracle.at_reads(schema, crun, [read], ("a", "c", "d"),
                                  kv)[0]
    steps["run_oracle_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    specs = workload.ycsb_e_batch(schema, ENGINE_KEYS, read,
                                  random.Random(29))
    page_route = eng._plan_scan(specs[0])[0]
    ycsb = check_pages(eng, specs, r_oracle,
                       "gather" if page_route == "gather" else "page",
                       "compacted ycsb_e")
    ycsb["route"] = page_route
    steps["ycsb_e_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    k11 = measure_k11(launch, bw, rate)
    k11["edges"] = k11_edges(launch)
    del launch
    steps["k11_timing_s"] = time.perf_counter() - t0
    out.update({
        "keys": ENGINE_KEYS, "waves": COMPACT_WAVES,
        "per_wave": len(waves[0]), "versions": N, "runs": COMPACT_WAVES + 1,
        "cutoff": cutoff, "generate_s": gen_s, "apply_flush_s": load_s,
        "oracle_s": oracle_s, "compact_wall_ms": wall * 1e3,
        "compact_parts_ms": parts, "kept": crun.num_versions,
        "merged_max_group_versions": crun.max_group_versions,
        "merged_flat": crun.max_group_versions <= 1,
        "sample_versions_per_key": dict(sorted(sizes.items())),
        "headline_route": route, "ycsb_e": ycsb, "launches": launches,
        "held_max_abs_err": held_err, "steps_s": steps, "k11": k11})
    print("compact_k11 " + json.dumps({k: v for k, v in out.items()
                                       if k != "k11"}))
    print("compact_k11_kernel " + json.dumps(k11))
    t0 = time.perf_counter()
    out["encoded"] = ENCODED["compacted"] = encoded_compacted(
        eng, updates, oracles, reads, schema, rows, max_ht, device, bw)
    steps["encoded_s"] = time.perf_counter() - t0
    del eng, history, oracles, r_oracle
    torch.cuda.empty_cache()

    # The overlay phase's flat engine: its memtable flushed, then all its
    # runs compacted at the newest hybrid time.
    fe = flat.eng
    read = flat.sources_read_ht
    t0 = time.perf_counter()
    sources = SourcesOracle(flat.schema, fe, flat.rows, read)
    steps = {"sources_oracle_s": time.perf_counter() - t0}
    before = {"runs": len(fe.runs),
              "memtable_versions": fe.memtable.num_versions}
    flush(fe, "compact")
    N = sum(t.crun.num_versions for t in fe.runs)
    t0 = time.perf_counter()
    fe.compact(read - 1)
    wall = time.perf_counter() - t0
    check(fe.compact_paths["twin"] == 1 and fe.compact_paths["k11"] == 0,
          f"the overlay engine's compaction took {fe.compact_paths}")
    parts = {k[:-2] + "_ms": v * 1e3 for k, v in fe.last_compact.items()
             if k.endswith("_s")}
    crun = fe.runs[0].crun
    t0 = time.perf_counter()
    r_oracle = RunOracle.at_reads(flat.schema, crun, [read],
                                  ("a", "c", "d"), kv)[0]
    steps["run_oracle_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    specs = workload.ycsb_e_batch(flat.schema, ENGINE_KEYS, read,
                                  random.Random(23), SOURCE_PAGES)
    page_route = fe._plan_scan(specs[0])[0]
    pages = check_pages(fe, specs, r_oracle,
                        "gather" if page_route == "gather" else "page",
                        "overlay engine compacted", sources)
    pages["route"] = page_route
    check(page_route != "host",
          "the pages after compaction still take the row scan over "
          "several sources")
    steps["pages_s"] = time.perf_counter() - t0
    out["overlay"] = dict(before, versions=N, cutoff=read - 1,
                          steps_s=steps, compact_wall_ms=wall * 1e3,
                          compact_parts_ms=parts, kept=crun.num_versions,
                          merged_max_group_versions=crun.max_group_versions,
                          pages=pages)
    print("compact_overlay " + json.dumps(out["overlay"]))
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def write_entries(eng_k12: dict, comp: dict) -> list:
    """The kernels line's K12 and K11 entries: K12 at the engine phase's
    flush (1,000,000 keys), its launches on every path's flushes (each
    held byte for byte); K11 at the compact phase's 4-run union; the
    launches held on the edges, and each build's registers and stack
    (``write_ptxas``: no spill, no stack frame)."""
    k11 = comp["k11"]
    held = sum(f["held"] for f in FLUSHES)
    usage = write_ptxas()
    return [{
        "name": "replay_flush", "route": "cuda",
        "source": "yugabyte_db_tpu_torch/csrc/flush.cu",
        "replaces": "yugabyte_db_tpu/ops/flush.py:38",
        "launches": sum(K12_LAUNCHES.values()),
        "launches_by_path": dict(K12_LAUNCHES), "held": held,
        "max_abs_err": 0, "max_abs_diff": 0, "ms": eng_k12["ms"],
        "plain_ms": eng_k12["plain_ms"], "bound_ms": eng_k12["bound_ms"],
        "bound_by": eng_k12["bound_by"], "library_ms": None,
        "library_note": "no single PyTorch call writes every plane of a "
                        "run from a permutation and its padding (an "
                        "index_put_ a plane is the plain version)",
        "rows": eng_k12["rows"], "slots": eng_k12["slots"],
        "edge_launches": sum(e["launches"]
                             for e in eng_k12["edges"].values()),
        "ptxas": usage["flush"],
        **({"codes_route_ms": ENCODED["k12_codes"]["ms"],
            "codes_route_plain_ms": ENCODED["k12_codes"]["plain_ms"],
            "codes_route_bound_ms": ENCODED["k12_codes"]["bound_ms"],
            "codes_route_rows": ENCODED["k12_codes"]["rows"]}
           if "k12_codes" in ENCODED else {})}, {
        "name": "gc_mask", "route": "cuda",
        "source": "yugabyte_db_tpu_torch/csrc/compact.cu",
        "replaces": "yugabyte_db_tpu/ops/compact.py:166",
        "launches": comp["launches"],
        "launches_by_path": {"compact": comp["launches"]},
        "max_abs_err": comp["held_max_abs_err"],
        "max_abs_diff": comp["held_max_abs_err"], "ms": k11["ms"],
        "plain_ms": k11["plain_ms"], "bound_ms": k11["bound_ms"],
        "bound_by": k11["bound_by"], "library_ms": None,
        "library_note": "no single PyTorch call computes a segmented "
                        "retention mask (a scatter_reduce and cumsum "
                        "composite is the plain version)",
        "twin_ms": k11["twin_ms"], "rows": k11["rows"],
        "edge_launches": len(k11["edges"]), "ptxas": usage["compact"]}]


def write_ptxas() -> dict:
    """K12's and K11's entry functions (``pack_kernel``, ``tile_kernel``;
    ``gc_mask_kernel``) as ptxas reported them in this process's build:
    registers, stack frame and spills; fails on any spill or stack frame.
    "not measured" where the library was built by an earlier process."""
    out = {}
    for lib, names in (("flush", ("pack_kernel", "tile_kernel")),
                       ("compact", ("gc_mask_kernel",))):
        usage = ptxas_usage(lib)
        if not usage:
            out[lib] = "not measured"
            continue
        for name in names:
            found = [u for u in usage if name in u["function"]]
            check(bool(found), f"ptxas reported no {name}: {usage}")
            for u in found:
                check(u.get("spill_store_bytes", 0) == 0 and
                      u.get("spill_load_bytes", 0) == 0 and
                      u.get("stack_bytes", 0) == 0,
                      f"{name}'s build spills or has a stack frame: {u}")
        out[lib] = usage
    print("write_ptxas " + json.dumps(out))
    return out


def load_module(path):
    """The Python module at ``path``, loaded under a name of its own."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"ab_{abs(hash(str(path)))}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def build_libs(kind: str, others: list) -> dict:
    """Each other source of a kernel built with this tree's nvcc flags (all
    at once; their ptxas lines printed) and loaded: {path: library}."""
    import ctypes
    from pathlib import Path

    from yugabyte_db_tpu_torch.ops import native

    native.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for k, other in enumerate(others):
        lib = native.BUILD_DIR / f"lib{kind}-other{k}-{Path(other).stem}.so"
        procs.append((other, lib, subprocess.Popen(
            [native._nvcc(), *native.NVCC_FLAGS, "-o", str(lib),
             str(Path(other).resolve())], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    out = {}
    for other, lib, proc in procs:
        log, _ = proc.communicate(timeout=600)
        check(proc.returncode == 0, f"building {other}: {log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {other}: {line.strip()}")
        out[other] = ctypes.CDLL(str(lib))
    return out


def wrapped_libs(kind: str, others: list, own) -> dict:
    """``build_libs``'s libraries, each bound by the wrapper module that
    speaks its C interface: the one saved beside the source under its
    stem (``OTHER.py``), else ``own``: {name: (library, module)}, this
    tree's as "A"."""
    from pathlib import Path

    libs = {"A": (own._library(), own)}
    for other, lib in build_libs(kind, others).items():
        path = Path(other).with_suffix(".py")
        mod = load_module(path) if path.exists() else own
        libs[other] = (mod.bind(lib), mod)
    return libs


def flush_ab(device, bw: float, rate: float, others: list) -> None:
    """This tree's K12 (A) against other sources of it (B1, ...), in turns
    A B1 .. Bn Bn .. B1 A on one card, on the engine phase's flush (the
    recorded launch: 1,000,000 rows, 1,048,576 slots) and on its columns
    repeated to MAX_COLS + 2 (two calls). Another source is bound and
    launched by the wrapper saved beside it (``wrapped_libs``), so a
    source with an older C interface is called as its own tree called
    it; every call's planes are held byte for byte against the plain
    version, then timed (``cuda_ms``, the output planes allocated in the
    timed call, as the engine's call does)."""
    import torch

    from yugabyte_db_tpu_torch.ops import flush as dflush

    libs = wrapped_libs("flush", others, dflush)
    t0 = time.perf_counter()
    flat = flat_engine(device)
    setup_s = time.perf_counter() - t0
    args, _out = write_log().last_flush
    staged, *rest = args
    cids = list(staged["cols"])
    wide = dict(staged, cols={100 + i: staged["cols"][cids[i % len(cids)]]
                              for i in range(dflush.MAX_COLS + 2)})
    cases = {"engine_flush": args, "cols34": (wide, *rest)}
    order = ["A", *others, *others[::-1], "A"]
    print("flush_ab_setup " + json.dumps({"card": nvidia_smi(),
                                          "setup_s": setup_s,
                                          "ptxas": write_ptxas()}))
    for label, a in cases.items():
        want = dflush.replay_flush_plain(*a)
        tree, perm, dst, gs, is_real, eh, el, R = a
        times = {name: [] for name in libs}

        def call(lib, mod):
            out = dflush._empty_tree(tree, is_real.shape[0], R, device)
            mod.launch(lib, tree, perm, dst, gs, is_real, eh, el, R, out,
                       torch.cuda.current_stream(device).cuda_stream)
            return out

        for name in order:
            lib, mod = libs[name]
            got = call(lib, mod)
            torch.cuda.synchronize()
            err = view_diff(got, want)
            check(err == 0, f"K12 {name} on {label} differs from the plain "
                            f"version by {err}")
            del got
            times[name].append(cuda_ms(lambda: call(lib, mod), KERNEL_REPS,
                                       queue_ahead=True))
        Bp = int(is_real.shape[0])
        n = int((dst < Bp * R).sum())
        nbytes = dflush.replay_bytes(tree, n, int(perm.shape[0]), Bp, R)
        print("flush_ab " + json.dumps({
            "case": label, "rows": n, "slots": Bp * R,
            "columns": len(tree["cols"]), "bytes": int(nbytes),
            "bound_ms": nbytes / bw * 1e3, "ms": times}))
    del flat


def compact_ab(device, bw: float, rate: float, others: list) -> None:
    """This tree's K11 (A) against other sources of it (the same C
    interface, or the wrapper saved beside one: ``wrapped_libs``), in
    turns A B1 .. Bn Bn .. B1 A on one card, on the compact phase's union
    (``compact_table``: 4 runs, 2,050,000 rows, compacted at the newest
    hybrid time; the recorded launch) and on it with its columns repeated
    to 42; every launch held byte for byte against the plain version and
    the numpy twin, then timed (``cuda_ms``)."""
    import torch

    from yugabyte_db_tpu_torch.ops import compact

    libs = wrapped_libs("compact", others, compact)
    t0 = time.perf_counter()
    flat = flat_engine(device)
    table = compact_table(device, flat)
    log = write_log()
    log.masks = []
    table.eng.compact(table.max_ht)
    check(table.eng.compact_paths["k11"] == 1,
          f"compaction routes {table.eng.compact_paths}")
    (runs, idx, new_group, starts, cut), _keep = log.masks[-1]
    setup_s = time.perf_counter() - t0
    wide = tuple(dict(r, sets=tuple(r["sets"][i % len(r["sets"])]
                                    for i in range(42))) for r in runs)
    cases = {"compact_union": (runs, idx, new_group, starts, cut),
             "cols42": (wide, idx, new_group, starts, cut)}
    order = ["A", *others, *others[::-1], "A"]
    print("compact_ab_setup " + json.dumps({"card": nvidia_smi(),
                                            "setup_s": setup_s,
                                            "ptxas": write_ptxas()}))
    for label, a in cases.items():
        rp, ix, _ng, st, ct = a
        times = {name: [] for name in libs}

        def call(lib, mod):
            keep = torch.empty(ix.shape[0], dtype=torch.bool, device=device)
            mod.launch(lib, rp, ix, st, ct, keep,
                       torch.cuda.current_stream(device).cuda_stream)
            return keep

        for name in order:
            lib, mod = libs[name]
            hold_mask((a, call(lib, mod)))
            times[name].append(cuda_ms(lambda: call(lib, mod), KERNEL_REPS,
                                       queue_ahead=True))
        num_cols = len(rp[0]["sets"])
        nbytes = compact.mask_bytes(num_cols, int(ix.shape[0]),
                                    int(st.shape[0]))
        print("compact_ab " + json.dumps({
            "case": label, "rows": int(ix.shape[0]),
            "groups": int(st.shape[0]), "columns": num_cols,
            "bytes": int(nbytes), "bound_ms": nbytes / bw * 1e3,
            "ms": times}))
    del table, flat


def compact_alone(device, bw: float, rate: float) -> None:
    """The compact phase without the others: the engine phase's table
    (flushed by K12, held against the host build), the overlay phase's
    waves on it (applied and flushed as there), and the kernels line's
    K12 and K11 entries."""
    from yugabyte_db_tpu_torch import workload

    flat = flat_engine(device)
    flush_against_host_build(flat, device)
    k12 = measure_k12(write_log().last_flush, bw, rate)
    k12["edges"] = k12_edges(write_log().last_flush)
    print("flush_kernel " + json.dumps(k12))
    ht = flat.max_ht
    for w in range(WAVES + 1):
        wave, ht = workload.make_wave_rows(flat.schema, ENGINE_KEYS,
                                           ENGINE_KEYS // 50, ht, seed=21 + w)
        flat.eng.apply(wave)
        if w < WAVES - 1:
            flush(flat.eng, "overlay")
    flat.sources_read_ht = ht + 1
    comp = compact_phase(device, bw, rate, flat)
    print(json.dumps({"kernels": write_entries(k12, comp)}))


# -- phase 9: the windowed fold K5 past the flat fold's bounds ---------------

FULL_BLOCKS = 16_896  # 34,603,008 rows at R = 2048: past flat_fold.MAX_B
FULL_R = 2048
# (col_id, kind, P(set), P(NULL | set), P(extreme | not NULL)): two i32,
# an i64, an f32 and an f64 column, and a never-set i64 one. The floats
# are positive (workload.FLOAT_RANGE), so a sum's sum of |x| is the sum.
FULL_COLUMNS = ((1, "i32", 0.97, 0.03, 0.001), (2, "i32", 0.95, 0.05, 0.001),
                (3, "i64", 0.99, 0.02, 0.001), (4, "f32", 0.95, 0.05, 0.0),
                (5, "f64", 0.97, 0.03, 0.0), (6, "i64", 0.0, 0.0, 0.0))
FULL_WIDE_BLOCKS = 512  # 1,048,576 rows of 18 value columns (an edge)
FULL_R64_BLOCKS = 8192  # 524,288 rows at R = 64: 1,024 windows (an edge)
FULL_R33_BLOCKS = 16384  # 540,672 rows at R = 33: 2,048 windows (an edge)
FULL_KEYS = 1_100_000   # the bench table at rows_per_block 64: 17,188
FULL_ENGINE_R = 64      # blocks, past flat_fold.MAX_B
FULL_WRITES = 1_000     # rows written to the memtable over that run
FULL_BATCH = 32
FULL_SUM_TOL = 1e-5     # |float sum - plain's| <= this x sum of |x|
# Float32 operations per second outside the tensor cores (H100 SXM data
# sheet at 700 W): K5's float sums and f32 extremes are held against it.
_F32_FLOPS = 67e12


def full_int_ops(plan) -> float:
    """K5's integer operations per row and spec in the spec's range, as
    the function needs them: a compare per order plane of each predicate,
    two adds per order-plane word of an integer SUM, one min/max op for an
    i32 MIN/MAX and a 64-bit compare and select (4) for a two-plane one,
    and the count slots' popcount and add per 32-row mask word."""
    n = sum(1 if p.kind == "i32" else 2 for p in plan.preds)
    for a in plan.aggs:
        if a.fn == "count" or a.kind == "f32" or (
                a.fn == "sum" and a.kind == "f64"):
            continue
        width = 1 if a.kind == "i32" else 2
        n += 2 * width if a.fn == "sum" else (1 if width == 1 else 4)
    return n + 2 * (1 + len(plan.aggs)) / 32


def full_float_ops(plan) -> int:
    """K5's float operations per row and spec: an add per float SUM, a
    min/max per f32 MIN/MAX."""
    return sum(1 for a in plan.aggs if a.fn != "count" and (
        a.kind == "f32" or (a.fn == "sum" and a.kind == "f64")))


def full_sums(plan, ivec, fvec) -> list:
    """Each float SUM's fsum - fcomp of packed rows, [spec][sum]."""
    from yugabyte_db_tpu_torch.ops import agg_fold

    out = []
    for iv, fv in zip(ivec.tolist(), fvec.tolist()):
        acc, _n = agg_fold.unpack(plan.aggs, iv, fv)
        out.append([a["fsum"] - a["fcomp"] for ag, a in zip(plan.aggs, acc)
                    if ag.fn == "sum" and ag.kind in ("f32", "f64")])
    return out


def hold_full(plan, arrays, params: np.ndarray, signed: bool,
              mod=None) -> dict:
    """K5 against its plain version on the same inputs: the ivec exactly,
    each float SUM within FULL_SUM_TOL x the sum of |x| (from the plain
    version over |arith| where the values may be negative, else the
    plain sum itself), the float extremes exactly; this tree's launch
    shape against ``launch_geometry``. ``mod``: another wrapper module
    (``full_ab``) that launches its own source, shape unchecked."""
    import torch

    from yugabyte_db_tpu_torch.ops import full_agg

    if mod is None:
        got_i, got_f = full_agg.full_aggregate(plan, arrays, params)
        geo = full_agg.last_launch()
        check(geo == full_agg.launch_geometry(
            plan, params, arrays["valid"].shape[0] // plan.K),
            f"K5's launch {geo} differs from launch_geometry")
    else:
        got_i, got_f = mod.full_aggregate(mod.make_plan(
            plan.aggs, plan.preds, plan.cols, plan.R, plan.K), arrays,
            params)
        geo = None
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want_i, want_f = full_agg.full_aggregate_plain(plan, arrays, params)
    end.record()
    torch.cuda.synchronize()
    diff = (got_i.long() - want_i.long()).abs()
    err = int(diff.max()) if diff.numel() else 0
    check(err == 0, f"K5 ivec != plain version (max |diff| {err}) for "
                    f"{plan.aggs} {plan.preds}")
    if signed:
        absolute = dict(arrays, cols={
            cid: dict(c, arith=c["arith"].abs()) if "arith" in c else c
            for cid, c in arrays["cols"].items()})
        scale = full_sums(plan, *full_agg.full_aggregate_plain(
            plan, absolute, params))
    else:
        scale = [[abs(x) for x in row] for row in full_sums(plan, want_i,
                                                           want_f)]
    worst = 0.0
    for g, w, sc in zip(full_sums(plan, got_i, got_f),
                        full_sums(plan, want_i, want_f), scale):
        for x, y, a in zip(g, w, sc):
            check(abs(x - y) <= FULL_SUM_TOL * a,
                  f"K5 float sum {x} vs plain {y} (sum of |x| {a})")
            worst = max(worst, abs(x - y) / a if a else 0.0)
    sums = [k for k, ag in enumerate(plan.aggs)
            if ag.fn == "sum" and ag.kind in ("f32", "f64")]
    ext_cols = [plan.foffs[k] for k, ag in enumerate(plan.aggs)
                if ag.fn in ("min", "max") and ag.kind == "f32"]
    for col in ext_cols:
        check(torch.equal(got_f[:, col], want_f[:, col]),
              "K5 f32 MIN/MAX != plain version")
    return {"max_abs_err": err, "float_sums": len(sums) * params.shape[0],
            "worst_sum_rel_err": worst, "geometry": geo,
            "plain_once_ms": start.elapsed_time(end),
            "ivec": got_i.cpu(), "fvec": got_f.cpu()}


def measure_full(plan, arrays, params: np.ndarray, bw: float, rate: float,
                 signed: bool = False, plain_reps: int = PLAIN_REPS) -> dict:
    """K5 held against its plain version, then timed (CUDA events, median
    of KERNEL_REPS calls queued behind a parked stream, and of calls
    timed one by one; the plain version the median of
    ``plain_reps``, or with 0 its one call of the hold) beside its bound:
    bytes of the planes over the covered rows (each read once), the
    parameter rows and the outputs; integer operations over the int32
    rate and float ones over the f32 rate."""
    from yugabyte_db_tpu_torch.ops import full_agg

    held = hold_full(plan, arrays, params, signed)
    # The device's time: the wrapper waits on nothing, so the calls queue
    # behind a parked stream and run back to back. Beside it, CUDA events
    # around each call, as K5's first design was timed (host work
    # included).
    ms = cuda_ms(lambda: full_agg.full_aggregate(plan, arrays, params),
                 KERNEL_REPS, queue_ahead=True)
    event_ms = cuda_ms(lambda: full_agg.full_aggregate(plan, arrays, params),
                       KERNEL_REPS)
    plain_ms = held["plain_once_ms"] if not plain_reps else cuda_ms(
        lambda: full_agg.full_aggregate_plain(plan, arrays, params),
        plain_reps)
    ivec = held.pop("ivec")
    held.pop("fvec")
    return {"specs": params.shape[0], "ms": ms, "event_ms": event_ms,
            "plain_ms": plain_ms,
            **full_bound(plan, arrays, params, bw, rate),
            "scanned": int(ivec[:, 0].sum()), **held}


def full_bound(plan, arrays, params: np.ndarray, bw: float,
               rate: float) -> dict:
    """K5's bound on these inputs: bytes of the planes over the covered
    rows (each read once), the parameter rows and the outputs; integer
    operations over the int32 rate and float ones over the f32 rate."""
    table = plan.plane_table(arrays)
    n_rows = table[0].numel()
    rows = covered_rows(params, n_rows)
    # A K5 row's read point follows its window range (row_lo, row_hi,
    # w_first, w_last, read planes): K1's layout without the windows.
    n_reads, vis_rows = visibility_rows(params[:, [0, 1, 4, 5, 6, 7]],
                                        n_rows)
    in_ranges = rows_in_ranges(params, n_rows)
    nbytes = (rows * plan.bytes_per_row(table) + params.nbytes
              + params.shape[0] * (4 * plan.n_ints + 4 * plan.n_floats))
    int_ops = (rows * (1 + len(plan.cols)) / 4 + vis_rows * VISIBILITY_OPS
               + in_ranges * full_int_ops(plan))
    bytes_ms = nbytes / bw * 1e3
    ops_ms = max(int_ops / rate, in_ranges * full_float_ops(plan)
                 / _F32_FLOPS) * 1e3
    return {"rows": rows, "read_points": n_reads,
            "bytes_per_row": plan.bytes_per_row(table),
            "bound_ms": max(bytes_ms, ops_ms), "bytes_ms": bytes_ms,
            "ops_ms": ops_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def full_plan(aggs, preds, columns, R: int):
    from yugabyte_db_tpu_torch.ops import agg_fold, full_agg
    from yugabyte_db_tpu_torch.ops.scan import ColSig

    return full_agg.make_plan(
        tuple(aggs), tuple(preds),
        tuple(ColSig(c[0], c[1]) for c in columns), R,
        agg_fold.safe_window_blocks(R, agg_fold.FULL_WINDOW_BLOCKS))


def lit_f64(v: float) -> np.ndarray:
    from yugabyte_db_tpu_torch.utils import planes as P

    hi, lo = P.f64_to_ordered_planes(np.array([v], np.float64))
    return np.array([hi[0], lo[0]], np.int32)


def full_params(plan, rows, W: int) -> np.ndarray:
    """[N, P] parameter rows of (row_lo, row_hi, read_ht, literals), each
    over the windows its rows cover."""
    from yugabyte_db_tpu_torch.ops import agg_fold

    return np.array([plan.param_row(
        lo, hi, *agg_fold.window_bounds(lo, hi, plan.R, plan.K, W),
        read_params(rd), lits) for lo, hi, rd, lits in rows], np.int32)


def full_signatures(reads: dict, n_rows: int, W: int):
    """(label, plan, [N, P] params) of every timed signature on the
    full-width planes."""
    from yugabyte_db_tpu_torch.ops.scan import AggSig, PredSig

    kind = {c[0]: c[1] for c in FULL_COLUMNS}

    def A(fn, c=None):
        return AggSig(fn, c, kind.get(c))

    cnt = A("count")
    f64 = (cnt, A("sum", 5), A("min", 5), A("max", 5))
    f32 = (A("count", 4), A("sum", 4), A("min", 4), A("max", 4))
    rng_preds = (PredSig(5, "f64", ">="), PredSig(5, "f64", "<"))
    rng_lits = (lit_f64(250.0), lit_f64(750.0))
    nine = (cnt, A("count", 1), A("sum", 1), A("sum", 3), A("min", 3),
            A("max", 3), A("sum", 5), A("min", 4), A("max", 2))
    all_, mid = reads["all"], reads["mid"]
    window = n_rows // W
    sigs = [
        ("f64_sum_min_max", f64, (), [(0, n_rows, all_, ())]),
        ("f32_sum_min_max", f32, (), [(0, n_rows, all_, ())]),
        ("count", (cnt,), (), [(0, n_rows, all_, ())]),
        ("f64_range_pred", f64 + f32, rng_preds,
         [(0, n_rows, all_, rng_lits)]),
        ("nine_aggs", nine, rng_preds[:1], [(0, n_rows, all_, rng_lits[:1])]),
        ("bounded_mid_window", f64, rng_preds[:1],
         [((W // 4) * window + window // 2 + 3,
           n_rows - (W // 4) * window - window // 3 - 11, all_,
           rng_lits[:1])]),
        ("mid_history_read", f64, rng_preds[:1],
         [(0, n_rows, mid, rng_lits[:1])]),
    ]
    rng = np.random.default_rng(8)
    batch = []
    for i in range(FULL_BATCH):
        lo = int(rng.integers(0, n_rows // 4)) if i % 4 == 1 else 0
        hi = n_rows - int(rng.integers(0, n_rows // 4)) if i % 4 == 2 \
            else n_rows
        rd = mid if i % 4 == 3 else all_
        batch.append((lo, hi, rd, (lit_f64(100.0 + 25.0 * i),)))
    sigs.append(("batch32", f64, rng_preds[:1], batch))
    out = []
    for label, aggs, preds, rows in sigs:
        plan = full_plan(aggs, preds, FULL_COLUMNS, FULL_R)
        out.append((label, plan, full_params(plan, rows, W)))
    return out


def full_kernel(device, bw: float, rate: float) -> dict:
    """K5 on ``workload.flat_planes`` at FULL_BLOCKS x FULL_R (made from a
    seed in numpy, then uploaded): every signature held and timed, then
    the edges on them, untimed: an empty range and a first window past
    0, and ``full_batch_edges``."""
    import torch

    from yugabyte_db_tpu_torch import workload
    from yugabyte_db_tpu_torch.ops import flat_fold
    from yugabyte_db_tpu_torch.ops.device_run import DeviceRun

    t0 = time.perf_counter()
    planes, reads = workload.flat_planes(FULL_BLOCKS, FULL_R, FULL_COLUMNS,
                                         seed=19)
    gen_s = time.perf_counter() - t0
    for cid, kind, *_rest in FULL_COLUMNS:
        if kind in ("f32", "f64"):
            check(float(planes["cols"][cid]["arith"].min()) >= 0.0,
                  f"column {cid} holds a negative value")
    t0 = time.perf_counter()
    run = DeviceRun.from_reference_planes(planes, FULL_R, device)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    del planes
    n_rows, W = run.B * FULL_R, run.B // 8
    check(run.B > flat_fold.MAX_B, "the full-width planes are within the "
                                   "flat fold's bounds")
    print(f"full phase: {n_rows} rows ({run.B} blocks of {FULL_R}), "
          f"{run.nbytes} bytes of planes, made in {gen_s:.1f} s, uploaded "
          f"in {upload_s:.1f} s")
    out = {"rows": n_rows, "blocks": run.B, "plane_bytes": run.nbytes,
           "generate_s": gen_s, "upload_s": upload_s, "signatures": {}}
    for label, plan, params in full_signatures(reads, n_rows, W):
        # The batch's plain version (32 specs, one after another) is
        # timed by its one call of the hold.
        row = measure_full(plan, run.arrays, params, bw, rate,
                           plain_reps=0 if label == "batch32" else PLAIN_REPS)
        check(row["scanned"] > 0, f"{label}: no row in range")
        out["signatures"][label] = row
        print("full_signature " + json.dumps({"signature": label, **row}))
    by = out["signatures"]
    print("full_batch_vs_single " + json.dumps({
        "batch32_ms": by["batch32"]["ms"],
        "single_ms": by["f64_sum_min_max"]["ms"],
        "batch32_over_32x_single":
            by["batch32"]["ms"] / (FULL_BATCH * by["f64_sum_min_max"]["ms"])}))
    _label, plan, params = full_signatures(reads, n_rows, W)[3]
    edge_rows = [plan.param_row(5, 5, 0, 0, read_params(reads["all"]),
                                (lit_f64(250.0), lit_f64(750.0))),
                 plan.param_row(0, n_rows, max(1, W // 8),
                                W - W // 16,
                                read_params(reads["early"]),
                                (lit_f64(100.0), lit_f64(900.0)))]
    edge = hold_full(plan, run.arrays, np.array(edge_rows, np.int32), False)
    check(int(edge["ivec"][0, 0]) == 0 and int(edge["ivec"][1, 0]) > 0,
          "K5's empty-range / first-window edge")
    out["edges"] = {"empty_range_and_first_window": edge["max_abs_err"]}
    print("full_edge empty_range_and_first_window: exact")
    # One spec chunk + 1 specs (two chunks), at more read points than a
    # chunk stages, each with a range and a literal of its own; then specs
    # over disjoint window ranges.
    _label, plan, _params = full_signatures(reads, n_rows, W)[-1]
    for label, rows in full_batch_edges(reads, n_rows, W).items():
        edge = hold_full(plan, run.arrays, full_params(plan, rows, W), False)
        check(int(edge["ivec"][:, 0].min()) > 0, f"K5's {label} edge is "
                                                  f"empty")
        out["edges"][label] = edge["max_abs_err"]
        print(f"full_edge {label}: {len(rows)} specs, "
              f"{edge['geometry']['chunks']} chunks, exact")
    return out


def full_batch_edges(reads: dict, n_rows: int, W: int) -> dict:
    """(row_lo, row_hi, read_ht, literals) rows of the batch edges: a
    chunk + 1 specs at 12 read points with ranges from mid-window, and 4
    specs over disjoint quarters of the run."""
    from yugabyte_db_tpu_torch.ops import full_agg

    rng = np.random.default_rng(29)
    pts = [reads["early"] + (reads["all"] - reads["early"]) * i // 11
           for i in range(12)]
    chunk1 = [(int(rng.integers(0, n_rows // 3)),
               n_rows - int(rng.integers(0, n_rows // 3)), pts[i % 12],
               (lit_f64(100.0 + 7.0 * i),))
              for i in range(full_agg.MAX_SPEC_CHUNK + 1)]
    quarter = n_rows // 4
    disjoint = [(k * quarter + 1000 + k, (k + 1) * quarter - 999 - k,
                 pts[3 * k], (lit_f64(200.0 + 100.0 * k),))
                for k in range(4)]
    return {"chunk_plus_one": chunk1, "disjoint_windows": disjoint}


def full_edges(device, mvcc) -> dict:
    """K5 held exactly against its plain version, untimed: 18 value
    columns at 1,048,576 rows (10 predicates, 12 aggregates, a bounded
    range and a first window past 0; then 21 aggregates in 5 passes),
    R = 64 planes at FULL_R64_BLOCKS blocks (several windows a block),
    R = 33 planes at FULL_R33_BLOCKS blocks (plain loads), and the view
    that the resolve makes of the mvcc phase's run at its newest read
    point."""
    from yugabyte_db_tpu_torch import workload
    from yugabyte_db_tpu_torch.ops import mvcc_resolve
    from yugabyte_db_tpu_torch.ops.device_run import DeviceRun
    from yugabyte_db_tpu_torch.ops.scan import AggSig, PredSig

    cols = tuple((c, ("i32", "i64", "f32", "f64")[c % 4], 0.9, 0.05,
                  0.001 if c % 4 < 2 else 0.0) for c in range(1, 19))
    kind = {c[0]: c[1] for c in cols}
    planes, reads = workload.flat_planes(FULL_WIDE_BLOCKS, FULL_R, cols,
                                         seed=23)
    run = DeviceRun.from_reference_planes(planes, FULL_R, device)
    del planes
    exact_cols = [c for c in kind if kind[c] != "f32"]
    ops = ("!=", ">=", "<=", ">", "<", "!=", ">=", "<=", ">", "<")
    bound = {"i32": 10**6 + 1, "i64": 10**12 + 1, "f64": 2000.0}
    lit = {"i32": np.int32, "i64": lit_i64, "f64": lit_f64}
    preds, lits = [], []
    for c, op in zip(exact_cols[:10], ops):
        x = {"!=": 0, ">=": -bound[kind[c]], ">": -bound[kind[c]],
             "<=": bound[kind[c]], "<": bound[kind[c]]}[op]
        if kind[c] == "f64" and op == "!=":
            x = 0.0
        preds.append(PredSig(c, kind[c], op))
        lits.append(lit[kind[c]](x))
    aggs = tuple(AggSig(fn, c, kind[c]) for fn, c in zip(
        ("sum", "min", "max", "count") * 3, range(7, 19)))
    plan = full_plan(aggs, preds, cols, FULL_R)
    n, W = run.B * FULL_R, run.B // plan.K
    rows = [(0, n, reads["all"], tuple(lits)),
            (FULL_R * 3 + 17, n - FULL_R * 9 - 1, reads["mid"], tuple(lits))]
    params = full_params(plan, rows, W)
    params = np.concatenate([params, np.array([plan.param_row(
        0, n, max(1, W // 8), W - W // 16, read_params(reads["early"]),
        tuple(lits))],
        np.int32)])
    wide = hold_full(plan, run.arrays, params, False)
    check(int(wide["ivec"][:, 0].min()) > 0, "the 18-column edge is empty")
    print(f"full_edge wide: {n} rows, {len(cols)} columns, {len(preds)} "
          f"predicates, {len(aggs)} aggregates, exact")
    # The same columns with every SUM, MIN, MAX and COUNT of 5 columns
    # (one of each kind, and a column a predicate also reads): several
    # aggregates a pass and more passes than a column holds.
    pplan = full_plan((AggSig("count", None, None),) + tuple(
        AggSig(fn, c, kind[c]) for c in (1, 2, 3, 4, 8)
        for fn in ("sum", "min", "max", "count")), preds[:3], cols, FULL_R)
    passes = hold_full(pplan, run.arrays, full_params(pplan, [
        (r[0], r[1], r[2], r[3][:3]) for r in rows], W), False)
    check(passes["geometry"]["passes"] == 5, "the pass edge's passes")
    print(f"full_edge passes: {len(pplan.aggs)} aggregates in "
          f"{len(pplan.passes)} passes, exact")
    del run
    # R = 64: a run of windows a block.
    planes, reads = workload.flat_planes(FULL_R64_BLOCKS, FULL_ENGINE_R,
                                         FULL_COLUMNS, seed=37)
    run = DeviceRun.from_reference_planes(planes, FULL_ENGINE_R, device)
    del planes
    kind64 = {c[0]: c[1] for c in FULL_COLUMNS}
    rplan = full_plan((AggSig("count", None, None), AggSig("sum", 5, "f64"),
                       AggSig("min", 5, "f64"), AggSig("max", 3, "i64"),
                       AggSig("sum", 1, "i32")),
                      (PredSig(2, kind64[2], ">="),), FULL_COLUMNS,
                      FULL_ENGINE_R)
    n, W = run.B * FULL_ENGINE_R, run.B // rplan.K
    rparams = full_params(rplan, [
        (0, n, reads["all"], (np.int32(-500_000),)),
        (FULL_ENGINE_R * 5 + 3, n - 1001, reads["mid"], (np.int32(0),)),
        (n // 3, n // 3 + 7 * FULL_ENGINE_R, reads["early"],
         (np.int32(-10**6),))], W)
    runs = hold_full(rplan, run.arrays, rparams, False)
    check(runs["geometry"]["windows_per_block"] > 1,
          "the R = 64 edge has one window a block")
    print(f"full_edge r64_runs: {n} rows, "
          f"{runs['geometry']['windows_per_block']} windows a block, exact")
    del run
    # R = 33: windows of 264 rows, not a multiple of 16, take plain loads
    # in place of the asynchronous copy.
    planes, reads = workload.flat_planes(FULL_R33_BLOCKS, 33, FULL_COLUMNS,
                                         seed=41)
    run = DeviceRun.from_reference_planes(planes, 33, device)
    del planes
    oplan = full_plan(rplan.aggs, rplan.preds, FULL_COLUMNS, 33)
    n, W = run.B * 33, run.B // oplan.K
    odd = hold_full(oplan, run.arrays, full_params(oplan, [
        (0, n, reads["all"], (np.int32(-500_000),)),
        (33 * 5 + 3, n - 1001, reads["mid"], (np.int32(0),))], W), False)
    check(odd["geometry"]["async_copy"] == 0,
          "the R = 33 edge took the asynchronous copy")
    print(f"full_edge r33_plain_loads: {n} rows, exact")
    del run

    trun = mvcc.eng.runs[0]
    view = mvcc_resolve.resolve_view(trun.dev.arrays,
                                     *read_params(mvcc.max_ht + 1),
                                     trun.resident().const)
    vkind = {c.col_id: ("f64" if c.name == "c" else
                        "i64" if c.name == "a" else "i32")
             for c in mvcc.schema.value_columns}
    name = {c.name: c.col_id for c in mvcc.schema.value_columns}
    a, c, d = name["a"], name["c"], name["d"]
    vcols = tuple((cid, k) for cid, k in vkind.items())
    vplan = full_plan(
        (AggSig("count", None, None), AggSig("sum", a, "i64"),
         AggSig("min", a, "i64"), AggSig("max", a, "i64"),
         AggSig("sum", c, "f64"), AggSig("min", c, "f64"),
         AggSig("max", c, "f64"), AggSig("sum", d, "i32")),
        (PredSig(c, "f64", ">="),), vcols, trun.crun.R)
    vn = view["valid"].numel()
    vparams = full_params(vplan, [(0, vn, mvcc.max_ht + 1, (lit_f64(0.0),)),
                                  (0, vn, mvcc.max_ht + 1,
                                   (lit_f64(-5e5),))],
                          view["valid"].shape[0] // vplan.K)
    held = hold_full(vplan, view, vparams, True)
    check(int(held["ivec"][:, 0].min()) > 0, "the view edge is empty")
    print(f"full_edge view: {vn} rows, the mvcc run's view at its newest "
          f"read point, exact; worst float sum {held['worst_sum_rel_err']}")
    return {"wide": wide["max_abs_err"], "passes": passes["max_abs_err"],
            "r64_runs": runs["max_abs_err"],
            "r33_plain_loads": odd["max_abs_err"],
            "view": held["max_abs_err"]}


def c_pred_answer(arrays: tuple, c_lo: float) -> tuple:
    """Exact answers of ``count(*), sum(a), min(a), max(a), sum(d),
    sum(c) where c >= c_lo and d >= -1000000`` over ``Oracle.arrays`` (the
    rows with a non-NULL d): (the integer part, sum(c), sum of |c|)."""
    d, a, a_ok, c, c_ok = arrays
    m = c_ok & (c >= c_lo)
    ma = m & a_ok
    has = bool(ma.any())
    ints = (int(m.sum()), int(a[ma].sum()) if has else None,
            int(a[ma].min()) if has else None,
            int(a[ma].max()) if has else None,
            int(d[m].sum()) if m.any() else None)
    return ints, float(c[m].sum()), float(np.abs(c[m]).sum())


def full_engine(device, bw: float, rate: float) -> dict:
    """The engine's route "full": the bench table at FULL_KEYS keys and
    rows_per_block FULL_ENGINE_R (one flat run past flat_fold.MAX_B
    blocks). A float spec and an f64-predicate spec, alone and in a
    32-spec batch, must take route "full" (``stats()["agg_routes"]``) and
    equal an exact oracle over the generated rows (integers exactly, float
    sums within FULL_SUM_TOL x the sum of |c|); then FULL_WRITES rows go
    to the memtable and the overlay's masked primary must take the same
    route and equal the oracle of the history. K5's launches are counted
    over that run; K5 is then held and timed at the engine's batch."""
    from yugabyte_db_tpu_torch import workload
    from yugabyte_db_tpu_torch.ops import full_agg

    schema, rows, max_ht, eng, gen_s, load_s = full_engine_table(device)
    float_spec, pred_spec = full_specs()
    cid = {c.name: c.col_id for c in schema.columns}
    arrays = Oracle.arrays([(r.columns[cid["d"]], r.columns[cid["a"]],
                             r.columns[cid["c"]])
                            for r in rows if not r.tombstone])
    oracle = Oracle(*arrays)
    read = max_ht + 1

    def check_float(got, orc, lo, label):
        want_s, want_min, want_max, abs_sum = orc.c_aggs(lo)
        check(abs(got[0] - want_s) <= FULL_SUM_TOL * abs_sum,
              f"{label}: sum(c) {got[0]} vs {want_s}")
        check(tuple(got[1:]) == (want_min, want_max),
              f"{label}: min/max(c) {got[1:]} vs {(want_min, want_max)}")

    def check_pred(got, arr, x, label):
        ints, want_c, abs_c = c_pred_answer(arr, x)
        check(tuple(got[:5]) == ints, f"{label}: {got[:5]} != {ints}")
        check(abs(got[5] - want_c) <= FULL_SUM_TOL * abs_c,
              f"{label}: sum(c) {got[5]} vs {want_c}")

    los, xs = FULL_LOS, FULL_XS
    for spec in (float_spec(read, 0), pred_spec(read, 0.0)):
        check(eng._plan_scan(spec).route == "full",
              "a K5 spec does not take route full")
    # The main path, counted.
    full_agg.full_aggregate.launches = 0
    routes0 = eng.stats()["agg_routes"]["full"]
    lat = []
    for _ in range(5):
        t = time.perf_counter()
        got = eng.scan(float_spec(read, 0)).rows[0]
        lat.append((time.perf_counter() - t) * 1e3)
    check_float(got, oracle, 0, "full float scan")
    check_pred(eng.scan(pred_spec(read, 0.0)).rows[0], arrays, 0.0,
               "full f64-predicate scan")
    specs = [float_spec(read, lo) for lo in los] + \
        [pred_spec(read, x) for x in xs]
    t = time.perf_counter()
    res = eng.scan_batch(specs)
    batch_ms = (time.perf_counter() - t) * 1e3
    for lo, r in zip(los, res):
        check_float(r.rows[0], oracle, lo, f"full batch d >= {lo}")
    for x, r in zip(xs, res[len(los):]):
        check_pred(r.rows[0], arrays, x, f"full batch c >= {x}")
    # The same batch traced: the device's busy share, K5's device time
    # (its two kernels) and the host's time per batch.
    trace = trace_batches(eng, [specs] * FULL_TRACE_BATCHES)
    by = trace["device_ms_by_kernel"]
    trace["k5_device_ms_per_batch"] = "not measured" if isinstance(
        by, str) else sum(ms for name, ms in by.items()
                          if "window_kernel" in name or "fold_kernel" in name
                          ) / FULL_TRACE_BATCHES
    print("full_trace " + json.dumps(trace))
    flat_scans = 5 + 1 + len(specs) * (1 + FULL_TRACE_BATCHES)
    check(eng.stats()["agg_routes"]["full"] == routes0 + flat_scans,
          "the K5 specs did not all take route full")
    # The overlay: FULL_WRITES rows over the run, in the memtable.
    wave, top = workload.make_wave_rows(schema, FULL_KEYS, FULL_WRITES,
                                        max_ht, seed=31)
    eng.apply(wave)
    history = HistoryOracle(schema, rows, wave)
    ov_arrays = history.arrays(top + 1)
    ov_oracle = Oracle(*ov_arrays)
    for spec in (float_spec(top + 1, 0), pred_spec(top + 1, 0.0)):
        prep = eng._plan_scan(spec)
        check(prep.overlay is not None and prep.route == "full",
              "the overlay's masked primary does not take route full")
    t = time.perf_counter()
    got = eng.scan(float_spec(top + 1, 0)).rows[0]
    overlay_first_ms = (time.perf_counter() - t) * 1e3
    check_float(got, ov_oracle, 0, "full overlay float scan")
    for x in (-5e5, 0.0, 7.5e5):
        check_pred(eng.scan(pred_spec(top + 1, x)).rows[0], ov_arrays, x,
                   f"full overlay c >= {x}")
    check(eng.stats()["agg_routes"]["full"] == routes0 + flat_scans + 4,
          "the overlay's K5 specs did not all take route full")
    launches = full_agg.full_aggregate.launches
    check(launches > 0, "the main path launched K5 0 times")
    check(eng.stats()["full_launches"] == launches,
          "the engine's K5 count differs from the wrapper's")
    # K5 at the engine's shapes: the batch's K5 specs on the run, held
    # and timed outside the counted run.
    preps = [eng._plan_scan(float_spec(read, lo)) for lo in los]
    p0 = preps[0]
    check(p0.overlay is not None, "the engine's batch is not on the overlay")
    plan = full_plan(p0.sig.aggs, p0.sig.preds,
                     [(cs.col_id, cs.kind) for cs in p0.sig.cols],
                     FULL_ENGINE_R)
    masked = p0.trun.dev.arrays
    W = masked["valid"].shape[0] // plan.K
    params = full_params(plan, [(p.row_lo, p.row_hi, read, p.lits)
                                for p in preps], W)
    kernel = measure_full(plan, masked, params, bw, rate, signed=True)
    print("full_engine_kernel " + json.dumps(kernel))
    row = {"keys": FULL_KEYS, "blocks": eng.runs[0].crun.B,
           "rows_per_block": FULL_ENGINE_R, "generate_s": gen_s,
           "load_s": load_s, "single_scan_ms": statistics.median(lat),
           "single_scan_ms_each": lat, "batch_ms": batch_ms,
           "batch_specs": len(specs), "overlay_first_scan_ms":
           overlay_first_ms, "memtable_rows": FULL_WRITES,
           "agg_routes": eng.stats()["agg_routes"], "launches": launches}
    print("full_engine " + json.dumps(row))
    row["kernel"] = kernel
    row["trace"] = trace
    return row


FULL_LOS = [-900_000 + 61_357 * i for i in range(FULL_BATCH // 2)]
FULL_XS = [-9e5 + 1.2e5 * i for i in range(FULL_BATCH // 2)]
FULL_TRACE_BATCHES = 2


def full_specs() -> tuple:
    """The route's two spec makers: a float spec (SUM/MIN/MAX of c under
    d >= lo) and an f64-predicate spec (c >= x), each of a read point."""
    from yugabyte_db_tpu_torch.storage import AggSpec, Predicate, ScanSpec

    def float_spec(rd, lo):
        return ScanSpec(read_ht=rd, predicates=[Predicate("d", ">=", lo)],
                        aggregates=[AggSpec("sum", "c"), AggSpec("min", "c"),
                                    AggSpec("max", "c")])

    def pred_spec(rd, x):
        return ScanSpec(read_ht=rd, predicates=[
            Predicate("c", ">=", x), Predicate("d", ">=", -10**6)],
            aggregates=[AggSpec("count", None), AggSpec("sum", "a"),
                        AggSpec("min", "a"), AggSpec("max", "a"),
                        AggSpec("sum", "d"), AggSpec("sum", "c")])

    return float_spec, pred_spec


def full_engine_table(device) -> tuple:
    """The bench table at FULL_KEYS keys in one flat run at rows_per_block
    FULL_ENGINE_R, past flat_fold.MAX_B blocks: (schema, rows, max_ht,
    engine, generation s, load s)."""
    from yugabyte_db_tpu_torch import workload
    from yugabyte_db_tpu_torch.ops import flat_fold
    from yugabyte_db_tpu_torch.storage import make_engine

    t0 = time.perf_counter()
    schema = workload.make_schema()
    # The engine phase's rows (made once a process), then the keys past
    # them at later hybrid times.
    rows, max_ht = bench_rows(schema, ENGINE_KEYS)
    tail, max_ht = workload.make_rows(schema, FULL_KEYS - ENGINE_KEYS,
                                      seed=4, first=ENGINE_KEYS, ht=max_ht)
    rows = rows + tail
    gen_s = time.perf_counter() - t0
    eng = make_engine("gpu", schema, {"rows_per_block": FULL_ENGINE_R,
                                      "device": device})
    t0 = time.perf_counter()
    eng.apply(rows)
    flush(eng, "full")
    load_s = time.perf_counter() - t0
    check(eng.runs[0].crun.B > flat_fold.MAX_B,
          f"{eng.runs[0].crun.B} blocks are within the flat fold's bounds")
    return schema, rows, max_ht, eng, gen_s, load_s


def full_phase(device, bw: float, rate: float, mvcc) -> dict:
    """K5 at full width, its edges and the engine's route "full"."""
    import torch

    out = {"kernel": full_kernel(device, bw, rate)}
    torch.cuda.empty_cache()
    out["edges"] = full_edges(device, mvcc)
    torch.cuda.empty_cache()
    out["engine"] = full_engine(device, bw, rate)
    return out


def full_entry(full: dict) -> dict:
    """The kernels line's K5 entry: the f64 SUM/MIN/MAX signature over the
    full-width planes as the headline, the other signatures and the
    engine's batch beside it, launches of the engine's counted run, the
    build's registers (no spill, no stack frame)."""
    usage = ptxas_usage("full_agg")
    check(all(u.get("spill_store_bytes", 0) == 0 and
              u.get("spill_load_bytes", 0) == 0 and
              u.get("stack_bytes", 0) == 0 for u in usage),
          f"K5's build spills or has a stack frame: {usage}")
    sigs, eng = full["kernel"]["signatures"], full["engine"]
    head = sigs["f64_sum_min_max"]
    err = max([r["max_abs_err"] for r in sigs.values()]
              + list(full["kernel"]["edges"].values())
              + list(full["edges"].values())
              + [eng["kernel"]["max_abs_err"]])
    return {
        "name": "full_agg", "route": "cuda",
        "source": "yugabyte_db_tpu_torch/csrc/full_agg.cu",
        "replaces": "yugabyte_db_tpu/ops/agg_fold.py:336",
        "launches": eng["launches"],
        "launches_by_path": {"full_engine": eng["launches"]},
        "max_abs_err": err, "max_abs_diff": err, "ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": None,
        "library_note": "no single PyTorch call folds windows into exact "
                        "base-2^16 digits",
        "rows": full["kernel"]["rows"],
        **{f"{label}_{key}": r[key] for label, r in sigs.items()
           if label != "f64_sum_min_max"
           for key in ("ms", "plain_ms", "bound_ms")},
        "engine_batch_ms": eng["kernel"]["ms"],
        "engine_batch_plain_ms": eng["kernel"]["plain_ms"],
        "engine_batch_bound_ms": eng["kernel"]["bound_ms"],
        "ptxas": usage if usage else "not measured"}


def full_alone(device, bw: float, rate: float) -> None:
    """The full phase without the others, over a multi-version run of
    200,000 keys and 200,000 updates for its view edge; prints the
    kernels line's K5 entry."""
    global MVCC_KEYS, MVCC_UPDATES

    MVCC_KEYS = MVCC_UPDATES = 200_000
    schema, rows, updates, _l, max_ht, eng, _g, _a = mvcc_engine(device)
    mvcc = SimpleNamespace(schema=schema, rows=rows, updates=updates,
                           max_ht=max_ht, eng=eng)
    full = full_phase(device, bw, rate, mvcc)
    print(json.dumps({"kernels": [full_entry(full)]}))


def full_ab(device, bw: float, rate: float, others: list) -> None:
    """This tree's K5 (A) against other sources of it (B1, ...), in turns
    A B1 .. Bn Bn .. B1 A on one card, on every ``full_signature`` over
    the full-width planes and on the engine's 16-spec launch (the route's
    float specs on its run at R = 64). Another source is launched by the
    wrapper saved beside it as ``OTHER.py`` (else by this tree's), bound
    to that source's library; every call is held against the plain
    version (ivec exactly, float sums within FULL_SUM_TOL, f32 extremes
    exactly), then timed by CUDA events: ``ms`` around each call (as the
    first design was timed: host work the call waits on included),
    ``queued_ms`` with the calls queued behind a parked stream (the
    device's time for a wrapper that waits on nothing; the first
    design's waits on its pageable uploads, so its calls stay one by
    one)."""
    import torch

    from yugabyte_db_tpu_torch import workload
    from yugabyte_db_tpu_torch.ops import full_agg
    from yugabyte_db_tpu_torch.ops.device_run import DeviceRun

    mods = other_modules("full_agg", full_agg, others)
    order = ["A", *others, *others[::-1], "A"]
    t0 = time.perf_counter()
    planes, reads = workload.flat_planes(FULL_BLOCKS, FULL_R, FULL_COLUMNS,
                                         seed=19)
    run = DeviceRun.from_reference_planes(planes, FULL_R, device)
    del planes
    n_rows, W = run.B * FULL_R, run.B // 8
    cases = [(label, plan, run.arrays, params) for label, plan, params in
             full_signatures(reads, n_rows, W)]
    _schema, _rows, max_ht, eng, _g, _l = full_engine_table(device)
    float_spec, _pred = full_specs()
    preps = [eng._plan_scan(float_spec(max_ht + 1, lo)) for lo in FULL_LOS]
    p0 = preps[0]
    plan = full_plan(p0.sig.aggs, p0.sig.preds,
                     [(cs.col_id, cs.kind) for cs in p0.sig.cols],
                     FULL_ENGINE_R)
    arrays = p0.trun.dev.arrays
    cases.append(("engine_batch16", plan, arrays, full_params(
        plan, [(p.row_lo, p.row_hi, max_ht + 1, p.lits) for p in preps],
        arrays["valid"].shape[0] // plan.K)))
    print("full_ab_setup " + json.dumps({
        "card": nvidia_smi(), "setup_s": time.perf_counter() - t0,
        "ptxas": ptxas_usage("full_agg")}))
    for label, plan, arrays, params in cases:
        times = {name: [] for name in mods}
        queued = {name: [] for name in mods}
        for name in order:
            mod = mods[name]
            hold_full(plan, arrays, params, label == "engine_batch16",
                      None if name == "A" else mod)
            mplan = mod.make_plan(plan.aggs, plan.preds, plan.cols, plan.R,
                                  plan.K)
            times[name].append(cuda_ms(
                lambda: mod.full_aggregate(mplan, arrays, params),
                KERNEL_REPS))
            queued[name].append(cuda_ms(
                lambda: mod.full_aggregate(mplan, arrays, params),
                KERNEL_REPS, queue_ahead=True))
        print("full_ab " + json.dumps({
            "case": label, "specs": params.shape[0],
            **full_bound(plan, arrays, params, bw, rate), "ms": times,
            "queued_ms": queued}))
    del run, eng


# -- phase 6: GROUP BY and expression aggregates (TPC-H Q1/Q6, K8) -------

LINEITEM_ROWS = 1_500_303  # TPC-H SF1 / 4 (workload.SF1_ROWS 6,001,215)
LINEITEM_R = 2048
MV_LINEITEM_ROWS = 250_000  # the multi-version lineitem: rows, updates
MV_LINEITEM_UPDATES = 250_000
TPCH_BATCH = 8      # bench.py:1003 bench_tpch: 10 batches of 8 Q1 specs,
TPCH_BATCHES = 10   # depth 4, after 4 warm-up batches
TPCH_DEPTH = 4
LATENCY_REPS = 3    # timed single Q1 / Q6 scans; the median is kept
GROUP_EDGE_ROWS = 20_000
# Integer operations per row that the function needs, beside each
# column's set/isnull pair (decode_ops) and the read point's visibility
# (VISIBILITY_OPS): per matching row the hash (two a key plane, five for
# the mix and the bucket), and per sum the base decode (2), the factors'
# nodes (1 each), the 128-bit product (4 a factor) and add (4); COUNTs
# and n cost a popcount and an add per 32-row mask word.
GROUP_HASH_OPS = 5
SUM_OPS = 2 + 4


def q1_oracle(cols: dict, cutoff: int = 10471) -> list:
    """TPC-H Q1 over lineitem column arrays in numpy int64 (exact at
    SF1: a sum_charge term is under 6e10, 6e6 of them under 4e17): the
    engine's rows, sorted by (returnflag, linestatus)."""
    m = cols["l_shipdate"] <= cutoff
    flag, status = cols["l_returnflag"][m], cols["l_linestatus"][m]
    qty, price = cols["l_quantity"][m], cols["l_extendedprice"][m]
    disc, tax = cols["l_discount"][m], cols["l_tax"][m]
    disc_price = price * (100 - disc)
    charge = disc_price * (100 + tax)
    out = []
    for f in sorted(set(flag.tolist())):
        for st in sorted(set(status[flag == f].tolist())):
            g = (flag == f) & (status == st)
            out.append((f, st, int(qty[g].sum()), int(price[g].sum()),
                        int(disc_price[g].sum()), int(charge[g].sum()),
                        int(g.sum())))
    return out


def q6_oracle(cols: dict, date_lo: int = 9131, discount: int = 6,
              quantity: int = 24) -> list:
    ship, disc = cols["l_shipdate"], cols["l_discount"]
    m = ((ship >= date_lo) & (ship < date_lo + 365) & (disc >= discount - 1)
         & (disc <= discount + 1) & (cols["l_quantity"] < quantity))
    return [(int((cols["l_extendedprice"][m] * disc[m]).sum())
             if m.any() else None,)]


def lineitem_at(cols: dict, upd: dict, read_ht: int) -> dict:
    """The lineitem columns as they read at ``read_ht`` after the updates
    of ``workload.make_lineitem_updates`` (arrays ``upd``): per row and
    field, the newest update at or before the read point, in numpy."""
    from yugabyte_db_tpu_torch import workload

    out = dict(cols)
    vis = upd["ht"] <= read_ht
    for f, name in enumerate(workload.LINEITEM_UPDATED):
        at = np.flatnonzero(vis & (upd["field"] == f))
        if not at.size:
            continue
        rows = upd["row"][at]
        order = np.lexsort((upd["ht"][at], rows))
        last = order[np.r_[rows[order][1:] != rows[order][:-1], True]]
        col = out[name].copy()
        col[rows[last]] = np.array([upd["value"][i] for i in at[last]],
                                   dtype=col.dtype)
        out[name] = col
    return out


def lineitem_engine(device, n_rows: int, n_updates: int = 0):
    """A ``gpu`` engine holding ``n_rows`` generated lineitem rows and
    ``n_updates`` zipfian one-field updates of them
    (``workload.make_lineitem_updates``), applied and flushed into one
    run: (namespace with schema, columns, the updates' arrays, max_ht,
    engine, generate and load seconds). The cyclic garbage collector is
    paused while the rows' objects are made and loaded (they hold no
    cycles)."""
    import gc

    from yugabyte_db_tpu_torch import workload
    from yugabyte_db_tpu_torch.storage import make_engine

    gc.disable()
    try:
        t0 = time.perf_counter()
        schema = workload.lineitem_schema()
        cols = workload.generate_lineitem(n_rows)
        keys = workload.lineitem_keys(schema, cols)
        rows, max_ht = workload.lineitem_rows(schema, cols)
        upd = None
        if n_updates:
            updates, upd = workload.make_lineitem_updates(
                schema, keys, max_ht, n_updates)
            rows += updates
            max_ht = int(upd["ht"][-1])
        gen_s = time.perf_counter() - t0
        eng = make_engine("gpu", schema, {"rows_per_block": LINEITEM_R,
                                          "device": device})
        t0 = time.perf_counter()
        eng.apply(rows)
        flush(eng, "grouped")
        load_s = time.perf_counter() - t0
        del rows
    finally:
        gc.enable()
    return SimpleNamespace(schema=schema, cols=cols, upd=upd,
                           max_ht=max_ht, eng=eng, gen_s=gen_s,
                           load_s=load_s)


def k8_inputs(eng, specs: list) -> tuple:
    """(plan, plane table, parameter rows on the card) of specs that the
    engine sends to K8 in one launch (one source, one signature)."""
    import torch

    from yugabyte_db_tpu_torch.ops import group_agg

    preps = [eng._plan_scan(s) for s in specs]
    plan = group_agg.make_plan(preps[0].sig)
    check(all(group_agg.make_plan(p.sig) is plan and p.trun is preps[0].trun
              and p.view_key == preps[0].view_key for p in preps),
          "specs of one K8 launch differ in signature or source")
    params = torch.tensor(
        [plan.param_row(p.row_lo, p.row_hi, p.read_planes, p.lits)
         for p in preps], dtype=torch.int32, device=eng.device)
    return plan, plan.plane_table(preps[0].k8_arrays()), params


def k8_exact(plan, table, params) -> int:
    """K8 against its plain version on the same inputs, every output
    byte for byte, and the launch the library reports equal to
    ``launch_geometry``'s: 0, or the check fails."""
    import torch

    from yugabyte_db_tpu_torch.ops import group_agg

    got = group_agg.grouped_aggregate(plan, table, params)
    launched = group_agg.last_launch()
    want = group_agg.grouped_aggregate_plain(plan, table, params)
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    check(torch.equal(got, want), f"K8 != plain version (max |diff| {err}) "
                                  f"for {plan.sig.aggs}")
    geo = group_agg.device_launch(group_agg._library(), plan, table,
                                  params)[1]
    check(launched == geo, f"K8 launched {launched}, launch_geometry says "
                           f"{geo}")
    return err


def k8_builds(plan, table, params) -> dict:
    """K8's two encoded builds on the same inputs whatever ``plan_launch``
    would pick: with the copies (``copy_layout``'s, at the geometry of
    the copy build) and without, each byte for byte against the plain
    version (or the check fails) and each reported launch equal to the
    geometry it was given: {copies: geometry}."""
    import torch

    from yugabyte_db_tpu_torch.ops import encodings as enc
    from yugabyte_db_tpu_torch.ops import group_agg

    lib = group_agg._library()
    want = group_agg.grouped_aggregate_plain(plan, table, params)
    sms = torch.cuda.get_device_properties(params.device).multi_processor_count
    n_rows = int(np.prod(enc.leaf_dims(table[4])))
    out = {}
    for copies in (True, False):
        layout = group_agg.copy_layout(plan, table, copies=copies)
        build = group_agg.build_of(layout)
        geo = group_agg.launch_geometry(
            params.shape[0], n_rows, plan.tile_bytes, plan.spec_bytes, sms,
            lambda smem: group_agg._occupancy(lib, len(plan.col_ids), smem,
                                              build), layout)
        got = group_agg.launch(lib, plan, table, params, geo, layout)
        launched = group_agg.last_launch()
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"K8's build {build} != plain version "
                                      f"for {plan.sig.aggs}")
        check(launched == geo, f"K8 launched {launched}, launch_geometry "
                               f"says {geo}")
        out[copies] = geo
    return out


def group_ops(plan, table, params) -> float:
    """Integer operations the function needs for these specs (see
    GROUP_HASH_OPS): the decode once per row in any range, visibility
    once per row and read point, per spec the predicates at the rows
    they see, the hash and the aggregates at its matching rows."""
    import torch

    from yugabyte_db_tpu_torch.ops import group_agg

    flat = group_agg._flat(plan, table)
    n = flat[4].numel()
    p_np = params.cpu().numpy()
    decode = (1 + len(plan.col_ids)) / 4
    n_reads, vis_rows = visibility_rows(p_np, n)
    ops = covered_rows(p_np, n) * decode + vis_rows * VISIBILITY_OPS
    for p in params.tolist():
        mk = group_agg._row_masks(plan, flat, p)
        for ps, seen in zip(plan.sig.preds, mk["pred"]):
            ops += int(seen.sum()) * group_agg._PLANES[ps.kind]
        per_match = 2 * plan.kp + GROUP_HASH_OPS
        for ag in plan.sig.aggs:
            per_match += 2 / 32
            if ag.kind != "count":
                per_match += SUM_OPS + sum(
                    len(group_agg._nodes(f)) + 4 for f in ag.factors)
        ops += int(mk["m"].sum()) * per_match
    return ops


def measure_k8(plan, table, params, bw: float, rate: float) -> dict:
    """K8 held byte for byte against its plain version, timed (CUDA
    events), with its bound: the larger of ``group_bytes`` over the
    bandwidth and ``group_ops`` over the int32 rate."""
    from yugabyte_db_tpu_torch.ops import group_agg
    from yugabyte_db_tpu_torch.ops.encodings import leaf_dims

    launches0 = group_agg.grouped_aggregate.launches
    err = k8_exact(plan, table, params)
    ms = cuda_ms(lambda: group_agg.grouped_aggregate(plan, table, params),
                 KERNEL_REPS, queue_ahead=True)
    plain_ms = cuda_ms(
        lambda: group_agg.grouped_aggregate_plain(plan, table, params),
        PLAIN_REPS)
    nbytes = group_agg.group_bytes(plan, table, params)
    ops = group_ops(plan, table, params)
    bytes_ms, ops_ms = nbytes / bw * 1e3, ops / rate * 1e3
    return {"specs": params.shape[0],
            "rows": int(np.prod(leaf_dims(table[4]))),
            "bytes": nbytes, "ops": ops, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms), "bytes_ms": bytes_ms,
            "ops_ms": ops_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "max_abs_err": err,
            "launches": group_agg.grouped_aggregate.launches - launches0}


def host_answer(schema, versions_by_key: dict, spec):
    """The spec's rows by the port's host oracle, independent of K8:
    each key's versions merged at the read point (``merge_versions``),
    its predicates applied and the ``Aggregator`` fold."""
    from yugabyte_db_tpu_torch.storage.cpu_engine import (Aggregator,
                                                          RowMaterializer)
    from yugabyte_db_tpu_torch.storage.merge import merge_versions

    mat = RowMaterializer(schema)
    agg = Aggregator(spec.aggregates, spec.group_by or [])
    for key in sorted(versions_by_key):
        if not spec.in_range(key):
            continue
        merged = merge_versions(key, versions_by_key[key], spec.read_ht)
        kv = mat.key_values(key)
        if merged.exists and mat.matches(spec, kv, merged):
            agg.add(lambda name: mat.value(name, kv, merged))
    return agg.results()


def group_edges(device) -> dict:
    """K8's edges at GROUP_EDGE_ROWS lineitem rows, each result held
    against ``host_answer`` and each launch against the plain version:
    NULLs in a group column; an int32 group column of more than 512
    values (a collision: re-served on the host); negative bases (negs:
    re-served on the host); COUNT(col) over NULLs; an empty range; a
    batch of distinct literals and read points in one launch."""
    import dataclasses

    from yugabyte_db_tpu_torch import workload
    from yugabyte_db_tpu_torch.ops import group_agg
    from yugabyte_db_tpu_torch.storage import (AggSpec, ScanSpec,
                                               make_engine)
    from yugabyte_db_tpu_torch.storage.row_version import RowVersion

    schema = workload.lineitem_schema()
    cid = {c.name: c.col_id for c in schema.columns}
    rng = np.random.default_rng(17)
    cols = workload.generate_lineitem(GROUP_EDGE_ROWS, seed=19)
    rows, max_ht = workload.lineitem_rows(schema, cols)
    # NULL statuses (5%) and quantities (3%); a negative price (1%) in a
    # second table of its own.
    neg_rows = []
    for r in rows:
        neg = dict(r.columns)
        if rng.random() < 0.05:
            r.columns[cid["l_linestatus"]] = None
        if rng.random() < 0.03:
            r.columns[cid["l_quantity"]] = None
        if rng.random() < 0.01:
            neg[cid["l_extendedprice"]] = -neg[cid["l_extendedprice"]]
        neg_rows.append(RowVersion(r.key, ht=r.ht, liveness=True,
                                   columns=neg))
    out = {}
    for label, rs in (("nulls", rows), ("negative", neg_rows)):
        eng = make_engine("gpu", schema, {"rows_per_block": LINEITEM_R,
                                          "device": device})
        eng.apply(rs)
        flush(eng, "grouped")
        by_key = {r.key: [r] for r in rs}
        read = max_ht + 1
        cases = {"q1": [workload.q1_spec(read)]}
        if label == "nulls":
            cases.update({
                "null_group": [ScanSpec(
                    read_ht=read, group_by=["l_linestatus"],
                    aggregates=[AggSpec("count", None),
                                AggSpec("sum", "l_quantity")])],
                "collision": [ScanSpec(
                    read_ht=read, group_by=["l_shipdate"],
                    aggregates=[AggSpec("count", None),
                                AggSpec("sum", "l_tax")])],
                "count_col": [ScanSpec(
                    read_ht=read, group_by=["l_returnflag"],
                    aggregates=[AggSpec("count", "l_quantity"),
                                AggSpec("count", "l_linestatus"),
                                AggSpec("sum", "l_quantity")])],
                "batch": [workload.q1_spec(
                    max_ht + 1 - GROUP_EDGE_ROWS // 16 * i, 10471 - 150 * i)
                    for i in range(TPCH_BATCH)],
            })
        for case, specs in cases.items():
            folds0 = eng.grouped_host_folds
            launches0 = group_agg.grouped_aggregate.launches
            got = eng.scan_batch(specs)
            launches = group_agg.grouped_aggregate.launches - launches0
            for s, g in zip(specs, got):
                want = host_answer(schema, by_key, s)
                check(g.rows == want, f"grouped edge {label}/{case}: "
                                      f"{g.rows[:3]} != {want[:3]}")
            err = k8_exact(*k8_inputs(eng, specs))
            folds = eng.grouped_host_folds - folds0
            check(launches == 1, f"grouped edge {label}/{case}: {launches} "
                                 "K8 launches, want 1")
            expect_folds = len(specs) if case == "collision" or \
                label == "negative" else 0
            check(folds == expect_folds,
                  f"grouped edge {label}/{case}: {folds} host folds, want "
                  f"{expect_folds}")
            out[f"{label}_{case}"] = {"specs": len(specs),
                                      "groups": len(got[0].rows),
                                      "host_folds": folds,
                                      "max_abs_err": err}
        if label == "nulls":
            # An empty range: the engine answers without a launch; K8 on
            # an empty parameter row leaves every bucket empty.
            key = workload.lineitem_keys(schema, {
                "l_orderkey": np.array([3]), "l_linenumber": np.array([2])})[0]
            spec = dataclasses.replace(workload.q1_spec(read), lower=key,
                                       upper=key)
            launches0 = group_agg.grouped_aggregate.launches
            check(eng.scan(spec).rows == [], "empty range: rows")
            check(group_agg.grouped_aggregate.launches == launches0,
                  "empty range: a launch")
            plan, table, params = k8_inputs(eng, [workload.q1_spec(read)])
            params[:, 1] = params[:, 0]
            err = k8_exact(plan, table, params)
            out["empty_range"] = {"max_abs_err": err}
    return out


# K8's encoded edges: (variant, R) tables whose numeric order planes take
# the variant's leaf kind (const data for "const"), at R = 64 and 96 (R
# not a multiple of 128: each row's block from a division) and the
# "delta16" one at R = 2048 too (a piece in one block).
GROUP_ENC_EDGE_ROWS = 6_144  # whole blocks at every R below
GROUP_ENC_VARIANTS = (("delta16", 64), ("delta16", 2048), ("rle", 96),
                      ("plain", 64), ("const", 96), ("cap", 64))
_NUMERIC = ("l_quantity", "l_extendedprice", "l_discount", "l_tax",
            "l_shipdate")


def group_enc_rows(schema, variant: str, seed: int) -> tuple:
    """(rows, max_ht) of a lineitem edge table: runs of 16 rows of one
    value (NULL runs of l_quantity, rows without liveness, TTLs on some
    runs; l_extendedprice within a 16-bit span, so that its two order
    planes take delta16 with the empty rows' zeros; whole blocks, so
    that the hybrid-time planes take delta16); ``const``: every
    numeric column the value of the rows past the run's end (0, and
    2^31 for l_extendedprice); ``cap``: 600 distinct return flags (a
    dictionary past the shared cap); ``plain``: DELETEs of 2% of the
    keys too (tombstones)."""
    from yugabyte_db_tpu_torch import workload
    from yugabyte_db_tpu_torch.storage.row_version import RowVersion

    n = GROUP_ENC_EDGE_ROWS
    rng = np.random.default_rng(seed)
    cols = workload.generate_lineitem(n, seed=seed)
    # Runs of 16 rows in the run's (key) order: each row takes the value
    # of its run's first row.
    keys = workload.lineitem_keys(schema, cols)
    order = np.array(sorted(range(n), key=keys.__getitem__))
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    run = order[rank // 16 * 16]
    for name in _NUMERIC:
        cols[name] = cols[name][run]
    # Prices from 2^31 on: the low order plane (the low word with its top
    # bit flipped) then spans 0 (the rows past the run's end) to 60,000.
    cols["l_extendedprice"] = (1 << 31) + cols["l_extendedprice"] % 60_000
    if variant == "const":  # the values the rows past the end hold
        for name in _NUMERIC:
            cols[name] = np.full(n, 1 << 31 if name == "l_extendedprice"
                                 else 0)
    if variant == "cap":
        cols["l_returnflag"] = np.array(
            [f"r{v:03d}" for v in rng.integers(0, 600, n)])
    rows, max_ht = workload.lineitem_rows(schema, cols)
    qty = schema.column("l_quantity").col_id
    null_runs = rng.random(n // 16 + 1) < 0.05
    ttl_runs = rng.random(n // 16 + 1) < 0.05
    for i, r in enumerate(rows):
        if null_runs[rank[i] // 16] and variant != "const":
            r.columns[qty] = None
        if i % 10 == 3:
            r.liveness = False
        if ttl_runs[rank[i] // 16]:
            r.expire_ht = max_ht - 50 + rank[i] // 16 % 100
    if variant == "plain":
        dead = rng.choice(n, n // 50, replace=False)
        rows += [RowVersion(rows[i].key, ht=max_ht + 1 + k, tombstone=True)
                 for k, i in enumerate(sorted(dead))]
        max_ht += len(dead)
    return rows, max_ht


def group_enc_sigs(schema) -> list:
    """(name, signature) of the edges' K8 signatures, between them every
    staged role: a predicate on each numeric column (l_extendedprice's
    two planes among them), on a dictionary's prefix planes and on its
    codes; group columns of one and two planes and dictionaries; sums of
    one- and two-plane bases with affine and postfix factors; COUNT(*)
    and COUNT(col)."""
    from yugabyte_db_tpu_torch.ops.group_agg import GAgg, GroupAggSig
    from yugabyte_db_tpu_torch.ops.scan import ColSig, PredSig

    c = {col.name: col.col_id for col in schema.value_columns}
    kinds = {"l_extendedprice": "i64", "l_returnflag": "str",
             "l_linestatus": "str"}
    cols = tuple(ColSig(c[n], kinds.get(n, "i32")) for n in c)
    qty, price, disc, tax, ship = (c[n] for n in _NUMERIC)
    flag, status = c["l_returnflag"], c["l_linestatus"]

    def sig(preds, group, aggs):
        return GroupAggSig(512, cols, tuple(PredSig(*p) for p in preds),
                           tuple(group), tuple(aggs))

    disc_price = ("*", ("c", price), ("-", ("k", 100), ("c", disc)))
    return [
        ("q1", sig([(ship, "i32", "<=")], [(flag, 2), (status, 2)], [
            GAgg("sum_prod", qty, 1, (), (qty,)),
            GAgg("sum_prod", price, 2, (), (price,)),
            GAgg("sum_prod", price, 2, (("-", ("k", 100), ("c", disc)),),
                 (price, disc)),
            GAgg("sum_prod", price, 2, (("-", ("k", 100), ("c", disc)),
                                        ("+", ("k", 100), ("c", tax))),
                 (price, disc, tax)),
            GAgg("count", None)])),
        ("narrow_groups", sig(
            [(qty, "i32", ">="), (price, "i64", "<"), (tax, "i32", "!=")],
            [(tax, 1), (disc, 1)], [
                GAgg("sum_prod", qty, 1, (("*", ("c", disc),
                                           ("+", ("c", tax), ("k", 1))),),
                     (qty, disc, tax)),
                GAgg("count", qty, 1, (), (qty,))])),
        ("wide_group", sig(
            [(flag, "i64", ">="), (status, "code", "="), (disc, "i32", "<")],
            [(price, 2), (ship, 1)], [
                GAgg("sum_prod", tax, 1, (("c", qty),), (tax, qty)),
                GAgg("count", None)])),
        ("expr", sig([(ship, "i32", ">"), (flag, "code", "!=")],
                     [(status, 2)], [
            GAgg("sum_prod", qty, 1, (disc_price[2],), (qty, disc)),
            GAgg("count", status, 1, (), (status,))])),
    ]


def group_enc_params(plan, table, max_ht: int, n_rows: int, device):
    """Three parameter rows: the whole run at the newest read point, a
    mid read point over a middle range, and a late one past the TTLs;
    literals drawn from the table's own values (a dictionary literal is
    one of its entries, or a code)."""
    import torch

    from yugabyte_db_tpu_torch.ops import encodings as enc
    from yugabyte_db_tpu_torch.ops import group_agg

    flat = group_agg._flat(plan, table)
    rows = []
    for k, (lo, hi, read) in enumerate(((0, n_rows, max_ht + 1),
                                        (n_rows // 5, n_rows // 2,
                                         max_ht - GROUP_ENC_EDGE_ROWS // 3),
                                        (n_rows // 3, n_rows,
                                         max_ht + 10_000))):
        lits = []
        for p in plan.sig.preds:
            slot = plan.slot[p.col_id]
            leaf = table[9 + 3 * slot]
            if p.kind == "code":
                lits.append(k % 2)
            elif enc.leaf_kind(leaf) == "dict":
                e = leaf["dict"]
                at = k % max(1, e["dhi"].numel() - 1)
                lits.append(np.array([int(e["dhi"][at]), int(e["dlo"][at])],
                                     np.int32))
            else:
                v = flat[9 + 3 * slot][(lo + hi) // 2 + 7 * k]
                lits.append(v.cpu().numpy().astype(np.int32)
                            if v.numel() > 1 else int(v))
        rows.append(plan.param_row(lo, hi, read_params(read), lits))
    return torch.tensor(rows, dtype=torch.int32, device=device)


def force_leaf(plane: np.ndarray, kind: str):
    """``plane`` (a host order plane) as a ``kind`` leaf where the encoder
    takes it, else None."""
    from yugabyte_db_tpu_torch.ops import encodings as enc

    if kind == "plain":
        return plane
    return {"const": enc.encode_const, "delta16": enc.encode_delta16,
            "rle": enc.encode_rle}[kind](plane)


def group_enc_edges(device) -> dict:
    """K8's encoded build on edge tables (GROUP_ENC_VARIANTS), every launch
    byte for byte against its plain version and its reported launch equal
    to ``launch_geometry``: each of ``group_enc_sigs`` over the variant's
    encoded tree (flags bit-packed, strings dictionaries, the numeric
    order planes of the variant's kind, the hybrid-time planes delta16
    where they fit and the expiries rle where they fit), three specs a
    launch. Then the roles each kind took must cover every staged role;
    the ``cap`` table's 600-entry dictionary must be read through the
    read-only cache and the status dictionary from shared memory; and a
    delta16 leaf whose offsets are not 16-byte aligned must be loaded
    from the run, not copied."""
    import torch

    from yugabyte_db_tpu_torch import workload
    from yugabyte_db_tpu_torch.ops import encodings as enc
    from yugabyte_db_tpu_torch.ops import group_agg
    from yugabyte_db_tpu_torch.ops.device_run import (
        DeviceRun, _encoded_padded_tree, padded_blocks)
    from yugabyte_db_tpu_torch.storage import make_engine
    from yugabyte_db_tpu_torch.storage.gpu_engine import PAD_BLOCKS

    schema = workload.lineitem_schema()
    sigs = group_enc_sigs(schema)
    roles = set()
    out = {}
    for v, (variant, R) in enumerate(GROUP_ENC_VARIANTS):
        rows, max_ht = group_enc_rows(schema, variant, 100 + v)
        eng = make_engine("gpu", schema, {"rows_per_block": R,
                                          "device": device})
        eng.apply(rows)
        flush(eng, "grouped")
        crun = eng.runs[0].crun
        tree = dict(crun.encoded_arrays("auto"))
        tree["cols"] = {cid: dict(col) for cid, col in tree["cols"].items()}
        for name, kinds in (("ht_lo", ("delta16",)),
                            ("exp_hi", ("rle", "const")),
                            ("exp_lo", ("rle", "delta16"))):
            for kind in kinds:
                leaf = force_leaf(getattr(crun, name), kind)
                if leaf is not None:
                    tree[name] = leaf
                    break
        want = "const" if variant == "const" else \
            "delta16" if variant in ("delta16", "cap") else variant
        for name in _NUMERIC:
            cid = schema.column(name).col_id
            leaf = force_leaf(crun.cols[cid].cmp_planes, want)
            check(leaf is not None, f"K8 edge {variant}: {name} takes no "
                                    f"{want} leaf")
            tree["cols"][cid]["cmp"] = leaf
        arrays = DeviceRun.from_reference_planes(
            _encoded_padded_tree(tree, padded_blocks(crun.B, PAD_BLOCKS)),
            R, device).arrays
        n_rows = int(np.prod(enc.tree_dims(arrays)))
        for label, sig in sigs:
            plan = group_agg.make_plan(sig)
            table = plan.plane_table(arrays)
            params = group_enc_params(plan, table, max_ht, n_rows, device)
            copy_geo = k8_builds(plan, table, params)[True]
            err = k8_exact(plan, table, params)
            geo = group_agg.last_launch()
            check(geo.encoded == 1, f"K8 edge {variant}/{label}: plain build")
            roles |= k8_roles(plan, table)
            if variant == "cap":
                flag = plan.slot[schema.column("l_returnflag").col_id]
                status = plan.slot[schema.column("l_linestatus").col_id]
                value = group_agg.value_cols(plan)
                check(((geo.dict_cached >> flag) & 1) == (flag in value) and
                      ((geo.dict_shared >> status) & 1) == (status in value),
                      f"K8 edge cap/{label}: dictionaries {geo}")
                if flag in value:
                    roles.add(("dict", "cached"))
            out[f"{variant}_R{R}_{label}"] = {
                "max_abs_err": err, "buffers": geo.buffers,
                "copy_buffers": copy_geo.buffers,
                "raw_bytes": copy_geo.raw_bytes,
                "dict_shared": geo.dict_shared,
                "dict_cached": geo.dict_cached}
        if variant == "delta16" and R == 64:
            # l_quantity's offsets 2 bytes past a 16-byte boundary: loaded
            # from the run with scalar loads, not copied.
            cid = schema.column("l_quantity").col_id
            doff = arrays["cols"][cid]["cmp"]["delta16"]["doff"]
            moved = torch.empty(doff.numel() + 8, dtype=doff.dtype,
                                device=device)[1:1 + doff.numel()]
            moved.copy_(doff.reshape(-1))
            odd = dict(arrays, cols=dict(arrays["cols"]))
            odd["cols"][cid] = dict(odd["cols"][cid], cmp={"delta16": dict(
                arrays["cols"][cid]["cmp"]["delta16"],
                doff=moved.view(doff.shape))})
            plan = group_agg.make_plan(sigs[0][1])
            table = plan.plane_table(odd)
            params = group_enc_params(plan, table, max_ht, n_rows, device)
            err = k8_exact(plan, table, params[:1])
            geo = k8_builds(plan, table, params)[True]
            k = 9 + 3 * plan.slot[cid]
            copied = (geo.copied_lo & 0xFFFFFFFF) | geo.copied_hi << 32
            check(not (copied >> k) & 1 and geo.raw_bytes > 0,
                  f"K8 edge: the unaligned delta16 leaf was copied ({geo})")
            roles.add(("delta16", "loaded"))
            out["delta16_unaligned"] = {"max_abs_err": err}
        del eng, arrays
    need = {(kind, role) for kind in ("const", "delta16", "delta16_wide",
                                      "rle", "dict")
            for role in ("pred", "group", "agg") if kind != "dict" or
            role != "agg"} | {("dict", "code"), ("dict", "cached"),
                              ("delta16", "loaded"), ("delta16", "time")} | {
        ("bits", f) for f in ("valid", "tomb", "live", "set", "isnull")}
    check(need <= roles, f"K8 edges miss roles {sorted(need - roles)}")
    return out


def k8_roles(plan, table) -> set:
    """The (leaf kind, staged role) pairs a K8 launch over ``table``
    stages: the bool planes' kinds, the hybrid-time planes', and each
    predicate, group and sum column's."""
    from yugabyte_db_tpu_torch.ops import encodings as enc
    from yugabyte_db_tpu_torch.ops import group_agg

    roles = set()
    for k, name in ((4, "valid"), (5, "tomb"), (6, "live")):
        roles.add((enc.leaf_kind(table[k]) or "plain", name))
    for slot in range(len(plan.col_ids)):
        roles.add((enc.leaf_kind(table[7 + 3 * slot]) or "plain", "set"))
        roles.add((enc.leaf_kind(table[8 + 3 * slot]) or "plain", "isnull"))
    if any(enc.leaf_kind(table[k]) == "delta16" for k in range(4)):
        roles.add(("delta16", "time"))

    def kind_of(cid):
        leaf = table[9 + 3 * plan.slot[cid]]
        kind = enc.leaf_kind(leaf) or "plain"
        if kind == "delta16" and group_agg.plane_width(leaf) == 2:
            return "delta16_wide"
        return kind

    for p in plan.sig.preds:
        roles.add((kind_of(p.col_id), "code" if p.kind == "code" else "pred"))
    for cid, _planes in plan.sig.group_cols:
        roles.add((kind_of(cid), "group"))
    for a in plan.sig.aggs:
        if a.kind != "count":
            for cid in [a.col_id] + [n[1] for f in a.factors
                                     for n in group_agg._nodes(f)
                                     if n[0] == "c"]:
                roles.add((kind_of(cid), "agg"))
    return roles


def grouped_phase(device, bw: float, rate: float) -> dict:
    """TPC-H lineitem at LINEITEM_ROWS (SF1 / 4) in one flat run, and at
    MV_LINEITEM_ROWS with MV_LINEITEM_UPDATES zipfian one-field updates in
    one multi-version run: Q1 and Q6 through the engine against numpy
    oracles, K8 held against its plain version and timed, its edges."""
    import torch

    from yugabyte_db_tpu_torch import workload
    from yugabyte_db_tpu_torch.ops import flat_agg, group_agg, mvcc_resolve

    ctx = lineitem_engine(device, LINEITEM_ROWS)
    # K12's codes route: the lineitem flush's launch, timed.
    ENCODED["k12_codes"] = measure_k12(write_log().last_flush, bw, rate)
    print("flush_kernel_codes " + json.dumps(ENCODED["k12_codes"]))
    eng, cols = ctx.eng, ctx.cols
    read = ctx.max_ht + 1
    q1, q6 = workload.q1_spec(read), workload.q6_spec(read)
    want_q1, want_q6 = q1_oracle(cols), q6_oracle(cols)
    setup = {"rows": LINEITEM_ROWS, "generate_s": ctx.gen_s,
             "apply_flush_s": ctx.load_s,
             "device_bytes": eng.stats()["device_bytes"]}
    print("grouped_setup " + json.dumps(setup))

    # The main path, counted.
    group_agg.grouped_aggregate.launches = 0
    flat_agg.flat_aggregate.launches = 0
    mvcc_resolve.resolve_view.launches = 0
    got = eng.scan(q1).rows
    check(got == want_q1, f"Q1 {got} != oracle {want_q1}")
    got = eng.scan(q6).rows
    check(got == want_q6, f"Q6 {got} != oracle {want_q6}")
    lat = {}
    for name, spec in (("q1", q1), ("q6", q6)):
        ts = []
        for _ in range(LATENCY_REPS):
            t = time.perf_counter()
            eng.scan(spec)
            ts.append(time.perf_counter() - t)
        lat[name] = statistics.median(ts) * 1e3
    batches = [[workload.q1_spec(read) for _ in range(TPCH_BATCH)]
               for _ in range(TPCH_BATCHES)]
    q = collections.deque()
    for bt in batches[:TPCH_DEPTH]:
        q.append(eng.scan_batch_async(bt))
    while q:
        q.popleft().finish()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = []
    for bt in batches:
        q.append(eng.scan_batch_async(bt))
        if len(q) > TPCH_DEPTH:
            done.append(q.popleft().finish())
    done.extend(b.finish() for b in q)
    pipe_s = time.perf_counter() - t0
    for res in done:
        for r in res:
            check(r.rows == want_q1, "pipelined Q1 != oracle")
    launches = group_agg.grouped_aggregate.launches
    check(launches > 0, "the grouped path launched K8 0 times")
    check(flat_agg.flat_aggregate.launches == 0,
          "the grouped path launched K1")
    check(eng.grouped_host_folds == 0,
          f"{eng.grouped_host_folds} Q1/Q6 specs re-served on the host")
    # The profiler has come back without device events late in a long
    # process: one more try, then the K8 batch's event-timed share below.
    for _ in range(2):
        trace = trace_batches(eng, [batches[0]])
        if trace["device_busy_share"] != "not measured":
            break
    row = {"rows": LINEITEM_ROWS, "q1_latency_ms": lat["q1"],
           "q6_latency_ms": lat["q6"],
           "q1_pipelined_rows_per_s": LINEITEM_ROWS * TPCH_BATCH
           * TPCH_BATCHES / pipe_s,
           "batch": TPCH_BATCH, "batches": TPCH_BATCHES,
           "depth": TPCH_DEPTH, "launches": launches,
           "grouped_host_folds": eng.grouped_host_folds,
           "groups": len(want_q1)}
    print("grouped " + json.dumps(row))

    # K8 at the main path's shapes and past its slots, outside the counted
    # run.
    kern = {}
    for label, specs in k8_cases(read, LINEITEM_ROWS).items():
        kern[label] = measure_k8(*k8_inputs(eng, specs), bw, rate)
        print(f"grouped_kernel_{label} " + json.dumps(kern[label]))
    row["kernel"] = kern
    if trace["device_busy_share"] == "not measured":
        trace["k8_share_from_events"] = (kern["q1_batch"]["ms"]
                                         / trace["wall_ms_per_batch"])
    print("grouped_trace " + json.dumps(trace))
    row["trace"] = trace
    row["encoded"] = ENCODED["lineitem"] = grouped_encoded(ctx, device, bw,
                                                           rate)
    del ctx, eng, cols, batches, done
    torch.cuda.empty_cache()

    # A multi-version run: Q1 at the newest and a mid read point through
    # the resolve and K8.
    ctx = lineitem_engine(device, MV_LINEITEM_ROWS, MV_LINEITEM_UPDATES)
    eng, upd = ctx.eng, ctx.upd
    trun = eng.runs[0]
    newest, mid = ctx.max_ht + 1, int(upd["ht"][len(upd["ht"]) // 2])
    mv = {"rows": MV_LINEITEM_ROWS, "updates": MV_LINEITEM_UPDATES,
          "versions": trun.crun.num_versions,
          "max_group_versions": trun.crun.max_group_versions,
          "generate_s": ctx.gen_s, "apply_flush_s": ctx.load_s}
    check(not trun.flat, "the updated lineitem run is flat")
    group_agg.grouped_aggregate.launches = 0
    mvcc_resolve.resolve_view.launches = 0
    for label, rd in (("newest", newest), ("mid", mid)):
        want = q1_oracle(lineitem_at(ctx.cols, upd, rd))
        got = eng.scan(workload.q1_spec(rd)).rows
        check(got == want, f"multi-version Q1 at {label}: {got} != {want}")
        mv[f"{label}_groups"] = len(want)
    mv["launches"] = {"group_agg": group_agg.grouped_aggregate.launches,
                      "mvcc_resolve": mvcc_resolve.resolve_view.launches}
    check(mv["launches"]["group_agg"] > 0 and
          mv["launches"]["mvcc_resolve"] > 0,
          f"multi-version Q1 launches {mv['launches']}")
    check(eng.grouped_host_folds == 0, "multi-version Q1 re-served on host")
    mv["kernel"] = measure_k8(*k8_inputs(eng, [workload.q1_spec(newest)]),
                              bw, rate)
    print("grouped_mvcc " + json.dumps(mv))
    row["mvcc"] = mv
    del ctx, eng, trun
    torch.cuda.empty_cache()

    group_agg.grouped_aggregate.launches = 0
    row["edges"] = group_edges(device)
    print("grouped_edges " + json.dumps(row["edges"]))
    t0 = time.perf_counter()
    row["enc_edges"] = group_enc_edges(device)
    print("grouped_enc_edges " + json.dumps(row["enc_edges"]))
    print(f"grouped_enc_edges_s {time.perf_counter() - t0}")
    return row


def k8_cases(read: int, n_rows: int) -> dict:
    """The spec batches K8 is timed on over a flat lineitem run of
    ``n_rows`` rows whose newest version is below ``read``: Q1 alone, 8
    copies of one Q1 spec (``q1_batch``), 8 Q1 specs at distinct ship
    cut-offs and read points (``q1_mixed``), Q1's aggregates grouped by
    (l_tax, l_returnflag), up to 27 groups: more than a block's slots
    (``q1_wide``), and Q6."""
    import dataclasses

    from yugabyte_db_tpu_torch import workload

    q1 = workload.q1_spec(read)
    return {"q1": [q1], "q1_batch": [q1] * TPCH_BATCH,
            "q1_mixed": [workload.q1_spec(read - n_rows // 16 * i,
                                          10471 - 150 * i)
                         for i in range(TPCH_BATCH)],
            "q1_wide": [dataclasses.replace(
                q1, group_by=["l_tax", "l_returnflag"])],
            "q6": [workload.q6_spec(read)]}


def other_modules(kind: str, own, others: list) -> dict:
    """This tree's wrapper module ``own`` as "A", then each other source
    of kernel ``kind`` built (``build_libs``) and bound to the wrapper
    saved beside it as ``OTHER.py`` (else a copy of ``own``), whose
    ``native`` loads that library: {name: module}."""
    from pathlib import Path

    mods = {"A": own}
    for other, lib in build_libs(kind, others).items():
        path = Path(other).with_suffix(".py")
        mod = load_module(path if path.exists() else own.__file__)
        mod.native = SimpleNamespace(load_library=lambda _name, lib=lib: lib)
        bound = mod._library.__wrapped__()
        mod._library = lambda bound=bound: bound
        mods[other] = mod
    return mods


def in_turns(mods: dict, others: list, run, held) -> dict:
    """Each module's calls timed in turns A B1 .. Bn Bn .. B1 A
    (``cuda_ms`` over KERNEL_REPS calls queued behind a parked stream),
    each turn's first call held by ``held``: {name: [ms, ...]}."""
    times = {name: [] for name in mods}
    for name in ["A", *others, *others[::-1], "A"]:
        held(name, run(name))
        times[name].append(cuda_ms(lambda: run(name), KERNEL_REPS,
                                   queue_ahead=True))
    return times


def group_enc_ab(device, bw: float, rate: float, others: list) -> None:
    """This tree's K8 (A) against other sources of it (B1, ...; the first
    encoded design's:
    ``git show 3550883:yugabyte_db_tpu_torch/csrc/group_agg.cu >
    build/ab/group_agg_enc_first.cu`` and its ``ops/group_agg.py`` beside it
    as ``build/ab/group_agg_enc_first.py``), in turns on one card, each call
    held byte for byte against the plain version: TPC-H lineitem at SF1 / 4
    flushed (``k8_cases`` over its dictionary leaves: the encoded build),
    then compacted (Q1, Q6 and a promoted Q1 over every leaf kind), each
    beside the same planes uploaded plain (the plain build), and Q1 on
    the view of a multi-version lineitem (MV_LINEITEM_ROWS rows and
    updates: the plain build). Prints ``group_enc_ab`` lines (ms by
    source, bytes and operations bounds, the build)."""
    import torch

    from yugabyte_db_tpu_torch import workload
    from yugabyte_db_tpu_torch.ops import encodings as enc
    from yugabyte_db_tpu_torch.ops import group_agg
    from yugabyte_db_tpu_torch.ops.device_run import DeviceRun
    from yugabyte_db_tpu_torch.storage.gpu_engine import PAD_BLOCKS

    mods = other_modules("group_agg", group_agg, others)

    def case(label, sig, arrays, params):
        plans = {n: m.make_plan(sig) for n, m in mods.items()}
        tables = {n: plans[n].plane_table(arrays) for n in mods}
        plan, table = plans["A"], tables["A"]
        want = group_agg.grouped_aggregate_plain(plan, table, params)

        def held(name, got):
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"K8 {name} on {label} != plain "
                                          f"version")

        times = in_turns(mods, others, lambda n: mods[n].grouped_aggregate(
            plans[n], tables[n], params), held)
        nbytes = group_agg.group_bytes(plan, table, params)
        ops = group_ops(plan, table, params)
        print("group_enc_ab " + json.dumps({
            "case": label, "card": nvidia_smi(), "rows": int(np.prod(
                enc.leaf_dims(table[4]))), "specs": params.shape[0],
            "build": group_agg.build_of(group_agg.device_launch(
                group_agg._library(), plan, table, params)[0]),
            "bytes": nbytes, "bytes_ms": nbytes / bw * 1e3,
            "ops_ms": ops / rate * 1e3, "ms": times}))

    ctx = lineitem_engine(device, LINEITEM_ROWS)
    eng, read = ctx.eng, ctx.max_ht + 1
    trun = eng.runs[0]
    off = DeviceRun(trun.crun, PAD_BLOCKS, device=device, setting="off")
    for label, specs in k8_cases(read, LINEITEM_ROWS).items():
        _plan, table, params = k8_inputs(eng, specs)
        sig = eng._plan_scan(specs[0]).sig
        case(f"flushed_{label}", sig, trun.dev.arrays, params)
        case(f"flushed_{label}_plain_upload", sig, off.arrays, params)
    del off
    eng.compact(1)  # a cutoff before every version: nothing is dropped
    trun = eng.runs[0]
    off = DeviceRun(trun.crun, PAD_BLOCKS, device=device, setting="off")
    for label, spec in (("q1", workload.q1_spec(read)),
                        ("q6", workload.q6_spec(read)),
                        ("q1_promoted", q1_promoted_spec(read))):
        _plan, _table, params = k8_inputs(eng, [spec])
        sig = eng._plan_scan(spec).sig
        case(f"compacted_{label}", sig, trun.dev.arrays, params)
        # The plain upload holds no code plane: the promoted Q1 reads the
        # side-car's, as the engine's plain readers do.
        case(f"compacted_{label}_plain_upload", sig,
             trun.plain() if label == "q1_promoted" else off.arrays, params)
    del ctx, eng, trun, off
    torch.cuda.empty_cache()
    ctx = lineitem_engine(device, MV_LINEITEM_ROWS, MV_LINEITEM_UPDATES)
    spec = workload.q1_spec(ctx.max_ht + 1)
    prep = ctx.eng._plan_scan(spec)
    _plan, _table, params = k8_inputs(ctx.eng, [spec])
    case("view", prep.sig, prep.k8_arrays(), params)


def decode_ab(device, bw: float, others: list) -> None:
    """This tree's K10 (A) against other sources of it (B1, ...; the first
    design's:
    ``git show 3550883:yugabyte_db_tpu_torch/csrc/decode.cu >
    build/ab/decode_first.cu`` and its ``ops/decode.py`` as
    ``build/ab/decode_first.py``), in turns on one card, each call held
    byte for byte against the plain version: the compact phase's merged
    run (the engine phase's table and COMPACT_WAVES waves, compacted at
    the newest hybrid time through K11) and TPC-H lineitem at SF1 / 4
    compacted with every version (every leaf kind). A call is the decode
    a run's first read makes with that source's wrapper: ``decode_tree``
    over the part table the run laid out when it was uploaded, where the
    wrapper has ``plan_tree`` (this tree's), else a whole ``decode_tree``
    (the first design lays out and copies its leaf table in each call).
    This tree's launch alone is ``launch_ms``, its ``decode_tree`` that
    lays out and uploads the table in the call ``tree_ms``. Prints
    ``decode_ab`` lines (ms by source, the bytes bound)."""
    import torch

    from yugabyte_db_tpu_torch.ops import decode
    from yugabyte_db_tpu_torch.ops import encodings as enc

    mods = other_modules("decode", decode, others)

    def case(label, arrays):
        want = decode.decode_tree_plain(arrays)

        def held(name, got):
            torch.cuda.synchronize()
            check(view_diff(got, want) == 0, f"K10 {name} on {label} != "
                                             "plain version")

        plans = {n: m.plan_tree(arrays) for n, m in mods.items()
                 if hasattr(m, "plan_tree")}
        times = in_turns(mods, others, lambda n: mods[n].decode_tree(
            arrays, plans[n]) if n in plans else mods[n].decode_tree(arrays),
            held)
        plan = plans["A"]
        out = torch.empty(plan.out_bytes, dtype=torch.uint8, device=device)
        launch_ms = cuda_ms(lambda: decode.launch(plan, out), KERNEL_REPS,
                            queue_ahead=True)
        tree_ms = cuda_ms(lambda: decode.decode_tree(arrays), KERNEL_REPS,
                          queue_ahead=True)
        nbytes = decode.decode_bytes(arrays)
        B, R = enc.tree_dims(arrays)
        print("decode_ab " + json.dumps({
            "case": label, "card": nvidia_smi(), "rows": B * R,
            "parts": int(plan.rows.shape[0]), "items": plan.n_items,
            "bytes": nbytes, "bound_ms": nbytes / bw * 1e3,
            "launch_ms": launch_ms, "tree_ms": tree_ms, "ms": times}))

    flat = flat_engine(device)
    table = compact_table(device, flat)
    del flat
    table.eng.compact(table.max_ht)
    case("merged_run", table.eng.runs[0].dev.arrays)
    del table
    torch.cuda.empty_cache()
    ctx = lineitem_engine(device, LINEITEM_ROWS)
    ctx.eng.compact(1)
    case("lineitem_compacted", ctx.eng.runs[0].dev.arrays)


def rows_ab(device, bw: float, rate: float, others: list) -> None:
    """This tree's K7 and K9 (A) against other sources of them (B1, B2,
    ..., each with the same C interface, bound with ``row_gather.bind``),
    on one card, on the launches the engine makes: a YCSB-E batch on the
    multi-version run at the newest and a mid read point, the full scans'
    chunks launches of the flat and the multi-version run, and K9 at 1, 4
    and 64 windows (the wide scan over the multi-version table and a live
    memtable). Each kernel held byte for byte against the plain version,
    then timed in turns A B1 .. Bn Bn .. B1 A (``cuda_ms``)."""
    import torch

    from yugabyte_db_tpu_torch import workload
    from yugabyte_db_tpu_torch.ops import row_gather as rg
    from yugabyte_db_tpu_torch.storage import ScanSpec

    libs = {"A": rg._library()}
    for other, lib in build_libs("row_gather", others).items():
        libs[other] = rg.bind(lib)
    own = rg._library

    t0 = time.perf_counter()
    flat = flat_engine(device)
    schema, rows, _u, _l, max_ht, eng, _g, _a = mvcc_engine(device)
    setup_s = time.perf_counter() - t0
    newest = max_ht + 1
    mid = (max(r.ht for r in rows) + max_ht) // 2
    proj = ["k", "r", "a", "d"]
    cases = {}
    log = LaunchLog()
    with log:
        for label, rd in (("ycsb_e_newest", newest), ("ycsb_e_mid", mid)):
            n0 = len(log.gathers)
            eng.scan_batch(workload.ycsb_e_batch(schema, ENGINE_KEYS, rd,
                                                 random.Random(11)))
            cases[label] = ("gather", log.gathers[n0])
        for label, e, rd in (("chunks_flat", flat.eng, flat.max_ht + 1),
                             ("chunks_mv", eng, newest)):
            e.scan(ScanSpec(read_ht=rd, projection=proj))
            cases[label] = ("gather", log.gathers[-1])
        eng.apply(workload.make_update_rows(schema, rows, max_ht,
                                            MVCC_KEYS // 50)[0])
        early = rows[len(rows) // WIDE_SCAN_SHARE].ht
        eng.scan(ScanSpec(read_ht=early, projection=proj))
        by_width = {c[4]: c for c in log.cands}
        for n in (1, 4, 64):
            check(n in by_width, f"no K9 launch of {n} windows: "
                                 f"{sorted(by_width)}")
            cases[f"k9_{n}"] = ("cands", by_width[n])

    def call(kind, launch):
        if kind == "gather":
            sig, run, ip, fp, _out = launch
            return [rg.gather_rows(sig, run, ip, fp)]
        sig, run, ip, fp, n, _out = launch
        return list(rg.scan_candidates(sig, run, ip, fp, n))

    def plain(kind, launch):
        if kind == "gather":
            sig, run, ip, fp, _out = launch
            return [rg.gather_rows_plain(sig, run, ip, fp)]
        sig, run, ip, fp, n, _out = launch
        return list(rg.scan_candidates_plain(sig, run, ip, fp, n))

    order = ["A", *others, *others[::-1], "A"]
    print("rows_ab_setup " + json.dumps({"card": nvidia_smi(),
                                         "setup_s": setup_s}))
    try:
        for label, (kind, launch) in cases.items():
            want = plain(kind, launch)
            times = {name: [] for name in libs}
            for name in order:
                rg._library = lambda lib=libs[name]: lib
                got = call(kind, launch)
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip(got, want)),
                      f"rows {name} on {label} != plain version")
                del got
                times[name].append(cuda_ms(lambda: call(kind, launch),
                                           KERNEL_REPS, queue_ahead=True))
            sig = launch[0]
            shape = ({"pages": int(launch[2].shape[0]), "M": sig.M,
                      "packed": sig.packed} if kind == "gather"
                     else {"windows": launch[4]})
            print("rows_ab " + json.dumps(dict(
                {"case": label, "flat": sig.flat}, **shape,
                **row_bound(kind, launch, bw, rate), ms=times)))
    finally:
        rg._library = own


def ptxas_usage(name: str) -> list:
    """Each entry function of kernel ``name``'s build in this process, as
    ``nvcc -Xptxas -v`` reported it: registers, stack frame and spill
    bytes."""
    import re

    from yugabyte_db_tpu_torch.ops import native

    out = []
    for line in native.build_logs.get(name, "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            out.append({"function": m[1]})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and out:
            out[-1].update(stack_bytes=int(m[1]), spill_store_bytes=int(m[2]),
                           spill_load_bytes=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m and out:
            out[-1]["registers"] = int(m[1])
    return out


def group_agg_entry(grp: dict) -> dict:
    """The kernels line's K8 entry: the single Q1 launch at SF1 / 4 as the
    headline, the other shapes beside it, and the build's registers and
    stack (no spills)."""
    k = grp["kernel"]
    usage = ptxas_usage("group_agg")
    check(all(u.get("spill_store_bytes", 0) == 0 and
              u.get("spill_load_bytes", 0) == 0 and
              u.get("stack_bytes", 0) == 0 for u in usage),
          f"K8's builds spill or have a stack frame: {usage}")
    q1, mv = k["q1"], grp["mvcc"]
    err = max([r["max_abs_err"] for r in k.values()]
              + [r["max_abs_err"] for r in grp["encoded"]["k8"].values()]
              + [mv["kernel"]["max_abs_err"]]
              + [e["max_abs_err"] for e in grp["edges"].values()]
              + [e["max_abs_err"] for e in grp["enc_edges"].values()])
    launches = {"grouped": grp["launches"],
                "grouped_mvcc": mv["launches"]["group_agg"],
                "grouped_encoded": grp["encoded"]["launches"]["group_agg"]}
    return {
        "name": "group_agg", "route": "cuda",
        "source": "yugabyte_db_tpu_torch/csrc/group_agg.cu",
        "replaces": "yugabyte_db_tpu/ops/group_agg.py:139",
        "launches": sum(launches.values()), "launches_by_path": launches,
        "max_abs_err": err, "max_abs_diff": err, "ms": q1["ms"],
        "plain_ms": q1["plain_ms"], "bound_ms": q1["bound_ms"],
        "bound_by": q1["bound_by"], "library_ms": None,
        "library_note": "no single PyTorch call computes K8 (a hashed "
                        "bucket table with exact 128-bit product sums)",
        "q1_batch_ms": k["q1_batch"]["ms"],
        "q1_batch_bound_ms": k["q1_batch"]["bound_ms"],
        "q1_batch_plain_ms": k["q1_batch"]["plain_ms"],
        "q1_mixed_ms": k["q1_mixed"]["ms"],
        "q1_mixed_bound_ms": k["q1_mixed"]["bound_ms"],
        "q1_mixed_plain_ms": k["q1_mixed"]["plain_ms"],
        "q1_wide_ms": k["q1_wide"]["ms"],
        "q1_wide_bound_ms": k["q1_wide"]["bound_ms"],
        "q1_wide_plain_ms": k["q1_wide"]["plain_ms"],
        "q6_ms": k["q6"]["ms"], "q6_bound_ms": k["q6"]["bound_ms"],
        "q6_plain_ms": k["q6"]["plain_ms"],
        "ptxas": usage if usage else "not measured",
        "mvcc_view_ms": mv["kernel"]["ms"],
        "mvcc_view_bound_ms": mv["kernel"]["bound_ms"],
        **{f"encoded_{label}_{f}": v[f]
           for label, v in grp["encoded"]["k8"].items()
           for f in ("ms", "plain_ms", "bound_ms", "encoded_turns_ms",
                     "plain_planes_turns_ms")}}


def rows_alone(device, bw: float, rate: float) -> None:
    """The rows phases without the others: the flat and multi-version
    tables, the rows phase, the overlay phase's waves (applied and
    flushed as there), the rows phase over several sources, and the
    kernels line's K7 and K9 entries."""
    from yugabyte_db_tpu_torch import workload

    flat = flat_engine(device)
    schema, rows, updates, _l, max_ht, eng, _g, _a = mvcc_engine(device)
    mvcc = SimpleNamespace(schema=schema, rows=rows, updates=updates,
                           max_ht=max_ht, eng=eng)
    out = rows_phase(device, bw, rate, flat, mvcc)
    ht = flat.max_ht
    for w in range(WAVES + 1):
        wave, ht = workload.make_wave_rows(flat.schema, ENGINE_KEYS,
                                           ENGINE_KEYS // 50, ht, seed=21 + w)
        flat.eng.apply(wave)
        if w < WAVES - 1:
            flush(flat.eng, "overlay")
    flat.sources_read_ht = ht + 1
    eng.apply(workload.make_update_rows(schema, rows, max_ht,
                                        MVCC_KEYS // 50)[0])
    sources = rows_sources_phase(device, bw, rate, flat, mvcc)
    print(json.dumps({"kernels": row_path_entries(out, sources)}))


def row_path_entries(rows: dict, sources: dict) -> list:
    """The kernels line's K7 and K9 entries: K7 at a YCSB-E batch on the
    multi-version run (the newest read point; the mid one and the full
    scans' chunks launches beside it), K9 at the widest launch of the
    row scan over several sources; launches of the phases' counted runs,
    the build's registers and stack, the shape the library reports for
    the timed launch, and the launches held on the edge planes (every one
    byte for byte, or the phase fails)."""
    usage = ptxas_usage("row_gather")
    err = max(h["max_abs_err"] for h in rows["held"] + [sources["held"]])
    k7, k9 = rows["k7"], sources["k9"]
    full = rows["full_scan"]
    common = {"route": "cuda",
              "source": "yugabyte_db_tpu_torch/csrc/row_gather.cu",
              "max_abs_err": err, "max_abs_diff": err, "library_ms": None,
              "ptxas": usage if usage else "not measured"}
    gather_launches = {"rows": rows["launches"]["gather_rows"],
                       "rows_sources": sources["launches"]["gather_rows"]}
    cand_launches = {"rows": rows["launches"]["scan_candidates"],
                     "rows_sources": sources["launches"]["scan_candidates"]}
    return [dict(common, **{
        "name": "row_gather", "replaces": "yugabyte_db_tpu/ops/row_gather.py:143",
        "launches": sum(gather_launches.values()),
        "launches_by_path": gather_launches,
        "ms": k7["ms"], "plain_ms": k7["plain_ms"],
        "bound_ms": k7["bound_ms"], "bound_by": k7["bound_by"],
        "pages": k7["pages"], "M": k7["M"], "geometry": k7["geometry"],
        "edge_launches": rows["edges"]["launches"],
        "library_note": "no single PyTorch call resolves MVCC groups and "
                        "compacts the first M matches",
        "mid_ms": k7["mid"]["ms"], "mid_bound_ms": k7["mid"]["bound_ms"],
        "chunks_flat_ms": full["flat"]["k7_chunks_launch"]["ms"],
        "chunks_flat_bound_ms": full["flat"]["k7_chunks_launch"]["bound_ms"],
        "chunks_mv_ms": full["mv"]["k7_chunks_launch"]["ms"],
        "chunks_mv_bound_ms": full["mv"]["k7_chunks_launch"]["bound_ms"]}),
        dict(common, **{
            "name": "scan_window", "replaces": "yugabyte_db_tpu/ops/scan.py:320",
            "launches": sum(cand_launches.values()),
            "launches_by_path": cand_launches,
            "ms": k9["ms"], "plain_ms": k9["plain_ms"],
            "bound_ms": k9["bound_ms"], "bound_by": k9["bound_by"],
            "windows": k9["windows"], "geometry": k9["geometry"],
            **{f"windows_{n}_{key}": t[key] for n, t in k9["narrow"].items()
               for key in ("ms", "plain_ms", "bound_ms")},
            "library_note": "no single PyTorch call resolves MVCC groups "
                            "of a window"})]


# -- phase 10: encoded planes (K10, K13b, K12's codes route, K8's decode) -----

ENCODED = {}  # the encoded phase's parts, by name (the kernels line reads it)
K10_LAUNCHES: dict = {}  # K10 launches on each main path, by path
ENCODED_WRITES = 1_000  # writes over the compacted run (the overlay, K13b)
ENCODED_BATCH = 32      # specs of the batch over the compacted run
K10_EDGE_B = 6          # blocks of an edge leaf (padded to 8)


def plain_tree_diff(side: dict, plain: dict, B: int) -> int:
    """Largest |difference| between K10's side-car and the plain upload of
    the same run (``plane_encoding`` "off") over the planes both have and
    the run's own blocks (a const leaf decodes its value into the pad
    blocks too, where the plain upload pads zeros)."""
    g, w = view_planes(side), view_planes(plain)
    shared = [k for k in w if k in g]
    check(len(shared) >= len(w) - sum(1 for k in w if k.endswith("arith")),
          "the side-car lacks planes of the plain upload")
    return view_diff({k: g[k][:B] for k in shared},
                     {k: w[k][:B] for k in shared})


def measure_k10(arrays: dict, bw: float, plan) -> dict:
    """K10 over a run's encoded tree held byte for byte against its plain
    version, timed (CUDA events, calls queued) beside the plain version
    and its bound: the encoded leaves read once and the plain planes
    written once (``decode_bytes``) over the bandwidth. ``plan`` is the
    part table the run laid out when it was uploaded (``GpuRun``), which
    must equal ``plan_tree``'s. ``ms`` is the decode a run's first read
    makes (``GpuRun.plain``: ``decode_tree`` over ``plan``, the output
    allocated, one launch); ``launch_ms`` the launch alone into an
    allocation made once; ``tree_ms`` a ``decode_tree`` without the run's
    table, which lays one out and uploads it in the call."""
    import torch

    from yugabyte_db_tpu_torch.ops import decode
    from yugabyte_db_tpu_torch.ops import encodings as enc

    check(plan is not None and plan.table is not None and np.array_equal(
        plan.rows, decode.plan_tree(arrays).rows),
          "the run holds no part table of its upload, or another one")
    launches0 = decode.decode_tree.launches
    err = view_diff(decode.decode_tree(arrays, plan),
                    decode.decode_tree_plain(arrays))
    check(err == 0, f"K10 differs from its plain version by {err}")
    out = torch.empty(plan.out_bytes, dtype=torch.uint8,
                      device=plan.table.device)
    ms = cuda_ms(lambda: decode.decode_tree(arrays, plan), KERNEL_REPS,
                 queue_ahead=True)
    launch_ms = cuda_ms(lambda: decode.launch(plan, out), KERNEL_REPS,
                        queue_ahead=True)
    tree_ms = cuda_ms(lambda: decode.decode_tree(arrays), KERNEL_REPS,
                      queue_ahead=True)
    plain_ms = cuda_ms(lambda: decode.decode_tree_plain(arrays), PLAIN_REPS)
    nbytes = decode.decode_bytes(arrays)
    B, R = enc.tree_dims(arrays)
    return {"ms": ms, "launch_ms": launch_ms, "tree_ms": tree_ms,
            "plain_ms": plain_ms, "bytes": nbytes,
            "bound_ms": nbytes / bw * 1e3, "bound_by": "bytes",
            "library_ms": None, "max_abs_err": err, "rows": B * R,
            "parts": int(plan.rows.shape[0]), "items": plan.n_items,
            "launches": decode.decode_tree.launches - launches0}


# K10's edge geometries beside [K10_EDGE_B + 2, 64]: (blocks, R), each
# decoded in one launch. R = 7 and 9 end parts inside a 16-byte unit
# (tails) and put a unit's words in two blocks of R rows; (1, 1) is a part
# of one unit; R = 2048 puts several work items in a block.
K10_EDGE_GEOMETRIES = ((3, 7), (5, 9), (1, 1), (2, 2048))


def k10_edge_leaves(rng, B: int, R: int) -> dict:
    """Edge leaves of a [B, R] run, numpy (K10_EDGE_B's names): every kind
    at [B, R] and [B, R, 2] (bits where R is a multiple of 32), float rle
    and const carrying NaN and -0.0, a dictionary with absent rows in its
    last slot, and one past the shared-memory cap (``dict_cached``)."""
    from yugabyte_db_tpu_torch.ops import decode
    from yugabyte_db_tpu_torch.ops import encodings as enc

    row = np.arange(B * R).reshape(B, R)
    run = R if R < 32 else 16  # rows a run (one a block at small R)
    nan_neg = np.array([np.nan, -0.0, 0.0, 1.5], np.float32)
    planes = {
        "const": (np.full((B, R), -7, np.int32), "const"),
        "const2": (np.full((B, R, 2), 3, np.int32), "const"),
        "delta16": ((rng.integers(-(1 << 30), 1 << 30, (B, 1))
                     + rng.integers(0, 60_000, (B, R))).astype(np.int32),
                    "delta16"),
        "delta16_2": ((rng.integers(-(1 << 30), 1 << 30, (B, 1, 2))
                       + rng.integers(0, 60_000, (B, R, 2))).astype(np.int32),
                      "delta16"),
        "rle": ((row // run * 1_000_000).astype(np.int32), "rle"),
        "rle2": (rng.integers(-9, 9, (B * R, 2))[(row // run).reshape(-1)]
                 .reshape(B, R, 2).astype(np.int32), "rle"),
        "float_const_nan": (np.full((B, R), np.nan, np.float32), "const"),
        "float_const_negzero": (np.full((B, R), -0.0, np.float32), "const"),
        "float_rle": (nan_neg[row // run % 4], "rle"),
    }
    if R % 32 == 0:
        planes["bits"] = (rng.random((B, R)) < 0.4, "bits")
    encoders = {"bits": enc.encode_bits, "const": enc.encode_const,
                "delta16": enc.encode_delta16, "rle": enc.encode_rle}
    leaves = {}
    for name, (p, kind) in planes.items():
        leaf = encoders[kind](p)
        check(enc.leaf_kind(leaf) == kind, f"K10 edge {name} at [{B}, {R}]: "
                                           f"{enc.leaf_kind(leaf)}")
        leaves[name] = leaf
    codes = rng.integers(0, 5, (B, R)).astype(np.int64)
    codes.reshape(-1)[3:40] = 7  # absent rows: the last slot
    leaves["dict_absent"] = enc.dict_leaf(
        codes, np.array([1, 2, 3, 4, 5, 0, 0, 0], np.int32),
        np.array([-1, -2, -3, -4, -5, 0, 0, 0], np.int32))
    big = 2 * decode.DICT_SMEM_CAP // 8  # entries past the cap
    leaves["dict_cached"] = enc.dict_leaf(
        rng.integers(0, big, (B, R)).astype(np.int64),
        rng.integers(-(1 << 30), 1 << 30, big).astype(np.int32),
        rng.integers(-(1 << 30), 1 << 30, big).astype(np.int32))
    return leaves


def k10_edges(device) -> dict:
    """K10 on edge leaves, each byte for byte against the plain version
    (untimed), one launch a geometry: ``k10_edge_leaves`` at [K10_EDGE_B,
    64] padded past their blocks (bits of group_start with all-ones
    words), then at each of K10_EDGE_GEOMETRIES; the dictionary past the
    shared-memory cap must be read through the read-only cache."""
    import torch

    from yugabyte_db_tpu_torch.ops import decode
    from yugabyte_db_tpu_torch.ops import encodings as enc

    rng = np.random.default_rng(31)

    def up(a):
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint16:
            a = a.view(np.int16)
        return torch.from_numpy(a).to(device)

    out = {}
    for B, R in ((K10_EDGE_B, 64),) + K10_EDGE_GEOMETRIES:
        leaves = k10_edge_leaves(rng, B, R)
        if R == 64:  # padded past the run's blocks
            leaves = {n: enc.pad_leaf(leaf, B + 2, ones=n == "bits")
                      for n, leaf in leaves.items()}
            B += 2
        names = list(leaves)
        dev = [{k: {n: up(a) for n, a in leaf[k].items()} for k in leaf}
               for leaf in leaves.values()]
        plan = decode.plan_leaves(dev, B, R)
        pair = [r for r in plan.rows if r[0] == decode._KIND["pair"]]
        check([int(r[6]) >= 0 for r in pair] == [True, False],
              "K10's dictionaries: the small one in shared memory, the "
              "one past the cap through the cache")
        launches0 = decode.decode_tree.launches
        got = decode.decode_leaves(dev, B, R, plan)
        check(decode.decode_tree.launches - launches0 == 1,
              "K10's edges are not one launch")
        for name, leaf, planes_got in zip(names, dev, got):
            want = enc.decode_leaf(leaf, B, R)
            if enc.leaf_kind(leaf) == "dict":
                want = [want[..., :2].contiguous(), want[..., 2].contiguous()]
            else:
                want = [want]
            if name == "dict_absent":
                absent = torch.from_numpy(
                    leaves[name]["dict"]["codes"].reshape(-1) == 7).to(device)
                check(bool((want[0].reshape(-1, 2)[absent] == 0).all()),
                      "the absent slot does not decode to (0, 0)")
            err = max(view_diff({"p": g}, {"p": w})
                      for g, w in zip(planes_got, want))
            check(err == 0, f"K10 edge {name} at [{B}, {R}] differs by "
                            f"{err}")
            out[f"{name}_{B}x{R}"] = {"max_abs_err": err}
    return out


def encoded_compacted(eng, updates: list, oracles: dict, reads: list,
                      schema, rows, max_ht: int, device, bw: float) -> dict:
    """The compact phase's merged run, encoded: its bytes by encoding
    (``stats()``), K10 held against its plain version and the plain
    upload and timed, K10's edges; the headline spec alone and a batch of
    ENCODED_BATCH through the side-car and K1 against the history; then
    ENCODED_WRITES writes: the overlay's masked primary through K13b (the
    bit-packed valid decoded by K10, then K13), exact again."""
    import torch

    from yugabyte_db_tpu_torch import workload
    from yugabyte_db_tpu_torch.ops import decode, flat_agg, mvcc_resolve
    from yugabyte_db_tpu_torch.ops import encodings as enc
    from yugabyte_db_tpu_torch.ops.device_run import DeviceRun
    from yugabyte_db_tpu_torch.storage.gpu_engine import PAD_BLOCKS

    t0 = time.perf_counter()
    trun = eng.runs[0]
    check(trun.dev.encoded, "the compacted run uploaded plain planes")
    stats = eng.stats()["plane_encoding"]
    print("encoded_stats_compacted " + json.dumps(stats))
    out = {"versions": trun.crun.num_versions, "stats": stats,
           "valid_kind": enc.leaf_kind(trun.dev.arrays["valid"])}
    check(out["valid_kind"] == "bits", "the compacted run's valid is plain")
    k10 = measure_k10(trun.dev.arrays, bw, trun.resident().decode_plan)
    off = DeviceRun(trun.crun, PAD_BLOCKS, device=device, setting="off")
    k10["off_upload_max_abs_err"] = plain_tree_diff(
        trun.plain(), off.arrays, trun.crun.B)
    check(k10["off_upload_max_abs_err"] == 0,
          "K10's side-car differs from the plain upload")
    k10["encoded_bytes"] = trun.dev.nbytes
    k10["plain_upload_bytes"] = off.nbytes
    del off
    k10["edges"] = k10_edges(device)
    out["k10"] = k10
    print("encoded_k10 " + json.dumps(k10))

    # K1 through the side-car (and the resolve: the run is multi-version).
    read = reads[-1]
    flat_agg.flat_aggregate.launches = 0
    route = eng._plan_scan(workload.headline_spec(read)).route
    got = eng.scan(workload.headline_spec(read)).rows[0]
    check(got == oracles[read].headline(-500_000),
          f"encoded compacted headline {got}")
    los = [-500_000 + 31_250 * i for i in range(ENCODED_BATCH)]
    batch = eng.scan_batch([workload.headline_spec(read, lo) for lo in los])
    for lo, r in zip(los, batch):
        check(r.rows[0] == oracles[read].headline(lo),
              f"encoded compacted batch d >= {lo}: {r.rows[0]}")
    out["k1"] = {"route": route, "batch": ENCODED_BATCH,
                 "launches": flat_agg.flat_aggregate.launches}
    check(out["k1"]["launches"] > 0, "K1 did not serve the encoded run")

    # ENCODED_WRITES writes in the memtable: the overlay over the
    # compacted primary, its valid bits decoded by K10 and cleared (K13b).
    writes, ht = workload.make_update_rows(schema, rows, max_ht + 2,
                                           ENCODED_WRITES, seed=41)
    top = ht + 1
    want = HistoryOracle(schema, rows, updates + writes).at(top)
    eng.apply(writes)
    decode.decode_tree.launches = 0
    flat_agg.flat_aggregate.launches = 0
    mvcc_resolve.resolve_view.launches = 0
    t1 = time.perf_counter()
    got = eng.scan(workload.headline_spec(top)).rows[0]
    first_ms = (time.perf_counter() - t1) * 1e3
    check(got == want.headline(-500_000), f"encoded overlay {got}")
    ov = eng._overlay(eng.memtable)
    check(ov is not None and ov.masked.dev.arrays["valid"].dtype ==
          torch.bool, "the overlay over the encoded run has no masked "
                      "primary")
    for lo in (-900_000, 0, 400_000):
        r = eng.scan(workload.headline_spec(top, lo)).rows[0]
        check(r == want.headline(lo), f"encoded overlay d >= {lo}: {r}")
    out["overlay"] = {
        "writes": ENCODED_WRITES, "first_scan_ms": first_ms,
        "dirty_rows": int(ov.idx.size),
        "k13b_k10_launches": decode.decode_tree.launches,
        "k1_launches": flat_agg.flat_aggregate.launches,
        "resolve_launches": mvcc_resolve.resolve_view.launches}
    check(decode.decode_tree.launches == 1,
          f"K13b launched K10 {decode.decode_tree.launches} times")
    K10_LAUNCHES["overlay"] = decode.decode_tree.launches
    out["s"] = time.perf_counter() - t0
    print("encoded_compacted " + json.dumps(
        {k: v for k, v in out.items() if k != "k10"}))
    return out


def encoded_mvcc(mvcc, device) -> dict:
    """The multi-version table of the mvcc phase (MVCC_KEYS keys,
    MVCC_UPDATES zipfian updates, the overlay phase's live wave): the
    wave flushed (K12), then the runs compacted with no history dropped
    into one run of every version, which uploads encoded; the headline
    spec at the newest and a mid read point through the resolve on K10's
    side-car and K1, against the history."""
    from yugabyte_db_tpu_torch import workload
    from yugabyte_db_tpu_torch.ops import decode, flat_agg, mvcc_resolve

    t0 = time.perf_counter()
    eng = mvcc.eng
    if eng.memtable.num_versions:
        flush(eng, "encoded")
    decode.decode_tree.launches = 0
    flat_agg.flat_aggregate.launches = 0
    mvcc_resolve.resolve_view.launches = 0
    t1 = time.perf_counter()
    eng.compact(1)  # a cutoff before every version: nothing is dropped
    compact_s = time.perf_counter() - t1
    trun = eng.runs[0]
    updates = mvcc.updates + getattr(mvcc, "wave", [])
    check(len(eng.runs) == 1 and trun.dev.encoded and not trun.flat and
          trun.crun.num_versions == len(mvcc.rows) + len(updates),
          "the compacted multi-version run is not one encoded run of every "
          "version")
    if hasattr(mvcc, "wave_oracle"):  # the mvcc and overlay phases' oracles
        newest, mid = mvcc.wave_newest, mvcc.mid_read
        oracles = {newest: mvcc.wave_oracle, mid: mvcc.oracles[mid]}
    else:
        newest = max(u.ht for u in updates) + 1
        mid = updates[len(mvcc.updates) // 2].ht
        oracles = HistoryOracle(mvcc.schema, mvcc.rows, updates).at_reads(
            [newest, mid])
    for rd in (newest, mid):
        for lo in (-500_000, 0):
            got = eng.scan(workload.headline_spec(rd, lo)).rows[0]
            check(got == oracles[rd].headline(lo),
                  f"encoded multi-version run at {rd}, d >= {lo}: {got}")
    out = {"versions": trun.crun.num_versions, "compact_s": compact_s,
           "route": eng._plan_scan(workload.headline_spec(newest)).route,
           "stats": eng.stats()["plane_encoding"],
           "launches": {"decode": decode.decode_tree.launches,
                        "mvcc_resolve": mvcc_resolve.resolve_view.launches,
                        "flat_agg": flat_agg.flat_aggregate.launches}}
    check(out["launches"]["decode"] == 1 and
          out["launches"]["mvcc_resolve"] > 0 and
          out["launches"]["flat_agg"] > 0,
          f"encoded multi-version launches {out['launches']}")
    K10_LAUNCHES["mvcc"] = out["launches"]["decode"]
    out["s"] = time.perf_counter() - t0
    print("encoded_mvcc " + json.dumps(out))
    return out


def q1_promoted_spec(read: int):
    """Q1 with ``l_returnflag >= 'N' and l_linestatus = 'O'``: string
    predicates the engine promotes to dictionary-code compares."""
    from yugabyte_db_tpu_torch import workload
    from yugabyte_db_tpu_torch.storage import Predicate

    spec = workload.q1_spec(read)
    spec.predicates = list(spec.predicates) + [
        Predicate("l_returnflag", ">=", "N"),
        Predicate("l_linestatus", "=", "O")]
    return spec


def grouped_encoded(ctx, device, bw: float, rate: float) -> dict:
    """TPC-H lineitem at LINEITEM_ROWS, encoded. The flushed run's dictionary
    columns (K12's codes route, held byte for byte by ``flush``) under Q1
    and Q6 (K8 decoding the dictionary leaves, checked by the grouped
    phase); then the run compacted (no history dropped) so that every
    leaf kind is present: Q1 and Q6 exact, K8 on the encoded tree held
    against its plain version and timed beside its bound and in turns
    with the same planes uploaded plain; Q1 with string predicates
    promoted to code compares, exact, with no gather and no host
    verify."""
    import torch

    from yugabyte_db_tpu_torch import workload
    from yugabyte_db_tpu_torch.ops import decode, group_agg, row_gather
    from yugabyte_db_tpu_torch.ops import encodings as enc
    from yugabyte_db_tpu_torch.ops.device_run import DeviceRun
    from yugabyte_db_tpu_torch.storage.gpu_engine import PAD_BLOCKS

    t0 = time.perf_counter()
    eng, cols = ctx.eng, ctx.cols
    read = ctx.max_ht + 1
    flag = ctx.schema.column("l_returnflag").col_id
    out = {"flushed_stats": eng.stats()["plane_encoding"],
           "flushed_flag_kind": enc.leaf_kind(
               eng.runs[0].dev.arrays["cols"][flag]["cmp"])}
    check(out["flushed_flag_kind"] == "dict",
          "the flushed lineitem's l_returnflag is not dictionary codes")
    t1 = time.perf_counter()
    eng.compact(1)  # a cutoff before every version: nothing is dropped
    out["compact_s"] = time.perf_counter() - t1
    trun = eng.runs[0]
    encoded = trun.dev.encoded  # the merged run's upload: its first access
    stats = eng.stats()["plane_encoding"]
    out["compacted_stats"] = stats
    print("encoded_stats_lineitem " + json.dumps(stats))
    check(encoded and {"bits", "dict", "delta16"} <=
          set(stats["by_encoding"]), f"the compacted lineitem's encodings "
                                     f"{stats['by_encoding']}")
    q1, q6 = workload.q1_spec(read), workload.q6_spec(read)
    group_agg.grouped_aggregate.launches = 0
    decode.decode_tree.launches = 0
    for spec, want in ((q1, q1_oracle(cols)), (q6, q6_oracle(cols))):
        got = eng.scan(spec).rows
        check(got == want, f"encoded lineitem: {got} != {want}")
    # Q1 promoted: no gather, no host verify round.
    pq = q1_promoted_spec(read)
    keep = (cols["l_returnflag"] >= "N") & (cols["l_linestatus"] == "O")
    want = q1_oracle({k: v[keep] for k, v in cols.items()})
    p0, g0 = eng.code_promotions, row_gather.gather_rows.launches
    route = eng._plan_scan(pq).route
    got = eng.scan(pq).rows
    check(got == want, f"promoted Q1 {got} != {want}")
    check(eng.code_promotions - p0 == 2 and route == "grouped" and
          row_gather.gather_rows.launches == g0,
          "the promoted Q1 was not served by K8 alone")
    out["promoted_q1"] = {"route": route, "groups": len(got),
                          "gather_launches": row_gather.gather_rows.launches
                          - g0}
    out["launches"] = {"group_agg": group_agg.grouped_aggregate.launches,
                       "decode": decode.decode_tree.launches}
    check(out["launches"]["group_agg"] >= 3 and
          out["launches"]["decode"] == 0,
          f"encoded lineitem launches {out['launches']}")
    check(eng.grouped_host_folds == 0, "encoded Q1/Q6 re-served on host")

    # K8 on the encoded tree, against the same planes uploaded plain.
    off = DeviceRun(trun.crun, PAD_BLOCKS, device=device, setting="off")
    kern = {}
    for label, spec in (("q1", q1), ("q6", q6), ("q1_promoted", pq)):
        plan, table, params = k8_inputs(eng, [spec])
        check(any(enc.leaf_kind(t) is not None for t in table
                  if t is not None), "K8's table holds no encoded leaf")
        k = measure_k8(plan, table, params, bw, rate)
        plain_table = plan.plane_table(
            off.arrays if label != "q1_promoted" else trun.plain())
        k8_exact(plan, plain_table, params)
        a = lambda: group_agg.grouped_aggregate(plan, table, params)
        b = lambda: group_agg.grouped_aggregate(plan, plain_table, params)
        turns = [cuda_ms(f, KERNEL_REPS, queue_ahead=True)
                 for f in (a, b, b, a)]
        k["encoded_turns_ms"] = [turns[0], turns[3]]
        k["plain_planes_turns_ms"] = [turns[1], turns[2]]
        k["plain_planes_bytes"] = group_agg.group_bytes(plan, plain_table,
                                                        params)
        kern[label] = k
        print(f"encoded_k8_{label} " + json.dumps(k))
    out["k8"] = kern
    out["device_bytes"] = {"encoded": trun.dev.nbytes,
                           "plain_upload": off.nbytes}
    del off
    torch.cuda.empty_cache()
    # K10 over the compacted tree (every leaf kind), timed.
    out["k10"] = measure_k10(trun.dev.arrays, bw, trun.resident().decode_plan)
    print("encoded_k10_lineitem " + json.dumps(out["k10"]))
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t0
    print("encoded_lineitem " + json.dumps(
        {k: v for k, v in out.items() if k != "k8"}))
    return out


def decode_entry() -> dict:
    """The kernels line's K10 entry: K10 over the compact phase's merged
    run (and over the compacted lineitem beside it), its launches on
    the main paths (the compacted run's first reads, the overlay's K13b,
    the encoded multi-version run), and the build's registers and stack
    (no spill, no stack frame)."""
    usage = ptxas_usage("decode")
    check(all(u.get("spill_store_bytes", 0) == 0 and
              u.get("spill_load_bytes", 0) == 0 and
              u.get("stack_bytes", 0) == 0 for u in usage),
          f"K10's build spills or has a stack frame: {usage}")
    comp = ENCODED["compacted"]["k10"]
    line = ENCODED["lineitem"]["k10"]
    err = max([comp["max_abs_err"], comp["off_upload_max_abs_err"],
               line["max_abs_err"]]
              + [e["max_abs_err"] for e in comp["edges"].values()])
    return {"name": "decode", "route": "cuda",
            "source": "yugabyte_db_tpu_torch/csrc/decode.cu",
            "replaces": "yugabyte_db_tpu/ops/encodings.py:435",
            "launches": sum(K10_LAUNCHES.values()),
            "launches_by_path": dict(K10_LAUNCHES),
            "max_abs_err": err, "max_abs_diff": err, "ms": comp["ms"],
            "plain_ms": comp["plain_ms"], "bound_ms": comp["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
            "library_note": "no single PyTorch call decodes a run's leaf "
                            "table",
            "bytes": comp["bytes"], "launch_ms": comp["launch_ms"],
            "tree_ms": comp["tree_ms"],
            "lineitem_ms": line["ms"], "lineitem_bound_ms": line["bound_ms"],
            "lineitem_launch_ms": line["launch_ms"],
            "lineitem_plain_ms": line["plain_ms"],
            "lineitem_bytes": line["bytes"],
            "ptxas": usage if usage else "not measured"}


def encoded_alone(device, bw: float, rate: float) -> None:
    """The encoded phase without the others: the compact phase (on the
    engine phase's table and the overlay phase's waves, as
    ``compact_alone``), the mvcc table (MVCC_KEYS keys and updates, one
    wave live) compacted encoded, and TPC-H lineitem at LINEITEM_ROWS;
    prints the kernels line's K10 and K8 entries."""
    global ENGINE_KEYS, MVCC_KEYS, MVCC_UPDATES

    from yugabyte_db_tpu_torch import workload

    compact_alone(device, bw, rate)
    schema, rows, updates, _l, max_ht, eng, _g, _a = mvcc_engine(device)
    wave, _ht = workload.make_update_rows(schema, rows, max_ht,
                                          MVCC_KEYS // 50)
    eng.apply(wave)
    mvcc = SimpleNamespace(schema=schema, rows=rows, updates=updates,
                           max_ht=max_ht, eng=eng, wave=wave)
    ENCODED["mvcc"] = encoded_mvcc(mvcc, device)
    del mvcc, eng
    ctx = lineitem_engine(device, LINEITEM_ROWS)
    ENCODED["lineitem"] = grouped_encoded(ctx, device, bw, rate)
    print(json.dumps({"kernels": [decode_entry()]}))


# -- the residency budget and the fault domain (storage.residency, breaker) --

RESIDENCY_ROUNDS = 4     # alternating batches on the two tables
RESIDENCY_HEADROOM = 1.25  # the budget over the larger run's entry bytes
MV_RESIDENCY_BATCH = 16  # specs at each of the mvcc table's two read points
FAULT_KEYS = 20_000      # keys of the range the faulted batches read
FAULT_SPECS = 2          # specs of a faulted batch (host re-serve: Python)
BREAKER_COOLDOWN_S = 0.05  # the engines' breakers' cooldown
_HOST_RESERVES = [0]     # batches re-served from the host, by any engine
_FAULT_ENGINES: set = set()  # breakers the residency phase faults


def configure_breakers() -> None:
    """Every engine the smoke builds gets a breaker that opens on its
    first device fault and admits a probe after BREAKER_COOLDOWN_S (the
    flags ``gpu_breaker_failure_threshold`` / ``gpu_breaker_cooldown_s``,
    set before any engine is built): the fault phase opens one with a
    single fault, and a fault in any other phase trips its engine's
    breaker, which ``check_no_fault`` fails on."""
    from yugabyte_db_tpu_torch.utils.flags import FLAGS

    FLAGS.set("gpu_breaker_failure_threshold", 1)
    FLAGS.set("gpu_breaker_cooldown_s", BREAKER_COOLDOWN_S)


def watch_host_reserves() -> None:
    """Count every host re-serve of every ``gpu`` engine (the smoke's
    proxy of ``GpuStorageEngine._serve_host_batch``), so that a phase can
    fail on one it did not ask for."""
    from yugabyte_db_tpu_torch.storage import gpu_engine

    cls = gpu_engine.GpuStorageEngine
    if getattr(cls._serve_host_batch, "watched", False):
        return
    serve = cls._serve_host_batch

    def counted(self, specs, deadline=None):
        _HOST_RESERVES[0] += 1
        return serve(self, specs, deadline)

    counted.watched = True
    cls._serve_host_batch = counted


def check_no_fault(phase: str, reserves0: int) -> None:
    """A phase other than ``residency`` ends with no host re-serve and with
    every live engine's breaker closed and never tripped (the residency
    phase's faulted engines aside): a device fault there fails the smoke
    instead of being re-served."""
    from yugabyte_db_tpu_torch.storage import breaker

    check(_HOST_RESERVES[0] == reserves0,
          f"phase {phase}: {_HOST_RESERVES[0] - reserves0} batches were "
          "re-served from the host")
    for b in list(breaker._BREAKERS):
        if b.name in _FAULT_ENGINES:
            continue
        check(b.state == breaker.CLOSED and b.trips == 0,
              f"phase {phase}: breaker {b.name} is {b.state} after "
              f"{b.trips} trips ({b.last_error!r})")


def entry_bytes(trun) -> int:
    """Bytes the residency cache charges a run now (payload and aux)."""
    from yugabyte_db_tpu_torch.storage.residency import hbm_cache

    e = hbm_cache()._entries.get(trun._res_key)
    return 0 if e is None or e.payload is None else e.total_bytes


def resident_tensors(cache) -> list:
    """Every device tensor the cache holds: payloads and aux values."""
    import torch

    out = []
    stack = [[e.payload for e in cache._entries.values()
              if e.payload is not None and not e.external],
             [v for e in cache._entries.values() for v, _n in e.aux.values()]]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
        elif isinstance(node, torch.Tensor):
            out.append(node)
        elif hasattr(node, "dev"):  # a run's payload
            stack.append([node.dev.arrays, node.const,
                          node.decode_plan.table if node.decode_plan
                          else None])
        elif hasattr(node, "table"):  # a decode plan
            stack.append(node.table)
    return out


def allocator_blocks() -> dict:
    """{address: bytes} of every allocated block of the caching allocator
    (``torch.cuda.memory_snapshot``): what ``memory_allocated`` sums."""
    import torch

    out = {}
    for seg in torch.cuda.memory_snapshot():
        addr = seg["address"]
        for blk in seg["blocks"]:
            if blk["state"] == "active_allocated":
                out[blk.get("address", addr)] = blk["size"]
            addr += blk["size"]
    return out


def release_check(cache) -> dict:
    """After ``evict_unpinned()``, ``torch.cuda.memory_allocated()`` falls
    by exactly the allocator's blocks of the allocations the cache held
    (``torch.cuda.memory_snapshot``: a block is its request rounded up,
    and one of 1 MiB or more may keep an unsplit remainder), and the cache
    released exactly the bytes of those allocations: tolerance 0 on both.
    Every tensor the cache held must be freed (weak references): none
    outlives its entry."""
    import gc
    import weakref

    import torch

    gc.collect()
    torch.cuda.synchronize()
    held = [weakref.ref(t) for t in resident_tensors(cache)]
    storages = {s.data_ptr(): s.nbytes() for s in
                (r().untyped_storage() for r in held) if s.nbytes()}
    blocks = allocator_blocks()
    missing = [p for p in storages if p not in blocks]
    block_bytes = sum(blocks.get(p, 0) for p in storages)
    del blocks
    before, res0 = torch.cuda.memory_allocated(), cache.resident_bytes()
    evicted = cache.evict_unpinned()
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    released = res0 - cache.resident_bytes()
    alive = sum(1 for r in held if r() is not None)
    out = {"evicted_entries": evicted, "released_bytes": released,
           "allocation_bytes": sum(storages.values()),
           "allocator_block_bytes": block_bytes,
           "allocated_fell_bytes": before - after, "tolerance_bytes": 0,
           "allocations": len(storages), "tensors_alive": alive}
    check(not missing, f"{len(missing)} allocations the cache holds are "
          "not blocks of the caching allocator")
    check(released > 0 and released == out["allocation_bytes"],
          f"the cache released {released} bytes where its allocations "
          f"hold {out['allocation_bytes']}: a charge is not what it holds")
    check(before - after == block_bytes,
          f"memory_allocated fell by {before - after} bytes where the "
          f"cache's allocations are {block_bytes} bytes of blocks: a "
          "reference outlives its entry, or an uncharged one died with it")
    check(alive == 0, f"{alive} device tensors outlive their evicted entry")
    return out


def range_oracle(schema, rows, updates, keys: set, read_ht: int) -> Oracle:
    """The headline oracle over the keys of ``keys`` only (their rows and
    updates merged in this process: a small slice)."""
    sub = HistoryOracle(schema, [r for r in rows if r.key in keys],
                        [u for u in updates if u.key in keys])
    return sub.at(read_ht, sub.merged([read_ht])[0])


def fault_phase(flat, device) -> dict:
    """Faults on a bounded range of FAULT_KEYS keys of the flat table (the
    host re-serve is Python): an armed ``fault.gpu_dispatch``, then one
    real device error (K1's wrapper wrapped here to allocate past the free
    device memory first, which raises ``torch.cuda.OutOfMemoryError``).
    Each faulted batch is re-served from the host equal to the oracle, the
    breaker (threshold 1) opens, and the next batch after the cooldown is
    the probe: served on the device, equal to the oracle, the breaker
    closed; no pin leaks."""
    import torch

    from yugabyte_db_tpu_torch import workload
    from yugabyte_db_tpu_torch.ops import flat_agg
    from yugabyte_db_tpu_torch.storage import breaker
    from yugabyte_db_tpu_torch.storage.residency import hbm_cache
    from yugabyte_db_tpu_torch.utils.fault_injection import arm_fault_once

    eng, read = flat.eng, flat.read
    cache = hbm_cache()
    t0 = time.perf_counter()
    keys = sorted(r.key for r in flat.rows)
    first = len(keys) // 3
    lower, upper = keys[first], keys[first + FAULT_KEYS]
    oracle = range_oracle(flat.schema, flat.rows, flat.updates,
                          set(keys[first:first + FAULT_KEYS]), read)
    oracle_s = time.perf_counter() - t0
    lits = [-500_000 + 400_000 * i for i in range(FAULT_SPECS)]

    def batch():
        specs = []
        for lo in lits:
            s = workload.headline_spec(read, lo)
            s.lower, s.upper = lower, upper
            specs.append(s)
        return specs

    def run(label):
        t = time.perf_counter()
        got = eng.scan_batch(batch())
        ms = (time.perf_counter() - t) * 1e3
        for lo, r in zip(lits, got):
            check(r.rows[0] == oracle.headline(lo),
                  f"{label}, d >= {lo}: {r.rows[0]} != {oracle.headline(lo)}")
        return ms

    br = eng.breaker
    check(br.failure_threshold == 1,
          f"the engine's breaker opens after {br.failure_threshold} faults")
    _FAULT_ENGINES.add(br.name)
    out = {"keys": FAULT_KEYS, "specs": FAULT_SPECS, "oracle_s": oracle_s}
    device_ms = run("the range on the device")
    pins0 = cache.pinned_bytes()
    tracker0 = eng.device_tracker.consumption
    reserves0 = eng.host_reserves
    cases = {}
    real = flat_agg.flat_aggregate

    def exhaust(*args, **kwargs):
        free, _total = torch.cuda.mem_get_info(device)
        torch.empty(free + (1 << 30), dtype=torch.uint8, device=device)
        return real(*args, **kwargs)

    for kind in ("injected", "out_of_memory"):
        trips0 = br.trips
        if kind == "injected":
            arm_fault_once("fault.gpu_dispatch")
        else:
            flat_agg.flat_aggregate = exhaust
        try:
            reserve_ms = run(f"{kind}: the host re-serve")
        finally:
            flat_agg.flat_aggregate = real
        check(br.state == breaker.OPEN and br.trips == trips0 + 1,
              f"{kind}: the breaker is {br.state} after the fault")
        check(eng.host_reserves == reserves0 + 1,
              f"{kind}: the batch was not re-served from the host")
        error = repr(br.last_error)
        time.sleep(br.cooldown_s * 1.5)
        probe_ms = run(f"{kind}: the probe")
        check(br.state == breaker.CLOSED,
              f"{kind}: the breaker is {br.state} after the probe")
        check(eng.host_reserves == reserves0 + 1,
              f"{kind}: the probe was re-served from the host")
        reserves0 = eng.host_reserves
        check(cache.pinned_bytes() == pins0,
              f"{kind}: {cache.pinned_bytes() - pins0} pinned bytes "
              "leaked")
        cases[kind] = {"host_reserve_ms": reserve_ms,
                       "probe_ms": probe_ms, "error": error[:120]}
    out.update(device_ms=device_ms, cases=cases,
               breaker=eng.stats()["breaker"],
               host_reserves=eng.host_reserves,
               tracker_bytes=(tracker0, eng.device_tracker.consumption))
    return out


def residency_phase(device, bw: float, rate: float, flat, mv) -> dict:
    """The residency budget on the card: the flat table (``flat``: its
    compacted, encoded run; ``read``, ``oracle``) and the multi-version
    one (``mv``: its encoded run of every version; ``reads``, ``oracles``)
    under a budget of RESIDENCY_HEADROOM x the larger run's entry bytes
    (payload, K10's side-car, a view), so that batches alternating between
    them evict each other's run. RESIDENCY_ROUNDS rounds of the headline
    32-spec batch and of an mvcc batch at two read points, each result
    against the oracles the earlier phases computed; each miss's upload
    timed beside a pinned host-to-device copy of the same bytes; each
    re-read encoded run's side-car rebuilt by one K10 launch and held byte
    for byte against its plain version; then both runs resident and
    evicted, ``memory_allocated`` against the released bytes
    (``release_check``); then the faults (``fault_phase``). No batch but
    the faulted ones is re-served from the host."""
    import gc

    import torch

    from yugabyte_db_tpu_torch import workload
    from yugabyte_db_tpu_torch.ops import decode
    from yugabyte_db_tpu_torch.storage.residency import hbm_cache
    from yugabyte_db_tpu_torch.utils.flags import FLAGS

    t_phase = time.perf_counter()
    cache = hbm_cache()
    fr, mr = flat.eng.runs[0], mv.eng.runs[0]
    check(len(flat.eng.runs) == 1 and len(mv.eng.runs) == 1 and
          fr.dev.encoded and mr.dev.encoded and not mr.flat,
          "the residency phase wants one encoded run in each table")
    newest, mid = mv.reads

    def flat_batch(r):
        los = [-500_000 - 7 * (r * BATCH + i) for i in range(BATCH)]
        got = flat.eng.scan_batch([workload.headline_spec(flat.read, lo)
                                   for lo in los])
        for lo, res in zip(los, got):
            check(res.rows[0] == flat.oracle.headline(lo),
                  f"residency flat batch d >= {lo}: {res.rows[0]}")

    def mv_batch(r):
        los = [-500_000 - 11 * (r * MV_RESIDENCY_BATCH + i)
               for i in range(MV_RESIDENCY_BATCH)]
        specs = [(rd, lo) for rd in (newest, mid) for lo in los]
        got = mv.eng.scan_batch([workload.headline_spec(rd, lo)
                                 for rd, lo in specs])
        for (rd, lo), res in zip(specs, got):
            check(res.rows[0] == mv.oracles[rd].headline(lo),
                  f"residency mvcc batch at {rd}, d >= {lo}: {res.rows[0]}")

    # The entries' bytes with no budget: payload, side-car and a view.
    gc.collect()
    cache.evict_unpinned()
    flat_batch(0)
    mv_batch(0)
    sizes = {"flat": entry_bytes(fr), "mvcc": entry_bytes(mr)}
    budget = int(RESIDENCY_HEADROOM * max(sizes.values()))
    FLAGS.set("gpu_hbm_budget_bytes", budget)
    cache.evict_unpinned()  # start cold: every round reads an evicted run
    st0 = cache.stats()
    miss_ms, k10, sidecar_err, payload = [], 0, 0, {}
    try:
        for r in range(RESIDENCY_ROUNDS):
            for trun, run_batch in ((fr, flat_batch), (mr, mv_batch)):
                check(trun.peek_device() is None,
                      f"round {r}: the run was not evicted by the other")
                launches0 = decode.decode_tree.launches
                torch.cuda.synchronize()
                t = time.perf_counter()
                res = trun.resident()  # the miss: the run's upload
                torch.cuda.synchronize()
                miss_ms.append((time.perf_counter() - t) * 1e3)
                payload[trun is fr and "flat" or "mvcc"] = res.nbytes
                del res
                run_batch(r + 1)
                k10 += decode.decode_tree.launches - launches0
                check(decode.decode_tree.launches - launches0 == 1,
                      f"round {r}: the side-car took "
                      f"{decode.decode_tree.launches - launches0} K10 "
                      "launches")
                if r == 0:  # the rebuilt side-car against its plain version
                    side = trun.plain()
                    sidecar_err = max(sidecar_err, view_diff(
                        side, decode.decode_tree_plain(trun.dev.arrays)))
                    del side
        check(sidecar_err == 0,
              f"the rebuilt side-car differs from K10's plain version by "
              f"{sidecar_err}")
        st1 = cache.stats()
    finally:
        FLAGS.set("gpu_hbm_budget_bytes", 0)
    nbytes = payload["flat"]  # a miss of the flat run uploads these
    src = torch.empty(nbytes, dtype=torch.uint8).pin_memory()
    dst = torch.empty(nbytes, dtype=torch.uint8, device=device)
    copy_ms = cuda_ms(lambda: dst.copy_(src, non_blocking=True), 5)
    del src, dst
    out = {"card": nvidia_smi(), "budget_bytes": budget,
           "entry_bytes": sizes, "payload_bytes": payload,
           "rounds": RESIDENCY_ROUNDS,
           "hits": st1["hits"] - st0["hits"],
           "misses": st1["misses"] - st0["misses"],
           "evictions": st1["evictions"] - st0["evictions"],
           "demand_upload_bytes": (st1["demand_upload_bytes"]
                                   - st0["demand_upload_bytes"]),
           "peak_resident_bytes": st1["peak_resident_bytes"],
           "miss_upload_ms": statistics.median(miss_ms),
           "miss_upload_ms_all": miss_ms,
           "pinned_copy_bytes": nbytes, "pinned_copy_ms": copy_ms,
           "pinned_copy_bound_ms": nbytes / bw * 1e3,
           "sidecar_k10_launches": k10, "sidecar_max_abs_err": sidecar_err}
    check(out["misses"] >= 2 * RESIDENCY_ROUNDS and out["evictions"] > 0,
          f"the budget did not evict: {out}")
    # Both runs resident, then evicted: the allocator frees what the cache
    # released.
    flat_batch(RESIDENCY_ROUNDS + 1)
    mv_batch(RESIDENCY_ROUNDS + 1)
    out["release"] = release_check(cache)
    check(flat.eng.host_reserves == 0 and mv.eng.host_reserves == 0,
          "a batch under the budget was re-served from the host")
    out["host_reserves"] = flat.eng.host_reserves + mv.eng.host_reserves
    print("residency " + json.dumps(out))
    t0 = time.perf_counter()
    faults = fault_phase(flat, device)
    faults["s"] = time.perf_counter() - t0
    print("breaker " + json.dumps(faults))
    out["faults"] = faults
    out["s"] = time.perf_counter() - t_phase
    return out


def residency_alone(device, bw: float, rate: float) -> None:
    """``--residency``: the engine phase's flat table and the mvcc phase's
    multi-version one, each compacted into one encoded run (a cutoff
    before every version), then the residency phase."""
    ctx = flat_engine(device)
    ctx.eng.compact(1)
    read = ctx.max_ht + 1
    flat = SimpleNamespace(eng=ctx.eng, schema=ctx.schema, rows=ctx.rows,
                           updates=[], read=read,
                           oracle=Oracle.of_rows(ctx.schema, ctx.rows))
    schema, rows, updates, load_ht, max_ht, eng, _g, _l = mvcc_engine(device)
    eng.compact(1)
    reads = (max_ht + 1, (load_ht + max_ht) // 2)
    mv = SimpleNamespace(eng=eng, reads=reads, oracles=HistoryOracle(
        schema, rows, updates).at_reads(list(reads)))
    residency_phase(device, bw, rate, flat, mv)


# -- the tablet phase: the port's Tablet on the gpu engine ------------------

TABLET_KEYS = 500_000         # the bench table at half the engine phase's
                              # keys (the raft phase reuses them): the
                              # smoke's time budget
TABLET_BATCH = 10_000         # rows a Tablet.write: one WAL append + sync
TABLET_UPDATES = 20_000       # zipfian one-field updates, left unflushed
TABLET_UPDATE_BATCH = 100     # updates a Tablet.write (a group commit)
TABLET_PAGES = 256            # YCSB-E LIMIT-100 pages a wire format
TABLET_POINTS = 1_000         # current_row_values point reads
TABLET_DELETES = 1_000        # deletes between a snapshot and its restore
TABLET_LAUNCHES: dict = {}    # the phase's kernel launches, by entry name

# The kernels line's entries and the wrappers whose ``.launches`` count
# their launches (K12 is counted by ``replay_flush.launches`` too).
_COUNTERS = (("flat_agg", "flat_agg", "flat_aggregate"),
             ("mvcc_resolve", "mvcc_resolve", "resolve_view"),
             ("group_agg", "group_agg", "grouped_aggregate"),
             ("row_gather", "row_gather", "gather_rows"),
             ("scan_window", "row_gather", "scan_candidates"),
             ("replay_flush", "flush", "replay_flush"),
             ("gc_mask", "compact", "resident_gc_mask"),
             ("full_agg", "full_agg", "full_aggregate"),
             ("decode", "decode", "decode_tree"))


def launch_counters() -> dict:
    """{entry name: the wrapper function whose ``.launches`` counts}."""
    import importlib

    return {name: getattr(importlib.import_module(
        f"yugabyte_db_tpu_torch.ops.{mod}"), fn)
        for name, mod, fn in _COUNTERS}


class TabletOracle:
    """The bench table's merged state at a read point that sees every
    version, from the rows as the tablet stamped them: each key's
    existence and a, c, d (``merge_versions`` for a key with more than
    one version, its one row otherwise), in key order, for LIMIT pages,
    point reads and the headline aggregates."""

    def __init__(self, schema, rows, more):
        from yugabyte_db_tpu_torch.storage.merge import merge_versions

        cid = {c.name: c.col_id for c in schema.columns}
        self.cid = cid
        by_key: dict = {}
        for u in more:
            by_key.setdefault(u.key, []).append(u)
        self.keys = sorted(r.key for r in rows)
        self.pos = {k: i for i, k in enumerate(self.keys)}
        self.kv = {r.key: i for i, r in enumerate(rows)}
        n = len(self.keys)
        self.exists = np.zeros(n, bool)
        self.vals = {name: [None] * n for name in ("a", "c", "d")}
        for r in rows:
            i = self.pos[r.key]
            vs = by_key.get(r.key)
            if vs is None:
                if r.tombstone:
                    continue
                self.exists[i] = True
                for name in ("a", "c", "d"):
                    self.vals[name][i] = r.columns.get(cid[name])
                continue
            m = merge_versions(r.key, [r] + vs, MAX_HT_READ)
            self.exists[i] = m.exists
            for name in ("a", "c", "d"):
                self.vals[name][i] = m.get(cid[name])
        d = self.vals["d"]
        self.match = np.nonzero(self.exists & np.fromiter(
            (v is not None and v >= -500_000 for v in d), bool, n))[0]

    def key_values(self, key: bytes) -> tuple:
        i = self.kv[key]
        return (f"user{i:06d}", i % 7)

    def headline(self, gone=frozenset()) -> Oracle:
        """The headline aggregates' ``Oracle`` over the rows that exist
        with a non-NULL d, the keys ``gone`` deleted after every version."""
        a, c, d = self.vals["a"], self.vals["c"], self.vals["d"]
        drop = {self.pos[k] for k in gone}
        return Oracle(*Oracle.arrays([
            (d[i], a[i], c[i]) for i in np.nonzero(self.exists)[0].tolist()
            if d[i] is not None and i not in drop]))

    def page(self, spec, extra=()) -> tuple:
        """(rows, resume key) of a YCSB-E page (``d >= -500000``,
        LIMIT 100, projecting k, r, a, d and the all-NULL ``extra``)."""
        p = bisect.bisect_left(self.keys, spec.lower)
        j = int(np.searchsorted(self.match, p))
        take = self.match[j:j + spec.limit].tolist()
        rows = [self.key_values(self.keys[i])
                + (self.vals["a"][i], self.vals["d"][i])
                + (None,) * len(extra) for i in take]
        hit = len(take) >= spec.limit
        return rows, (self.keys[take[-1]] + b"\0" if hit else None)

    def point(self, key: bytes, extra=()):
        """``current_row_values`` (with the all-NULL columns ``extra``):
        None for a key that does not exist."""
        i = self.pos[key]
        if not self.exists[i]:
            return None
        return {**{name: self.vals[name][i] for name in ("a", "c", "d")},
                **{name: None for name in extra}}


MAX_HT_READ = (1 << 63) - 2  # a read point after every version


def stamped_batch(rows, ht: int) -> list:
    """``Tablet.write``'s stamping of one batch: every row at the batch's
    hybrid time, TTLs resolved against it, the row's place as its write
    id."""
    from yugabyte_db_tpu_torch.storage.row_version import RowVersion

    return [RowVersion(r.key, ht=ht, tombstone=r.tombstone,
                       liveness=r.liveness, columns=r.columns,
                       expire_ht=r.resolve_ttl(ht), write_id=i)
            for i, r in enumerate(rows)]


def run_io_speed(reps: int = 2) -> dict:
    """A run file of the bench table's TABLET_KEYS rows (one version a
    key), encoded and decoded by the codec's record functions and by the
    generic codec over the record lists, in turns (``reps`` each, GC
    paused as ``run_io.load_run`` pauses it); the bytes and the versions
    must be equal. Host seconds, no fsync."""
    import gc

    from yugabyte_db_tpu_torch import workload
    from yugabyte_db_tpu_torch.storage.row_version import RowVersion
    from yugabyte_db_tpu_torch.utils import codec

    schema = workload.make_schema()
    rows, _ = bench_rows(schema, TABLET_KEYS)
    entries = sorted(((r.key, [r]) for r in rows), key=lambda e: e[0])

    def generic_encode():
        return codec.encode(["run1", [
            [k, [[v.ht, v.tombstone, v.liveness,
                  {str(c): x for c, x in v.columns.items()}, v.expire_ht,
                  v.write_id] for v in vs]] for k, vs in entries]])

    def generic_decode(buf):
        _magic, payload = codec.decode(buf)
        return [(k, [RowVersion(k, ht=r[0], tombstone=r[1], liveness=r[2],
                                columns={int(c): x
                                         for c, x in r[3].items()},
                                expire_ht=r[4], write_id=r[5])
                     for r in recs]) for k, recs in payload]

    times: dict = {"encode_run": [], "encode": [], "decode_run": [],
                   "decode": []}
    gc.collect()
    gc.disable()
    try:
        for _ in range(reps):
            for name, fn in (("encode_run",
                              lambda: codec.encode_run("run1", entries)),
                             ("encode", generic_encode)):
                t = time.perf_counter()
                buf = fn()
                times[name].append(time.perf_counter() - t)
            check(buf == codec.encode_run("run1", entries),
                  "encode_run's bytes differ from the generic codec's")
            for name, fn in (("decode_run", lambda: codec.decode_run(
                    buf, "run1", RowVersion.stored)),
                             ("decode", lambda: generic_decode(buf))):
                t = time.perf_counter()
                got = fn()
                times[name].append(time.perf_counter() - t)
                check(len(got) == len(entries)
                      and got[0][1][0] == entries[0][1][0]
                      and got[-1][1][0] == entries[-1][1][0],
                      f"{name}: the versions differ")
                del got
    finally:
        gc.enable()
    best = {k: min(v) for k, v in times.items()}
    out = {"card": nvidia_smi(), "versions": len(entries),
           "bytes": len(buf), "s_each": times,
           "encode_speedup": best["encode"] / best["encode_run"],
           "decode_speedup": best["decode"] / best["decode_run"]}
    print("run_io " + json.dumps(out))
    return out


def tablet_write(tablet, rows, batch: int, out: list) -> float:
    """``rows`` through ``Tablet.write`` in batches of ``batch`` (each one
    WAL append and one sync), their stamped versions appended to ``out``:
    the seconds it took."""
    t0 = time.perf_counter()
    hts = []
    for i in range(0, len(rows), batch):
        hts.append(tablet.write(rows[i:i + batch]).value)
    wall = time.perf_counter() - t0
    for j, ht in enumerate(hts):
        out.extend(stamped_batch(rows[j * batch:(j + 1) * batch], ht))
    return wall


def timed_call(fn) -> tuple:
    """(fn()'s result, its wall ms), the device synchronised first."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def tablet_headline(tablet, oracle, label: str) -> dict:
    """The engine phase's 32-spec headline batch through ``scan_many`` at
    the tablet's read point, each answer held against ``oracle`` (a
    HistoryOracle's ``Oracle``), and timed; the same batch on the engine
    beside it."""
    from yugabyte_db_tpu_torch import workload

    read = tablet.read_time().value
    lits = [-500_000 - 7 * i for i in range(BATCH)]
    specs = [workload.headline_spec(read, lo) for lo in lits]
    got, ms = timed_call(lambda: tablet.scan_many(specs))
    for lo, r in zip(lits, got):
        check(r.rows[0] == oracle.headline(lo),
              f"tablet {label}: headline d >= {lo}: {r.rows[0]} != "
              f"{oracle.headline(lo)}")
    _r, eng_ms = timed_call(lambda: tablet.engine.scan_batch(specs))
    return {"batch_ms": ms, "engine_batch_ms": eng_ms, "specs": BATCH}


def tablet_pages(tablet, oracle, label: str, seed: int,
                 extra=()) -> dict:
    """TABLET_PAGES YCSB-E pages through ``scan_wire_many`` in "cql" and
    in "pg", each page's bytes equal to ``models.wirefmt``'s serialization
    of the oracle's rows, and its resume key the oracle's; timed."""
    from yugabyte_db_tpu_torch import workload
    from yugabyte_db_tpu_torch.models import wirefmt
    from yugabyte_db_tpu_torch.storage import ScanSpec

    schema = tablet.meta.schema
    read = tablet.read_time().value
    specs = workload.ycsb_e_batch(schema, TABLET_KEYS, read,
                                  random.Random(seed), TABLET_PAGES)
    proj = ["k", "r", "a", "d", *extra]
    specs = [ScanSpec(lower=s.lower, read_ht=read, predicates=s.predicates,
                      projection=proj, limit=s.limit) for s in specs]
    dts = [schema.column(n).dtype for n in proj]
    wants = [oracle.page(s, extra) for s in specs]
    out = {}
    for fmt in ("cql", "pg"):
        pages, ms = timed_call(lambda: tablet.scan_wire_many(specs, fmt))
        for j, (pg, (rows, resume)) in enumerate(zip(pages, wants)):
            check(pg.nrows == len(rows) and pg.resume == resume,
                  f"tablet {label} {fmt} page {j}: {pg.nrows} rows, "
                  f"resume {pg.resume!r}; oracle {len(rows)}, {resume!r}")
            check(bytes(pg.data) == wirefmt.serialize_rows(fmt, dts, rows),
                  f"tablet {label} {fmt} page {j}: bytes differ from the "
                  "oracle's")
        out[f"{fmt}_batch_ms"] = ms
    out["pages"] = len(specs)
    out["rows_per_page"] = statistics.mean(len(w[0]) for w in wants)
    return out


def tablet_points(tablet, oracle, keys, label: str, extra=()) -> dict:
    """``current_row_values`` of ``keys``, each held against the oracle;
    the mean ms a read."""
    t0 = time.perf_counter()
    for k in keys:
        got = tablet.current_row_values(k)
        want = oracle.point(k, extra)
        check(got == want, f"tablet {label}: current_row_values "
                           f"{got} != {want}")
    ms = (time.perf_counter() - t0) * 1e3
    return {"reads": len(keys), "ms_each": ms / len(keys)}


def tablet_phase(device, bw: float, rate: float, ready=None) -> tuple:
    """The port's ``Tablet`` on the ``gpu`` engine at TABLET_KEYS keys of
    the bench table, in a data directory on the host's disk (fsync on,
    the default plane encoding): bulk writes through the WAL, the device
    flush with its run saved, unflushed updates, close, reopen (the run
    loaded from disk, the WAL replayed), reads against an exact oracle,
    ALTER ADD COLUMN, a snapshot around deletes and its restore, and
    compaction (K11). Every kernel launch of the phase is counted (zeroed
    just before, read just after) and held against the plain versions
    (K12 by the WriteLog, K7 and K9 by a LaunchLog). ``ready()``, when
    given, is called before the first kernel is needed (the whole smoke
    builds the kernels meanwhile). Returns the phase's line and its
    table (schema, rows, updates, oracle), which the raft phase reuses."""
    import shutil
    import tempfile

    import torch

    from yugabyte_db_tpu_torch import workload
    from yugabyte_db_tpu_torch.models.datatypes import DataType
    from yugabyte_db_tpu_torch.storage import gpu_engine
    from yugabyte_db_tpu_torch.storage.residency import hbm_cache
    from yugabyte_db_tpu_torch.storage.row_version import RowVersion
    from yugabyte_db_tpu_torch.tablet import Tablet, TabletMetadata

    parts: dict = {}
    steps: dict = {}  # wall seconds of each step, in order
    mark = [time.perf_counter()]

    def step(name):
        now = time.perf_counter()
        steps[name] = now - mark[0]
        mark[0] = now

    card = nvidia_smi()
    schema = workload.make_schema()
    rows, max_ht = bench_rows(schema, TABLET_KEYS)
    updates, _ = workload.make_update_rows(schema, rows, max_ht,
                                           TABLET_UPDATES)
    root = tempfile.mkdtemp(prefix="tablet-")
    step("generate")
    opts = {"rows_per_block": 2048, "device": device}
    wlog = write_log()
    wlog.verify_flushes()  # an earlier phase's records are not ours
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    cache = hbm_cache()
    try:
        with LaunchLog() as rlog:
            meta = TabletMetadata("bench-0001", "bench", schema, 0, 65536,
                                  engine="gpu")
            tablet = Tablet.create(meta, root, engine_options=opts)
            stamped: list = []
            s = tablet_write(tablet, rows, TABLET_BATCH, stamped)
            parts["write"] = {"rows": len(rows), "batches": len(rows)
                              // TABLET_BATCH, "s": s,
                              "rows_per_s": len(rows) / s}
            step("write")
            eng = tablet.engine
            if ready is not None:
                ready()
            step("build_wait")
            t0 = time.perf_counter()
            tablet.flush()
            parts["flush"] = {"ms": (time.perf_counter() - t0) * 1e3,
                              **{k[:-2] + "_ms": v * 1e3 for k, v in
                                 eng.last_flush.items() if k.endswith("_s")}}
            check(eng.flush_paths == {"device": 1, "host": 0},
                  "the tablet's flush took the host route")
            check(len(eng.persist.files) == 1
                  and tablet.meta.flushed_op_index == len(rows)
                  // TABLET_BATCH, "the flush saved no run or frontier")
            step("flush")
            ups: list = []
            s = tablet_write(tablet, updates, TABLET_UPDATE_BATCH, ups)
            parts["updates"] = {"rows": len(updates), "s": s,
                                "rows_per_s": len(updates) / s}
            step("updates")
            # close(): the device bytes go, and the cache forgets the runs.
            keys = [t._res_key for t in eng.runs]
            charged = eng.device_tracker.consumption
            resident0 = cache.resident_bytes()
            t0 = time.perf_counter()
            tablet.close()
            parts["close_ms"] = (time.perf_counter() - t0) * 1e3
            check(charged > 0 and cache.resident_bytes() == resident0
                  - charged and eng.stats()["device_bytes"] == 0
                  and not any(k in cache._entries for k in keys),
                  f"close() left device bytes: {charged} charged, "
                  f"{resident0 - cache.resident_bytes()} released")
            del eng
            t0 = time.perf_counter()
            tablet = Tablet.open("bench-0001", root, engine_options=opts)
            wall = time.perf_counter() - t0
            eng = tablet.engine
            n_entries = -(-TABLET_UPDATES // TABLET_UPDATE_BATCH)
            parts["reopen"] = {"ms": wall * 1e3,
                               "load_ms": eng.last_load["load_s"] * 1e3,
                               "build_ms": eng.last_load["build_s"] * 1e3,
                               "replayed_entries":
                               tablet._replayed_on_bootstrap}
            check(tablet._replayed_on_bootstrap == n_entries
                  and eng.memtable.num_versions == TABLET_UPDATES
                  and eng.stats()["num_runs"] == 1,
                  f"the reopen replayed {tablet._replayed_on_bootstrap} "
                  f"entries, {eng.memtable.num_versions} versions")
            step("close_reopen")
            # Reads against the exact oracle, none re-served.
            t0 = time.perf_counter()
            oracle = TabletOracle(schema, stamped, ups)
            before = oracle.headline()
            parts["oracle_s"] = time.perf_counter() - t0
            step("oracle")
            parts["headline"] = tablet_headline(tablet, before, "reopened")
            parts["pages"] = tablet_pages(tablet, oracle, "reopened", 31)
            # Held against the plain versions: the launches of this one
            # batch of pages (K9) and of the restored table's (K7).
            rlog.record = False
            rng = random.Random(37)
            point_keys = [rows[rng.randrange(len(rows))].key
                          for _ in range(TABLET_POINTS // 2)] + [
                u.key for u in rng.sample(updates, TABLET_POINTS // 2)]
            parts["points"] = tablet_points(tablet, oracle, point_keys,
                                            "reopened")
            step("reads")
            # ALTER: the runs' payloads go, the re-upload is a counted miss.
            new_schema = schema.with_added_column("e", DataType.INT64)
            t0 = time.perf_counter()
            tablet.alter_schema(new_schema)
            parts["alter_ms"] = (time.perf_counter() - t0) * 1e3
            check(all(cache._entries[t._res_key].payload is None
                      for t in eng.runs), "ALTER left a run's payload")
            misses = cache.stats()["misses"]
            parts["alter_headline"] = tablet_headline(tablet, before,
                                                      "altered")
            parts["alter_pages"] = tablet_pages(tablet, oracle, "altered",
                                                41, extra=("e",))
            check(cache.stats()["misses"] >= misses + len(eng.runs),
                  "the re-upload after ALTER was not a counted miss")
            step("alter")
            # A snapshot, deletes, and the restore.
            tablet.snapshot_op("create_snapshot", "s1")
            victims = [rows[i] for i in random.Random(43).sample(
                range(len(rows)), TABLET_DELETES)]
            tablet_write(tablet, [RowVersion(r.key, ht=0, tombstone=True)
                                  for r in victims], TABLET_DELETES, [])
            deleted = oracle.headline({r.key for r in victims})
            parts["deleted_headline"] = tablet_headline(tablet, deleted,
                                                        "deleted")
            for r in victims[:100]:
                check(tablet.current_row_values(r.key) is None,
                      "a deleted row still reads")
            step("snapshot_deletes")
            t0 = time.perf_counter()
            tablet.snapshot_op("restore_snapshot", "s1")
            parts["restore_ms"] = (time.perf_counter() - t0) * 1e3
            step("restore")
            parts["restored_headline"] = tablet_headline(tablet, before,
                                                         "restored")
            rlog.record = True
            parts["restored_pages"] = tablet_pages(tablet, oracle,
                                                   "restored", 47,
                                                   extra=("e",))
            rlog.record = False
            tablet_points(tablet, oracle, [r.key for r in victims[:100]],
                          "restored", extra=("e",))
            step("restored_reads")
            # Compaction: K11 over the run (the union of ~1.02M rows is
            # under the engine's numpy-twin crossover, HOST_GC_MASK_MAX,
            # which the phase lowers so that the mask is K11's).
            mask_max = gpu_engine.HOST_GC_MASK_MAX
            gpu_engine.HOST_GC_MASK_MAX = 0
            t0 = time.perf_counter()
            try:
                tablet.compact(tablet.read_time().value)
            finally:
                gpu_engine.HOST_GC_MASK_MAX = mask_max
            parts["compact"] = {"ms": (time.perf_counter() - t0) * 1e3,
                                **{k[:-2] + "_ms": v * 1e3 for k, v in
                                   eng.last_compact.items()
                                   if k.endswith("_s")}}
            check(eng.compact_paths["k11"] == 1,
                  f"the tablet's compaction took {eng.compact_paths}")
            parts["compacted_headline"] = tablet_headline(tablet, before,
                                                          "compacted")
            step("compact")
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in counters.items()}
        for fn in counters.values():  # the later phases count their own
            fn.launches = 0
        parts["held"] = {"replay_flush": wlog.verify_flushes(),
                         **rlog.verify()}
        tablet.close()
        step("hold_close")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    TABLET_LAUNCHES.update(launches)
    for name in ("flat_agg", "mvcc_resolve", "row_gather", "scan_window",
                 "replay_flush", "gc_mask", "decode"):
        check(launches[name] > 0,
              f"the tablet phase launched {name} 0 times")
    check(eng.stats()["host_reserves"] == 0, "a tablet batch was re-served")
    parts["launches"] = launches
    parts["steps_s"] = steps
    parts["card"] = card
    print("tablet " + json.dumps(parts))
    return parts, SimpleNamespace(schema=schema, rows=rows, updates=updates,
                                  oracle=oracle)


# -- the raft phase: a three-replica Raft group of TabletPeers on gpu ---------

RAFT_NODES = ("node-0", "node-1", "node-2")
RAFT_FAILOVER_KEYS = 1_000    # keys written through the new leader, unflushed
RAFT_WAIT_S = 60.0            # the longest wait for a leader, lease or apply


def wait_until(pred, what: str, timeout: float = RAFT_WAIT_S):
    """Poll ``pred`` until it returns something true: that value."""
    t_end = time.monotonic() + timeout
    while True:
        v = pred()
        if v:
            return v
        check(time.monotonic() < t_end, f"raft: timed out waiting for {what}")
        time.sleep(0.005)


class RaftGroup:
    """Three ``TabletPeer``s of the bench table over the port's
    ``LocalTransport``, each its own ``gpu`` engine on ``device`` in a
    data directory under ``root`` (fsync on), with the default
    ``RaftOptions``. Writes and reads go through the leader and retry a
    ``NotLeader`` as a client does; ``retries`` counts them."""

    def __init__(self, schema, root: str, opts: dict):
        import os

        from yugabyte_db_tpu_torch.consensus import LocalTransport
        from yugabyte_db_tpu_torch.tablet import TabletMetadata, TabletPeer

        self.transport = LocalTransport()
        self.peers = {}
        self.retries = 0
        for uuid in RAFT_NODES:
            meta = TabletMetadata("bench-raft", "bench", schema, 0, 65536,
                                  engine="gpu")
            peer = TabletPeer(uuid, meta, os.path.join(root, uuid),
                              self.transport.bind(uuid), list(RAFT_NODES),
                              engine_options=opts, fsync=True)
            self.transport.register(
                uuid, lambda m, p, _pr=peer: _pr.raft.handle(m, p))
            self.peers[uuid] = peer
        for peer in self.peers.values():
            peer.start()

    def leader(self, exclude=None):
        """The peer that leads with a lease and has applied its own
        term's no_op (it takes writes)."""
        def ready():
            return next((p for u, p in self.peers.items() if u != exclude
                         and p.raft.is_leader() and p.raft.has_lease()
                         and p.raft.leader_ready()), None)
        return wait_until(ready, "a leader with a lease")

    def write(self, rows, exclude=None):
        """One write through the leader: its hybrid time."""
        from yugabyte_db_tpu_torch.consensus import NotLeader

        while True:
            leader = self.leader(exclude)
            try:
                return leader.write(rows, timeout=RAFT_WAIT_S)
            except NotLeader:
                self.retries += 1

    def on_leader(self, fn, exclude=None):
        """``fn(leader)`` for a read that needs the lease, retried on
        ``NotLeader``."""
        from yugabyte_db_tpu_torch.consensus import NotLeader

        while True:
            leader = self.leader(exclude)
            try:
                return fn(leader)
            except NotLeader:
                self.retries += 1

    def caught_up(self, peer, leader) -> float:
        """Seconds until ``peer`` has applied the leader's commit index."""
        t0 = time.perf_counter()
        target = leader.raft.stats()["commit_index"]
        wait_until(lambda: peer.raft.stats()["applied_index"] >= target,
                   f"{peer.node_uuid} to apply index {target}")
        return time.perf_counter() - t0

    def terms(self) -> dict:
        return {u: p.raft.stats()["term"] for u, p in self.peers.items()}

    def shutdown(self):
        for p in self.peers.values():
            p.shutdown()


class GcPauses:
    """The cyclic GC's full (generation 2) collections while the context
    is open, through ``gc.callbacks``: each holds the interpreter lock,
    so every Raft thread of the process waits it out."""

    def __enter__(self):
        import gc

        self.pauses, self._t0 = [], None
        gc.callbacks.append(self._cb)
        return self

    def _cb(self, phase, info):
        if info.get("generation") != 2:
            return
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.pauses.append((time.perf_counter() - self._t0) * 1e3)
            self._t0 = None

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self._cb)

    def summary(self) -> dict:
        p = self.pauses
        return {"full_collections": len(p), "max_ms": max(p, default=0.0),
                "total_ms": sum(p)}


def peer_reader(peer, stale: bool):
    """``peer`` shaped as the tablet the tablet phase's readers take: its
    scans through ``TabletPeer`` (the lease gate, or a stale follower
    read)."""
    return SimpleNamespace(
        read_time=peer.read_time, engine=peer.tablet.engine,
        meta=peer.tablet.meta,
        scan_many=lambda specs: peer.scan_many(specs, allow_stale=stale),
        scan_wire_many=lambda specs, fmt: peer.scan_wire_many(
            specs, fmt, allow_stale=stale))


def stamped_oracle(schema, rows, updates) -> "TabletOracle":
    """The oracle of ``rows`` written TABLET_BATCH a write, then
    ``updates`` TABLET_UPDATE_BATCH a write, each write stamped by
    ``stamped_batch`` at its own hybrid time after every generated one:
    what the leader stamps, up to the times' values (the oracle reads
    after every version, and a generated expiry precedes every stamp)."""
    ht = int(time.time() * 1e6) << 12
    stamped, ups = [], []
    for out, src, n in ((stamped, rows, TABLET_BATCH),
                        (ups, updates, TABLET_UPDATE_BATCH)):
        for i in range(0, len(src), n):
            ht += 1 << 12
            out.extend(stamped_batch(src[i:i + n], ht))
    return TabletOracle(schema, stamped, ups)


def failover_rows(schema, rows, oracle, seed: int = 59) -> tuple:
    """RAFT_FAILOVER_KEYS whole-row writes to existing keys of ``rows``
    (new a, c and d), and ``oracle`` with them applied (a copy)."""
    import copy

    from yugabyte_db_tpu_torch.storage.row_version import RowVersion

    rng = random.Random(seed)
    cid = oracle.cid
    picks = rng.sample(range(len(rows)), RAFT_FAILOVER_KEYS)
    writes = [RowVersion(rows[i].key, ht=0, liveness=True, columns={
        cid["a"]: rng.randrange(-10**12, 10**12),
        cid["c"]: rng.uniform(-1e6, 1e6),
        cid["d"]: rng.randrange(-1_000_000, 1_000_000)}) for i in picks]
    after = copy.copy(oracle)
    after.exists = oracle.exists.copy()
    after.vals = {n: list(v) for n, v in oracle.vals.items()}
    for w in writes:
        i = oracle.pos[w.key]
        after.exists[i] = True
        for name in ("a", "c", "d"):
            after.vals[name][i] = w.columns[cid[name]]
    d = after.vals["d"]
    after.match = np.nonzero(after.exists & np.fromiter(
        (v is not None and v >= -500_000 for v in d), bool, len(d)))[0]
    return writes, after


def raft_phase(device, bw: float, rate: float, table=None) -> dict:
    """A three-replica Raft group (``RaftGroup``) of the port's
    ``TabletPeer``s on the ``gpu`` engine on ``table``, the tablet
    phase's schema, rows, updates and oracle (made here, the oracle by
    ``stamped_oracle``, when it is None: the phase alone): an election
    with a lease, the writes of 10,000 rows (TABLET_BATCH) and the
    zipfian updates (100 a write) through the leader, each replica's
    flush (the device route, its run saved), the headline batch
    and YCSB-E pages on the leader (lease) and the headline batch on each
    follower (stale, once it applied the leader's commit index), the
    leader isolated (the time to a new lease), 1,000 unflushed writes
    through the new leader and its reads (the overlay), the heal (the old
    leader's catch-up and its stale read), and ``snapshot_for_bootstrap``
    on the leader restored into a fresh engine. Every answer equals the
    exact oracle; every kernel launch is counted (zeroed just before, read
    just after) and K12, K7 and K9 are held against their plain versions
    (the WriteLog, a LaunchLog)."""
    import gc
    import shutil
    import tempfile

    import torch

    from yugabyte_db_tpu_torch import workload
    from yugabyte_db_tpu_torch.storage.engine import make_engine

    parts: dict = {}
    steps: dict = {}
    mark = [time.perf_counter()]

    def step(name):
        now = time.perf_counter()
        steps[name] = now - mark[0]
        mark[0] = now
        if group is not None:
            terms_at[name] = max(group.terms().values())
        print(f"raft step {name}: {steps[name]:.1f} s, terms "
              f"{terms_at.get(name)}, gc {gcp.summary()}", flush=True)

    terms_at: dict = {}  # the highest term after each step
    group = None
    gc.collect()  # an earlier phase's garbage, not frozen below
    gcp = GcPauses().__enter__()
    card = nvidia_smi()
    if table is not None:
        schema, rows, updates, oracle = (
            table.schema, table.rows, table.updates, table.oracle)
    else:
        schema = workload.make_schema()
        rows, max_ht = bench_rows(schema, TABLET_KEYS)
        updates, _ = workload.make_update_rows(schema, rows, max_ht,
                                               TABLET_UPDATES)
        oracle = stamped_oracle(schema, rows, updates)
    writes, after = failover_rows(schema, rows, oracle)
    # The client's rows and the oracle stand for another process: out of
    # the cyclic GC's full collections, which stop every Raft thread.
    gc.freeze()
    root = tempfile.mkdtemp(prefix="raft-")
    step("setup")
    opts = {"rows_per_block": 2048, "device": device}
    wlog = write_log()
    wlog.verify_flushes()  # an earlier phase's records are not ours
    reserves0 = _HOST_RESERVES[0]
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    try:
        with LaunchLog() as rlog:
            t0 = time.perf_counter()
            group = RaftGroup(schema, root, opts)
            leader = group.leader()
            parts["election_ms"] = (time.perf_counter() - t0) * 1e3
            terms0 = group.terms()
            step("elect")
            # Writes of 10,000 rows, then the updates, 100 a write.
            t0 = time.perf_counter()
            for i in range(0, len(rows), TABLET_BATCH):
                group.write(rows[i:i + TABLET_BATCH])
            s = time.perf_counter() - t0
            parts["write"] = {"rows": len(rows), "batches": -(-len(rows)
                              // TABLET_BATCH), "s": s,
                              "rows_per_s": len(rows) / s}
            step("write")
            lat = []
            t0 = time.perf_counter()
            for i in range(0, len(updates), TABLET_UPDATE_BATCH):
                t1 = time.perf_counter()
                group.write(updates[i:i + TABLET_UPDATE_BATCH])
                lat.append((time.perf_counter() - t1) * 1e3)
            s = time.perf_counter() - t0
            q = statistics.quantiles(lat, n=100)
            parts["updates"] = {"rows": len(updates), "writes": len(lat),
                                "s": s, "rows_per_s": len(updates) / s,
                                "commit_p50_ms": statistics.median(lat),
                                "commit_p99_ms": q[98],
                                "commit_max_ms": max(lat)}
            step("updates")
            # Each replica flushes (the leader's apply is drained first).
            parts["flush"] = {}
            for uuid, peer in group.peers.items():
                eng = peer.tablet.engine
                t0 = time.perf_counter()
                peer.flush()
                parts["flush"][uuid] = {
                    "ms": (time.perf_counter() - t0) * 1e3,
                    **{k[:-2] + "_ms": v * 1e3 for k, v in
                       eng.last_flush.items() if k.endswith("_s")}}
                check(eng.flush_paths == {"device": 1, "host": 0},
                      f"raft: {uuid}'s flush took {eng.flush_paths}")
                check(len(eng.persist.files) == 1
                      and eng.stats()["num_runs"] == 1
                      and eng.memtable.num_versions == 0,
                      f"raft: {uuid}'s flush saved no run file")
            parts["flush_held"] = wlog.verify_flushes()
            step("flush")
            # Reads: the leader under its lease, each follower stale.
            headline = oracle.headline()
            parts["leader_headline"] = group.on_leader(
                lambda p: tablet_headline(peer_reader(p, False), headline,
                                          "raft leader"))
            parts["leader_pages"] = group.on_leader(
                lambda p: tablet_pages(peer_reader(p, False), oracle,
                                       "raft leader", 31))
            rlog.record = False
            leader = group.leader()
            parts["followers"] = {}
            for uuid, peer in group.peers.items():
                if peer is leader:
                    continue
                wait_s = group.caught_up(peer, leader)
                got = tablet_headline(peer_reader(peer, True), headline,
                                      f"raft follower {uuid}")
                parts["followers"][uuid] = {"apply_wait_ms": wait_s * 1e3,
                                            **got}
            step("reads")
            # Failover: the leader isolated, a new lease, writes and reads
            # through the new leader (the unflushed writes: the overlay).
            old = leader
            terms1 = group.terms()
            t0 = time.perf_counter()
            group.transport.isolate(old.node_uuid)
            new = group.leader(exclude=old.node_uuid)
            parts["failover_ms"] = (time.perf_counter() - t0) * 1e3
            terms2 = group.terms()
            t0 = time.perf_counter()
            for i in range(0, len(writes), TABLET_UPDATE_BATCH):
                group.write(writes[i:i + TABLET_UPDATE_BATCH],
                            exclude=old.node_uuid)
            parts["failover_writes_s"] = time.perf_counter() - t0
            moved = after.headline()
            parts["failover_headline"] = group.on_leader(
                lambda p: tablet_headline(peer_reader(p, False), moved,
                                          "raft new leader"),
                exclude=old.node_uuid)
            rlog.record = True
            parts["failover_pages"] = group.on_leader(
                lambda p: tablet_pages(peer_reader(p, False), after,
                                       "raft new leader", 47),
                exclude=old.node_uuid)
            rlog.record = False
            check(new.tablet.engine.memtable.num_versions
                  >= RAFT_FAILOVER_KEYS,
                  "raft: the failover writes are not in the new leader's "
                  "memtable")
            step("failover")
            t0 = time.perf_counter()
            group.transport.heal(old.node_uuid)
            wait_until(lambda: not old.raft.is_leader(),
                       "the old leader to step down")
            leader = group.leader()
            group.caught_up(old, leader)
            parts["catch_up_ms"] = (time.perf_counter() - t0) * 1e3
            parts["old_leader_headline"] = tablet_headline(
                peer_reader(old, True), moved, "raft old leader")
            terms3 = group.terms()
            step("heal")
            # The remote-bootstrap payload, restored into a fresh engine.
            leader = group.leader()
            t0 = time.perf_counter()
            snap = leader.snapshot_for_bootstrap()
            parts["bootstrap_snapshot_ms"] = (time.perf_counter() - t0) * 1e3
            check(leader.tablet.engine.flush_paths["host"] == 0,
                  "raft: the bootstrap snapshot's flush took the host route")
            check(len(snap["entries"]) == len(rows)
                  and snap["tail"]["term"] == leader.raft.stats()["term"],
                  f"raft: the bootstrap payload holds "
                  f"{len(snap['entries'])} keys")
            t0 = time.perf_counter()
            fresh = make_engine("gpu", schema, opts)
            fresh.restore_entries(snap["entries"])
            parts["bootstrap_restore_ms"] = (time.perf_counter() - t0) * 1e3
            del snap
            parts["bootstrap_headline"] = tablet_headline(
                SimpleNamespace(read_time=leader.read_time, engine=fresh,
                                scan_many=fresh.scan_batch), moved,
                "raft bootstrap restore")
            fresh.close()
            parts["bootstrap_held"] = wlog.verify_flushes()
            step("bootstrap")
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in counters.items()}
        for fn in counters.values():  # the later phases count their own
            fn.launches = 0
        parts["held"] = rlog.verify()
        reserves = sum(p.tablet.engine.stats()["host_reserves"]
                       for p in group.peers.values())
        check_no_fault("raft", reserves0)
        step("hold")
    finally:
        gcp.__exit__()
        gc.unfreeze()
        if group is not None:
            group.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    for name in ("flat_agg", "mvcc_resolve", "row_gather", "scan_window",
                 "replay_flush", "decode"):
        check(launches[name] > 0, f"the raft phase launched {name} 0 times")
    check(reserves == 0, "a raft batch was re-served from the host")
    # Elections: the first, the deliberate one after the isolation, and
    # any other (reported by step, not hidden).
    grew, prev = {}, terms_at["elect"]
    for name, term in terms_at.items():
        grew[name], prev = term - prev, term
    grew["failover"] -= 1  # the deliberate one
    check(terms2[new.node_uuid] > terms1[old.node_uuid],
          "raft: no new term after the leader was isolated")
    parts["terms"] = {"elected": terms0, "before_isolation": terms1,
                      "after_failover": terms2, "after_heal": terms3}
    parts["elections_besides_the_deliberate"] = {
        "total": sum(grew.values()),
        "by_step": {k: v for k, v in grew.items() if v}}
    parts["terms_after_step"] = terms_at
    parts["gc"] = gcp.summary()
    parts["not_leader_retries"] = group.retries
    parts["launches"] = launches
    parts["steps_s"] = steps
    parts["card"] = card
    print("raft " + json.dumps(parts))
    return parts


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
    rate = int32_ops_per_s()
    print(f"bounds: {bw} bytes/s, {rate} int32 operations/s "
          f"(64 lanes x SMs x clocks.max.sm "
          f"{nvidia_smi('clocks.max.sm')})")
    t_start = t0 = time.perf_counter()
    walls = {}  # seconds of each phase
    built: list = []  # the build's error, if any, then True once printed

    def build_kernels():
        try:
            native.build(KERNELS)
        except BaseException as e:  # noqa: BLE001 — raised by kernels_built
            built.append(e)
        walls["build"] = time.perf_counter() - t0

    # The whole smoke builds the kernels (one nvcc a source, all started
    # together) while the tablet phase does its first host work; every
    # other mode waits for the build first.
    build_thread = threading.Thread(target=build_kernels)
    build_thread.start()

    def kernels_built():
        """Wait for the build, raise its error, print its ptxas lines."""
        build_thread.join()
        if built and built[0] is True:
            return
        if built:
            raise built[0]
        built.append(True)
        print(f"build: {', '.join(KERNELS)} in {walls['build']:.1f} s")
        for name in KERNELS:
            for line in native.build_logs.get(name, "").splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas: {name}: {line.strip()}")

    if len(sys.argv) == 2 and sys.argv[1] == "--run-io":
        build_thread.join()
        run_io_speed()
        return 0
    if len(sys.argv) > 1:
        kernels_built()

    if len(sys.argv) == 3 and sys.argv[1] == "--resolve-ab":
        resolve_ab(device, bw, sys.argv[2].split(","))
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--group-enc-ab":
        group_enc_ab(device, bw, rate, sys.argv[2].split(","))
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--decode-ab":
        decode_ab(device, bw, sys.argv[2].split(","))
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--rows-ab":
        rows_ab(device, bw, rate, sys.argv[2].split(","))
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--flush-ab":
        flush_ab(device, bw, rate, sys.argv[2].split(","))
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--compact-ab":
        compact_ab(device, bw, rate, sys.argv[2].split(","))
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--full-ab":
        full_ab(device, bw, rate, sys.argv[2].split(","))
        return 0
    if len(sys.argv) == 2 and sys.argv[1] == "--rows":
        rows_alone(device, bw, rate)
        return 0
    if len(sys.argv) == 2 and sys.argv[1] == "--compact":
        compact_alone(device, bw, rate)
        return 0
    if len(sys.argv) == 2 and sys.argv[1] == "--full":
        full_alone(device, bw, rate)
        return 0
    if len(sys.argv) == 2 and sys.argv[1] == "--encoded":
        encoded_alone(device, bw, rate)
        return 0
    configure_breakers()
    watch_host_reserves()
    if len(sys.argv) == 2 and sys.argv[1] == "--residency":
        residency_alone(device, bw, rate)
        return 0
    if len(sys.argv) == 2 and sys.argv[1] == "--tablet":
        tablet_phase(device, bw, rate)
        return 0
    if len(sys.argv) == 2 and sys.argv[1] == "--raft":
        raft_phase(device, bw, rate)
        return 0

    def timed(name, phase, *args):
        reserves0 = _HOST_RESERVES[0]
        t = time.perf_counter()
        result = phase(device, bw, rate, *args)
        walls[name] = time.perf_counter() - t
        print(f"phase {name}: {walls[name]:.1f} s", flush=True)
        if name != "residency":
            check_no_fault(name, reserves0)
        return result

    tab, table = timed("tablet", tablet_phase, kernels_built)
    kernels_built()
    raft = timed("raft", raft_phase, table)
    del table

    kernel_err = timed("kernel", kernel_phase)
    eng, flat = timed("engine", engine_phase)
    mv, mvcc = timed("mvcc", mvcc_phase)
    rows = timed("rows", rows_phase, flat, mvcc)
    ov = timed("overlay", overlay_phase, flat, mvcc)
    sources = timed("rows_sources", rows_sources_phase, flat, mvcc)
    comp = timed("compact", compact_phase, flat)
    full = timed("full", full_phase, mvcc)
    ENCODED["mvcc"] = timed("encoded_mvcc",
                            lambda d, _b, _r: encoded_mvcc(mvcc, d))
    timed("residency", residency_phase, SimpleNamespace(
        eng=flat.eng, schema=flat.schema, rows=flat.rows,
        updates=flat.updates5, read=flat.sources_read_ht,
        oracle=flat.oracle5), SimpleNamespace(
        eng=mvcc.eng, reads=(mvcc.wave_newest, mvcc.mid_read),
        oracles={mvcc.wave_newest: mvcc.wave_oracle,
                 mvcc.mid_read: mvcc.oracles[mvcc.mid_read]}))
    del flat, mvcc
    torch.cuda.empty_cache()
    grp = timed("grouped", grouped_phase)
    walls["total"] = time.perf_counter() - t_start
    print("phases_s " + json.dumps(walls))
    # The encoded phase's parts run inside the phases whose tables they
    # reuse (compact, after full, grouped): their seconds.
    print("encoded_s " + json.dumps({k: ENCODED[k]["s"] for k in (
        "compacted", "mvcc", "lineitem")}))
    ovf, ovm = ov["flat"], ov["mvcc"]
    k = eng["kernel"]
    err = max(k["max_abs_err"], kernel_err, mv["kernel"]["max_abs_err"],
              ovf["kernel"]["max_abs_err"], ovm["kernel"]["max_abs_err"])
    res, mid, long = (mv["resolve"][k] for k in ("newest", "mid", "long"))
    res_err = max(r["max_abs_err"] for r in list(mv["resolve"].values())
                  + list(ovm["resolve"].values()))
    overlay_k1 = ovf["launches"] + ovm["launches"]["flat_agg"]
    kernels = [{
        "name": "flat_agg", "route": "cuda",
        "source": "yugabyte_db_tpu_torch/csrc/flat_agg.cu",
        "replaces": "yugabyte_db_tpu/ops/pallas_agg.py:76",
        "launches": eng["launches"] + mv["launches"]["flat_agg"]
        + overlay_k1,
        "launches_by_path": {"engine": eng["launches"],
                             "mvcc": mv["launches"]["flat_agg"],
                             "overlay": overlay_k1},
        "max_abs_err": err,
        "max_abs_diff": err, "ms": k["ms"], "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
        "library_ms": None,
        "overlay_flat_ms": ovf["kernel"]["ms"],
        "overlay_flat_bound_ms": ovf["kernel"]["bound_ms"],
        "overlay_mvcc_ms": ovm["kernel"]["ms"],
        "overlay_mvcc_bound_ms": ovm["kernel"]["bound_ms"]}, {
        "name": "mvcc_resolve", "route": "cuda",
        "source": "yugabyte_db_tpu_torch/csrc/mvcc_resolve.cu",
        "replaces": "yugabyte_db_tpu/ops/seg_fold.py:104, "
                    "yugabyte_db_tpu/ops/lookback_fold.py:87",
        "launches": mv["launches"]["mvcc_resolve"]
        + ovm["launches"]["mvcc_resolve"],
        "launches_by_path": {"mvcc": mv["launches"]["mvcc_resolve"],
                             "overlay": ovm["launches"]["mvcc_resolve"]},
        "max_abs_err": res_err, "max_abs_diff": res_err, "ms": res["ms"],
        "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
        "bound_by": res["bound_by"], "library_ms": None,
        "mid_ms": mid["ms"], "mid_bound_ms": mid["bound_ms"],
        "long_group_ms": long["ms"], "long_group_bound_ms": long["bound_ms"],
        "long_group_plain_ms": long["plain_ms"],
        "overlay_newest_ms": ovm["resolve"]["newest"]["ms"],
        "overlay_newest_bound_ms": ovm["resolve"]["newest"]["bound_ms"],
        "overlay_mid_ms": ovm["resolve"]["mid"]["ms"],
        "overlay_mid_bound_ms": ovm["resolve"]["mid"]["bound_ms"],
        "overlay_long_group_ms": ovm["resolve"]["long"]["ms"],
        "overlay_long_group_bound_ms": ovm["resolve"]["long"]["bound_ms"]},
        group_agg_entry(grp), *row_path_entries(rows, sources),
        *write_entries(eng["k12"], comp), full_entry(full),
        decode_entry()]
    # The tablet and raft phases' launches, each on its own path.
    for entry in kernels:
        for path, counts in (("tablet", tab["launches"]),
                             ("raft", raft["launches"])):
            n = counts.get(entry["name"], 0)
            if n:
                entry["launches"] += n
                entry.setdefault("launches_by_path", {})[path] = n
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
