"""Aggregate accumulators: the packed layout, the windowed fold, and the
host-side finish.

The JAX package's ``ops/agg_fold.py``: the folds return their
accumulators packed as ``(ivec int32, fvec float32)`` in the same layout,
and ``unpack`` / ``merge_accs`` / ``finalize`` turn them into the values a
``ScanResult`` carries.

The windowed full-run aggregate (K5, the JAX ``compiled_full_aggregate``)
is here too: ``full_aggregate_plain`` is its plain version, in the JAX
program's order (per block, then per window, then a fold over the windows
in window order with one ``carry_step`` a window), and
``compiled_full_aggregate`` its entry, which launches the CUDA kernel
``csrc/full_agg.cu`` (``ops.full_agg``) on CUDA tensors. The per-window
partials are few (a handful of numbers a window and aggregate), so the
plain version folds them on the host: digits in Python integers, the
Kahan pair in numpy float32.

Integer sums are exact at any scale: 16-bit-limb partials fold into a
base-2^16 digit vector (``finalize`` recombines the digits in Python ints,
so a digit may exceed 2^16). Min/max fold lexicographically on two int32
planes; float sums fold in f32.

Reference analog: the per-row aggregate accumulation inside the scan loop
(QLReadOperation::EvalAggregate, src/yb/docdb/cql_operation.cc:1212;
PgsqlReadOperation::EvalAggregate, src/yb/docdb/pgsql_operation.cc:473).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from yugabyte_db_tpu_torch.ops import scan as dscan
from yugabyte_db_tpu_torch.utils import planes as PL

DIGITS = 8  # base-2^16 digit vector length for exact integer sums

# Window size for on-device full-run loops: keeps the per-window limb sum
# (<= 65535 * R * K) inside int32.
FULL_WINDOW_BLOCKS = 8

# Headroom for the accumulated carry digits (< ~2^17 after carry_step) on
# top of one window's limb sum.
_LIMB_BUDGET = (1 << 31) - (1 << 18)


def check_limb_bound(R: int, K: int) -> None:
    """Integer-sum safety: one window's 16-bit-limb partial plus carry
    headroom must fit int32."""
    if 65535 * R * K > _LIMB_BUDGET:
        raise ValueError(
            f"rows_per_block={R} x window_blocks={K} overflows the int32 "
            f"limb accumulator (65535*R*K > {_LIMB_BUDGET}); shrink one")


def safe_window_blocks(R: int, max_k: int) -> int:
    """Largest power-of-two window <= max_k that satisfies check_limb_bound."""
    k = max_k
    while k > 1 and 65535 * R * k > _LIMB_BUDGET:
        k //= 2
    check_limb_bound(R, k)
    return k


# -- packing: accumulators <-> two flat vectors (one D2H copy each) ----------

def pack(sig_aggs, acc, scanned):
    """(int32 vector, float32 vector) carrying every accumulator + scanned.
    ``acc`` entries are 0-d tensors (``digits`` a [DIGITS] tensor), all on
    one device."""
    ints, floats = [scanned], []
    for ag, a in zip(sig_aggs, acc):
        if ag.fn == "count":
            ints.append(a["count"])
        elif ag.fn == "sum":
            if ag.kind in ("f32", "f64"):
                floats.extend([a["fsum"], a["fcomp"]])
                ints.append(a["n"])
            else:
                ints.extend([a["digits"][j] for j in range(DIGITS)])
                ints.append(a["n"])
        elif ag.kind == "f32":
            floats.append(a["fext"])
            ints.append(a["n"])
        elif ag.kind == "i32":
            ints.extend([a["ext"], a["n"]])
        else:
            ints.extend([a["ext_hi"], a["ext_lo"], a["n"]])
    device = scanned.device
    ivec = torch.stack([torch.as_tensor(x, device=device).to(torch.int32)
                        for x in ints])
    fvec = (torch.stack([torch.as_tensor(x, device=device)
                         .to(torch.float32) for x in floats])
            if floats else torch.zeros((0,), dtype=torch.float32,
                                       device=device))
    return ivec, fvec


# -- the windowed fold (K5's plain version) ---------------------------------

def carry_step(digits: list) -> list:
    """One base-2^16 carry propagation over a non-negative digit vector
    (Python integers); the last digit's carry drops, as in the JAX
    program (it is zero for any sum of fewer than 2^31 values)."""
    return [digits[0] & 0xFFFF] + [(d & 0xFFFF) + (prev >> 16)
                                   for prev, d in zip(digits, digits[1:])]


def agg_init(sig_aggs) -> list:
    """Host accumulators before the first window (the JAX ``agg_init``):
    Python integers, numpy float32 for the f32 fields."""
    acc = []
    for ag in sig_aggs:
        if ag.fn == "count":
            acc.append({"count": 0})
        elif ag.fn == "sum":
            if ag.kind in ("f32", "f64"):
                # A Kahan-compensated f32 pair, as the JAX program keeps it.
                acc.append({"fsum": np.float32(0), "fcomp": np.float32(0),
                            "n": 0})
            else:
                acc.append({"digits": [0] * DIGITS, "n": 0})
        else:
            is_max = ag.fn == "max"
            fill = int(dscan.I32_MIN if is_max else dscan.I32_MAX)
            if ag.kind == "f32":
                acc.append({"fext": np.float32(-np.inf if is_max else np.inf),
                            "n": 0})
            elif ag.kind == "i32":
                acc.append({"ext": fill, "n": 0})
            else:
                acc.append({"ext_hi": fill, "ext_lo": fill, "n": 0})
    return acc


def agg_fold(sig_aggs, acc, parts: dict) -> list:
    """Fold one window's partials (``window_parts``: host values, the
    block axis already summed) into the accumulators, as the JAX
    ``agg_fold`` does: the window's limb sums into the digits and one
    ``carry_step``; a Kahan add of the window's f32 sum; MIN/MAX by
    lexicographic comparison of the order planes."""
    out = []
    for i, ag in enumerate(sig_aggs):
        a = acc[i]

        def p(name):
            return parts[f"agg{i}_{name}"]

        if ag.fn == "count":
            out.append({"count": a["count"] + p("count")})
            continue
        n = a["n"] + p("n")
        if ag.fn == "sum":
            if ag.kind in ("f32", "f64"):
                y = np.float32(p("fsum")) - a["fcomp"]
                t = a["fsum"] + y
                out.append({"fsum": t, "fcomp": (t - a["fsum"]) - y, "n": n})
            else:
                limbs = p("limbs")
                widened = list(limbs) + [0] * (DIGITS - len(limbs))
                out.append({"digits": carry_step(
                    [d + x for d, x in zip(a["digits"], widened)]), "n": n})
            continue
        pick = max if ag.fn == "max" else min
        if ag.kind == "f32":
            out.append({"fext": pick(a["fext"], np.float32(p("fext"))),
                        "n": n})
        elif ag.kind == "i32":
            out.append({"ext": pick(a["ext"], p("ext")), "n": n})
        else:
            hi, lo = pick((a["ext_hi"], a["ext_lo"]),
                          (p("ext_hi"), p("ext_lo")))
            out.append({"ext_hi": hi, "ext_lo": lo, "n": n})
    return out


# Rows of windows resolved at once by the plain version.
_CHUNK_ROWS = 1 << 22


def window_parts(sig: dscan.ScanSig, run: dict, w_first: int, w_last: int,
                 row_lo: int, row_hi: int, read_planes, pred_lits):
    """Yield each window's partials in window order, for the windows
    [w_first, w_last) of ``run`` (``DeviceRun.arrays``), as host values:
    ``scanned`` (rows that pass every predicate) and the ``agg<i>_*``
    entries of ``scan._eval_agg`` with the block axis summed on the
    device (limb sums exactly, f32 sums in f32). Windows are resolved
    in chunks of about ``_CHUNK_ROWS`` rows with ``scan.resolve_windows``;
    the window-local row bounds are clipped to +-2^30, as the JAX
    ``fold_window`` clips them."""
    device = run["valid"].device
    N = sig.K * sig.R
    step = max(1, _CHUNK_ROWS // N)
    lits = dscan._scalar_lits(sig, pred_lits, device)
    read = torch.tensor([[int(v) for v in read_planes]], dtype=torch.int64,
                        device=device)
    lim = 1 << 30
    for c0 in range(w_first, w_last, step):
        ws = torch.arange(c0, min(w_last, c0 + step), device=device)
        G = ws.shape[0]
        base = ws * N
        r = dscan.resolve_windows(
            sig, run, ws * sig.K, (row_lo - base).clamp(-lim, lim),
            (row_hi - base).clamp(-lim, lim), read.expand(G, 4),
            tuple(x.expand((G,) + tuple(x.shape[1:])) for x in lits))
        block_of_group = r["start_idx"] // sig.R
        vals = {"scanned": r["result"].sum(dim=1)}
        for i, ag in enumerate(sig.aggs):
            parts = dscan._eval_agg(f"agg{i}", ag, r["result"], r["col_idx"],
                                    r["col_notnull"], r["cmp_w"],
                                    r["arith_w"], block_of_group, sig.K)
            for k, v in parts.items():
                vals[k] = v.sum(dim=1) if k.endswith(("_fsum", "_limbs")) \
                    else v
        host = {k: v.tolist() for k, v in vals.items()}
        for g in range(G):
            yield {k: v[g] for k, v in host.items()}


def fold_window(sig: dscan.ScanSig, run: dict, w: int, carry: tuple,
                row_lo: int, row_hi: int, read_planes, pred_lits) -> tuple:
    """Resolve window ``w`` of ``run`` and fold its partials into
    ``carry`` = (accumulators, scanned): the JAX ``fold_window``, on host
    values."""
    acc, scanned = carry
    parts = next(window_parts(sig, run, w, w + 1, row_lo, row_hi,
                              read_planes, pred_lits))
    return agg_fold(sig.aggs, acc, parts), scanned + parts["scanned"]


def window_bounds(row_lo: int, row_hi: int, R: int, K: int, W: int):
    """[w_first, w_last) window indices overlapping row range (host ints)."""
    if row_hi <= row_lo:
        return 0, 0
    w_first = max(0, min(W, (row_lo // R) // K))
    w_last = max(0, min(W, ((row_hi - 1) // R) // K + 1))
    return w_first, w_last


def full_aggregate_plain(sig: dscan.ScanSig, arrays: dict, row_lo: int,
                         row_hi: int, w_first: int, w_last: int, read_hi: int,
                         read_lo: int, rexp_hi: int, rexp_lo: int,
                         lits) -> tuple:
    """K5's plain version: fold the windows [w_first, w_last) of the run
    (``DeviceRun.arrays``) in window order and return ``pack``'s (ivec
    int32, fvec float32) on the run's device. Scalars are host ints and
    ``lits`` host literals (``pred_literal_host``). The ivec equals the
    JAX program's digit for digit: the same window limb sums go through
    the same carry steps."""
    check_limb_bound(sig.R, sig.K)
    acc, scanned = agg_init(sig.aggs), 0
    for parts in window_parts(sig, arrays, w_first, w_last, row_lo, row_hi,
                              (read_hi, read_lo, rexp_hi, rexp_lo), lits):
        acc = agg_fold(sig.aggs, acc, parts)
        scanned += parts["scanned"]
    ivec, fvec = pack(sig.aggs, acc, torch.tensor(scanned))
    device = arrays["valid"].device
    return ivec.to(device), fvec.to(device)


@functools.lru_cache(maxsize=128)
def compiled_full_aggregate(sig: dscan.ScanSig):
    """fn(run, row_lo, row_hi, w_first, w_last, read_hi, read_lo, rexp_hi,
    rexp_lo, pred_lits) -> (ivec, fvec) of one spec, named as in the JAX
    package: K5 over a flat run or view (``ops.full_agg.supports``). On
    CUDA tensors it launches the kernel, on CPU tensors it runs
    ``full_aggregate_plain``; scalars are host ints, ``pred_lits`` host
    literals. Nothing is compiled."""
    from yugabyte_db_tpu_torch.ops import full_agg

    check_limb_bound(sig.R, sig.K)
    plan = full_agg.make_plan(sig.aggs, sig.preds, sig.cols, sig.R, sig.K)

    def fn(run, row_lo, row_hi, w_first, w_last, read_hi, read_lo, rexp_hi,
           rexp_lo, pred_lits):
        params = np.array([plan.param_row(
            row_lo, row_hi, w_first, w_last,
            (read_hi, read_lo, rexp_hi, rexp_lo), pred_lits)], np.int32)
        ivec, fvec = full_agg.full_aggregate(plan, run, params)
        return ivec[0], fvec[0]

    return fn


def unpack(sig_aggs, ivec, fvec):
    """Inverse of pack on host arrays (numpy or CPU tensors) -> (acc dicts of python
    numbers, scanned)."""
    ints = [int(x) for x in np.asarray(ivec)]
    floats = [float(x) for x in np.asarray(fvec)]
    ii, fi = 1, 0
    scanned = ints[0]
    acc = []
    for ag in sig_aggs:
        if ag.fn == "count":
            acc.append({"count": ints[ii]}); ii += 1
        elif ag.fn == "sum":
            if ag.kind in ("f32", "f64"):
                acc.append({"fsum": floats[fi], "fcomp": floats[fi + 1],
                            "n": ints[ii]})
                fi += 2; ii += 1
            else:
                acc.append({"digits": ints[ii:ii + DIGITS],
                            "n": ints[ii + DIGITS]})
                ii += DIGITS + 1
        elif ag.kind == "f32":
            acc.append({"fext": floats[fi], "n": ints[ii]}); fi += 1; ii += 1
        elif ag.kind == "i32":
            acc.append({"ext": ints[ii], "n": ints[ii + 1]}); ii += 2
        else:
            acc.append({"ext_hi": ints[ii], "ext_lo": ints[ii + 1],
                        "n": ints[ii + 2]})
            ii += 3
    return acc, scanned


def merge_accs(ag: dscan.AggSig, a: dict, b: dict) -> dict:
    """Combine two unpacked accumulators over DISJOINT row sets (the
    overlay-scan composition: primary-run partial + dirty-key overlay
    partial). Exact for count/sum (digit adds) and order-correct for
    min/max (lexicographic on ordered planes)."""
    if ag.fn == "count":
        return {"count": a["count"] + b["count"]}
    n = a["n"] + b["n"]
    if ag.fn == "sum":
        if ag.kind in ("f32", "f64"):
            return {"fsum": a["fsum"] + b["fsum"],
                    "fcomp": a["fcomp"] + b["fcomp"], "n": n}
        return {"digits": [int(x) + int(y)
                           for x, y in zip(a["digits"], b["digits"])],
                "n": n}
    if a["n"] == 0:
        return dict(b, n=n)
    if b["n"] == 0:
        return dict(a, n=n)
    pick = max if ag.fn == "max" else min
    if ag.kind == "f32":
        return {"fext": pick(a["fext"], b["fext"]), "n": n}
    if ag.kind == "i32":
        return {"ext": pick(a["ext"], b["ext"]), "n": n}
    best = pick((a["ext_hi"], a["ext_lo"]), (b["ext_hi"], b["ext_lo"]))
    return {"ext_hi": best[0], "ext_lo": best[1], "n": n}


def finalize(ag: dscan.AggSig, a: dict, fn_name: str):
    """Accumulator -> python value (fn_name is the user fn: avg uses a sum
    accumulator)."""
    if fn_name == "count":
        return int(a["count"])
    n = int(a["n"])
    if fn_name in ("sum", "avg"):
        if n == 0:
            return None
        if ag.kind in ("f32", "f64"):
            s = float(a["fsum"]) - float(a["fcomp"])
        else:
            digits = a["digits"]
            total = sum(int(digits[j]) << (16 * j) for j in range(DIGITS))
            bias = (1 << 63) if ag.kind == "i64" else (1 << 31)
            s = total - n * bias
        return s / n if fn_name == "avg" else s
    if n == 0:
        return None
    if ag.kind == "f32":
        return float(a["fext"])
    if ag.kind == "i32":
        return int(a["ext"])
    hi = np.array([int(a["ext_hi"])], dtype=np.int32)
    lo = np.array([int(a["ext_lo"])], dtype=np.int32)
    if ag.kind == "i64":
        return int(PL.ordered_planes_to_i64(hi, lo)[0])
    return float(PL.ordered_planes_to_f64(hi, lo)[0])



# -- AggSpec lowering ---------------------------------------------------------

def lower_aggs(spec_aggs, name_to_id, kinds):
    """ScanSpec aggregates -> (device AggSigs, [(user_fn, index)] lowering).
    avg lowers to a sum accumulator; finalize() divides by n."""
    dev_aggs, lowering = [], []
    for a in spec_aggs:
        cid = name_to_id.get(a.column) if a.column else None
        kind = kinds[cid] if cid is not None else None
        fn = "sum" if a.fn == "avg" else a.fn
        lowering.append((a.fn, len(dev_aggs)))
        dev_aggs.append(dscan.AggSig(fn, cid, kind))
    return tuple(dev_aggs), lowering


def pred_literal_host(kind: str, value):
    """Predicate literal -> host (numpy) device representation. Kept on
    host so batched planners can stack many specs' literals into one
    transfer instead of queueing a tiny H2D copy per predicate."""
    if kind == "i32":
        return np.int32(int(value))
    if kind == "code":
        # Promoted string predicate: the engine already translated the
        # value to an int32 dictionary-code bound.
        return np.int32(int(value))
    if kind == "f32":
        return np.float32(value)
    if kind == "i64":
        hi, lo = PL.i64_to_ordered_planes(np.array([int(value)], dtype=np.int64))
        return np.array([hi[0], lo[0]], dtype=np.int32)
    if kind == "f64":
        hi, lo = PL.f64_to_ordered_planes(np.array([value], dtype=np.float64))
        return np.array([hi[0], lo[0]], dtype=np.int32)
    raw = (value.encode("utf-8", "surrogateescape")
           if isinstance(value, str) else bytes(value))
    hi, lo = PL.varlen_prefix_planes([raw])
    return np.array([hi[0], lo[0]], dtype=np.int32)
