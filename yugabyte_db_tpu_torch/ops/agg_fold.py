"""Aggregate accumulators: the packed layout and the host-side finish.

The host pieces of the JAX package's ``ops/agg_fold.py``: the folds return
their accumulators packed as ``(ivec int32, fvec float32)`` in the same
layout, and ``unpack`` / ``merge_accs`` / ``finalize`` turn them into the
values a ``ScanResult`` carries.

Integer sums are exact at any scale: 16-bit-limb partials fold into a
base-2^16 digit vector (``finalize`` recombines the digits in Python ints,
so a digit may exceed 2^16). Min/max fold lexicographically on two int32
planes; float sums fold in f32.

Reference analog: the per-row aggregate accumulation inside the scan loop
(QLReadOperation::EvalAggregate, src/yb/docdb/cql_operation.cc:1212;
PgsqlReadOperation::EvalAggregate, src/yb/docdb/pgsql_operation.cc:473).
"""

from __future__ import annotations

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
