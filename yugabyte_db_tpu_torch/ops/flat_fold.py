"""Full-run aggregate over a FLAT run in plain PyTorch.

Counterpart of the JAX package's ``ops/flat_fold.py`` (an XLA program
there, not a Pallas kernel). A flat run (one version per key) needs no
cross-row state, so resolve + predicates + aggregates evaluate as
elementwise masks and reductions over the whole [B, R] planes. The engine
routes here the flat-run signatures the CUDA kernel (``ops.flat_agg``)
does not take: f64 predicates, f32/f64 sums and MIN/MAX on the ``arith``
plane, COUNT over f32 order planes.

Exact integer sums follow the JAX program digit for digit, so ``ivec``
matches it exactly: every 32-bit plane splits into two 16-bit limbs,
summed per block, and the per-block sums are split again into 16-bit
halves summed over the blocks. Float sums are f32 over the ``arith``
plane, per block then across blocks, in torch's summation order.
Returns ``agg_fold.pack``'s (ivec, fvec) layout.
"""

from __future__ import annotations

import functools

import torch

from yugabyte_db_tpu_torch.ops import agg_fold
from yugabyte_db_tpu_torch.ops import scan as dscan
from yugabyte_db_tpu_torch.ops.encodings import require_plain
from yugabyte_db_tpu_torch.ops.scan import I32_MAX, I32_MIN, le2

MAX_R = (1 << 15) - 1   # the JAX program's int32 block limb-sum bound
MAX_B = 1 << 14         # and its second-stage bound


def supports(sig: dscan.ScanSig) -> bool:
    """Eligibility: flat run within the JAX program's shape bounds, exact
    predicate kinds only (dictionary-code predicates among them)."""
    if not sig.flat or sig.R > MAX_R or sig.B > MAX_B:
        return False
    if any(ps.kind not in ("i32", "i64", "f64", "code")
           for ps in sig.preds):
        return False
    return all(ag.fn in ("count", "sum", "min", "max") for ag in sig.aggs)


def _limb_scalars(masked_u16, pos, digits):
    """Add the exact sum of a [B, R] array of values in [0, 0xFFFF] into
    digits ``pos`` and ``pos + 1``: per-block sums, then their 16-bit
    halves summed over the blocks."""
    s1 = masked_u16.sum(dim=1)
    digits[pos] = digits[pos] + (s1 & 0xFFFF).sum()
    digits[pos + 1] = digits[pos + 1] + (s1 >> 16).sum()


def _masked_plane_limbs(plane, m, digits, base_pos):
    """Add a 2^31-biased plane's masked exact sum into the digits."""
    u = plane.long() + (1 << 31)
    _limb_scalars(torch.where(m, u & 0xFFFF, 0), base_pos, digits)
    _limb_scalars(torch.where(m, u >> 16, 0), base_pos + 1, digits)


def _eval_pred_flat(ps: dscan.PredSig, col: dict, lit):
    """Elementwise exact predicate over a column's full planes (i32 / i64 /
    f64, or a promoted string predicate on its code plane)."""
    cmp = col["cmp"]
    if ps.kind in ("i32", "code"):
        v = col["code"] if ps.kind == "code" else cmp[..., 0]
        x = int(lit)
        return {"=": v == x, "!=": v != x, "<": v < x, "<=": v <= x,
                ">": v > x, ">=": v >= x}[ps.op]
    hi, lo = cmp[..., 0], cmp[..., 1]
    lhi, llo = int(lit[0]), int(lit[1])
    eq = (hi == lhi) & (lo == llo)
    lt = (hi < lhi) | ((hi == lhi) & (lo < llo))
    return {"=": eq, "!=": ~eq, "<": lt, "<=": lt | eq,
            ">": ~(lt | eq), ">=": ~lt}[ps.op]


def compiled_flat_aggregate(sig: dscan.ScanSig):
    """fn(run, row_lo, row_hi, read_hi, read_lo, rexp_hi, rexp_lo,
    pred_lits) -> (ivec, fvec) in agg_fold's packed format, on the run's
    device. ``run`` is ``DeviceRun.arrays``; scalars are host ints and
    ``pred_lits`` host literals (``agg_fold.pred_literal_host``). The name
    is the JAX package's; nothing is compiled."""
    if not supports(sig):
        raise ValueError(f"flat_fold does not take {sig}")
    return functools.partial(_flat_aggregate, sig)


def _flat_aggregate(sig, run, row_lo, row_hi, read_hi, read_lo, rexp_hi,
                    rexp_lo, pred_lits):
    require_plain(run, "the flat fold")
    valid = run["valid"]
    device = valid.device
    visible = valid & le2(run["ht_hi"], run["ht_lo"], read_hi, read_lo)
    expired = le2(run["exp_hi"], run["exp_lo"], rexp_hi, rexp_lo)
    alive = visible & ~run["tomb"]
    not_expired = ~expired
    exists = alive & run["live"] & not_expired
    notnull = {}
    for cs in sig.cols:
        c = run["cols"][cs.col_id]
        nn = alive & c["set"] & ~c["isnull"] & not_expired
        notnull[cs.col_id] = nn
        exists = exists | nn
    B, R = valid.shape
    gidx = torch.arange(B * R, device=device).reshape(B, R)
    result = exists & (gidx >= row_lo) & (gidx < row_hi)
    for i, ps in enumerate(sig.preds):
        c = run["cols"][ps.col_id]
        result = result & notnull[ps.col_id] & _eval_pred_flat(
            ps, c, pred_lits[i])

    # The windowed fold's statistic: result rows.
    scanned = result.sum()
    zero = torch.zeros((), dtype=torch.int64, device=device)
    acc = []
    for ag in sig.aggs:
        if ag.fn == "count":
            m = (result if ag.col_id is None
                 else result & notnull[ag.col_id])
            acc.append({"count": m.sum()})
            continue
        c = run["cols"][ag.col_id]
        m = result & notnull[ag.col_id]
        n = m.sum()
        if ag.fn == "sum":
            if ag.kind in ("f32", "f64"):
                s1 = torch.where(m, c["arith"], 0.0).sum(dim=1)
                acc.append({"fsum": s1.sum(),
                            "fcomp": torch.zeros((), device=device), "n": n})
            else:
                digits = [zero] * agg_fold.DIGITS
                if ag.kind == "i32":
                    _masked_plane_limbs(c["cmp"][..., 0], m, digits, 0)
                else:  # i64: lo plane at digit 0, hi plane at 2
                    _masked_plane_limbs(c["cmp"][..., 1], m, digits, 0)
                    _masked_plane_limbs(c["cmp"][..., 0], m, digits, 2)
                acc.append({"digits": torch.stack(digits), "n": n})
            continue
        is_max = ag.fn == "max"
        if ag.kind == "f32":
            fill = float("-inf") if is_max else float("inf")
            v = torch.where(m, c["arith"], fill)
            acc.append({"fext": v.amax() if is_max else v.amin(), "n": n})
            continue
        fill = int(I32_MIN) if is_max else int(I32_MAX)
        hi = c["cmp"][..., 0]
        ext_hi = _extreme(torch.where(m, hi, fill), is_max)
        if ag.kind == "i32":
            acc.append({"ext": ext_hi, "n": n})
        else:
            lo = torch.where(m & (hi == ext_hi), c["cmp"][..., 1], fill)
            acc.append({"ext_hi": ext_hi, "ext_lo": _extreme(lo, is_max),
                        "n": n})
    return agg_fold.pack(sig.aggs, acc, scanned)


def _extreme(t, is_max: bool):
    return t.amax() if is_max else t.amin()
