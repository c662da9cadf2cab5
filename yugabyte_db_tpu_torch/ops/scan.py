"""Static scan signatures, the two-plane compares, and the window resolve.

The dataclasses carry the same fields as the JAX package's ``ops/scan.py``
so that one signature means the same thing on both sides: a differential
test builds one ``ScanSig`` and hands it to either fold.

``resolve_windows`` is the plain PyTorch version of the JAX package's
``resolve_window`` (MVCC merge-on-read of K-block windows: visibility,
tombstone shadowing, TTL expiry, each column's latest alive setter, row
existence, row bounds and predicates), batched over G windows at once,
each with its own bounds, read point and literals. It is the plain
version of both row-path kernels (``ops.row_gather``: K7 ``gather_rows``
and K9 ``scan_candidates``, ``csrc/row_gather.cu``), and its answers are
the JAX program's, garbage entries included: a group id past the
window's groups has ``result`` False and ``start_idx`` I32_MAX, and a
column with no alive setter reads its planes from the window's last row
(the JAX program clips I32_MAX to N - 1).

Design notes shared with the JAX package: every 64-bit comparison is a
two-int32-plane lexicographic compare (utils.planes); range bounds arrive
as row-index bounds pre-resolved on the host by exact bisection over full
key bytes; integer SUM is exact through 16-bit limbs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

I32_MIN = np.int32(np.iinfo(np.int32).min)
I32_MAX = np.int32(np.iinfo(np.int32).max)


def le2(a_hi, a_lo, b_hi, b_lo):
    """(a_hi, a_lo) <= (b_hi, b_lo), lexicographic on signed int32 planes;
    works on tensors and on python ints alike."""
    return (a_hi < b_hi) | ((a_hi == b_hi) & (a_lo <= b_lo))


def lt2(a_hi, a_lo, b_hi, b_lo):
    return (a_hi < b_hi) | ((a_hi == b_hi) & (a_lo < b_lo))


def eq2(a_hi, a_lo, b_hi, b_lo):
    return (a_hi == b_hi) & (a_lo == b_lo)


@dataclass(frozen=True)
class ColSig:
    col_id: int
    kind: str        # 'i32' | 'i64' | 'f32' | 'f64' | 'str'

    @property
    def two_plane(self) -> bool:
        return self.kind in ("i64", "f64", "str")


@dataclass(frozen=True)
class PredSig:
    col_id: int
    kind: str
    op: str          # '=', '!=', '<', '<=', '>', '>=' ('IN' expands to '='s)


@dataclass(frozen=True)
class AggSig:
    fn: str          # 'count' | 'sum' | 'min' | 'max'
    col_id: int | None
    kind: str | None


@dataclass(frozen=True)
class ScanSig:
    """Everything that shapes a fold over one run."""

    B: int           # blocks in run
    R: int           # rows per block
    K: int           # blocks per window
    cols: tuple      # tuple[ColSig] — columns the program touches
    preds: tuple     # tuple[PredSig]
    aggs: tuple      # tuple[AggSig] — empty for row scans
    apply_preds: bool  # False: candidates only (multi-source scans)
    flat: bool = False  # every key group has exactly 1 version: the MVCC
                        # merge degenerates to elementwise masks
    lookback: int = 0   # run's max versions per key group (0 = unknown/
                        # flat)


# -- the window resolve (plain PyTorch, batched over windows) -----------------

def window_plane(plane: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``plane`` ([B, R] or [B, R, P]) at the global rows ``rows`` [G, N]:
    [G, N] or [G, N, P]."""
    if plane.dim() == 3:
        return plane.reshape(-1, plane.shape[2])[rows]
    return plane.reshape(-1)[rows]


def _seg(vals: torch.Tensor, seg: torch.Tensor, fill, how: str):
    """Segment max/min of ``vals`` [G, N] over the flattened segment ids
    ``seg`` [G, N] (page-offset group ids), empty segments at ``fill``:
    [G, N] indexed by group id."""
    G, N = vals.shape
    out = torch.full((G * N,), fill, dtype=vals.dtype, device=vals.device)
    out = out.scatter_reduce(0, seg.reshape(-1), vals.reshape(-1), how,
                             include_self=True)
    return out.reshape(G, N)


def resolve_windows(sig, run: dict, b0: torch.Tensor, row_lo: torch.Tensor,
                    row_hi: torch.Tensor, read: torch.Tensor,
                    lits: tuple) -> dict:
    """Resolve G windows of ``sig.K`` blocks of ``run`` (``DeviceRun.arrays``)
    at once: ``b0`` [G] each window's first block, ``row_lo`` / ``row_hi``
    [G] its window-local row bounds, ``read`` [G, 4] its read and expiry
    planes, ``lits`` one [G] (i32, f32) or [G, 2] tensor per predicate.

    Returns per-group [G, N] arrays (the JAX ``resolve_window``'s
    contract, with a leading window axis): ``result``, ``pre_pred``,
    ``start_idx`` (int64), ``num_groups`` [G], ``ridx``, and per touched
    column ``col_idx`` / ``col_has`` / ``col_notnull``, plus the row-indexed
    windowed planes ``cmp_w`` / ``arith_w``."""
    K, R = sig.K, sig.R
    N = K * R
    device = run["valid"].device
    G = b0.shape[0]
    ridx = torch.arange(N, device=device)
    rows = b0.to(torch.int64)[:, None] * R + ridx

    def wp(plane):
        return window_plane(plane, rows)

    valid = wp(run["valid"])
    tomb = wp(run["tomb"])
    live = wp(run["live"])
    ht_hi, ht_lo = wp(run["ht_hi"]), wp(run["ht_lo"])
    read = read.to(torch.int64)
    r_hi, r_lo, e_hi, e_lo = (read[:, i:i + 1] for i in range(4))
    visible = valid & le2(ht_hi, ht_lo, r_hi, r_lo)
    expired = le2(wp(run["exp_hi"]), wp(run["exp_lo"]), e_hi, e_lo)
    row_lo = row_lo.to(torch.int64)[:, None]
    row_hi = row_hi.to(torch.int64)[:, None]
    ridx_g = ridx.expand(G, N)

    cmp_w, arith_w, code_w, set_w, null_w = {}, {}, {}, {}, {}
    for cs in sig.cols:
        c = run["cols"][cs.col_id]
        set_w[cs.col_id] = wp(c["set"])
        null_w[cs.col_id] = wp(c["isnull"])
        cmp_w[cs.col_id] = wp(c["cmp"])
        if "arith" in c:
            arith_w[cs.col_id] = wp(c["arith"])
        if "code" in c:  # a dictionary column's code plane
            code_w[cs.col_id] = wp(c["code"])

    col_idx, col_has, col_notnull = {}, {}, {}
    if sig.flat:
        alive = visible & ~tomb
        exists = alive & live & ~expired
        for cs in sig.cols:
            has = alive & set_w[cs.col_id]
            col_idx[cs.col_id] = ridx_g
            col_has[cs.col_id] = has
            col_notnull[cs.col_id] = has & ~null_w[cs.col_id] & ~expired
            exists = exists | col_notnull[cs.col_id]
        start_idx = ridx_g
        in_range = (ridx_g >= row_lo) & (ridx_g < row_hi)
        result = exists & in_range & valid
        num_groups = torch.full((G,), N, dtype=torch.int64, device=device)
    else:
        gid = torch.cumsum(wp(run["group_start"]).to(torch.int64), 1) - 1
        num_groups = gid[:, -1] + 1
        seg = gid.clamp(min=0) + torch.arange(G, device=device)[:, None] * N
        hi32, lo32 = ht_hi.to(torch.int64), ht_lo.to(torch.int64)
        i32_min, i32_max = int(I32_MIN), int(I32_MAX)

        def back(per_group):  # per-group [G, N] -> per-row [G, N]
            return per_group.reshape(-1)[seg]

        vt = visible & tomb
        t_hi = back(_seg(torch.where(vt, hi32, i32_min), seg, i32_min,
                         "amax"))
        t_lo = back(_seg(torch.where(vt & (hi32 == t_hi), lo32, i32_min),
                         seg, i32_min, "amax"))
        # <= (not <): a value at exactly the tombstone's hybrid time is
        # shadowed too (a same-batch DELETE + write share one).
        shadowed = (t_hi != i32_min) & le2(hi32, lo32, t_hi, t_lo)
        alive = visible & ~tomb & ~shadowed
        exists = _seg((alive & live & ~expired).to(torch.int64), seg, 0,
                      "amax") > 0
        start_idx = _seg(ridx_g, seg, i32_max, "amin")
        for cs in sig.cols:
            first = _seg(torch.where(alive & set_w[cs.col_id], ridx_g,
                                     i32_max), seg, i32_max, "amin")
            has = first != i32_max
            idx = first.clamp(0, N - 1)
            col_idx[cs.col_id] = idx
            col_has[cs.col_id] = has
            col_notnull[cs.col_id] = (
                has & ~torch.gather(null_w[cs.col_id], 1, idx)
                & ~torch.gather(expired, 1, idx))
            exists = exists | col_notnull[cs.col_id]
        in_range = (start_idx >= row_lo) & (start_idx < row_hi)
        valid_group = _seg(valid.to(torch.int64), seg, i32_min, "amax") > 0
        result = exists & in_range & valid_group

    pre_pred = result
    if sig.apply_preds:
        for ps, lit in zip(sig.preds, lits):
            cid = ps.col_id
            result = result & col_notnull[cid] & _eval_pred(
                ps, cmp_w.get(cid), arith_w.get(cid), col_idx[cid], lit,
                code_w.get(cid))
    return {"result": result, "pre_pred": pre_pred, "start_idx": start_idx,
            "num_groups": num_groups, "ridx": ridx_g, "col_idx": col_idx,
            "col_has": col_has, "col_notnull": col_notnull, "cmp_w": cmp_w,
            "arith_w": arith_w, "code_w": code_w}


def _eval_pred(ps: PredSig, cmp, arith, idx, lit, code=None):
    """Predicate mask over the merged values at ``idx`` [G, N] (the JAX
    package's ``_eval_pred``). For 'str' AND 'f32', a SUPERSET mask (ties
    count as maybe-match; the host verifies): f32 rounding is monotone
    but not injective, so equal-after-rounding comparisons are ambiguous
    just like equal string prefixes. A promoted 'code' predicate compares
    the dictionary column's code plane ``code`` exactly (the sorted
    dictionary makes code order value order). ``lit``: [G] (i32, f32,
    code) or [G, 2]."""
    if ps.kind == "code":
        v = torch.gather(code, 1, idx)
        x = lit.to(torch.int64)[:, None]
        return {"=": v == x, "!=": v != x, "<": v < x, "<=": v <= x,
                ">": v > x, ">=": v >= x}[ps.op]
    if ps.kind == "f32":
        v = torch.gather(arith, 1, idx)
        x = lit.to(torch.float32)[:, None]
        return {"=": v == x, "!=": torch.ones_like(v, dtype=torch.bool),
                "<": v <= x, "<=": v <= x, ">": v >= x, ">=": v >= x}[ps.op]
    if ps.kind == "i32":
        v = torch.gather(cmp[..., 0], 1, idx)
        x = lit.to(torch.int64)[:, None]
        return {"=": v == x, "!=": v != x, "<": v < x, "<=": v <= x,
                ">": v > x, ">=": v >= x}[ps.op]
    hi = torch.gather(cmp[..., 0], 1, idx)
    lo = torch.gather(cmp[..., 1], 1, idx)
    lit = lit.to(torch.int64)
    lhi, llo = lit[:, 0:1], lit[:, 1:2]
    eq = eq2(hi, lo, lhi, llo)
    lt = lt2(hi, lo, lhi, llo)
    if ps.kind in ("i64", "f64"):
        return {"=": eq, "!=": ~eq, "<": lt, "<=": lt | eq,
                ">": ~(lt | eq), ">=": ~lt}[ps.op]
    # strings: plane-equality is ambiguous -> superset semantics
    return {"=": eq, "!=": torch.ones_like(eq), "<": lt | eq, "<=": lt | eq,
            ">": ~lt, ">=": ~lt}[ps.op]


def _limbs16(u: torch.Tensor) -> tuple:
    """The two 16-bit limbs of a 2^31-biased int32 plane (int64 values in
    [0, 2^32))."""
    return u & 0xFFFF, u >> 16


def _eval_agg(name: str, ag: AggSig, result, col_idx, col_notnull, cmp_w,
              arith_w, block_of_group, K: int) -> dict:
    """Per-block partials of one aggregate over G resolved windows (the JAX
    package's ``_eval_agg`` with a leading window axis): ``result``,
    ``col_idx`` / ``col_notnull`` entries and ``block_of_group`` are
    [G, N] (``resolve_windows``' output), ``cmp_w`` / ``arith_w`` its
    row-indexed windowed planes.

    Returns ``{name}_count`` [G]; for SUM ``{name}_n`` [G] and
    ``{name}_limbs`` [G, K, 4] int64 (the 16-bit limbs of the biased
    order planes, summed per block) or ``{name}_fsum`` [G, K] float32
    (the ``arith`` plane summed per block); for MIN/MAX ``{name}_n`` and
    ``{name}_fext`` (f32, on ``arith``), ``{name}_ext`` (i32) or
    ``{name}_ext_hi`` / ``{name}_ext_lo`` (two order planes, the tie on
    the high plane broken on the low one), [G] each, at the type's fill
    where no row counts. Integer partials are int64 here, int32 in the
    JAX program: the values are the same, none overflows int32."""
    out = {}
    if ag.fn == "count":
        mask = (result if ag.col_id is None
                else result & col_notnull[ag.col_id])
        out[f"{name}_count"] = mask.sum(dim=1)
        return out
    mask = result & col_notnull[ag.col_id]
    idx = col_idx[ag.col_id]
    out[f"{name}_n"] = mask.sum(dim=1)
    G = mask.shape[0]
    # Garbage group ids (past the window's groups) never count: clamp
    # their block so that the per-block scatter stays in range.
    blocks = block_of_group.clamp(0, K - 1)

    def per_block(v):
        shape = (G, K) + tuple(v.shape[2:])
        index = blocks.reshape(blocks.shape + (1,) * (v.dim() - 2)
                               ).expand(v.shape)
        return torch.zeros(shape, dtype=v.dtype,
                           device=v.device).scatter_add_(1, index, v)

    def plane(j):
        return torch.gather(cmp_w[ag.col_id][..., j], 1, idx)

    if ag.fn == "sum":
        if ag.kind in ("f32", "f64"):
            v = torch.gather(arith_w[ag.col_id], 1, idx)
            out[f"{name}_fsum"] = per_block(torch.where(mask, v, 0.0))
            return out
        if ag.kind == "i32":
            l0, l1 = _limbs16(plane(0).long() + (1 << 31))
            zero = torch.zeros_like(l0)
            limbs = (l0, l1, zero, zero)
        else:  # i64: lo plane's limbs, then hi plane's
            limbs = (*_limbs16(plane(1).long() + (1 << 31)),
                     *_limbs16(plane(0).long() + (1 << 31)))
        stacked = torch.stack([torch.where(mask, l, 0) for l in limbs], -1)
        out[f"{name}_limbs"] = per_block(stacked)
        return out
    # MIN / MAX on the order planes (exact); f32 on the arith plane.
    is_max = ag.fn == "max"

    def red(v):
        return v.amax(dim=1) if is_max else v.amin(dim=1)

    if ag.kind == "f32":
        v = torch.gather(arith_w[ag.col_id], 1, idx)
        out[f"{name}_fext"] = red(torch.where(
            mask, v, float("-inf") if is_max else float("inf")))
        return out
    ifill = int(I32_MIN) if is_max else int(I32_MAX)
    hi = plane(0).long()
    mhi = red(torch.where(mask, hi, ifill))
    if ag.kind == "i32":
        out[f"{name}_ext"] = mhi
        return out
    tie = mask & (hi == mhi[:, None])
    out[f"{name}_ext_hi"] = mhi
    out[f"{name}_ext_lo"] = red(torch.where(tie, plane(1).long(), ifill))
    return out


def _scalar_lits(sig, pred_literals, device) -> tuple:
    """One-window literal tensors ([1] or [1, 2]) of host literals."""
    out = []
    for ps, lit in zip(sig.preds, pred_literals):
        if ps.kind == "f32":
            out.append(torch.tensor([float(lit)], dtype=torch.float32,
                                    device=device))
        elif ps.kind in ("i32", "code"):
            out.append(torch.tensor([int(lit)], dtype=torch.int64,
                                    device=device))
        else:
            out.append(torch.tensor([[int(lit[0]), int(lit[1])]],
                                    dtype=torch.int64, device=device))
    return tuple(out)


def resolve_window(sig, run, b0, row_lo, row_hi, read_hi, read_lo, rexp_hi,
                   rexp_lo, pred_literals) -> dict:
    """The JAX package's ``resolve_window`` for one window (host scalars):
    ``resolve_windows`` at G = 1, the window axis dropped."""
    device = run["valid"].device

    def t(v):
        return torch.tensor([int(v)], dtype=torch.int64, device=device)

    r = resolve_windows(
        sig, run, t(b0), t(row_lo), t(row_hi),
        torch.tensor([[read_hi, read_lo, rexp_hi, rexp_lo]],
                     dtype=torch.int64, device=device),
        _scalar_lits(sig, pred_literals, device))

    def one(x):
        if isinstance(x, dict):
            return {k: one(v) for k, v in x.items()}
        return x[0]
    return {k: one(v) for k, v in r.items()}


def scan_window(sig: ScanSig, run, b0, row_lo, row_hi, read_hi, read_lo,
                rexp_hi, rexp_lo, pred_literals) -> dict:
    """The JAX package's ``scan_window`` in its row-scan form (``aggs=()``,
    the candidates of a multi-source row scan): ``result`` bool [N] per
    group id, ``start_idx`` int32 [N] (I32_MAX past the window's groups)
    and ``num_groups``. K9's kernel (``row_gather.scan_candidates``)
    computes this over a range of windows in one launch."""
    if sig.aggs:
        raise ValueError("the port's scan_window is the row-scan form: "
                         "aggregates fold in ops.flat_agg / ops.flat_fold")
    r = resolve_window(sig, run, b0, row_lo, row_hi, read_hi, read_lo,
                       rexp_hi, rexp_lo, pred_literals)
    return {"result": r["result"], "start_idx": r["start_idx"].to(torch.int32),
            "num_groups": r["num_groups"].to(torch.int32)}
