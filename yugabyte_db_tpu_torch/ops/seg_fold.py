"""MVCC resolve of a MULTI-VERSION run's key groups in plain PyTorch.

The resolve half of the JAX package's ``ops/seg_fold.py`` (K4, segmented
associative scans) and ``ops/lookback_fold.py`` (K3, shifted masks for
runs of at most 32 versions a key): XLA programs there, segment
reductions here. A key's versions are contiguous, newest first, and
never span a block (``storage.columnar``), so each question the MVCC
merge asks of a key group is a segment reduction over the flattened
rows:

- ``gid = cumsum(group_start) - 1`` numbers the groups;
- the group's first visible tombstone (the newest, in the ht-desc
  layout) is the least row index among its visible tombstones
  (``scatter_reduce(..., "amin")``); it shadows every version whose
  hybrid time is at or below its own, so a write at the same hybrid time
  is shadowed on either side of it in the layout (the same-batch
  DELETE + write tie);
- liveness is any alive, unexpired version with the liveness marker;
- each column's value comes from the group's first alive version that
  sets it; if that version is expired or NULL the column is NULL for the
  group, with no fallback to an older setter.

``ops.mvcc_resolve`` builds the plain version of its kernel from
``resolve_groups``: a flat view of the group representatives, which the
flat folds (K1, ``ops.flat_fold``) fold as the JAX package's
``finish_groups`` folds them.
"""

from __future__ import annotations

import torch

from yugabyte_db_tpu_torch.ops.scan import le2


def _group_ids(run: dict) -> torch.Tensor:
    """Each flattened row's key group number."""
    gs = run["group_start"].reshape(-1)
    return (torch.cumsum(gs, 0) - 1).clamp(min=0)


def _first_row(gid: torch.Tensor, found: torch.Tensor) -> torch.Tensor:
    """Per flattened row: the least row of its group where ``found``
    holds, or the row count where none does."""
    n = gid.numel()
    rows = torch.arange(n, device=gid.device)
    none = torch.full((n,), n, dtype=torch.int64, device=gid.device)
    return none.scatter_reduce(0, gid, torch.where(found, rows, n),
                               "amin")[gid]


def alive_rows(run: dict, read_hi, read_lo) -> torch.Tensor:
    """Flattened [B * R] bool: the versions of ``run``
    (``DeviceRun.arrays``) visible at the read point that are neither a
    tombstone nor shadowed by the group's newest visible one."""
    n = run["valid"].numel()
    ht_hi, ht_lo = run["ht_hi"].reshape(n), run["ht_lo"].reshape(n)
    visible = run["valid"].reshape(n) & le2(ht_hi, ht_lo, read_hi, read_lo)
    tomb = run["tomb"].reshape(n)
    t_row = _first_row(_group_ids(run), visible & tomb)
    t = t_row.clamp(max=n - 1)
    shadowed = (t_row < n) & le2(ht_hi, ht_lo, ht_hi[t], ht_lo[t])
    return visible & ~tomb & ~shadowed


def resolve_groups(run: dict, read_hi, read_lo, rexp_hi, rexp_lo):
    """(live_any, col_val) of ``run`` (``DeviceRun.arrays``) at one read
    point (read and expiry planes), every array [B, R] (``cmp`` [B, R, P])
    holding its row's group answer: the group has an alive, unexpired
    liveness marker; and ``col_val[cid]`` = {row, has, null, exp, cmp[,
    arith]} of the column's latest alive setter (``row``: its flattened
    row, B * R where there is none; ``has``: there is one; the rest is
    garbage where it is False)."""
    shape = run["valid"].shape
    n = run["valid"].numel()
    gid = _group_ids(run)
    alive = alive_rows(run, read_hi, read_lo)
    expired = le2(run["exp_hi"].reshape(n), run["exp_lo"].reshape(n),
                  rexp_hi, rexp_lo)
    live_any = _first_row(gid, alive & run["live"].reshape(n) & ~expired) < n

    col_val = {}
    for cid, c in run["cols"].items():
        s_row = _first_row(gid, alive & c["set"].reshape(n))
        s = s_row.clamp(max=n - 1)
        latest = {"row": s_row, "has": s_row < n,
                  "null": c["isnull"].reshape(n)[s], "exp": expired[s]}
        if "arith" in c:
            latest["arith"] = c["arith"].reshape(n)[s]
        latest = {k: v.reshape(shape) for k, v in latest.items()}
        latest["cmp"] = c["cmp"].reshape(n, -1)[s].reshape(c["cmp"].shape)
        col_val[cid] = latest
    return live_any.reshape(shape), col_val
