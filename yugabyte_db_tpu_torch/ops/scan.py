"""Static scan signatures and the two-plane compare the folds share.

The dataclasses carry the same fields as the JAX package's ``ops/scan.py``
so that one signature means the same thing on both sides: a differential
test builds one ``ScanSig`` and hands it to either fold.

Design notes shared with the JAX package: every 64-bit comparison is a
two-int32-plane lexicographic compare (utils.planes); range bounds arrive
as row-index bounds pre-resolved on the host by exact bisection over full
key bytes; integer SUM is exact through 16-bit limbs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

I32_MIN = np.int32(np.iinfo(np.int32).min)
I32_MAX = np.int32(np.iinfo(np.int32).max)


def le2(a_hi, a_lo, b_hi, b_lo):
    """(a_hi, a_lo) <= (b_hi, b_lo), lexicographic on signed int32 planes;
    works on tensors and on python ints alike."""
    return (a_hi < b_hi) | ((a_hi == b_hi) & (a_lo <= b_lo))


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
