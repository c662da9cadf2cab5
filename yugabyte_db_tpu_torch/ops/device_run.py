"""DeviceRun: a ColumnarRun's planes resident in device memory.

Reference analog: the SSTable blocks an LRU block cache holds in RAM
(src/yb/rocksdb/util/cache.cc). While resident, an aggregate scan is pure
compute over the planes with no host↔device data motion besides its
parameters and its (small) result.

Layout: the JAX package's ``DeviceRun.arrays`` tree, as torch tensors —
``valid`` / ``group_start`` / ``tomb`` / ``live`` [B, R] bool (one byte a
row), ``ht_hi/lo`` / ``exp_hi/lo`` [B, R] int32, and per value column
``cols[cid]`` = {``set``, ``isnull`` [B, R] bool, ``cmp`` [B, R, P] int32,
``arith`` [B, R] float32 for numeric columns}. The block axis is padded to
a multiple of the window size exactly as the JAX package pads it.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch

from yugabyte_db_tpu_torch.models.datatypes import DataType

if TYPE_CHECKING:  # type-only: ops never depends on storage at runtime
    from yugabyte_db_tpu_torch.storage.columnar import ColumnarRun

_TOP_PLANES = ("valid", "group_start", "tomb", "live",
               "ht_hi", "ht_lo", "exp_hi", "exp_lo")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another one. Raises when CUDA is asked for (or defaulted to) and
    absent — never drifts to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU")
    return dev


def dtype_kind(dt: DataType) -> str:
    if not dt.is_fixed_width:
        return "str"  # varlen/opaque: host payload + 8-byte prefix planes
    if dt == DataType.DOUBLE:
        return "f64"
    if dt == DataType.FLOAT:
        return "f32"
    if dt.np_dtype.itemsize == 8:
        return "i64"
    return "i32"


def padded_blocks(B: int, window_blocks: int) -> int:
    """The padded block count a DeviceRun uses for a run of ``B`` blocks."""
    b = max(B, 1)
    return b + (-b) % window_blocks


def _padded_tree(run: ColumnarRun, window_blocks: int) -> dict:
    """The run's host planes in the arrays-tree layout, block axis padded:
    padding blocks are valid=False, group_start=True (each pad row its own
    group), everything else zero."""
    B = max(run.B, 1)
    pad = padded_blocks(run.B, window_blocks) - B

    def pad_b(arr, fill=0):
        if pad == 0:
            return arr
        tail = np.full((pad,) + arr.shape[1:], fill, dtype=arr.dtype)
        return np.concatenate([arr, tail], axis=0)

    tree = {
        "valid": pad_b(run.valid),
        "group_start": pad_b(run.group_start, True),
        "tomb": pad_b(run.tomb),
        "live": pad_b(run.live),
        "ht_hi": pad_b(run.ht_hi),
        "ht_lo": pad_b(run.ht_lo),
        "exp_hi": pad_b(run.exp_hi),
        "exp_lo": pad_b(run.exp_lo),
        "cols": {},
    }
    for cid, col in run.cols.items():
        entry = {"set": pad_b(col.set_), "isnull": pad_b(col.isnull),
                 "cmp": pad_b(col.cmp_planes)}
        if col.arith is not None:
            entry["arith"] = pad_b(col.arith)
        tree["cols"][cid] = entry
    return tree


class DeviceRun:
    """A run's planes on one device (``arrays``), block axis padded to a
    multiple of ``window_blocks``."""

    def __init__(self, run: ColumnarRun, window_blocks: int, device=None):
        self._adopt(_padded_tree(run, window_blocks), run.R,
                    resolve_device(device))

    @classmethod
    def from_reference_planes(cls, planes: dict, R: int,
                              device=None) -> "DeviceRun":
        """Upload planes given as numpy arrays in the arrays-tree layout —
        e.g. the JAX package's ``DeviceRun.arrays`` brought to the host —
        so that both implementations read the same bytes. The block axis
        is taken as given (already padded by whoever built it)."""
        self = cls.__new__(cls)
        self._adopt(planes, R, resolve_device(device))
        return self

    @classmethod
    def from_arrays(cls, arrays: dict, R: int) -> "DeviceRun":
        """Adopt planes made ON the device (``ops.flush.replay_flush``)
        instead of uploading host planes: the arrays must already carry
        this class's padding encoding, the block axis padded to the window
        multiple. A flush seeds its run this way with no host-to-device
        upload."""
        self = cls.__new__(cls)
        self.device = arrays["valid"].device
        self.R = int(R)
        self.arrays = arrays
        self.B = int(arrays["valid"].shape[0])
        return self

    def _adopt(self, planes: dict, R: int, device: torch.device) -> None:
        def up(arr):
            arr = np.ascontiguousarray(np.asarray(arr))
            if not arr.flags.writeable:  # e.g. a view of a JAX array
                arr = arr.copy()
            return torch.from_numpy(arr).to(device)

        self.device = device
        self.R = int(R)
        self.arrays = {name: up(planes[name]) for name in _TOP_PLANES}
        self.arrays["cols"] = {
            int(cid): {n: up(a) for n, a in entry.items()}
            for cid, entry in planes["cols"].items()}
        shape = tuple(self.arrays["valid"].shape)
        if len(shape) != 2 or shape[1] != self.R:
            raise ValueError(f"planes of shape {shape} do not hold R={R} "
                             "rows per block")
        self.B = shape[0]

    @property
    def nbytes(self) -> int:
        """Device-resident bytes of this run's planes."""
        total = 0
        stack = [self.arrays]
        while stack:
            node = stack.pop()
            if isinstance(node, dict):
                stack.extend(node.values())
            else:
                total += node.numel() * node.element_size()
        return total
