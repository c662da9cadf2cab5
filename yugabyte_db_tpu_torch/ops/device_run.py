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

Under the ``plane_encoding`` setting ``"auto"`` (the default, as the JAX
package's flag) a run uploads its encoded tree (``ops.encodings``) leaf by
leaf, each padded by ``pad_leaf``: ``encoded`` is then True and
``arrays`` holds encoded leaves, which ``ops.decode`` (K10) turns into
the plain tree above for the kernels that read plain planes. The u16
arrays of a leaf (``doff``, ``codes``) are held as ``torch.int16``.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch

from yugabyte_db_tpu_torch.models.datatypes import DataType
from yugabyte_db_tpu_torch.ops import encodings

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


PLANE_ENCODINGS = ("auto", "off")  # the plane_encoding setting's values


def plane_nbytes(run: ColumnarRun, window_blocks: int,
                 setting: str = "off") -> int:
    """Device bytes of ``DeviceRun(run, window_blocks, setting=...)``,
    from the host planes' shapes, without uploading (the JAX package's
    ``plane_nbytes``): the encoded tree's padded bytes where the run
    uploads encoded, else the plain planes'."""
    pb = padded_blocks(run.B, window_blocks)
    tree = run.encoded_arrays(setting)
    if tree is not None:
        return encodings.tree_padded_nbytes(tree, run.B, pb)

    def padded(arr) -> int:
        per_block = 1
        for d in arr.shape[1:]:
            per_block *= int(d)
        return pb * per_block * arr.dtype.itemsize

    total = sum(padded(a) for a in (
        run.valid, run.group_start, run.tomb, run.live,
        run.ht_hi, run.ht_lo, run.exp_hi, run.exp_lo))
    for col in run.cols.values():
        total += padded(col.set_) + padded(col.isnull)
        total += padded(col.cmp_planes)
        if col.arith is not None:
            total += padded(col.arith)
    return total


def _encoded_padded_tree(tree: dict, pad_b: int) -> dict:
    """An encoded tree's leaves with their block axis padded to ``pad_b``
    (``pad_leaf``: all-ones words for ``group_start``, zeros elsewhere,
    the absent code for a dictionary's pad rows)."""
    out = {name: encodings.pad_leaf(tree[name], pad_b,
                                    ones=(name == "group_start"))
           for name in _TOP_PLANES}
    out["cols"] = {cid: {n: encodings.pad_leaf(p, pad_b)
                         for n, p in col.items()}
                   for cid, col in tree["cols"].items()}
    return out


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
    multiple of ``window_blocks``: the encoded tree under ``setting``
    ``"auto"`` (the engine's default; ``encoded`` True, unless
    ``encoded_arrays`` gives None), the plain planes under ``"off"`` (this
    class's default, for callers that want the plain planes)."""

    def __init__(self, run: ColumnarRun, window_blocks: int, device=None,
                 setting: str = "off"):
        if setting not in PLANE_ENCODINGS:
            raise ValueError(f"plane_encoding {setting!r}: want one of "
                             f"{PLANE_ENCODINGS}")
        tree = run.encoded_arrays(setting)
        if tree is None:
            planes = _padded_tree(run, window_blocks)
        else:
            planes = _encoded_padded_tree(
                tree, padded_blocks(run.B, window_blocks))
        self._adopt(planes, run.R, resolve_device(device))

    @classmethod
    def from_reference_planes(cls, planes: dict, R: int,
                              device=None) -> "DeviceRun":
        """Upload planes given as numpy arrays in the arrays-tree layout —
        e.g. the JAX package's ``DeviceRun.arrays`` brought to the host,
        plain or encoded — so that both implementations read the same
        bytes. The block axis is taken as given (already padded by
        whoever built it)."""
        self = cls.__new__(cls)
        self._adopt(planes, R, resolve_device(device))
        return self

    @classmethod
    def from_arrays(cls, arrays: dict, R: int) -> "DeviceRun":
        """Adopt planes made ON the device (``ops.flush.replay_flush``)
        instead of uploading host planes: the arrays must already carry
        this class's padding encoding, the block axis padded to the window
        multiple. A flush seeds its run this way with no host-to-device
        upload; its dictionary columns make it ``encoded``."""
        self = cls.__new__(cls)
        self.device = arrays["ht_hi"].device  # hybrid times stay plain
        self.R = int(R)
        self.arrays = arrays
        self.B = int(encodings.tree_dims(arrays)[0])
        self.encoded = encodings.tree_encoded(arrays)
        return self

    def _adopt(self, planes: dict, R: int, device: torch.device) -> None:
        def up(arr):
            arr = np.ascontiguousarray(np.asarray(arr))
            if arr.dtype == np.uint16:  # torch holds u16 leaves as int16
                arr = arr.view(np.int16)
            if not arr.flags.writeable:  # e.g. a view of a JAX array
                arr = arr.copy()
            return torch.from_numpy(arr).to(device)

        def up_leaf(leaf):
            k = encodings.leaf_kind(leaf)
            if k is None:
                return up(leaf)
            return {k: {n: up(a) for n, a in leaf[k].items()}}

        self.device = device
        self.R = int(R)
        self.arrays = {name: up_leaf(planes[name]) for name in _TOP_PLANES}
        self.arrays["cols"] = {
            int(cid): {n: up_leaf(a) for n, a in entry.items()}
            for cid, entry in planes["cols"].items()}
        B, r = encodings.tree_dims(self.arrays)
        if r != self.R:
            raise ValueError(f"planes of {r} rows a block do not hold "
                             f"R={R} rows per block")
        self.B = int(B)
        self.encoded = encodings.tree_encoded(self.arrays)

    @property
    def nbytes(self) -> int:
        """Device-resident bytes of this run's planes (encoded bytes for
        an encoded tree)."""
        return tree_nbytes(self.arrays)


def tree_nbytes(tree: dict) -> int:
    """Bytes of every tensor in a plane tree."""
    total = 0
    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        else:
            total += node.numel() * node.element_size()
    return total
