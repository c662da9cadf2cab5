"""MVCC resolve of a multi-version run into a flat view: the CUDA kernel
and its plain version.

The JAX package resolves a multi-version run inside each aggregate
program, with XLA: ``ops/seg_fold.py`` ``compiled_seg_aggregate`` (K4,
segmented associative scans) and ``ops/lookback_fold.py``
``compiled_lookback_aggregate`` (K3, W - 1 shifted masks), both ending in
its ``flat_fold.finish_groups``. Here the resolve is a kernel of its own,
``csrc/mvcc_resolve.cu``, that writes a **resolved flat view** of the run
at one read point, in the ``DeviceRun.arrays`` layout. At each key
group's first row:

- ``valid``: the group has a valid row; ``live``: an alive, unexpired
  version of the group carries the liveness marker;
- per column, ``set``: the column has a latest alive setter; ``isnull``:
  that setter's value is NULL or expired; ``cmp`` and ``arith``: the
  setter's planes.

Every other row is ``valid = False`` with zero planes. The view's
``ht_*``, ``exp_*``, ``tomb`` and ``group_start`` planes are constant
(hybrid time 0, expiry MAX_HT, no tombstones, every row its own group;
``constant_planes``, allocated once per run), so the flat folds (K1 in
``ops.flat_agg``, ``ops.flat_fold``) see every representative visible
and unexpired at any read point, and give on the view exactly what
``finish_groups`` gives on the run.

- ``resolve_view``: the wrapper. On CUDA tensors it launches the kernel
  (or raises); on CPU tensors it runs ``resolve_view_plain``, built from
  ``seg_fold.resolve_groups``. ``resolve_view.launches`` counts launches.
- ``view_bytes``: the bytes the function must move at one read point,
  for the bound.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from yugabyte_db_tpu_torch.ops import native, seg_fold
from yugabyte_db_tpu_torch.ops.encodings import require_plain
from yugabyte_db_tpu_torch.utils import planes as PL

MAX_COLS = 16   # value columns one launch resolves; csrc/mvcc_resolve.cu
MAX_HT = (1 << 63) - 1  # no expiry (storage.row_version.MAX_HT)
TILE_MAX = 2048  # rows a block of the kernel stages (kTileMax)
THREADS = 256  # threads a block (kThreads)
# A block's static shared memory: 21 bytes a row of the tile (4 flag
# bytes, 16 bytes of hybrid time and expiry, the answers).
STATIC_SMEM = 21 * TILE_MAX
SMEM_PER_SM = 228 * 1024  # shared memory an H100 SM holds
# Input planes of the run, in the kernel's order; per column set, isnull,
# cmp, arith follow.
_RUN_PLANES = ("valid", "group_start", "tomb", "live", "ht_hi", "ht_lo",
               "exp_hi", "exp_lo")


def constant_planes(B: int, R: int, device) -> dict:
    """The view planes that no read point changes: hybrid time 0, expiry
    MAX_HT, no tombstone, every row its own group."""
    def full(value, dtype):
        return torch.full((B, R), value, dtype=dtype, device=device)

    ht_hi, ht_lo = PL.scalar_ht_planes(0)
    exp_hi, exp_lo = PL.scalar_ht_planes(MAX_HT)
    return {"group_start": full(True, torch.bool),
            "tomb": full(False, torch.bool),
            "ht_hi": full(ht_hi, torch.int32), "ht_lo": full(ht_lo, torch.int32),
            "exp_hi": full(exp_hi, torch.int32),
            "exp_lo": full(exp_lo, torch.int32)}


def launch_geometry(n_rows: int, R: int, n_cols: int) -> dict:
    """The kernel's launch shape, as ``csrc/mvcc_resolve.cu`` computes it:
    each block stages a tile of the most whole blocks of R rows that fit
    in TILE_MAX rows (TILE_MAX rows of a longer block), so that no group
    crosses a tile unless R > TILE_MAX; ``smem_bytes``: the block's shared
    memory (the static planes and the dynamic part: each column's set
    flags, then its setters, two bytes a row)."""
    tile = TILE_MAX // R * R if R <= TILE_MAX else TILE_MAX
    dyn = -(-tile * n_cols // 16) * 16 + 2 * n_cols * tile
    return {"tile_rows": tile, "blocks": -(-n_rows // tile),
            "threads": THREADS, "dynamic_smem_bytes": dyn,
            "smem_bytes": STATIC_SMEM + dyn}


def _check(run: dict, const: dict) -> tuple:
    valid = run["valid"]
    device = valid.device
    shape = tuple(valid.shape)
    if len(shape) != 2 or valid.numel() >= (1 << 31):
        raise ValueError(f"planes of shape {shape}: the kernel takes [B, R] "
                         "with fewer than 2^31 rows")
    want = {"valid": torch.bool, "group_start": torch.bool,
            "tomb": torch.bool, "live": torch.bool, "ht_hi": torch.int32,
            "ht_lo": torch.int32, "exp_hi": torch.int32,
            "exp_lo": torch.int32}
    planes = [(name, run[name], dt) for name, dt in want.items()]
    planes += [(f"constant {name}", const[name], want[name])
               for name in ("group_start", "tomb", "ht_hi", "ht_lo",
                            "exp_hi", "exp_lo")]
    for cid, c in run["cols"].items():
        planes += [(f"col {cid} set", c["set"], torch.bool),
                   (f"col {cid} isnull", c["isnull"], torch.bool)]
        if "arith" in c:
            planes.append((f"col {cid} arith", c["arith"], torch.float32))
        cmp = c["cmp"]
        if cmp.dtype != torch.int32 or cmp.dim() != 3 or \
                tuple(cmp.shape[:2]) != shape or cmp.shape[2] not in (1, 2):
            raise ValueError(f"col {cid} cmp: {cmp.dtype} {tuple(cmp.shape)}")
        planes.append((f"col {cid} cmp", cmp, torch.int32))
    for name, t, dt in planes:
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, valid on {device}")
        if t.dtype != dt or not t.is_contiguous() or \
                tuple(t.shape[:2]) != shape:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}, want "
                             f"contiguous {dt} {shape}")
    return shape


def resolve_view(run: dict, read_hi: int, read_lo: int, rexp_hi: int,
                 rexp_lo: int, const: dict) -> dict:
    """The resolved flat view of ``run`` (``DeviceRun.arrays``) at one
    read point (read and expiry planes, as the folds take them), sharing
    ``const`` (``constant_planes``). Launches the CUDA kernel for CUDA
    tensors (one launch per ``MAX_COLS`` value columns), runs the plain
    version for CPU tensors, and raises for anything else."""
    require_plain(run, "the resolve")
    B, R = _check(run, const)
    device = run["valid"].device
    if device.type == "cpu":
        return resolve_view_plain(run, read_hi, read_lo, rexp_hi, rexp_lo,
                                  const)
    if device.type != "cuda":
        raise ValueError(f"resolve_view runs on cuda or cpu, not {device}")
    lib = _library()

    def like(t):
        return torch.empty(t.shape, dtype=t.dtype, device=device)

    view = dict(const, valid=like(run["valid"]), live=like(run["live"]),
                cols={cid: {k: like(t) for k, t in c.items()}
                      for cid, c in run["cols"].items()})
    cids = list(run["cols"])
    for k in range(0, max(len(cids), 1), MAX_COLS):
        chunk = cids[k:k + MAX_COLS]
        ins = [run[name] for name in _RUN_PLANES]
        outs = [view["valid"], view["live"]]
        for cid in chunk:
            c, o = run["cols"][cid], view["cols"][cid]
            ins += [c["set"], c["isnull"], c["cmp"], c.get("arith")]
            outs += [o["set"], o["isnull"], o["cmp"], o.get("arith")]
        widths = (ctypes.c_int32 * MAX_COLS)(
            *[run["cols"][cid]["cmp"].shape[2] for cid in chunk])
        in_ptrs = (ctypes.c_void_p * len(ins))(
            *[None if t is None else t.data_ptr() for t in ins])
        out_ptrs = (ctypes.c_void_p * len(outs))(
            *[None if t is None else t.data_ptr() for t in outs])
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = lib.mvcc_resolve_launch(
                in_ptrs, out_ptrs, widths, len(chunk), B * R, R, read_hi,
                read_lo, rexp_hi, rexp_lo, ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError(f"mvcc_resolve kernel launch failed ({rc}): "
                               f"{lib.mvcc_resolve_error_string(rc).decode()}")
        resolve_view.launches += 1
    return view


# Kernel launches since the count was last set to 0.
resolve_view.launches = 0


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    return bind(native.load_library("mvcc_resolve"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with the argument and result types of the kernel's C
    interface set."""
    lib.mvcc_resolve_launch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.mvcc_resolve_launch.restype = ctypes.c_int
    lib.mvcc_resolve_error_string.argtypes = [ctypes.c_int]
    lib.mvcc_resolve_error_string.restype = ctypes.c_char_p
    return lib


def resolve_view_plain(run: dict, read_hi: int, read_lo: int, rexp_hi: int,
                       rexp_lo: int, const: dict) -> dict:
    """The kernel's function in torch ops, from ``seg_fold.resolve_groups``:
    the same view, byte for byte."""
    live_any, col_val = seg_fold.resolve_groups(run, read_hi, read_lo,
                                                rexp_hi, rexp_lo)
    rep = run["group_start"] & run["valid"]
    view = dict(const, valid=rep, live=rep & live_any, cols={})
    for cid, v in col_val.items():
        s = rep & v["has"]
        entry = {"set": s, "isnull": s & (v["null"] | v["exp"]),
                 "cmp": torch.where(s[..., None], v["cmp"], 0)}
        if "arith" in v:
            entry["arith"] = torch.where(s, v["arith"], 0.0)
        view["cols"][cid] = entry
    return view


def view_bytes(run: dict, read_hi: int, read_lo: int, rexp_hi: int,
               rexp_lo: int) -> int:
    """Bytes the function must move at one read point, each plane read
    only where the resolve needs it (1 byte a flag, 4 a word, 8 a hybrid
    time or expiry):

    - every row's valid flag (padding rows need nothing else);
    - at valid rows: group start, tombstone and hybrid time;
    - at alive rows (visible, not a tombstone, not shadowed): the liveness
      marker, and each column's set flag up to the group's latest setter
      of it;
    - the expiry at alive rows with the liveness marker and at setters;
    - at each latest setter: its isnull flag and its order and arithmetic
      planes;
    - the view's valid, live and column planes written at every row (the
      constant planes are not rewritten)."""
    n = run["valid"].numel()
    valid = run["valid"].reshape(n)
    alive = seg_fold.alive_rows(run, read_hi, read_lo)
    _live, col_val = seg_fold.resolve_groups(run, read_hi, read_lo, rexp_hi,
                                             rexp_lo)
    rep = (run["group_start"].reshape(n) & valid)
    rows = torch.arange(n, device=valid.device)
    needs_exp = alive & run["live"].reshape(n)
    total = n + int(valid.sum()) * (1 + 1 + 8) + int(alive.sum()) + 2 * n
    for cid, c in run["cols"].items():
        per_row = 4 * c["cmp"].shape[2] + (4 if "arith" in c else 0)
        s_row = col_val[cid]["row"].reshape(n)
        setters = s_row[rep & (s_row < n)]
        needs_exp[setters] = True
        total += int((alive & (rows <= s_row)).sum())  # set flags
        total += setters.numel() * (1 + per_row) + n * (2 + per_row)
    return total + 8 * int(needs_exp.sum())
