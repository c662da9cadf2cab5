"""History GC over a compaction's merge order: the retention mask K11, its
plain version and its numpy twin.

The JAX package's ``ops/compact.py``: the engine computes the merge ORDER
of its runs on the host (a k-way merge of the presorted runs over memcmp
sort keys, exact whenever keys fit the 32-byte prefix planes), and the
retention mask over that sorted union decides which versions survive:
visibility at the cutoff, tombstone shadowing, the contributors of each
key's merged state (the first alive setter of each column, the first
alive unexpired liveness) and the spans of equal hybrid time around them,
exactly as ``storage.cpu_engine.gc_versions`` decides it key by key.

- ``gc_mask_plain``: the counterpart of the JAX ``gc_mask``, in torch ops
  (``scatter_reduce`` segment maxima and minima over ``cumsum`` group and
  span ids), over the union's planes given row by row;
- ``gc_mask_host``: the port's own copy of the JAX numpy twin
  (``reduceat`` segment reductions), which the engine takes for unions of
  at most ``storage.gpu_engine.HOST_GC_MASK_MAX`` rows;
- ``resident_gc_mask``: the wrapper of the CUDA kernel
  ``csrc/compact.cu`` (K11, the counterpart of the JAX
  ``resident_gc_mask``): it reads each union row's planes through ``idx``
  from the runs' resident planes, so only the index vector, the group
  bits and the group starts travel to the card. On CPU tensors it gathers
  the planes and runs ``gc_mask_plain``. ``resident_gc_mask.launches``
  counts launches;
- ``mask_bytes``: the bytes the function must move, for the bound;
- ``tile_rows`` / ``tile_plan`` / ``shared_bytes``: the kernel's tiles of
  union rows (a block owns the key groups that start in its tile and
  stages them in shared memory), mirrored for the tests.

Pad rows (``idx`` < 0) read as the JAX function fills them: hybrid time
and expiry 0, no tombstone, no liveness, no column set; they never
contribute. Not here: encoded resident planes (the JAX function decodes
them inline; ROADMAP.md §1 item 8): the engine passes each run's plain
planes (an encoded run's side-car), pins every run across the launch, and
takes the numpy twin where the runs would not fit the residency budget
together (``_device_gc_fits_budget``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from yugabyte_db_tpu_torch.ops import native

_PAD_ZLO = -(1 << 31)  # low plane of hybrid time 0 (bias-flipped)
_SENTINEL = -(1 << 31)  # no visible tombstone (a real hi plane is >= 0)
MAX_COLS = 256  # value columns one launch takes; csrc/compact.cu kMaxCols
_WARPS = 8  # csrc/compact.cu kWarps
_SHARED_RUNS = 64  # csrc/compact.cu kSharedRuns
# Planes of a run in the kernel's pointer table; each column's set plane
# follows.
_RUN_PLANES = ("ht_hi", "ht_lo", "exp_hi", "exp_lo", "tomb", "live")


def _le2(a_hi, a_lo, b_hi, b_lo):
    return (a_hi < b_hi) | ((a_hi == b_hi) & (a_lo <= b_lo))


def gc_mask_plain(num_cols: int, s: dict, cutoff_planes) -> torch.Tensor:
    """Retention mask over the SORTED union (key asc, hybrid time desc):
    the JAX ``gc_mask`` in torch ops. ``s`` = {new_group, tomb, live: [N]
    bool; ht_hi, ht_lo, exp_hi, exp_lo: [N] int32; set_: [num_cols, N]
    bool}; ``cutoff_planes`` = (cutoff hi, lo, expiry cutoff hi, lo).
    Returns keep[N] bool."""
    ht_hi, ht_lo = s["ht_hi"], s["ht_lo"]
    N = ht_hi.shape[0]
    dev = ht_hi.device
    new_group = s["new_group"]
    gid = torch.cumsum(new_group.to(torch.int64), 0) - 1
    ridx = torch.arange(N, dtype=torch.int64, device=dev)
    c_hi, c_lo, ce_hi, ce_lo = (int(x) for x in cutoff_planes)

    def seg(vals, fill, reduce):
        out = torch.full((N,), fill, dtype=vals.dtype, device=dev)
        return out.scatter_reduce(0, gid, vals, reduce, include_self=True)[gid]

    visible = _le2(ht_hi, ht_lo, c_hi, c_lo)
    vt = visible & s["tomb"]
    t_hi_r = seg(torch.where(vt, ht_hi, _SENTINEL), _SENTINEL, "amax")
    t_lo_r = seg(torch.where(vt & (ht_hi == t_hi_r), ht_lo, _SENTINEL),
                 _SENTINEL, "amax")
    has_tomb = t_hi_r != _SENTINEL
    shadowed = has_tomb & _le2(ht_hi, ht_lo, t_hi_r, t_lo_r)
    alive = visible & ~s["tomb"] & ~shadowed

    imax = torch.iinfo(torch.int64).max
    is_contrib = torch.zeros(N, dtype=torch.bool, device=dev)
    for c in range(num_cols):
        first = seg(torch.where(alive & s["set_"][c], ridx, imax), imax,
                    "amin")
        is_contrib |= first == ridx
    expired = _le2(s["exp_hi"], s["exp_lo"], ce_hi, ce_lo)
    lfirst = seg(torch.where(alive & s["live"] & ~expired, ridx, imax), imax,
                 "amin")
    is_contrib |= lfirst == ridx

    changed = torch.ones(N, dtype=torch.bool, device=dev)
    changed[1:] = (ht_hi[1:] != ht_hi[:-1]) | (ht_lo[1:] != ht_lo[:-1])
    sid = torch.cumsum((new_group | changed).to(torch.int64), 0) - 1
    span = torch.zeros(N, dtype=torch.int32, device=dev).scatter_reduce(
        0, sid, is_contrib.to(torch.int32), "amax", include_self=True)
    kept_contrib = span[sid] > 0
    return ~visible | (kept_contrib & ~_le2(ht_hi, ht_lo, t_hi_r, t_lo_r))


def gc_mask_host(num_cols: int, s, cutoff_planes) -> np.ndarray:
    """Numpy twin of ``gc_mask_plain`` (``reduceat`` segment reductions),
    for unions small enough that the host's vectorized passes cost less
    than a trip to the card. ``s`` as ``gc_mask_plain`` takes it, as
    numpy arrays (``set_`` a list of per-column planes)."""
    ht_hi, ht_lo = s["ht_hi"], s["ht_lo"]
    N = ht_hi.shape[0]
    c_hi, c_lo, ce_hi, ce_lo = (int(x) for x in cutoff_planes)

    def le2s(a_hi, a_lo, b_hi, b_lo):
        return (a_hi < b_hi) | ((a_hi == b_hi) & (a_lo <= b_lo))

    gs_idx = np.flatnonzero(s["new_group"])
    sizes = np.diff(np.append(gs_idx, N))

    def seg_max(vals):
        return np.repeat(np.maximum.reduceat(vals, gs_idx), sizes)

    def seg_min(vals):
        return np.repeat(np.minimum.reduceat(vals, gs_idx), sizes)

    visible = le2s(ht_hi, ht_lo, c_hi, c_lo)
    sentinel = np.int32(_SENTINEL)
    vt = visible & s["tomb"]
    t_hi_r = seg_max(np.where(vt, ht_hi, sentinel))
    t_lo_r = seg_max(np.where(vt & (ht_hi == t_hi_r), ht_lo, sentinel))
    has_tomb = t_hi_r != sentinel
    shadowed = has_tomb & le2s(ht_hi, ht_lo, t_hi_r, t_lo_r)
    alive = visible & ~s["tomb"] & ~shadowed

    ridx = np.arange(N, dtype=np.int64)
    imax = np.int64(np.iinfo(np.int64).max)
    is_contrib = np.zeros(N, dtype=bool)
    for c in range(num_cols):
        first = seg_min(np.where(alive & s["set_"][c], ridx, imax))
        is_contrib |= first == ridx
    expired = le2s(s["exp_hi"], s["exp_lo"], ce_hi, ce_lo)
    lfirst = seg_min(np.where(alive & s["live"] & ~expired, ridx, imax))
    is_contrib |= lfirst == ridx

    new_span = s["new_group"] | np.concatenate(
        [[True], (ht_hi[1:] != ht_hi[:-1]) | (ht_lo[1:] != ht_lo[:-1])])
    span_idx = np.flatnonzero(new_span)
    span_sizes = np.diff(np.append(span_idx, N))
    kept_contrib = np.repeat(
        np.maximum.reduceat(is_contrib.astype(np.int8), span_idx),
        span_sizes) > 0
    return ~visible | (kept_contrib & ~le2s(ht_hi, ht_lo, t_hi_r, t_lo_r))


def gather_union(runs_planes, idx: torch.Tensor) -> dict:
    """The union's planes row by row (``gc_mask_plain``'s ``s`` without
    ``new_group``): each row's planes read through ``idx`` from the
    concatenation of the runs' flattened planes, pad rows (``idx`` < 0)
    filled as the JAX function fills them."""
    pads = idx < 0
    safe = idx.clamp(min=0).to(torch.int64)

    def take(planes, fill):
        cat = torch.cat([p.reshape(-1) for p in planes])
        return torch.where(pads, torch.tensor(fill, dtype=cat.dtype,
                                              device=cat.device), cat[safe])

    s = {name: take([r[name] for r in runs_planes], fill)
         for name, fill in (("ht_hi", 0), ("ht_lo", _PAD_ZLO),
                            ("exp_hi", 0), ("exp_lo", _PAD_ZLO),
                            ("tomb", False), ("live", False))}
    num_cols = len(runs_planes[0]["sets"])
    s["set_"] = (torch.stack([take([r["sets"][c] for r in runs_planes],
                                   False) for c in range(num_cols)])
                 if num_cols else torch.zeros((0, idx.shape[0]),
                                              dtype=torch.bool,
                                              device=idx.device))
    return s


def _check(runs_planes, idx, new_group, group_starts) -> torch.device:
    device = idx.device
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise ValueError(f"idx: {idx.dtype} {tuple(idx.shape)}, want [N] "
                         "int32")
    N = idx.shape[0]
    if new_group.dtype != torch.bool or tuple(new_group.shape) != (N,):
        raise ValueError(f"new_group: {new_group.dtype} "
                         f"{tuple(new_group.shape)}, want [{N}] bool")
    if group_starts.dtype != torch.int32 or group_starts.dim() != 1:
        raise ValueError("group_starts: want [G] int32")
    if not runs_planes:
        raise ValueError("no runs")
    num_cols = len(runs_planes[0]["sets"])
    if num_cols > MAX_COLS:
        raise ValueError(f"{num_cols} value columns; the kernel takes "
                         f"{MAX_COLS}")
    total = 0
    for r in runs_planes:
        shape = tuple(r["tomb"].shape)
        want = {"ht_hi": torch.int32, "ht_lo": torch.int32,
                "exp_hi": torch.int32, "exp_lo": torch.int32,
                "tomb": torch.bool, "live": torch.bool}
        planes = [(name, r[name], dt) for name, dt in want.items()]
        if len(r["sets"]) != num_cols:
            raise ValueError("runs differ in their column count")
        planes += [(f"set {c}", t, torch.bool) for c, t in
                   enumerate(r["sets"])]
        for name, t, dt in planes:
            if t.device != device or t.dtype != dt or \
                    not t.is_contiguous() or tuple(t.shape) != shape:
                raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on "
                                 f"{t.device}, want contiguous {dt} "
                                 f"{shape} on {device}")
        total += r["tomb"].numel()
    if total >= (1 << 31):
        raise ValueError("the runs hold 2^31 rows or more")
    for name, t in (("new_group", new_group), ("group_starts",
                                               group_starts)):
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{name} on {t.device}, idx on {device}")
    return device


def resident_gc_mask(runs_planes, idx: torch.Tensor,
                     new_group: torch.Tensor, group_starts: torch.Tensor,
                     cutoff_planes) -> torch.Tensor:
    """keep[N] of the sorted union whose row i is flat row ``idx[i]`` of
    the concatenation of the runs' flattened planes (-1: a pad row).

    ``runs_planes``: one dict a run of its resident [B, R] planes
    {ht_hi, ht_lo, exp_hi, exp_lo (int32), tomb, live (bool), sets: tuple
    of each value column's set plane}; ``new_group`` [N] bool, True at
    each key group's first row (row 0 included); ``group_starts`` [G]
    int32, the rows where ``new_group`` is True, in order (the host has
    them); ``cutoff_planes``: (cutoff hi, lo, expiry cutoff hi, lo).
    Launches K11 for CUDA tensors, runs the plain version for CPU
    tensors, raises for anything else."""
    device = _check(runs_planes, idx, new_group, group_starts)
    num_cols = len(runs_planes[0]["sets"])
    if device.type == "cpu":
        s = gather_union(runs_planes, idx)
        s["new_group"] = new_group
        return gc_mask_plain(num_cols, s, cutoff_planes)
    if device.type != "cuda":
        raise ValueError(f"resident_gc_mask runs on cuda or cpu, not {device}")
    keep = torch.empty(idx.shape[0], dtype=torch.bool, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        launch(_library(), runs_planes, idx, group_starts, cutoff_planes,
               keep, stream)
    resident_gc_mask.launches += 1
    return keep


# Kernel launches since the count was last set to 0.
resident_gc_mask.launches = 0


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    return bind(native.load_library("compact"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with the argument and result types of the kernel's C
    interface set."""
    lib.gc_mask_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.gc_mask_launch.restype = ctypes.c_int
    lib.gc_mask_error_string.argtypes = [ctypes.c_int]
    lib.gc_mask_error_string.restype = ctypes.c_char_p
    return lib


def launch(lib: ctypes.CDLL, runs_planes, idx, group_starts,
           cutoff_planes, keep, stream: int) -> None:
    """One launch of ``lib``'s ``gc_mask_launch`` (a bound library of
    ``csrc/compact.cu``'s C interface) on ``stream``, writing ``keep``;
    raises on a refused launch. The runs' plane pointers and flat offsets
    go in a descriptor tensor beside ``idx``."""
    N = idx.shape[0]
    if N == 0:
        return
    table, offsets, off = [], [], 0
    for r in runs_planes:
        table += [r[name].data_ptr() for name in _RUN_PLANES]
        table += [t.data_ptr() for t in r["sets"]]
        offsets.append(off)
        off += r["tomb"].numel()
    offsets.append(off)
    desc = torch.tensor(table + offsets, dtype=torch.int64)
    if idx.is_cuda:  # from pinned memory: the copy does not wait
        desc = desc.pin_memory().to(idx.device, non_blocking=True)
    c_hi, c_lo, ce_hi, ce_lo = (int(x) for x in cutoff_planes)
    rc = lib.gc_mask_launch(
        ctypes.c_void_p(desc.data_ptr()), len(runs_planes),
        len(runs_planes[0]["sets"]), ctypes.c_void_p(idx.data_ptr()),
        ctypes.c_void_p(group_starts.data_ptr()), group_starts.shape[0], N,
        c_hi, c_lo, ce_hi, ce_lo, ctypes.c_void_p(keep.data_ptr()),
        ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"gc_mask kernel launch failed ({rc}): "
                           f"{lib.gc_mask_error_string(rc).decode()}")


def tile_rows(num_cols: int) -> tuple:
    """(union rows a tile, union rows a block stages) of
    ``csrc/compact.cu`` at ``num_cols`` value columns."""
    tile = 2048 if num_cols <= 32 else 1024
    return tile, tile * 3 // 2


def tile_plan(group_starts: np.ndarray, N: int, num_cols: int) -> list:
    """The kernel's blocks over a union of N rows: for each, ``(ga, gb,
    lo, staged)``: it owns the key groups [ga, gb), those whose first row
    lies in its tile, and stages union rows [lo, lo + staged) (its groups'
    rows, at most ``tile_rows(num_cols)[1]``; a group's rows past them are
    read from the runs). A block that owns no group has gb == ga."""
    tile, cap = tile_rows(num_cols)
    starts = np.asarray(group_starts, dtype=np.int64)
    out = []
    for t0 in range(0, N, tile):
        ga, gb = (int(x) for x in np.searchsorted(
            starts, [t0, min(t0 + tile, N)], side="left"))
        if ga == gb:
            out.append((ga, gb, 0, 0))
            continue
        lo = int(starts[ga])
        hi = int(starts[gb]) if gb < starts.size else N
        out.append((ga, gb, lo, min(cap, hi - lo)))
    return out


def shared_bytes(num_cols: int, n_runs: int) -> int:
    """Dynamic shared memory of a block of ``csrc/compact.cu``: each staged
    row's key (8), set words (4 a 32 columns), flag and keep bytes; the run
    offsets (8 a run, up to 64 runs); each warp's contributor spans."""
    _tile, cap = tile_rows(num_cols)
    words = (num_cols + 31) // 32
    offs = 8 * (n_runs + 1) if n_runs <= _SHARED_RUNS else 0
    return cap * (8 + 4 * words + 2) + offs + 4 * _WARPS * 2 * (num_cols + 1)


def mask_bytes(num_cols: int, N: int, n_groups: int) -> int:
    """Bytes the function must move for a union of N rows in ``n_groups``
    key groups: each row's index (4), hybrid time and expiry (16),
    tombstone, liveness and set flags (1 each) read once, each group's
    start (4) read once, and each row's keep flag written once."""
    return N * (4 + 16 + 2 + num_cols + 1) + 4 * n_groups
