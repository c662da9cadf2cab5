"""The mesh scans' kernels: K14's cross-piece combine and the stack's
slot update, each a CUDA kernel (``csrc/mesh.cu``) with its plain PyTorch
version.

Counterparts of the JAX package's ``parallel/sharded.py`` collectives and
update program:

- ``combine``: K14's combine (``_combine_across_mesh`` :399,
  ``_lex_collective_ext`` :389: a psum and a two-step lexicographic pmax
  over the ("t", "b") mesh). The port folds each piece of a stack (one
  tablet's b-shard) with K5 into one packed accumulator row
  (``agg_fold.pack``'s layout), and ``combine`` reduces the S rows ([S, I]
  int32, [S, F] float32) to one: int64 [I] (the same layout, wider words)
  and float32 [F]. Counts, ``n``, rows scanned and the Kahan pair's two
  words are sums; digit vectors are summed in int64 and carry-normalised
  (``carry``); i32 and f32 extremes are max or min; i64 and f64 extremes
  take the two-plane lexicographic step. ``combine_items`` lays the
  fields out as the kernel's items;
- ``stack_update``: ``_compiled_stack_update`` :479 (tablet t's slot of
  every leaf written with ``dynamic_update_slice``, the source cast as
  ``s.astype(d.dtype)``). It takes a list of entries, each (destination
  range, source range or None, fill value), as ``ShardedTablets`` makes
  them, and writes them all in one launch (``update_entries`` the table,
  ``update_table`` its upload, ``launch_update`` the launch).

On CUDA tensors each wrapper launches its kernel (or raises); on CPU
tensors it runs the plain version (``combine_plain``,
``stack_update_plain``). ``combine.launches`` and ``stack_update.launches``
count launches. ``combine_bytes`` / ``update_bytes`` give the bytes each
function must move, for the bound; ``launch_geometry`` / ``last_launch``
the launch's shape.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from yugabyte_db_tpu_torch.ops import agg_fold, native
from yugabyte_db_tpu_torch.ops.scan import I32_MAX, I32_MIN

# Item ops of csrc/mesh.cu: a field of the packed row and how it combines.
SUM, DIGITS, MAX, MIN, LEX_MAX, LEX_MIN, FSUM, FMAX, FMIN = range(9)
_FLOAT_OPS = (FSUM, FMAX, FMIN)
ITEM_WORDS = 2   # op, offset (kItemWords)
ENTRY_WORDS = 6  # dst, src, count, dst type, src type, fill (kEntryWords)
COMBINE_THREADS = 128
UPDATE_THREADS = 256
MAX_ENTRIES = 65535  # grid.y
MAX_GRID_X = 1024    # blocks an entry of the update at most
# Element types of the update's entries (csrc/mesh.cu Type).
TYPE_CODES = {torch.bool: 0, torch.int32: 1, torch.float32: 2, torch.int16: 3}
GEOMETRY = ("kernel", "blocks_x", "blocks_y", "threads")


@functools.lru_cache(maxsize=256)
def combine_items(aggs: tuple) -> tuple:
    """((op, offset), ...) of the packed layout of ``aggs`` (``AggSig``s,
    ``agg_fold.pack``'s order): offsets index the int32 row for the
    integer ops and the float32 row for the float ones."""
    items = [(SUM, 0)]  # rows scanned
    ii, fi = 1, 0
    for ag in aggs:
        if ag.fn == "count":
            items.append((SUM, ii))
            ii += 1
        elif ag.fn == "sum":
            if ag.kind in ("f32", "f64"):
                items += [(FSUM, fi), (FSUM, fi + 1), (SUM, ii)]
                fi, ii = fi + 2, ii + 1
            else:
                items += [(DIGITS, ii), (SUM, ii + agg_fold.DIGITS)]
                ii += agg_fold.DIGITS + 1
        else:
            is_max = ag.fn == "max"
            if ag.kind == "f32":
                items += [(FMAX if is_max else FMIN, fi), (SUM, ii)]
                fi, ii = fi + 1, ii + 1
            elif ag.kind == "i32":
                items += [(MAX if is_max else MIN, ii), (SUM, ii + 1)]
                ii += 2
            else:
                items += [(LEX_MAX if is_max else LEX_MIN, ii), (SUM, ii + 2)]
                ii += 3
    return tuple(items)


@functools.lru_cache(maxsize=256)
def _item_table(aggs: tuple, device: torch.device) -> torch.Tensor:
    """``combine_items(aggs)`` as the kernel reads it, int32 on
    ``device``, uploaded once a signature and device."""
    return torch.tensor([w for it in combine_items(aggs) for w in it],
                        dtype=torch.int32, device=device)


def packed_widths(aggs: tuple) -> tuple:
    """(I, F): the words of ``aggs``' packed int32 and float32 rows."""
    ni, nf = 1, 0
    for op, off in combine_items(aggs):
        width = {DIGITS: agg_fold.DIGITS, LEX_MAX: 2, LEX_MIN: 2}.get(op, 1)
        if op in _FLOAT_OPS:
            nf = max(nf, off + 1)
        else:
            ni = max(ni, off + width)
    return ni, nf


def carry(digits: list) -> list:
    """A digit vector's sums (Python ints) carry-normalised as the kernel
    does: digits 0..6 keep their low 16 bits, the last takes the rest."""
    out, c = [], 0
    for d in digits[:-1]:
        v = int(d) + c
        out.append(v & 0xFFFF)
        c = v >> 16
    return out + [int(digits[-1]) + c]


def combine_plain(aggs: tuple, ivec: torch.Tensor,
                  fvec: torch.Tensor) -> tuple:
    """The kernel's function in torch ops over S packed rows (``ivec``
    [S, I] int32, ``fvec`` [S, F] float32): (int64 [I], float32 [F]) on
    their device. Float sums add the rows in order, one float32 rounding
    an add, as the kernel does."""
    device = ivec.device
    I, F = ivec.shape[1], fvec.shape[1]
    out_i = torch.zeros(I, dtype=torch.int64, device=device)
    out_f = torch.zeros(F, dtype=torch.float32, device=device)
    wide = ivec.to(torch.int64)
    for op, off in combine_items(aggs):
        if op == SUM:
            out_i[off] = wide[:, off].sum()
        elif op == DIGITS:
            sums = wide[:, off:off + agg_fold.DIGITS].sum(0).tolist()
            out_i[off:off + agg_fold.DIGITS] = torch.tensor(
                carry(sums), dtype=torch.int64)
        elif op in (MAX, MIN):
            col = ivec[:, off]
            out_i[off] = col.amax() if op == MAX else col.amin()
        elif op in (LEX_MAX, LEX_MIN):
            is_max = op == LEX_MAX
            hi, lo = ivec[:, off], ivec[:, off + 1]
            mhi = hi.amax() if is_max else hi.amin()
            masked = torch.where(hi == mhi, lo, torch.tensor(
                int(I32_MIN if is_max else I32_MAX), dtype=torch.int32,
                device=device))
            out_i[off] = mhi
            out_i[off + 1] = masked.amax() if is_max else masked.amin()
        elif op == FSUM:
            acc = torch.zeros((), dtype=torch.float32, device=device)
            for s in range(fvec.shape[0]):
                acc = acc + fvec[s, off]
            out_f[off] = acc
        else:
            col = fvec[:, off]
            out_f[off] = col.amax() if op == FMAX else col.amin()
    return out_i, out_f


def _check_combine(aggs: tuple, ivec: torch.Tensor,
                   fvec: torch.Tensor) -> None:
    I, F = packed_widths(aggs)
    if ivec.dtype != torch.int32 or ivec.dim() != 2 or ivec.shape[1] != I:
        raise ValueError(f"ivec {ivec.dtype} {tuple(ivec.shape)}: want int32 "
                         f"[S, {I}]")
    if fvec.dtype != torch.float32 or fvec.dim() != 2 or \
            tuple(fvec.shape) != (ivec.shape[0], F):
        raise ValueError(f"fvec {fvec.dtype} {tuple(fvec.shape)}: want "
                         f"float32 [{ivec.shape[0]}, {F}]")
    if ivec.shape[0] < 1:
        raise ValueError("no packed row to combine")
    if fvec.device != ivec.device or not ivec.is_contiguous() or \
            not fvec.is_contiguous():
        raise ValueError("ivec and fvec must be contiguous on one device")


def combine(aggs: tuple, ivec: torch.Tensor, fvec: torch.Tensor) -> tuple:
    """K14's combine of S packed rows (``ivec`` [S, I] int32, ``fvec``
    [S, F] float32, one device) into (int64 [I], float32 [F]). Launches
    the CUDA kernel for CUDA tensors, runs ``combine_plain`` for CPU
    tensors, and raises for anything else."""
    aggs = tuple(aggs)
    _check_combine(aggs, ivec, fvec)
    device = ivec.device
    if device.type == "cpu":
        return combine_plain(aggs, ivec, fvec)
    if device.type != "cuda":
        raise ValueError(f"combine runs on cuda or cpu, not {device}")
    items = combine_items(aggs)
    table = _item_table(aggs, device)
    I, F = ivec.shape[1], fvec.shape[1]
    out_i = torch.empty(I, dtype=torch.int64, device=device)
    out_f = torch.empty(max(F, 1), dtype=torch.float32, device=device)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.mesh_combine_launch(
            ctypes.c_void_p(table.data_ptr()), len(items),
            ctypes.c_void_p(ivec.data_ptr()), I,
            ctypes.c_void_p(fvec.data_ptr() if F else 0), F, ivec.shape[0],
            ctypes.c_void_p(out_i.data_ptr()),
            ctypes.c_void_p(out_f.data_ptr()), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"mesh_combine kernel launch failed ({rc}): "
                           f"{lib.mesh_error_string(rc).decode()}")
    combine.launches += 1
    return out_i, out_f[:F]


# Kernel launches since the count was last set to 0.
combine.launches = 0


def combine_bytes(aggs: tuple, S: int) -> int:
    """Bytes the combine must move: S packed rows read, one written (int64
    words and float32 words), and the item table."""
    I, F = packed_widths(tuple(aggs))
    return S * 4 * (I + F) + 8 * I + 4 * F + \
        4 * ITEM_WORDS * len(combine_items(tuple(aggs)))


# -- the slot update --------------------------------------------------------

def _check_entries(entries: list) -> torch.device:
    if not entries:
        raise ValueError("no entry to write")
    if len(entries) > MAX_ENTRIES:
        raise ValueError(f"{len(entries)} entries: one launch takes at most "
                         f"{MAX_ENTRIES}")
    device = entries[0][0].device
    for dst, src, fill in entries:
        if dst.device != device or not dst.is_contiguous() or \
                dst.dtype not in TYPE_CODES:
            raise ValueError(f"destination {dst.dtype} on {dst.device}: want "
                             f"a contiguous bool, int32, float32 or int16 "
                             f"range on {device}")
        if src is None:
            if not isinstance(fill, int):
                raise ValueError(f"a fill entry's value is an int, not "
                                 f"{fill!r}")
            continue
        if src.device != device or not src.is_contiguous() or \
                src.dtype not in TYPE_CODES:
            raise ValueError(f"source {src.dtype} on {src.device}: want a "
                             f"contiguous bool, int32, float32 or int16 "
                             f"range on {device}")
        if src.numel() != dst.numel():
            raise ValueError(f"source of {src.numel()} elements for a "
                             f"destination of {dst.numel()}")
    return device


def update_entries(entries: list) -> list:
    """The kernel's entry table: per entry (destination address, source
    address or 0, elements, destination type, source type, fill)."""
    out = []
    for dst, src, fill in entries:
        code = TYPE_CODES[dst.dtype]
        out += [dst.data_ptr(), 0 if src is None else src.data_ptr(),
                dst.numel(), code,
                code if src is None else TYPE_CODES[src.dtype],
                int(fill or 0)]
    return out


def launch_geometry(entries: list) -> dict:
    """The update's launch shape: an entry a row of blocks (grid.y), each
    row ``blocks_x`` blocks of UPDATE_THREADS threads, enough for the
    largest entry at 16 bytes a thread (at most MAX_GRID_X)."""
    most = max(dst.numel() * dst.element_size() for dst, _s, _f in entries)
    blocks_x = max(1, min(MAX_GRID_X, -(-most // (16 * UPDATE_THREADS))))
    return {"kernel": 1, "blocks_x": blocks_x, "blocks_y": len(entries),
            "threads": UPDATE_THREADS}


def stack_update_plain(entries: list) -> None:
    """The kernel's function in torch ops: each destination range takes
    its source (``copy_`` casts as ``astype`` does) or its fill value."""
    for dst, src, fill in entries:
        if src is None:
            dst.fill_(fill)
        else:
            dst.copy_(src)


def update_table(entries: list, device: torch.device) -> torch.Tensor:
    """``update_entries(entries)`` as the kernel reads it, int64 on
    ``device``: one upload from pinned memory, not waited for."""
    return torch.tensor(update_entries(entries), dtype=torch.int64
                        ).pin_memory().to(device, non_blocking=True)


def launch_update(table: torch.Tensor, n_entries: int, blocks_x: int) -> None:
    """One launch of the update kernel over an ``update_table`` of
    ``n_entries`` entries on its card, ``blocks_x`` blocks an entry
    (``launch_geometry``)."""
    device = table.device
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.stack_update_launch(ctypes.c_void_p(table.data_ptr()),
                                     n_entries, blocks_x,
                                     ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"stack_update kernel launch failed ({rc}): "
                           f"{lib.mesh_error_string(rc).decode()}")
    stack_update.launches += 1


def stack_update(entries: list) -> None:
    """Write every entry ``(dst, src, fill)`` (``dst`` a contiguous range
    of a stack's leaf; ``src`` a contiguous range of as many elements, or
    None to write ``fill``) in one launch for CUDA tensors, with
    ``stack_update_plain`` for CPU tensors; raises for anything else."""
    device = _check_entries(entries)
    if device.type == "cpu":
        stack_update_plain(entries)
        return
    if device.type != "cuda":
        raise ValueError(f"stack_update runs on cuda or cpu, not {device}")
    launch_update(update_table(entries, device), len(entries),
                  launch_geometry(entries)["blocks_x"])


# Kernel launches since the count was last set to 0.
stack_update.launches = 0


def update_bytes(entries: list) -> int:
    """Bytes the update must move: each source range read once, each
    destination range written once, and the entry table."""
    total = 8 * ENTRY_WORDS * len(entries)
    for dst, src, _fill in entries:
        total += dst.numel() * dst.element_size()
        if src is not None:
            total += src.numel() * src.element_size()
    return total


def last_launch() -> dict:
    """The shape of this process's last launch of either kernel as the
    library reports it (``GEOMETRY``: kernel 0 the combine, 1 the
    update)."""
    lib = _library()
    out = (ctypes.c_int32 * len(GEOMETRY))()
    lib.mesh_last_launch(out)
    return dict(zip(GEOMETRY, out))


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    return bind(native.load_library("mesh"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with the argument and result types of the kernels' C
    interfaces set."""
    I, P = ctypes.c_int, ctypes.c_void_p
    lib.mesh_combine_launch.argtypes = [P, I, P, I, P, I, I, P, P, P]
    lib.mesh_combine_launch.restype = I
    lib.stack_update_launch.argtypes = [P, I, I, P]
    lib.stack_update_launch.restype = I
    lib.mesh_item_words.argtypes = []
    lib.mesh_item_words.restype = I
    lib.mesh_entry_words.argtypes = []
    lib.mesh_entry_words.restype = I
    lib.mesh_last_launch.argtypes = [ctypes.POINTER(ctypes.c_int32)]
    lib.mesh_last_launch.restype = None
    lib.mesh_error_string.argtypes = [I]
    lib.mesh_error_string.restype = ctypes.c_char_p
    if (lib.mesh_item_words(), lib.mesh_entry_words()) != (ITEM_WORDS,
                                                           ENTRY_WORDS):
        raise RuntimeError("csrc/mesh.cu's tables differ from ops/mesh.py's")
    return lib
