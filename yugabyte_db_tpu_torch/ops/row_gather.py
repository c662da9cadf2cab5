"""The row path's kernels: K7, the packed row gather, and K9, the
candidate scan, each a CUDA kernel (``csrc/row_gather.cu``) with its
plain PyTorch version.

Counterpart of the JAX package's ``ops/row_gather.py`` (``gather_rows``,
vmapped over G pages by ``compiled_gather_batch``) and of the row-scan
form of its ``ops/scan.py`` ``scan_window`` (``compiled_scan``). Both
resolve K-block windows of a run at a read point (``ops.scan``'s
``resolve_windows``) and give the JAX programs' buffers int for int.

- K7 (``gather_rows``): one launch for G pages. Each page walks its
  windows in key order and compacts its matches (group start row plus
  each output column's setter planes, NULL flag and, with ``want_idx``,
  setter row) into an int32 ``[M + 1, W]`` buffer whose last row is
  ``[count, scanned, w_end]``: ``count`` sums every match of the windows
  walked (not capped at M: the host reads ``count > M`` as overflow),
  ``scanned`` the groups that exist in range before predicates at or
  past ``scan_from``, ``w_end`` the first window not walked; a page stops
  after the window in which ``count`` reached M. ``packed=False``
  (chunks mode) emits one whole window in place, each group at its
  group id with start -1 where it does not match.
- K9 (``scan_candidates``): the match flags, first rows and group counts
  of a range of windows of one run in one launch, predicates applied or
  not (``apply_preds``).

On CUDA tensors each wrapper launches its kernel (or raises); on CPU
tensors it runs the plain version (``gather_rows_plain``,
``scan_candidates_plain``). ``gather_rows.launches`` and
``scan_candidates.launches`` count launches. ``gather_bytes`` /
``candidates_bytes`` give the bytes each function must move, for the
bound. Both kernels run a window as a thread block cluster, one block a
run block, each staging its run block in shared memory;
``launch_geometry`` gives a launch's shape.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from yugabyte_db_tpu_torch.ops import decode, encodings, native
from yugabyte_db_tpu_torch.ops.scan import I32_MAX, resolve_windows

# Fixed slots at the head of the int32 params row; predicate literal
# planes follow from PARAM_FIXED onward (layout per GatherSig.preds).
# scan_from: rows below it are excluded from the rows_scanned statistic
# (but not from results): continuation rounds re-scan part of an already
# counted window and must not count it twice.
PARAM_FIXED = 9  # w_first, w_last, row_lo, row_hi, r_hi, r_lo, e_hi, e_lo,
                 # scan_from
# Descriptor limits and codes; csrc/row_gather.cu holds the same.
MAX_COLS = 16
MAX_PREDS = 16
MAX_OUT = 16
# The launch geometry (csrc/row_gather.cu's kMaxCluster, kPieceMax,
# kHeadBytes): blocks a cluster, rows a block stages at once, and the
# bytes of shared memory before the staged rows.
CLUSTER_MAX = 8
PIECE_MAX = 2048
HEAD_BYTES = 512
SHARED_LIMIT = 232_448  # shared memory a block can have on Hopper (227 KB)
KIND_CODES = {"i32": 0, "i64": 1, "f64": 2, "str": 3, "f32": 4}
OP_CODES = {"=": 0, "!=": 1, "<": 2, "<=": 3, ">": 4, ">=": 5}
_RUN_PLANES = ("valid", "group_start", "tomb", "live", "ht_hi", "ht_lo",
               "exp_hi", "exp_lo")


@dataclass(frozen=True)
class OutCol:
    col_id: int
    planes: int      # cmp-plane count (1 or 2)
    want_idx: bool   # fetch-by-index column: emit the setter's global row


@dataclass(frozen=True)
class GatherSig:
    """Static shape of one gather (the JAX package's ``GatherSig``)."""

    B: int            # blocks in run (padded)
    R: int            # rows per block
    K: int            # blocks per window
    M: int            # output capacity (rows)
    cols: tuple       # tuple[ColSig]: every column the resolve touches
    preds: tuple      # tuple[PredSig]
    apply_preds: bool
    out_cols: tuple   # tuple[OutCol]
    flat: bool = False  # single-version-per-key run (see ScanSig.flat)
    packed: bool = True  # True: compacted pages walking windows; False:
                         # one whole window emitted in place (start = -1
                         # marks non-matches; the host compacts)


def out_layout(sig: GatherSig):
    """Column layout of the packed [M+1, W] output matrix.

    Row m < M: [start | per out col: cmp planes.., null, (idx)].
    Row M:     [count, scanned, w_end, 0...].
    Returns (W, {col_id: (cmp_off, null_off, idx_off|None)}).
    """
    off = 1
    cols = {}
    for oc in sig.out_cols:
        idx_off = off + oc.planes + 1 if oc.want_idx else None
        cols[oc.col_id] = (off, off + oc.planes, idx_off)
        off += oc.planes + 1 + (1 if oc.want_idx else 0)
    return max(off, 3), cols


def launch_geometry(sig, G: int) -> dict:
    """The shape of one launch of K7 over ``G`` pages (or of K9 over ``G``
    windows) for ``sig`` (a ``GatherSig`` or a row-scan ``ScanSig``), as
    ``csrc/row_gather.cu`` makes it: a cluster of ``cluster`` blocks a
    window, block rank r taking run blocks [r * run_blocks_per_block, ...)
    of it in order; each block stages ``piece_rows`` rows at a time
    (``pieces_per_run_block`` pieces a run block) in ``shared_bytes`` of
    dynamic shared memory: the head, then a byte a row of each flag plane,
    the answer byte, 16 bytes of hybrid time and expiry, and a set and an
    isnull byte a column."""
    cluster = min(sig.K, CLUSTER_MAX)
    piece = min(sig.R, PIECE_MAX)
    shared = HEAD_BYTES + piece * (21 + 2 * len(sig.cols))
    return {"cluster": cluster, "blocks": G * cluster,
            "run_blocks_per_block": -(-sig.K // cluster),
            "piece_rows": piece, "pieces_per_run_block": -(-sig.R // piece),
            "shared_bytes": -(-shared // 16) * 16}


def last_launch() -> dict:
    """The shape of this process's last K7 or K9 launch as the library
    reports it (``launch_geometry``'s keys): what ``launch_geometry``
    mirrors, read from the launch itself."""
    lib = _library()
    lib.row_gather_last_launch.argtypes = [ctypes.POINTER(ctypes.c_int32)]
    lib.row_gather_last_launch.restype = None
    out = (ctypes.c_int32 * 6)()
    lib.row_gather_last_launch(out)
    return dict(zip(("cluster", "blocks", "run_blocks_per_block",
                     "piece_rows", "pieces_per_run_block", "shared_bytes"),
                    out))


def pack_params(w_first, w_last, row_lo, row_hi, read_planes, int_lits,
                f32_lits, scan_from=None):
    """One page's params row -> (i32[P], f32[F]) numpy arrays."""
    iparams = np.array(
        [w_first, w_last, row_lo, row_hi, *read_planes,
         row_lo if scan_from is None else scan_from, *int_lits],
        dtype=np.int32)
    fparams = np.array(f32_lits if f32_lits else [0.0], dtype=np.float32)
    return iparams, fparams


def _unpack_literals(sig, iparams: torch.Tensor, fparams: torch.Tensor):
    """Each predicate's literal column of [G, P] / [G, F] params: [G]
    (i32, f32) or [G, 2]."""
    off, foff = PARAM_FIXED, 0
    lits = []
    for ps in sig.preds:
        if ps.kind == "f32":
            lits.append(fparams[:, foff])
            foff += 1
        elif ps.kind in ("i32", "code"):
            lits.append(iparams[:, off])
            off += 1
        else:
            lits.append(iparams[:, off:off + 2])
            off += 2
    return tuple(lits)


def _window_parts(sig, r: dict, base: torch.Tensor, m: torch.Tensor):
    """Per-group output rows [G, N, W]: start (or -1 for a non-match) and
    each out col's value planes / null / setter row."""
    W, _ = out_layout(sig)
    base = base[:, None]
    parts = [torch.where(m, base + r["start_idx"], -1)[..., None]]
    for oc in sig.out_cols:
        cid = oc.col_id
        idx = r["col_idx"][cid]
        notnull = r["col_notnull"][cid]
        cmp = r["cmp_w"][cid][..., :oc.planes].to(torch.int64)
        if not sig.flat:
            cmp = torch.gather(cmp, 1, idx[..., None].expand(-1, -1,
                                                              oc.planes))
        parts.append(cmp)
        parts.append((~notnull).to(torch.int64)[..., None])
        if oc.want_idx:
            parts.append(torch.where(notnull, base + idx, -1)[..., None])
    vals = torch.cat(parts, dim=2)
    if vals.shape[2] < W:
        vals = torch.nn.functional.pad(vals, (0, W - vals.shape[2]))
    return vals.to(torch.int32)


def _resolve_pages(sig, run, ip, lits, w):
    """Resolve window ``w`` [A] of each page of ``ip`` [A, P]: (r, base,
    match mask, counted mask), the JAX program's ``resolve``."""
    K, R = sig.K, sig.R
    b0 = w * K
    base = b0 * R
    r = resolve_windows(sig, run, b0, ip[:, 2] - base, ip[:, 3] - base,
                        ip[:, 4:8], lits)
    gvalid = r["ridx"] < r["num_groups"][:, None]
    m = r["result"] & gvalid
    pre = (r["pre_pred"] & gvalid
           & (r["start_idx"] >= (ip[:, 8] - base)[:, None]))
    return r, base, m, pre


def gather_rows_plain(sig: GatherSig, run: dict, iparams: torch.Tensor,
                      fparams: torch.Tensor) -> torch.Tensor:
    """K7's function in torch ops over G pages (``iparams`` [G, P] int32,
    ``fparams`` [G, F] float32, on the run's device): i32 [G, M+1, W],
    the JAX ``compiled_gather_batch``'s buffer exactly. Every page walks
    its next window in one batched resolve a step."""
    M = sig.M
    W, _ = out_layout(sig)
    ip = iparams.to(torch.int64)
    lits = _unpack_literals(sig, ip, fparams)
    G = ip.shape[0]
    device = ip.device
    if not sig.packed:
        r, base, m, pre = _resolve_pages(sig, run, ip, lits, ip[:, 0])
        tail = torch.zeros((G, 1, W), dtype=torch.int32, device=device)
        tail[:, 0, 0] = m.sum(1).to(torch.int32)
        tail[:, 0, 1] = pre.sum(1).to(torch.int32)
        tail[:, 0, 2] = (ip[:, 0] + 1).to(torch.int32)
        return torch.cat([_window_parts(sig, r, base, m), tail], dim=1)
    buf = torch.zeros((G, M + 1, W), dtype=torch.int32, device=device)
    w = ip[:, 0].clone()
    count = torch.zeros(G, dtype=torch.int64, device=device)
    scanned = torch.zeros(G, dtype=torch.int64, device=device)
    while True:
        act = torch.nonzero((w <= ip[:, 1]) & (count < M))[:, 0]
        if act.numel() == 0:
            break
        r, base, m, pre = _resolve_pages(
            sig, run, ip[act], tuple(x[act] for x in lits), w[act])
        # The first M matches in key order: each match's rank among the
        # page's matches so far.
        pos = count[act][:, None] + torch.cumsum(m.to(torch.int64), 1) - 1
        pi, gi = torch.nonzero(m & (pos < M), as_tuple=True)
        buf[act[pi], pos[pi, gi]] = _window_parts(sig, r, base, m)[pi, gi]
        count[act] += m.sum(1)
        scanned[act] += pre.sum(1)
        w[act] += 1
    buf[:, M, 0] = count.to(torch.int32)
    buf[:, M, 1] = scanned.to(torch.int32)
    buf[:, M, 2] = w.to(torch.int32)
    return buf


def scan_candidates_plain(sig, run: dict, iparams: torch.Tensor,
                          fparams: torch.Tensor, n_windows: int) -> tuple:
    """K9's function in torch ops: the row-scan ``scan_window`` of the
    ``n_windows`` windows from ``iparams[0]`` (one params row, [P] / [F],
    on the run's device; ``row_lo`` / ``row_hi`` global) ->
    (result bool [n, N], start_idx int32 [n, N], num_groups int32 [n])."""
    K, R = sig.K, sig.R
    ip = iparams.to(torch.int64)[None, :].expand(n_windows, -1)
    w = ip[:, 0] + torch.arange(n_windows, device=ip.device)
    base = w * K * R
    r = resolve_windows(sig, run, w * K, ip[:, 2] - base, ip[:, 3] - base,
                        ip[:, 4:8], _unpack_literals(
                            sig, ip, fparams[None, :].expand(n_windows, -1)))
    gvalid = r["ridx"] < r["num_groups"][:, None]
    start = torch.where(gvalid, r["start_idx"], int(I32_MAX))
    return (r["result"] & gvalid, start.to(torch.int32),
            r["num_groups"].to(torch.int32))


# -- the kernels ----------------------------------------------------------

def _check_run(sig, run: dict) -> tuple:
    """(flattened run planes, per column set/isnull/cmp/arith, widths) in
    the kernel's order; raises on what the kernel does not take."""
    valid = run["valid"]
    shape = tuple(valid.shape)
    if len(shape) != 2 or shape[1] != sig.R or valid.numel() >= (1 << 31) \
            or shape[0] % sig.K:
        raise ValueError(f"planes of shape {shape}: the kernel takes [B, R] "
                         f"with R = {sig.R}, B a multiple of K = {sig.K} "
                         "and fewer than 2^31 rows")
    want = {"valid": torch.bool, "group_start": torch.bool,
            "tomb": torch.bool, "live": torch.bool, "ht_hi": torch.int32,
            "ht_lo": torch.int32, "exp_hi": torch.int32,
            "exp_lo": torch.int32}
    planes = [(n, run[n], want[n]) for n in _RUN_PLANES]
    cols, widths = [], []
    if len(sig.cols) > MAX_COLS:
        raise ValueError(f"{len(sig.cols)} value columns: the kernel takes "
                         f"at most {MAX_COLS}")
    for cs in sig.cols:
        c = run["cols"][cs.col_id]
        cmp = c["cmp"]
        if cmp.dim() != 3 or cmp.shape[2] not in (1, 2):
            raise ValueError(f"col {cs.col_id} cmp: {tuple(cmp.shape)}")
        planes += [(f"col {cs.col_id} set", c["set"], torch.bool),
                   (f"col {cs.col_id} isnull", c["isnull"], torch.bool),
                   (f"col {cs.col_id} cmp", cmp, torch.int32)]
        if "arith" in c:
            planes.append((f"col {cs.col_id} arith", c["arith"],
                           torch.float32))
        cols += [c["set"], c["isnull"], cmp, c.get("arith")]
        widths.append(int(cmp.shape[2]))
    for name, t, dt in planes:
        if t.device != valid.device:
            raise ValueError(f"{name} on {t.device}, valid on {valid.device}")
        if t.dtype != dt or not t.is_contiguous() or \
                tuple(t.shape[:2]) != shape:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}, want "
                             f"contiguous {dt} {shape}")
    return [run[n] for n in _RUN_PLANES], cols, widths


def _pred_table(sig) -> list:
    slot = {cs.col_id: i for i, cs in enumerate(sig.cols)}
    if len(sig.preds) > MAX_PREDS:
        raise ValueError(f"{len(sig.preds)} predicates: the kernel takes at "
                         f"most {MAX_PREDS}")
    out = []
    for ps in sig.preds:
        if ps.kind not in KIND_CODES or ps.op not in OP_CODES:
            raise ValueError(f"predicate {ps}: the kernel does not take it")
        out += [slot[ps.col_id], KIND_CODES[ps.kind], OP_CODES[ps.op]]
    return out


def _ptrs(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * max(len(tensors), 1))(
        *[None if t is None else t.data_ptr() for t in tensors])


def _ints(values) -> ctypes.Array:
    return (ctypes.c_int32 * max(len(values), 1))(*values)


def _check_params(iparams, fparams, device, rows: int | None) -> None:
    for name, t, dt in (("iparams", iparams, torch.int32),
                        ("fparams", fparams, torch.float32)):
        if t.device != device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: {t.dtype} on {t.device}, want "
                             f"contiguous {dt} on {device}")
        if rows is not None and (t.dim() != 2 or t.shape[0] != rows):
            raise ValueError(f"{name} of shape {tuple(t.shape)}")


def gather_rows(sig: GatherSig, run: dict, iparams: torch.Tensor,
                fparams: torch.Tensor) -> torch.Tensor:
    """K7 over G pages of ``run`` (``DeviceRun.arrays``): ``iparams``
    [G, P] int32 and ``fparams`` [G, F] float32 (``pack_params`` rows) on
    the run's device -> int32 [G, M+1, W]. Launches the CUDA kernel for
    CUDA tensors, runs ``gather_rows_plain`` for CPU tensors, and raises
    for anything else."""
    encodings.require_plain(run, "K7")
    device = run["valid"].device
    if iparams.dim() != 2:
        raise ValueError(f"iparams of shape {tuple(iparams.shape)}")
    G = iparams.shape[0]
    _check_params(iparams, fparams, device, G)
    if not sig.packed and sig.M != sig.K * sig.R:
        raise ValueError("chunks mode writes a whole window: M = K * R")
    if not sig.apply_preds:
        raise ValueError("K7 applies its predicates: apply_preds = True")
    if device.type == "cpu":
        return gather_rows_plain(sig, run, iparams, fparams)
    if device.type != "cuda":
        raise ValueError(f"gather_rows runs on cuda or cpu, not {device}")
    # A promoted predicate compares its column's code plane as an i32
    # column of its own (the output columns stay the run's).
    sig, run = decode.lower_code_preds(sig, run)
    top, cols, widths = _check_run(sig, run)
    preds = _pred_table(sig)
    slot = {cs.col_id: i for i, cs in enumerate(sig.cols)}
    if len(sig.out_cols) > MAX_OUT:
        raise ValueError(f"{len(sig.out_cols)} output columns: the kernel "
                         f"takes at most {MAX_OUT}")
    outs = [v for oc in sig.out_cols
            for v in (slot[oc.col_id], oc.planes, int(oc.want_idx))]
    W, _ = out_layout(sig)
    out = torch.empty((G, sig.M + 1, W), dtype=torch.int32, device=device)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.row_gather_launch(
            _ptrs(top), _ptrs(cols), _ints(widths), len(sig.cols),
            run["valid"].numel(), sig.R, sig.K, sig.M, W, int(sig.packed),
            int(sig.flat), _ints(preds), len(sig.preds), _ints(outs),
            len(sig.out_cols), ctypes.c_void_p(iparams.data_ptr()),
            iparams.shape[1], ctypes.c_void_p(fparams.data_ptr()),
            fparams.shape[1], G, ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"row_gather kernel launch failed ({rc}): "
                           f"{lib.row_gather_error_string(rc).decode()}")
    gather_rows.launches += 1
    return out


# Kernel launches since the count was last set to 0.
gather_rows.launches = 0


def scan_candidates(sig, run: dict, iparams: torch.Tensor,
                    fparams: torch.Tensor, n_windows: int) -> tuple:
    """K9 over ``n_windows`` windows of ``run`` from the params row's
    ``w_first`` (``sig``: a row-scan ``ScanSig``; ``iparams`` [P] int32 /
    ``fparams`` [F] float32 on the run's device) -> (result bool [n, N],
    start_idx int32 [n, N], num_groups int32 [n]). Launches the CUDA
    kernel for CUDA tensors, runs ``scan_candidates_plain`` for CPU
    tensors, and raises for anything else."""
    if sig.aggs:
        raise ValueError("scan_candidates is the row-scan form (aggs=())")
    encodings.require_plain(run, "K9")
    device = run["valid"].device
    _check_params(iparams, fparams, device, None)
    if iparams.dim() != 1 or fparams.dim() != 1:
        raise ValueError("one params row: iparams [P], fparams [F]")
    if device.type == "cpu":
        return scan_candidates_plain(sig, run, iparams, fparams, n_windows)
    sig, run = decode.lower_code_preds(sig, run)
    if device.type != "cuda":
        raise ValueError(f"scan_candidates runs on cuda or cpu, not {device}")
    top, cols, widths = _check_run(sig, run)
    preds = _pred_table(sig)
    N = sig.K * sig.R
    result = torch.empty((n_windows, N), dtype=torch.bool, device=device)
    start = torch.empty((n_windows, N), dtype=torch.int32, device=device)
    num_groups = torch.empty((n_windows,), dtype=torch.int32, device=device)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.scan_window_launch(
            _ptrs(top), _ptrs(cols), _ints(widths), len(sig.cols),
            run["valid"].numel(), sig.R, sig.K, int(sig.flat),
            int(sig.apply_preds), _ints(preds), len(sig.preds),
            ctypes.c_void_p(iparams.data_ptr()), iparams.shape[0],
            ctypes.c_void_p(fparams.data_ptr()), fparams.shape[0], n_windows,
            ctypes.c_void_p(result.data_ptr()),
            ctypes.c_void_p(start.data_ptr()),
            ctypes.c_void_p(num_groups.data_ptr()), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"scan_window kernel launch failed ({rc}): "
                           f"{lib.row_gather_error_string(rc).decode()}")
    scan_candidates.launches += 1
    return result, start, num_groups


# Kernel launches since the count was last set to 0.
scan_candidates.launches = 0


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    return bind(native.load_library("row_gather"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with the argument and result types of the kernels' C
    interfaces set."""
    vp, i32, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    pp = ctypes.POINTER(ctypes.c_void_p)
    ip = ctypes.POINTER(ctypes.c_int32)
    lib.row_gather_launch.argtypes = [
        pp, pp, ip, i32, ll, i32, i32, i32, i32, i32, i32, ip, i32, ip, i32,
        vp, i32, vp, i32, i32, vp, vp]
    lib.row_gather_launch.restype = i32
    lib.scan_window_launch.argtypes = [
        pp, pp, ip, i32, ll, i32, i32, i32, i32, ip, i32, vp, i32, vp, i32,
        i32, vp, vp, vp, vp]
    lib.scan_window_launch.restype = i32
    lib.row_gather_error_string.argtypes = [i32]
    lib.row_gather_error_string.restype = ctypes.c_char_p
    return lib


# -- bytes the functions must move (the bound) ------------------------------

def _resolve_bytes(sig, with_preds: bool) -> tuple:
    """(bytes, columns read): what a walked row's resolve reads. Its
    valid, tombstone and liveness flags, hybrid time and expiry (and, on a
    multi-version run, its group_start flag; a flat run's groups are its
    rows), each value column's set and isnull flags, and with
    ``with_preds`` each predicate column's planes: an f32 predicate's
    arithmetic plane, an i32 one's order plane, the others' two order
    planes. Columns read: the ones whose order planes that covers."""
    total = 3 + 8 + 8 + (0 if sig.flat else 1) + 2 * len(sig.cols)
    planes: dict = {}
    if with_preds:
        for ps in sig.preds:
            key = (ps.col_id, ps.kind == "f32")
            planes[key] = max(planes.get(key, 0), 1 if ps.kind in (
                "f32", "i32", "code") else 2)
    total += 4 * sum(planes.values())
    return total, {c for (c, arith), n in planes.items() if not arith}


def gather_bytes(sig: GatherSig, run: dict, iparams: np.ndarray,
                 out: np.ndarray) -> int:
    """Bytes K7 must move for one launch: each page's params; the
    resolve's planes, predicates' included, for every row of the windows
    it walked (from the output's tail: w_end - w_first windows, one in
    chunks mode); the planes of the output columns that no predicate
    read, for each row written (a page's min(count, M) matches, or a
    chunks window's groups); and the output once."""
    N = sig.K * sig.R
    per_row, read = _resolve_bytes(sig, True)
    per_out = 4 * sum(oc.planes for oc in sig.out_cols
                      if oc.col_id not in read)
    if sig.packed:
        walked = np.maximum(out[:, sig.M, 2].astype(np.int64)
                            - iparams[:, 0].astype(np.int64), 0)
        written = np.minimum(out[:, sig.M, 0].astype(np.int64), sig.M)
    else:
        walked = np.ones(out.shape[0], np.int64)
        if sig.flat:
            written = walked * N
        else:
            groups = run["group_start"].reshape(-1, N).sum(
                1, dtype=torch.int64).cpu().numpy()
            written = groups[iparams[:, 0]]
    return (int(walked.sum()) * N * per_row + int(written.sum()) * per_out
            + iparams.nbytes + out.nbytes)


def candidates_bytes(sig, run: dict, n_windows: int) -> int:
    """Bytes K9 must move for one launch: the resolve's planes
    (predicates' with ``apply_preds``) for ``n_windows`` windows and the
    outputs (a flag and a row a group slot, a count a window)."""
    N = sig.K * sig.R
    per_row, _read = _resolve_bytes(sig, sig.apply_preds)
    return n_windows * (N * (per_row + 1 + 4) + 4)
