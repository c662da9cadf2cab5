"""Device memtable flush: the replay scatter K12, its plain version and the
flushed planes' size.

The JAX package's ``ops/flush.py``. The host stages the memtable's
apply-order rows as flat planes through the columnar encoders, computes
the flush sort permutation and the block packing over memcmp sort keys
(exact whenever keys fit the 32-byte prefix planes), and one launch then
writes the SORTED, BLOCK-PACKED run planes, already padded to the
``DeviceRun`` block multiple:

    out[dst[j]] = staged[perm[j]]

for every fixed-width plane at once, and the padding and unfilled-row
encoding everywhere else. The engine adopts the output as the run's
device planes (no second upload) and reads the host planes back from it,
so both are byte-identical by construction.

- ``replay_flush``: the wrapper of the CUDA kernel ``csrc/flush.cu`` (K12)
  for CUDA tensors; on CPU tensors it runs ``replay_flush_plain``.
  ``replay_flush.launches`` counts launches;
- ``replay_flush_plain``: the function in torch ops (an ``index_put_`` a
  plane), the counterpart of the JAX ``replay_flush``;
- ``flush_plane_nbytes``: the JAX function's device footprint estimate of
  the replayed planes, which the engine's budget gate checks against the
  residency budget (``gpu_hbm_budget_bytes``);
- ``replay_bytes``: the bytes the function must move, for the bound;
- ``record_layout``: where each plane of a staged row lies in the record
  that the kernel's first pass packs (its scratch is ``n`` records).

A string column the engine dictionary-encodes (its ``plane_encoding``
``"auto"``) is staged as ``codes`` ([n] u16, held as int16) with its
sorted dictionary's ``dhi`` / ``dlo`` instead of ``cmp``: the JAX
function's ``codes`` route. Its output is the encoded leaf
``{"dict": {codes [Bp, R], dhi, dlo}}``, unfilled and padding slots
holding the absent code (the dictionary's last slot), which decodes to
the plain format's zero prefix planes.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from yugabyte_db_tpu_torch.ops import native

MAX_COLS = 32  # value columns one launch writes; csrc/flush.cu kMaxCols
# The staged planes every row has, and the output's, in the kernel's
# order, with their types.
_TOP = {"ht_hi": torch.int32, "ht_lo": torch.int32, "exp_hi": torch.int32,
        "exp_lo": torch.int32, "tomb": torch.bool, "live": torch.bool}
_OUT_TOP = {"valid": torch.bool, "group_start": torch.bool,
            "tomb": torch.bool, "live": torch.bool, "ht_hi": torch.int32,
            "ht_lo": torch.int32, "exp_hi": torch.int32,
            "exp_lo": torch.int32}


def _width(col: dict) -> int:
    """Order words a staged row of the column holds in the kernel's
    record layout: 1 or 2, or 0 for a dictionary column's code."""
    return 0 if "codes" in col else col["cmp"].shape[1]


def _absent(col: dict) -> int:
    """A dictionary column's absent code (its last slot), else 0."""
    return col["dhi"].shape[0] - 1 if "codes" in col else 0


def _empty_tree(staged: dict, Bp: int, R: int, device) -> dict:
    out = {name: torch.empty((Bp, R), dtype=dt, device=device)
           for name, dt in _OUT_TOP.items()}
    out["cols"] = {}
    for cid, col in staged["cols"].items():
        entry = {"set": torch.empty((Bp, R), dtype=torch.bool, device=device),
                 "isnull": torch.empty((Bp, R), dtype=torch.bool,
                                       device=device)}
        if "codes" in col:
            entry["cmp"] = {"dict": {
                "codes": torch.empty((Bp, R), dtype=torch.int16,
                                     device=device),
                "dhi": col["dhi"], "dlo": col["dlo"]}}
        else:
            entry["cmp"] = torch.empty((Bp, R, col["cmp"].shape[1]),
                                       dtype=torch.int32, device=device)
        if "arith" in col:
            entry["arith"] = torch.empty((Bp, R), dtype=torch.float32,
                                         device=device)
        out["cols"][cid] = entry
    return out


def replay_flush_plain(staged: dict, perm, dst, gs, is_real,
                       exp_hi_default: int, exp_lo_default: int,
                       R: int) -> dict:
    """The JAX ``replay_flush`` in torch ops. ``staged``: {ht_hi, ht_lo,
    exp_hi, exp_lo: [m] int32; tomb, live: [m] bool; cols: {cid: {set,
    isnull: [m] bool, cmp: [m, P] int32 or codes: [m] int16 (u16) with
    dhi, dlo: [D] int32, arith?: [m] float32}}}, the apply-order rows; ``perm[j]``: the staged row of sorted position j;
    ``dst[j]``: its flat output slot (out of range: dropped); ``gs[j]``:
    its group-start bit; ``is_real`` [Bp] bool: the blocks the run owns
    (padding blocks keep valid False, group_start True, expiry 0; a real
    block's unfilled rows get the default expiry). Returns the
    ``DeviceRun.arrays`` tree of [Bp, R] planes."""
    Bp = is_real.shape[0]
    S = Bp * R
    device = is_real.device
    ok = (dst >= 0) & (dst < S)
    d = dst[ok].to(torch.int64)
    src = perm[ok].to(torch.int64)

    def scat(init, vals):
        init[d] = vals[src]
        return init.reshape((Bp, R) + tuple(init.shape[1:]))

    def zeros(dtype, tail=()):
        return torch.zeros((S,) + tuple(tail), dtype=dtype, device=device)

    real_rows = is_real.repeat_interleave(R)
    valid = zeros(torch.bool)
    valid[d] = True
    group_start = torch.ones(S, dtype=torch.bool, device=device)
    group_start[d] = gs[ok]
    out = {
        "valid": valid.reshape(Bp, R),
        "group_start": group_start.reshape(Bp, R),
        "tomb": scat(zeros(torch.bool), staged["tomb"]),
        "live": scat(zeros(torch.bool), staged["live"]),
        "ht_hi": scat(zeros(torch.int32), staged["ht_hi"]),
        "ht_lo": scat(zeros(torch.int32), staged["ht_lo"]),
        "exp_hi": scat(torch.where(real_rows, exp_hi_default, 0).to(
            torch.int32), staged["exp_hi"]),
        "exp_lo": scat(torch.where(real_rows, exp_lo_default, 0).to(
            torch.int32), staged["exp_lo"]),
        "cols": {},
    }
    for cid, col in staged["cols"].items():
        entry = {"set": scat(zeros(torch.bool), col["set"]),
                 "isnull": scat(zeros(torch.bool), col["isnull"])}
        if "codes" in col:
            codes = torch.full((S,), _absent(col), dtype=torch.int16,
                               device=device)
            entry["cmp"] = {"dict": {"codes": scat(codes, col["codes"]),
                                     "dhi": col["dhi"], "dlo": col["dlo"]}}
        else:
            entry["cmp"] = scat(zeros(torch.int32, (col["cmp"].shape[1],)),
                                col["cmp"])
        if "arith" in col:
            entry["arith"] = scat(zeros(torch.float32), col["arith"])
        out["cols"][cid] = entry
    return out


def _check(staged, perm, dst, gs, is_real) -> torch.device:
    device = is_real.device
    m = perm.shape[0]
    for name, t, dt in (("perm", perm, torch.int32), ("dst", dst, torch.int32),
                        ("gs", gs, torch.bool)):
        if t.dtype != dt or tuple(t.shape) != (m,):
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}, want "
                             f"[{m}] {dt}")
    if is_real.dtype != torch.bool or is_real.dim() != 1:
        raise ValueError("is_real: want [Bp] bool")
    n = staged["ht_hi"].shape[0]
    planes = [(name, staged[name], dt) for name, dt in _TOP.items()]
    for cid, col in staged["cols"].items():
        planes += [(f"col {cid} set", col["set"], torch.bool),
                   (f"col {cid} isnull", col["isnull"], torch.bool)]
        if "arith" in col:
            planes.append((f"col {cid} arith", col["arith"], torch.float32))
        if "codes" in col:
            planes.append((f"col {cid} codes", col["codes"], torch.int16))
            for name in ("dhi", "dlo"):
                d = col[name]
                if d.dtype != torch.int32 or d.dim() != 1 or \
                        d.shape[0] < 1 or d.device != device:
                    raise ValueError(f"col {cid} {name}: {d.dtype} "
                                     f"{tuple(d.shape)}")
            continue
        cmp = col["cmp"]
        if cmp.dtype != torch.int32 or cmp.dim() != 2 or \
                cmp.shape[0] != n or cmp.shape[1] not in (1, 2) or \
                not cmp.is_contiguous() or cmp.device != device:
            raise ValueError(f"col {cid} cmp: {cmp.dtype} "
                             f"{tuple(cmp.shape)}")
    for name, t, dt in planes:
        if t.dtype != dt or tuple(t.shape) != (n,):
            raise ValueError(f"staged {name}: {t.dtype} {tuple(t.shape)}, "
                             f"want [{n}] {dt}")
    for name, t, _dt in planes + [("perm", perm, None), ("dst", dst, None),
                                  ("gs", gs, None)]:
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{name} on {t.device} (want contiguous, on "
                             f"{device})")
    return device


def replay_flush(staged: dict, perm, dst, gs, is_real, exp_hi_default: int,
                 exp_lo_default: int, R: int) -> dict:
    """``replay_flush_plain``'s function: K12 for CUDA tensors (one call
    for every plane, ``MAX_COLS`` value columns a call), the plain
    version for CPU tensors, and a raise for anything else. The kernel
    inverts ``dst`` a tile of slots at a time, so it takes ``dst``
    ascending, strictly over its in-range entries (the flush's packing
    gives it so; entries past the last slot may repeat)."""
    device = _check(staged, perm, dst, gs, is_real)
    if device.type == "cpu":
        return replay_flush_plain(staged, perm, dst, gs, is_real,
                                  exp_hi_default, exp_lo_default, R)
    if device.type != "cuda":
        raise ValueError(f"replay_flush runs on cuda or cpu, not {device}")
    out = _empty_tree(staged, is_real.shape[0], R, device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        replay_flush.launches += launch(
            _library(), staged, perm, dst, gs, is_real, exp_hi_default,
            exp_lo_default, R, out, stream)
    return out


# Kernel launches since the count was last set to 0.
replay_flush.launches = 0


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    return bind(native.load_library("flush"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with the argument and result types of the kernel's C
    interface set."""
    lib.replay_flush_launch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p]
    lib.replay_flush_launch.restype = ctypes.c_int
    lib.replay_flush_error_string.argtypes = [ctypes.c_int]
    lib.replay_flush_error_string.restype = ctypes.c_char_p
    return lib


def record_layout(widths, has_arith, top: bool) -> dict:
    """Where each plane of a staged row lies in the 32-bit words of its
    record, as ``csrc/flush.cu`` packs it for a chunk of columns of order
    widths ``widths`` (1 or 2, or 0 for a dictionary column, whose u16
    code takes one word) and arithmetic planes ``has_arith``:
    ``top`` (the first chunk) leads with hybrid time and expiry (words
    0-3); then the flag words (byte 0 tombstone, 1 liveness, 2 + 2c
    column c's set, 3 + 2c its isnull); then each column's order words
    (``cmp[c]``) and arithmetic word (``arith[c]``, -1: none).
    ``stride``, the words a record, is a multiple of 4, so that every
    record starts 16-byte aligned."""
    words = 4 if top else 0
    flags = words
    words += (2 + 2 * len(widths) + 3) // 4
    cmp, arith = [], []
    for w, a in zip(widths, has_arith):
        cmp.append(words)
        words += max(w, 1)
        arith.append(words if a else -1)
        words += 1 if a else 0
    return {"stride": (words + 3) // 4 * 4, "flags": flags, "cmp": cmp,
            "arith": arith}


def _chunks(staged: dict) -> list:
    """The value columns' ids in chunks of ``MAX_COLS``, one a call (at
    least one, which writes the planes every row has)."""
    cids = list(staged["cols"])
    return [cids[k:k + MAX_COLS] for k in range(0, max(len(cids), 1),
                                                MAX_COLS)]


def scratch_words(staged: dict) -> int:
    """32-bit words of the records' scratch the calls share: a record of
    the widest chunk's layout for each staged row."""
    cols = staged["cols"]
    return staged["ht_hi"].shape[0] * max(
        record_layout([_width(cols[cid]) for cid in chunk],
                      ["arith" in cols[cid] for cid in chunk],
                      k == 0)["stride"]
        for k, chunk in enumerate(_chunks(staged)))


def launch(lib: ctypes.CDLL, staged: dict, perm, dst, gs, is_real,
           exp_hi_default: int, exp_lo_default: int, R: int, out: dict,
           stream: int) -> int:
    """The calls of ``lib``'s ``replay_flush_launch`` (a bound library of
    ``csrc/flush.cu``'s C interface) on ``stream`` that write ``out``
    (``_empty_tree``'s layout), one a chunk of ``MAX_COLS`` value columns,
    each packing the chunk's records into one scratch of the largest
    chunk's size (``torch.empty``); returns their count, raises on a
    refused launch."""
    chunks = _chunks(staged)
    n = staged["ht_hi"].shape[0]
    scratch = torch.empty(max(1, scratch_words(staged)), dtype=torch.int32,
                          device=perm.device)
    for k, chunk in enumerate(chunks):
        ins = [staged[name] for name in _TOP]
        outs = [out[name] for name in _OUT_TOP]
        for cid in chunk:
            c, o = staged["cols"][cid], out["cols"][cid]
            if "codes" in c:
                cmp_in, cmp_out = c["codes"], o["cmp"]["dict"]["codes"]
            else:
                cmp_in, cmp_out = c["cmp"], o["cmp"]
            ins += [c["set"], c["isnull"], cmp_in, c.get("arith")]
            outs += [o["set"], o["isnull"], cmp_out, o.get("arith")]
        widths = (ctypes.c_int32 * MAX_COLS)(
            *[_width(staged["cols"][cid]) for cid in chunk])
        absent = (ctypes.c_int32 * MAX_COLS)(
            *[_absent(staged["cols"][cid]) for cid in chunk])
        in_ptrs = (ctypes.c_void_p * len(ins))(
            *[None if t is None else t.data_ptr() for t in ins])
        out_ptrs = (ctypes.c_void_p * len(outs))(
            *[None if t is None else t.data_ptr() for t in outs])
        rc = lib.replay_flush_launch(
            in_ptrs, out_ptrs, widths, absent, len(chunk), k == 0,
            ctypes.c_void_p(perm.data_ptr()), ctypes.c_void_p(dst.data_ptr()),
            ctypes.c_void_p(gs.data_ptr()),
            ctypes.c_void_p(is_real.data_ptr()), perm.shape[0], n,
            is_real.shape[0], R, exp_hi_default, exp_lo_default,
            ctypes.c_void_p(scratch.data_ptr()), 4 * scratch.numel(),
            ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError(f"replay_flush kernel launch failed ({rc}): "
                               f"{lib.replay_flush_error_string(rc).decode()}")
    return len(chunks)


def flush_plane_nbytes(Bp: int, R: int, schema) -> int:
    """Device bytes of the replayed planes (the plain plane format): the
    JAX function's estimate, which its engine checks against the residency
    budget before staging."""
    per_slot = 4 * 1 + 4 * 4  # valid/group_start/tomb/live + ht/exp
    for c in schema.value_columns:
        planes = 2 if c.dtype.device_planes == 2 else 1
        per_slot += 2 * 1 + 4 * planes  # set/isnull + cmp
        if c.dtype.is_numeric:
            per_slot += 4  # arith f32
    return Bp * R * per_slot


def replay_bytes(staged: dict, n: int, m: int, Bp: int, R: int) -> int:
    """Bytes the function must move: the ``n`` gathered staged rows read
    once (their hybrid time, expiry, flags and column planes), ``perm``
    and ``gs`` of those rows, all ``m`` entries of ``dst`` and the
    ``is_real`` flags read once, and every plane of the [Bp, R] output
    written once."""
    row = 8 + 8 + 2
    out = 4 + 16
    for col in staged["cols"].values():
        order = 2 if "codes" in col else 4 * col["cmp"].shape[1]
        width = 2 + order + (4 if "arith" in col else 0)
        row += width
        out += width
    return n * (row + 4 + 1) + 4 * m + Bp + Bp * R * out
