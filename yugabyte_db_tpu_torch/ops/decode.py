"""The whole-run decode of encoded planes: K10, its plain version, and the
code planes' lowering for the kernels that compare plain int32 planes.

Counterpart of the JAX package's ``ops/encodings.py`` ``decode_run`` (an
XLA program), which becomes ``csrc/decode.cu`` here. ``decode_tree`` turns
an encoded run tree (``DeviceRun.arrays`` with ``encoded`` True) into the
plain tree that every kernel reading plain planes takes (the JAX package
materialises the same side-car for its K1 in ``ops/pallas_agg.py``
``gather_tensors``): plain leaves pass through as they are, each encoded
leaf is decoded, and a dictionary ``cmp`` leaf gives the two prefix planes
as ``cmp`` [B, R, 2] and its int32 code plane beside them as ``code``
[B, R] (the JAX decode's plane 2), so that no reader's strides change.

- ``decode_tree`` / ``decode_leaves``: the wrapper. On CUDA tensors one
  launch of the kernel decodes every encoded leaf (``decode_tree.launches``
  counts launches); on CPU tensors it runs ``decode_tree_plain``;
- ``plan_leaves`` / ``plan_tree``: the launch's part table (``part_rows``:
  each leaf's 16-byte output units, numbered into work items of
  ITEM_UNITS units by ``work_items``, its outputs' places in one
  allocation, its dictionary in shared memory or not), laid out and
  uploaded once; ``launch`` then copies nothing from the host;
- ``decode_tree_plain``: the function in torch ops (``ops.encodings``
  ``decode_leaf``, a dictionary's three planes split as above);
- ``decode_bytes``: the bytes the function must move, for the bound;
- ``code_columns`` / ``fold_code_columns`` / ``lower_code_preds``: a
  promoted ``"code"`` predicate compares a column's code plane; the hand
  kernels that compare int32 order planes (K5, K7, K9, the resolve) see
  that plane as a column of its own, ``CODE_COL + cid``, with the
  column's set and isnull planes, and the predicate as an ``"i32"`` one
  on it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from yugabyte_db_tpu_torch.ops import encodings as enc
from yugabyte_db_tpu_torch.ops import native

# A code plane's column id in a lowered signature: CODE_COL + the column's.
CODE_COL = 1 << 20
# Part kinds of csrc/decode.cu (a dictionary is two parts: its prefix
# planes, then its codes), and the words of a part table row.
_KIND = {"bits": 0, "const": 1, "delta16": 2, "rle": 3, "pair": 4, "code": 5}
PART_WORDS = 12
ITEM_UNITS = 256  # 16-byte output units a work item: one a thread
# Shared bytes a block gives the dictionaries (int2 entries); a larger
# dictionary is read through the read-only cache.
DICT_SMEM_CAP = 8192


def _split(decoded: torch.Tensor, kind: str) -> dict:
    """A decoded ``cmp`` leaf's entries: a dictionary's [B, R, 3] as the
    prefix planes and the code plane."""
    if kind != "dict":
        return {"cmp": decoded}
    return {"cmp": decoded[..., :2].contiguous(),
            "code": decoded[..., 2].contiguous()}


def decode_tree_plain(tree: dict) -> dict:
    """The plain tree of an encoded tensor tree, in torch ops."""
    B, R = enc.tree_dims(tree)
    out = {name: enc.decode_leaf(leaf, B, R)
           for name, leaf in tree.items() if name != "cols"}
    out["cols"] = {}
    for cid, col in tree["cols"].items():
        entry = {}
        for n, leaf in col.items():
            decoded = enc.decode_leaf(leaf, B, R)
            if n == "cmp":
                entry.update(_split(decoded, enc.leaf_kind(leaf)))
            else:
                entry[n] = decoded
        out["cols"][cid] = entry
    return out


def _out_shapes(leaf, B: int, R: int) -> list[tuple]:
    """(shape, dtype) of each plain plane an encoded leaf decodes into: a
    dictionary's prefix planes and its code plane, else one plane."""
    k = enc.leaf_kind(leaf)
    e = leaf[k]
    if k == "bits":
        return [((B, R), torch.bool)]
    if k == "dict":
        return [((B, R, 2), torch.int32), ((B, R), torch.int32)]
    src = {"const": "cval", "delta16": "doff", "rle": "rvals"}[k]
    tail = tuple(e[src].shape[2:])
    dtype = torch.int32 if k == "delta16" else e[src].dtype
    return [((B, R) + tail, dtype)]


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def _nbytes(shape, dtype) -> int:
    return int(np.prod(shape, dtype=np.int64)) * torch.empty(
        0, dtype=dtype).element_size()


class DecodePlan(NamedTuple):
    """A decode of ``leaves`` (of a [B, R] run) laid out for the kernel:
    the part table's rows (``rows``, PART_WORDS int64 words a part; on
    the device as ``table``, None on the CPU), the work items, each
    leaf's output planes as (byte offset, shape, dtype) in one allocation
    of ``out_bytes``, and the dictionaries' shared bytes."""
    B: int
    R: int
    rows: np.ndarray
    table: torch.Tensor | None
    n_items: int
    outs: tuple
    out_bytes: int
    dict_bytes: int


def work_items(units) -> list[int]:
    """Each part's first work item (ITEM_UNITS units an item, a part's
    items after the previous parts'), then the item count."""
    first = [0]
    for u in units:
        first.append(first[-1] + -(-int(u) // ITEM_UNITS))
    return first


def part_rows(leaves: list, B: int, R: int,
              dict_cap: int = DICT_SMEM_CAP) -> tuple:
    """(rows, outs, out_bytes, dict_bytes): the part table of ``leaves``
    (csrc/decode.cu's row layout; a dictionary is two parts, its prefix
    planes then its codes), each leaf's output planes as (byte offset,
    shape, dtype) in one allocation (each 16-byte aligned), the
    allocation's bytes, and the dictionaries in shared memory (in leaf
    order while their int2 entries stay within ``dict_cap`` bytes; the
    others are read through the read-only cache)."""
    rows, outs = [], []
    off = entries = 0
    if B * R * 8 >= 1 << 34:
        raise ValueError(f"a [{B}, {R}] run exceeds the decode's 32-bit "
                         "word index")
    for leaf in leaves:
        k = enc.leaf_kind(leaf)
        e = leaf[k]
        for name, a in e.items():
            if not a.is_contiguous():
                raise ValueError(f"{k} leaf array {name} is not contiguous")
        shapes = _out_shapes(leaf, B, R)
        planes = []
        for shape, dtype in shapes:
            planes.append((off, shape, dtype))
            off = _align16(off + _nbytes(shape, dtype))
        outs.append(tuple(planes))
        P = int(np.prod(shapes[0][0][2:], dtype=np.int64))
        n_rows = B * R
        if k in ("const", "rle") and _nbytes((), shapes[0][1]) != 4:
            raise ValueError(f"{k} leaf of {shapes[0][1]}: the kernel copies "
                             "4-byte words")
        if k == "bits":
            arrays, units, words = [e["bw"]], n_rows // 16, n_rows // 4
        elif k == "dict":
            arrays = [e["codes"], e["dhi"], e["dlo"]]
        else:
            arrays = [e[n] for n in {"const": ("cval",),
                                     "delta16": ("dbase", "doff"),
                                     "rle": ("rid", "rvals")}[k]]
            words = n_rows * P
            units = -(-words // 4)
        for a in arrays:
            if a.data_ptr() % (8 if a.element_size() == 2 else 4):
                raise ValueError(f"{k} leaf array is not aligned for the "
                                 "kernel's vector loads")
        ptrs = [a.data_ptr() for a in arrays] + [0] * (3 - len(arrays))
        if k != "dict":
            rows.append([_KIND[k], units, P, R,
                         e["rvals"].shape[1] if k == "rle" else 0, 0, -1,
                         planes[0][0], *ptrs, words])
            continue
        d = e["dhi"].numel()
        dsh = -1
        if 8 * (entries + d) <= dict_cap:
            dsh, entries = entries, entries + d
        rows.append([_KIND["pair"], -(-2 * n_rows // 4), 2, R, d, 0, dsh,
                     planes[0][0], *ptrs, 2 * n_rows])
        rows.append([_KIND["code"], -(-n_rows // 4), 1, R, d, 0, -1,
                     planes[1][0], *ptrs, n_rows])
    table = np.array(rows, dtype=np.int64).reshape(-1, PART_WORDS)
    table[:, 5] = work_items(table[:, 1])[:-1]
    return table, tuple(outs), off, _align16(8 * entries)


def plan_leaves(leaves: list, B: int, R: int) -> DecodePlan:
    """The decode of ``leaves`` laid out once (``part_rows``), its part
    table uploaded to the leaves' device (there, a launch copies nothing
    from the host)."""
    rows, outs, out_bytes, dict_bytes = part_rows(leaves, B, R)
    device = next(iter(leaves[0][enc.leaf_kind(leaves[0])].values())).device
    table = None
    if device.type == "cuda":  # pinned, and not waited for
        table = torch.from_numpy(rows).pin_memory().to(device,
                                                       non_blocking=True)
    return DecodePlan(B, R, rows, table, work_items(rows[:, 1])[-1], outs,
                      out_bytes, dict_bytes)


def planes_of(plan: DecodePlan, out: torch.Tensor) -> list:
    """Each leaf's plain planes as views into the allocation ``out``."""
    return [[out[o:o + _nbytes(shape, dtype)].view(dtype).view(shape)
             for o, shape, dtype in planes] for planes in plan.outs]


def launch_geometry(n_items: int, n_parts: int, dict_bytes: int, sms: int,
                    per_sm) -> tuple:
    """(grid, shared bytes) of a launch: the parts' first items (16-byte
    aligned) and the shared dictionaries; a persistent grid of the
    blocks ``per_sm(shared bytes)`` holds on each of ``sms`` SMs, but no
    more than the items."""
    smem = _align16(4 * (n_parts + 1)) + dict_bytes
    return max(1, min(n_items, sms * per_sm(smem))), smem


def launch(plan: DecodePlan, out: torch.Tensor) -> None:
    """One launch of K10 writing ``plan``'s planes into ``out`` (a uint8
    allocation of ``plan.out_bytes`` on the plan's device)."""
    device = out.device
    if out.dtype != torch.uint8 or out.numel() < plan.out_bytes or \
            out.data_ptr() % 16:
        raise ValueError("the output must be a 16-byte aligned uint8 "
                         f"allocation of {plan.out_bytes} bytes")
    lib = _library()
    grid, smem = launch_geometry(
        plan.n_items, plan.rows.shape[0], plan.dict_bytes,
        torch.cuda.get_device_properties(device).multi_processor_count,
        lambda s: _occupancy(lib, s))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.decode_launch(ctypes.c_void_p(plan.table.data_ptr()),
                               plan.rows.shape[0], plan.n_items,
                               ctypes.c_void_p(out.data_ptr()), grid, smem,
                               ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"decode kernel launch failed ({rc}): "
                           f"{lib.decode_error_string(rc).decode()}")
    decode_tree.launches += 1


def decode_leaves(leaves: list, B: int, R: int,
                  plan: DecodePlan | None = None) -> list[list[torch.Tensor]]:
    """Each encoded leaf of ``leaves`` (of a [B, R] run) decoded: a list of
    its plain planes (a dictionary's: the prefix planes and the code
    plane). On CUDA tensors one launch of the kernel, into a new
    allocation, over ``plan`` (``plan_leaves``, made here when None);
    the plain version for CPU tensors; a raise for anything else."""
    if not leaves:
        return []
    first = next(iter(leaves[0][enc.leaf_kind(leaves[0])].values()))
    device = first.device
    if device.type == "cpu":
        out = []
        for leaf in leaves:
            d = _split(enc.decode_leaf(leaf, B, R), enc.leaf_kind(leaf))
            out.append([d["cmp"], d["code"]] if "code" in d else [d["cmp"]])
        return out
    if device.type != "cuda":
        raise ValueError(f"decode runs on cuda or cpu, not {device}")
    plan = plan or plan_leaves(leaves, B, R)
    out = torch.empty(plan.out_bytes, dtype=torch.uint8, device=device)
    launch(plan, out)
    return planes_of(plan, out)


def tree_leaves(tree: dict) -> tuple:
    """(where, leaves): the encoded leaves of a run tree and where each
    sits ((None, name) or (column id, name))."""
    where, leaves = [], []
    for name, leaf in tree.items():
        if name != "cols" and enc.leaf_kind(leaf) is not None:
            where.append((None, name))
            leaves.append(leaf)
    for cid, col in tree["cols"].items():
        for n, leaf in col.items():
            if enc.leaf_kind(leaf) is not None:
                where.append((cid, n))
                leaves.append(leaf)
    return where, leaves


def plan_tree(tree: dict) -> DecodePlan:
    """``plan_leaves`` over a run tree's encoded leaves (``tree_leaves``'
    order)."""
    B, R = enc.tree_dims(tree)
    return plan_leaves(tree_leaves(tree)[1], B, R)


def assemble(tree: dict, planes: list) -> dict:
    """The plain tree of ``tree`` with its encoded leaves replaced by
    their decoded ``planes`` (``tree_leaves``' order)."""
    out = {name: leaf for name, leaf in tree.items() if name != "cols"}
    out["cols"] = {cid: dict(col) for cid, col in tree["cols"].items()}
    for (cid, n), got in zip(tree_leaves(tree)[0], planes):
        if cid is None:
            out[n] = got[0]
        elif len(got) == 2:
            out["cols"][cid].update(cmp=got[0], code=got[1])
        else:
            out["cols"][cid][n] = got[0]
    return out


def decode_tree(tree: dict, plan: DecodePlan | None = None) -> dict:
    """The plain tree of an encoded run tree (``decode_tree_plain``'s
    function): every encoded leaf decoded by one launch of K10 on CUDA
    tensors (over ``plan``, ``plan_tree``'s, made here when None), by the
    plain version on CPU tensors; plain leaves are the tree's own
    tensors."""
    B, R = enc.tree_dims(tree)
    _where, leaves = tree_leaves(tree)
    return assemble(tree, decode_leaves(leaves, B, R, plan))


# Kernel launches since the count was last set to 0.
decode_tree.launches = 0


def decode_bytes(tree: dict) -> int:
    """Bytes the function must move: every encoded leaf read once and the
    plain planes it decodes into written once (plain leaves move
    nothing)."""
    B, R = enc.tree_dims(tree)
    total = 0
    for leaf in tree_leaves(tree)[1]:
        total += sum(a.numel() * a.element_size()
                     for a in leaf[enc.leaf_kind(leaf)].values())
        total += sum(_nbytes(shape, dtype)
                     for shape, dtype in _out_shapes(leaf, B, R))
    return total


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    return bind(native.load_library("decode"))


@functools.lru_cache(maxsize=16)
def _occupancy(lib: ctypes.CDLL, smem_bytes: int) -> int:
    blocks = lib.decode_occupancy(smem_bytes)
    if blocks < 1:
        raise RuntimeError(f"decode occupancy query failed ({blocks})")
    return blocks


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with the argument and result types of the kernel's C
    interface set."""
    I, P = ctypes.c_int, ctypes.c_void_p
    lib.decode_launch.argtypes = [P, I, I, P, I, I, P]
    lib.decode_launch.restype = I
    lib.decode_occupancy.argtypes = [I]
    lib.decode_occupancy.restype = I
    lib.decode_part_words.argtypes = []
    lib.decode_part_words.restype = I
    lib.decode_error_string.argtypes = [I]
    lib.decode_error_string.restype = ctypes.c_char_p
    if lib.decode_part_words() != PART_WORDS:
        raise RuntimeError("csrc/decode.cu's part table differs from "
                           "ops/decode.py's")
    return lib


# -- code planes as columns of their own --------------------------------------

def code_columns(run: dict) -> dict:
    """``run`` (a plain tree) with each column that carries a code plane
    given a column of its own, ``CODE_COL + cid``: the column's set and
    isnull planes and the code plane as its one order plane."""
    extra = {CODE_COL + cid: {"set": c["set"], "isnull": c["isnull"],
                              "cmp": c["code"].unsqueeze(-1)}
             for cid, c in run["cols"].items() if "code" in c}
    if not extra:
        return run
    return dict(run, cols={**run["cols"], **extra})


def fold_code_columns(run: dict) -> dict:
    """The inverse of ``code_columns`` on a resolved view: each
    ``CODE_COL + cid`` column's order plane back as column ``cid``'s
    ``code`` plane."""
    codes = {cid - CODE_COL: c["cmp"][..., 0].contiguous()
             for cid, c in run["cols"].items() if cid >= CODE_COL}
    if not codes:
        return run
    cols = {cid: (dict(c, code=codes[cid]) if cid in codes else c)
            for cid, c in run["cols"].items() if cid < CODE_COL}
    return dict(run, cols=cols)


def lower_code_preds(sig, run: dict):
    """(signature, plain tree) for a kernel that compares int32 order
    planes: each ``"code"`` predicate of ``sig`` (a ``ScanSig`` or
    ``GatherSig``) becomes an ``"i32"`` predicate on column ``CODE_COL +
    cid``, which ``run`` gains (``code_columns``) and ``sig.cols`` lists.
    Unchanged when ``sig`` has no ``"code"`` predicate."""
    if not any(p.kind == "code" for p in sig.preds):
        return sig, run
    from yugabyte_db_tpu_torch.ops.scan import ColSig, PredSig

    preds = tuple(PredSig(CODE_COL + p.col_id, "i32", p.op)
                  if p.kind == "code" else p for p in sig.preds)
    have = {c.col_id for c in sig.cols}
    cols = tuple(sig.cols) + tuple(
        ColSig(cid, "i32") for cid in dict.fromkeys(
            p.col_id for p in preds if p.col_id >= CODE_COL)
        if cid not in have)
    return (dataclasses.replace(sig, preds=preds, cols=cols),
            code_columns(run))
