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

import numpy as np
import torch

from yugabyte_db_tpu_torch.ops import encodings as enc
from yugabyte_db_tpu_torch.ops import native

# A code plane's column id in a lowered signature: CODE_COL + the column's.
CODE_COL = 1 << 20
_KIND = {"bits": 0, "const": 1, "delta16": 2, "rle": 3, "dict": 4}
LEAF_WORDS = 10  # csrc/decode.cu kLeafWords


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


def _out_planes(leaf, B: int, R: int, device) -> list[torch.Tensor]:
    """The empty plain planes an encoded leaf decodes into."""
    k = enc.leaf_kind(leaf)
    e = leaf[k]
    if k == "bits":
        return [torch.empty((B, R), dtype=torch.bool, device=device)]
    if k == "dict":
        return [torch.empty((B, R, 2), dtype=torch.int32, device=device),
                torch.empty((B, R), dtype=torch.int32, device=device)]
    src = {"const": "cval", "delta16": "doff", "rle": "rvals"}[k]
    tail = tuple(e[src].shape[2:])
    dtype = torch.int32 if k == "delta16" else e[src].dtype
    return [torch.empty((B, R) + tail, dtype=dtype, device=device)]


def _leaf_row(leaf, outs: list, B: int, R: int) -> list[int]:
    """A leaf table row (csrc/decode.cu ``Leaf``): kind, units, P, R, Rc,
    the leaf's arrays, the output planes."""
    k = enc.leaf_kind(leaf)
    e = leaf[k]
    for a in e.values():
        if not a.is_contiguous():
            raise ValueError(f"{k} leaf array is not contiguous")
    P = 1
    for d in outs[0].shape[2:]:
        P *= int(d)
    if k == "bits":
        arrays, units = [e["bw"]], B * R // 32
    elif k == "const":
        arrays, units = [e["cval"]], B * R
    elif k == "delta16":
        arrays, units = [e["dbase"], e["doff"]], B * R
    elif k == "rle":
        arrays, units = [e["rid"], e["rvals"]], B * R
    else:
        arrays, units = [e["codes"], e["dhi"], e["dlo"]], B * R
        P = 2
    if k in ("const", "rle") and outs[0].element_size() != 4:
        raise ValueError(f"{k} leaf of {outs[0].dtype}: the kernel copies "
                         "4-byte words")
    Rc = e["rvals"].shape[1] if k == "rle" else 0
    ptrs = [a.data_ptr() for a in arrays] + [0] * (3 - len(arrays))
    ptrs += [o.data_ptr() for o in outs] + [0] * (2 - len(outs))
    return [_KIND[k], units, P, R, Rc, *ptrs]


def decode_leaves(leaves: list, B: int, R: int) -> list[list[torch.Tensor]]:
    """Each encoded leaf of ``leaves`` (of a [B, R] run) decoded: a list of
    its plain planes (a dictionary's: the prefix planes and the code
    plane). One launch of the kernel for CUDA tensors, the plain version
    for CPU tensors, a raise for anything else."""
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
    outs = [_out_planes(leaf, B, R, device) for leaf in leaves]
    table = np.array([_leaf_row(leaf, o, B, R)
                      for leaf, o in zip(leaves, outs)], dtype=np.int64)
    lib = _library()
    # Pinned and not waited for: the launch queues behind the copy.
    dev_table = torch.from_numpy(table).pin_memory().to(device,
                                                        non_blocking=True)
    max_units = int(table[:, 1].max())
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.decode_launch(ctypes.c_void_p(dev_table.data_ptr()),
                               len(leaves), max_units,
                               ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"decode kernel launch failed ({rc}): "
                           f"{lib.decode_error_string(rc).decode()}")
    decode_tree.launches += 1
    return outs


def decode_tree(tree: dict) -> dict:
    """The plain tree of an encoded run tree (``decode_tree_plain``'s
    function): every encoded leaf decoded by one launch of K10 on CUDA
    tensors, by the plain version on CPU tensors; plain leaves are the
    tree's own tensors."""
    B, R = enc.tree_dims(tree)
    where, leaves = [], []
    out = {"cols": {}}
    for name, leaf in tree.items():
        if name == "cols":
            continue
        if enc.leaf_kind(leaf) is None:
            out[name] = leaf
        else:
            where.append((None, name))
            leaves.append(leaf)
    for cid, col in tree["cols"].items():
        out["cols"][cid] = {}
        for n, leaf in col.items():
            if enc.leaf_kind(leaf) is None:
                out["cols"][cid][n] = leaf
            else:
                where.append((cid, n))
                leaves.append(leaf)
    for (cid, n), planes in zip(where, decode_leaves(leaves, B, R)):
        if cid is None:
            out[n] = planes[0]
        elif len(planes) == 2:
            out["cols"][cid].update(cmp=planes[0], code=planes[1])
        else:
            out["cols"][cid][n] = planes[0]
    return out


# Kernel launches since the count was last set to 0.
decode_tree.launches = 0


def decode_bytes(tree: dict) -> int:
    """Bytes the function must move: every encoded leaf read once and the
    plain planes it decodes into written once (plain leaves move
    nothing)."""
    B, R = enc.tree_dims(tree)
    total = 0

    def one(leaf):
        nonlocal total
        k = enc.leaf_kind(leaf)
        if k is None:
            return
        total += sum(a.numel() * a.element_size() for a in leaf[k].values())
        total += sum(o.numel() * o.element_size()
                     for o in _out_planes(leaf, B, R, "meta"))

    for name, leaf in tree.items():
        if name == "cols":
            for col in leaf.values():
                for p in col.values():
                    one(p)
        else:
            one(leaf)
    return total


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    return bind(native.load_library("decode"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with the argument and result types of the kernel's C
    interface set."""
    lib.decode_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_longlong, ctypes.c_void_p]
    lib.decode_launch.restype = ctypes.c_int
    lib.decode_leaf_words.argtypes = []
    lib.decode_leaf_words.restype = ctypes.c_int
    lib.decode_error_string.argtypes = [ctypes.c_int]
    lib.decode_error_string.restype = ctypes.c_char_p
    if lib.decode_leaf_words() != LEAF_WORDS:
        raise RuntimeError("csrc/decode.cu's leaf table differs from "
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
