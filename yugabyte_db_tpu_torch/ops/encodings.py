"""Compressed plane encodings of a run's device planes.

The port's copy of the JAX package's ``ops/encodings.py``. A run's
[B, R] (or [B, R, P]) host plane may upload in one of five compressed
leaf forms; a leaf is either a bare array ("plain") or a single-key dict
naming the encoding:

  {"bits":    {"bw": i32 [B, R//32]}}          bool plane, 1 bit/row
  {"const":   {"cval": [1, 1, ...]}}           whole-plane constant
  {"delta16": {"dbase": i32 [B, 1, ...],
               "doff": u16 [B, R, ...]}}       per-block base + u16 offset
  {"rle":     {"rid": i16 [B, R],
               "rvals": [B, Rc, ...]}}         per-block run id -> value
  {"dict":    {"codes": u16 [B, R],
               "dhi": i32 [D], "dlo": i32 [D]}} sorted per-run dictionary

The numpy half (the encoders, the byte accounting and the block padding)
is the JAX module's, byte for byte, so both packages encode a run into
the same leaves. The invariants the kernels rely on are the JAX
module's: ``valid`` and ``group_start`` are only ever bits or plain; a
dictionary is the sorted unique full values of the column's set non-null
rows, its last slot (D-1) reserved for absent rows and decoding to the
prefix planes (0, 0); a dictionary ``cmp`` leaf decodes to three planes,
the two prefix planes and the int32 code plane that promoted ``"code"``
predicates compare; an rle leaf's run id is shared by every plane of the
leaf.

The torch half (``wplane``, ``decode_leaf``, ``decode_run``) decodes
leaves of torch tensors in plain PyTorch: the plain version of K10
(``ops.decode``, ``csrc/decode.cu``). On a tensor, the u16 arrays
(``doff``, ``codes``) are held as ``torch.int16`` and widened with
``& 0xFFFF``: ``torch.uint16`` has almost no kernels.
"""

from __future__ import annotations

import numpy as np
import torch

ENC_KINDS = ("bits", "const", "delta16", "rle", "dict")
_ENC_SET = frozenset(ENC_KINDS)

# Dictionary capacity: codes are uint16 and one slot is reserved for the
# absent (unset/NULL) rows, so at most 2^16 - 1 distinct values.
DICT_MAX_VALUES = (1 << 16) - 1
# rle is eligible when the worst block has at most R // RLE_MAX_RUN_DIV
# runs (denser planes gain too little over delta16/plain).
RLE_MAX_RUN_DIV = 8


def pow2_bucket(n: int) -> int:
    """Round a count up to the next power of two (>= 1) so encoded
    widths land in a small set of static shapes (bounded retraces)."""
    return 1 << max(0, int(n - 1).bit_length())


def leaf_kind(x):
    """Encoding kind of a plane leaf, or None for a plain ndarray.

    Encoded leaves are single-key dicts keyed by the kind; every other
    dict in a run tree (column entries, the cols map) has multiple keys
    or non-kind keys, so this never misfires on tree structure.
    """
    if isinstance(x, dict) and len(x) == 1:
        k = next(iter(x))
        if k in _ENC_SET:
            return k
    return None


def leaf_dims(leaf):
    """(B, R) of a leaf, or None when the leaf carries no block dim
    (const)."""
    k = leaf_kind(leaf)
    if k is None:
        return leaf.shape[0], leaf.shape[1]
    e = leaf[k]
    if k == "bits":
        return e["bw"].shape[0], e["bw"].shape[1] * 32
    if k == "delta16":
        return e["doff"].shape[0], e["doff"].shape[1]
    if k == "rle":
        return e["rid"].shape[0], e["rid"].shape[1]
    if k == "dict":
        return e["codes"].shape[0], e["codes"].shape[1]
    return None


def tree_encoded(run) -> bool:
    """True when any leaf of a run-plane tree is encoded."""
    for name, leaf in run.items():
        if name == "cols":
            for col in leaf.values():
                for p in col.values():
                    if leaf_kind(p) is not None:
                        return True
        elif leaf_kind(leaf) is not None:
            return True
    return False


def tree_dims(run):
    """(B, R) of a run-plane tree; "valid" always carries block dims."""
    d = leaf_dims(run["valid"])
    if d is None:  # pragma: no cover - valid is never const
        raise ValueError("run tree has no block-dimensioned valid plane")
    return d


# ---------------------------------------------------------------------------
# host-side encoders (numpy; run once per ColumnarRun at upload time)
# ---------------------------------------------------------------------------


def _as_cmp_words(p):
    """Bitwise view for value comparisons: floats compare as their bit
    patterns (NaN == NaN, -0.0 != 0.0) so decode is byte-identical."""
    if p.dtype.kind == "f":
        return p.view(np.int32 if p.dtype.itemsize == 4 else np.int64)
    return p


def encode_bits(plane):
    """[B, R] bool -> bits leaf (R must be a multiple of 32)."""
    B, R = plane.shape
    if R % 32 or plane.size == 0:
        return None
    w = plane.reshape(B, R // 32, 32).astype(np.uint32)
    bw = (w << np.arange(32, dtype=np.uint32)).sum(
        axis=-1, dtype=np.uint32)
    return {"bits": {"bw": bw.view(np.int32)}}


def encode_const(plane):
    """Whole-plane constant -> const leaf (cval keeps the dtype)."""
    if plane.size == 0:
        return None
    w = _as_cmp_words(plane)
    if not (w == w.reshape(-1, *w.shape[2:])[:1]).all():
        return None
    return {"const": {"cval": np.ascontiguousarray(plane[:1, :1])}}


def encode_delta16(plane):
    """Per-block int32 base + uint16 offsets; eligible when every
    block's span fits 16 bits (span computed in int64 — int32 max-min
    overflows)."""
    if plane.size == 0 or plane.dtype.kind not in "iu":
        return None
    p64 = plane.astype(np.int64)
    base = p64.min(axis=1, keepdims=True)
    span = (p64.max(axis=1, keepdims=True) - base).max(initial=0)
    if span > 0xFFFF:
        return None
    return {"delta16": {"dbase": base.astype(np.int32),
                        "doff": (p64 - base).astype(np.uint16)}}


def encode_rle(plane):
    """Per-block run-length leaf: rid[b, r] indexes rvals[b]; a run
    breaks where ANY plane of the leaf changes."""
    if plane.size == 0:
        return None
    B, R = plane.shape[0], plane.shape[1]
    w = _as_cmp_words(plane).reshape(B, R, -1)
    brk = np.ones((B, R), np.bool_)
    brk[:, 1:] = (w[:, 1:] != w[:, :-1]).any(axis=-1)
    rid = brk.cumsum(axis=1, dtype=np.int64) - 1
    nruns = int(rid[:, -1].max()) + 1
    if nruns > max(1, R // RLE_MAX_RUN_DIV):
        return None
    Rc = pow2_bucket(nruns)
    v3 = plane.reshape(B, R, -1)
    rvals = np.zeros((B, Rc, v3.shape[2]), plane.dtype)
    bi, ri = np.nonzero(brk)
    rvals[bi, rid[bi, ri]] = v3[bi, ri]
    if plane.ndim == 2:
        rvals = rvals[:, :, 0]
    return {"rle": {"rid": rid.astype(np.int16),
                    "rvals": np.ascontiguousarray(rvals)}}


def dict_leaf(codes, dhi, dlo):
    """Assemble a dict leaf. ``codes`` [B, R] row codes (absent rows
    already set to len(dhi) - 1); ``dhi``/``dlo`` the prefix planes of
    the sorted dictionary, absent slot zeroed, padded to a pow2 width."""
    return {"dict": {"codes": codes.astype(np.uint16),
                     "dhi": dhi.astype(np.int32),
                     "dlo": dlo.astype(np.int32)}}


def leaf_nbytes(leaf) -> int:
    """Encoded byte size of a leaf as uploaded (unpadded)."""
    k = leaf_kind(leaf)
    if k is None:
        return leaf.nbytes
    return sum(a.nbytes for a in leaf[k].values())


def _pick_smaller(plane, candidates):
    cands = [c for c in candidates if c is not None]
    if not cands:
        return plane
    best = min(cands, key=leaf_nbytes)
    return best if leaf_nbytes(best) < plane.nbytes else plane


def encode_bool_plane(plane):
    """bool planes bit-pack (never const: valid/group_start padding
    semantics depend on per-block words)."""
    e = encode_bits(np.ascontiguousarray(plane))
    return plane if e is None else e


def encode_int_plane(plane):
    """int32 [B, R(, P)] -> const | smaller of delta16/rle | plain."""
    c = encode_const(plane)
    if c is not None:
        return c
    return _pick_smaller(plane, [encode_delta16(plane),
                                 encode_rle(plane)])


def encode_float_plane(plane):
    """f32 arith planes: const | rle | plain (no delta on floats)."""
    c = encode_const(plane)
    if c is not None:
        return c
    return _pick_smaller(plane, [encode_rle(plane)])


# ---------------------------------------------------------------------------
# accounting (budget gates, metrics)
# ---------------------------------------------------------------------------


def leaf_padded_nbytes(leaf, B: int, pad_b: int) -> int:
    """Device byte size of a leaf once its block axis pads to pad_b.

    Block-dimensioned arrays scale by pad_b / B; const cval and dict
    dhi/dlo have no block axis and upload once.
    """
    k = leaf_kind(leaf)
    if k is None:
        per_block = int(np.prod(leaf.shape[1:], dtype=np.int64))
        return per_block * leaf.dtype.itemsize * pad_b
    total = 0
    no_block = {"const": ("cval",), "dict": ("dhi", "dlo")}.get(k, ())
    for name, a in leaf[k].items():
        if name in no_block:
            total += a.nbytes
        else:
            per_block = int(np.prod(a.shape[1:], dtype=np.int64))
            total += per_block * a.dtype.itemsize * pad_b
    return total


def tree_padded_nbytes(tree, B: int, pad_b: int) -> int:
    total = 0
    for name, leaf in tree.items():
        if name == "cols":
            for col in leaf.values():
                for p in col.values():
                    total += leaf_padded_nbytes(p, B, pad_b)
        else:
            total += leaf_padded_nbytes(leaf, B, pad_b)
    return total


def _leaf_logical_nbytes(leaf, B: int, R: int) -> int:
    """Plain-format bytes the leaf replaces (dict: the two int32 prefix
    planes; bits: one bool byte per row)."""
    k = leaf_kind(leaf)
    if k is None:
        return leaf.nbytes
    if k == "bits":
        return B * R
    if k == "dict":
        return B * R * 8
    if k == "const":
        cv = leaf[k]["cval"]
        return B * R * int(np.prod(cv.shape[2:], dtype=np.int64)) * \
            cv.dtype.itemsize
    if k == "delta16":
        d = leaf[k]["doff"]
        return B * R * int(np.prod(d.shape[2:], dtype=np.int64)) * 4
    rv = leaf[k]["rvals"]
    return B * R * int(np.prod(rv.shape[2:], dtype=np.int64)) * \
        rv.dtype.itemsize


def tree_stats(tree) -> dict:
    """Per-encoding byte accounting for metrics/memz: {"by_encoding":
    {kind: encoded_bytes}, "encoded_bytes", "logical_bytes"}."""
    B, R = tree_dims(tree)
    by = {}
    logical = 0

    def one(leaf):
        nonlocal logical
        k = leaf_kind(leaf) or "plain"
        by[k] = by.get(k, 0) + leaf_nbytes(leaf)
        logical += _leaf_logical_nbytes(leaf, B, R)

    for name, leaf in tree.items():
        if name == "cols":
            for col in leaf.values():
                for p in col.values():
                    one(p)
        else:
            one(leaf)
    return {"by_encoding": by, "encoded_bytes": sum(by.values()),
            "logical_bytes": logical}


# ---------------------------------------------------------------------------
# device-side block padding (DeviceRun upload)
# ---------------------------------------------------------------------------


def pad_leaf(leaf, pad_b: int, ones: bool = False):
    """Pad a leaf's block axis to pad_b blocks with the plain format's
    padding values: False/0 everywhere, except ``ones`` (group_start)
    pads all-True words so pad rows are each their own group."""
    k = leaf_kind(leaf)
    if k is None:
        B = leaf.shape[0]
        if pad_b <= B:
            return leaf
        fill = np.ones if ones else np.zeros
        pad = fill((pad_b - B,) + leaf.shape[1:], leaf.dtype)
        return np.concatenate([leaf, pad], axis=0)
    e = dict(leaf[k])
    if k == "bits":
        B = e["bw"].shape[0]
        if pad_b > B:
            fill = np.full((pad_b - B,) + e["bw"].shape[1:], -1,
                           np.int32) if ones else \
                np.zeros((pad_b - B,) + e["bw"].shape[1:], np.int32)
            e["bw"] = np.concatenate([e["bw"], fill], axis=0)
    elif k == "delta16":
        B = e["doff"].shape[0]
        if pad_b > B:
            for n in ("dbase", "doff"):
                pad = np.zeros((pad_b - B,) + e[n].shape[1:], e[n].dtype)
                e[n] = np.concatenate([e[n], pad], axis=0)
    elif k == "rle":
        B = e["rid"].shape[0]
        if pad_b > B:
            for n in ("rid", "rvals"):
                pad = np.zeros((pad_b - B,) + e[n].shape[1:], e[n].dtype)
                e[n] = np.concatenate([e[n], pad], axis=0)
    elif k == "dict":
        B = e["codes"].shape[0]
        if pad_b > B:
            # pad rows decode the absent slot: prefix planes (0, 0),
            # matching the plain format's zeroed pad rows.
            absent = e["dhi"].shape[0] - 1
            pad = np.full((pad_b - B,) + e["codes"].shape[1:], absent,
                          np.uint16)
            e["codes"] = np.concatenate([e["codes"], pad], axis=0)
    return {k: e}




# ---------------------------------------------------------------------------
# decode (plain PyTorch on tensor leaves: K10's plain version)
# ---------------------------------------------------------------------------


def _u16(t: torch.Tensor) -> torch.Tensor:
    """A u16 array held as int16 (or uint16), widened to int32."""
    return t.to(torch.int32) & 0xFFFF


def wplane(leaf, b0: int, K: int, R: int) -> torch.Tensor:
    """Decode a K-block window of a tensor leaf to the flat [K*R, ...]
    layout (the JAX ``wplane``)."""
    k = leaf_kind(leaf)
    if k is None:
        return leaf[b0:b0 + K].reshape((K * R,) + tuple(leaf.shape[2:]))
    e = leaf[k]
    if k == "bits":
        w = e["bw"][b0:b0 + K].to(torch.int32)
        shifts = torch.arange(32, dtype=torch.int32, device=w.device)
        bits = (w[:, :, None] >> shifts) & 1
        return bits.to(torch.bool).reshape(K * R)
    if k == "const":
        cv = e["cval"]
        tail = tuple(cv.shape[2:])
        return cv.reshape((1,) + tail).expand((K * R,) + tail).contiguous()
    if k == "delta16":
        base = e["dbase"][b0:b0 + K].to(torch.int32)
        off = _u16(e["doff"][b0:b0 + K])
        return (base + off).reshape((K * R,) + tuple(e["doff"].shape[2:]))
    if k == "rle":
        Rc = e["rvals"].shape[1]
        rid = e["rid"][b0:b0 + K].reshape(K * R).to(torch.int64)
        rv = e["rvals"][b0:b0 + K]
        flat = rv.reshape((K * Rc,) + tuple(rv.shape[2:]))
        idx = rid + Rc * (torch.arange(K * R, device=rid.device) // R)
        return flat[idx]
    # dict: the prefix planes, then the code plane
    codes = _u16(e["codes"][b0:b0 + K].reshape(K * R))
    ci = codes.to(torch.int64)
    return torch.stack([e["dhi"][ci], e["dlo"][ci], codes], dim=-1)


def require_plain(tree: dict, reader: str) -> None:
    """Raise where an encoded leaf reaches ``reader``, a reader of plain
    planes (the run's side-car, ``ops.decode``, is what it takes)."""
    leaves = [v for k, v in tree.items() if k != "cols"]
    leaves += [p for col in tree.get("cols", {}).values()
               for p in col.values()]
    for leaf in leaves:
        k = leaf_kind(leaf)
        if k is not None:
            raise ValueError(f"{reader} reads plain planes; a {k} leaf "
                             "reached it (decode the run first)")


def decode_leaf(leaf, B: int, R: int) -> torch.Tensor:
    """Full-plane decode back to the [B, R, ...] layout."""
    if leaf_kind(leaf) is None:
        return leaf
    flat = wplane(leaf, 0, B, R)
    return flat.reshape((B, R) + tuple(flat.shape[1:]))


def decode_run(run) -> dict:
    """Decode every leaf of a run-plane tree of tensors (the JAX
    ``decode_run``: a dictionary ``cmp`` comes out as [B, R, 3])."""
    B, R = tree_dims(run)
    out = {}
    for name, leaf in run.items():
        if name == "cols":
            out[name] = {
                cid: {n: decode_leaf(p, B, R) for n, p in col.items()}
                for cid, col in leaf.items()}
        else:
            out[name] = decode_leaf(leaf, B, R)
    return out
