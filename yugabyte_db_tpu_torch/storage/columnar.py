"""Columnar sorted runs: the SoA layout the device folds read.

Copy of the JAX package's ``storage/columnar.py`` generic build path: the
planes are byte-identical to the ones it builds (tests/test_torch_models.py
holds them so), which is what lets the JAX package's planes feed this
port's kernels in the differential tests.

- rows are MVCC versions sorted (encoded key asc, commit ht desc), grouped
  by key; a key's versions never span a block boundary;
- keys are represented device-side by a fixed-width big-endian word prefix
  as int32 "planes" (signed compare == byte order, utils.planes); full key
  bytes stay host-side for ties/materialization;
- every 64-bit ordered quantity (hybrid times, int64/double values) is two
  int32 planes; varlen values keep an 8-byte order-preserving prefix on
  device and their payload host-side.

Also copied: the row path's host helpers (``key_vals_at``,
``key_col_arrays``) and the hashed-prefix bloom
(``bloom_ready``, ``may_contain_hashed``), and the compressed plane
encodings (``encoded_arrays``, ``_encode_planes``, ``_encode_dict_col``,
with ``enc_dicts`` and ``enc_stats``): the tree is the JAX package's leaf
for leaf, its dictionaries built over the distinct values rather than row
by row. Not in this slice: the native one-pass flush
(``build_from_memtable``).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from operator import attrgetter

import numpy as np

from yugabyte_db_tpu_torch.models.datatypes import DataType
from yugabyte_db_tpu_torch.models.schema import Schema
from yugabyte_db_tpu_torch.ops import encodings as enc
from yugabyte_db_tpu_torch.storage.row_version import MAX_HT, RowVersion
from yugabyte_db_tpu_torch.utils import planes as P

DEFAULT_ROWS_PER_BLOCK = 2048
KEY_WORDS = 8  # 32-byte key prefix on device


def _varlen_raw(v) -> bytes:
    """Bytes for a varlen value's device prefix planes. Strings/bytes are
    their contents (order-preserving compares); opaque containers
    (collections, jsonb) serialize deterministically — their prefix is
    only an equality heuristic, predicates on them stay host-side."""
    if isinstance(v, str):
        return v.encode("utf-8", "surrogateescape")
    if isinstance(v, (bytes, bytearray)):
        return bytes(v)
    return repr(v).encode("utf-8", "surrogateescape")


def sorted_dictionary(vals: list):
    """(sorted unique raw values, int64 codes of ``vals``) of a string or
    binary column's non-NULL values, or None past ``DICT_MAX_VALUES``
    distinct raw values: the JAX package's ``sorted(set(raws))`` and
    ``code_of`` lookup, with the raw bytes taken once per distinct value
    instead of once per row (once per row for unhashable values: the
    collections and JSONB documents a CQL table stores)."""
    try:
        raw_of = {v: _varlen_raw(v) for v in set(vals)}
    except TypeError:
        raws = [_varlen_raw(v) for v in vals]
        uniq = sorted(set(raws))
        if len(uniq) > enc.DICT_MAX_VALUES:
            return None
        code_of_raw = {r: i for i, r in enumerate(uniq)}
        return uniq, np.fromiter(map(code_of_raw.__getitem__, raws),
                                 np.int64, len(raws))
    uniq = sorted(set(raw_of.values()))
    if len(uniq) > enc.DICT_MAX_VALUES:
        return None
    code_of_raw = {r: i for i, r in enumerate(uniq)}
    code_of = {v: code_of_raw[r] for v, r in raw_of.items()}
    return uniq, np.fromiter(map(code_of.__getitem__, vals), np.int64,
                             len(vals))


def dictionary_planes(uniq: list) -> tuple:
    """The dictionary's prefix planes (dhi, dlo), padded to
    ``pow2_bucket(len + 1)`` with the last (absent) slot zero."""
    cap = enc.pow2_bucket(len(uniq) + 1)
    dhi = np.zeros(cap, np.int32)
    dlo = np.zeros(cap, np.int32)
    if uniq:
        hi, lo = P.varlen_prefix_planes(uniq)
        dhi[:len(uniq)] = hi
        dlo[:len(uniq)] = lo
    return dhi, dlo


@dataclass
class ColumnData:
    """Host planes for one value column across all blocks: [B, R, ...]."""

    dtype: DataType
    set_: np.ndarray          # bool: version sets this column
    isnull: np.ndarray        # bool: set and value is NULL
    cmp_planes: np.ndarray    # [B, R, P] int32: order planes (compare/minmax)
    arith: np.ndarray | None  # [B, R] float32 arithmetic plane (numeric only)
    varlen: list | None       # per-block list of python payloads (varlen only)


@dataclass
class BlockMeta:
    min_key: bytes
    max_key: bytes
    num_valid: int


class ColumnarRun:
    """One immutable sorted run in blocked columnar layout."""

    def __init__(self, schema: Schema, rows_per_block: int = DEFAULT_ROWS_PER_BLOCK):
        self.schema = schema
        self.R = rows_per_block
        self.B = 0
        self.num_versions = 0
        self.blocks: list[BlockMeta] = []
        # Filled by build():
        self.key_planes: np.ndarray | None = None   # [B, R, KEY_WORDS] i32
        self.ht_hi = self.ht_lo = None              # [B, R] i32
        self.exp_hi = self.exp_lo = None            # [B, R] i32
        self.tomb = self.live = self.valid = self.group_start = None  # [B, R] bool
        self.cols: dict[int, ColumnData] = {}       # col_id -> ColumnData
        # Host-side exact data for ties/materialization/compaction —
        # [B, R] OBJECT ndarrays (bytes / RowVersion / key-value lists)
        # so compaction slices whole blocks as views:
        self.row_keys: np.ndarray | None = None     # [B, R] object (b"" pad)
        self.row_versions: np.ndarray | None = None  # [B, R] object
        self.min_key = b""
        self.max_key = b""
        self.max_ht = 0
        # Largest key-group version count. 1 means the run is "flat": every
        # row is its own group, so device kernels can skip the segmented
        # MVCC merge machinery entirely (the common post-compaction shape).
        self.max_group_versions = 0
        # Longest varlen value per column (bytes): values <= 8 are fully
        # captured by the device prefix planes, making prefix equality
        # EXACT — the device GROUP BY eligibility check for strings.
        self.varlen_max_len: dict[int, int] = {}
        # Longest encoded key (bytes): keys <= 32 are fully captured by
        # the KEY_WORDS prefix planes, so plane equality/order is EXACT —
        # the device compaction eligibility check.
        self.max_key_len = 0
        # Lazily-built per-key-column object arrays (global row index ->
        # decoded key value) for fancy-indexed materialization of key
        # columns on the batched scan path; decoded block by block under a
        # lock (concurrent scans share one run).
        self._kv_cols: list[np.ndarray] | None = None
        self._kv_blocks_done: set[int] = set()
        self.kv_ready = False  # True once every block's keys are decoded
        # Hashed-prefix bloom (storage.bloom): None = not built yet,
        # True = inapplicable (range-partitioned keys present).
        self._hash_bloom = None
        self._kv_lock = threading.Lock()
        # The compressed device plane tree, cached with the setting and
        # column count it was built for; ``enc_dicts`` holds each
        # dictionary column's sorted raw values (code -> value, what
        # string predicates promote against) and ``enc_stats`` the tree's
        # byte accounting, both set when the tree is built.
        self._enc_cache: tuple | None = None
        self.enc_dicts: dict[int, list[bytes]] = {}
        self.enc_stats: dict | None = None

    # -- construction ------------------------------------------------------
    @staticmethod
    def build(schema: Schema, entries: list[tuple[bytes, list[RowVersion]]],
              rows_per_block: int = DEFAULT_ROWS_PER_BLOCK) -> "ColumnarRun":
        """entries: (key asc, versions ht-desc) — MemTable.drain_sorted() or a
        compaction merge. Packs key groups into blocks without splitting."""
        run = ColumnarRun(schema, rows_per_block)
        R = run.R
        for key, versions in entries:
            n = len(versions)
            if n > run.max_group_versions:
                run.max_group_versions = n
            if len(key) > run.max_key_len:
                run.max_key_len = len(key)
        # Greedy block packing, key groups kept whole (shared with the
        # device-compaction gather path).
        ranges = ColumnarRun.pack_group_ranges(
            [len(v) for _, v in entries], R)
        blocks = [entries[g0:g0 + gn] for g0, gn, _rows in ranges]
        B = max(1, len(blocks))
        run.B = B
        run._alloc(B)
        for b, group_list in enumerate(blocks):
            run._fill_block(b, group_list)
        run.min_key = blocks[0][0][0] if blocks else b""
        run.max_key = blocks[-1][-1][0] if blocks else b""
        run.num_versions = sum(len(v) for _, v in entries)
        return run

    @staticmethod
    def pack_group_ranges(sizes: list[int], R: int):
        """Greedy packing of whole key groups into R-row blocks:
        [(first_group_index, group_count, row_count)] per block. The ONE
        packing implementation — build() and device compaction share it,
        so their block layouts always agree."""
        ranges = []
        g0, gn, fill = 0, 0, 0
        for gi, n in enumerate(sizes):
            if n > R:
                raise ValueError(
                    f"key has {n} versions > rows_per_block={R}; "
                    "GC history (compact with a cutoff) to shrink it")
            if fill + n > R and fill > 0:
                ranges.append((g0, gn, fill))
                g0, gn, fill = gi, 0, 0
            gn += 1
            fill += n
        if fill > 0 or not ranges:
            if gn > 0:
                ranges.append((g0, gn, fill))
        return ranges

    def _alloc(self, B: int) -> None:
        R = self.R
        self.key_planes = np.zeros((B, R, KEY_WORDS), dtype=np.int32)
        self.ht_hi = np.zeros((B, R), dtype=np.int32)
        self.ht_lo = np.zeros((B, R), dtype=np.int32)
        maxhi, maxlo = P.scalar_ht_planes(MAX_HT)
        self.exp_hi = np.full((B, R), maxhi, dtype=np.int32)
        self.exp_lo = np.full((B, R), maxlo, dtype=np.int32)
        self.tomb = np.zeros((B, R), dtype=bool)
        self.live = np.zeros((B, R), dtype=bool)
        self.valid = np.zeros((B, R), dtype=bool)
        # Padding rows are each their own group so they never join a real one.
        self.group_start = np.ones((B, R), dtype=bool)
        for c in self.schema.value_columns:
            P_cmp = 2 if c.dtype.device_planes == 2 else 1
            self.cols[c.col_id] = ColumnData(
                dtype=c.dtype,
                set_=np.zeros((B, R), dtype=bool),
                isnull=np.zeros((B, R), dtype=bool),
                cmp_planes=np.zeros((B, R, P_cmp), dtype=np.int32),
                arith=(np.zeros((B, R), dtype=np.float32)
                       if c.dtype.is_numeric else None),
                varlen=([[None] * R for _ in range(B)]
                        if not c.dtype.is_fixed_width else None),
            )
        # Object NDARRAYS (not lists): compaction slices whole blocks of
        # row payloads as views instead of per-row pointer copies.
        self.row_keys = np.empty((B, R), dtype=object)
        self.row_keys[:] = b""
        self.row_versions = np.empty((B, R), dtype=object)
        self.blocks = [BlockMeta(b"", b"", 0) for _ in range(B)]

    def _fill_block(self, b: int, group_list) -> None:
        """Encode one block's rows. List comprehensions collect parallel
        per-plane lists; every plane then encodes with a single vectorized
        numpy call (the per-row scalar encode was the write-path
        bottleneck: ~15 tiny numpy ops per version)."""
        vers_flat = [v for _key, versions in group_list for v in versions]
        keys_flat = [key for key, versions in group_list for _v in versions]
        gs = [i == 0 for _key, versions in group_list
              for i in range(len(versions))]
        n = len(vers_flat)
        self.blocks[b] = BlockMeta(
            group_list[0][0] if group_list else b"",
            group_list[-1][0] if group_list else b"",
            n,
        )
        if n == 0:
            return
        self.valid[b, :n] = True
        self.group_start[b, :n] = gs
        self.row_keys[b][:n] = keys_flat
        self.row_versions[b][:n] = vers_flat
        self._fill_planes(b, vers_flat, keys_flat)

    def stage_rows(self, rows: list[RowVersion]) -> None:
        """Encode ``rows`` into block 0 in the order given, each row its
        own key group, planes only (the device flush's staging): the same
        encoders as ``_fill_block``; validity, group starts, the host
        payloads and the block bounds stay unset."""
        if rows:
            self._fill_planes(0, rows, [r.key for r in rows])

    def _fill_planes(self, b: int, vers_flat: list, keys_flat: list) -> None:
        """The hybrid-time, expiry, flag, key and column planes of block
        ``b``'s rows ``vers_flat`` (keys ``keys_flat``)."""
        hts = list(map(attrgetter("ht"), vers_flat))
        tombs = list(map(attrgetter("tombstone"), vers_flat))
        lives = list(map(attrgetter("liveness"), vers_flat))
        exps = list(map(attrgetter("expire_ht"), vers_flat))
        exp_idx = [r for r, e in enumerate(exps) if e != MAX_HT]  # has_ttl
        exp_hts = [exps[r] for r in exp_idx]
        columns = list(map(attrgetter("columns"), vers_flat))
        col_rows: dict[int, list[int]] = {}
        col_vals: dict[int, list] = {}
        for cid in self.cols:  # dropped columns: id retired, not read
            col_rows[cid] = [r for r, c in enumerate(columns) if cid in c]
            col_vals[cid] = [columns[r][cid] for r in col_rows[cid]]
        n = len(vers_flat)
        self.tomb[b, :n] = tombs
        self.live[b, :n] = lives
        ht_arr = np.array(hts, dtype=np.int64)
        hi, lo = P.ht_to_planes(ht_arr)
        self.ht_hi[b, :n] = hi
        self.ht_lo[b, :n] = lo
        self.max_ht = max(self.max_ht, int(ht_arr.max()))
        if exp_idx:
            ehi, elo = P.ht_to_planes(np.array(exp_hts, dtype=np.int64))
            self.exp_hi[b, exp_idx] = ehi
            self.exp_lo[b, exp_idx] = elo
        kp = P.key_prefix_planes(keys_flat, KEY_WORDS)
        self.key_planes[b, :n] = kp
        for cid in self.cols:
            if col_rows[cid]:
                self._fill_column(b, cid, col_rows[cid], col_vals[cid])

    def _fill_column(self, b: int, cid: int, rows: list[int],
                     vals: list) -> None:
        """Vectorized encode of one column's set values within a block."""
        col = self.cols[cid]
        col.set_[b, np.array(rows, dtype=np.intp)] = True
        nn_rows = rows
        nn_vals = vals
        if any(v is None for v in vals):
            null_rows = [r for r, v in zip(rows, vals) if v is None]
            col.isnull[b, null_rows] = True
            nn_rows = [r for r, v in zip(rows, vals) if v is not None]
            nn_vals = [v for v in vals if v is not None]
            if not nn_rows:
                return
        idx = np.array(nn_rows, dtype=np.intp)  # converted once, used twice
        dt = col.dtype
        if dt.is_integer or dt == DataType.BOOL:
            if dt == DataType.BOOL:
                arr = np.array([int(bool(v)) for v in nn_vals],
                               dtype=np.int64)
            else:
                arr = np.array(nn_vals, dtype=np.int64)
            if col.cmp_planes.shape[-1] == 2:
                hi, lo = P.i64_to_ordered_planes(arr)
                col.cmp_planes[b, idx] = np.stack([hi, lo], axis=-1)
            else:
                col.cmp_planes[b, idx, 0] = arr
            if col.arith is not None:  # BOOL: orderable but not numeric
                col.arith[b, idx] = arr.astype(np.float32)
        elif dt == DataType.FLOAT:
            arr = np.array(nn_vals, dtype=np.float32)
            col.cmp_planes[b, idx, 0] = arr.view(np.int32)
            col.arith[b, idx] = arr
        elif dt == DataType.DOUBLE:
            arr = np.array(nn_vals, dtype=np.float64)
            hi, lo = P.f64_to_ordered_planes(arr)
            col.cmp_planes[b, idx] = np.stack([hi, lo], axis=-1)
            col.arith[b, idx] = arr.astype(np.float32)
        else:  # STRING / BINARY / opaque (collections, jsonb)
            raws = [_varlen_raw(v) for v in nn_vals]
            hi, lo = P.varlen_prefix_planes(raws)
            col.cmp_planes[b, idx] = np.stack([hi, lo], axis=-1)
            vl = col.varlen[b]
            for r, v in zip(nn_rows, nn_vals):
                vl[r] = v
            longest = max(map(len, raws))
            if longest > self.varlen_max_len.get(cid, 0):
                self.varlen_max_len[cid] = longest

    def encoded_arrays(self, setting: str = "auto"):
        """The compressed device plane tree for this run, or None when
        ``setting`` (the engine's ``plane_encoding``) is ``"off"`` or the
        run is empty: upload the plain planes instead. Encoded once per
        run and setting, and cached."""
        key = (setting, len(self.cols))
        if self._enc_cache is not None and self._enc_cache[0] == key:
            return self._enc_cache[1]
        tree = None
        if setting != "off" and self.num_versions:
            tree = self._encode_planes()
        self._enc_cache = (key, tree)
        return tree

    def _encode_planes(self):
        """One stats pass per plane picks its encoding; every fallback is
        per plane (a pathological column stays plain while its neighbours
        compress)."""
        tree = {
            "valid": enc.encode_bool_plane(self.valid),
            "group_start": enc.encode_bool_plane(self.group_start),
            "tomb": enc.encode_bool_plane(self.tomb),
            "live": enc.encode_bool_plane(self.live),
            "ht_hi": enc.encode_int_plane(self.ht_hi),
            "ht_lo": enc.encode_int_plane(self.ht_lo),
            "exp_hi": enc.encode_int_plane(self.exp_hi),
            "exp_lo": enc.encode_int_plane(self.exp_lo),
            "cols": {},
        }
        self.enc_dicts = {}
        for cid, col in self.cols.items():
            entry = {"set": enc.encode_bool_plane(col.set_),
                     "isnull": enc.encode_bool_plane(col.isnull)}
            cmp_leaf = None
            if col.dtype in (DataType.STRING, DataType.BINARY):
                cmp_leaf = self._encode_dict_col(cid, col)
            if cmp_leaf is None:
                cmp_leaf = enc.encode_int_plane(col.cmp_planes)
            entry["cmp"] = cmp_leaf
            if col.arith is not None and col.dtype in (
                    DataType.FLOAT, DataType.DOUBLE):
                # Float arithmetic planes are the value itself and upload;
                # every other numeric kind aggregates exactly from its
                # order planes, so its arithmetic plane is left out.
                entry["arith"] = enc.encode_float_plane(col.arith)
            tree["cols"][cid] = entry
        self.enc_stats = enc.tree_stats(tree)
        return tree

    def _encode_dict_col(self, cid: int, col: ColumnData):
        """The sorted per-run dictionary leaf of a string or binary
        column, or None (overflow, or no set non-NULL row): the caller
        falls back to the prefix planes' int encodings. Codes order as
        the values do, and the last (absent) slot decodes the zero
        prefix planes that unset and NULL rows hold."""
        if col.varlen is None:
            return None
        nn = col.set_ & ~col.isnull
        bi, ri = np.nonzero(nn)
        if bi.size == 0:
            return None
        vals = [col.varlen[b][r] for b, r in zip(bi.tolist(), ri.tolist())]
        built = sorted_dictionary(vals)
        if built is None:
            return None
        uniq, row_codes = built
        dhi, dlo = dictionary_planes(uniq)
        codes = np.full((self.B, self.R), dhi.shape[0] - 1, np.int64)
        codes[bi, ri] = row_codes
        self.enc_dicts[cid] = uniq
        return enc.dict_leaf(codes, dhi, dlo)

    # -- host-side access (the delta overlay's dirty keys) ------------------
    def iter_entries(self):
        """Yield (key, versions ht-desc) in key order."""
        for b in range(self.B):
            meta = self.blocks[b]
            r = 0
            while r < meta.num_valid:
                key = self.row_keys[b][r]
                versions = []
                while r < meta.num_valid and self.row_keys[b][r] == key:
                    versions.append(self.row_versions[b][r])
                    r += 1
                yield key, versions

    def group_versions(self, b: int, r: int) -> tuple[bytes, list[RowVersion]]:
        """The key group starting at (block b, row r): its key and versions
        ht-desc (r must be a group start)."""
        key = self.row_keys[b][r]
        versions = []
        meta = self.blocks[b]
        while r < meta.num_valid and self.row_keys[b][r] == key:
            versions.append(self.row_versions[b][r])
            r += 1
        return key, versions

    def iter_groups(self, row_lo: int, row_hi: int):
        """Yield (key, versions ht-desc) of the key groups whose first row
        lies in [row_lo, row_hi) (global rows; ``row_lo`` a group start,
        as ``lower_row`` gives it)."""
        R = self.R
        for b in range(row_lo // R, min(self.B, -(-row_hi // R))):
            r = row_lo - b * R if b == row_lo // R else 0
            end = min(self.blocks[b].num_valid, row_hi - b * R)
            while r < end:
                key, versions = self.group_versions(b, r)
                yield key, versions
                r += len(versions)

    def key_rows(self, key: bytes) -> tuple[int, list[RowVersion]]:
        """(global row index of the key's first version, its versions
        ht-desc); [] when the run does not hold the key. One bisect,
        then a read forward."""
        row = self.lower_row(key)
        out = []
        if row < self.total_rows():
            b, r = divmod(row, self.R)
            meta = self.blocks[b]
            keys, versions = self.row_keys[b], self.row_versions[b]
            while r < meta.num_valid and keys[r] == key:
                out.append(versions[r])
                r += 1
        return row, out

    def find_versions(self, key: bytes) -> list[RowVersion]:
        """All versions of key in this run (ht-desc), or []."""
        return self.key_rows(key)[1]

    # -- exact host-side key location (bounds) ------------------------------
    def lower_row(self, key: bytes) -> int:
        """Global row index (b*R + r) of the first valid row with
        row_key >= key. Exact on full key bytes — this is what turns scan
        bounds into device row-index bounds with no prefix-tie ambiguity."""
        import bisect as _bisect

        if self.B == 0 or not self.blocks[0].num_valid:
            return 0
        maxes = getattr(self, "_block_maxes", None)
        if maxes is None:
            # Runs are immutable once built; cache the per-block max-key
            # list (page scans bisect this on every request).
            maxes = self._block_maxes = [m.max_key for m in self.blocks
                                         if m.num_valid]
        b = _bisect.bisect_left(maxes, key)
        if b >= len(maxes):
            return self.total_rows()
        meta = self.blocks[b]
        r = _bisect.bisect_left(self.row_keys[b], key, 0, meta.num_valid)
        return b * self.R + r

    def upper_row(self, upper: bytes) -> int:
        """Global row index bound for exclusive upper (b'' = unbounded)."""
        if not upper:
            return self.total_rows()
        return self.lower_row(upper)

    def total_rows(self) -> int:
        return self.B * self.R

    def key_at(self, global_row: int) -> bytes:
        b, r = divmod(global_row, self.R)
        return self.row_keys[b][r]

    def key_vals_at(self, global_row: int) -> list:
        """Decoded key-column values (hashed + range) of the row's key,
        from ``key_col_arrays`` (its block decoded once)."""
        cols = self.key_col_arrays([global_row // self.R])
        return [c[global_row] for c in cols]

    def key_col_arrays(self, blocks=None) -> list[np.ndarray]:
        """One object ndarray per key column, indexed by global row index
        (b*R + r), holding the decoded key value. Decoded lazily PER
        BLOCK (``blocks``: iterable of block indices a scan touched;
        None = all) so a small page never pays an O(run) decode pass;
        batched scans then materialize key columns with one numpy
        fancy-index instead of per-row Python."""
        from yugabyte_db_tpu_torch.models.encoding import decode_doc_key

        nk = len(self.schema.key_columns)
        if self.kv_ready:  # lock-free fast path once fully decoded
            return self._kv_cols
        with self._kv_lock:
            if self._kv_cols is None:
                self._kv_cols = [np.empty(self.B * self.R, dtype=object)
                                 for _ in range(nk)]
            cols = self._kv_cols
            todo = range(self.B) if blocks is None else blocks
            for b in todo:
                if b in self._kv_blocks_done or b >= self.B:
                    continue
                n = self.blocks[b].num_valid
                rk = self.row_keys[b]
                base = b * self.R
                for r in range(n):
                    _, hashed, ranges = decode_doc_key(rk[r])
                    kv = hashed + ranges
                    for p in range(nk):
                        cols[p][base + r] = kv[p]
                # marked done only after the block is fully decoded, so a
                # concurrent reader can never see half-filled rows
                self._kv_blocks_done.add(b)
            if len(self._kv_blocks_done) == self.B:
                self.kv_ready = True
        return cols

    # -- run pruning (hashed-prefix bloom) ----------------------------------
    @property
    def bloom_ready(self) -> bool:
        """True once the lazy hash bloom exists (callers use this to
        avoid paying the build for workloads where a binary search on
        one or two runs is already cheap)."""
        return self._hash_bloom is not None

    def may_contain_hashed(self, prefix: bytes) -> bool:
        """Can this run contain any key with the given hashed-components
        prefix? False lets point gets / single-key scans skip the run
        entirely (reference: DocDbAwareFilterPolicy,
        src/yb/docdb/doc_key.h:551-575). Never a false negative."""
        bl = self._hash_bloom
        if bl is None:
            bl = self._build_hash_bloom()
        if bl is True:
            return True
        return bl.may_contain(prefix)

    def _build_hash_bloom(self):
        from yugabyte_db_tpu_torch.models.encoding import hashed_prefix
        from yugabyte_db_tpu_torch.storage.bloom import BloomFilter

        with self._kv_lock:
            if self._hash_bloom is not None:
                return self._hash_bloom
            bl = BloomFilter(self.num_versions or 1)
            prefixes: list[bytes] = []
            last = None
            for b in range(self.B):
                n = self.blocks[b].num_valid
                rk = self.row_keys[b]
                for r in range(n):
                    key = rk[r]
                    hp = hashed_prefix(key)
                    if not hp:
                        self._hash_bloom = True  # filter inapplicable
                        return True
                    if hp != last:
                        prefixes.append(hp)
                        last = hp
            bl.add_many(prefixes)
            self._hash_bloom = bl
            return bl
