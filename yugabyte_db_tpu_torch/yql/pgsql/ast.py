"""SQL (YSQL-dialect) statement AST.

Reference analog: the parse-tree the PostgreSQL fork hands to pggate —
statement shapes mirroring PgStatement subclasses (PgSelect/PgInsert/
PgUpdate/PgDelete/PgCreateTable, src/yb/yql/pggate/pg_select.cc etc.).
Scalar expressions reuse storage.expr nodes (Col/Const/BinOp) so an
aggregate argument parses straight into the device-lowerable tree.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from yugabyte_db_tpu_torch.models.datatypes import DataType


@dataclass
class ColumnDef:
    name: str
    dtype: DataType


@dataclass
class CreateTable:
    name: str
    columns: list[ColumnDef]
    hash_keys: list[str]
    range_keys: list[str]
    if_not_exists: bool = False
    num_tablets: int | None = None


@dataclass
class DropTable:
    name: str
    if_exists: bool = False


@dataclass
class AlterTable:
    """ALTER TABLE t ADD/DROP/RENAME COLUMN."""

    name: str
    action: str                    # "add" | "drop" | "rename"
    column: str | None = None
    dtype: DataType | None = None  # for "add"
    new_name: str | None = None    # for "rename"


@dataclass
class CreateIndex:
    name: str
    table: str
    column: str
    if_not_exists: bool = False


@dataclass
class DropIndex:
    name: str
    if_exists: bool = False


@dataclass
class CreateView:
    """CREATE [OR REPLACE] VIEW name AS <select> — the defining query is
    stored as SQL text and re-planned at use (reference: pg_rewrite)."""

    name: str
    query_sql: str
    select: object             # parsed ast.Select (validation)
    replace: bool = False


@dataclass
class DropView:
    name: str
    if_exists: bool = False


@dataclass
class CreateSequence:
    name: str
    if_not_exists: bool = False


@dataclass
class DropSequence:
    name: str
    if_exists: bool = False


@dataclass
class SeqFunc:
    """nextval('s') / currval('s') in a VALUES list or bare SELECT."""

    kind: str                  # "nextval" | "currval"
    sequence: str


@dataclass
class TxnControl:
    """BEGIN / COMMIT / ROLLBACK / SAVEPOINT name / ROLLBACK TO name /
    RELEASE name."""

    kind: str                  # "begin" | "commit" | "rollback" |
                               # "savepoint" | "rollback_to" | "release"
    name: str | None = None    # savepoint name


@dataclass
class BindMarker:
    """$N placeholder (1-based in SQL text, stored 0-based)."""

    index: int


@dataclass
class Insert:
    table: str
    columns: list[str]
    rows: list[list]           # one value list per VALUES tuple


@dataclass
class Rel:
    """One WHERE conjunct: column op value (IN carries a tuple).
    [NOT] EXISTS conjuncts carry column=None and a SubQuery value."""

    column: str | None
    op: str                    # = != < <= > >= IN | EXISTS | NOT EXISTS
    value: object


@dataclass
class Update:
    table: str
    assignments: list[tuple]   # (column, expr-or-literal)
    where: list[Rel]


@dataclass
class Delete:
    table: str
    where: list[Rel]


@dataclass
class JsonPath:
    """col -> 'key' -> 0 ->> 'leaf': jsonb extraction, host-evaluated
    (reference: jsonb operators over common/jsonb.cc)."""

    column: str
    steps: list                # [(op "->"|"->>", key str|int), ...]


@dataclass
class Agg:
    fn: str                    # count | sum | min | max | avg
    arg: object | None         # storage.expr tree, or None for count(*)


@dataclass
class Func:
    """Scalar function call (abs/upper/lower/length/coalesce/round/
    floor/ceil/concat/mod/substring/nullif/greatest/least), evaluated
    host-side above the storage seam — the work stock PG's executor does
    above the FDW (reference capability:
    src/postgres/src/backend/utils/adt)."""

    name: str
    args: list


@dataclass
class WindowFunc:
    """fn(arg) OVER (PARTITION BY ... ORDER BY ...) — evaluated
    host-side over the fetched relation, the work stock PG's
    nodeWindowAgg.c does above the FDW (reference capability:
    src/postgres/src/backend/executor/nodeWindowAgg.c). With ORDER BY,
    aggregate windows use PG's default frame (RANGE UNBOUNDED PRECEDING
    .. CURRENT ROW): running values where order-key peers share a
    result; without ORDER BY the frame is the whole partition."""

    fn: str                    # row_number|rank|dense_rank|lag|lead|
                               # sum|count|avg|min|max
    arg: object | None         # storage.expr tree (None: row_number etc)
    partition_by: list[str] = field(default_factory=list)
    order_by: list["OrderBy"] = field(default_factory=list)
    offset: int = 1            # lag/lead displacement
    default: object = None     # lag/lead out-of-partition fill


@dataclass
class SelectItem:
    expr: object               # "*" | storage.expr tree | Agg
    alias: str | None = None


@dataclass
class OrderBy:
    column: str
    desc: bool = False


@dataclass
class SubQuery:
    """A parenthesized SELECT used as a scalar / IN-list value in WHERE
    (uncorrelated; reference capability: the full PG executor runs
    subplans above the FDW, src/postgres/src/backend/executor)."""

    select: "Select"


@dataclass
class Join:
    """One JOIN clause: JOIN table [alias] ON a.x = b.y [AND ...]."""

    table: str
    alias: str | None
    kind: str                  # "inner" | "left"
    on: list[tuple]            # [(left_ref, right_ref)] column refs


@dataclass
class HavingRel:
    """One HAVING conjunct: <agg-or-scalar expr> op literal."""

    expr: object               # Agg | storage.expr tree
    op: str
    value: object


@dataclass
class Union:
    """Set operations over same-arity queries: UNION / EXCEPT /
    INTERSECT, each optionally ALL, left-associative with INTERSECT
    binding tighter (parser builds the precedence nesting); the
    trailing ORDER BY / LIMIT / OFFSET applies to the whole chain
    (PG semantics; reference capability: nodeSetOp.c / nodeAppend.c
    above the FDW)."""

    branches: list                   # [Select | Union, ...]
    alls: list                       # [bool] per joint, len-1 of branches
    order_by: list = field(default_factory=list)
    limit: object | None = None
    offset: object | None = None
    ctes: list = field(default_factory=list)
    kinds: list = field(default_factory=list)  # per joint: "union" |
                                               # "except" | "intersect"


@dataclass
class Select:
    items: list[SelectItem]
    table: str
    where: list[Rel] = field(default_factory=list)
    group_by: list[str] = field(default_factory=list)
    order_by: list[OrderBy] = field(default_factory=list)
    limit: object | None = None
    distinct: bool = False
    alias: str | None = None           # base-table alias
    joins: list[Join] = field(default_factory=list)
    having: list[HavingRel] = field(default_factory=list)
    offset: object | None = None       # LIMIT ... OFFSET n
    # WITH clause: [(name, Select)] evaluated before the body; later
    # CTEs and the body may reference earlier names as tables.
    ctes: list = field(default_factory=list)
