"""SQL (YSQL dialect) recursive-descent parser.

Reference analog: the PostgreSQL fork's gram.y as exercised by YSQL —
here only the surface the executor lowers: CREATE/DROP TABLE,
CREATE/DROP INDEX, INSERT (multi-row VALUES), UPDATE, DELETE, SELECT
with arithmetic expressions, aggregates, GROUP BY / ORDER BY / LIMIT,
AND-conjunct WHERE with =/!=/</<=/>/>=/IN/BETWEEN, and $N bind markers.
Scalar expressions parse into storage.expr trees so aggregate arguments
lower directly onto the device GROUP BY kernel (ops.group_agg).

The port's copy of the JAX package's ``yql/pgsql/parser.py``. Its one
departure: INSERT, UPDATE and DELETE take a schema-qualified table
(``schema.name``) as SELECT does, where the JAX parser takes a bare name
only; PostgreSQL takes both (ROADMAP.md §3).
"""

from __future__ import annotations

import re

from yugabyte_db_tpu_torch.models.datatypes import DataType
from yugabyte_db_tpu_torch.storage.expr import BinOp, Col, Const
from yugabyte_db_tpu_torch.storage.scan_spec import AGG_FNS as _AGG_FN_TUPLE
from yugabyte_db_tpu_torch.utils.status import InvalidArgument
from yugabyte_db_tpu_torch.yql.pgsql import ast

AGG_FNS = frozenset(_AGG_FN_TUPLE)

_TOKEN_RE = re.compile(r"""
    \s+
  | (?P<comment>--[^\n]*)
  | (?P<string>'(?:[^']|'')*')
  | (?P<number>\d+\.\d+(?:[eE][+-]?\d+)?|\.\d+|\d+[eE][+-]?\d+|\d+)
  | (?P<param>\$\d+)
  | (?P<name>[A-Za-z_][A-Za-z_0-9]*|"(?:[^"]|"")*")
  | (?P<op>->>|->|<=|>=|<>|!=|=|<|>)
  | (?P<sym>[(),.;*+/-])
""", re.VERBOSE)

# SQL type name (first word, with optional qualifiers) -> DataType
_TYPES = {
    "TINYINT": DataType.INT8,
    "SMALLINT": DataType.INT16, "INT2": DataType.INT16,
    "INT": DataType.INT32, "INTEGER": DataType.INT32,
    "INT4": DataType.INT32,
    "BIGINT": DataType.INT64, "INT8": DataType.INT64,
    "TEXT": DataType.STRING, "VARCHAR": DataType.STRING,
    "CHAR": DataType.STRING,
    "REAL": DataType.FLOAT, "FLOAT4": DataType.FLOAT,
    "FLOAT8": DataType.DOUBLE,
    "BOOLEAN": DataType.BOOL, "BOOL": DataType.BOOL,
    "BYTEA": DataType.BINARY,
    "JSONB": DataType.JSONB, "JSON": DataType.JSONB,
    "TIMESTAMP": DataType.TIMESTAMP,  # microseconds since epoch (int64)
    "NUMERIC": DataType.DECIMAL, "DECIMAL": DataType.DECIMAL,
    "UUID": DataType.UUID,
    "INET": DataType.INET,
    "DATE": DataType.DATE,
    "TIME": DataType.TIME,
}


class Token:
    __slots__ = ("kind", "text", "pos")

    def __init__(self, kind, text, pos=0):
        self.kind = kind
        self.text = text
        self.pos = pos

    def __repr__(self):
        return f"{self.kind}:{self.text}"


def tokenize(sql: str) -> list[Token]:
    out, pos = [], 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if not m:
            raise InvalidArgument(
                f"SQL syntax error near {sql[pos:pos + 20]!r}")
        pos = m.end()
        for kind in ("string", "number", "param", "name", "op", "sym"):
            text = m.group(kind)
            if text is not None:
                out.append(Token(kind, text, m.start(kind)))
                break
    return out


class Parser:
    def __init__(self, sql: str):
        self.raw = sql
        self.toks = tokenize(sql)
        self.i = 0

    # -- token helpers -----------------------------------------------------
    def peek(self) -> Token | None:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> Token:
        t = self.peek()
        if t is None:
            raise InvalidArgument("unexpected end of statement")
        self.i += 1
        return t

    def at_kw(self, *kws) -> bool:
        t = self.peek()
        return (t is not None and t.kind == "name"
                and t.text.upper() in kws)

    def take_kw(self, *kws) -> bool:
        if self.at_kw(*kws):
            self.i += 1
            return True
        return False

    def expect_kw(self, kw: str) -> None:
        if not self.take_kw(kw):
            raise InvalidArgument(f"expected {kw}, got {self.peek()}")

    def at_sym(self, s: str) -> bool:
        t = self.peek()
        return t is not None and t.kind in ("sym", "op") and t.text == s

    def take_sym(self, s: str) -> bool:
        if self.at_sym(s):
            self.i += 1
            return True
        return False

    def expect_sym(self, s: str) -> None:
        if not self.take_sym(s):
            raise InvalidArgument(f"expected {s!r}, got {self.peek()}")

    def ident(self) -> str:
        t = self.next()
        if t.kind != "name":
            raise InvalidArgument(f"expected identifier, got {t}")
        if t.text.startswith('"'):
            return t.text[1:-1].replace('""', '"')
        return t.text.lower()

    def literal(self):
        neg = self.take_sym("-")
        t = self.next()
        if t.kind == "param":
            if neg:
                raise InvalidArgument("cannot negate a bind marker")
            idx = int(t.text[1:])
            if idx < 1:  # $0 would alias params[-1] via negative indexing
                raise InvalidArgument(
                    f"bind markers are 1-based: {t.text}")
            return ast.BindMarker(idx - 1)
        if t.kind == "string":
            if neg:
                raise InvalidArgument("cannot negate a string")
            return t.text[1:-1].replace("''", "'")
        if t.kind == "number":
            v = (float(t.text) if any(c in t.text for c in ".eE")
                 else int(t.text))
            return -v if neg else v
        if t.kind == "name" and not neg:
            up = t.text.upper()
            if up in ("NEXTVAL", "CURRVAL") and self.at_sym("("):
                self.i -= 1  # re-read the function name
                return self._seq_func()
            if up == "TRUE":
                return True
            if up == "FALSE":
                return False
            if up == "NULL":
                return None
        raise InvalidArgument(f"expected literal, got {t}")

    # -- statements --------------------------------------------------------
    def parse(self):
        t = self.peek()
        if t is None:
            raise InvalidArgument("empty statement")
        head = t.text.upper()
        if head == "CREATE":
            self.next()
            if self.at_kw("TABLE"):
                return self._create_table()
            if self.at_kw("INDEX", "UNIQUE"):
                return self._create_index()
            if self.take_kw("OR"):
                self.expect_kw("REPLACE")
                self.expect_kw("VIEW")
                return self._create_view(replace=True)
            if self.take_kw("VIEW"):
                return self._create_view(replace=False)
            if self.take_kw("SEQUENCE"):
                ine = False
                if self.take_kw("IF"):
                    self.expect_kw("NOT")
                    self.expect_kw("EXISTS")
                    ine = True
                return ast.CreateSequence(self.ident(), ine)
            raise InvalidArgument(f"cannot CREATE {self.peek()}")
        if head == "DROP":
            self.next()
            if self.take_kw("TABLE"):
                return ast.DropTable(*self._name_if_exists())
            if self.take_kw("INDEX"):
                return ast.DropIndex(*self._name_if_exists())
            if self.take_kw("VIEW"):
                return ast.DropView(*self._name_if_exists())
            if self.take_kw("SEQUENCE"):
                return ast.DropSequence(*self._name_if_exists())
            raise InvalidArgument(f"cannot DROP {self.peek()}")
        if head in ("BEGIN", "START"):
            self.next()
            if head == "START":
                self.expect_kw("TRANSACTION")
            else:
                self.take_kw("TRANSACTION", "WORK")
            self.take_sym(";")
            return ast.TxnControl("begin")
        if head == "COMMIT":
            self.next()
            self.take_kw("TRANSACTION", "WORK")
            self.take_sym(";")
            return ast.TxnControl("commit")
        if head in ("ROLLBACK", "ABORT"):
            self.next()
            if self.take_kw("TO"):
                self.take_kw("SAVEPOINT")
                name = self.ident()
                self.take_sym(";")
                return ast.TxnControl("rollback_to", name)
            self.take_kw("TRANSACTION", "WORK")
            self.take_sym(";")
            return ast.TxnControl("rollback")
        if head == "SAVEPOINT":
            self.next()
            name = self.ident()
            self.take_sym(";")
            return ast.TxnControl("savepoint", name)
        if head == "RELEASE":
            self.next()
            self.take_kw("SAVEPOINT")
            name = self.ident()
            self.take_sym(";")
            return ast.TxnControl("release", name)
        if head == "ALTER":
            return self._alter_table()
        if head == "INSERT":
            return self._insert()
        if head == "UPDATE":
            return self._update()
        if head == "DELETE":
            return self._delete()
        if head == "SELECT":
            return self._select_entry()
        if head == "WITH":
            return self._with_select()
        raise InvalidArgument(f"unsupported statement {head}")

    def _select_entry(self):
        """SELECT possibly followed by UNION / EXCEPT / INTERSECT
        [ALL] chains; INTERSECT binds tighter (PG precedence) and the
        trailing ORDER BY/LIMIT/OFFSET binds to the whole chain."""
        branches = [self._select()]
        seps: list[tuple] = []
        while True:
            if self.take_kw("UNION"):
                kind = "union"
            elif self.take_kw("EXCEPT"):
                kind = "except"
            elif self.take_kw("INTERSECT"):
                kind = "intersect"
            else:
                break
            seps.append((kind, bool(self.take_kw("ALL"))))
            branches.append(self._select())
        if not seps:
            return branches[0]
        for b in branches[:-1]:
            if b.order_by or b.limit is not None or b.offset is not None:
                raise InvalidArgument(
                    "ORDER BY/LIMIT is only supported after the last "
                    "branch of a set operation (it applies to the "
                    "whole result)")
        import dataclasses as _dc

        last = branches[-1]
        order_by, limit, offset = last.order_by, last.limit, last.offset
        branches[-1] = _dc.replace(last, order_by=[], limit=None,
                                   offset=None)

        def joint(a, kind, alln, b):
            return ast.Union([a, b], [alln], kinds=[kind])

        # Precedence pass 1: fold INTERSECT joints into their left
        # neighbor; pass 2: left-fold the remaining UNION/EXCEPT.
        vals = [branches[0]]
        ops: list[tuple] = []
        for (kind, alln), b in zip(seps, branches[1:]):
            if kind == "intersect":
                vals[-1] = joint(vals[-1], kind, alln, b)
            else:
                ops.append((kind, alln))
                vals.append(b)
        acc = vals[0]
        for (kind, alln), b in zip(ops, vals[1:]):
            acc = joint(acc, kind, alln, b)
        return _dc.replace(acc, order_by=order_by, limit=limit,
                           offset=offset)

    def _with_select(self):
        """WITH name AS (select) [, name AS (select)]* SELECT ... — CTEs
        (reference capability: stock PG CTE scans above the FDW,
        src/postgres/src/backend/executor/nodeCtescan.c)."""
        self.expect_kw("WITH")
        if self.at_kw("RECURSIVE"):
            raise InvalidArgument("WITH RECURSIVE is not supported")
        ctes = []
        while True:
            name = self.ident()
            self.expect_kw("AS")
            self.expect_sym("(")
            sel = self._select_entry()
            self.expect_sym(")")
            ctes.append((name, sel))
            if not self.take_sym(","):
                break
        body = self._select_entry()
        body.ctes = ctes
        return body

    def _name_if_exists(self):
        if_exists = False
        if self.take_kw("IF"):
            self.expect_kw("EXISTS")
            if_exists = True
        name = self.ident()
        self.take_sym(";")
        return name, if_exists

    # -- DDL ---------------------------------------------------------------
    def _type(self) -> DataType:
        name = self.ident().upper()
        if name == "DOUBLE":
            self.take_kw("PRECISION")
            return DataType.DOUBLE
        if name == "FLOAT":
            return DataType.DOUBLE  # SQL FLOAT defaults to float8
        dt = _TYPES.get(name)
        if dt is None:
            raise InvalidArgument(f"unknown type {name}")
        if self.take_sym("("):  # VARCHAR(n) / NUMERIC(p,s): args ignored
            self.literal()
            if self.take_sym(","):
                self.literal()
            self.expect_sym(")")
        return dt

    def _create_table(self) -> ast.CreateTable:
        self.expect_kw("TABLE")
        if_not_exists = False
        if self.take_kw("IF"):
            self.expect_kw("NOT")
            self.expect_kw("EXISTS")
            if_not_exists = True
        name = self.ident()
        self.expect_sym("(")
        columns: list[ast.ColumnDef] = []
        hash_keys: list[str] = []
        range_keys: list[str] = []
        while True:
            if self.take_kw("PRIMARY"):
                self.expect_kw("KEY")
                self.expect_sym("(")
                # YSQL shape: PRIMARY KEY ((h1, h2), r1, r2 [ASC|DESC]).
                # A plain list makes the FIRST column the hash column
                # (YSQL's default for the leading PK column).
                if self.take_sym("("):
                    while not self.take_sym(")"):
                        hash_keys.append(self.ident())
                        self.take_sym(",")
                else:
                    hash_keys.append(self.ident())
                    self.take_kw("HASH")
                while self.take_sym(","):
                    range_keys.append(self.ident())
                    self.take_kw("ASC") or self.take_kw("DESC")
                self.expect_sym(")")
            else:
                cname = self.ident()
                dtype = self._type()
                columns.append(ast.ColumnDef(cname, dtype))
                if self.take_kw("PRIMARY"):
                    self.expect_kw("KEY")
                    hash_keys.append(cname)
                self.take_kw("NOT") and self.expect_kw("NULL")
            if not self.take_sym(","):
                break
        self.expect_sym(")")
        num_tablets = None
        if self.take_kw("SPLIT"):
            self.expect_kw("INTO")
            num_tablets = int(self.literal())
            self.expect_kw("TABLETS")
        self.take_sym(";")
        if not hash_keys:
            raise InvalidArgument("table has no primary key")
        return ast.CreateTable(name, columns, hash_keys, range_keys,
                               if_not_exists, num_tablets)

    def _alter_table(self) -> ast.AlterTable:
        self.expect_kw("ALTER")
        self.expect_kw("TABLE")
        name = self.ident()
        if self.take_kw("ADD"):
            self.take_kw("COLUMN")
            col = self.ident()
            dtype = self._type()
            self.take_sym(";")
            return ast.AlterTable(name, "add", col, dtype)
        if self.take_kw("DROP"):
            self.take_kw("COLUMN")
            col = self.ident()
            self.take_sym(";")
            return ast.AlterTable(name, "drop", col)
        if self.take_kw("RENAME"):
            self.take_kw("COLUMN")
            old = self.ident()
            self.expect_kw("TO")
            new = self.ident()
            self.take_sym(";")
            return ast.AlterTable(name, "rename", old, new_name=new)
        raise InvalidArgument(
            f"expected ADD/DROP/RENAME, got {self.peek()}")

    def _create_index(self) -> ast.CreateIndex:
        self.take_kw("UNIQUE")  # accepted, enforced as a plain index
        self.expect_kw("INDEX")
        if_not_exists = False
        if self.take_kw("IF"):
            self.expect_kw("NOT")
            self.expect_kw("EXISTS")
            if_not_exists = True
        name = self.ident()
        self.expect_kw("ON")
        table = self.ident()
        self.expect_sym("(")
        column = self.ident()
        self.expect_sym(")")
        self.take_sym(";")
        return ast.CreateIndex(name, table, column, if_not_exists)

    # -- DML ---------------------------------------------------------------
    def _insert(self) -> ast.Insert:
        self.expect_kw("INSERT")
        self.expect_kw("INTO")
        table = self._table_name()
        self.expect_sym("(")
        columns = [self.ident()]
        while self.take_sym(","):
            columns.append(self.ident())
        self.expect_sym(")")
        self.expect_kw("VALUES")
        rows = []
        while True:
            self.expect_sym("(")
            vals = [self.literal()]
            while self.take_sym(","):
                vals.append(self.literal())
            self.expect_sym(")")
            if len(vals) != len(columns):
                raise InvalidArgument(
                    f"{len(columns)} columns but {len(vals)} values")
            rows.append(vals)
            if not self.take_sym(","):
                break
        self.take_sym(";")
        return ast.Insert(table, columns, rows)

    def _update(self) -> ast.Update:
        self.expect_kw("UPDATE")
        table = self._table_name()
        self.expect_kw("SET")
        assignments = []
        while True:
            cname = self.ident()
            self.expect_sym("=")
            assignments.append((cname, self._scalar_or_literal()))
            if not self.take_sym(","):
                break
        where = self._where()
        self.take_sym(";")
        return ast.Update(table, assignments, where)

    def _delete(self) -> ast.Delete:
        self.expect_kw("DELETE")
        self.expect_kw("FROM")
        table = self._table_name()
        where = self._where()
        self.take_sym(";")
        return ast.Delete(table, where)

    # -- SELECT ------------------------------------------------------------
    _CLAUSE_KWS = ("FROM", "WHERE", "GROUP", "ORDER", "LIMIT", "OFFSET",
                   "AS", "JOIN", "INNER", "LEFT", "RIGHT", "FULL",
                   "CROSS", "ON", "HAVING", "AND", "OR", "DESC", "ASC",
                   "UNION", "EXCEPT", "INTERSECT")

    SCALAR_FNS = ("abs", "upper", "lower", "length", "coalesce", "round",
                  "floor", "ceil", "ceiling", "concat", "mod",
                  "substring", "substr", "nullif", "greatest", "least")

    def _create_view(self, replace: bool):
        name = self.ident()
        self.expect_kw("AS")
        t = self.peek()
        if t is None:
            raise InvalidArgument("CREATE VIEW needs a query")
        query_sql = self.raw[t.pos:].rstrip().rstrip(";")
        select = self._select_entry()  # validated now, re-parsed at use
        return ast.CreateView(name, query_sql, select, replace)

    def _select(self) -> ast.Select:
        self.expect_kw("SELECT")
        distinct = bool(self.take_kw("DISTINCT"))
        items = [self._select_item()]
        while self.take_sym(","):
            items.append(self._select_item())
        if not self.at_kw("FROM"):
            # FROM-less SELECT: constant/sequence-function items
            # (PG: SELECT nextval('s')); column references need a FROM.
            for it in items:
                if isinstance(it.expr, Col) or it.expr == "*":
                    raise InvalidArgument("SELECT needs a FROM clause")
            return ast.Select(items, None)
        self.expect_kw("FROM")
        table = self._table_name()
        alias = self._table_alias()
        joins: list[ast.Join] = []
        while True:
            if self.take_kw("JOIN"):
                kind = "inner"
            elif self.at_kw("INNER") and self._kw_ahead(1, "JOIN"):
                self.next(); self.expect_kw("JOIN")
                kind = "inner"
            elif self.at_kw("LEFT"):
                self.next()
                self.take_kw("OUTER")
                self.expect_kw("JOIN")
                kind = "left"
            elif self.at_kw("RIGHT"):
                self.next()
                self.take_kw("OUTER")
                self.expect_kw("JOIN")
                kind = "right"
            elif self.at_kw("FULL"):
                self.next()
                self.take_kw("OUTER")
                self.expect_kw("JOIN")
                kind = "full"
            else:
                break
            jtable = self._table_name()
            jalias = self._table_alias()
            self.expect_kw("ON")
            on = [self._on_pair()]
            while self.take_kw("AND"):
                on.append(self._on_pair())
            joins.append(ast.Join(jtable, jalias, kind, on))
        where = self._where()
        group_by: list[str] = []
        if self.take_kw("GROUP"):
            self.expect_kw("BY")
            group_by.append(self._colref())
            while self.take_sym(","):
                group_by.append(self._colref())
        having: list[ast.HavingRel] = []
        if self.take_kw("HAVING"):
            while True:
                expr = self._item_expr()
                t = self.next()
                if t.kind != "op":
                    raise InvalidArgument(
                        f"expected operator in HAVING, got {t}")
                op = "!=" if t.text == "<>" else t.text
                having.append(ast.HavingRel(expr, op, self.literal()))
                if not self.take_kw("AND"):
                    break
        order_by: list[ast.OrderBy] = []
        if self.take_kw("ORDER"):
            self.expect_kw("BY")
            while True:
                col = self._colref()
                desc = bool(self.take_kw("DESC"))
                if not desc:
                    self.take_kw("ASC")
                order_by.append(ast.OrderBy(col, desc))
                if not self.take_sym(","):
                    break
        limit = None
        offset = None
        while True:  # PG accepts LIMIT/OFFSET in either order
            if limit is None and self.take_kw("LIMIT"):
                limit = self.literal()
            elif offset is None and self.take_kw("OFFSET"):
                offset = self.literal()
            else:
                break
        self.take_sym(";")
        return ast.Select(items, table, where, group_by, order_by, limit,
                          distinct, alias, joins, having, offset=offset)

    def _kw_ahead(self, n: int, kw: str) -> bool:
        t = self.toks[self.i + n] if self.i + n < len(self.toks) else None
        return t is not None and t.kind == "name" and t.text.upper() == kw

    def _table_name(self) -> str:
        """Possibly schema-qualified table: name or schema.name (the
        pg_catalog / information_schema surface)."""
        name = self.ident()
        if self.at_sym("."):
            self.next()
            return f"{name}.{self.ident()}"
        return name

    def _table_alias(self) -> str | None:
        if self.take_kw("AS"):
            return self.ident()
        t = self.peek()
        if (t is not None and t.kind == "name"
                and t.text.upper() not in self._CLAUSE_KWS):
            return self.ident()
        return None

    def _colref(self) -> str:
        """Possibly-qualified column reference: name or alias.name."""
        name = self.ident()
        if self.at_sym("."):
            self.next()
            return f"{name}.{self.ident()}"
        return name

    def _on_pair(self) -> tuple:
        left = self._colref()
        self.expect_sym("=")
        return (left, self._colref())

    def _select_item(self) -> ast.SelectItem:
        if self.take_sym("*"):
            return ast.SelectItem("*")
        expr = self._item_expr()
        alias = None
        if self.take_kw("AS"):
            alias = self.ident()
        elif (self.peek() is not None and self.peek().kind == "name"
              and self.peek().text.upper() not in self._CLAUSE_KWS):
            alias = self.ident()
        return ast.SelectItem(expr, alias)

    def _seq_func(self):
        """nextval('s') / currval('s') — the only SQL functions the
        value grammar knows (used from VALUES lists and select items)."""
        fn = self.ident().lower()
        self.expect_sym("(")
        seq = self.next()
        if seq.kind != "string":
            raise InvalidArgument(f"{fn} takes a sequence name string")
        self.expect_sym(")")
        return ast.SeqFunc(fn, seq.text[1:-1])

    def _item_expr(self):
        t = self.peek()
        if (t is not None and t.kind == "name"
                and t.text.upper() in ("NEXTVAL", "CURRVAL")
                and self.i + 1 < len(self.toks)
                and self.toks[self.i + 1].text == "("):
            return self._seq_func()
        if (t is not None and t.kind == "name"
                and t.text.lower() in AGG_FNS
                and self.i + 1 < len(self.toks)
                and self.toks[self.i + 1].text == "("):
            fn = self.ident().lower()
            self.expect_sym("(")
            if self.take_sym("*"):
                if fn != "count":
                    raise InvalidArgument(f"{fn}(*) is not valid")
                arg = None
            else:
                arg = self._scalar()
            self.expect_sym(")")
            if self.at_kw("OVER"):
                return self._over(fn, arg)
            return ast.Agg(fn, arg)
        if (t is not None and t.kind == "name"
                and t.text.lower() in self.WINDOW_FNS
                and self.i + 1 < len(self.toks)
                and self.toks[self.i + 1].text == "("):
            fn = self.ident().lower()
            self.expect_sym("(")
            arg, offset, default = None, 1, None
            if not self.at_sym(")"):
                arg = self._scalar()
                if self.take_sym(","):
                    offset = self.literal()
                    if self.take_sym(","):
                        default = self.literal()
            self.expect_sym(")")
            if fn in ("lag", "lead") and arg is None:
                raise InvalidArgument(f"{fn}() needs an argument")
            if not self.at_kw("OVER"):
                raise InvalidArgument(f"{fn}() requires an OVER clause")
            return self._over(fn, arg, offset, default)
        return self._scalar()

    WINDOW_FNS = frozenset({"row_number", "rank", "dense_rank",
                            "lag", "lead"})

    def _over(self, fn, arg, offset=1, default=None) -> ast.WindowFunc:
        """OVER ( [PARTITION BY cols] [ORDER BY col [ASC|DESC], ...] )."""
        self.expect_kw("OVER")
        self.expect_sym("(")
        partition: list[str] = []
        order: list[ast.OrderBy] = []
        if self.take_kw("PARTITION"):
            self.expect_kw("BY")
            partition.append(self._colref())
            while self.take_sym(","):
                partition.append(self._colref())
        if self.take_kw("ORDER"):
            self.expect_kw("BY")
            while True:
                col = self._colref()
                desc = bool(self.take_kw("DESC"))
                if not desc:
                    self.take_kw("ASC")
                order.append(ast.OrderBy(col, desc))
                if not self.take_sym(","):
                    break
        self.expect_sym(")")
        return ast.WindowFunc(fn, arg, partition, order,
                              offset=offset, default=default)

    # -- scalar expressions (storage.expr trees) ---------------------------
    def _scalar(self):
        node = self._term()
        while self.at_sym("+") or self.at_sym("-"):
            op = self.next().text
            node = BinOp(op, node, self._term())
        return node

    def _term(self):
        node = self._factor()
        while self.at_sym("*"):
            self.next()
            node = BinOp("*", node, self._factor())
        return node

    def _factor(self):
        if self.take_sym("("):
            node = self._scalar()
            self.expect_sym(")")
            return node
        t = self.peek()
        if t is not None and (t.kind == "number" or self.at_sym("-")):
            return Const(self.literal())
        if t is not None and t.kind == "string":
            return Const(self.literal())
        if (t is not None and t.kind == "name"
                and t.text.lower() in self.SCALAR_FNS
                and self.i + 1 < len(self.toks)
                and self.toks[self.i + 1].text == "("):
            fn = self.ident().lower()
            self.expect_sym("(")
            args = []
            if not self.at_sym(")"):
                args.append(self._scalar())
                while self.take_sym(","):
                    args.append(self._scalar())
            self.expect_sym(")")
            return ast.Func(fn, args)
        name = self._colref()
        # jsonb path: col -> 'key' -> 0 ->> 'leaf'
        steps = []
        while self.peek() is not None and self.peek().kind == "op" \
                and self.peek().text in ("->", "->>"):
            op = self.next().text
            steps.append((op, self.literal()))
        if steps:
            return ast.JsonPath(name, steps)
        return Col(name)

    def _scalar_or_literal(self):
        """UPDATE SET rhs: a literal (any type) or a column expression."""
        t = self.peek()
        if t is not None and (t.kind in ("string", "param")
                              or (t.kind == "name" and t.text.upper()
                                  in ("TRUE", "FALSE", "NULL"))):
            return self.literal()
        if t is not None and t.kind == "number":
            return self.literal()
        if t is not None and self.at_sym("-"):
            return self.literal()
        return self._scalar()

    # -- WHERE -------------------------------------------------------------
    def _at_subquery(self) -> bool:
        return self.at_sym("(") and self._kw_ahead(1, "SELECT")

    def _subquery(self) -> ast.SubQuery:
        self.expect_sym("(")
        sel = self._select()
        self.expect_sym(")")
        return ast.SubQuery(sel)

    def _where(self) -> list[ast.Rel]:
        rels: list[ast.Rel] = []
        if not self.take_kw("WHERE"):
            return rels
        while True:
            neg = False
            if self.at_kw("NOT") and self._kw_ahead(1, "EXISTS"):
                self.next()
                neg = True
            if self.at_kw("EXISTS"):
                self.expect_kw("EXISTS")
                if not self._at_subquery():
                    raise InvalidArgument(
                        "EXISTS requires a parenthesized subquery")
                rels.append(ast.Rel(None,
                                    "NOT EXISTS" if neg else "EXISTS",
                                    self._subquery()))
                if not self.take_kw("AND"):
                    break
                continue
            col = self._colref()
            if self.take_kw("BETWEEN"):
                lo = self.literal()
                self.expect_kw("AND")
                hi = self.literal()
                rels.append(ast.Rel(col, ">=", lo))
                rels.append(ast.Rel(col, "<=", hi))
            elif self.take_kw("IN"):
                if self._at_subquery():
                    rels.append(ast.Rel(col, "IN", self._subquery()))
                else:
                    self.expect_sym("(")
                    vals = [self.literal()]
                    while self.take_sym(","):
                        vals.append(self.literal())
                    self.expect_sym(")")
                    rels.append(ast.Rel(col, "IN", tuple(vals)))
            else:
                t = self.next()
                if t.kind != "op":
                    raise InvalidArgument(f"expected operator, got {t}")
                op = "!=" if t.text == "<>" else t.text
                if self._at_subquery():
                    value = self._subquery()
                else:
                    v = self.peek()
                    if (v is not None and v.kind == "name"
                            and v.text.upper() not in ("TRUE", "FALSE",
                                                       "NULL")):
                        # Column reference as the rhs: col-vs-col inside
                        # a subquery is how correlation is spelled; the
                        # executor resolves outer refs per row.
                        value = Col(self._colref())
                    else:
                        value = self.literal()
                rels.append(ast.Rel(col, op, value))
            if not self.take_kw("AND"):
                break
        return rels


def parse_statement(sql: str):
    p = Parser(sql)
    stmt = p.parse()
    if p.peek() is not None:
        raise InvalidArgument(f"trailing tokens at {p.peek()}")
    return stmt


def parse_script(sql: str):
    """Split a multi-statement string on top-level ';' and parse each
    (the simple-query wire message may carry several statements).
    Comment-only fragments are skipped, not syntax errors."""
    stmts = []
    for part in _split_statements(sql):
        if part.strip() and tokenize(part):
            stmts.append(parse_statement(part))
    return stmts


def _split_statements(sql: str):
    out, depth, start, i = [], 0, 0, 0
    in_str = False
    while i < len(sql):
        c = sql[i]
        if in_str:
            if c == "'":
                in_str = False
        elif c == "-" and sql[i:i + 2] == "--":
            nl = sql.find("\n", i)
            i = len(sql) if nl < 0 else nl
            continue
        elif c == "'":
            in_str = True
        elif c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
        elif c == ";" and depth == 0:
            out.append(sql[start:i])
            start = i + 1
        i += 1
    out.append(sql[start:])
    return out
