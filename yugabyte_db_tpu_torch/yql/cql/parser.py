"""CQL recursive-descent parser (tokenizer + statement grammar).

Reference analog: the Bison/Flex grammar of src/yb/yql/cql/ql/parser/
(parser_gram.y, scanner_lex.l). The reference generates a ~30-statement
grammar; this covers the DDL/DML core (CREATE/DROP KEYSPACE|TABLE, USE,
INSERT, SELECT incl. aggregates, UPDATE, DELETE) and grows per statement.
"""

from __future__ import annotations

import re

from yugabyte_db_tpu_torch.models.datatypes import DataType
from yugabyte_db_tpu_torch.storage.scan_spec import AGG_FNS as _AGG_FN_TUPLE
from yugabyte_db_tpu_torch.utils.status import InvalidArgument
from yugabyte_db_tpu_torch.yql.cql import ast

AGG_FNS = frozenset(_AGG_FN_TUPLE)

_TOKEN_RE = re.compile(r"""
    \s+
  | (?P<comment>--[^\n]*|//[^\n]*)
  | (?P<string>'(?:[^']|'')*')
  | (?P<blob>0[xX][0-9a-fA-F]*)
  | (?P<number>-?\d+\.\d+(?:[eE][+-]?\d+)?|-?\.\d+|-?\d+[eE][+-]?\d+|-?\d+)
  | (?P<name>[A-Za-z_][A-Za-z_0-9]*|"(?:[^"]|"")*")
  | (?P<op><=|>=|!=|=|<|>)
  | (?P<sym>[(),.;*?{}:\[\]+-])
""", re.VERBOSE)


class Token:
    __slots__ = ("kind", "text")

    def __init__(self, kind, text):
        self.kind = kind
        self.text = text

    def __repr__(self):
        return f"{self.kind}:{self.text}"


def tokenize(sql: str) -> list[Token]:
    out, pos = [], 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if not m:
            raise InvalidArgument(f"CQL syntax error near {sql[pos:pos+20]!r}")
        pos = m.end()
        for kind in ("string", "blob", "number", "name", "op", "sym"):
            text = m.group(kind)
            if text is not None:
                out.append(Token(kind, text))
                break
    return out


class Parser:
    def __init__(self, sql: str):
        self.toks = tokenize(sql)
        self.i = 0
        self.bind_count = 0  # ``?`` markers seen, in appearance order

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

    def qualified_name(self) -> str:
        name = self.ident()
        if self.take_sym("."):
            return f"{name}.{self.ident()}"
        return name

    def literal(self):
        # collection literals: [a, b] list; {a, b} set; {k: v, ...} map.
        # Bind markers are supported for WHOLE collections (v = ?) but
        # not for individual elements — element markers would persist
        # BindMarker objects as data (and sets can't sort them).
        def _no_marker(v):
            if isinstance(v, ast.BindMarker):
                raise InvalidArgument(
                    "bind markers are not allowed inside collection "
                    "literals; bind the whole collection instead")
            return v

        if self.take_sym("["):
            out = []
            while not self.take_sym("]"):
                out.append(_no_marker(self.literal()))
                self.take_sym(",")
            return out
        if self.at_sym("{"):
            self.next()
            if self.take_sym("}"):
                return {}  # empty braces: map (CQL's untyped empty {})
            first = _no_marker(self.literal())
            if self.take_sym(":"):
                m = {first: _no_marker(self.literal())}
                while self.take_sym(","):
                    k = _no_marker(self.literal())
                    self.expect_sym(":")
                    m[k] = _no_marker(self.literal())
                self.expect_sym("}")
                return dict(sorted(m.items()))  # normalized key order
            items = [first]
            while self.take_sym(","):
                items.append(_no_marker(self.literal()))
            self.expect_sym("}")
            return sorted(set(items))  # SET: normalized sorted list
        t = self.next()
        if t.kind == "sym" and t.text == "?":
            marker = ast.BindMarker(self.bind_count)
            self.bind_count += 1
            return marker
        if t.kind == "string":
            return t.text[1:-1].replace("''", "'")
        if t.kind == "blob":
            hexpart = t.text[2:]
            if len(hexpart) % 2:
                raise InvalidArgument(f"odd-length blob literal {t.text}")
            return bytes.fromhex(hexpart)
        if t.kind == "number":
            txt = t.text
            if any(c in txt for c in ".eE"):
                return float(txt)
            return int(txt)
        if t.kind == "name":
            up = t.text.upper()
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
        kw = t.text.upper() if t.kind == "name" else ""
        fn = {
            "CREATE": self._create, "DROP": self._drop, "USE": self._use,
            "INSERT": self._insert, "SELECT": self._select,
            "UPDATE": self._update, "DELETE": self._delete,
            "ALTER": self._alter, "BEGIN": self._batch,
            "GRANT": self._grant_revoke, "REVOKE": self._grant_revoke,
            "LIST": self._list,
        }.get(kw)
        if fn is None:
            raise InvalidArgument(f"unsupported statement {t.text!r}")
        stmt = fn()
        self.take_sym(";")
        if self.peek() is not None:
            raise InvalidArgument(f"trailing tokens at {self.peek()}")
        return stmt

    # -- roles / permissions (reference grammar: PTCreateRole,
    # PTGrantRevokePermission in parser_gram.y) -----------------------------
    _PERMS = ("ALL", "ALTER", "AUTHORIZE", "CREATE", "DESCRIBE", "DROP",
              "MODIFY", "SELECT")

    def _role_options(self):
        password, can_login, superuser = None, None, None
        if self.take_kw("WITH"):
            while True:
                opt = self.ident().upper()
                self.expect_sym("=")
                v = self.literal()
                if opt == "PASSWORD":
                    password = str(v)
                elif opt == "LOGIN":
                    can_login = bool(v)
                elif opt == "SUPERUSER":
                    superuser = bool(v)
                else:
                    raise InvalidArgument(f"unknown role option {opt}")
                if not self.take_kw("AND"):
                    break
        return password, can_login, superuser

    def _grant_revoke(self):
        grant = self.take_kw("GRANT")
        if not grant:
            self.expect_kw("REVOKE")
        t = self.peek()
        word = t.text.upper() if t is not None and t.kind == "name" else ""
        if word in self._PERMS and (
                self._peek_ahead_kw(1, "ON", "PERMISSION", "PERMISSIONS")):
            perm = self.ident().upper()
            self.take_kw("PERMISSION") or self.take_kw("PERMISSIONS")
            self.expect_kw("ON")
            resource = self._auth_resource()
            self.expect_kw("TO" if grant else "FROM")
            return ast.GrantRevokePermission(grant, perm, resource,
                                             self.ident())
        role = self.ident()
        self.expect_kw("TO" if grant else "FROM")
        return ast.GrantRevokeRole(grant, role, self.ident())

    def _peek_ahead_kw(self, n: int, *kws) -> bool:
        t = self.toks[self.i + n] if self.i + n < len(self.toks) else None
        return (t is not None and t.kind == "name"
                and t.text.upper() in kws)

    def _auth_resource(self) -> str:
        if self.take_kw("ALL"):
            if self.take_kw("KEYSPACES"):
                return "data"
            self.expect_kw("ROLES")
            return "roles"
        if self.take_kw("KEYSPACE"):
            return f"data/{self.ident()}"
        if self.take_kw("ROLE"):
            return f"roles/{self.ident()}"
        self.take_kw("TABLE")
        name = self.qualified_name()
        if "." in name:
            ks, table = name.split(".", 1)
            return f"data/{ks}/{table}"
        return f"data//{name}"   # keyspace resolved by the processor

    def _list(self):
        self.expect_kw("LIST")
        if self.take_kw("ROLES"):
            return ast.ListRoles()
        self.take_kw("ALL")
        self.expect_kw("PERMISSIONS")
        return ast.ListPermissions()

    def _alter(self):
        """ALTER TABLE t ... | ALTER ROLE r WITH ..."""
        self.expect_kw("ALTER")
        if self.take_kw("ROLE"):
            name = self.ident()
            password, can_login, superuser = self._role_options()
            return ast.AlterRole(name, password, can_login, superuser)
        self.expect_kw("TABLE")
        name = self.qualified_name()
        if self.take_kw("ADD"):
            col = self.ident()
            dtype = self._type()
            return ast.AlterTable(name, "add", col, dtype)
        if self.take_kw("DROP"):
            return ast.AlterTable(name, "drop", self.ident())
        if self.take_kw("RENAME"):
            old = self.ident()
            self.expect_kw("TO")
            return ast.AlterTable(name, "rename", old,
                                  new_name=self.ident())
        raise InvalidArgument(f"expected ADD/DROP/RENAME, got {self.peek()}")

    def _batch(self):
        """BEGIN [UNLOGGED|LOGGED|COUNTER] BATCH <dml>; ... APPLY BATCH
        (reference: PTInsertStmt lists under PTListNode in a batch tree).
        Batches group client-side; each statement routes to its tablet —
        per-tablet atomicity, like the reference without transactions."""
        self.expect_kw("BEGIN")
        logged = not self.take_kw("UNLOGGED")
        self.take_kw("LOGGED", "COUNTER")
        self.expect_kw("BATCH")
        stmts = []
        while not self.at_kw("APPLY"):
            t = self.peek()
            if t is None:
                raise InvalidArgument("unterminated BATCH (missing APPLY)")
            kw = t.text.upper()
            fn = {"INSERT": self._insert, "UPDATE": self._update,
                  "DELETE": self._delete}.get(kw)
            if fn is None:
                raise InvalidArgument(
                    f"only INSERT/UPDATE/DELETE allowed in BATCH, got {kw}")
            stmts.append(fn())
            self.take_sym(";")
        self.expect_kw("APPLY")
        self.expect_kw("BATCH")
        return ast.Batch(stmts, logged)

    def _if_not_exists(self) -> bool:
        if self.take_kw("IF"):
            self.expect_kw("NOT")
            self.expect_kw("EXISTS")
            return True
        return False

    def _if_exists(self) -> bool:
        if self.take_kw("IF"):
            self.expect_kw("EXISTS")
            return True
        return False

    def _create(self):
        self.expect_kw("CREATE")
        if self.take_kw("ROLE"):
            ine = self._if_not_exists()
            name = self.ident()
            password, can_login, superuser = self._role_options()
            return ast.CreateRole(name, password,
                                  bool(can_login), bool(superuser), ine)
        if self.take_kw("KEYSPACE", "SCHEMA"):
            ine = self._if_not_exists()
            name = self.ident()
            self._skip_with()
            return ast.CreateKeyspace(name, ine)
        if self.take_kw("TYPE"):
            ine = self._if_not_exists()
            tname = self.qualified_name()
            self.expect_sym("(")
            fields = [(self.ident(), self._type())]
            while self.take_sym(","):
                fields.append((self.ident(), self._type()))
            self.expect_sym(")")
            return ast.CreateType(tname, fields, ine)
        if self.take_kw("INDEX"):
            ine = self._if_not_exists()
            iname = self.ident()
            self.expect_kw("ON")
            table = self.qualified_name()
            self.expect_sym("(")
            columns = [self.ident()]
            while self.take_sym(","):
                columns.append(self.ident())
            self.expect_sym(")")
            include = []
            if self.take_kw("INCLUDE"):
                self.expect_sym("(")
                include.append(self.ident())
                while self.take_sym(","):
                    include.append(self.ident())
                self.expect_sym(")")
            return ast.CreateIndex(iname, table, columns, ine, include)
        self.expect_kw("TABLE")
        ine = self._if_not_exists()
        name = self.qualified_name()
        cols, hash_keys, range_keys = self._table_body()
        props = self._with_properties()
        return ast.CreateTable(name, cols, hash_keys, range_keys, ine, props)

    def _table_body(self):
        self.expect_sym("(")
        cols: list[ast.ColumnDef] = []
        hash_keys: list[str] = []
        range_keys: list[str] = []
        while True:
            if self.at_kw("PRIMARY"):
                self.next()
                self.expect_kw("KEY")
                self.expect_sym("(")
                if self.take_sym("("):   # ((h1, h2), r1, ...)
                    hash_keys.append(self.ident())
                    while self.take_sym(","):
                        hash_keys.append(self.ident())
                    self.expect_sym(")")
                else:                     # (h1, r1, ...)
                    hash_keys.append(self.ident())
                while self.take_sym(","):
                    range_keys.append(self.ident())
                self.expect_sym(")")
            else:
                cname = self.ident()
                dtype, udt = self._type_with_udt()
                is_static = bool(self.take_kw("STATIC"))
                if self.take_kw("PRIMARY"):
                    self.expect_kw("KEY")
                    hash_keys.append(cname)
                cols.append(ast.ColumnDef(cname, dtype, is_static, udt))
            if not self.take_sym(","):
                break
        self.expect_sym(")")
        if not hash_keys:
            raise InvalidArgument("table needs a primary key")
        return cols, hash_keys, range_keys

    def _type_with_udt(self):
        """A column type: native (possibly FROZEN<...>-wrapped) -> (dtype,
        None); an unknown name is a user-defined type reference ->
        (MAP, udt_name) — UDT values store as frozen field maps."""
        t = self.peek()
        if t is not None and t.kind == "name" and \
                t.text.upper() == "FROZEN":
            self.ident()
            self.expect_sym("<")
            inner = self._type_with_udt()
            self.expect_sym(">")
            dt, udt = inner
            if udt is None and dt in (DataType.LIST, DataType.SET,
                                      DataType.MAP, DataType.TUPLE):
                # frozen<collection>: immutable, byte-comparable, valid
                # in primary keys (reference: common.proto FROZEN +
                # primitive_value.h kFrozen key encoding).
                return DataType.FROZEN, None
            return inner  # frozen<udt> / frozen<scalar>: unchanged
        if t is not None and t.kind == "name":
            try:
                DataType.parse(t.text)
            except ValueError:
                return DataType.MAP, self.ident()
        return self._type(), None

    def _type(self) -> DataType:
        name = self.ident()
        try:
            dt = DataType.parse(name)
        except ValueError as e:
            raise InvalidArgument(str(e))
        if dt in (DataType.LIST, DataType.SET, DataType.MAP,
                  DataType.TUPLE) and self.take_sym("<"):
            # element types accepted and discarded: values are stored as
            # host containers; element validation is container-level
            self._type()
            while self.take_sym(","):
                self._type()
            self.expect_sym(">")
        return dt

    def _with_properties(self) -> dict:
        props = {}
        if self.take_kw("WITH"):
            while True:
                key = self.ident()
                self.expect_sym("=")
                props[key] = self.literal()
                if not self.take_kw("AND"):
                    break
        return props

    def _skip_with(self):
        # CREATE KEYSPACE ... WITH replication = {...}: accept and ignore.
        if self.take_kw("WITH"):
            while self.peek() is not None and not self.at_sym(";"):
                self.next()

    def _drop(self):
        self.expect_kw("DROP")
        if self.take_kw("ROLE"):
            ie = self._if_exists()
            return ast.DropRole(self.ident(), ie)
        if self.take_kw("KEYSPACE", "SCHEMA"):
            ie = self._if_exists()
            return ast.DropKeyspace(self.ident(), ie)
        if self.take_kw("INDEX"):
            ie = self._if_exists()
            return ast.DropIndex(self.ident(), ie)
        if self.take_kw("TYPE"):
            ie = self._if_exists()
            return ast.DropType(self.qualified_name(), ie)
        self.expect_kw("TABLE")
        ie = self._if_exists()
        return ast.DropTable(self.qualified_name(), ie)

    def _use(self):
        self.expect_kw("USE")
        return ast.UseKeyspace(self.ident())

    def _insert(self):
        self.expect_kw("INSERT")
        self.expect_kw("INTO")
        table = self.qualified_name()
        self.expect_sym("(")
        columns = [self.ident()]
        while self.take_sym(","):
            columns.append(self.ident())
        self.expect_sym(")")
        self.expect_kw("VALUES")
        self.expect_sym("(")
        values = [self.literal()]
        while self.take_sym(","):
            values.append(self.literal())
        self.expect_sym(")")
        ine = self._if_not_exists()
        ttl = self._using_ttl()
        if len(columns) != len(values):
            raise InvalidArgument("column/value count mismatch")
        return ast.Insert(table, columns, values, ttl, ine)

    def _using_ttl(self):
        if self.take_kw("USING"):
            self.expect_kw("TTL")
            ttl = self.literal()
            if not isinstance(ttl, ast.BindMarker) and (
                    not isinstance(ttl, int) or ttl < 0):
                raise InvalidArgument("TTL must be a non-negative integer")
            return ttl
        return None

    def _select(self):
        self.expect_kw("SELECT")
        items = None
        if not self.take_sym("*"):
            items = [self._select_item()]
            while self.take_sym(","):
                items.append(self._select_item())
        self.expect_kw("FROM")
        table = self.qualified_name()
        where = self._where_opt()
        group_by = []
        if self.take_kw("GROUP"):
            self.expect_kw("BY")
            group_by.append(self.ident())
            while self.take_sym(","):
                group_by.append(self.ident())
        order_by = []
        if self.take_kw("ORDER"):
            self.expect_kw("BY")
            while True:
                name = self.ident()
                desc = False
                if self.take_kw("DESC"):
                    desc = True
                else:
                    self.take_kw("ASC")
                order_by.append((name, desc))
                if not self.take_sym(","):
                    break
        limit = None
        if self.take_kw("LIMIT"):
            limit = self.literal()
            if not isinstance(limit, ast.BindMarker) and (
                    not isinstance(limit, int) or limit < 0):
                raise InvalidArgument("LIMIT must be a non-negative integer")
        allow = False
        if self.take_kw("ALLOW"):
            self.expect_kw("FILTERING")
            allow = True
        return ast.Select(table, items, where, limit, allow,
                          group_by, order_by)

    def _select_item(self) -> ast.SelectItem:
        name = self.ident()
        if name in AGG_FNS and self.at_sym("("):
            self.next()
            if self.take_sym("*"):
                item = ast.SelectItem(None, agg_fn=name)
            else:
                expr = self._arith_expr()
                from yugabyte_db_tpu_torch.storage.expr import Col
                if isinstance(expr, Col):
                    item = ast.SelectItem(expr.name, agg_fn=name)
                else:
                    item = ast.SelectItem(None, agg_fn=name, expr=expr)
            self.expect_sym(")")
        else:
            item = ast.SelectItem(name)
        if self.take_kw("AS"):
            item.alias = self.ident()
        return item

    def _arith_expr(self):
        """Arithmetic over columns and integer constants: + - * with the
        usual precedence and parentheses (storage.expr tree)."""
        from yugabyte_db_tpu_torch.storage.expr import BinOp, Const

        left = self._arith_term()
        while True:
            if self.take_sym("+"):
                left = BinOp("+", left, self._arith_term())
            elif self.take_sym("-"):
                left = BinOp("-", left, self._arith_term())
            else:
                t = self.peek()
                # "a -5": the lexer folds the sign into the number.
                if t is not None and t.kind == "number" and \
                        t.text.startswith("-") and "." not in t.text:
                    self.next()
                    left = BinOp("+", left, Const(int(t.text)))
                else:
                    return left

    def _arith_term(self):
        from yugabyte_db_tpu_torch.storage.expr import BinOp

        left = self._arith_factor()
        while self.take_sym("*"):
            left = BinOp("*", left, self._arith_factor())
        return left

    def _arith_factor(self):
        from yugabyte_db_tpu_torch.storage.expr import Col, Const

        if self.take_sym("("):
            e = self._arith_expr()
            self.expect_sym(")")
            return e
        t = self.peek()
        if t is not None and t.kind == "number":
            self.next()
            if any(c in t.text for c in ".eE"):
                raise InvalidArgument(
                    "only integer constants in pushed-down expressions")
            return Const(int(t.text))
        return Col(self.ident())


    def _where_opt(self) -> list[ast.Relation]:
        if not self.take_kw("WHERE"):
            return []
        return self._relation_list()

    def _where_required(self) -> list[ast.Relation]:
        self.expect_kw("WHERE")
        return self._relation_list()

    def _relation_list(self) -> list[ast.Relation]:
        rels = [self._relation()]
        while self.take_kw("AND"):
            rels.append(self._relation())
        return rels

    def _relation(self) -> ast.Relation:
        col = self.ident()
        t = self.next()
        if t.kind == "name" and t.text.upper() == "IN":
            self.expect_sym("(")
            vals = [self.literal()]
            while self.take_sym(","):
                vals.append(self.literal())
            self.expect_sym(")")
            return ast.Relation(col, "IN", tuple(vals))
        if t.kind != "op":
            raise InvalidArgument(f"expected comparison operator, got {t}")
        return ast.Relation(col, t.text, self.literal())

    def _update(self):
        self.expect_kw("UPDATE")
        table = self.qualified_name()
        ttl = self._using_ttl()
        self.expect_kw("SET")
        assigns = [self._assignment()]
        while self.take_sym(","):
            assigns.append(self._assignment())
        return ast.Update(table, assigns, self._where_required(), ttl)

    def _assignment(self):
        col = self.ident()
        if self.take_sym("["):
            idx = self.literal()
            self.expect_sym("]")
            self.expect_sym("=")
            return (col, ast.CollectionOp("setelem", self.literal(),
                                          index=idx))
        self.expect_sym("=")
        # collection/counter edits reference the column itself:
        # v = v + [...], v = [...] + v, v = v - {...}, c = c + 1
        t = self.peek()
        if t is not None and t.kind == "name" and t.text.lower() == col \
                and self.i + 1 < len(self.toks):
            nxt = self.toks[self.i + 1]
            if nxt.text in "+-":
                self.ident()
                op = "append" if self.next().text == "+" else "remove"
                return (col, ast.CollectionOp(op, self.literal()))
            if nxt.kind == "number" and nxt.text.startswith("-"):
                # 'c = c -2': the tokenizer fused the sign into the
                # number; this is still a subtraction
                self.ident()
                v = self.literal()
                return (col, ast.CollectionOp("remove", -v))
        value = self.literal()
        if self.at_sym("+"):
            self.next()
            name = self.ident()
            if name != col:
                raise InvalidArgument(
                    f"prepend must reference {col}, got {name}")
            return (col, ast.CollectionOp("prepend", value))
        return (col, value)

    def _delete(self):
        self.expect_kw("DELETE")
        columns = None
        if not self.at_kw("FROM"):
            columns = [self.ident()]
            while self.take_sym(","):
                columns.append(self.ident())
        self.expect_kw("FROM")
        table = self.qualified_name()
        return ast.Delete(table, self._where_required(), columns)


def parse_statement(sql: str):
    """Parse one CQL statement -> ast node."""
    return Parser(sql).parse()
