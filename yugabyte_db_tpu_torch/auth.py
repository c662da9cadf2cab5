"""Roles, permissions, and password auth — the authorization state
machine shared by every frontend.

Reference analogs: the master's CreateRole / GrantRevokeRole /
GrantRevokePermission RPCs (src/yb/master/master.proto:1383-1388), the
role/permission records of the auth vtables
(src/yb/master/yql_auth_roles_vtable.cc, yql_auth_role_permissions_vtable.cc),
and CQL enforcement in the analyzer/executor. The store is a
deterministic state machine over small dict ops, so the master
replicates role DDL through the same Raft'd catalog pipeline as table
DDL, and an in-process cluster applies the ops directly.

Resources are hierarchical, Cassandra-style:
  data               all keyspaces
  data/<ks>          one keyspace
  data/<ks>/<table>  one table
  roles              all roles
  roles/<role>       one role
A permission granted on an ancestor applies to every descendant.
Passwords are stored as salted SHA-256 ("<salt>$<hexdigest>"); the hash
is computed BEFORE the op enters replication so replicas apply
byte-identical state.

The port's copy of the JAX package's ``auth.py``, whole.
"""

from __future__ import annotations

import hashlib
import os
import threading

from yugabyte_db_tpu_torch.utils.status import InvalidArgument, NotFound

PERMISSIONS = ("ALTER", "AUTHORIZE", "CREATE", "DESCRIBE", "DROP",
               "MODIFY", "SELECT")


def hash_password(password: str, salt: str | None = None) -> str:
    salt = salt if salt is not None else os.urandom(8).hex()
    digest = hashlib.sha256((salt + password).encode()).hexdigest()
    return f"{salt}${digest}"


def verify_password(password: str, salted_hash: str) -> bool:
    if not salted_hash or "$" not in salted_hash:
        return False
    salt, _d = salted_hash.split("$", 1)
    return hash_password(password, salt) == salted_hash


class Role:
    __slots__ = ("name", "can_login", "superuser", "salted_hash",
                 "member_of")

    def __init__(self, name, can_login=False, superuser=False,
                 salted_hash="", member_of=None):
        self.name = name
        self.can_login = can_login
        self.superuser = superuser
        self.salted_hash = salted_hash
        self.member_of = set(member_of or ())

    def to_dict(self) -> dict:
        return {"name": self.name, "can_login": self.can_login,
                "superuser": self.superuser,
                "salted_hash": self.salted_hash,
                "member_of": sorted(self.member_of)}


class RoleStore:
    """Deterministic role/permission state machine."""

    def __init__(self):
        self._lock = threading.RLock()
        self.roles: dict[str, Role] = {}
        # (role, resource) -> set of permission names
        self.perms: dict[tuple[str, str], set[str]] = {}

    # -- the op interface (replicated verbatim) -----------------------------
    def apply(self, op: dict) -> None:
        kind = op["op"]
        with self._lock:
            if kind == "auth_create_role":
                name = op["name"]
                if name in self.roles:
                    from yugabyte_db_tpu_torch.utils.status import AlreadyPresent

                    raise AlreadyPresent(f"role {name} already exists")
                self.roles[name] = Role(
                    name, op.get("can_login", False),
                    op.get("superuser", False),
                    op.get("salted_hash", ""))
            elif kind == "auth_alter_role":
                r = self._role(op["name"])
                if "can_login" in op:
                    r.can_login = op["can_login"]
                if "superuser" in op:
                    r.superuser = op["superuser"]
                if "salted_hash" in op:
                    r.salted_hash = op["salted_hash"]
            elif kind == "auth_drop_role":
                if self.roles.pop(op["name"], None) is None:
                    raise NotFound(f"role {op['name']} does not exist")
                for r in self.roles.values():
                    r.member_of.discard(op["name"])
                for key in [k for k in self.perms if k[0] == op["name"]]:
                    del self.perms[key]
            elif kind == "auth_grant_role":
                member = self._role(op["member"])
                self._role(op["role"])
                if self._reachable(op["member"], op["role"], reverse=True):
                    raise InvalidArgument(
                        f"{op['role']} is already a member of "
                        f"{op['member']} (circular grant)")
                member.member_of.add(op["role"])
            elif kind == "auth_revoke_role":
                self._role(op["member"]).member_of.discard(op["role"])
            elif kind == "auth_grant_perm":
                self._role(op["role"])
                perms = self.perms.setdefault(
                    (op["role"], op["resource"]), set())
                perms.update(self._perm_list(op["perm"]))
            elif kind == "auth_revoke_perm":
                key = (op["role"], op["resource"])
                have = self.perms.get(key)
                if have:
                    have.difference_update(self._perm_list(op["perm"]))
                    if not have:
                        del self.perms[key]
            else:
                raise ValueError(f"unknown auth op {kind!r}")

    @staticmethod
    def _perm_list(perm: str) -> tuple:
        if perm == "ALL":
            return PERMISSIONS
        if perm not in PERMISSIONS:
            raise InvalidArgument(f"unknown permission {perm}")
        return (perm,)

    def _role(self, name: str) -> Role:
        r = self.roles.get(name)
        if r is None:
            raise NotFound(f"role {name} does not exist")
        return r

    def _reachable(self, src: str, dst: str, reverse: bool = False) -> bool:
        """Is dst reachable from src over member_of edges? (cycle guard:
        with reverse=True asks whether src is already granted to dst)."""
        a, b = (dst, src) if reverse else (src, dst)
        seen, stack = set(), [a]
        while stack:
            cur = stack.pop()
            if cur == b:
                return True
            if cur in seen:
                continue
            seen.add(cur)
            r = self.roles.get(cur)
            if r is not None:
                stack.extend(r.member_of)
        return False

    # -- queries ------------------------------------------------------------
    def effective_roles(self, name: str) -> set[str]:
        with self._lock:
            out: set[str] = set()
            stack = [name]
            while stack:
                cur = stack.pop()
                if cur in out or cur not in self.roles:
                    continue
                out.add(cur)
                stack.extend(self.roles[cur].member_of)
            return out

    @staticmethod
    def resource_chain(resource: str) -> list[str]:
        """A resource and its ancestors, root first."""
        parts = resource.split("/")
        return ["/".join(parts[:i + 1]) for i in range(len(parts))]

    def authorize(self, role_name: str, perm: str, resource: str) -> bool:
        with self._lock:
            r = self.roles.get(role_name)
            if r is None:
                return False
            eff = self.effective_roles(role_name)
            if any(self.roles[n].superuser for n in eff
                   if n in self.roles):
                return True
            chain = self.resource_chain(resource)
            for n in eff:
                for res in chain:
                    if perm in self.perms.get((n, res), ()):
                        return True
            return False

    def check_login(self, name: str, password: str) -> bool:
        with self._lock:
            r = self.roles.get(name)
            return (r is not None and r.can_login
                    and verify_password(password, r.salted_hash))

    def list_roles(self) -> list[Role]:
        with self._lock:
            return sorted(self.roles.values(), key=lambda r: r.name)

    def list_perms(self) -> list[tuple[str, str, str]]:
        """(role, resource, permission) triples, sorted."""
        with self._lock:
            return sorted((role, res, p)
                          for (role, res), ps in self.perms.items()
                          for p in ps)

    # -- serialization (client mirror fetch) --------------------------------
    def to_dict(self) -> dict:
        with self._lock:
            return {
                "roles": [r.to_dict() for r in self.roles.values()],
                "perms": [[role, res, sorted(ps)]
                          for (role, res), ps in self.perms.items()],
            }

    @classmethod
    def from_dict(cls, d: dict) -> "RoleStore":
        st = cls()
        for rd in d.get("roles", ()):
            st.roles[rd["name"]] = Role(
                rd["name"], rd["can_login"], rd["superuser"],
                rd["salted_hash"], rd["member_of"])
        for role, res, ps in d.get("perms", ()):
            st.perms[(role, res)] = set(ps)
        return st
