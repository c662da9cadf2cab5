"""Roles and permissions on the port: ``yugabyte_db_tpu_torch.auth``'s
``RoleStore`` under the four unit tests of the JAX package's
``tests/test_auth.py``, and ``test_roles_replicate_through_master`` on the
port's cluster. The JAX test issues its role DDL as CQL statements; the
port has no YQL frontends yet (ROADMAP.md §1 item 16), so this one sends
the ops those statements make (``master.auth_op``) through the port's
``YBClient``, and reads the store back with ``master.get_auth``. The JAX
file's CQL and PG tests wait for the frontends.
"""

import pytest

from test_torch_data import cpu_mini_cluster as MiniCluster
from yugabyte_db_tpu_torch.auth import RoleStore, hash_password
from yugabyte_db_tpu_torch.utils.status import (AlreadyPresent,
                                                InvalidArgument, NotFound)


# -- RoleStore unit ----------------------------------------------------------

def test_role_store_basics():
    st = RoleStore()
    st.apply({"op": "auth_create_role", "name": "admin",
              "superuser": True, "can_login": True,
              "salted_hash": hash_password("pw")})
    st.apply({"op": "auth_create_role", "name": "reader",
              "can_login": True, "salted_hash": hash_password("r")})
    with pytest.raises(AlreadyPresent):
        st.apply({"op": "auth_create_role", "name": "admin"})
    assert st.check_login("admin", "pw")
    assert not st.check_login("admin", "wrong")
    assert not st.check_login("ghost", "pw")
    # superuser passes everything; reader nothing yet
    assert st.authorize("admin", "MODIFY", "data/ks/t")
    assert not st.authorize("reader", "SELECT", "data/ks/t")
    st.apply({"op": "auth_grant_perm", "role": "reader",
              "resource": "data/ks", "perm": "SELECT"})
    # keyspace grant covers tables beneath it
    assert st.authorize("reader", "SELECT", "data/ks/t")
    assert not st.authorize("reader", "MODIFY", "data/ks/t")
    st.apply({"op": "auth_revoke_perm", "role": "reader",
              "resource": "data/ks", "perm": "SELECT"})
    assert not st.authorize("reader", "SELECT", "data/ks/t")


def test_role_store_membership_transitive():
    st = RoleStore()
    for n in ("a", "b", "c"):
        st.apply({"op": "auth_create_role", "name": n})
    st.apply({"op": "auth_grant_perm", "role": "a",
              "resource": "data", "perm": "SELECT"})
    st.apply({"op": "auth_grant_role", "role": "a", "member": "b"})
    st.apply({"op": "auth_grant_role", "role": "b", "member": "c"})
    assert st.authorize("c", "SELECT", "data/x/y")   # c -> b -> a
    with pytest.raises(InvalidArgument):             # circular grant
        st.apply({"op": "auth_grant_role", "role": "c", "member": "a"})
    st.apply({"op": "auth_revoke_role", "role": "a", "member": "b"})
    assert not st.authorize("c", "SELECT", "data/x/y")


def test_role_store_drop_cleans_up():
    st = RoleStore()
    st.apply({"op": "auth_create_role", "name": "a"})
    st.apply({"op": "auth_create_role", "name": "b"})
    st.apply({"op": "auth_grant_role", "role": "a", "member": "b"})
    st.apply({"op": "auth_grant_perm", "role": "a",
              "resource": "data", "perm": "ALL"})
    st.apply({"op": "auth_drop_role", "name": "a"})
    assert "a" not in st.roles
    assert not st.roles["b"].member_of
    assert not st.perms
    with pytest.raises(NotFound):
        st.apply({"op": "auth_drop_role", "name": "a"})


def test_role_store_serialization_round_trip():
    st = RoleStore()
    st.apply({"op": "auth_create_role", "name": "r", "can_login": True,
              "salted_hash": hash_password("x")})
    st.apply({"op": "auth_grant_perm", "role": "r",
              "resource": "data/ks", "perm": "MODIFY"})
    st2 = RoleStore.from_dict(st.to_dict())
    assert st2.check_login("r", "x")
    assert st2.authorize("r", "MODIFY", "data/ks/t")


# -- distributed: role ops replicate through the master catalog --------------

def auth_op(client, op: dict) -> dict:
    """One role op through the master, as the CQL frontend sends it."""
    return client.master_rpc("master.auth_op", {"auth": op})


def auth_store(client) -> RoleStore:
    return RoleStore.from_dict(client.master_rpc("master.get_auth",
                                                 {})["auth"])


def test_roles_replicate_through_master(tmp_path):
    mc = MiniCluster(str(tmp_path), num_masters=3, num_tservers=3).start()
    try:
        mc.wait_tservers_registered()
        client = mc.client()
        # CREATE ROLE dadmin WITH PASSWORD = 'd' AND LOGIN = true AND
        # SUPERUSER = true
        create = {"op": "auth_create_role", "name": "dadmin",
                  "superuser": True, "can_login": True,
                  "salted_hash": hash_password("d")}
        assert auth_op(client, create)["code"] == "ok"
        # GRANT SELECT ON ALL KEYSPACES TO dadmin
        assert auth_op(client, {"op": "auth_grant_perm", "role": "dadmin",
                                "resource": "data",
                                "perm": "SELECT"})["code"] == "ok"
        # CREATE ROLE dadmin: the duplicate is rejected
        assert auth_op(client, {"op": "auth_create_role",
                                "name": "dadmin"})["code"] != "ok"
        # a second client observes the replicated store
        st = auth_store(mc.client("c2"))
        assert st.check_login("dadmin", "d")
        assert st.authorize("dadmin", "SELECT", "data/ks/t")
        assert ("dadmin", "data", "SELECT") in st.list_perms()
    finally:
        mc.shutdown()
