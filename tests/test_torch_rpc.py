"""The port's RPC framework (``yugabyte_db_tpu_torch/rpc``) against the JAX
package's.

Mirrors of ``tests/test_rpc.py``'s 8 tests (:42, :50, :72, :82, :90, :98,
:124, :142) on the port's ``Messenger`` / ``Proxy`` / ``SocketTransport``;
the raft group over sockets (:142) is a group of the port's
``TabletPeer``s on the ``gpu`` engine over CPU tensors. Then the frames
across packages: a JAX ``Proxy`` calls a port ``Messenger`` and a port
``Proxy`` a JAX ``Messenger``, with the same replies as within a package
(both frame with the same codec bytes).
"""

from __future__ import annotations

import socket
import threading
import time

import pytest

import yugabyte_db_tpu.rpc as jrpc
from yugabyte_db_tpu_torch.consensus import RaftOptions
from yugabyte_db_tpu_torch.models.datatypes import DataType
from yugabyte_db_tpu_torch.models.partition import compute_hash_code
from yugabyte_db_tpu_torch.models.schema import (ColumnKind, ColumnSchema,
                                                 Schema)
from yugabyte_db_tpu_torch.rpc import (ConnectionContext, Messenger, Proxy,
                                       RpcCallError, SocketTransport)
from yugabyte_db_tpu_torch.storage import RowVersion, ScanSpec
from yugabyte_db_tpu_torch.tablet import TabletMetadata
from yugabyte_db_tpu_torch.tablet.tablet_peer import TabletPeer


@pytest.fixture
def messenger():
    m = Messenger("test")
    yield m
    m.shutdown()


def echo_handler(method, body):
    if method == "echo":
        return body
    if method == "slow":
        time.sleep(body["sleep_s"])
        return "done"
    if method == "boom":
        raise ValueError("intentional failure")
    raise KeyError(method)


def test_echo_roundtrip(messenger):
    host, port = messenger.listen("127.0.0.1", 0, echo_handler)
    proxy = Proxy(host, port)
    assert proxy.call("echo", {"x": [1, 2.5, "s", b"b", None, True]}) == \
        {"x": [1, 2.5, "s", b"b", None, True]}
    proxy.close()


def test_concurrent_calls_multiplex(messenger):
    host, port = messenger.listen("127.0.0.1", 0, echo_handler)
    proxy = Proxy(host, port)
    results = {}
    errors = []

    def worker(i):
        try:
            results[i] = proxy.call("echo", {"i": i})
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(50)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert all(results[i] == {"i": i} for i in range(50))
    proxy.close()


def test_remote_error_propagates(messenger):
    host, port = messenger.listen("127.0.0.1", 0, echo_handler)
    proxy = Proxy(host, port)
    with pytest.raises(RpcCallError, match="intentional failure"):
        proxy.call("boom", None)
    # connection still usable after a handler error
    assert proxy.call("echo", 42) == 42
    proxy.close()


def test_call_deadline(messenger):
    host, port = messenger.listen("127.0.0.1", 0, echo_handler)
    proxy = Proxy(host, port)
    with pytest.raises(TimeoutError):
        proxy.call("slow", {"sleep_s": 2.0}, timeout=0.2)
    proxy.close()


def test_large_payload(messenger):
    host, port = messenger.listen("127.0.0.1", 0, echo_handler)
    proxy = Proxy(host, port)
    blob = b"\xab" * (4 * 1024 * 1024)
    assert proxy.call("echo", blob) == blob
    proxy.close()


def test_connect_refused():
    with pytest.raises(OSError):
        Proxy("127.0.0.1", 1, connect_timeout=0.5)


class LineContext(ConnectionContext):
    """A trivial newline-delimited text protocol, standing in for RESP/CQL
    to prove foreign protocols ride the same reactor."""

    def __init__(self):
        self._buf = bytearray()

    def feed(self, data):
        self._buf.extend(data)
        calls = []
        while b"\n" in self._buf:
            line, _, rest = bytes(self._buf).partition(b"\n")
            self._buf = bytearray(rest)
            calls.append((None, "line", line.decode()))
        return calls

    def serialize(self, response):
        _, _, body = response
        return (body + "\n").encode()


def test_foreign_protocol_context(messenger):
    def upper(method, line):
        return line.upper()

    host, port = messenger.listen("127.0.0.1", 0, upper,
                                  context_factory=LineContext)
    s = socket.create_connection((host, port))
    s.sendall(b"hello\nworld\n")
    got = b""
    while got.count(b"\n") < 2:
        got += s.recv(1024)
    assert got == b"HELLO\nWORLD\n"
    s.close()


# -- raft over sockets -------------------------------------------------------

def test_raft_group_over_sockets(tmp_path):
    schema = Schema([
        ColumnSchema("k", DataType.STRING, ColumnKind.HASH),
        ColumnSchema("v", DataType.INT64),
    ], table_id="t")
    cid = {c.name: c.col_id for c in schema.columns}
    opts = RaftOptions(election_timeout_s=0.25, heartbeat_interval_s=0.05,
                       lease_s=0.6, rpc_timeout_s=1.0)
    nodes = ["s-0", "s-1", "s-2"]
    transport = SocketTransport()
    messengers, peers = {}, {}
    try:
        for uuid in nodes:
            m = Messenger(uuid)
            meta = TabletMetadata("tablet-1", "t", schema, 0, 65536)
            peer = TabletPeer(uuid, meta, str(tmp_path / uuid), transport,
                              nodes, fsync=False, raft_opts=opts,
                              engine_options={"device": "cpu"})
            host, port = m.listen(
                "127.0.0.1", 0,
                lambda method, body, _p=peer: _p.raft.handle(method, body))
            transport.set_address(uuid, host, port)
            messengers[uuid], peers[uuid] = m, peer
        for p in peers.values():
            p.start()

        deadline = time.monotonic() + 10
        leader = None
        while time.monotonic() < deadline and leader is None:
            leader = next((p for p in peers.values()
                           if p.raft.is_leader() and p.raft.has_lease()
                           and p.raft.leader_ready()), None)
            time.sleep(0.02)
        assert leader is not None, "no leader over sockets"

        key = schema.encode_primary_key(
            {"k": "sock"}, compute_hash_code(schema, {"k": "sock"}))
        for i in range(10):
            leader.write([RowVersion(key, ht=0, liveness=True,
                                     columns={cid["v"]: i})])
        # all replicas converge
        deadline = time.monotonic() + 5
        target = leader.raft.stats()["applied_index"]
        while time.monotonic() < deadline:
            if all(p.raft.stats()["applied_index"] >= target
                   for p in peers.values()):
                break
            time.sleep(0.02)
        for p in peers.values():
            res = p.scan(ScanSpec(read_ht=p.tablet.clock.now().value),
                         allow_stale=True)
            assert res.rows == [("sock", 9)], (p.node_uuid, res.rows)
    finally:
        for p in peers.values():
            p.shutdown()
        transport.close()
        for m in messengers.values():
            m.shutdown()


# -- frames across the packages -------------------------------------------

PAYLOADS = [{"x": [1, 2.5, "s", b"b", None, True]}, 2 ** 70,
            b"\xab" * (1 << 20), [[b"k", {"1": -7}]], "héllo"]


@pytest.mark.parametrize("server,client", [("port", "jax"), ("jax", "port")])
def test_frames_cross_the_packages(server, client):
    """A proxy of one package calls a messenger of the other: the replies,
    remote errors, deadlines and concurrent calls are those of one
    package calling itself."""
    M = Messenger if server == "port" else jrpc.Messenger
    P = Proxy if client == "port" else jrpc.Proxy
    err = RpcCallError if client == "port" else jrpc.RpcCallError
    m = M("cross")
    try:
        host, port = m.listen("127.0.0.1", 0, echo_handler)
        proxy = P(host, port)
        for body in PAYLOADS:
            assert proxy.call("echo", body) == body
        with pytest.raises(err, match="intentional failure"):
            proxy.call("boom", None)
        with pytest.raises(TimeoutError):
            proxy.call("slow", {"sleep_s": 1.0}, timeout=0.1)
        got = {}
        threads = [threading.Thread(
            target=lambda i=i: got.__setitem__(i, proxy.call("echo", i)))
            for i in range(20)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert got == {i: i for i in range(20)}
        proxy.close()
    finally:
        m.shutdown()


def test_socket_transports_cross_the_packages():
    """Each package's ``SocketTransport`` reaches the other's messenger by
    uuid, and a dropped address raises the seam's ``TransportError``."""
    from yugabyte_db_tpu.rpc.interface import TransportError as JErr
    from yugabyte_db_tpu_torch.rpc import TransportError

    jm, tm = jrpc.Messenger("j"), Messenger("t")
    try:
        jaddr = jm.listen("127.0.0.1", 0, echo_handler)
        taddr = tm.listen("127.0.0.1", 0, echo_handler)
        tt, jt = SocketTransport(), jrpc.SocketTransport()
        tt.set_address("j", *jaddr)
        jt.set_address("t", *taddr)
        assert tt.send("j", "echo", {"a": 1}) == {"a": 1}
        assert jt.send("t", "echo", [b"x"]) == [b"x"]
        with pytest.raises(TransportError):
            tt.send("nobody", "echo", 1)
        with pytest.raises(JErr):
            jt.send("nobody", "echo", 1)
        tt.close()
        jt.close()
    finally:
        jm.shutdown()
        tm.shutdown()
