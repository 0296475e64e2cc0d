"""The port's RPC layer (``flink_tpu_torch/cluster/rpc.py``) against the
reference's (``flink_tpu/cluster/rpc.py``, gRPC + cloudpickle).

The serializer is pickle with functions pickle cannot name shipped by
value; each round-trip is held against cloudpickle's on the same object.
The transport's semantics (main thread, exceptions at the caller,
fencing, unknown endpoints and methods, a refused peer) run through both
packages; the socket specifics (timeouts, frame cap, nested calls, a
stopped peer) through the port. Every wait is bounded.
"""

import importlib
import os
import threading
import time

import cloudpickle
import numpy as np
import pytest

from flink_tpu_torch.cluster import rpc as trpc

PKGS = ("reference", "port")


def _rpc(pkg):
    return importlib.import_module(
        "flink_tpu.cluster.rpc" if pkg == "reference"
        else "flink_tpu_torch.cluster.rpc")


def _roundtrip(obj):
    """(port's copy, cloudpickle's copy) of ``obj``."""
    return trpc.loads(trpc.dumps(obj)), cloudpickle.loads(
        cloudpickle.dumps(obj))


# ------------------------------------------------------------ serializer


def _closures():
    table = {"a": 3, "b": 4}

    def over_dict(k):
        return table[k] * 2

    def fact(n):
        return 1 if n <= 1 else n * fact(n - 1)

    def uses_np_and_os(n):
        return float(np.arange(n).sum()) + len(os.path.join("x", "y"))

    return over_dict, fact, uses_np_and_os


def test_lambda_round_trips_as_cloudpickle_does():
    f = lambda x, y=2: x * y + 1  # noqa: E731
    port, ref = _roundtrip(f)
    for x in range(-3, 4):
        assert port(x) == ref(x) == f(x)
    assert port(5, y=7) == ref(5, y=7)


def test_closure_over_a_dict():
    over_dict, _, _ = _closures()
    port, ref = _roundtrip(over_dict)
    assert port("a") == ref("a") == 6
    assert port("b") == ref("b") == 8


def test_recursive_local_function():
    _, fact, _ = _closures()
    port, ref = _roundtrip(fact)
    assert [port(n) for n in range(8)] == [ref(n) for n in range(8)]
    assert port(10) == 3628800


def test_function_naming_np_and_os():
    _, _, fn = _closures()
    port, ref = _roundtrip(fn)
    assert port(10) == ref(10) == fn(10)
    # the modules arrive by import name: the very same module objects
    assert port.__globals__["np"] is np
    assert port.__globals__["os"] is os


def test_function_of_main_goes_by_value():
    """A function whose module is ``__main__`` (a script) is shipped by
    value, as cloudpickle ships it."""
    ns = {"__name__": "__main__"}
    exec("K = 5\ndef scaled(x):\n    return x * K\n", ns)
    port, ref = _roundtrip(ns["scaled"])
    assert port(3) == ref(3) == 15
    assert port.__module__ == "__main__"


def test_keyword_defaults_attributes_and_docstring_survive():
    def g(a, *, b=10):
        """doc"""
        return a + b

    g.tag = "x"
    port, ref = _roundtrip(g)
    assert port(1) == ref(1) == 11
    assert port(1, b=2) == 3
    assert port.tag == ref.tag == "x"
    assert port.__doc__ == "doc"
    assert port.__qualname__ == g.__qualname__


def test_importable_functions_go_by_reference():
    """Plain pickle's by-name form: the very same object comes back, and
    the payload names it instead of carrying code."""
    assert trpc.loads(trpc.dumps(np.linalg.norm)) is np.linalg.norm
    assert trpc.loads(trpc.dumps(os.path.join)) is os.path.join
    assert b"_make_function" not in trpc.dumps(os.path.join)
    assert b"_make_function" in trpc.dumps(lambda: 0)


def test_objects_holding_closures_round_trip():
    from flink_tpu_torch.core.records import RecordBatch

    _, fact, _ = _closures()
    obj = {"fns": [lambda b: b, fact],
           "batch": RecordBatch.from_pydict({"x": np.arange(4)})}
    port, ref = _roundtrip(obj)
    assert port["fns"][1](5) == ref["fns"][1](5) == 120
    assert port["batch"]["x"].tolist() == ref["batch"]["x"].tolist()


def test_two_functions_share_one_shipped_closure_object():
    """Pickle's memo holds across by-value functions: two closures over
    one dict still share it after the round trip."""
    shared = {"n": 1}

    def read():
        return shared["n"]

    def bump():
        shared["n"] += 1

    r, b = trpc.loads(trpc.dumps((read, bump)))
    b()
    assert r() == 2


def test_the_port_imports_neither_grpc_nor_cloudpickle():
    import subprocess
    import sys

    code = ("import sys, flink_tpu_torch.cluster.minicluster, "
            "flink_tpu_torch.cluster.rpc_shuffle, "
            "flink_tpu_torch.cluster.standalone, flink_tpu_torch.cli\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('grpc', 'cloudpickle', 'jax', 'flink_tpu'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


# ---------------------------------------------------- transport, both


def _echo_cls(pkg):
    mod = _rpc(pkg)

    class Echo(mod.RpcEndpoint):
        def __init__(self):
            super().__init__("echo")
            self.calls = 0

        def echo(self, x):
            self.validate_main_thread()
            self.calls += 1
            return x

        def boom(self):
            raise ValueError("intentional")

        def thread_name(self):
            return threading.current_thread().name

    return Echo


@pytest.fixture(params=PKGS)
def echo(request):
    mod = _rpc(request.param)
    svc = mod.RpcService()
    ep = _echo_cls(request.param)()
    svc.register(ep)
    yield mod, svc, ep
    svc.stop()


def test_roundtrip_and_main_thread(echo):
    mod, svc, ep = echo
    gw = svc.self_gateway("echo")
    assert gw.echo({"a": [1, 2, 3]}) == {"a": [1, 2, 3]}
    assert gw.thread_name() == "rpc-main-echo"
    assert ep.calls == 1


def test_exception_marshalling(echo):
    mod, svc, _ = echo
    gw = svc.self_gateway("echo")
    with pytest.raises(ValueError, match="intentional"):
        gw.boom()
    with pytest.raises(mod.RpcException, match="no such rpc method"):
        gw.no_such_method()
    with pytest.raises(mod.RpcException, match="unknown endpoint"):
        svc.self_gateway("nobody").echo(1)
    with pytest.raises(AttributeError):
        gw._private


@pytest.mark.parametrize("pkg", PKGS)
def test_fencing_token(pkg):
    mod = _rpc(pkg)
    svc = mod.RpcService()
    try:
        ep = _echo_cls(pkg)()
        ep.fencing_token = 42
        svc.register(ep)
        assert svc.self_gateway("echo", fencing_token=42).echo(1) == 1
        with pytest.raises(mod.FencingTokenException, match="fencing"):
            svc.self_gateway("echo", fencing_token=7).echo(1)
        gw = svc.self_gateway("echo").with_fencing_token(42)
        assert gw.echo(2) == 2
    finally:
        svc.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_a_refused_peer_raises_quickly(pkg):
    mod = _rpc(pkg)
    svc = mod.RpcService()
    dead = mod.RpcService()
    address = dead.address
    dead.stop()
    try:
        t0 = time.monotonic()
        with pytest.raises(Exception):
            svc.connect(address, "echo", call_timeout=5).echo(1)
        assert time.monotonic() - t0 < 5
    finally:
        svc.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_client_connect_without_a_server(pkg):
    mod = _rpc(pkg)
    svc = mod.RpcService()
    try:
        svc.register(_echo_cls(pkg)())
        gw = mod.RpcService.client_connect(svc.address, "echo")
        assert gw.echo("hi") == "hi"
        mod.RpcService.client_close(svc.address)
        assert mod.RpcService.client_connect(svc.address,
                                             "echo").echo(3) == 3
    finally:
        mod.RpcService.client_close()
        svc.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_bind_all_advertises_a_routable_address(pkg):
    mod = _rpc(pkg)
    svc = mod.RpcService(bind_address="0.0.0.0")
    try:
        host = svc.address.rsplit(":", 1)[0]
        assert host != "0.0.0.0" and svc.address.endswith(f":{svc.port}")
    finally:
        svc.stop()
    svc = mod.RpcService(advertised_address="worker-7")
    try:
        assert svc.address == f"worker-7:{svc.port}"
    finally:
        svc.stop()


# ------------------------------------------------------ transport, port


class _Slow(trpc.RpcEndpoint):
    def __init__(self, peer=None):
        super().__init__("slow")
        self.peer = peer

    def sleep(self, s):
        time.sleep(s)
        return s

    def ask_peer(self, x):
        # a nested call made while serving one
        return self.peer.echo(x)


def test_call_timeout_raises_within_its_deadline():
    svc = trpc.RpcService()
    try:
        svc.register(_Slow())
        gw = svc.connect(svc.address, "slow", call_timeout=0.2)
        t0 = time.monotonic()
        with pytest.raises(trpc.RpcTimeoutException):
            gw.sleep(2)
        assert time.monotonic() - t0 < 1.5
        assert isinstance(trpc.RpcTimeoutException("x"), TimeoutError)
    finally:
        svc.stop()


def test_nested_and_concurrent_calls_each_get_a_connection():
    svc = trpc.RpcService()
    try:
        svc.register(_echo_cls("port")())
        svc.register(_Slow(peer=svc.self_gateway("echo")))
        gw = svc.self_gateway("slow")
        assert gw.ask_peer(7) == 7
        out = []
        threads = [threading.Thread(
            target=lambda i=i: out.append(svc.self_gateway("echo").echo(i)))
            for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert sorted(out) == list(range(8))
    finally:
        svc.stop()


def test_a_peer_that_drops_the_call_raises_at_the_caller():
    """A peer that accepts the call and closes its socket without a reply
    (a process that died mid-call) gives an exception, not a hang."""
    import socket

    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)

    def drop():
        conn, _ = listener.accept()
        conn.recv(16)
        conn.close()

    t = threading.Thread(target=drop, daemon=True)
    t.start()
    client = trpc.RpcService()
    try:
        gw = client.connect(f"127.0.0.1:{listener.getsockname()[1]}",
                            "slow", call_timeout=30)
        t0 = time.monotonic()
        with pytest.raises(trpc.RpcException):
            gw.sleep(3)
        assert time.monotonic() - t0 < 5
    finally:
        client.stop()
        listener.close()


def test_frames_past_the_cap_are_refused(monkeypatch):
    svc = trpc.RpcService()
    try:
        svc.register(_echo_cls("port")())
        monkeypatch.setattr(trpc, "MAX_FRAME_BYTES", 1 << 10)
        with pytest.raises(trpc.RpcException, match="exceeds"):
            svc.self_gateway("echo").echo(b"x" * (1 << 12))
        monkeypatch.undo()
        assert svc.self_gateway("echo").echo(b"y" * (1 << 12)) == \
            b"y" * (1 << 12)
    finally:
        svc.stop()


def test_a_restarted_peer_is_reached_through_a_fresh_connection():
    a = trpc.RpcService()
    client = trpc.RpcService()
    try:
        a.register(_echo_cls("port")())
        port = a.port
        gw = client.connect(a.address, "echo", call_timeout=5)
        assert gw.echo(1) == 1
        a.stop()
        b = trpc.RpcService(port=port)
        try:
            b.register(_echo_cls("port")())
            # the idle connection to the stopped server is dropped
            assert gw.echo(2) == 2
        finally:
            b.stop()
    finally:
        client.stop()
