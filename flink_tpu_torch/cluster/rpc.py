"""Location-transparent RPC over plain TCP sockets (port of
``flink_tpu/cluster/rpc.py``).

reference: flink-rpc — RpcEndpoint/RpcGateway/RpcService
(flink-rpc-core/.../rpc/RpcEndpoint.java) implemented over Pekko actors with
JDK dynamic proxies (flink-rpc-akka/.../pekko/PekkoInvocationHandler.java,
PekkoRpcActor.java). Key semantics kept:

- every endpoint runs its handlers on ONE main thread (the reference's
  main-thread executor; MainThreadValidatorUtil assertions)
- gateways are dynamic proxies: attribute access returns a callable that
  marshals (endpoint, method, args) over the wire and blocks on the reply
- fencing tokens guard against split-brain leaders

Transport: the standard library only. A call is one length-prefixed frame
each way (``u32 length | payload``, big-endian, at most 512 MiB). The
server reads each connection on its own thread and serves at most 16 calls
at once (the reference's gRPC worker pool). The client keeps idle
connections per peer address under a lock and takes one per call, so
concurrent and nested calls (an endpoint calling a peer while serving a
call) each get a socket. ``call_timeout`` is the socket timeout; a refused,
reset or timed-out connection reaches the caller as an exception, never as
a hang — heartbeats and TaskExecutor-loss detection rely on that.

Payloads go through :func:`dumps` / :func:`loads`: ``pickle`` with a
``reducer_override`` that ships by value what plain pickle cannot find by
name — lambdas, functions defined inside other functions, functions of
``__main__`` — so a job graph carries the user's closures to the worker.
Both ends run the same interpreter, so ``marshal``'s code format matches.
The transport trusts its peers, as the reference's does: every frame is
unpickled, so bind only to addresses that members of the cluster alone
can reach (``rpc.bind-address``, 127.0.0.1 by default).
"""

from __future__ import annotations

import atexit
import builtins
import importlib
import io
import marshal
import pickle
import queue
import select
import socket
import struct
import threading
import traceback
import types
from concurrent import futures
from typing import Any, Dict, List, Optional

#: the reference's gRPC message cap and server worker pool
MAX_FRAME_BYTES = 512 * 1024 * 1024
MAX_CONCURRENT_CALLS = 16


class RpcException(RuntimeError):
    pass


class FencingTokenException(RpcException):
    pass


class RpcTimeoutException(RpcException, TimeoutError):
    """A call got no reply within its ``call_timeout``."""


# ---------------------------------------------------------------------------
# Serializer: pickle, with functions pickle cannot name shipped by value
# ---------------------------------------------------------------------------


def _importable(fn) -> bool:
    """True when ``fn`` is reachable as ``module.qualname`` — then plain
    pickle's by-reference form restores the same object."""
    module = getattr(fn, "__module__", None)
    qualname = getattr(fn, "__qualname__", "")
    if not module or module == "__main__" or "<" in qualname:
        return False
    try:
        obj = importlib.import_module(module)
        for part in qualname.split("."):
            obj = getattr(obj, part)
    except Exception:  # noqa: BLE001 - anything unreachable goes by value
        return False
    return obj is fn


def _global_names(code: types.CodeType) -> set:
    names = set(code.co_names)
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            names |= _global_names(const)
    return names


class _EmptyCell:
    """Marks a closure cell with no value yet."""


def _make_function(code_bytes: bytes, name: str, module: str,
                   ncells: int):
    """The skeleton: code, fresh globals, empty cells. The state part
    (``_fill_function``) sets globals and cells afterwards, so a function
    that refers to itself resolves to this very object."""
    code = marshal.loads(code_bytes)
    glb = {"__builtins__": builtins, "__name__": module}
    cells = tuple(types.CellType() for _ in range(ncells))
    return types.FunctionType(code, glb, name, None, cells or None)


def _fill_function(fn, state) -> None:
    fn.__globals__.update(state["globals"])
    for cell, value in zip(fn.__closure__ or (), state["cells"]):
        if value is not _EmptyCell:
            cell.cell_contents = value
    fn.__defaults__ = state["defaults"]
    fn.__kwdefaults__ = state["kwdefaults"]
    fn.__dict__.update(state["dict"])
    fn.__qualname__ = state["qualname"]
    fn.__module__ = state["module"]
    fn.__doc__ = state["doc"]


def _reduce_function(fn):
    code = fn.__code__
    glb = fn.__globals__
    used = {n: glb[n] for n in _global_names(code)
            if n in glb and n != "__builtins__"}
    cells = []
    for cell in fn.__closure__ or ():
        try:
            cells.append(cell.cell_contents)
        except ValueError:
            cells.append(_EmptyCell)
    state = {"globals": used, "cells": cells,
             "defaults": fn.__defaults__, "kwdefaults": fn.__kwdefaults__,
             "dict": dict(fn.__dict__), "qualname": fn.__qualname__,
             "module": fn.__module__, "doc": fn.__doc__}
    return (_make_function,
            (marshal.dumps(code), fn.__name__, fn.__module__,
             len(fn.__closure__ or ())),
            state, None, None, _fill_function)


class _Pickler(pickle.Pickler):
    def reducer_override(self, obj):
        if isinstance(obj, types.FunctionType) and not _importable(obj):
            return _reduce_function(obj)
        if isinstance(obj, types.ModuleType):
            # a module a shipped function names travels by import name
            return importlib.import_module, (obj.__name__,)
        return NotImplemented


def dumps(obj) -> bytes:
    buf = io.BytesIO()
    _Pickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()


def loads(data) -> Any:
    return pickle.loads(data)


# ---------------------------------------------------------------------------
# Frames
# ---------------------------------------------------------------------------

_HEADER = struct.Struct(">I")


def _send_frame(sock: socket.socket, payload: bytes) -> None:
    if len(payload) > MAX_FRAME_BYTES:
        raise RpcException(
            f"rpc frame of {len(payload)} bytes exceeds the "
            f"{MAX_FRAME_BYTES}-byte cap")
    sock.sendall(_HEADER.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if k == 0:
            raise ConnectionResetError("rpc peer closed the connection")
        got += k
    return bytes(buf)


def _recv_frame(sock: socket.socket) -> bytes:
    (n,) = _HEADER.unpack(_recv_exact(sock, _HEADER.size))
    if n > MAX_FRAME_BYTES:
        raise RpcException(f"rpc frame of {n} bytes exceeds the cap")
    return _recv_exact(sock, n)


# ---------------------------------------------------------------------------
# Endpoints
# ---------------------------------------------------------------------------


class RpcEndpoint:
    """Base class: subclass and define public methods; they become remotely
    callable. All calls execute serialized on this endpoint's main thread."""

    def __init__(self, endpoint_id: str):
        self.endpoint_id = endpoint_id
        self._mailbox: "queue.Queue" = queue.Queue()
        self._running = False
        self._main_thread: Optional[threading.Thread] = None
        self.fencing_token: Optional[int] = None

    # -- lifecycle ----------------------------------------------------------

    def on_start(self) -> None:
        pass

    def on_stop(self) -> None:
        pass

    def start(self) -> None:
        self._running = True
        self._main_thread = threading.Thread(
            target=self._main_loop, name=f"rpc-main-{self.endpoint_id}",
            daemon=True)
        self._main_thread.start()
        self.run_in_main_thread(self.on_start).result()

    def stop(self) -> None:
        if not self._running:
            return
        self.run_in_main_thread(self.on_stop).result()
        self._running = False
        self._mailbox.put(None)  # wake the loop
        self._main_thread.join(timeout=5)

    # -- main-thread executor ----------------------------------------------

    def _main_loop(self) -> None:
        while True:
            item = self._mailbox.get()
            if item is None:
                if not self._running:
                    return
                continue
            fn, args, kwargs, fut = item
            try:
                fut.set_result(fn(*args, **kwargs))
            except BaseException as e:  # noqa: BLE001 - marshalled to caller
                fut.set_exception(e)

    def run_in_main_thread(self, fn, *args, **kwargs) -> "futures.Future":
        """A future of ``fn(*args, **kwargs)`` run on the main thread; on
        an endpoint that was stopped it fails at once instead of never
        completing."""
        fut: "futures.Future" = futures.Future()
        if self._main_thread is not None and not self._running:
            fut.set_exception(RpcException(
                f"endpoint {self.endpoint_id} is stopped"))
            return fut
        self._mailbox.put((fn, args, kwargs, fut))
        return fut

    def validate_main_thread(self) -> None:
        """reference: MainThreadValidatorUtil.isRunningInExpectedThread."""
        assert threading.current_thread() is self._main_thread, \
            "must run on the endpoint main thread"

    # -- dispatch (called by RpcService) ------------------------------------

    def _invoke(self, method: str, args, kwargs,
                fencing_token: Optional[int]) -> Any:
        if self.fencing_token is not None and \
                fencing_token != self.fencing_token:
            raise FencingTokenException(
                f"{self.endpoint_id}: fencing token mismatch "
                f"(got {fencing_token}, expected {self.fencing_token})")
        fn = getattr(self, method, None)
        if fn is None or method.startswith("_"):
            raise RpcException(
                f"no such rpc method {method!r} on {self.endpoint_id}")
        return self.run_in_main_thread(fn, *args, **kwargs).result()


class _GatewayProxy:
    """Dynamic proxy — the reference's PekkoInvocationHandler."""

    def __init__(self, invoke, endpoint_id: str,
                 fencing_token: Optional[int] = None):
        object.__setattr__(self, "_invoke_fn", invoke)
        object.__setattr__(self, "_endpoint_id", endpoint_id)
        object.__setattr__(self, "_fencing_token", fencing_token)

    def __getattr__(self, method: str):
        if method.startswith("_"):
            raise AttributeError(method)

        def call(*args, **kwargs):
            return self._invoke_fn(self._endpoint_id, method, args, kwargs,
                                   self._fencing_token)

        return call

    def with_fencing_token(self, token: int) -> "_GatewayProxy":
        return _GatewayProxy(self._invoke_fn, self._endpoint_id, token)


# ---------------------------------------------------------------------------
# Client connections
# ---------------------------------------------------------------------------


def _split_address(address: str):
    host, _, port = address.rpartition(":")
    return host, int(port)


class _ConnectionPool:
    """Idle connections per peer address, under one lock."""

    def __init__(self):
        self._idle: Dict[str, List[socket.socket]] = {}
        self._lock = threading.Lock()
        self._closed = False

    def take(self, address: str, timeout: float) -> socket.socket:
        with self._lock:
            idle = self._idle.get(address, [])
            while idle:
                sock = idle.pop()
                # an idle socket that reads as ready has been closed by
                # its peer (a restarted or stopped server): drop it
                readable, _, _ = select.select([sock], [], [], 0)
                if not readable:
                    return sock
                sock.close()
        try:
            sock = socket.create_connection(_split_address(address),
                                            timeout=timeout)
        except OSError as e:
            raise RpcException(
                f"cannot reach rpc peer {address}: {e}") from e
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def give(self, address: str, sock: socket.socket) -> None:
        with self._lock:
            if self._closed:
                sock.close()
                return
            self._idle.setdefault(address, []).append(sock)

    def close(self, address: Optional[str] = None,
              final: bool = False) -> None:
        with self._lock:
            self._closed = self._closed or final
            targets = ([address] if address is not None
                       else list(self._idle))
            for addr in targets:
                for sock in self._idle.pop(addr, []):
                    sock.close()


def _make_gateway(pool: _ConnectionPool, address: str, endpoint_id: str,
                  fencing_token: Optional[int],
                  call_timeout: float) -> _GatewayProxy:
    def invoke(eid, method, args, kwargs, token):
        payload = dumps((eid, method, args, kwargs, token))
        sock = pool.take(address, call_timeout)
        try:
            sock.settimeout(call_timeout)
            _send_frame(sock, payload)
            reply = _recv_frame(sock)
        except socket.timeout as e:
            sock.close()
            raise RpcTimeoutException(
                f"{eid}.{method} at {address}: no reply within "
                f"{call_timeout} s") from e
        except OSError as e:
            sock.close()
            raise RpcException(
                f"{eid}.{method} at {address}: {e}") from e
        except BaseException:
            sock.close()
            raise
        pool.give(address, sock)
        reply = loads(reply)
        if reply[0] == "ok":
            return reply[1]
        raise reply[1]

    return _GatewayProxy(invoke, endpoint_id, fencing_token)


#: process-wide connections of server-less gateways (client_connect)
_client_pool = _ConnectionPool()

atexit.register(lambda: RpcService.client_close())


# ---------------------------------------------------------------------------
# Service
# ---------------------------------------------------------------------------


class RpcService:
    """Hosts endpoints on a TCP server; connects gateways to remote ones."""

    def __init__(self, bind_address: str = "127.0.0.1", port: int = 0,
                 advertised_address: str = ""):
        self._endpoints: Dict[str, RpcEndpoint] = {}
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((bind_address, port))
        self._listener.listen(128)
        self.port = self._listener.getsockname()[1]
        self._calls = threading.BoundedSemaphore(MAX_CONCURRENT_CALLS)
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self._stopped = threading.Event()
        self._acceptor = threading.Thread(
            target=self._accept_loop, name=f"rpc-accept-{self.port}",
            daemon=True)
        self._acceptor.start()
        # the address peers CONNECT to, which 0.0.0.0 never is: bind-all
        # servers advertise their routable host (reference:
        # taskmanager.host / jobmanager.rpc.address vs bind-host split)
        if not advertised_address:
            if bind_address == "0.0.0.0":
                try:
                    advertised_address = socket.gethostbyname(
                        socket.gethostname())
                except OSError:
                    advertised_address = socket.gethostname()
            else:
                advertised_address = bind_address
        self.address = f"{advertised_address}:{self.port}"
        self._pool = _ConnectionPool()

    # -- server side --------------------------------------------------------

    def register(self, endpoint: RpcEndpoint) -> None:
        self._endpoints[endpoint.endpoint_id] = endpoint
        endpoint.start()

    def unregister(self, endpoint_id: str) -> None:
        ep = self._endpoints.pop(endpoint_id, None)
        if ep is not None:
            ep.stop()

    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return  # listener closed
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conns_lock:
                if self._stopped.is_set():
                    conn.close()
                    return
                self._conns.add(conn)
            threading.Thread(target=self._serve_connection, args=(conn,),
                             name=f"rpc-conn-{self.port}",
                             daemon=True).start()

    def _serve_connection(self, conn: socket.socket) -> None:
        try:
            while not self._stopped.is_set():
                try:
                    request = _recv_frame(conn)
                except (OSError, RpcException):
                    return
                with self._calls:
                    reply = self._serve(request)
                try:
                    _send_frame(conn, reply)
                except OSError:
                    return
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            conn.close()

    def _serve(self, request: bytes) -> bytes:
        try:
            endpoint_id, method, args, kwargs, token = loads(request)
            ep = self._endpoints.get(endpoint_id)
            if ep is None:
                raise RpcException(f"unknown endpoint {endpoint_id!r}")
            result = ep._invoke(method, args, kwargs, token)
            return dumps(("ok", result))
        except BaseException as e:  # noqa: BLE001 - marshalled to caller
            tb = traceback.format_exc()
            try:
                return dumps(("err", e, tb))
            except Exception:  # noqa: BLE001 - unpicklable exception
                return dumps(("err", RpcException(f"{e!r}\n{tb}"), tb))

    # -- client side --------------------------------------------------------

    def connect(self, address: str, endpoint_id: str,
                fencing_token: Optional[int] = None,
                call_timeout: float = 120) -> _GatewayProxy:
        """``call_timeout``: per-RPC deadline in seconds — liveness probes
        (heartbeats) use short deadlines so one unreachable peer cannot
        stall the caller for the default two minutes."""
        return _make_gateway(self._pool, address, endpoint_id,
                             fencing_token, call_timeout)

    def self_gateway(self, endpoint_id: str,
                     fencing_token: Optional[int] = None) -> _GatewayProxy:
        return self.connect(self.address, endpoint_id, fencing_token)

    @classmethod
    def client_connect(cls, address: str, endpoint_id: str,
                       fencing_token: Optional[int] = None,
                       call_timeout: float = 120) -> _GatewayProxy:
        """Client-only gateway: connections to a remote endpoint without
        hosting a server (drivers submitting to a standalone cluster need
        no inbound RPC). Connections are cached process-wide; see
        :func:`client_close` for eviction."""
        return _make_gateway(_client_pool, address, endpoint_id,
                             fencing_token, call_timeout)

    @classmethod
    def client_close(cls, address: Optional[str] = None) -> None:
        """Close and evict cached client connections (one address, or all
        when ``address`` is None). Also runs at interpreter exit."""
        _client_pool.close(address)

    def stop(self) -> None:
        for ep in list(self._endpoints.values()):
            ep.stop()
        self._endpoints.clear()
        self._stopped.set()
        try:
            # shutdown wakes the accept loop; close alone does not
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        with self._conns_lock:
            conns = list(self._conns)
            self._conns.clear()
        for conn in conns:
            # peers blocked on a reply see a reset, not a hang
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            conn.close()
        self._pool.close(final=True)
