"""Socket transport for the node seam: a stand-in for ROS 1's TCPROS.

Counterpart of ``mpc_quad_ros_tpu/io/transport.py``, the port's own copy on
the standard library.  ``node.ControllerNode`` keeps its seams as plain
callables; these classes carry them across process boundaries:

- ``TcpPublisher`` / ``TcpSubscriber``: one-way pub/sub of the message
  dataclasses (``ControlCommand``, ``PositionCommand``, ``MotorPower``,
  ``LiveFrame``) as length-prefixed pickle frames with TCP_NODELAY, for the
  ``publish_control`` and ``live_callback`` seams;
- ``TcpRpcServer`` / ``TcpRpcClient``: request and response for the
  trajectory service (``TrajectoryRequest`` -> ``Trajectory``).

The messages hold numpy arrays, so no tensor and no card crosses the link.
Framing is pickle on a trusted local link, TCPROS's trust model; every
connection is blocking IO on a thread of its own (100 Hz control telemetry,
not a data plane).
"""

from __future__ import annotations

import pickle
import socket
import struct
import threading
from typing import Callable, Optional

_HDR = struct.Struct("!I")


def _send_frame(sock: socket.socket, obj) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_HDR.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def _recv_frame(sock: socket.socket):
    hdr = _recv_exact(sock, _HDR.size)
    if hdr is None:
        return None
    (n,) = _HDR.unpack(hdr)
    payload = _recv_exact(sock, n)
    if payload is None:
        return None
    return pickle.loads(payload)


class TcpPublisher:
    """Fan-out publisher: every connected subscriber receives every message.
    Broken subscribers are dropped silently (a dead listener must not
    stall the 100 Hz control path)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen()
        self.host, self.port = self._srv.getsockname()
        self._clients: list[socket.socket] = []
        self._lock = threading.Lock()
        self._closed = False
        self._accept_thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._accept_thread.start()

    def _accept_loop(self):
        while not self._closed:
            try:
                c, _ = self._srv.accept()
            except OSError:
                return
            c.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                self._clients.append(c)

    def publish(self, msg) -> None:
        with self._lock:
            dead = []
            for c in self._clients:
                try:
                    _send_frame(c, msg)
                except OSError:
                    dead.append(c)
            for c in dead:
                self._clients.remove(c)
                c.close()

    __call__ = publish            # drop-in for the node's publish seams

    def close(self):
        self._closed = True
        self._srv.close()
        with self._lock:
            for c in self._clients:
                c.close()
            self._clients.clear()


class TcpSubscriber:
    """Connect to a TcpPublisher and dispatch each message to `callback` on a
    reader thread."""

    def __init__(self, host: str, port: int, callback: Callable):
        self._sock = socket.create_connection((host, port))
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.callback = callback
        self._thread = threading.Thread(target=self._read_loop, daemon=True)
        self._thread.start()

    def _read_loop(self):
        while True:
            try:
                msg = _recv_frame(self._sock)
            except OSError:
                return
            if msg is None:
                return
            self.callback(msg)

    def close(self):
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()


class TcpRpcServer:
    """Serve `handler(request) -> response` over the socket, one thread per
    client: the trajectory service's side."""

    def __init__(self, handler: Callable, host: str = "127.0.0.1", port: int = 0):
        self.handler = handler
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen()
        self.host, self.port = self._srv.getsockname()
        self._closed = False
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()

    def _accept_loop(self):
        while not self._closed:
            try:
                c, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_client, args=(c,), daemon=True).start()

    def _serve_client(self, c: socket.socket):
        c.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        with c:
            while True:
                try:
                    req = _recv_frame(c)
                except OSError:
                    return
                if req is None:
                    return
                try:
                    resp = self.handler(req)
                    _send_frame(c, ("ok", resp))
                except Exception as e:  # propagate as a remote error
                    try:
                        _send_frame(c, ("err", repr(e)))
                    except OSError:
                        return

    def close(self):
        self._closed = True
        self._srv.close()


class TcpRpcClient:
    """Blocking request/response client.  `handle(req)` mirrors
    `TrajectoryServer.handle`, so an instance is a drop-in trajectory server
    for `ControllerNode`: the controller's side of the seam."""

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._lock = threading.Lock()

    def call(self, req):
        with self._lock:
            _send_frame(self._sock, req)
            resp = _recv_frame(self._sock)
        if resp is None:
            raise ConnectionError("rpc server closed the connection")
        status, payload = resp
        if status != "ok":
            raise RuntimeError(f"remote handler failed: {payload}")
        return payload

    handle = call                 # TrajectoryServer drop-in

    def close(self):
        self._sock.close()
