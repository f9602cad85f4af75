"""Unix-socket control probes (parity: `nidx ctl alive/ready`,
nidx/src/control.rs:29-87 — liveness/readiness checks for process
supervisors that can't speak HTTP)."""

from __future__ import annotations

import os
import socket
import threading
from typing import Callable


class ControlSocket:
    """Line protocol: client sends 'alive' or 'ready', server answers
    'ok' or 'fail'."""

    def __init__(self, path: str, ready_check: Callable[[], bool]):
        self.path = path
        self.ready_check = ready_check
        self._stop = threading.Event()
        if os.path.exists(path):
            os.unlink(path)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(path)
        self._sock.listen(4)
        self._sock.settimeout(0.5)
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            with conn:
                try:
                    # accept() returns a BLOCKING socket even when the
                    # listener has a timeout; a client that connects and
                    # sends nothing must not wedge the probe loop forever
                    conn.settimeout(2.0)
                    cmd = conn.recv(64).decode().strip().lower()
                    if cmd == "alive":
                        conn.sendall(b"ok\n")
                    elif cmd == "ready":
                        conn.sendall(b"ok\n" if self.ready_check() else b"fail\n")
                    else:
                        conn.sendall(b"unknown\n")
                except OSError:
                    pass

    def close(self) -> None:
        self._stop.set()
        self._sock.close()
        try:
            os.unlink(self.path)
        except OSError:
            pass


def probe(path: str, command: str, timeout: float = 2.0) -> bool:
    """Client side (parity: `nidx ctl <alive|ready>`)."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(timeout)
        s.connect(path)
        s.sendall(command.encode() + b"\n")
        return s.recv(64).strip() == b"ok"
