"""RPC client: persistent connection with reconnect + bounded retry (the
port's own copy of the JAX package's rpc/client.py; its endpoint handoff
for a recovered driver waits for ROADMAP.md queue 1's driver recovery).

Mirrors the reference's singleton retry proxy (rpc/impl/ApplicationRpcClient.java:48-77
— 10 retries x 2s) but with exponential backoff capped at 2s.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Any

from .protocol import RpcError, recv_frame, send_frame, sign


class RpcClient:
    def __init__(
        self,
        host: str,
        port: int,
        token: str = "",
        max_retries: int = 10,
        connect_timeout: float = 5.0,
        role: str = "",
    ):
        self._addr = (host, port)
        self._token = token
        self._role = role
        self._max_retries = max_retries
        self._connect_timeout = connect_timeout
        self._sock: socket.socket | None = None
        self._lock = threading.Lock()

    def _connect(self) -> socket.socket:
        if self._sock is None:
            sock = socket.create_connection(self._addr, timeout=self._connect_timeout)
            sock.settimeout(60)
            self._sock = sock
        return self._sock

    def _close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def call(self, method: str, **params: Any) -> Any:
        """Invoke `method`; retries transport errors, raises RpcError on
        server-reported errors (those are not retried — they are decisions,
        not failures)."""
        last_exc: Exception | None = None
        with self._lock:
            for attempt in range(self._max_retries):
                try:
                    sock = self._connect()
                    send_frame(
                        sock,
                        {
                            "method": method,
                            "params": params,
                            "auth": sign(self._token, method, params,
                                         self._role),
                            "role": self._role,
                        },
                    )
                    resp = recv_frame(sock)
                    if resp is None:
                        raise ConnectionError("server closed connection")
                    if not resp.get("ok"):
                        raise RpcError(resp.get("error", "unknown rpc error"))
                    return resp.get("result")
                except RpcError:
                    raise
                except (OSError, ValueError, ConnectionError) as e:
                    last_exc = e
                    self._close()
                    time.sleep(min(2.0, 0.1 * (2 ** attempt)))
        raise ConnectionError(
            f"rpc {method} to {self._addr} failed after {self._max_retries} retries"
        ) from last_exc

    def close(self) -> None:
        with self._lock:
            self._close()
