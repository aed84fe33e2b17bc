"""Threaded RPC server hosting the application control-plane service.

Mirrors rpc/ApplicationRpcServer.java (ephemeral-port bind, request dispatch,
token check) and rpc/impl/MetricsRpcServer.java (second service; here the
metrics methods share the same port — the reference only split them because
Hadoop IPC couldn't mix protobuf and Writable engines on one server).
"""

from __future__ import annotations

import logging
import socket
import socketserver
import threading
from typing import Any, Callable

from .protocol import send_frame, recv_frame, verify

log = logging.getLogger(__name__)

Handler = Callable[..., Any]


class RpcServer:
    """method-name -> handler dispatch over framed JSON; one thread per
    connection (connections are persistent — executors keep one open for
    heartbeats)."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        token: str = "",
        roles: dict[str, str] | None = None,
        acl: dict[str, frozenset[str] | set[str]] | None = None,
    ):
        """``token`` alone = single-key mode (every holder may call every
        method). ``roles`` (role name -> HMAC key) switches to per-principal
        auth: the request's role claim selects the key, and ``acl``
        (method -> allowed roles; methods absent from it accept any
        authenticated role) enforces the client/executor privilege split —
        reference TonyPolicyProvider service ACLs."""
        self._handlers: dict[str, Handler] = {}
        self._token = token
        self._roles = roles
        self._acl = {m: frozenset(r) for m, r in (acl or {}).items()}
        outer = self

        class _ConnHandler(socketserver.BaseRequestHandler):
            def handle(self) -> None:
                sock: socket.socket = self.request
                sock.settimeout(300)
                try:
                    while True:
                        try:
                            req = recv_frame(sock)
                        except (ConnectionError, socket.timeout, OSError):
                            return
                        if req is None:
                            return
                        send_frame(sock, outer._dispatch(req))
                except (BrokenPipeError, OSError):
                    return

        class _Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = _Server((host, port), _ConnHandler)
        self._thread: threading.Thread | None = None

    # ---------------------------------------------------------------- control
    @property
    def address(self) -> tuple[str, int]:
        return self._server.server_address[:2]

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def register(self, method: str, handler: Handler) -> None:
        self._handlers[method] = handler

    def register_service(self, service: object) -> None:
        """Expose every public method of `service` (not starting with _)."""
        for name in dir(service):
            if name.startswith("_"):
                continue
            fn = getattr(service, name)
            if callable(fn):
                self._handlers[name] = fn

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="rpc-server", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        # shutdown() blocks on serve_forever()'s exit handshake; if start()
        # was never called there is no loop to exit and it would hang forever.
        if self._thread is not None:
            self._server.shutdown()
            self._thread.join(timeout=5.0)
            self._thread = None
        self._server.server_close()

    # --------------------------------------------------------------- dispatch
    def _dispatch(self, req: dict[str, Any]) -> dict[str, Any]:
        method = req.get("method", "")
        params = req.get("params", {}) or {}
        role = str(req.get("role", "") or "")
        if self._roles is not None:
            key = self._roles.get(role)
            if key is None or not verify(
                key, method, params, req.get("auth", ""), role
            ):
                return {"ok": False, "error": "authentication failed"}
            allowed = self._acl.get(method)
            if allowed is not None and role not in allowed:
                return {
                    "ok": False,
                    "error": f"authorization failed: {method} requires role "
                             f"{sorted(allowed)}, caller holds {role!r}",
                }
        elif not verify(self._token, method, params, req.get("auth", ""),
                        role):
            return {"ok": False, "error": "authentication failed"}
        handler = self._handlers.get(method)
        if handler is None:
            return {"ok": False, "error": f"unknown method: {method}"}
        try:
            return {"ok": True, "result": handler(**params)}
        except Exception as e:  # surfaced to caller, server keeps running
            log.exception("rpc handler %s failed", method)
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}
