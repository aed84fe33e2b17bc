"""Wire protocol: length-prefixed JSON frames over TCP, with optional
HMAC-SHA256 request signing.

The reference's control plane is protobuf-2.5 over Hadoop IPC with
ClientToAM-token security (rpc/ApplicationRpcServer.java:122-148). The message
set is 8 tiny methods at ~1 Hz per task, so a framed-JSON protocol on stdlib
sockets gives the same capability without a Hadoop/grpc dependency; the HMAC
session token plays the ClientToAM-token role.

Frame layout:  [4-byte big-endian length][utf-8 JSON payload]
Request:   {"method": str, "params": {...}, "auth": hex-hmac | "", "role": str}
Response:  {"ok": true, "result": ...} | {"ok": false, "error": str}

Role split (reference TonyPolicyProvider.java:1-20 service-level ACLs, wired
at ApplicationMaster.java:483-503): the job secret is the ROOT key held by
the client and driver only; each principal class gets a one-way derived key
(`derive_role_key`). Executors receive only the "executor" key, so they can
sign executor calls but cannot forge client-role signatures — the server's
per-method ACL can then restrict e.g. finish_application to the client.
The signed message covers the role claim, so a frame can't be replayed
under a different role.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import socket
import struct
from typing import Any

MAX_FRAME = 64 * 1024 * 1024
_LEN = struct.Struct(">I")


class RpcError(Exception):
    """Server-side error surfaced to the caller."""


def derive_role_key(secret: str, role: str) -> str:
    """One-way per-role key from the job secret: a role-key holder can sign
    that role's calls but cannot recover the secret or any other role's key
    (HMAC-SHA256 is a PRF)."""
    if not secret:
        return ""
    return hmac.new(
        secret.encode(), b"tony-role:" + role.encode(), hashlib.sha256
    ).hexdigest()


def sign(token: str, method: str, params: dict[str, Any],
         role: str = "") -> str:
    if not token:
        return ""
    msg = (
        role + "\x00" + method + "\x00" + json.dumps(params, sort_keys=True)
    ).encode()
    return hmac.new(token.encode(), msg, hashlib.sha256).hexdigest()


def verify(token: str, method: str, params: dict[str, Any], auth: str,
           role: str = "") -> bool:
    if not token:
        return True
    return hmac.compare_digest(sign(token, method, params, role), auth or "")


def send_frame(sock: socket.socket, obj: Any) -> None:
    payload = json.dumps(obj).encode()
    if len(payload) > MAX_FRAME:
        raise ValueError(f"frame too large: {len(payload)}")
    sock.sendall(_LEN.pack(len(payload)) + payload)


def recv_frame(sock: socket.socket) -> Any | None:
    """Returns the decoded object, or None on clean EOF before a frame."""
    header = _recv_exact(sock, _LEN.size)
    if header is None:
        return None
    (length,) = _LEN.unpack(header)
    if length > MAX_FRAME:
        raise ValueError(f"frame too large: {length}")
    body = _recv_exact(sock, length)
    if body is None:
        raise ConnectionError("connection closed mid-frame")
    return json.loads(body.decode())


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            if buf:
                raise ConnectionError("connection closed mid-frame")
            return None
        buf += chunk
    return buf
