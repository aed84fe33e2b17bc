"""Port reservation: ephemeral vs reusable (SO_REUSEPORT) server ports.

Mirrors the reference's ServerPort abstraction (tony-core/.../EphemeralPort.java,
ReusablePort.java:39-52,204-237 and resources/reserve_reusable_port.py): an
executor must advertise a port to the driver *before* the user process exists,
yet the user's framework must later bind that same port. Two strategies:

- EphemeralPort: bind(0), hold the socket, release just before exec. There is
  a race window between release and the child's bind (reference notes the TF
  >= 2.3 gRPC failure mode this causes).
- ReusablePort: bind with SO_REUSEPORT and keep holding the socket across the
  exec; a child that also sets SO_REUSEPORT (gRPC servers do by default, and
  torch.distributed's TCP store need not) binds the same port with no race window.
  The reference forks a python sidecar to hold the socket because Java can't
  set SO_REUSEPORT portably; here the executor process holds it directly.

Opt-in mirrors the reference's TF_GRPC_REUSE_PORT / TB_SERVER_REUSE_PORT envs
(TaskExecutor.java:119-152) via tony.task.port-reuse-enabled /
tony.task.tb-port-reuse-enabled.
"""

from __future__ import annotations

import socket


def reuse_port_supported() -> bool:
    """SO_REUSEPORT exists on Linux >= 3.9 and macOS; absent on Windows."""
    return hasattr(socket, "SO_REUSEPORT")


class ServerPort:
    """A held TCP port reservation. `port` is valid until `release()`."""

    def __init__(self, sock: socket.socket):
        self._sock: socket.socket | None = sock
        self.port: int = sock.getsockname()[1]

    @property
    def held(self) -> bool:
        return self._sock is not None

    def release(self) -> None:
        if self._sock is not None:
            self._sock.close()
            self._sock = None

    def release_before_exec(self) -> None:
        """Called just before the user process is spawned. Ephemeral
        reservations must free the port here (accepting the race window);
        held strategies override this as a no-op."""
        self.release()

    def __enter__(self) -> "ServerPort":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class EphemeralPort(ServerPort):
    """Plain bind(0) reservation — must be released before the child binds
    (reference EphemeralPort.java; release-before-exec dance
    TaskExecutor.java:201-233)."""

    @classmethod
    def create(cls) -> "EphemeralPort":
        sock = socket.socket()
        sock.bind(("", 0))
        return cls(sock)


class ReusablePort(ServerPort):
    """SO_REUSEPORT reservation held across the child's exec — no race window
    (reference ReusablePort.create, ReusablePort.java:204-237)."""

    @classmethod
    def create(cls, port: int = 0) -> "ReusablePort":
        if not reuse_port_supported():
            raise OSError("SO_REUSEPORT is not supported on this platform")
        sock = socket.socket()
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        # bound but NOT listening: reserves the port (plain binds collide)
        # without joining the kernel's reuseport listener group — a listening
        # reservation would be load-balanced a share of the child's incoming
        # connections and never accept them
        sock.bind(("", port))
        return cls(sock)

    def release_before_exec(self) -> None:
        """Held across the exec — the child rebinds while we still hold."""


def allocate(reuse: bool) -> ServerPort:
    """Pick the strategy the way the executor's setupPorts does
    (TaskExecutor.java:88-100,119-152): reusable iff requested AND supported."""
    if reuse:
        if reuse_port_supported():
            return ReusablePort.create()
        import logging

        logging.getLogger(__name__).warning(
            "SO_REUSEPORT requested but unsupported on this platform; "
            "falling back to an ephemeral port (release-before-exec race window)"
        )
    return EphemeralPort.create()
